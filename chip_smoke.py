#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

  PYTHONPATH=src python chip_smoke.py

Drives the port (``src/repro_torch``) on one card, in thirteen phases, each
printing JSON lines:

1. device — refuses to run without CUDA; the card's name and power limit
   (``nvidia-smi``), also printed raw on a line of their own;
2. build — builds every CUDA kernel from the sources in this checkout;
3. kernels — every kernel against its plain PyTorch version on the card at
   the serving path's shapes, kernel 6 also at the training path's
   4,096 rows (and at qwen2-1.5b's head shapes, bf16 and
   int8, a sliding window; a wrapped ring; pool blocks of 16 and 64
   tokens in shuffled order, two slots sharing their first blocks; the
   attention kernels against the plain version in their own split order
   and in the default one, also on rows either side of a split boundary),
   with its time — event ms per call and the profiler's device ms — the
   plain version's, a PyTorch library call's (event and device ms) and the
   bound the card sets (the cases without a window, at 64-token blocks;
   the profiler's at SmolLM-135M's heads); kernels 1-4 again at the
   serve profile's shapes;
   the paged kernel at 64-token blocks against the ring kernel on the same
   stream, bit for bit; the speculative verify kernels (ring and paged, 4
   and 8 query rows, a slot two short of the cache's end), every row equal
   to the decode kernel at its position, bit for bit, and paged verify
   equal to ring verify;
4. serve — full-width SmolLM-135M cut to ``SMOLLM_LAYERS`` = 8 of its 30
   layers, as in phases 5-7 (random weights from seed 0), through the
   port's ``Engine``, with the bf16 and the int8-dither KV cache, over the
   ring cache (16 requests, prompts of 32–512 tokens) and over the paged
   pool (16 requests sharing a 256-token system prompt, a pool of 56
   blocks against the 128 a dense cache would take, so requests hit the
   prefix cache and get preempted), 64 new tokens each, mixed greedy and
   sampled; then each path again with speculative decoding (draft_k 4,
   a replay drafter of the plain streams and the prompt-lookup drafter;
   the ring runs serve ``SPEC_RING_NEW`` = 32 new tokens a request),
   whose streams must equal the plain ones token for token; each path's
   launch counts are set to 0 just before its run and read just after
   (a policy-free decode window is one CUDA-graph replay, so its launches
   are the graph's times its replays, ``launch_gates``); before the serve
   runs, a probe of which library ops of a verify forward are row-pure;
   then the ring (bf16, int8) and paged (int8) traffic in windows of 8
   ticks, whose streams must equal the one-tick streams; graph ≡ eager:
   one window replayed and the same window run eagerly on a clone of its
   state, byte for byte, for ring and paged, bf16 and int8, also right
   after an admission rebinds the positions and block tables; chunked
   prefill (chunks of 128 tokens) against whole-prompt prefill within the
   logit tolerance, and the ring int8 traffic served in chunks and
   windows; then steady decode ticks (bf16 and int8), speculative
   windows and dither-policy ticks (bf16), and bf16 8-tick windows
   replayed and run eagerly from one state, under
   ``torch.profiler`` (wall and device time per tick or window, busy
   share, launches, the heaviest kernels);
5. parity — one prefill and three decode steps at full width per layout,
   the CUDA kernel against the plain version passed explicitly; the
   paged engine's greedy streams against the ring engine's, token for
   token; and a request's prefill unchanged by the other requests of a
   wave at its own padded length (which the engine's prefill per length
   bucket relies on), beside how far a longer padded wave moves it;
6. fault tolerance and observability (between the chunked and the policy
   phases): ``fault`` — the ring bf16 (W = 1), ring int8 (W = 8, chunks of
   128, 32 new tokens a request) and paged bf16 and int8 (W = 1) traffic
   served through
   ``run_serve_with_restarts`` with a snapshot every window and all five
   crash points fired at distinct ticks, streams equal to the
   uninterrupted runs', and two in-place restores per run on one
   graph-replaying engine whose rebuilt cache equals the one its windows
   wrote, byte for byte; ``observe`` — ring bf16 at W = 8 and paged int8
   at W = 1 with and without metrics (JSONL) and tracing (memory and
   Perfetto): equal streams, launches, replays and host↔device syncs,
   explain shares summing to 100 %, the Perfetto counters equal to the
   JSONL gauges; ``overload`` — paged int8 at W = 8 degrading under pool
   pressure (windows down to one tick and back, streams unchanged), then
   queue caps with both shed policies and deadlines on the engine's
   injected clock;
7. training and the pulse-stream core (after the policy phases): ``train``
   — full-width SmolLM-135M (8 layers), batch 8 × 512, 10 steps from
   seed 0 (cosine schedule, remat) with no policy and under
   ``QuantPolicy(scheme="dither", bits=8, backend="auto")``, whose every
   forward product runs through kernel 6's policy entry at 4,096 rows
   (the tied head through the transposed embedding): losses finite and
   falling, kernel 6 launched 85 times a step (43 without remat; 421 and
   211 at 30 layers), the step's loss and every gradient through the
   kernel equal to the plain version's bit for bit, a run crashed after
   a checkpoint and before a step and restarted equal to an uninterrupted
   one bit for bit; step times, tokens/s, peak memory, one profiled step
   and the checkpoint's save and restore times;
   ``core`` — the §II–IV encoders and pulse arithmetic on the card at
   N = 16…1024 against the paper's bias, EMSE and slope bounds;
8. the rest of the zoo (``zoo``, one line per config) — granite-3-8b,
   minicpm-2b, internvl2-1b, granite-moe-1b-a400m and qwen2-moe-a2.7b at
   full width, random bf16 weights from seed 0, one model on the card at
   a time: kernels 1–4 at its (n_kv, group, head dim) and kernel 6's
   policy entry at its new shapes against their plain versions (verify
   rows equal to decode bit for bit); 8 requests (32 new tokens, batch 8,
   ``max_len`` 1024, half greedy, half sampled) served ring bf16 and int8,
   paged bf16 with the prefix cache off (streams equal to ring bf16's) and
   paged int8 after a shared 128-token system prompt (prefix hits), with
   the launch gates; speculatively (draft_k 4, prompt lookup) on the dense
   ones, streams equal to the plain ones; on the MoE ones one W = 8 window
   replayed and run eagerly, byte for byte, and the share of routed
   assignments dropped at decode and prefill (counted in a second ring
   run, so the timed one runs without the counter); greedy decode through
   the kernels against their plain versions, logits within
   ``ZOO_PARITY_ATOL``; granite-moe under the dither policy (4 new tokens
   a request; kernel-6 launches a call, logits against the plain route)
   and through a crashed run restored as the reference restores an MoE
   engine (every budget completed); granite-moe and internvl2 trained 2
   steps of 8 × 512 (the VLM's 256 stub embeds prepended) with and
   without the policy, one step through kernel 6 bit for bit the plain
   one; peak memory per config;
9. the recurrent configs (``zoo``, one line each) — mamba2-370m and
   recurrentgemma-9b at full width and depth, one at a time: kernel 1 at
   head dim 256 (recurrentgemma's 16 heads over 1 KV head; a wrapped
   2,048-slot ring under the 2,048-token window) and kernel 6 at mamba2's
   products against their plain versions; the zoo's ring traffic in bf16
   and int8 (mamba2's int8 flag inert: equal streams), prompts prefilled
   by the scanned prefill replayed from one captured decode step a
   position (its replay timed alone against its bound), the launch gates
   counting those replays; a W = 8 window replayed and run eagerly,
   byte for byte, states included, and W = 8 streams equal to W = 1's;
   the kernel route against the plain one; mamba2 under the dither
   policy (16-token prompts; logits bit for bit the plain route) and
   trained 2 steps; a
   crashed recurrentgemma run restored, streams equal to uninterrupted;
10. the encoder-decoder (``zoo``, one line) — whisper-small at full width
   and depth (12 + 12 layers, d 768, 12 heads of 64, vocab 51,865),
   each of 8 slots over its own 1,500 audio-stub frames from the data
   pipeline: kernel 1 at (12, 1, 64) within 1e-6 of its plain version,
   with SDPA's times, and kernel 6's policy entry at its nine product
   shapes bit for bit; the encoder's time to build the cache and the
   cross-KV's bytes; the zoo's ring traffic in bf16 and with the inert
   ``kv_quant`` (equal streams), prefilled by the captured scanned
   prefill, the launch gates counting its replays, a tick's and a prefill
   step's device ms; a W = 8 window replayed and run eagerly, byte for
   byte, the cross-KV equal and unchanged, an in-place restore rebuilding
   the self-KV and cross-KV byte for byte, W = 8 streams equal to W = 1's;
   the kernel route against the plain one; the dither policy on 16-token
   prompts (logits bit for bit the plain route); a crashed run restored
   (streams equal); 2 train steps of 8 × 512 with and without the policy,
   one bit for bit its plain version;
11. sharded serving (``mesh``, one line per mesh, then a summary) —
   qwen2-1.5b at full width and depth (28 layers, d 1,536, 12 heads / 2
   KV heads of 128, vocab 151,936), seed-0 bf16 weights, the zoo's ring
   traffic: the shard-purity table (``transformer.shard_purity`` at
   decode rows and at each prefill bucket of the traffic); the
   (1, 1) mesh through NCCL, ring bf16 and int8 and paged bf16 bit for
   bit the single-device engine, windows graph replays; (1, 2), (2, 1)
   and (2, 2) as gloo ranks sharing the card (spawned processes, results
   through a queue; 8 of the 28 layers, ``MESH_SHARED_LAYERS``), ring
   int8 and paged bf16: every rank's host streams
   equal, bit for bit the single-device streams where the purity table
   reads 0 (else equal where the margin clears), kernels 1 and 2 at (1,
   6, 128) on the (·, 2) meshes, each rank's int8 codes byte for byte the
   single-device codes of its heads, all-gathers and bytes a tick and
   decode ms a tick (ranks sharing one card: not a sharded rate); the GQA
   fallback (smollm-135m, 3 KV heads) on (1, 2) bit for bit; kernels 1
   and 2 checked and timed at the local shape (1, 6, 128);
12. the training mesh (``train_mesh``) — kernel 6's sharded entry at the
   meshes' local shapes (``SHARDED_CASES``: qwen2-1.5b's rows, columns
   and K halves with their epilogue, mamba2-370m's ``in_proj`` columns and
   ``out_proj`` K halves, whisper-small's encoder QKV columns, and the
   decode's 8-row blocks of mamba2 and whisper), bit for
   bit its plain version and the slice of the unsharded product, timed
   beside bf16 ``torch.matmul``; qwen2-1.5b trained on the (1, 1) mesh
   through NCCL at 28 layers, bit for bit one device; (2, 2), (2, 1)
   and (1, 2) as gloo ranks sharing the card at 8 layers, with and
   without the dither policy, granite-moe at (2, 1), smollm-135m's
   sequence split and (ROADMAP item 10c) mamba2-370m (16 layers),
   recurrentgemma-9b (3 layers) and whisper-small (12 + 12) at (1, 2):
   replicas bit for bit after every step, step-1 losses within the
   one-device tolerance (qwen2-1.5b's (2, 2) dither step bit for bit
   through kernel 6's plain version; mamba2's and whisper's dither step
   against one device's through the kernel), kernel 6's launches by
   block kind; the same three families' sharded decode on the training
   layout at (1, 2) (ROADMAP Queue 3): 8 greedy ticks after a one-device
   prefill, against one device's (logits and each rank's state and KV
   within their tolerances, replicated leaves bit for bit on both ranks,
   under the dither policy bit for bit through kernel 6's sharded
   entry), kernel 1 at the local heads (recurrentgemma's (1, 8, 256),
   whisper's (6, 1, 64)) checked, timed and counted; the elastic
   checkpoint; and the dry run (``launch/dryrun.py``, meta tensors on a
   fake process group) predicting the (2, 2) step's and the (1, 2)
   decode ticks' collectives exactly and the (1, 1) run's peak beside
   the measured one;
13. the kernel autotuner (``autotune``, run after the row-purity probe and
   before the serve phases, ``autotune_phase``) — with
   ``REPRO_AUTOTUNE_CACHE`` on a temporary file (the variable is unset for
   the rest of the run): every launch-parameter candidate of kernels 1–6
   at SmolLM-135M's full width against its plain version (ring tiles of
   8–64 slots within 1e-4, paged ≡ ring at bs == bk and verify rows ≡
   decode bit for bit, kernel 6's policy entry at every ``(mt, cps,
   splits)`` of the serve products and kernel 5 bit for bit), each kernel
   swept by CUDA events with every candidate's times printed beside the
   card's name and power limit, the winners written and read back by ring
   int8 engines (W = 1, W = 8, speculative, dither policy) whose streams
   keep W = 8 ≡ W = 1, spec ≡ plain and tuned ≡ untuned under the policy,
   with a tracer that saw the cache hits; then the cache is cleared.

Then one ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.  Any
failed check ends the run with a non-zero exit; nothing is caught.

  PYTHONPATH=src python chip_smoke.py --attention-times TREE [TREE ...]

times kernels 1-4 alone (``attention_times``) for each TREE — a checkout's
root, such as a parent commit unpacked under ``build/``, or ``split=N``,
this checkout's port with a split span of N tiles — each in a process of
its own, in the order given, so that versions compare on one card.

  PYTHONPATH=src python chip_smoke.py --dither-times TREE [TREE ...]

does the same for kernels 5-6 (``dither_times``: the quantiser, the f32
dither matmul and the policy's bf16 product) and a dither-policy decode
tick under the profiler (bf16 and int8 KV).

  PYTHONPATH=src python chip_smoke.py --mesh-block

runs the device and build phases, the mesh block and the training-mesh
block alone.

  PYTHONPATH=src python chip_smoke.py --autotune

runs the device and build phases and the autotune phase alone.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                          # H100 SXM
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}       # dense tensor-core rates
KERNEL_TOL = 1e-4     # f32 vs f32, summation order only
# Logits: kernel and plain version differ only in f32 summation order
# (about 1e-7 on the attention output), but after the cast to bf16 a few
# elements round the other way and the difference spreads through 30 bf16
# layers.  Re-blocking the plain version's own sum (whole cap → 64-slot
# blocks) moves the logits as far: up to 0.032, 0.0028 on average, over
# three steps (the parity phase reports that drift beside the kernel's).
# The kernel is held to about twice that: 2^-4 at most, 2^-7 on average.
LOGIT_ATOL, LOGIT_MEAN_ATOL = 2.0 ** -4, 2.0 ** -7
REPLACES = "src/repro/kernels/decode_attention.py:139"
PAGED_REPLACES = "src/repro/kernels/decode_attention.py:482"
PAGED_BLOCKS = 56          # the paged serve phase's pool, against 8 × 16
SERVE_REQUESTS = 16        # requests of each serve phase
SPEC_K = 4                 # the speculative serve phases' draft_k
# new tokens a request of the ring spec runs: the plain streams' first 32
# (a ring request's stream does not depend on its budget or its wave)
SPEC_RING_NEW = 32
POLICY_NEW = 16            # new tokens a request of the policy serve phases
# SmolLM-135M's depth in phases 4-7: full width, 8 of its 30 layers, to
# keep the script inside its time limit with the zoo's blocks (every gate
# and count follows n_layers; PERF.md §4)
SMOLLM_LAYERS = 8
VERIFY_REPLACES = "src/repro/kernels/decode_attention.py:316"
PAGED_VERIFY_REPLACES = "src/repro/kernels/decode_attention.py:653"
ATTN_KERNELS = ("flash_decode",)   # kernels 1-4's device kernels (and merge)
SDPA_OP = "aten::scaled_dot_product_attention"
ATTN_SHAPES = {"smollm_135m": dict(nkv=3, group=3, hd=64),
               "qwen2_1_5b": dict(nkv=2, group=6, hd=128)}
LONG_POS = [0, 37, 255, 511, 700, 1023, 1500, 2047]   # ring wrap >= 1024
# the profile phase's steady ticks: 8 prompts of 199 + 20 r tokens
SERVE_POS = [203 + 20 * r for r in range(8)]
# rows either side of split boundaries (multiples of S tiles of 64 keys)
# and of the ring's end
SPLIT_POS = [255, 256, 257, 511, 512, 1023, 1024, 1025]
VERIFY_SPLIT_POS = [252, 253, 255, 256, 509, 512, 1021, 1024]


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; phase lines carry the seconds since the start."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T_START, 1)}
    print(json.dumps(obj), flush=True)


def part_timer():
    """(mark, parts): ``mark(name)`` records the seconds since the last
    mark under ``name`` in ``parts`` — where a phase's time goes."""
    parts, last = {}, [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        parts[name] = round(now - last[0], 2)
        last[0] = now
    return mark, parts


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- phase 3


def ring_inputs(gen, *, b, cap, nkv, group, hd, quant, pos_vals,
                kq=None, device="cuda"):
    """A ring-cache snapshot on the card: slot s of row i holds the latest
    position p ≡ s (mod cap) with p ≤ pos_i; unwritten slots k_pos = -1.
    With ``kq`` (a verify call), q is (B, kq, n_kv, group, hd) and the ring
    holds positions up to pos_i + kq - 1, the draft rows' writes."""
    import torch

    pos = torch.tensor(pos_vals, dtype=torch.int32)
    kpos = torch.full((b, cap), -1, dtype=torch.int32)
    for i, p in enumerate(pos_vals):
        top = p + (kq or 1) - 1
        ps = torch.arange(max(0, top - cap + 1), top + 1)
        kpos[i, ps % cap] = ps.to(torch.int32)
    q = torch.randn((b,) + ((kq,) if kq else ()) + (nkv, group, hd),
                    generator=gen).to(torch.bfloat16)
    if quant:
        k = torch.randint(-127, 128, (b, cap, nkv, hd), generator=gen,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (b, cap, nkv, hd), generator=gen,
                          dtype=torch.int8)
        ks = torch.rand((b, cap, nkv), generator=gen) * 1.9 + 0.1
        vs = torch.rand((b, cap, nkv), generator=gen) * 1.9 + 0.1
    else:
        k = torch.randn((b, cap, nkv, hd), generator=gen).to(torch.bfloat16)
        v = torch.randn((b, cap, nkv, hd), generator=gen).to(torch.bfloat16)
        ks = vs = None
    return [None if t is None else t.to(device)
            for t in (q, k, v, kpos, pos, ks, vs)]


def needed_positions(pos_vals, cap, window):
    """Cache positions each row must read: the written, unmasked ones."""
    out = []
    for p in pos_vals:
        n = min(p + 1, cap)
        out.append(min(n, window) if window else n)
    return out


def decode_bound(pos_vals, *, b, cap, nkv, group, hd, quant, window):
    """Least time the card could take: every needed input byte read once,
    the output written once, over HBM; the QK and PV flops over the peak
    tensor rate of the cache's type.  Returns (ms, 'bytes'|'operations')."""
    n = sum(needed_positions(pos_vals, cap, window))
    per_pos = nkv * hd * (1 if quant else 2) * 2 + 4     # K, V, k_pos
    if quant:
        per_pos += nkv * 4 * 2                           # k_scale, v_scale
    nbytes = n * per_pos + b * nkv * group * hd * (2 + 4) + b * 4
    ops = 4 * group * hd * nkv * n
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS["int8" if quant else "bf16"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def library_call(t, window):
    """``F.scaled_dot_product_attention`` on a bf16 cache (the int8 one
    dequantised first) with K/V expanded over the GQA group and the same
    mask — timed as a yardstick only; the port never calls it."""
    import torch
    import torch.nn.functional as F

    q, k, v, kp, pos, ks, vs = t
    b, cap, nkv, hd = k.shape
    group = q.shape[2]
    if ks is not None:
        k = (k.float() * (ks[..., None] / 127.0)).to(torch.bfloat16)
        v = (v.float() * (vs[..., None] / 127.0)).to(torch.bfloat16)
    kk = k.permute(0, 2, 1, 3).repeat_interleave(group, dim=1).contiguous()
    vv = v.permute(0, 2, 1, 3).repeat_interleave(group, dim=1).contiguous()
    qq = q.reshape(b, nkv * group, 1, hd)
    p = pos[:, None]
    mask = (kp >= 0) & (kp <= p)
    if window:
        mask = mask & (kp > p - window)
    mask = mask[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qq, kk, vv,
                                                  attn_mask=mask)


def host_ms(torch, fn, calls: int = 200) -> float:
    """Host time per call of ``fn`` (what the caller waits before its next
    call: checks, allocation, launches), over ``calls`` calls that the card
    keeps up with, without a sync inside."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / calls


def device_ms(torch, fn, calls, names=None, op=None, by_kernel=None):
    """Device time per call of ``fn`` from ``torch.profiler`` over ``calls``
    calls (after one outside the trace): the summed self time of the CUDA
    kernels whose names contain one of ``names`` (``None``: every device
    kernel and memset in the trace, that is all ``fn`` launches) or, with
    ``op``, the device time of everything launched under that operator.
    With a dict ``by_kernel``, also each matching kernel's share, by name.
    The larger of two traces that caught some (a trace may drop events);
    None ("not measured") when five traces catch none: the profiler's
    CUPTI tracing now and then records no device activity at all (an
    epilogue row of the training mesh's kernel checks, one run of four),
    and a kernel's launches are gated by its wrapper's count, not here."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    traces = []                # (us, by kernel) of traces that caught some
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        split = {}
        if op is not None:
            us = sum(e.device_time_total for e in events if e.key == op)
        else:
            hits = [e for e in events if str(e.device_type).endswith("CUDA")
                    and (names is None or any(n in e.key for n in names))]
            us = sum(e.self_device_time_total for e in hits)
            for e in hits:
                name = "merge" if "merge_kernel" in e.key else "main"
                split[name] = (split.get(name, 0.0)
                               + e.self_device_time_total / 1e3 / calls)
        if us > 0:
            traces.append((us, split))
        if len(traces) == 2:   # the larger of two: a trace may drop events
            break
    if not traces:
        print(f"chip_smoke: the profiler caught no device time of "
              f"{op or names or 'any kernel'} in five traces",
              file=sys.stderr)
        return None
    us, split = max(traces, key=lambda t: t[0])
    if by_kernel is not None:
        by_kernel.update(split)
    return us / 1e3 / calls


def share_of(bound_ms, res):
    """The bound over the kernel's device time (None where the profiler
    caught none or the case was not timed)."""
    return bound_ms / res["device_ms"] if res.get("device_ms") else None


def cold_times(t, kernel, plain, library, iters, profiled=True):
    """Times of ``kernel(*t)``, ``plain(*t)`` (``None``: not timed) and the
    call that ``library(t)`` returns, with the inputs rotated over copies
    that exceed the 50 MB L2, as the serving path finds each layer's cache
    cold: event ms, the mean over ``iters`` = (kernel, plain, library)
    back-to-back calls, which is the wrapper's host time where that is the
    longer; the kernel's host ms (``host_ms``); device ms, the profiler's
    time of the attention kernel's own device kernels (``ATTN_KERNELS``,
    also by kernel) and of what SDPA launches (``SDPA_OP``; the library
    call's dequantise and GQA expand stay outside it, a paged gather inside
    the call outside SDPA), over 50 and 20 calls — the host and device
    numbers only when ``profiled`` (None otherwise).  Returns a dict."""
    import torch

    nbytes = sum(x.numel() * x.element_size() for x in t[1:3])
    copies = [t] + [[None if x is None else x.clone() for x in t]
                    for _ in range(max(1, math.ceil(120e6 / nbytes)))]
    libs = [library(c) for c in copies]
    turn = {"i": 0}

    def rotate(fn):
        """fn(i) on the next copy's index, round robin."""
        def call():
            turn["i"] = (turn["i"] + 1) % len(copies)
            return fn(turn["i"])
        return call

    run_kernel = rotate(lambda i: kernel(*copies[i]))
    run_library = rotate(lambda i: libs[i]())
    by_kernel = {}
    res = {"ms": cuda_ms(run_kernel, iters[0]),
           "library_ms": cuda_ms(run_library, iters[2]),
           "copies_rotated": len(copies), "host_ms": None,
           "device_ms": None, "device_ms_by_kernel": None,
           "library_device_ms": None}
    if profiled:
        res.update(host_ms=host_ms(torch, run_kernel),
                   device_ms=device_ms(torch, run_kernel, 50, ATTN_KERNELS,
                                       by_kernel=by_kernel),
                   device_ms_by_kernel=by_kernel,
                   library_device_ms=device_ms(torch, run_library, 20,
                                               op=SDPA_OP))
    if plain is not None:
        res["plain_ms"] = cuda_ms(rotate(lambda i: plain(*copies[i])),
                                  iters[1], warmup=1)
    return res


def timed(model, window, bs=64):
    """Which kernel-phase cases are timed (``cold_times``): the ones the
    ``kernels`` line and PERF.md report — no window, 64-token blocks.
    Every case is checked against its plain version all the same; the
    profiler's device ms are taken at SmolLM-135M's heads (the line's)."""
    return window == 0 and bs == 64


def kernel_phase(torch, da, ref):
    """Each case: kernel vs plain version on the card, with the kernel's
    64-slot tiles and split, and vs the whole-cap plain version; then cold
    times (``cold_times``).  Then the split-boundary rows (``SPLIT_POS``),
    checked the same way, untimed."""
    cases = [(m, q, 0) for m in ATTN_SHAPES for q in (False, True)]
    cases.append(("smollm_135m", True, 256))
    ring_kw = dict(block=(da.KERNEL_BLOCK,), split=da.SPLIT_TILES)
    gen = torch.Generator().manual_seed(0)
    results = []
    for model, quant, window in cases:
        dims = dict(b=8, cap=1024, **ATTN_SHAPES[model])
        t = ring_inputs(gen, quant=quant, pos_vals=LONG_POS, **dims)
        _, res = check_kernel(torch, da.decode_attention,
                              ref.decode_attention_ref, t, window, ring_kw)
        if timed(model, window):
            res.update(cold_times(
                t, functools.partial(da.decode_attention, window=window),
                functools.partial(ref.decode_attention_ref, window=window),
                lambda c: library_call(c, window), (200, 20, 200),
                profiled=model == "smollm_135m"))
        bound_ms, bound_by = decode_bound(LONG_POS, quant=quant,
                                          window=window, **dims)
        results.append({
            "name": f"decode_attention[{'int8' if quant else 'bf16'}]",
            "model_shapes": model, "window": window,
            "shape": {"B": 8, "cap": 1024, **ATTN_SHAPES[model]},
            "pos": LONG_POS, **res, "kernel_ms": res.get("ms"),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": share_of(bound_ms, res)})
    for model in ATTN_SHAPES:
        for quant in (False, True):
            t = ring_inputs(gen, quant=quant, pos_vals=SPLIT_POS, b=8,
                            cap=1024, **ATTN_SHAPES[model])
            results.append({
                "name": f"decode_attention[{'int8' if quant else 'bf16'}]",
                "model_shapes": model, "window": 0, "pos": SPLIT_POS,
                "split_boundaries": True,
                **check_kernel(torch, da.decode_attention,
                               ref.decode_attention_ref, t, 0, ring_kw)[1]})
    return results


def check_kernel(torch, kernel, plain, t, window, split_kw):
    """``kernel(*t)`` on the card against ``plain(*t)`` with the kernel's
    tiles and split (``split_kw``) and against the plain version's default
    order (the ring's whole cap, the pool block, no split), both within
    ``KERNEL_TOL``; returns the output and the two max errors."""
    got = kernel(*t, window=window)
    torch.cuda.synchronize()
    want = plain(*t, window=window, **split_kw)
    whole = plain(*t, window=window)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=KERNEL_TOL, rtol=KERNEL_TOL)
    torch.testing.assert_close(got, whole, atol=KERNEL_TOL, rtol=KERNEL_TOL)
    return got, {"max_abs_err": (got - want).abs().max().item(),
                 "max_abs_err_vs_default_plain":
                     (got - whole).abs().max().item()}


def pool_inputs(gen, *, b, nbmax, bs, nkv, group, hd, quant, pos_vals,
                share, kq=None, device="cuda"):
    """A paged pool on the card: each row's blocks taken in a shuffled
    order, the rows in ``share`` reading the first row's first two blocks
    (a shared prompt prefix), unused table entries on the trash block.
    With ``kq`` (a verify call), q is (B, kq, n_kv, group, hd) and each row
    holds blocks up to position pos_i + kq - 1 (within the table)."""
    import torch

    need = [min((p + (kq or 1) - 1) // bs, nbmax - 1) + 1 for p in pos_vals]
    nblk = sum(need) + 1
    ids = torch.randperm(nblk - 1, generator=gen).tolist()
    bt = torch.full((b, nbmax), nblk - 1, dtype=torch.int32)
    for i, n in enumerate(need):
        for j in range(n):
            bt[i, j] = (bt[share[0], j] if i in share[1:] and j < 2
                        else ids.pop())
    q = torch.randn((b,) + ((kq,) if kq else ()) + (nkv, group, hd),
                    generator=gen).to(torch.bfloat16)
    if quant:
        k = torch.randint(-127, 128, (nblk, bs, nkv, hd), generator=gen,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (nblk, bs, nkv, hd), generator=gen,
                          dtype=torch.int8)
        ks = torch.rand((nblk, bs, nkv), generator=gen) * 1.9 + 0.1
        vs = torch.rand((nblk, bs, nkv), generator=gen) * 1.9 + 0.1
    else:
        k = torch.randn((nblk, bs, nkv, hd), generator=gen).to(torch.bfloat16)
        v = torch.randn((nblk, bs, nkv, hd), generator=gen).to(torch.bfloat16)
        ks = vs = None
    pos = torch.tensor(pos_vals, dtype=torch.int32)
    return [None if t is None else t.to(device)
            for t in (q, k, v, bt, pos, ks, vs)]


def paged_bound(t, window, *, quant):
    """Least time the card could take for a paged call: each distinct pool
    position the rows need (shared prefix positions once) read once, plus
    the table entries, the queries, positions and output; the QK and PV
    flops over the peak rate of the pool's type.  Returns (ms, bound_by,
    distinct bytes, bytes counted per slot)."""
    q, k, _, bt, pos, _, _ = t
    kq = q.shape[1] if q.dim() == 5 else 1         # verify: kq query rows
    b, nkv, group, hd = q.shape[0], *q.shape[-3:]
    bs = k.shape[1]
    top = bt.shape[1] * bs - 1                      # the table's last position
    per_pos = nkv * hd * (1 if quant else 2) * 2 + (nkv * 8 if quant else 0)
    seen, per_slot = set(), 0
    bt_h, pos_h = bt.cpu().tolist(), pos.cpu().tolist()
    for row, p0 in zip(bt_h, pos_h):
        for p in range(p0, p0 + kq):
            p = min(p, top)
            lo = max(0, p - window + 1) if window else 0
            for x in range(lo, p + 1):
                seen.add((row[x // bs], x % bs))
            per_slot += p + 1 - lo
    fixed = (b * kq * nkv * group * hd * (2 + 4) + b * 4
             + sum(min(p + kq - 1, top) // bs + 1 for p in pos_h) * 4)
    nbytes = len(seen) * per_pos + fixed
    ops = 4 * group * hd * nkv * per_slot
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS["int8" if quant else "bf16"]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes,
            per_slot * per_pos + fixed)


def paged_library_call(t, window):
    """One PyTorch route to the same function, timed as a yardstick only
    (the port never calls it): gather each row's blocks through the table
    with torch indexing, dequantise an int8 pool, expand K/V over the GQA
    group and run ``F.scaled_dot_product_attention`` with the mask."""
    import torch
    import torch.nn.functional as F

    q, k, v, bt, pos, ks, vs = t
    b, nkv, group, hd = q.shape
    nbmax, bs = bt.shape[1], k.shape[1]
    kp = torch.arange(nbmax * bs, device=q.device)[None, :]
    p = pos[:, None]
    mask = kp <= p
    if window:
        mask = mask & (kp > p - window)
    mask = mask[:, None, None, :]
    qq = q.reshape(b, nkv * group, 1, hd)
    idx = bt.long()

    def call():
        kk, vv = k[idx], v[idx]                     # (B, nbmax, bs, nkv, hd)
        if ks is not None:
            kk = (kk.float() * (ks[idx][..., None] / 127.0)).to(torch.bfloat16)
            vv = (vv.float() * (vs[idx][..., None] / 127.0)).to(torch.bfloat16)
        kk = kk.reshape(b, nbmax * bs, nkv, hd).permute(0, 2, 1, 3)
        vv = vv.reshape(b, nbmax * bs, nkv, hd).permute(0, 2, 1, 3)
        kk = kk.repeat_interleave(group, dim=1)
        vv = vv.repeat_interleave(group, dim=1)
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)

    return call


def ring_as_pool(torch, gen, t, bs=None):
    """The ring snapshot ``t`` (no wrap) as a pool of ``bs``-token blocks
    (default KERNEL_BLOCK) in shuffled order, with its block table: (q, k,
    v, block_tables, pos, k_scale, v_scale)."""
    from repro_torch.kernels.decode_attention import KERNEL_BLOCK

    q, k, v, _, pos, ks, vs = t
    b, cap = k.shape[:2]
    bs = bs or KERNEL_BLOCK
    nb = cap // bs
    perm = torch.randperm(b * nb, generator=gen).to(q.device)

    def to_pool(x):
        if x is None:
            return None
        tail = tuple(x.shape[2:])
        pool = torch.zeros((b * nb + 1, bs) + tail, dtype=x.dtype,
                           device=x.device)
        pool[perm] = x.reshape((b * nb, bs) + tail)
        return pool

    return [q, to_pool(k), to_pool(v), perm.reshape(b, nb).to(torch.int32),
            pos, to_pool(ks), to_pool(vs)]


def paged_kernel_phase(torch, da, pda, ref):
    """Each case: the paged kernel vs its plain version on the card (with
    the kernels' split and without), then cold times (``cold_times``).
    Positions are the ring case's, unwrapped (a table of 2048 tokens);
    row 6 shares row 5's first two blocks.  Then the bitwise check:
    paged at 64-token blocks against the ring kernel at bk = 64 on one
    stream, at ``LONG_POS`` and at the split-boundary rows."""
    gen = torch.Generator().manual_seed(1)
    results = []
    for model in ATTN_SHAPES:
        for quant in (False, True):
            for bs in (16, 64):
                for window in (0, 256):
                    dims = dict(b=8, nbmax=2048 // bs, bs=bs,
                                **ATTN_SHAPES[model])
                    t = pool_inputs(gen, quant=quant, pos_vals=LONG_POS,
                                    share=(5, 6), **dims)
                    _, res = check_kernel(
                        torch, pda.paged_decode_attention,
                        ref.paged_decode_attention_ref, t, window,
                        dict(split=da.SPLIT_TILES))
                    if timed(model, window, bs):
                        res.update(cold_times(
                            t, functools.partial(pda.paged_decode_attention,
                                                 window=window),
                            functools.partial(ref.paged_decode_attention_ref,
                                              window=window),
                            lambda c: paged_library_call(c, window),
                            (200, 10, 50), profiled=model == "smollm_135m"))
                    bound_ms, bound_by, nbytes, slot_bytes = paged_bound(
                        t, window, quant=quant)
                    results.append({
                        "name": "paged_decode_attention"
                                f"[{'int8' if quant else 'bf16'}]",
                        "model_shapes": model, "window": window,
                        "shape": {"B": 8, "bs": bs, "nbmax": 2048 // bs,
                                  **ATTN_SHAPES[model]},
                        "pos": LONG_POS, **res, "kernel_ms": res.get("ms"),
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "distinct_bytes": nbytes,
                        "per_slot_bytes": slot_bytes,
                        "share_of_bound": share_of(bound_ms, res)})

    # paged == ring, bit for bit, at bs == bk == 64 on one stream
    bitwise = []
    for pos_vals in (LONG_POS, SPLIT_POS):
        for quant in (False, True):
            for window in (0, 256):
                t = ring_inputs(gen, quant=quant, pos_vals=pos_vals, b=8,
                                cap=2048, **ATTN_SHAPES["smollm_135m"])
                ring = da.decode_attention(*t, window=window)
                paged = pda.paged_decode_attention(
                    *ring_as_pool(torch, gen, t), window=window)
                torch.cuda.synchronize()
                same = torch.equal(ring, paged)
                assert same, (quant, window,
                              (ring - paged).abs().max().item())
                bitwise.append({"kv": "int8" if quant else "bf16",
                                "window": window, "pos": pos_vals,
                                "bitwise_equal": same})
    return results, bitwise


def verify_bound(pos_vals, kq, *, b, cap, nkv, group, hd, quant, window):
    """``decode_bound``'s model for a verify call: the distinct cache
    positions the kq rows need (up to pos + kq - 1, each read once), the
    queries and outputs of kq rows, and the flops of every row.  Returns
    (ms, 'bytes'|'operations')."""
    n = sum(needed_positions([p + kq - 1 for p in pos_vals], cap,
                             window + kq - 1 if window else 0))
    per_pos = nkv * hd * (1 if quant else 2) * 2 + 4     # K, V, k_pos
    if quant:
        per_pos += nkv * 4 * 2                           # k_scale, v_scale
    nbytes = n * per_pos + b * kq * nkv * group * hd * (2 + 4) + b * 4
    rows = [p + t for p in pos_vals for t in range(kq)]
    ops = 4 * group * hd * nkv * sum(needed_positions(rows, cap, window))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS["int8" if quant else "bf16"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def verify_mask(kp, pos, kq, window):
    """(B, 1, kq, n_keys) bool: row t of slot b sees keys at positions
    kp ≥ 0, ≤ pos + t (and inside the window)."""
    import torch

    qp = pos[:, None] + torch.arange(kq, device=pos.device)[None, :]
    kp = kp[:, None, :]
    mask = (kp >= 0) & (kp <= qp[:, :, None])
    if window:
        mask = mask & (kp > qp[:, :, None] - window)
    return mask[:, None]


def verify_library_call(t, window):
    """``F.scaled_dot_product_attention`` with a per-row causal mask over
    the bf16 ring (an int8 one dequantised first, outside the timed call),
    K/V expanded over the GQA group — a yardstick only; the port never
    calls it."""
    import torch
    import torch.nn.functional as F

    q, k, v, kp, pos, ks, vs = t
    b, kq, nkv, group, hd = q.shape
    if ks is not None:
        k = (k.float() * (ks[..., None] / 127.0)).to(torch.bfloat16)
        v = (v.float() * (vs[..., None] / 127.0)).to(torch.bfloat16)
    kk = k.permute(0, 2, 1, 3).repeat_interleave(group, dim=1).contiguous()
    vv = v.permute(0, 2, 1, 3).repeat_interleave(group, dim=1).contiguous()
    qq = q.permute(0, 2, 3, 1, 4).reshape(b, nkv * group, kq, hd)
    mask = verify_mask(kp, pos, kq, window)
    return lambda: F.scaled_dot_product_attention(qq, kk, vv,
                                                  attn_mask=mask)


def paged_verify_library_call(t, window):
    """The paged verify yardstick: gather each row's blocks through the
    table, dequantise an int8 pool, expand over the GQA group and run
    ``F.scaled_dot_product_attention`` with the per-row mask, all inside
    the timed call (as ``paged_library_call``)."""
    import torch
    import torch.nn.functional as F

    q, k, v, bt, pos, ks, vs = t
    b, kq, nkv, group, hd = q.shape
    nbmax, bs = bt.shape[1], k.shape[1]
    kp = torch.arange(nbmax * bs, device=q.device)[None, :].expand(b, -1)
    mask = verify_mask(kp, pos, kq, window)
    qq = q.permute(0, 2, 3, 1, 4).reshape(b, nkv * group, kq, hd)
    idx = bt.long()

    def call():
        kk, vv = k[idx], v[idx]                     # (B, nbmax, bs, nkv, hd)
        if ks is not None:
            kk = (kk.float() * (ks[idx][..., None] / 127.0)).to(torch.bfloat16)
            vv = (vv.float() * (vs[idx][..., None] / 127.0)).to(torch.bfloat16)
        kk = kk.reshape(b, nbmax * bs, nkv, hd).permute(0, 2, 1, 3)
        vv = vv.reshape(b, nbmax * bs, nkv, hd).permute(0, 2, 1, 3)
        kk = kk.repeat_interleave(group, dim=1)
        vv = vv.repeat_interleave(group, dim=1)
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)

    return call


def rows_equal(torch, got, decode, t, window):
    """Row r of a verify output against ``decode`` at pos + r, bit for
    bit."""
    q, k, v, index, pos, ks, vs = t
    for r in range(q.shape[1]):
        one = decode(q[:, r].contiguous(), k, v, index, pos + r, ks, vs,
                     window=window)
        torch.cuda.synchronize()
        if not torch.equal(got[:, r], one):
            return False
    return True


def verify_kernel_phase(torch, da, pda, va, pva, ref):
    """Kernels 3 and 4, each case on the card: the verify kernel against
    its plain version with the kernels' tiles and split, and without the
    split, within ``KERNEL_TOL``; every row t equal to the decode kernel
    (ring or paged) at pos + t, bit for bit; then cold times
    (``cold_times``) and the bound.  Positions are the decode cases' plus
    one slot two short of the end (ring cap 1024, table 2048), so rows run
    past the cache's end; K = 4, and K = 8 at Qwen2-1.5B's heads (48 rows
    a block).  Then the ring kernel's rows either side of the split
    boundaries (``VERIFY_SPLIT_POS``), untimed.  Then paged verify at
    64-token blocks against ring verify at bk 64 on one stream, bit for
    bit."""
    gen = torch.Generator().manual_seed(4)
    cases = [(m, q, w, 4) for m in ATTN_SHAPES for q in (False, True)
             for w in (0, 256)]
    cases.append(("qwen2_1_5b", True, 0, 8))
    ring_kw = dict(block=(da.KERNEL_BLOCK,), split=da.SPLIT_TILES)
    ring, paged = [], []

    for model, quant, window, kq in cases:
        pos_vals = LONG_POS + [1022]
        dims = dict(b=9, cap=1024, **ATTN_SHAPES[model])
        t = ring_inputs(gen, quant=quant, pos_vals=pos_vals, kq=kq, **dims)
        got, res = check_kernel(torch, va.verify_attention,
                                ref.verify_attention_ref, t, window, ring_kw)
        same = rows_equal(torch, got, da.decode_attention, t, window)
        assert same, (model, quant, window, kq)
        if timed(model, window):
            res.update(cold_times(
                t, functools.partial(va.verify_attention, window=window),
                functools.partial(ref.verify_attention_ref, window=window),
                lambda c: verify_library_call(c, window), (200, 5, 100),
                profiled=model == "smollm_135m"))
        bound_ms, bound_by = verify_bound(pos_vals, kq, quant=quant,
                                          window=window, **dims)
        ring.append({
            "name": f"verify_attention[{'int8' if quant else 'bf16'}]",
            "model_shapes": model, "window": window, "kq": kq,
            "shape": {"B": 9, "cap": 1024, "kq": kq, **ATTN_SHAPES[model]},
            "pos": pos_vals, **res, "kernel_ms": res.get("ms"),
            "rows_equal_decode_kernel_bitwise": same,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": share_of(bound_ms, res)})
    for model, quant, kq in [(m, q, 4) for m in ATTN_SHAPES
                             for q in (False, True)] + [("qwen2_1_5b", True,
                                                         8)]:
        t = ring_inputs(gen, quant=quant, pos_vals=VERIFY_SPLIT_POS, kq=kq,
                        b=8, cap=1024, **ATTN_SHAPES[model])
        got, res = check_kernel(torch, va.verify_attention,
                                ref.verify_attention_ref, t, 0, ring_kw)
        same = rows_equal(torch, got, da.decode_attention, t, 0)
        assert same, (model, quant, kq)
        ring.append({
            "name": f"verify_attention[{'int8' if quant else 'bf16'}]",
            "model_shapes": model, "window": 0, "kq": kq,
            "pos": VERIFY_SPLIT_POS, "split_boundaries": True, **res,
            "rows_equal_decode_kernel_bitwise": same})

    for model, quant, window, kq in cases:
        for bs in ((16, 64) if kq == 4 else (64,)):
            pos_vals = LONG_POS + [2046]
            dims = dict(b=9, nbmax=2048 // bs, bs=bs, **ATTN_SHAPES[model])
            t = pool_inputs(gen, quant=quant, pos_vals=pos_vals,
                            share=(5, 6), kq=kq, **dims)
            got, res = check_kernel(
                torch, pva.paged_verify_attention,
                ref.paged_verify_attention_ref, t, window,
                dict(split=da.SPLIT_TILES))
            same = rows_equal(torch, got, pda.paged_decode_attention, t,
                              window)
            assert same, (model, quant, window, kq, bs)
            if timed(model, window, bs):
                res.update(cold_times(
                    t, functools.partial(pva.paged_verify_attention,
                                         window=window),
                    functools.partial(ref.paged_verify_attention_ref,
                                      window=window),
                    lambda c: paged_verify_library_call(c, window),
                    (200, 2, 50), profiled=model == "smollm_135m"))
            bound_ms, bound_by, nbytes, slot_bytes = paged_bound(
                t, window, quant=quant)
            paged.append({
                "name": "paged_verify_attention"
                        f"[{'int8' if quant else 'bf16'}]",
                "model_shapes": model, "window": window, "kq": kq,
                "shape": {"B": 9, "bs": bs, "nbmax": 2048 // bs, "kq": kq,
                          **ATTN_SHAPES[model]},
                "pos": pos_vals, **res, "kernel_ms": res.get("ms"),
                "rows_equal_decode_kernel_bitwise": same,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "distinct_bytes": nbytes, "per_slot_bytes": slot_bytes,
                "share_of_bound": share_of(bound_ms, res)})

    # paged verify == ring verify, bit for bit, at bs == bk == 64 on one
    # stream (every row inside the 2048-slot ring, so nothing wraps)
    bitwise = []
    for pos_vals in ([0, 37, 255, 511, 700, 1023, 1500, 2044],
                     VERIFY_SPLIT_POS):
        for quant in (False, True):
            for window in (0, 256):
                t = ring_inputs(gen, quant=quant, pos_vals=pos_vals, kq=4,
                                b=8, cap=2048, **ATTN_SHAPES["smollm_135m"])
                r = va.verify_attention(*t, window=window)
                pg = pva.paged_verify_attention(*ring_as_pool(torch, gen, t),
                                                window=window)
                torch.cuda.synchronize()
                same = torch.equal(r, pg)
                assert same, (quant, window, (r - pg).abs().max().item())
                bitwise.append({"kv": "int8" if quant else "bf16",
                                "window": window, "pos": pos_vals,
                                "bitwise_equal": same})
    return ring, paged, bitwise


def attention_times(torch, sets=("long", "serve")):
    """Kernels 1-4 timed alone (``cold_times``, no plain version), bf16 and
    int8, window 0, K 4: at the kernels phase's shapes ("long": B 8, a
    1024-slot ring or a 2048-token table of 64-token blocks, ``LONG_POS``,
    SmolLM-135M's and Qwen2-1.5B's heads) and at the serve profile's
    ("serve": B 8, ``SERVE_POS``, a 1024-token cache, SmolLM-135M's heads;
    the paged slots share their first two blocks, as the profile's prompts
    share a prefix).  Decode and verify take the same positions.  It calls
    only the wrappers, so it times any tree of the port
    (``--attention-times``)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_verify_attention as pva
    from repro_torch.kernels import verify_attention as va

    gen = torch.Generator().manual_seed(7)
    rows = []
    for shape_set in sets:
        pos_vals = LONG_POS if shape_set == "long" else SERVE_POS
        models = (list(ATTN_SHAPES) if shape_set == "long"
                  else ["smollm_135m"])
        nbmax = 32 if shape_set == "long" else 16
        share = (5, 6) if shape_set == "long" else tuple(range(8))
        for model in models:
            heads = ATTN_SHAPES[model]
            for quant in (False, True):
                ring = dict(b=8, cap=1024, quant=quant, pos_vals=pos_vals,
                            **heads)
                pool = dict(b=8, nbmax=nbmax, bs=64, quant=quant,
                            pos_vals=pos_vals, share=share, **heads)
                for name, fn, t, library in (
                        ("decode_attention", da.decode_attention,
                         ring_inputs(gen, **ring), library_call),
                        ("verify_attention", va.verify_attention,
                         ring_inputs(gen, kq=SPEC_K, **ring),
                         verify_library_call),
                        ("paged_decode_attention", pda.paged_decode_attention,
                         pool_inputs(gen, **pool), paged_library_call),
                        ("paged_verify_attention", pva.paged_verify_attention,
                         pool_inputs(gen, kq=SPEC_K, **pool),
                         paged_verify_library_call)):
                    res = cold_times(t, fn, None,
                                     lambda c, lib=library: lib(c, 0),
                                     (200, 0, 100))
                    if name.startswith("paged"):
                        bound_ms, bound_by = paged_bound(t, 0,
                                                         quant=quant)[:2]
                    elif name == "verify_attention":
                        bound_ms, bound_by = verify_bound(
                            pos_vals, SPEC_K, window=0,
                            **{k: v for k, v in ring.items()
                               if k != "pos_vals"})
                    else:
                        bound_ms, bound_by = decode_bound(
                            pos_vals, window=0,
                            **{k: v for k, v in ring.items()
                               if k != "pos_vals"})
                    kv = "int8" if quant else "bf16"
                    rows.append({"name": f"{name}[{kv}]", "shapes": shape_set,
                                 "model_shapes": model, "pos": pos_vals,
                                 **res, "bound_ms": bound_ms,
                                 "bound_by": bound_by})
    return rows


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def attention_times_worker(root: str, label: str) -> int:
    """One tree's ``attention_times``, in this process: the port under
    ``root/src`` is imported, its kernels 1-4 built and timed, and one
    ``{"attention_times": label, ...}`` line printed."""
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from repro_torch.kernels import _build

    secs = _build.build(["decode_attention", "verify_attention",
                         "paged_decode_attention", "paged_verify_attention"])
    emit({"attention_times": label, "root": str(root),
          "nvidia_smi": nvidia_smi(), "build_s": secs,
          "rows": attention_times(torch)})
    return 0


def split_tree(n: int) -> Path:
    """A copy of this checkout's port under ``build/split_sweep/S<n>`` with
    the split span ``kSplitTiles`` (and the wrappers' ``SPLIT_TILES``) set
    to ``n`` tiles: the trees ``--attention-times split=<n>`` times."""
    import shutil

    dst = ROOT / "build" / "split_sweep" / f"S{n}"
    shutil.rmtree(dst, ignore_errors=True)
    pkg = dst / "src" / "repro_torch"
    shutil.copytree(ROOT / "src" / "repro_torch", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, pattern in (
            ("kernels/csrc/flash_decode.cuh",
             r"(constexpr int kSplitTiles = )\d+;"),
            ("kernels/decode_attention.py", r"(SPLIT_TILES = )\d+ ")):
        path = pkg / rel
        text, count = re.subn(pattern, lambda m: f"{m.group(1)}{n}"
                              + m.group(0)[-1], path.read_text())
        assert count == 1, (rel, pattern)
        path.write_text(text)
    return dst


def times_main(mode: str, trees) -> int:
    """``--attention-times TREE ...`` / ``--dither-times TREE ...``: each
    TREE — a checkout's root, or (attention) ``split=N`` for this
    checkout's port at a split span of N tiles (``split_tree``) — timed in
    a process of its own, one after the other in the order given (for a
    comparison on one card: parent, change, change, parent)."""
    for tree in trees:
        root = (split_tree(int(tree.split("=")[1]))
                if tree.startswith("split=") else Path(tree))
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        f"{mode}-of", str(root), tree],
                       check=True, timeout=900)
    return 0


def dither_times_worker(root: str, label: str) -> int:
    """One tree's ``dither_times`` and its dither-policy decode tick
    (``profile_phase``, bf16 and int8 KV, full-width SmolLM-135M), in this
    process: the port under ``root/src`` is imported, its kernels built,
    and one ``{"dither_times": label, ...}`` line printed."""
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import dither_matmul as dm
    from repro_torch.kernels import quantize as qk
    from repro_torch.models import registry
    from repro_torch.numerics import policy

    torch.backends.cuda.matmul.allow_tf32 = False
    secs = _build.build(["quantize", "dither_matmul", "decode_attention"])
    rows = dither_times(torch, qk, dm, policy)
    cfg = get_config("smollm_135m")
    params = registry.init_model(cfg, seed=0, device="cuda")
    ticks = [profile_phase(torch, cfg, params, kv_quant,
                           policy=policy.QuantPolicy(scheme="dither",
                                                     backend="auto"))
             for kv_quant in (False, True)]
    emit({"dither_times": label, "root": str(root),
          "nvidia_smi": nvidia_smi(), "build_s": secs,
          "int32_ops_per_s": int32_ops_per_s()[0], "rows": rows,
          "policy_ticks": ticks})
    return 0


def row_purity_phase(torch, cfg, params):
    """Are the library ops of a verify forward row-pure on this card?  For
    each projection of a full-width layer, the norm and the LM head:
    ``transformer.row_purity`` — the op over (B, K) rows at once against
    the op on each (B, 1, ·) row at decode's own shape, on inputs that make
    a reordered f32 sum show — at batch 8 with K = 4 (the serve phases'
    shape) and K = 8.  The engine fuses the ops at 0 and runs the others
    per row."""
    from repro_torch.models import transformer

    out = {f"K{kq}": transformer.row_purity(params, cfg, 8, kq)
           for kq in (SPEC_K, 8)}
    torch.cuda.synchronize()
    return {"phase": "row_purity", "B": 8, "differing_outputs": out,
            "fused_at_serve_shape": sorted(
                op for op, n in out[f"K{SPEC_K}"].items() if n == 0)}


# ---------------------------------------------------------------- phase 4


def ring_requests(cfg, n, lens, max_new):
    """The ring serve phases' traffic: random prompts of ``lens`` tokens,
    even requests greedy, odd ones at temperature 0.8 with top-k 40, one
    counter offset per request."""
    import numpy as np

    from repro_torch.serve import Request, SamplingParams

    rng = np.random.default_rng(0)
    out = []
    for r in range(n):
        prompt = rng.integers(1, cfg.vocab_size, size=int(lens[r]))
        greedy = r % 2 == 0
        out.append(Request(rid=r, prompt=prompt.tolist(),
                           sampling=SamplingParams(
                               temperature=0.0 if greedy else 0.8,
                               top_k=0 if greedy else 40, seed=r,
                               max_new=max_new, counter_offset=1000 * r)))
    return out


def ring_lens():
    import numpy as np

    return np.random.default_rng(1).permutation(
        np.linspace(32, 512, SERVE_REQUESTS).astype(int))


def paged_requests(cfg, n, suffix_lens, max_new, system_len=256):
    """The paged serve phases' traffic: a shared system prompt of
    ``system_len`` tokens, then a random suffix per request; the ring
    traffic's sampling mix, one counter offset for all (so the int8 pool's
    prefix chain matches)."""
    import numpy as np

    from repro_torch.serve import Request, SamplingParams

    rng = np.random.default_rng(0)
    system = rng.integers(1, cfg.vocab_size, size=system_len).tolist()
    out = []
    for r in range(n):
        suffix = rng.integers(1, cfg.vocab_size, size=int(suffix_lens[r]))
        greedy = r % 2 == 0
        out.append(Request(rid=r, prompt=system + suffix.tolist(),
                           sampling=SamplingParams(
                               temperature=0.0 if greedy else 0.8,
                               top_k=0 if greedy else 40, seed=r,
                               max_new=max_new, counter_offset=0)))
    return out


def paged_lens():
    import numpy as np

    return np.random.default_rng(1).permutation(
        np.linspace(16, 256, SERVE_REQUESTS).astype(int))


def paged_engine(cfg, params, kv_quant, device="cuda", **kw):
    from repro_torch.serve import Engine

    return Engine(params, cfg, 8, 1024, kv_quant=kv_quant, kv_layout="paged",
                  block_size=64, num_blocks=PAGED_BLOCKS, device=device, **kw)


def attn_layers(cfg):
    """The config's attention layers (all of them but in a model with
    recurrent SSD or RG-LRU layers)."""
    return sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))


def launch_gates(eng, host, kernel, cfg):
    """The launch gates of a policy-free serve run, whose windows are
    CUDA-graph replays: one replay per window, each graph holding one
    ``kernel`` launch per attention layer and tick, so the run launched
    it ``attn_layers × ticks`` times (replays × launches per graph; ticks
    = ``decode_ticks`` × windows, less where pool pressure stepped windows
    down to one tick) and no other kernel; the host counts (``host``:
    kernel → count, set to 0 just before the run) saw one eager warm-up
    window and one capture per graph and nothing else, so no window ran
    eagerly.  A model with recurrent state prefills through its captured
    scanned-prefill step (``PrefillGraphs``): one more warm-up and
    capture, and ``attn_layers`` launches a replay, one replay a prompt
    position.  Returns the launches each kernel really made: the host's
    less what the captures recorded, plus the replays'.  (Eager windows on
    the CPU: the host counts.)"""
    ticks, windows = eng.tick, eng.stats["decode_calls"]
    g, n_attn = eng._graphs, attn_layers(cfg)
    if g is None:
        assert host[kernel] == n_attn * ticks, (host, ticks)
        return dict(host)
    replayed, recorded = g.launches(), g.recorded()
    pf = getattr(getattr(eng, "_prefill", None), "step_launches", None)
    if pf is not None:
        assert pf[kernel] == n_attn, pf
        assert all(v == 0 for k, v in pf.items() if k != kernel), pf
        for k, n in eng._prefill.launches().items():
            replayed[k] += n
        for k, n in pf.items():
            recorded[k] += n
    assert g.replays == windows, (g.replays, windows)
    for key, w in g.windows().items():
        assert w["launches"][kernel] == n_attn * key[0], (key, w)
    pf_replays = eng._prefill.replays if pf is not None else 0
    assert replayed[kernel] == n_attn * (ticks + pf_replays), (replayed,
                                                               ticks)
    assert all(v == 0 for k, v in replayed.items() if k != kernel), replayed
    assert all(host[k] == 2 * recorded[k] for k in host), (host, recorded)
    return {k: host[k] - recorded[k] + replayed[k] for k in host}


def serve_phase(torch, da, pda, cfg, params, kv_quant, device="cuda",
                decode_ticks=1, prefill_chunk=None):
    """The ring path: ``SERVE_REQUESTS`` requests (``ring_requests``),
    prompts spread over 32–512 tokens, 64 new tokens each; batch 8;
    windows of ``decode_ticks`` ticks (one CUDA-graph replay each),
    prompts in chunks of ``prefill_chunk`` tokens if given.  Returns the
    phase's line and the streams {prompt: output}."""
    from repro_torch.serve import Engine
    from repro_torch.serve.graphs import KERNEL_WRAPPERS

    knobs = dict(kv_quant=kv_quant, device=device, decode_ticks=decode_ticks,
                 prefill_chunk=prefill_chunk)
    # warm-up wave: loads the kernel library and PyTorch's own kernels, at
    # every prefill length bucket the run meets
    warm = Engine(params, cfg, 8, 1024, **knobs)
    for req in ring_requests(cfg, 5, [20, 40, 100, 200, 300], 4):
        warm.submit(req)
    warm.run(50)
    del warm

    lens = ring_lens()
    n = SERVE_REQUESTS
    eng = Engine(params, cfg, 8, 1024, **knobs)
    for req in ring_requests(cfg, n, lens, 64):
        eng.submit(req)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    for m in KERNEL_WRAPPERS.values():
        m.launches = 0
    t0 = time.perf_counter()
    done = eng.run(10_000)
    sync()
    wall = time.perf_counter() - t0
    host = {k: m.launches for k, m in KERNEL_WRAPPERS.items()}
    st = eng.stats
    assert len(done) == n, len(done)
    for r in done:
        assert r.finish_reason == "length" and len(r.out) == 64, (
            r.rid, r.finish_reason, len(r.out))
        assert all(0 <= t < cfg.vocab_size for t in r.out)
    launches = launch_gates(eng, host, "decode_attention", cfg)
    streams = {tuple(r.prompt): list(r.out) for r in done}
    capture_s = eng._graphs.capture_s if eng._graphs is not None else 0.0
    return {"phase": "serve", "layout": "ring",
            "kv": "int8" if kv_quant else "bf16",
            "requests": n, "prompt_tokens": int(sum(lens)),
            "new_tokens_each": 64, "batch": 8, "max_len": 1024,
            "decode_ticks_per_window": decode_ticks,
            "prefill_chunk": eng.prefill_chunk,
            "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
            "decode_tok_s": st["decode_tokens"] / st["decode_s"],
            "decode_tok_s_after_capture": st["decode_tokens"]
                                          / (st["decode_s"] - capture_s),
            "capture_s": capture_s,
            "prefill_calls": st["prefill_calls"],
            "decode_ticks": eng.tick,
            "windows": st["decode_calls"], "wall_s": wall,
            "graph_replays": (eng._graphs.replays
                              if eng._graphs is not None else 0),
            "decode_attention_launches": launches["decode_attention"],
            "launches_per_window": cfg.n_layers * decode_ticks}, streams


def paged_serve_phase(torch, da, pda, cfg, params, kv_quant, device="cuda",
                      decode_ticks=1):
    """The paged path: ``SERVE_REQUESTS`` requests (``paged_requests``)
    sharing a 256-token system prompt, then suffixes of 16–256 tokens, 64
    new tokens each; batch 8, 64-token blocks, a pool of ``PAGED_BLOCKS``
    against the 8 × 16 a dense cache would hold; windows of
    ``decode_ticks`` ticks (one CUDA-graph replay each).  Later requests
    hit the prefix cache and the pool runs dry, so requests are preempted
    with their blocks and resumed.  Returns the phase's line and the
    streams."""
    from repro_torch.serve.graphs import KERNEL_WRAPPERS

    # warm-up waves, cold and with prefix hits, at every length bucket
    warm = paged_engine(cfg, params, kv_quant, device,
                        decode_ticks=decode_ticks, degrade_high=None)
    for req in paged_requests(cfg, 12, [16, 30, 60, 120, 240] * 3, 4):
        warm.submit(req)
    warm.run(100)
    del warm

    lens = paged_lens()
    n = SERVE_REQUESTS
    eng = paged_engine(cfg, params, kv_quant, device,
                       decode_ticks=decode_ticks, degrade_high=None)
    for req in paged_requests(cfg, n, lens, 64):
        eng.submit(req)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    for m in KERNEL_WRAPPERS.values():
        m.launches = 0
    t0 = time.perf_counter()
    done = eng.run(10_000)
    sync()
    wall = time.perf_counter() - t0
    host = {k: m.launches for k, m in KERNEL_WRAPPERS.items()}
    st = eng.stats
    assert len(done) == n, len(done)
    for r in done:
        assert r.finish_reason == "length" and len(r.out) == 64, (
            r.rid, r.finish_reason, len(r.out))
        assert all(0 <= t < cfg.vocab_size for t in r.out)
    assert st["prefix_hit_tokens"] > 0, st
    assert st["preemptions"] >= 1, st
    assert eng.pool.live_blocks == 0, eng.pool_stats()
    launches = launch_gates(eng, host, "paged_decode_attention", cfg)
    streams = {tuple(r.prompt): list(r.out) for r in done}
    capture_s = eng._graphs.capture_s if eng._graphs is not None else 0.0
    return {"phase": "serve", "layout": "paged",
            "kv": "int8" if kv_quant else "bf16", "requests": n,
            "prompt_tokens": int(256 * n + sum(lens)),
            "new_tokens_each": 64, "batch": 8, "max_len": 1024,
            "block_size": 64, "num_blocks": PAGED_BLOCKS,
            "decode_ticks_per_window": decode_ticks,
            "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
            "decode_tok_s": st["decode_tokens"] / st["decode_s"],
            "decode_tok_s_after_capture": st["decode_tokens"]
                                          / (st["decode_s"] - capture_s),
            "capture_s": capture_s,
            "prefill_tokens_computed": st["prefill_tokens"],
            "prefix_hit_tokens": st["prefix_hit_tokens"],
            "preemptions": st["preemptions"], "pool": eng.pool_stats(),
            "degrade_events": eng.metrics.counters.get("degrade_events", 0),
            "prefill_calls": st["prefill_calls"],
            "decode_ticks": eng.tick,
            "windows": st["decode_calls"], "wall_s": wall,
            "graph_replays": (eng._graphs.replays
                              if eng._graphs is not None else 0),
            "paged_decode_attention_launches":
                launches["paged_decode_attention"],
            "launches_per_window": cfg.n_layers * decode_ticks}, streams


def spec_serve_phase(torch, kmods, cfg, params, kv_quant, layout, plain,
                     streams, drafter, device="cuda"):
    """The speculative path on a serve phase's own traffic: the same
    requests through ``Engine(spec_decode=True, draft_k=SPEC_K)`` with
    ``drafter`` "replay" (a ``ReplayDrafter`` of the plain streams, so most
    drafts are accepted) or "lookup" (``PromptLookupDrafter``, the
    default).  Every spec stream must equal the plain stream token for
    token, every request finish its budget, the paged pool end with no live
    block, the layout's verify kernel launch once per layer per window and
    no decode kernel launch.  ``plain`` is the plain phase's line."""
    from repro_torch.serve.draft import PromptLookupDrafter, ReplayDrafter

    paged = layout == "paged"
    dr = (ReplayDrafter(streams) if drafter == "replay"
          else PromptLookupDrafter())
    if paged:
        eng = paged_engine(cfg, params, kv_quant, device, spec_decode=True,
                           draft_k=SPEC_K, drafter=dr)
        reqs = paged_requests(cfg, SERVE_REQUESTS, paged_lens(), 64)
    else:
        from repro_torch.serve import Engine

        eng = Engine(params, cfg, 8, 1024, kv_quant=kv_quant, device=device,
                     spec_decode=True, draft_k=SPEC_K, drafter=dr)
        reqs = ring_requests(cfg, SERVE_REQUESTS, ring_lens(), SPEC_RING_NEW)
    new = 64 if paged else SPEC_RING_NEW
    for req in reqs:
        eng.submit(req)
    torch.cuda.synchronize()
    for m in kmods.values():
        setattr(m, "launches", 0)
    t0 = time.perf_counter()
    done = eng.run(10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: m.launches for n, m in kmods.items()}
    st = eng.stats
    assert len(done) == SERVE_REQUESTS, len(done)
    for r in done:
        assert r.finish_reason == "length" and len(r.out) == new, (
            r.rid, r.finish_reason, len(r.out))
    differ = [r.rid for r in done
              if r.out != streams[tuple(r.prompt)][:new]]
    assert not differ, ("spec streams differ from plain", layout, kv_quant,
                        drafter, differ)
    kernel = "paged_verify_attention" if paged else "verify_attention"
    windows = st["spec_windows"]
    assert windows == st["decode_calls"] > 0, st
    assert launches[kernel] == cfg.n_layers * windows, (launches, windows)
    assert all(v == 0 for n, v in launches.items() if n != kernel), launches
    if paged:
        assert eng.pool.live_blocks == 0, eng.pool_stats()
    slot_windows = st["spec_emitted_tokens"] - st["spec_accepted_tokens"]
    if drafter == "replay":
        assert st["spec_emitted_tokens"] > slot_windows, st
    return {"phase": "spec_serve", "layout": layout,
            "kv": "int8" if kv_quant else "bf16", "drafter": drafter,
            "draft_k": SPEC_K, "requests": SERVE_REQUESTS,
            "new_tokens_each": new,
            "streams_equal_plain": True, "windows": windows,
            "slot_windows": slot_windows,
            "drafted": st["spec_draft_tokens"],
            "accepted": st["spec_accepted_tokens"],
            "emitted": st["spec_emitted_tokens"],
            "acceptance": st["spec_accepted_tokens"]
                          / max(1, st["spec_draft_tokens"]),
            "tokens_per_window": st["spec_emitted_tokens"] / windows,
            "tokens_per_slot_window": st["spec_emitted_tokens"]
                                      / slot_windows,
            "decode_tok_s": st["decode_tokens"] / st["decode_s"],
            "plain_decode_tok_s": plain["decode_tok_s"],
            "plain_decode_ticks": plain["decode_ticks"],
            "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
            "prefix_hit_tokens": st["prefix_hit_tokens"],
            "preemptions": st["preemptions"], "wall_s": wall,
            "verify_fused_ops": sorted(eng.verify_fused_ops),
            f"{kernel}_launches": launches[kernel],
            "launches": launches}


def profile_phase(torch, cfg, params, kv_quant, device="cuda",
                  kv_layout="ring", spec=False, policy=None):
    """Where a decode tick's time goes: three steady ticks of batch-8
    decoding under ``torch.profiler`` — wall time per tick, device time of
    all kernels per tick (their sum over wall is the busy share), kernel
    launches per tick, and the kernels that take the most device time.
    With ``spec``, three speculative windows of ``SPEC_K`` rows instead
    (the default prompt-lookup drafter): the same numbers per window.
    With a matmul ``policy``, also the dither matmul's device time per
    tick and its share of the tick's device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import Engine, Request, SamplingParams

    eng = Engine(params, cfg, 8, 1024, kv_quant=kv_quant, device=device,
                 kv_layout=kv_layout, spec_decode=spec, draft_k=SPEC_K,
                 policy=policy)
    for r in range(8):
        eng.submit(Request(rid=r, prompt=list(range(1, 200 + 20 * r)),
                           sampling=SamplingParams(max_new=64)))
    for _ in range(4):                 # admission, prefill, warm ticks
        eng.step()
    ticks = 3
    tokens0 = eng.stats["decode_tokens"]
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        wall_ms = 1e3 * (time.perf_counter() - t0) / ticks
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    dither_us = sum(e.self_device_time_total for e in kernels
                    if any(n in e.key
                           for n in DITHER_KERNELS + THREE_PASS_KERNELS))
    extra = {} if policy is None else {
        "policy": policy.scheme,
        "dither_matmul_device_ms_per_tick": dither_us / 1e3 / ticks,
        "dither_matmul_device_share": dither_us / max(device_us, 1e-9)}
    return {"phase": "profile", "layout": kv_layout, **extra,
            "kv": "int8" if kv_quant else "bf16",
            "spec_decode": spec, "draft_k": SPEC_K if spec else None,
            "verify_fused_ops": sorted(eng.verify_fused_ops),
            "tokens_emitted": eng.stats["decode_tokens"] - tokens0,
            "ticks": ticks, "wall_ms_per_tick": wall_ms,
            "device_ms_per_tick": device_us / 1e3 / ticks,
            "device_busy_share": device_us / 1e3 / ticks / wall_ms,
            "kernel_launches_per_tick": sum(e.count for e in kernels) / ticks,
            "top_kernels": [{"name": e.key[:80],
                             "device_ms_per_tick":
                                 e.self_device_time_total / 1e3 / ticks,
                             "launches_per_tick": e.count / ticks}
                            for e in top]}


# ------------------------------------------- phase 4: windows and chunks


WINDOW = 8                 # decode ticks per window in the window phases
CHUNK = 128                # prefill chunk of the chunked phase
# Chunked against whole-prompt logits: a chunk's history join sums the
# attention output in two bf16 products and adds them, one more bf16
# rounding than the whole prompt's one product, and that moves the logits
# through 30 layers as far as the plain path's re-blocking does (bf16:
# held to LOGIT_ATOL, LOGIT_MEAN_ATOL).  With the int8 cache the history
# is moreover read back dequantised, as the reference reads it (and as an
# int8 prefix hit does), while the whole prompt attends its unrounded
# K/V: the int8 step (1/127 of a row's absmax) is twice a bf16 rounding
# step (2^-8 relative), so int8 is held to twice the tolerance.
CHUNK_INT8_FACTOR = 2


def clone_tree(x):
    """A deep copy of a dict / list of tensors (on their device)."""
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [clone_tree(v) for v in x]
    return x.clone()


def graph_against_eager(torch, eng, cfg, params):
    """The engine's next window twice from one state: replayed from its
    CUDA graph (on the engine) and eagerly (``make_fused_decode``, called
    directly, on a clone).  The (n, B) tokens, next tokens, counters,
    ``pos`` and every cache tensor must be byte-equal; the paged pool's
    trash block is compared apart and only reported (dead rows write
    there, several to one slot, and nothing reads it).  The engine then
    drains the window as it would.  An encoder-decoder's cross-KV must be
    equal and unchanged by the window.  Returns the window's host
    times."""
    from repro_torch.serve import make_fused_decode

    plan = eng._window_plan()
    dev, cache = clone_tree(eng._dev), clone_tree(eng.cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = eng._run_window(plan)
    graph_ms = 1e3 * (time.perf_counter() - t0)
    t = lambda a: torch.from_numpy(a).to(eng.device)   # noqa: E731
    t0 = time.perf_counter()
    want, last, counters, new = make_fused_decode(cfg, n_ticks=plan.n)(
        params, dev["last_token"], cache, dev["offsets"], eng.tick,
        dev["temps"], dev["topks"], dev["seeds"], dev["counters"],
        t(plan.alive), t(plan.budgets), t(plan.stops))
    want = want.cpu().numpy()
    eager_ms = 1e3 * (time.perf_counter() - t0)
    paged = "block_tables" in cache
    same = {"tokens": bool((toks == want).all()),
            "next_tokens": torch.equal(last, eng._dev["last_token"]),
            "counters": torch.equal(counters, eng._dev["counters"]),
            "pos": torch.equal(new["pos"], eng.cache["pos"])}
    trash_equal = True
    for li, (got_e, want_e) in enumerate(zip(
            eng.cache["layers"] + eng.cache["remainder"],
            new["layers"] + new["remainder"])):
        for name, got_t in got_e.items():
            want_t = want_e[name]
            if paged:
                trash_equal &= torch.equal(got_t[:, -1], want_t[:, -1])
                got_t, want_t = got_t[:, :-1], want_t[:, :-1]
            same[f"layers[{li}].{name}"] = torch.equal(got_t, want_t)
    for name, got_t in eng.cache.get("cross", {}).items():
        # the encoder-decoder's static cross-KV: read by the window and
        # left as it was
        same[f"cross.{name}"] = torch.equal(got_t, new["cross"][name])
        same[f"cross.{name}.unchanged"] = torch.equal(got_t,
                                                      cache["cross"][name])
    assert all(same.values()), same
    eng.stats["decode_calls"] += 1
    eng.tick += plan.n
    eng._drain(plan, toks)
    return {"alive": int(plan.alive.sum()), "graph_ms": graph_ms,
            "eager_ms": eager_ms,
            "trash_block_equal": trash_equal if paged else None}


def graph_phase(torch, cfg, params, layout, kv_quant):
    """Graph ≡ eager, bit for bit, at full width, batch 8, windows of
    ``WINDOW`` ticks: the first window of a wave (its capture included),
    then again right after an admission that rebinds ``pos`` and (paged)
    the block table, so the static buffers take fresh values.  The
    traffic: 12 of the layout's serve requests, 16 new tokens each."""
    from repro_torch.serve import Engine

    paged = layout == "paged"
    if paged:
        eng = paged_engine(cfg, params, kv_quant, decode_ticks=WINDOW,
                           degrade_high=None)
        reqs = paged_requests(cfg, 12, paged_lens()[:12], 16)
    else:
        eng = Engine(params, cfg, 8, 1024, kv_quant=kv_quant, device="cuda",
                     decode_ticks=WINDOW)
        reqs = ring_requests(cfg, 12, ring_lens()[:12], 16)
    for req in reqs:
        eng.submit(req)
    eng._admit_and_prefill()
    first = graph_against_eager(torch, eng, cfg, params)
    while all(s is not None for s in eng.slots):
        eng._decode_tick()
    eng._admit_and_prefill()
    rebound = {"pos": eng.cache["pos"] is not eng._graphs.pos}
    if paged:
        rebound["block_tables"] = (eng.cache["block_tables"]
                                   is not eng._graphs.block_tables)
    assert all(rebound.values()), rebound
    after = graph_against_eager(torch, eng, cfg, params)
    done = eng.run(1000)
    assert len(done) == 12 and all(len(r.out) == 16 for r in done)
    return {"phase": "graph", "layout": layout,
            "kv": "int8" if kv_quant else "bf16", "batch": 8,
            "window": WINDOW, "bitwise_equal_eager": True,
            "first_window": first, "after_admission": after,
            "rebound_before_replay": rebound,
            "graphs": {str(k): v for k, v in eng._graphs.windows().items()},
            "capture_s": eng._graphs.capture_s}


def window_serve_phase(torch, da, pda, cfg, params, layout, kv_quant,
                       plain, streams):
    """The serve traffic again in windows of ``WINDOW`` ticks, each one
    CUDA-graph replay: every stream equals the W = 1 stream of the plain
    phase (``plain``, ``streams``), token for token."""
    if layout == "paged":
        res, got = paged_serve_phase(torch, da, pda, cfg, params, kv_quant,
                                     decode_ticks=WINDOW)
    else:
        res, got = serve_phase(torch, da, pda, cfg, params, kv_quant,
                               decode_ticks=WINDOW)
    differ = [i for i, p in enumerate(streams) if got[p] != streams[p]]
    assert not differ, ("W = 8 streams differ from W = 1", layout, differ)
    return {**res, "phase": "window_serve", "streams_equal_w1": True,
            "w1_decode_tok_s": plain["decode_tok_s"],
            "w1_windows": plain["windows"]}


def chunked_logits(torch, cfg, params, layout, kv_quant, toks, lens, off):
    """Each row's last-prompt-token logits from a whole-prompt prefill and
    from chunks of ``CHUNK`` tokens (the ring's chunked prefill; the
    paged prefill's block-aligned suffix calls), batch 8."""
    import numpy as np

    from repro_torch.models import registry

    b, dev = toks.shape[0], "cuda"
    kw = (dict(kv_layout="paged", block_size=64, num_blocks=b * 16)
          if layout == "paged" else {})
    bt = torch.arange(b * 16, dtype=torch.int32, device=dev).reshape(b, 16)
    whole_cache = registry.make_cache(params, cfg, b, 1024,
                                      kv_quant=kv_quant, device=dev, **kw)
    t = lambda a: torch.from_numpy(a).to(dev)         # noqa: E731
    zeros = np.zeros(b, np.int32)
    if layout == "paged":
        whole, _ = registry.apply_prefill_paged(
            params, cfg, t(toks), t(lens), t(zeros), bt, whole_cache,
            kv_quant=kv_quant, kv_offset=off)
    else:
        whole, _ = registry.apply_prefill(params, cfg, t(toks), t(lens),
                                          1024, kv_quant=kv_quant,
                                          kv_offset=off)
    cache = registry.make_cache(params, cfg, b, 1024, kv_quant=kv_quant,
                                device=dev, **kw)
    starts = zeros.copy()
    last = [None] * b
    while (starts < lens).any():
        clen = np.minimum(CHUNK, lens - starts).astype(np.int32)
        piece = np.zeros((b, CHUNK), np.int64)
        for i in range(b):
            piece[i, :clen[i]] = toks[i, starts[i]:starts[i] + clen[i]]
        if layout == "paged":
            logits, cache = registry.apply_prefill_paged(
                params, cfg, t(piece), t(clen), t(starts), bt, cache,
                kv_quant=kv_quant, kv_offset=off,
                prefix_blocks=16 if starts.any() else 0)
        else:
            logits, cache = registry.apply_prefill_chunked(
                params, cfg, t(piece), t(clen), t(starts), cache,
                kv_quant=kv_quant, kv_offset=off)
        for i in range(b):
            if clen[i] and starts[i] + clen[i] == lens[i]:
                last[i] = logits[i]
        starts = starts + clen
    return whole, torch.stack(last)


def chunked_phase(torch, da, pda, cfg, params, ring_streams_int8):
    """Chunked prefill at full width.  (1) For ring and paged, bf16 and
    int8, the ring serve traffic's 16 prompts (32–512 tokens, batch 8):
    last-chunk logits of chunks of ``CHUNK`` tokens within the plain
    path's logit tolerance (``LOGIT_ATOL`` max, ``LOGIT_MEAN_ATOL`` mean)
    of whole-prompt prefill's — the history join re-associates the
    softmax, so they agree to rounding.  (2) The ring int8 traffic served
    with ``prefill_chunk=CHUNK, decode_ticks=WINDOW``: every request ends
    with its full budget; how many streams equal the unchunked W = 1 ones
    is reported, not gated."""
    import numpy as np

    lens_all = ring_lens().astype(np.int32)
    prompts = [r.prompt for r in ring_requests(cfg, SERVE_REQUESTS,
                                               lens_all, 1)]
    off = torch.arange(8, dtype=torch.int32, device="cuda") * 1000
    logits = {}
    for layout in ("ring", "paged"):
        for kv_quant in (False, True):
            worst = mean = 0.0
            rows = []
            for g in range(0, SERVE_REQUESTS, 8):
                lens = lens_all[g:g + 8]
                toks = np.zeros((8, 512), np.int64)
                for i, n in enumerate(lens):
                    toks[i, :n] = prompts[g + i]
                whole, chunked = chunked_logits(torch, cfg, params, layout,
                                                kv_quant, toks, lens, off)
                assert torch.isfinite(chunked).all()
                assert chunked.shape == (8, cfg.vocab_size)
                d = (chunked - whole).abs()
                worst = max(worst, d.max().item())
                mean = max(mean, d.mean().item())
                rows += [[int(n), d[i].max().item(), d[i].mean().item()]
                         for i, n in enumerate(lens)]
            logits[f"{layout} {'int8' if kv_quant else 'bf16'}"] = {
                "max_abs_diff": worst, "max_mean_abs_diff": mean,
                "rows_len_max_mean": sorted(rows)}
    tol = {kv: (LOGIT_ATOL * f, LOGIT_MEAN_ATOL * f)
           for kv, f in (("bf16", 1), ("int8", CHUNK_INT8_FACTOR))}
    emit({"phase": "chunked_logits", "chunk": CHUNK, "tolerance": tol,
          "logits_vs_whole_prompt": logits})
    for key, r in logits.items():
        atol, mean_atol = tol[key.split()[1]]
        assert (r["max_abs_diff"] <= atol
                and r["max_mean_abs_diff"] <= mean_atol), (key, r)
    res, got = serve_phase(torch, da, pda, cfg, params, True,
                           decode_ticks=WINDOW, prefill_chunk=CHUNK)
    equal = sum(got[p] == ring_streams_int8[p] for p in ring_streams_int8)
    for r in logits.values():
        del r["rows_len_max_mean"]
    return {**res, "phase": "chunked", "chunk": CHUNK,
            "logits_vs_whole_prompt": logits, "tolerance": tol,
            "streams_equal_unchunked_w1": int(equal),
            "streams": len(ring_streams_int8)}, got


def window_profile_phase(torch, cfg, params, kv_quant):
    """Where a window's time goes: a ring engine at windows of ``WINDOW``
    ticks (8 prompts of 199 + 20 r tokens, 64 new tokens each, batch 8),
    warmed by two steps; then from one state a window replayed from the
    engine's graph and an eager window (``make_fused_decode``, called
    directly) on a clone of it, each under ``torch.profiler`` (device
    activity only): wall ms (the window's call and its token drain),
    device ms (all kernels), the busy share, kernel launches and tokens;
    then three more of each without the profiler, whose tracing of every
    kernel slows the host (their mean wall ms, and the device ms over it
    as the busy share).  Both paths' last tokens must be equal."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import (Engine, Request, SamplingParams,
                                   make_fused_decode)

    eng = Engine(params, cfg, 8, 1024, kv_quant=kv_quant, device="cuda",
                 decode_ticks=WINDOW)
    for r in range(8):
        eng.submit(Request(rid=r, prompt=list(range(1, 200 + 20 * r)),
                           sampling=SamplingParams(max_new=64)))
    for _ in range(2):                 # admission, prefill, capture, a window
        eng.step()
    plan = eng._window_plan()
    assert plan.alive.all() and (plan.budgets == WINDOW).all()
    dev, cache = clone_tree(eng._dev), clone_tree(eng.cache)
    windows = 3
    eager = make_fused_decode(cfg, n_ticks=WINDOW)
    t = lambda a: torch.from_numpy(a).to("cuda")      # noqa: E731
    rows = {}
    out = {}

    def run(path):
        nonlocal cache
        if path == "graph":
            return eng._graphs.run(WINDOW, eng._dev, eng.cache, plan.alive,
                                   plan.budgets, plan.stops).cpu().numpy()
        toks, dev["last_token"], dev["counters"], cache = eager(
            params, dev["last_token"], cache, dev["offsets"], 0,
            dev["temps"], dev["topks"], dev["seeds"], dev["counters"],
            t(plan.alive), t(plan.budgets), t(plan.stops))
        return toks.cpu().numpy()

    for path in ("graph", "eager"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(path)
            wall_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(windows):
            out[path] = run(path)
        plain_ms = 1e3 * (time.perf_counter() - t0) / windows
        kernels = [e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and e.self_device_time_total > 0]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        rows[path] = {
            "wall_ms_per_window": wall_ms,
            "device_ms_per_window": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "unprofiled_wall_ms_per_window": plain_ms,
            "device_busy_share_unprofiled": device_ms / plain_ms,
            "kernel_launches_per_window": sum(e.count for e in kernels),
            "tokens_per_window": int(plan.alive.sum()) * WINDOW}
    assert np.array_equal(out["graph"], out["eager"])
    return {"phase": "profile", "layout": "ring", "window": WINDOW,
            "kv": "int8" if kv_quant else "bf16",
            "windows_profiled": 1, "windows_unprofiled": windows,
            "graph": rows["graph"], "eager": rows["eager"],
            "graph_launches_per_replay": {
                str(k): v["launches"]
                for k, v in eng._graphs.windows().items()},
            "tokens_equal": True}


# ---------------------------------------------------------------- phase 5


@contextlib.contextmanager
def plain_in_blocks(ref, block):
    """Run the plain version in ``block``-slot blocks instead of one
    whole-cap block: the same function in another f32 summation order,
    the yardstick for how far order alone moves full-width logits."""
    whole = ref.decode_attention_ref
    ref.decode_attention_ref = functools.partial(whole, block=block)
    try:
        yield
    finally:
        ref.decode_attention_ref = whole


def parity_phase(torch, cfg, params, kv_quant, device="cuda"):
    import numpy as np

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import KERNEL_BLOCK
    from repro_torch.models import registry

    rng = np.random.default_rng(2)
    lens = np.array([32, 97, 160, 255, 300, 411, 480, 512], np.int32)
    toks = np.zeros((8, 512), np.int64)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, size=n)
    toks_d = torch.from_numpy(toks).to(device)
    lens_d = torch.from_numpy(lens).to(device)
    off = torch.arange(8, dtype=torch.int32, device=device) * 1000
    logits, cache = registry.apply_prefill(params, cfg, toks_d, lens_d, 1024,
                                           kv_quant=kv_quant, kv_offset=off)
    paths = ("cuda", "torch-ref", "torch-ref-blocks")
    caches = {p: copy.deepcopy(cache) for p in paths}
    cur = torch.argmax(logits, -1)
    drift = {"kernel": [0.0, 0.0], "plain_reblocked": [0.0, 0.0]}
    for _ in range(3):
        out = {}
        for path in paths:
            blocks = (plain_in_blocks(ref, (KERNEL_BLOCK,))
                      if path == "torch-ref-blocks"
                      else contextlib.nullcontext())
            with blocks:
                out[path], caches[path] = registry.apply_decode(
                    params, cfg, cur, caches[path], kv_offset=off,
                    backend=path.replace("-blocks", ""))
        for name, path in (("kernel", "cuda"),
                           ("plain_reblocked", "torch-ref-blocks")):
            d = (out[path] - out["torch-ref"]).abs()
            drift[name] = [max(drift[name][0], d.max().item()),
                           max(drift[name][1], d.mean().item())]
        assert torch.isfinite(out["cuda"]).all()
        assert out["cuda"].shape == (8, cfg.vocab_size)
        cur = torch.argmax(out["cuda"], -1)
    worst, mean = drift["kernel"]
    assert worst <= LOGIT_ATOL and mean <= LOGIT_MEAN_ATOL, drift
    return {"phase": "parity", "kv": "int8" if kv_quant else "bf16",
            "decode_steps": 3, "max_abs_logit_diff": worst,
            "max_mean_abs_logit_diff": mean, "atol": LOGIT_ATOL,
            "mean_atol": LOGIT_MEAN_ATOL,
            "plain_reblocked_max_abs_logit_diff": drift["plain_reblocked"][0],
            "plain_reblocked_max_mean_abs_logit_diff":
                drift["plain_reblocked"][1]}


def prefill_invariance_phase(torch, cfg, params, kv_quant, device="cuda"):
    """Full width: does a request's batched prefill depend on its wave?
    Seven prompts of 33–63 tokens (length bucket 64): the first prefilled
    alone at its own padded length (64) and beside the other six — which
    must change no bit of its logits or cache row, as the engine's prefill
    per length bucket relies on — then all seven padded to 128 and to 512,
    where the library may sum in another order: how many of their logits
    change is reported (the hazard the grouping avoids; speculation
    changes which prompts share a wave).  A reordered f32 sum shows only
    where it flips a bf16 rounding, so the count depends on the prompts."""
    import numpy as np

    from repro_torch.models import registry

    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in (60, 33, 41, 47, 52, 57, 63)]

    def prefill(rows, s):
        toks = torch.zeros((8, s), dtype=torch.long, device=device)
        lens = torch.zeros((8,), dtype=torch.int32, device=device)
        for i, p in enumerate(rows):
            toks[i, : len(p)] = torch.tensor(p, device=device)
            lens[i] = len(p)
        logits, cache = registry.apply_prefill(params, cfg, toks, lens, 1024,
                                               kv_quant=kv_quant)
        return logits[: len(rows)], [t[:, 0] for e in cache["layers"]
                                     for t in e.values()]

    alone, alone_kv = prefill(prompts[:1], 64)
    shared, shared_kv = prefill(prompts, 64)
    same = torch.equal(alone[0], shared[0]) and all(
        torch.equal(x, y) for x, y in zip(alone_kv, shared_kv))
    assert same, "a request's prefill changed with its wave at one length"
    res = {"phase": "prefill_invariance", "kv": "int8" if kv_quant else "bf16",
           "prompts": [len(p) for p in prompts], "own_length": 64,
           "same_length_wave_bitwise_equal": same}
    for s in (128, 512):
        padded, _ = prefill(prompts, s)
        res[f"padded_{s}"] = {
            "prompts_changed": int((padded != shared).any(dim=-1).sum()),
            "logits_differing": int((padded != shared).sum().item()),
            "logits": shared.numel(),
            "max_abs_logit_diff": (padded - shared).abs().max().item()}
    return res


def paged_parity_phase(torch, cfg, params, kv_quant, device="cuda"):
    """Full width, paged: one cold paged prefill into shuffled 64-token
    blocks, then three decode steps through the paged kernel and through
    the plain version passed explicitly (both in 64-token tiles).  Then the
    paged engine's greedy streams (cold, prefix cache off) against the ring
    engine's on the same requests, token for token: at bs == bk the two
    kernels share one tile body and a cold paged prefill is the ring
    prefill's ops, so the streams must be equal."""
    import numpy as np

    from repro_torch.models import registry
    from repro_torch.serve import Engine, Request

    rng = np.random.default_rng(3)
    lens = np.array([32, 97, 160, 255, 300, 411, 480, 512], np.int32)
    toks = np.zeros((8, 512), np.int64)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, size=n)
    bs, nbmax = 64, 1024 // 64
    cache = registry.make_cache(params, cfg, 8, 1024, kv_quant=kv_quant,
                                kv_layout="paged", block_size=bs,
                                device=device)
    ids = rng.permutation(8 * nbmax).tolist()
    bt = np.full((8, nbmax), 8 * nbmax, np.int32)
    for i, n in enumerate(lens):
        for j in range((int(n) + 3) // bs + 1):
            bt[i, j] = ids.pop()
    off = torch.arange(8, dtype=torch.int32, device=device) * 1000
    logits, cache = registry.apply_prefill_paged(
        params, cfg, torch.from_numpy(toks).to(device),
        torch.from_numpy(lens).to(device),
        torch.zeros(8, dtype=torch.int32, device=device),
        torch.from_numpy(bt).to(device), cache, kv_quant=kv_quant,
        kv_offset=off)
    caches = {p: copy.deepcopy(cache) for p in ("cuda", "torch-ref")}
    cur = torch.argmax(logits, -1)
    worst = mean = 0.0
    for _ in range(3):
        out = {}
        for path in caches:
            out[path], caches[path] = registry.apply_decode(
                params, cfg, cur, caches[path], kv_offset=off, backend=path)
        d = (out["cuda"] - out["torch-ref"]).abs()
        worst, mean = max(worst, d.max().item()), max(mean, d.mean().item())
        assert torch.isfinite(out["cuda"]).all()
        assert out["cuda"].shape == (8, cfg.vocab_size)
        cur = torch.argmax(out["cuda"], -1)
    assert worst <= LOGIT_ATOL and mean <= LOGIT_MEAN_ATOL, (worst, mean)

    streams = {}
    for layout in ("ring", "paged"):
        eng = Engine(params, cfg, 8, 1024, kv_quant=kv_quant,
                     kv_layout=layout, prefix_cache=False, device=device)
        for r, n in enumerate(lens):
            eng.submit(Request(rid=r, prompt=toks[r, :n].tolist(),
                               max_new=32))
        streams[layout] = [r.out for r in sorted(eng.run(1000),
                                                 key=lambda r: r.rid)]
    same = streams["paged"] == streams["ring"]
    assert same, [i for i, (a, b) in enumerate(zip(streams["paged"],
                                                  streams["ring"])) if a != b]
    return {"phase": "parity", "layout": "paged",
            "kv": "int8" if kv_quant else "bf16", "decode_steps": 3,
            "max_abs_logit_diff": worst, "max_mean_abs_logit_diff": mean,
            "atol": LOGIT_ATOL, "mean_atol": LOGIT_MEAN_ATOL,
            "greedy_streams_equal_ring": same, "stream_requests": 8,
            "stream_tokens_each": 32}


# ------------------------------------------------ kernels 5–6, policy serving


DITHER_SCHEMES = ("deterministic", "stochastic", "dither")
QUANTIZE_REPLACES = "src/repro/kernels/quantize.py:84"
MATMUL_REPLACES = "src/repro/kernels/dither_matmul.py:128"
PEAK_F32 = 67e12          # H100 SXM, f32 outside the tensor cores
QUANT_F32_OPS = 12        # f32 ops of one dither code (dither_quant.cuh)
# uint32 operations of one dither code that depend on the element, in the
# reference's formula (src/repro/core/rounding.py): hash_uniform's
# idx * M1, the xor into the first round and two fmix32 rounds (three
# shift-xors and two multiplies: 8 each), the xor with counter * M2 and
# the >> 8 (20); lcg_slot's phase, one xor and an fmix32 (9), (counter +
# phase) % N (2) and (a * q + (phase >> 8)) % N (4).  mix(seed ^ golden)
# and counter * M2 are constants of the operand.
QUANT_INT_OPS = 35
NORM_F32_OPS = 2          # the policy entry's bf16(v / absmax) per code
EPILOGUE_F32_OPS = 5      # fma, 2 mul, 2 add per output (+1: the rescale)
SMS, INT32_LANES = 132, 64   # H100 SXM: INT32 lanes per SM
DITHER_KERNELS = ("prep_rows", "fused_decode", "absmax_rows", "quantize_bt",
                  "gemm_u8")   # kernel 6's device kernels
# the device kernels of kernel 6's earlier three-pass design (quantise A,
# quantise B, multiply), which --dither-times may time in an older tree
THREE_PASS_KERNELS = ("quantize_a", "quantize_b", "gemm_u8")
QUANTIZE_SHAPES = ((8, 576), (576, 1536), (37, 1000))
# decode shapes of the serve path (batch 8: q, k/v, o; gate/up; down; LM
# head) and the train path's 4,096 rows (batch 8 × seq 512: q and o, k/v,
# gate/up, down, the tied LM head)
MATMUL_SHAPES = ((8, 576, 576), (8, 576, 192), (8, 576, 1536),
                 (8, 1536, 576), (8, 576, 49152), (4096, 576, 576),
                 (4096, 576, 192), (4096, 576, 1536), (4096, 1536, 576),
                 (4096, 576, 49152))
TRAIN_HEAD = [4096, 576, 49152]
# checked, not timed: the regime boundary (M 128 / 129), a K of 19 chunks
# (a split remainder), ragged shapes off every tile multiple
EDGE_MATMUL_SHAPES = ((128, 576, 200), (129, 576, 200), (8, 600, 576),
                      (37, 100, 53), (5, 7, 3))
# the policy entry at the same shapes; the LM head is the transposed view
# of the (49152, 576) embedding, as the tied head passes it, and so are
# the weights of these edge shapes (prefill regime; unaligned rows)
TRANS_N = 49152
TRANS_EDGE = ((129, 576, 200), (37, 100, 53))


@functools.lru_cache(maxsize=None)
def int32_ops_per_s():
    """(INT32 operations a second, the SM clock in MHz): 132 SMs × 64
    INT32 lanes × the clock ``nvidia-smi --query-gpu=clocks.max.sm``
    reports."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    return SMS * INT32_LANES * mhz * 1e6, mhz


def least_time(terms):
    """(bound ms, the term that sets it): the largest of the terms'
    seconds, not their sum."""
    name = max(terms, key=terms.get)
    return 1e3 * terms[name], name


def quantize_bound(m, n):
    """Least time for kernel 5 (dither codes): 4 bytes read and 4 written
    per element over HBM; its INT32 ops at ``int32_ops_per_s``; its f32 ops
    over the non-tensor f32 rate."""
    e = m * n
    return least_time({"bytes": 8 * e / HBM_BYTES_PER_S,
                       "INT32 ops": QUANT_INT_OPS * e / int32_ops_per_s()[0],
                       "f32 ops": QUANT_F32_OPS * e / PEAK_F32})


def matmul_bound(m, k, n, policy=False):
    """Least time for kernel 6: both operands read once and the output
    written once over HBM (f32, or bf16 for the policy entry); the
    2·M·K·N int8 tensor-core operations at 1,979 TOPS; each code's INT32
    ops; the codes' f32 ops (with the policy entry's normalisation) and the
    epilogue's."""
    codes, outs = m * k + k * n, m * n
    return least_time({
        "bytes": (2 if policy else 4) * (codes + outs) / HBM_BYTES_PER_S,
        "int8 tensor ops": 2 * m * k * n / PEAK_OPS["int8"],
        "INT32 ops": QUANT_INT_OPS * codes / int32_ops_per_s()[0],
        "f32 ops": ((QUANT_F32_OPS + NORM_F32_OPS * policy) * codes
                    + (EPILOGUE_F32_OPS + policy) * outs) / PEAK_F32})


def rotated(torch, fn, args):
    """``fn`` over copies of ``args`` that together exceed the 50 MB L2,
    one copy a call in turn (the serving path finds each layer's weight
    cold), after one call on each copy."""
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor))
    copies = [args] + [[a.clone() if isinstance(a, torch.Tensor) else a
                        for a in args]
                       for _ in range(max(1, math.ceil(120e6 / nbytes)))]
    for c in copies:
        fn(*c)
    turn = {"i": 0}

    def call():
        turn["i"] = (turn["i"] + 1) % len(copies)
        return fn(*copies[turn["i"]])
    return call


def dither_times(torch, qk, dm, policy):
    """Kernels 5–6 timed alone through their wrappers, so any tree of the
    port can be timed (``--dither-times``): the quantiser at
    ``QUANTIZE_SHAPES`` (dither, spread, 8 bits), the f32 dither matmul and
    the policy's product (``policy._fused_matmul`` on bf16 operands, the
    dither scheme on the ``cuda`` backend: the kernel's policy entry, or in
    a tree that has none, torch ops around the f32 kernel) at ``MATMUL_SHAPES``.  Event ms:
    the mean over back-to-back calls on inputs rotated past the L2
    (``rotated``); device ms: everything the calls launch, from the
    profiler; the bound and what sets it."""
    gen = torch.Generator().manual_seed(5)
    rows = []
    for m, n in QUANTIZE_SHAPES:
        x = (torch.rand((m, n), generator=gen) * 2.4 - 1.2).cuda()
        kw = dict(scale=127.5, zero=-1.0, bits=8, scheme="dither",
                  counter=12345, seed=7, n_pulses=16, fmt="spread")
        run = rotated(torch, lambda t: qk.quantize(t, **kw), [x])
        bound_ms, term = quantize_bound(m, n)
        rows.append({"name": "quantize", "shape": [m, n],
                     "ms": cuda_ms(run, 200),
                     "device_ms": device_ms(torch, run, 20),
                     "bound_ms": bound_ms, "bound_term": term})
    pol = policy.QuantPolicy(scheme="dither", backend="cuda")
    for m, k, n in MATMUL_SHAPES:
        a = (torch.rand((m, k), generator=gen) * 2 - 1).cuda()
        b = (torch.rand((k, n), generator=gen) * 2 - 1).cuda()
        kw = dict(bits=8, scheme="dither", a_range=(-1.0, 1.0),
                  b_range=(-1.0, 1.0), counter=77, seed=3)
        run = rotated(torch, lambda s, t: dm.dither_matmul(s, t, **kw),
                      [a, b])
        bound_ms, term = matmul_bound(m, k, n)
        rows.append({"name": "dither_matmul", "shape": [m, k, n],
                     "ms": cuda_ms(run, 100),
                     "device_ms": device_ms(torch, run, 10),
                     "bound_ms": bound_ms, "bound_term": term})
        x, w = policy_operands(torch, gen, m, k, n)
        run = rotated(torch, lambda s, t: policy._fused_matmul(
            s, t, pol, 3, 77.0), [x, w])
        bound_ms, term = matmul_bound(m, k, n, policy=True)
        rows.append({"name": "policy_product", "shape": [m, k, n],
                     "weight": "transposed view" if n == TRANS_N else "row",
                     "ms": cuda_ms(run, 100),
                     "device_ms": device_ms(torch, run, 10),
                     "bound_ms": bound_ms, "bound_term": term})
    return rows


def policy_operands(torch, gen, m, k, n):
    """bf16 x (M, K) and w (K, N) as the policy sees them: w the
    transposed view of an (N, K) embedding at the LM head's width."""
    x = torch.randn((m, k), generator=gen).to(torch.bfloat16).cuda()
    if n == TRANS_N:
        w = (torch.randn((n, k), generator=gen) * 0.05).to(
            torch.bfloat16).cuda().T
    else:
        w = (torch.randn((k, n), generator=gen) * 0.05).to(
            torch.bfloat16).cuda()
    return x, w


def policy_route(torch, dm, x, w, **kw):
    """The policy's product as ``policy._fused_matmul`` computes it for
    operands its policy entry does not take (and for every operand in a
    tree without that entry): torch ops for both absmaxes, the normalised
    operands and the rescale around the f32 CUDA kernel."""
    ax = torch.clamp_min(torch.amax(torch.abs(x)), 1e-6)
    aw = torch.clamp_min(torch.amax(torch.abs(w)), 1e-6)
    out = dm.dither_matmul((x / ax).to(torch.float32).contiguous(),
                           (w / aw).to(torch.float32).contiguous(),
                           a_range=(-1.0, 1.0), b_range=(-1.0, 1.0), **kw)
    return (out * (ax * aw)).to(x.dtype)


def dither_kernel_phase(torch, qk, dm, ref, policy):
    """Kernels 5 and 6 on the card against their plain versions passed
    explicitly, bit for bit (int32 codes; f32 outputs of two exact integer
    products through one epilogue): kernel 5 at the serve path's operand
    shapes and a ragged one, every scheme, both formats, bits 2/4/8;
    kernel 6 at the serve path's decode shapes, a prefill shape and the
    edge shapes, every scheme, ranges (−1, 1) and (0, 1); its policy entry
    at the same shapes (the LM head as the transposed view) against the
    plain version and against ``policy_route`` (torch ops around the f32
    kernel), every scheme.  Then ``dither_times`` with the plain versions'
    times beside, and ``policy_route``'s.  No single PyTorch call quantises
    with a hash-driven rounding, so there is no library time; beside
    kernel 6 stands the unquantised bf16 ``torch.matmul`` of the same
    operands, the policy-free path's product."""
    gen = torch.Generator().manual_seed(5)
    cases = {"quantize": 0, "dither_matmul": 0, "policy_product": 0}
    for m, n in QUANTIZE_SHAPES:
        x = (torch.rand((m, n), generator=gen) * 2.4 - 1.2).cuda()
        for scheme in DITHER_SCHEMES:
            for fmt in ("spread", "unary"):
                for bits in (2, 4, 8):
                    kw = dict(scale=((1 << bits) - 1) / 2.0, zero=-1.0,
                              bits=bits, scheme=scheme, counter=12345,
                              seed=7, n_pulses=16, fmt=fmt)
                    got = qk.quantize(x, **kw)
                    torch.cuda.synchronize()
                    want = ref.quantize_codes_ref(x, **kw)
                    assert torch.equal(got, want), ((m, n), scheme, fmt,
                                                    bits)
                    cases["quantize"] += 1
    for m, k, n in MATMUL_SHAPES + EDGE_MATMUL_SHAPES:
        a = (torch.rand((m, k), generator=gen) * 2 - 1).cuda()
        b = (torch.rand((k, n), generator=gen) * 2 - 1).cuda()
        for scheme in DITHER_SCHEMES:
            for rg in ((-1.0, 1.0), (0.0, 1.0)):
                kw = dict(bits=8, scheme=scheme, a_range=rg, b_range=rg,
                          counter=77, seed=3)
                got = dm.dither_matmul(a, b, **kw)
                torch.cuda.synchronize()
                want = ref.dither_matmul_ref(a, b, **kw)
                assert torch.isfinite(got).all()
                assert torch.equal(got, want), ((m, k, n), scheme, rg)
                cases["dither_matmul"] += 1
        x, w = policy_operands(torch, gen, m, k, n)
        if (m, k, n) in TRANS_EDGE:
            w = w.T.contiguous().T
        for scheme in DITHER_SCHEMES:
            kw = dict(bits=8, scheme=scheme, counter=77, seed=3)
            got = dm.dither_matmul_scaled(x, w, dm.weight_absmax(w), **kw)
            torch.cuda.synchronize()
            want = ref.dither_matmul_scaled_ref(x, w, **kw)
            assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
            assert torch.equal(got, want), ((m, k, n), scheme)
            assert torch.equal(got, policy_route(torch, dm, x, w, **kw)), (
                (m, k, n), scheme)
            cases["policy_product"] += 1
    rows = dither_times(torch, qk, dm, policy)
    for row in rows:
        row["bound_by"] = ("bytes" if row["bound_term"] == "bytes"
                           else "operations")
        row["max_abs_err"] = 0
        row["cases_bitwise"] = cases[row["name"]]
        row["library_ms"] = None
    gen = torch.Generator().manual_seed(6)
    for row in rows:
        if row["name"] == "quantize":
            m, n = row["shape"]
            x = (torch.rand((m, n), generator=gen) * 2.4 - 1.2).cuda()
            kw = dict(scale=127.5, zero=-1.0, bits=8, scheme="dither",
                      counter=12345, seed=7, n_pulses=16, fmt="spread")
            row["plain_ms"] = cuda_ms(
                lambda: ref.quantize_codes_ref(x, **kw), 5, warmup=1)
            continue
        m, k, n = row["shape"]
        kw = dict(bits=8, scheme="dither", counter=77, seed=3)
        if row["name"] == "dither_matmul":
            a = (torch.rand((m, k), generator=gen) * 2 - 1).cuda()
            b = (torch.rand((k, n), generator=gen) * 2 - 1).cuda()
            rk = dict(a_range=(-1.0, 1.0), b_range=(-1.0, 1.0), **kw)
            row["plain_ms"] = cuda_ms(
                lambda: ref.dither_matmul_ref(a, b, **rk), 2, warmup=1)
            ab, bb = a.bfloat16(), b.bfloat16()
            row["unquantised_bf16_matmul_ms"] = cuda_ms(lambda: ab @ bb, 100)
        else:
            x, w = policy_operands(torch, gen, m, k, n)
            row["plain_ms"] = cuda_ms(
                lambda: ref.dither_matmul_scaled_ref(x, w, **kw), 2,
                warmup=1)
            run = rotated(torch, lambda s, t: policy_route(torch, dm, s, t,
                                                           **kw), [x, w])
            row["torch_ops_route_ms"] = cuda_ms(run, 50)
            row["torch_ops_route_device_ms"] = device_ms(torch, run, 10)
    return rows, cases


def policy_serve_phase(torch, kmods, cfg, params, kv_quant, layout, plain):
    """The quantised-matmul path: the serve phase's own prompts (ring: the
    16 requests over 32–512-token prompts; paged: the 16 sharing a system
    prompt), ``POLICY_NEW`` new tokens each, through
    ``Engine(policy=QuantPolicy(scheme="dither", backend="auto"))``: every dense product through the CUDA dither matmul
    (the paged prefix cache off, as under the reference's policy).  Gates:
    every budget emitted, dither-matmul launches = (7 × layers + 1) ×
    (prefill calls + ticks), one attention launch per layer per tick, no
    standalone-quantiser launch, no prefix hit, no live block at the end.
    ``plain`` is the policy-free phase's line."""
    from repro_torch.numerics.policy import QuantPolicy
    from repro_torch.serve import Engine

    pol = QuantPolicy(scheme="dither", backend="auto")
    paged = layout == "paged"

    def engine():
        if paged:
            return paged_engine(cfg, params, kv_quant, policy=pol)
        return Engine(params, cfg, 8, 1024, kv_quant=kv_quant,
                      device="cuda", policy=pol)

    warm = engine()                   # the policy path's first calls
    for req in ring_requests(cfg, 2, [40, 300], 3):
        warm.submit(req)
    warm.run(20)
    del warm
    eng = engine()
    assert eng.policy.backend == "cuda"
    reqs = (paged_requests(cfg, SERVE_REQUESTS, paged_lens(), POLICY_NEW)
            if paged else ring_requests(cfg, SERVE_REQUESTS, ring_lens(),
                                        POLICY_NEW))
    for req in reqs:
        eng.submit(req)
    torch.cuda.synchronize()
    for m in kmods.values():
        m.launches = 0
    t0 = time.perf_counter()
    done = eng.run(10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: m.launches for n, m in kmods.items()}
    st = eng.stats
    assert len(done) == SERVE_REQUESTS, len(done)
    for r in done:
        assert r.finish_reason == "length" and len(r.out) == POLICY_NEW, (
            r.rid, r.finish_reason, len(r.out))
        assert all(0 <= t < cfg.vocab_size for t in r.out)
    per_forward = 7 * cfg.n_layers + 1
    calls = st["prefill_calls"] + st["decode_calls"]
    assert launches["dither_matmul"] == per_forward * calls, (launches, st)
    # bf16 serving: every product through the kernel's policy entry
    assert launches["dither_matmul_scaled"] == launches["dither_matmul"], (
        launches)
    attn = "paged_decode_attention" if paged else "decode_attention"
    assert launches[attn] == cfg.n_layers * st["decode_calls"], launches
    assert launches["quantize"] == 0, launches
    if paged:
        assert not eng.pool.prefix_cache and st["prefix_hit_tokens"] == 0
        assert eng.pool.live_blocks == 0, eng.pool_stats()
    return {"phase": "policy_serve", "layout": layout,
            "kv": "int8" if kv_quant else "bf16", "policy": "dither",
            "backend": eng.policy.backend, "requests": SERVE_REQUESTS,
            "new_tokens_each": POLICY_NEW, "batch": 8, "max_len": 1024,
            "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
            "decode_tok_s": st["decode_tokens"] / st["decode_s"],
            "plain_prefill_tok_s": plain["prefill_tok_s"],
            "plain_decode_tok_s": plain["decode_tok_s"],
            "prefill_calls": st["prefill_calls"],
            "plain_prefill_calls": plain["prefill_calls"],
            "decode_ticks": st["decode_calls"], "wall_s": wall,
            "preemptions": st["preemptions"],
            "dither_matmul_launches": launches["dither_matmul"],
            "dither_matmul_launches_per_forward": per_forward,
            "launches": launches}


def policy_restart_phase(torch, cfg, params):
    """Restart determinism under the policy: the ring traffic's first four
    prompts (int8 KV, ``POLICY_NEW`` new tokens each), served twice on
    fresh engines, give the same streams token for token (the counter is the engine tick, the hash
    stateless)."""
    from repro_torch.numerics.policy import QuantPolicy
    from repro_torch.serve import Engine

    streams = []
    for _ in range(2):
        eng = Engine(params, cfg, 8, 1024, kv_quant=True, device="cuda",
                     policy=QuantPolicy(scheme="dither", backend="auto"))
        for req in ring_requests(cfg, 4, ring_lens()[:4], POLICY_NEW):
            eng.submit(req)
        streams.append([r.out for r in sorted(eng.run(1000),
                                              key=lambda r: r.rid)])
    assert streams[0] == streams[1]
    assert all(len(s) == POLICY_NEW for s in streams[0])
    return {"phase": "policy_restart", "kv": "int8", "requests": 4,
            "streams_equal": True}


def policy_parity_phase(torch, cfg, params, kv_quant):
    """Full width under the dither policy: one prefill (8 prompts of 16–128
    tokens) and three decode steps with the matmul backend ``cuda``
    against ``torch-ref`` (the plain version, passed explicitly), the
    attention kernels shared: logits bit for bit."""
    import numpy as np

    from repro_torch.models import registry
    from repro_torch.numerics.policy import QuantPolicy

    rng = np.random.default_rng(6)
    lens = np.array([16, 33, 47, 64, 80, 97, 111, 128], np.int32)
    toks = np.zeros((8, 128), np.int64)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, size=n)
    toks_d = torch.from_numpy(toks).cuda()
    lens_d = torch.from_numpy(lens).cuda()
    off = torch.arange(8, dtype=torch.int32, device="cuda") * 1000
    out = {}
    for backend in ("cuda", "torch-ref"):
        pol = QuantPolicy(scheme="dither", backend=backend)
        logits, cache = registry.apply_prefill(
            params, cfg, toks_d, lens_d, 1024, policy=pol, counter=0,
            kv_quant=kv_quant, kv_offset=off)
        seq = [logits]
        for step in range(3):
            logits, cache = registry.apply_decode(
                params, cfg, torch.argmax(logits, -1), cache, policy=pol,
                counter=1 + step, kv_offset=off)
            seq.append(logits)
        torch.cuda.synchronize()
        out[backend] = seq
    for got, want in zip(out["cuda"], out["torch-ref"]):
        assert torch.isfinite(got).all()
        assert torch.equal(got, want), (got - want).abs().max().item()
    return {"phase": "policy_parity", "kv": "int8" if kv_quant else "bf16",
            "prefill_prompts": lens.tolist(), "decode_steps": 3,
            "logits_bitwise_equal": True}


def policy_error_phase(torch, cfg, params):
    """Report only: the paper's bias and MSE claim on the served model.
    One full-width decode step (8 slots after 64-token prompts) per scheme
    at counters 0–15, each from the same cache: the relative error
    ‖logits − policy-free logits‖ / ‖policy-free logits‖ at counter 0, its
    mean over the 16 counters, and the error of the mean logits over the
    16 counters (dither's time average should cancel more of its error
    than stochastic rounding's; deterministic rounding has none to
    cancel)."""
    import numpy as np

    from repro_torch.models import registry
    from repro_torch.numerics.policy import QuantPolicy

    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                         size=(8, 64))).cuda()
    lens = torch.full((8,), 64, dtype=torch.int32, device="cuda")
    logits, cache = registry.apply_prefill(params, cfg, toks, lens, 1024)
    cur = torch.argmax(logits, -1)
    base, _ = registry.apply_decode(params, cfg, cur, copy.deepcopy(cache))
    norm = base.norm().item()
    res = {"phase": "policy_error", "counters": 16, "schemes": {}}
    for scheme in DITHER_SCHEMES:
        pol = QuantPolicy(scheme=scheme, backend="cuda")
        outs = [registry.apply_decode(params, cfg, cur, copy.deepcopy(cache),
                                      policy=pol, counter=c)[0]
                for c in range(16)]
        errs = [(o - base).norm().item() / norm for o in outs]
        mean = torch.stack(outs).mean(0)
        res["schemes"][scheme] = {
            "rel_err_counter0": errs[0],
            "rel_err_mean_over_counters": sum(errs) / len(errs),
            "rel_err_of_mean_logits": (mean - base).norm().item() / norm}
    return res


# --------------------------------------------------------------------------
# fault tolerance and observability (ROADMAP Queue 1 item 8)
# --------------------------------------------------------------------------

# the fault phase's crash ticks, one per SERVE_PHASES entry in that order:
# W = 1 runs (about 126 ring / 157 paged windows), and the window starts of
# the chunked W = 8 run, which serves ``FAULT_NEW_W8`` new tokens a request
# (its 112 ticks: admission waves at ticks 0 and about 40 put chunks in
# flight at 8-24 and 48-80; 64 tokens a request take 176 ticks)
FAULT_TICKS = (12, 37, 61, 88, 110)
FAULT_TICKS_W8 = (8, 24, 48, 64, 88)
FAULT_NEW_W8 = 32
SCRATCH = ROOT / "build" / "chip_smoke"      # snapshots, feeds (git-ignored)


def serve_engine(cfg, params, layout, kv_quant, **kw):
    """An engine of the ring or paged serve phases' shape."""
    from repro_torch.serve import Engine

    if layout == "paged":
        return paged_engine(cfg, params, kv_quant, **kw)
    return Engine(params, cfg, 8, 1024, kv_quant=kv_quant, device="cuda",
                  **kw)


def serve_traffic(cfg, layout, max_new=64):
    """The ring or paged serve phases' 16 requests, 64 new tokens each
    (or ``max_new``)."""
    if layout == "paged":
        return paged_requests(cfg, SERVE_REQUESTS, paged_lens(), max_new)
    return ring_requests(cfg, SERVE_REQUESTS, ring_lens(), max_new)


def check_streams(done, want, what):
    """Every request kept its budget and its stream equals the
    uninterrupted run's (``want``: prompt → tokens) as far as it went: a
    request is determined by its prompt and sampling, whatever else the
    engine serves, so a shorter budget gives a prefix of the stream."""
    assert len(done) == len(want), (what, len(done))
    for r in done:
        assert r.finish_reason == "length", (what, r.rid, r.finish_reason)
    differ = [r.rid for r in done
              if r.out != want[tuple(r.prompt)][:r.effective_max_new()]]
    assert not differ, (what, "streams differ", differ)


def assert_drained(eng, what):
    assert all(s is None for s in eng.slots), what
    assert len(eng.scheduler) == 0, what
    if eng.pool is not None:
        assert eng.pool.live_blocks == 0, (what, eng.pool_stats())


def fault_phase(torch, cfg, params, layout, kv_quant, knobs, want, ticks,
                max_new=64):
    """Crash recovery at full width on a serve phase's traffic (``want``:
    its uninterrupted streams; ``max_new`` new tokens a request, whose
    streams are ``want``'s first ``max_new``).  (1) Through ``run_serve_with_restarts``
    with a snapshot file written every window: one ``FailureInjector``
    schedule fires all five serve crash points at ``ticks``, and every
    restart builds a fresh engine (its graphs captured anew) that
    restores from the file.  Gates: every stream and finish reason equals
    the uninterrupted run's, nothing is left in a slot, the queue or the
    pool, 5 recoveries, the attention kernel launched.  (2) In place on
    one graph-replaying engine, at two of those ticks: the cache rebuilt
    by the restore (prefill in admission's groups and chunks,
    teacher-forced replay through a one-tick window's graph) equals the
    cache the engine's own windows wrote, byte for byte at every written
    position, the existing graphs replay on, and the streams equal the
    uninterrupted ones.  Reports each restore's seconds (prefill and
    replay apart), the snapshot's JSON bytes and the host ms of
    ``write_snapshot`` per window."""
    import json
    import os

    from repro_torch.dist.fault_tolerance import (SERVE_PHASES,
                                                  FailureInjector,
                                                  run_serve_with_restarts)
    from repro_torch.serve.graphs import KERNEL_WRAPPERS

    t_phase = time.perf_counter()
    kernel = ("paged_decode_attention" if layout == "paged"
              else "decode_attention")
    SCRATCH.mkdir(parents=True, exist_ok=True)
    path = str(SCRATCH / f"fault-{layout}-{int(kv_quant)}.json")
    if os.path.exists(path):
        os.remove(path)
    crash = dict(zip(ticks, SERVE_PHASES))
    injector = FailureInjector(crash)
    restores, write_ms = [], []

    def make_engine():
        eng = serve_engine(cfg, params, layout, kv_quant, injector=injector,
                           snapshot_path=path, **knobs)
        restore, write = eng.restore, eng.write_snapshot

        def timed_restore(snap, streams=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            restore(snap, streams=streams)
            torch.cuda.synchronize()
            restores.append({
                "tick": eng.tick, "seconds": time.perf_counter() - t0,
                **eng.last_restore,
                "snapshot_json_bytes": os.path.getsize(path),
                "prefilling_slots": sum(1 for r in eng.slots
                                        if r is not None
                                        and r.state == "prefilling")})
            return eng

        def timed_write(p):
            t0 = time.perf_counter()
            write(p)
            write_ms.append(1e3 * (time.perf_counter() - t0))

        eng.restore, eng.write_snapshot = timed_restore, timed_write
        return eng

    def submit(eng):
        for req in serve_traffic(cfg, layout, max_new):
            eng.submit(req)

    for m in KERNEL_WRAPPERS.values():
        m.launches = 0
    eng = run_serve_with_restarts(make_engine, submit, snapshot_path=path,
                                  ticks=10_000, max_restarts=5)
    torch.cuda.synchronize()
    host = {k: m.launches for k, m in KERNEL_WRAPPERS.items()}
    what = f"fault {layout} {'int8' if kv_quant else 'bf16'}"
    assert injector.fired == set(crash.items()), (what, injector.fired)
    assert eng.metrics.counters["recoveries"] == 5, eng.metrics.counters
    check_streams(eng.finished, want, what)
    assert_drained(eng, what)
    assert host[kernel] > 0 and eng._graphs.replays > 0, (host, what)
    if knobs.get("prefill_chunk"):
        assert any(r["prefilling_slots"] for r in restores), restores

    # (2) in place on one engine, the cache compared byte for byte
    eng = serve_engine(cfg, params, layout, kv_quant, **knobs)
    submit(eng)
    compares = []
    for stop in (ticks[1], ticks[3]):
        while eng.tick < stop and (len(eng.scheduler) or any(eng.slots)):
            eng.step()
        windows = dict(eng._graphs._windows)
        replays = eng._graphs.replays
        before = eng.written_kv()
        snap = json.loads(json.dumps(eng.snapshot()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.restore(snap)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        n, nbytes = eng.compare_written_kv(before, eng.written_kv())
        assert all(eng._graphs._windows[k] is w for k, w in windows.items())
        compares.append({"tick": eng.tick, "requests": len(before),
                         "tensors_equal": n, "bytes_equal": nbytes,
                         "seconds": seconds, **eng.last_restore,
                         "replays_before": replays})
        del before
    replays = eng._graphs.replays
    done = eng.run(10_000)
    assert eng._graphs.replays > replays
    check_streams(done, want, what + " in place")
    assert_drained(eng, what + " in place")
    assert eng.metrics.counters["recoveries"] == 2
    return {"phase": "fault", "layout": layout,
            "kv": "int8" if kv_quant else "bf16", **knobs,
            "new_tokens_each": max_new,
            "crash_at": {str(k): v for k, v in crash.items()},
            "streams_equal_uninterrupted": True, "recoveries": 5,
            "restores": restores,
            "write_snapshot_ms": {"windows": len(write_ms),
                                  "mean": sum(write_ms) / len(write_ms),
                                  "max": max(write_ms)},
            "in_place": {"bitwise_cache": True, "graphs_kept": True,
                         "restores": compares},
            "seconds": time.perf_counter() - t_phase}


class SyncCounter:
    """Counts the host↔device syncs a run makes: calls of
    ``torch.cuda.synchronize`` and of ``Tensor.item``, ``.tolist`` and
    ``.cpu`` on CUDA tensors, by name, while installed."""

    NAMES = ("item", "tolist", "cpu")

    def __init__(self, torch):
        self.torch = torch
        self.counts = {n: 0 for n in self.NAMES + ("synchronize",)}

    def __enter__(self):
        torch, counts = self.torch, self.counts
        self._saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}
        self._sync = torch.cuda.synchronize

        def counting(name, fn):
            def wrapped(t, *a, **k):
                if t.is_cuda:
                    counts[name] += 1
                return fn(t, *a, **k)
            return wrapped

        for n, fn in self._saved.items():
            setattr(torch.Tensor, n, counting(n, fn))

        def sync(*a, **k):
            counts["synchronize"] += 1
            return self._sync(*a, **k)

        torch.cuda.synchronize = sync
        return self

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            setattr(self.torch.Tensor, n, fn)
        self.torch.cuda.synchronize = self._sync


def observe_phase(torch, cfg, params, layout, kv_quant, decode_ticks, want):
    """Metrics and tracing at full width on a serve phase's traffic, run
    untraced and with ``metrics="jsonl:…"``, ``trace="mem,perfetto:…"``.
    Gates: the streams equal the untraced run's and ``want``; each
    captured graph's launches and replays equal; the host↔device syncs of
    the run (``SyncCounter``) equal, so per window too; every finished
    request's ``explain`` shares sum to 100 %; the Perfetto file parses,
    its counter samples equal the JSONL gauge records value for value, and
    the JSONL has one gauge record per engine step (window).  Reports
    decode tok/s traced against untraced and TTFT/ITL p50/p95."""
    import json

    t_phase = time.perf_counter()
    SCRATCH.mkdir(parents=True, exist_ok=True)
    tag = f"{layout}-{int(kv_quant)}-{decode_ticks}"
    feed, pf = SCRATCH / f"metrics-{tag}.jsonl", SCRATCH / f"trace-{tag}.json"
    for f in (feed, pf):
        if f.exists():
            f.unlink()
    runs = {}
    for traced in (False, True):
        kw = (dict(metrics=f"jsonl:{feed}", trace=f"mem,perfetto:{pf}")
              if traced else {})
        eng = serve_engine(cfg, params, layout, kv_quant,
                           decode_ticks=decode_ticks, **kw)
        for req in serve_traffic(cfg, layout):
            eng.submit(req)
        torch.cuda.synchronize()
        with SyncCounter(torch) as syncs:
            t0 = time.perf_counter()
            done = eng.run(10_000)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        check_streams(done, want, f"observe {tag} traced={traced}")
        st, ms = eng.stats, eng.metrics.summary()
        capture_s = eng._graphs.capture_s
        runs[traced] = {
            "eng": eng, "streams": {tuple(r.prompt): r.out for r in done},
            "syncs": syncs.counts, "windows": st["decode_calls"],
            "steps": ms["ticks"],
            "graphs": {k: (w["launches"], w["replays"])
                       for k, w in eng._graphs.windows().items()},
            "line": {"wall_s": wall, "capture_s": capture_s,
                     "decode_tok_s": st["decode_tokens"] / st["decode_s"],
                     "decode_tok_s_after_capture": st["decode_tokens"]
                     / (st["decode_s"] - capture_s),
                     "windows": st["decode_calls"], "syncs": syncs.counts,
                     "ttft_ms": {q: 1e3 * ms["ttft_s"][q]
                                 for q in ("p50", "p95")},
                     "itl_ms": {q: 1e3 * ms["itl_s"][q]
                                for q in ("p50", "p95")}}}
    plain, traced = runs[False], runs[True]
    assert traced["streams"] == plain["streams"]
    assert traced["graphs"] == plain["graphs"], (traced["graphs"],
                                                 plain["graphs"])
    assert traced["windows"] == plain["windows"]
    assert traced["syncs"] == plain["syncs"], (traced["syncs"],
                                               plain["syncs"])
    eng = traced["eng"]
    shares = [sum(eng.explain(r.rid)["shares"].values())
              for r in eng.finished]
    assert all(abs(x - 1.0) < 0.01 for x in shares), shares
    eng.trace.close()
    eng.metrics.close()
    records = [json.loads(ln) for ln in feed.read_text().splitlines()]
    trace = json.loads(pf.read_text())
    assert len(records) == traced["steps"] > 0, (len(records),
                                                 traced["steps"])
    counters = {}
    for e in trace["traceEvents"]:              # in the order recorded
        if e["ph"] == "C":
            counters.setdefault(e["name"], []).append(e["args"]["value"])
    for key in records[0]:
        if key not in ("t", "tick"):
            assert counters[key] == [r[key] for r in records], key
    spans = sum(1 for e in trace["traceEvents"] if e["ph"] == "X")
    return {"phase": "observe", "layout": layout,
            "kv": "int8" if kv_quant else "bf16",
            "decode_ticks_per_window": decode_ticks,
            "streams_equal_untraced": True, "graphs_equal": True,
            "syncs_equal": True, "steps": traced["steps"],
            "syncs_per_window": {k: v / traced["windows"]
                                 for k, v in traced["syncs"].items()},
            "jsonl_records": len(records), "perfetto_events":
                len(trace["traceEvents"]), "perfetto_spans": spans,
            "explain_shares_min_max": [min(shares), max(shares)],
            "untraced": plain["line"], "traced": traced["line"],
            "seconds": time.perf_counter() - t_phase}


def overload_phase(torch, cfg, params, want):
    """Overload at full width.  (1) The paged int8 traffic at ``WINDOW``
    ticks on the serve phase's 56-block pool, which crosses
    ``degrade_high``: the windows step down to one tick (a one-tick graph
    captured mid-run) and back, ``degrade_events`` ≥ 1, and the streams
    equal the W = 1 streams (``want``) and the same run's with
    degradation off (``degrade_high=None``).  (2) Admission control, on a
    paged int8 engine: ``queue_cap`` 3 with 'reject-new' and with
    'evict-lowest-priority', and deadlines driven by the engine's
    injected clock expiring a queued and cancelling running requests —
    every finish reason as the policy says, and nothing left in a slot,
    the queue or the pool."""
    t_phase = time.perf_counter()
    runs = {}
    for degrade in (True, False):
        eng = paged_engine(cfg, params, True, decode_ticks=WINDOW,
                           trace="mem" if degrade else None,
                           **({} if degrade else dict(degrade_high=None)))
        for req in serve_traffic(cfg, "paged"):
            eng.submit(req)
        done = eng.run(10_000)
        check_streams(done, want, f"overload degrade={degrade}")
        assert_drained(eng, "overload")
        runs[degrade] = eng
    eng, calm = runs[True], runs[False]
    assert {tuple(r.prompt): r.out for r in eng.finished} == {
        tuple(r.prompt): r.out for r in calm.finished}
    assert eng.metrics.counters.get("degrade_events", 0) >= 1
    assert "degrade_events" not in calm.metrics.counters
    ticks = [r["n_ticks"] for r in eng.trace.records()
             if r.get("name") == "decode_window" and r["rid"] is None]
    first = ticks.index(1)
    assert WINDOW in ticks[:first] and WINDOW in ticks[first:], ticks
    one_tick = {str(k): w["capture_s"] for k, w in
                eng._graphs.windows().items() if k[0] == 1}
    assert one_tick
    degraded = {"windows": len(ticks), "one_tick_windows": ticks.count(1),
                "degrade_events": eng.metrics.counters["degrade_events"],
                "slow_windows": eng.metrics.counters.get("slow_windows", 0),
                "one_tick_capture_s": one_tick,
                "capture_s": eng._graphs.capture_s,
                "decode_tok_s": eng.stats["decode_tokens"]
                / eng.stats["decode_s"],
                "undegraded_decode_tok_s": calm.stats["decode_tokens"]
                / calm.stats["decode_s"],
                "undegraded_windows": calm.stats["decode_calls"],
                "undegraded_slow_windows":
                    calm.metrics.counters.get("slow_windows", 0)}
    del runs, eng, calm

    # (2) admission control and deadlines on the injected clock
    reasons = {}
    for policy in ("reject-new", "evict-lowest-priority"):
        eng = paged_engine(cfg, params, True, queue_cap=3,
                           shed_policy=policy, scheduler="priority")
        reqs = paged_requests(cfg, 13, [16 + 8 * i for i in range(13)], 8)
        for g in range(0, 8, 3):                 # within the queue's cap
            for r in reqs[g:min(g + 3, 8)]:
                eng.submit(r)
            eng.step()                           # ... 8 slots busy
        for r in reqs[8:11]:                     # the queue fills
            eng.submit(r)
        if policy == "reject-new":
            reqs[11].deadline_s = 1e6
            eng.submit(reqs[11])                 # shed: the queue is full
            for r in reqs[:2]:
                r.deadline_s = 1e6               # running, cancelled below
            reqs[9].deadline_s = 1e6             # queued, expired below
            clock = eng._now
            eng._now = lambda: clock() + 2e6
            want_reasons = {0: "deadline", 1: "deadline", 9: "deadline",
                            11: "shed"}
        else:
            reqs[11].priority = 5
            eng.submit(reqs[11])                 # evicts rid 10
            eng.submit(reqs[12])                 # priority 0: shed
            want_reasons = {10: "shed", 12: "shed"}
        eng.run(1000)
        got = {r.rid: r.finish_reason for r in eng.finished}
        assert len(got) == len(set(got)) and len(got) >= 12, got
        for rid, reason in got.items():
            assert reason == want_reasons.get(rid, "length"), (policy, got)
        assert_drained(eng, f"overload {policy}")
        reasons[policy] = {str(k): v for k, v in sorted(got.items())}
    return {"phase": "overload", "layout": "paged", "kv": "int8",
            "window": WINDOW, "num_blocks": PAGED_BLOCKS,
            "degrade_high": 0.9, "degrade_low": 0.7,
            "streams_equal_w1_and_undegraded": True, **degraded,
            "admission": reasons,
            "seconds": time.perf_counter() - t_phase}


# --------------------------------------------------------------------------
# training and the pulse-stream core (ROADMAP Queue 1 items 12 and 6a)
# --------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 10
# cosine peak and warm-up steps of the train runs (a peak of 3e-3 made the
# loss of 20 steps rise at full width on an H100)
TRAIN_LR = (1e-3, 5)
TRAIN_RESTART_LAYERS = 2    # the restart run's depth (its gates: bitwise)
TRAIN_CRASHES = {1: "after_save", 2: "before_save"}   # the restart run's
CORE_N = (16, 64, 256, 1024)     # pulse counts of the core phase
CORE_TRIALS = 256                # encodings of each x (as test_paper_stats)
CORE_OP_TRIALS = 20              # pulse streams of each random op


def layer_products(cfg, kind="attn"):
    """Dense products of one layer that run through ``policy.dense``: the
    four attention projections, the RG-LRU block's three or the SSD
    block's two (in and out), and then, but for SSD blocks, the MLP's
    three (SwiGLU) or two (GELU), or the shared expert's three
    (qwen2-moe); the routed experts are fake-quantised ``einsum``s, as in
    the reference, not kernel 6."""
    if kind == "ssm":
        return 2
    mlp = 0 if cfg.n_experts and not cfg.shared_d_ff else (
        2 if cfg.mlp_act == "gelu" else 3)
    return (4 if kind == "attn" else 3) + mlp


def model_products(cfg):
    """Dense products of one decode forward's layers (``layer_products``
    over the layer kinds), the LM head not counted.  An encoder-decoder's
    decoder layer has eight: the self-attention's four, the
    cross-attention's q and o (its K/V are the cache's) and the GELU
    MLP's two."""
    if cfg.is_encdec:
        return 8 * cfg.n_layers
    return sum(layer_products(cfg, cfg.layer_kind(i))
               for i in range(cfg.n_layers))


def head_products(cfg):
    """Dense products of the LM head: one, but none for the
    encoder-decoder, whose tied head is a plain product (as the
    reference's)."""
    return 0 if cfg.is_encdec else 1


def train_launches(cfg, remat):
    """Kernel-6 launches of one train step under the dither policy: the
    layers' dense products (``model_products``: seven a layer for a dense
    model) and the LM head in the forward, and the layers' again when
    ``remat`` recomputes them in the backward (the head is not
    recomputed); the backward's products are plain ``torch.matmul``
    (straight-through).  The encoder-decoder: six a encoder layer (not
    recomputed), ten a decoder layer (the cross-attention's K/V project
    the encoder output), its head plain."""
    if cfg.is_encdec:
        dec = 10 * cfg.n_layers
        return 6 * cfg.n_enc_layers + dec + (dec if remat else 0)
    per = model_products(cfg)
    return per + 1 + (per if remat else 0)


def profiled_step(torch, step_fn, state, data):
    """One train step under ``torch.profiler``: wall ms (to the loss on
    the host), device ms of every kernel, busy share, kernel 6's device ms
    and share, launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, metrics = step_fn(state, data)
        float(metrics["loss"])
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in kernels)
    k6_us = sum(e.self_device_time_total for e in kernels
                if any(n in e.key for n in DITHER_KERNELS))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {"wall_ms": wall_ms, "device_ms": device_us / 1e3,
            "device_busy_share": device_us / 1e3 / wall_ms,
            "kernel6_device_ms": k6_us / 1e3,
            "kernel6_device_share": k6_us / max(device_us, 1e-9),
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:80],
                             "device_ms": e.self_device_time_total / 1e3,
                             "launches": e.count} for e in top]}


def train_run(torch, dm, cfg, policy, steps, device):
    """``steps`` train steps of batch ``TRAIN_BATCH`` × ``TRAIN_SEQ`` from
    seed 0 (cosine schedule, remat), each launch count set to 0 just
    before a step and read just after.  Gates: every loss finite, the last
    five below the first five on average, kernel 6 launched
    ``train_launches`` times a step through the policy entry (0 without a
    policy)."""
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedules import cosine_schedule
    from repro_torch.train import trainer

    opt = AdamW(lr=cosine_schedule(TRAIN_LR[0], TRAIN_LR[1], steps))
    step_fn = trainer.make_train_step(cfg, opt, policy=policy)
    state = trainer.init_train_state(cfg, seed=0, device=device)
    dcfg = DataConfig(batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0)
    want = train_launches(cfg, True) if policy is not None else 0
    losses, step_ms, launches = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for s in range(steps):
        data = synthetic_batch(cfg, dcfg, s, device=device)
        dm.dither_matmul.launches = dm.dither_matmul_scaled.launches = 0
        t0 = time.perf_counter()
        state, metrics = step_fn(state, data)
        losses.append(float(metrics["loss"]))
        step_ms.append(1e3 * (time.perf_counter() - t0))
        launches.append(dm.dither_matmul_scaled.launches)
        assert dm.dither_matmul.launches == launches[-1], (
            "a train product left the policy entry",
            dm.dither_matmul.launches, launches[-1])
    peak = torch.cuda.max_memory_allocated()
    assert all(math.isfinite(x) for x in losses), losses
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    assert last < first, ("loss did not fall", first, last)
    assert launches == [want] * steps, ("kernel-6 launches a step",
                                        launches, want)
    median_ms = sorted(step_ms[1:])[(steps - 1) // 2]
    res = {"policy": policy.scheme if policy else "none",
           "backend": policy.backend if policy else None,
           "steps": steps, "losses": losses,
           "loss_first5": first, "loss_last5": last,
           "step_host_ms": step_ms, "first_step_host_ms": step_ms[0],
           "median_step_host_ms": median_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (median_ms / 1e3),
           "peak_memory_allocated_gb": peak / 1e9,
           "kernel6_launches_per_step": want,
           "kernel6_launches": sum(launches)}
    data = synthetic_batch(cfg, dcfg, steps, device=device)
    res["profiled_step"] = profiled_step(torch, step_fn, state, data)
    return res


def train_parity(torch, dm, cfg, policy_cls, device):
    """One step's loss and every gradient through kernel 6 (backend
    ``cuda``) against the same step through its plain version (backend
    ``torch-ref``, passed explicitly), same params and batch, bit for bit;
    the kernel's step twice and with ``remat=False`` (bit for bit: the
    recomputation and the repeat change nothing), with its launch counts."""
    from repro_torch import tree
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.train import trainer

    params = trainer.init_train_state(cfg, seed=0, device=device)["params"]
    data = synthetic_batch(cfg, DataConfig(TRAIN_BATCH, TRAIN_SEQ, seed=0),
                           0, device=device)
    out, counts = {}, {}
    for name, backend, remat in (("cuda", "cuda", True),
                                 ("cuda_again", "cuda", True),
                                 ("cuda_no_remat", "cuda", False),
                                 ("plain", "torch-ref", True)):
        pol = policy_cls(scheme="dither", bits=8, backend=backend)
        dm.dither_matmul.launches = dm.dither_matmul_scaled.launches = 0
        loss, grads = trainer.loss_and_grads(params, cfg, data, pol, 0,
                                             remat=remat)
        torch.cuda.synchronize()
        counts[name] = dm.dither_matmul_scaled.launches
        out[name] = (loss, tree.leaves(grads))
    names = [tree.path_str(p) for p, _ in tree.leaves_with_path(params)]
    res = {"launches": counts, "grad_leaves": len(names),
           "loss": {k: float(v[0]) for k, v in out.items()}}
    for other in ("cuda_again", "cuda_no_remat", "plain"):
        bad = [i for i, (x, y) in enumerate(zip(out["cuda"][1],
                                                 out[other][1]))
               if not torch.equal(x, y)]
        res[f"cuda_equals_{other}_bitwise"] = (
            not bad and torch.equal(out["cuda"][0], out[other][0]))
        res[f"differing_leaves_{other}"] = [names[i] for i in bad]
    assert counts == {"cuda": train_launches(cfg, True),
                      "cuda_again": train_launches(cfg, True),
                      "cuda_no_remat": train_launches(cfg, False),
                      "plain": 0}, counts
    for other in ("cuda_again", "cuda_no_remat", "plain"):
        assert res[f"cuda_equals_{other}_bitwise"], (other, res)
    return res


def checkpoint_equal(a_dir, b_dir, step):
    """Leaves of two checkpoints at ``step`` that differ in any bit (and
    the leaf count)."""
    import numpy as np

    name = f"step_{step:08d}/arrays.npz"
    with np.load(Path(a_dir) / name) as a, np.load(Path(b_dir) / name) as b:
        assert sorted(a.files) == sorted(b.files)
        bad = [k for k in a.files
               if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape
               or a[k].tobytes() != b[k].tobytes()]
        return bad, len(a.files)


def train_restart(torch, cfg, policy, device):
    """``run_training`` (4 steps, a checkpoint every 2) through
    ``run_with_restarts`` with crashes ``TRAIN_CRASHES`` (after the step-2
    save, then before step 2 of the resumed run) against the same run
    uninterrupted: the final checkpoints (params, moments, step, counter)
    equal leaf for leaf, bit for bit, and the resumed losses equal the
    uninterrupted ones.  Then the save and restore times of the full train
    state."""
    import shutil

    from repro_torch import tree
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.dist.fault_tolerance import (FailureInjector,
                                                  run_with_restarts)
    from repro_torch.launch.train import run_training
    from repro_torch.train import trainer

    root = SCRATCH / "train"
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(steps=4, batch=TRAIN_BATCH, seq=TRAIN_SEQ, policy=policy,
              ckpt_every=2, peak_lr=TRAIN_LR[0], device=device,
              log=lambda *a: None)
    _, want = run_training(cfg, ckpt_dir=str(root / "plain"), **kw)
    injector = FailureInjector(crash_at=TRAIN_CRASHES)
    attempts = []

    def loop(i):
        _, losses = run_training(cfg, ckpt_dir=str(root / "crashed"),
                                 injector=injector, **kw)
        attempts.append(i)
        return losses

    resumed = run_with_restarts(loop)
    bad, n_leaves = checkpoint_equal(root / "plain", root / "crashed", 4)
    res = {"crashes": {str(k): v for k, v in TRAIN_CRASHES.items()},
           "fired": sorted(f"{s}:{p}" for s, p in injector.fired),
           "attempts": attempts[-1] + 1, "leaves": n_leaves,
           "differing_leaves": bad, "losses": want,
           "resumed_losses": resumed}
    assert injector.fired == {(s, p) for s, p in TRAIN_CRASHES.items()}
    assert not bad, ("resumed run's final state differs", bad)
    assert resumed == want[-len(resumed):], (resumed, want)
    # save / restore of the full state, on the card
    state = trainer.init_train_state(cfg, seed=0, device=device)
    ck = Checkpointer(str(root / "timed"), keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save(1, state)
    res["save_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    back = ck.restore(1, state)
    torch.cuda.synchronize()
    res["restore_ms"] = 1e3 * (time.perf_counter() - t0)
    res["checkpoint_bytes"] = sum(      # bf16 leaves are stored as f32
        t.numel() * (4 if t.dtype == torch.bfloat16 else t.element_size())
        for t in tree.leaves(back))
    shutil.rmtree(root, ignore_errors=True)
    return res


def train_phase(torch, dm, cfg, device="cuda", steps=TRAIN_STEPS):
    """The training path (ROADMAP Queue 1 item 12): full-width
    SmolLM-135M, batch ``TRAIN_BATCH`` × ``TRAIN_SEQ``, ``steps`` steps
    with no policy and under ``QuantPolicy(scheme="dither", bits=8,
    backend="auto")`` (every dense product of the forward through kernel
    6's policy entry, at M = 4,096 rows; the tied head through the
    transposed view of ``embed``); the CUDA step against the plain step;
    a crashed and resumed run against an uninterrupted one.  Every gate
    is hard."""
    from repro_torch.numerics.policy import QuantPolicy

    dither = QuantPolicy(scheme="dither", bits=8, backend="auto")
    res = {"phase": "train", "model": cfg.name, "layers": cfg.n_layers,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "schedule": {"cosine_peak": TRAIN_LR[0], "warmup": TRAIN_LR[1],
                        "total": steps}}
    mark, parts = part_timer()
    res["runs"] = [train_run(torch, dm, cfg, pol, steps, device)
                   for pol in (None, dither)]
    mark("runs")
    res["parity"] = train_parity(torch, dm, cfg, QuantPolicy, device)
    mark("parity")
    res["restart"] = train_restart(
        torch, dataclasses.replace(cfg, n_layers=TRAIN_RESTART_LAYERS),
        dither, device)
    mark("restart")
    res["part_s"] = parts
    return res


def core_phase(torch, device="cuda"):
    """The paper's pulse-stream core (§II–IV, ROADMAP Queue 1 item 6a) on
    the card: the dither, deterministic and stochastic encoders of an
    off-lattice x grid (33 values, ``CORE_TRIALS`` encodings each) and
    ``multiply_estimate`` / ``scaled_add_pulses`` of 800 uniform pairs
    (``CORE_OP_TRIALS`` streams each), at N in ``CORE_N``, from a seeded
    ``torch.Generator``.  Gates, as ``tests/test_paper_stats.py`` and
    ``tests/test_ops.py`` hold the reference: dither unbiased (8σ of its
    variance bound) with EMSE·N² ≤ 3; stochastic EMSE·N in [0.08, 0.30];
    the log-log slopes of EMSE over N near −2 (dither, deterministic) and
    −1 (stochastic); dither below stochastic at every N, for encodes,
    products and averages, and its products' EMSE a third of
    stochastic's or less."""
    import numpy as np

    from repro_torch.core import ops
    from repro_torch.core import representations as rep

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    xs = torch.linspace(0.013, 0.987, 33, device=device)
    xt = xs.expand(CORE_TRIALS, 33)
    x = torch.rand(800, generator=gen, device=device)
    y = torch.rand(800, generator=gen, device=device)
    schemes = ("dither", "stochastic", "deterministic")
    enc = {s: [] for s in schemes}
    mul = {s: [] for s in schemes}
    add = {s: [] for s in schemes}
    rows = []
    for n in CORE_N:
        pulses = {"dither": rep.dither_encode(gen, xt, n),
                  "stochastic": rep.stochastic_encode(gen, xt, n),
                  "deterministic": rep.deterministic_encode(xt, n)}
        row = {"n": n}
        for s in schemes:
            err = rep.decode(pulses[s]) - xt
            enc[s].append(float(torch.mean(err * err)))
            row[f"{s}_bias"] = float(torch.mean(err))
            for op, fn, want, out in (
                    ("mul", ops.multiply_estimate, x * y, mul),
                    ("add", ops.scaled_add_pulses, (x + y) / 2, add)):
                trials = 1 if s == "deterministic" else CORE_OP_TRIALS
                est = torch.stack([fn(gen, x, y, n, s)
                                   for _ in range(trials)])
                out[s].append(float(torch.mean((est - want) ** 2)))
                row[f"{s}_{op}_bias"] = float(torch.mean(est - want))
        row.update({f"{s}_emse": enc[s][-1] for s in schemes})
        row.update({f"{s}_{op}_emse": d[s][-1] for s in schemes
                    for op, d in (("mul", mul), ("add", add))})
        row["dither_emse_n2"] = enc["dither"][-1] * n * n
        row["stochastic_emse_n"] = enc["stochastic"][-1] * n
        rows.append(row)
    slopes = {f"{k}_{s}": float(np.polyfit(np.log(CORE_N),
                                           np.log(np.maximum(d[s], 1e-30)),
                                           1)[0])
              for s in schemes
              for k, d in (("encode", enc), ("mul", mul), ("add", add))}
    for row in rows:
        n = row["n"]
        tol = 8.0 * math.sqrt(2.0) / (n * math.sqrt(CORE_TRIALS * 33))
        assert abs(row["dither_bias"]) <= tol, (row, tol)
        assert row["dither_emse_n2"] <= 3.0, row
        assert 0.08 <= row["stochastic_emse_n"] <= 0.30, row
        assert row["dither_emse"] < row["stochastic_emse"], row
        assert row["dither_mul_emse"] < row["stochastic_mul_emse"] / 3, row
        assert row["dither_add_emse"] < row["stochastic_add_emse"], row
    assert -2.7 <= slopes["encode_dither"] <= -1.6, slopes
    assert -1.35 <= slopes["encode_stochastic"] <= -0.7, slopes
    assert -2.6 <= slopes["encode_deterministic"] <= -1.5, slopes
    for op in ("mul", "add"):       # Table I: Θ(1/N²) against Θ(1/N)
        assert -2.7 <= slopes[f"{op}_dither"] <= -1.6, slopes
        assert -1.35 <= slopes[f"{op}_stochastic"] <= -0.7, slopes
    return {"phase": "core", "device": device, "n": list(CORE_N),
            "trials": CORE_TRIALS, "op_trials": CORE_OP_TRIALS,
            "rows": rows, "slopes": slopes,
            "seconds": time.perf_counter() - t0}


# --------------------------------------------------------------------------
# the attention-only rest of the zoo (ROADMAP Queue 1 item 11, first half)
# --------------------------------------------------------------------------

ZOO = ("granite_3_8b", "minicpm_2b", "internvl2_1b", "granite_moe_1b_a400m",
       "qwen2_moe_a2_7b")
ZOO_REQUESTS, ZOO_NEW = 8, 32    # requests of a zoo serve run, new tokens
ZOO_SYSTEM = 128                 # the paged traffic's shared system prompt
ZOO_POLICY = "granite_moe_1b_a400m"       # served under the dither policy
ZOO_POLICY_NEW = 4          # new tokens a request of a zoo policy run
# a scanned prefill's policy prompts (tokens): eager under the policy,
# one forward a position (served and held to the plain route)
ZOO_POLICY_PARITY_LEN = 8
ZOO_TRAIN = ("granite_moe_1b_a400m", "internvl2_1b")
# granite-moe trains at 4 of its 24 layers (its widths, and so
# every product shape, stay; its plain-route parity step was most of the
# time)
ZOO_TRAIN_LAYERS = {"granite_moe_1b_a400m": 4}
ZOO_TRAIN_STEPS = 2
ZOO_PARITY_STEPS = 8
# the recurrent configs (ROADMAP Queue 1 item 11b-i): mamba2 served under
# the policy and trained; recurrentgemma (≈ 15 GB of weights, f32 AdamW
# moments alone ≈ 72 GB) served only, with a crashed run
RECURRENT_ZOO = ("mamba2_370m", "recurrentgemma_9b")
# their depth on the card (the widths, and so every kernel and
# library shape, stay the model's; recurrentgemma keeps its two remainder
# layers after whole (rglru, rglru, attn) periods): the scanned prefill
# steps every layer once a prompt position, so depth was most of their
# phases' time (PERF.md §4)
RECURRENT_LAYERS = {"mamba2_370m": 16, "recurrentgemma_9b": 14}
# the parity's prompts of a scanned-prefill config (the ring traffic's,
# cut): its prefill is one eager forward a position
ZOO_PARITY_SCANNED_LEN = 64
RECURRENT_POLICY = ("mamba2_370m",)
RECURRENT_TRAIN = ("mamba2_370m",)
# kernel 1 at recurrentgemma's attention (1 KV head, group 16, head dim
# 256): a wrapped 2,048-slot ring under the 2,048-token window, and the
# serve cache's 1,024 slots
HD256_CASES = ((2048, 2048, [0, 37, 255, 1023, 2047, 2048, 3000, 4095]),
               (1024, 2048, [0, 37, 255, 511, 700, 1023, 1500, 2047]))
ZOO_FAULT_TICK = 9          # the zoo fault runs' one crash ("mid_window")
# the encoder-decoder (ROADMAP Queue 1 item 11b-ii), last: whisper-small
# at full width and depth over 8 slots of 1,500 audio-stub frames each;
# kernel 1 at its self-attention (12 KV heads, group 1, head dim 64) over
# the serve cache's 1,024 slots, bf16 only (its self-KV is bf16)
ENCDEC = "whisper_small"
ENCDEC_CASES = ((1024, 0, LONG_POS),)
ENCDEC_KERNEL_TOL = 1e-6
# zoo_parity's limits on the kernel route's logits against the plain
# route's, (max, mean) over 8 decode steps from copies of one cache whose
# histories drift apart: dense full-width stacks (up to 40 layers) round
# bf16 attention sums in another order; MoE adds near-tied routings that
# flip, each moving a row by a routed expert's output
ZOO_PARITY_ATOL = {"dense": (2.0 ** -2, 2.0 ** -5),
                   "moe": (2.0 ** 0, 2.0 ** -3)}
# kernel 6's policy entry at each config's decode shapes (M 8) that the
# smollm rows do not cover: granite-3-8b's MLP both ways (K·255² < 2³¹ at
# K 12,800) and its head, the tied heads of minicpm and internvl2 (the
# transposed embedding, padded vocab), qwen2-moe's shared expert, and
# granite-moe's products of its policy serve run
ZOO_MATMULS = {
    "granite_3_8b": ((8, 4096, 12800, False), (8, 12800, 4096, False),
                     (8, 4096, 49168, False)),
    "minicpm_2b": ((8, 2304, 122768, True),),
    "internvl2_1b": ((8, 896, 151664, True),),
    "granite_moe_1b_a400m": ((8, 1024, 1024, False), (8, 1024, 512, False),
                             (8, 1024, 49168, False)),
    "qwen2_moe_a2_7b": ((8, 2048, 5632, False), (8, 5632, 2048, False)),
    "mamba2_370m": ((8, 1024, 4384, False), (8, 2048, 1024, False),
                    (8, 1024, 50288, True)),
    # whisper's three product shapes at decode (M 8), training's decoder
    # (8 x 512 tokens) and the encoder's and cross K/V's (8 x 1,500 frames)
    "whisper_small": tuple((m, k, n, False) for m in (8, 4096, 12000)
                           for k, n in ((768, 768), (768, 3072),
                                        (3072, 768))),
}


def zoo_shape(cfg):
    """(n_kv, group, head dim) of a config's attention."""
    return dict(nkv=cfg.n_kv_heads, group=cfg.n_heads // cfg.n_kv_heads,
                hd=cfg.hd())


def zoo_kernel_checks(torch, cfg, da, pda, va, pva, ref):
    """Kernels 1–4 at a config's (n_kv, group, head dim), bf16 and int8,
    window 0: each against its plain version with the kernels' tiles and
    split and in the plain version's own order (``check_kernel``), each
    verify row equal to the decode kernel at its position bit for bit;
    then cold event ms of the kernel, the plain version and SDPA
    (``cold_times``, unprofiled) and the bound.  Ring: B 8, cap 1024 (B 9
    for verify, K 4); paged: 64-token blocks, a 2048-token table, rows 5
    and 6 sharing their first blocks."""
    gen = torch.Generator().manual_seed(9)
    sh = zoo_shape(cfg)
    ring_kw = dict(block=(da.KERNEL_BLOCK,), split=da.SPLIT_TILES)
    rows = []
    for quant in (False, True):
        kv = "int8" if quant else "bf16"
        t = ring_inputs(gen, quant=quant, pos_vals=LONG_POS, b=8, cap=1024,
                        **sh)
        _, res = check_kernel(torch, da.decode_attention,
                              ref.decode_attention_ref, t, 0, ring_kw)
        res.update(cold_times(t, da.decode_attention,
                              ref.decode_attention_ref,
                              lambda c: library_call(c, 0), (100, 5, 50),
                              profiled=False))
        bound = decode_bound(LONG_POS, b=8, cap=1024, quant=quant, window=0,
                             **sh)
        rows.append({"name": f"decode_attention[{kv}]", "pos": LONG_POS,
                     "shape": {"B": 8, "cap": 1024, **sh}, **res,
                     "bound_ms": bound[0], "bound_by": bound[1]})

        t = pool_inputs(gen, quant=quant, pos_vals=LONG_POS, share=(5, 6),
                        b=8, nbmax=32, bs=64, **sh)
        _, res = check_kernel(torch, pda.paged_decode_attention,
                              ref.paged_decode_attention_ref, t, 0,
                              dict(split=da.SPLIT_TILES))
        res.update(cold_times(t, pda.paged_decode_attention,
                              ref.paged_decode_attention_ref,
                              lambda c: paged_library_call(c, 0),
                              (100, 3, 20), profiled=False))
        bound = paged_bound(t, 0, quant=quant)
        rows.append({"name": f"paged_decode_attention[{kv}]",
                     "pos": LONG_POS,
                     "shape": {"B": 8, "bs": 64, "nbmax": 32, **sh}, **res,
                     "bound_ms": bound[0], "bound_by": bound[1]})

        pos_vals = LONG_POS + [1022]
        t = ring_inputs(gen, quant=quant, pos_vals=pos_vals, kq=SPEC_K, b=9,
                        cap=1024, **sh)
        got, res = check_kernel(torch, va.verify_attention,
                                ref.verify_attention_ref, t, 0, ring_kw)
        same = rows_equal(torch, got, da.decode_attention, t, 0)
        assert same, (cfg.name, kv, "verify rows")
        res.update(cold_times(t, va.verify_attention,
                              ref.verify_attention_ref,
                              lambda c: verify_library_call(c, 0),
                              (100, 3, 50), profiled=False))
        bound = verify_bound(pos_vals, SPEC_K, b=9, cap=1024, quant=quant,
                             window=0, **sh)
        rows.append({"name": f"verify_attention[{kv}]", "pos": pos_vals,
                     "shape": {"B": 9, "cap": 1024, "kq": SPEC_K, **sh},
                     **res, "rows_equal_decode_kernel_bitwise": same,
                     "bound_ms": bound[0], "bound_by": bound[1]})

        pos_vals = LONG_POS + [2046]
        t = pool_inputs(gen, quant=quant, pos_vals=pos_vals, share=(5, 6),
                        kq=SPEC_K, b=9, nbmax=32, bs=64, **sh)
        got, res = check_kernel(torch, pva.paged_verify_attention,
                                ref.paged_verify_attention_ref, t, 0,
                                dict(split=da.SPLIT_TILES))
        same = rows_equal(torch, got, pda.paged_decode_attention, t, 0)
        assert same, (cfg.name, kv, "paged verify rows")
        res.update(cold_times(t, pva.paged_verify_attention,
                              ref.paged_verify_attention_ref,
                              lambda c: paged_verify_library_call(c, 0),
                              (100, 2, 20), profiled=False))
        bound = paged_bound(t, 0, quant=quant)
        rows.append({"name": f"paged_verify_attention[{kv}]",
                     "pos": pos_vals,
                     "shape": {"B": 9, "bs": 64, "nbmax": 32, "kq": SPEC_K,
                               **sh}, **res,
                     "rows_equal_decode_kernel_bitwise": same,
                     "bound_ms": bound[0], "bound_by": bound[1]})
    for row in rows:
        row["model_shapes"] = cfg.name.replace("-", "_").replace(".", "_")
    return rows


def zoo_matmul_checks(torch, name, dm, ref):
    """Kernel 6's policy entry at ``ZOO_MATMULS[name]``: bit for bit its
    plain version, every scheme; then event ms (inputs rotated past the
    L2), the plain version's ms, the unquantised bf16 ``torch.matmul`` of
    the same operands and the bound (``matmul_bound``)."""
    gen = torch.Generator().manual_seed(10)
    rows = []
    for m, k, n, tied in ZOO_MATMULS[name]:
        x = torch.randn((m, k), generator=gen).to(torch.bfloat16).cuda()
        if tied:        # the tied head: the (N, K) embedding's transpose
            w = (torch.randn((n, k), generator=gen) * 0.05).to(
                torch.bfloat16).cuda().T
        else:
            w = (torch.randn((k, n), generator=gen) * 0.05).to(
                torch.bfloat16).cuda()
        for scheme in DITHER_SCHEMES:
            kw = dict(bits=8, scheme=scheme, counter=77, seed=3)
            got = dm.dither_matmul_scaled(x, w, dm.weight_absmax(w), **kw)
            torch.cuda.synchronize()
            want = ref.dither_matmul_scaled_ref(x, w, **kw)
            assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
            assert torch.equal(got, want), (name, (m, k, n), scheme)
        kw = dict(bits=8, scheme="dither", counter=77, seed=3)
        run = rotated(torch, lambda s, t: dm.dither_matmul_scaled(
            s, t, dm.weight_absmax(t), **kw), [x, w])
        bound_ms, term = matmul_bound(m, k, n, policy=True)
        rows.append({
            "name": "dither_matmul_scaled", "shape": [m, k, n],
            "weight": "transposed view" if tied else "row",
            "max_abs_err": 0, "schemes_bitwise": len(DITHER_SCHEMES),
            "ms": cuda_ms(run, 100),
            "plain_ms": cuda_ms(lambda: ref.dither_matmul_scaled_ref(
                x, w, **kw), 2, warmup=1),
            "unquantised_bf16_matmul_ms": cuda_ms(
                rotated(torch, lambda s, t: s @ t, [x, w]), 100),
            "library_ms": None, "bound_ms": bound_ms, "bound_term": term,
            "bound_by": "bytes" if term == "bytes" else "operations"})
    return rows


@contextlib.contextmanager
def moe_drops(torch, batch):
    """Count, on the card, the routed assignments an MoE run drops: every
    ``moe.route`` call adds its dropped and total assignments to a device
    counter (decode calls: ``batch`` tokens; prefill calls: more), with
    in-place adds that a captured decode graph replays.  Yields the two
    counters (dropped, total)."""
    from repro_torch.models import moe

    acc = {k: torch.zeros(2, dtype=torch.int64, device="cuda")
           for k in ("decode", "prefill")}
    orig = moe.route

    def spy(params, cfg, xf):
        out = orig(params, cfg, xf)
        a = acc["decode" if xf.shape[0] == batch else "prefill"]
        a[0].add_((~out[3]).sum())
        a[1].add_(out[3].numel())
        return out

    moe.route = spy
    try:
        yield acc
    finally:
        moe.route = orig


def zoo_requests(cfg, layout):
    """The zoo's traffic: 8 requests, 32 new tokens each, even ones greedy
    and odd ones at temperature 0.8 with top-k 40.  Ring: prompts spread
    over 32–256 tokens; paged: a shared 128-token system prompt, then
    suffixes of 16–128 tokens."""
    import numpy as np

    rng = np.random.default_rng(1)
    if layout == "paged":
        return paged_requests(cfg, ZOO_REQUESTS, rng.permutation(
            np.linspace(16, 128, ZOO_REQUESTS).astype(int)), ZOO_NEW,
            system_len=ZOO_SYSTEM)
    return ring_requests(cfg, ZOO_REQUESTS, rng.permutation(
        np.linspace(32, 256, ZOO_REQUESTS).astype(int)), ZOO_NEW)


def zoo_serve(torch, cfg, params, layout, kv_quant, *, staged=False,
              traffic=None, **kw):
    """One zoo serve run through ``Engine`` (batch 8, ``max_len`` 1024):
    launch counts set to 0 just before the run and read just after.
    ``staged``: the first request runs one step alone, so its prefill
    seals the shared system prompt's blocks before the others arrive.
    Gates: every request its full budget in the vocabulary; the policy-free
    launch gates (``launch_gates``: kernel 1 or 2 = layers × ticks through
    graph replays); for a speculative engine, the verify kernel once per
    layer and window and nothing else.  Returns (line, streams, engine)."""
    from repro_torch.serve import Engine
    from repro_torch.serve.graphs import KERNEL_WRAPPERS

    reqs = zoo_requests(cfg, traffic or layout)
    if layout == "paged":
        kw["block_size"] = 64
    eng = Engine(params, cfg, 8, 1024, kv_quant=kv_quant, kv_layout=layout,
                 device="cuda", **kw)
    torch.cuda.synchronize()
    for m in KERNEL_WRAPPERS.values():
        m.launches = 0
    t0 = time.perf_counter()
    if staged:
        eng.submit(reqs[0])
        eng.step()
    for req in reqs[1 if staged else 0:]:
        eng.submit(req)
    done = eng.run(10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    host = {k: m.launches for k, m in KERNEL_WRAPPERS.items()}
    st = eng.stats
    assert len(done) == len(reqs), (cfg.name, layout, len(done))
    for r in done:
        assert r.finish_reason == "length" and len(r.out) == ZOO_NEW, (
            cfg.name, r.rid, r.finish_reason, len(r.out))
        assert all(0 <= t < cfg.vocab_size for t in r.out)
    paged = layout == "paged"
    if eng.spec_decode:
        kernel = "paged_verify_attention" if paged else "verify_attention"
        windows = st["spec_windows"]
        assert host[kernel] == cfg.n_layers * windows, (host, windows)
        assert all(v == 0 for n, v in host.items() if n != kernel), host
        launches = host
    else:
        kernel = "paged_decode_attention" if paged else "decode_attention"
        launches = launch_gates(eng, host, kernel, cfg)
    if paged:
        assert eng.pool.live_blocks == 0, eng.pool_stats()
    capture_s = eng._graphs.capture_s if eng._graphs is not None else 0.0
    line = {"layout": layout, "kv": "int8" if kv_quant else "bf16",
            "requests": len(reqs), "new_tokens_each": ZOO_NEW,
            "prompt_tokens": sum(len(r.prompt) for r in reqs),
            "spec_decode": eng.spec_decode,
            "decode_ticks_per_window": eng.decode_ticks,
            "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
            "decode_tok_s": st["decode_tokens"] / st["decode_s"],
            "decode_tok_s_after_capture": st["decode_tokens"]
                                          / max(st["decode_s"] - capture_s,
                                                1e-9),
            "capture_s": capture_s, "prefill_calls": st["prefill_calls"],
            "prefill_tokens_computed": st["prefill_tokens"],
            "prefix_hit_tokens": st["prefix_hit_tokens"],
            "decode_ticks": eng.tick, "windows": st["decode_calls"],
            "graph_replays": (eng._graphs.replays
                              if eng._graphs is not None else 0),
            "wall_s": wall, f"{kernel}_launches": launches[kernel],
            "launches_per_window": attn_layers(cfg) * eng.decode_ticks}
    if eng.spec_decode:
        line.update(spec_windows=st["spec_windows"],
                    accepted=st["spec_accepted_tokens"],
                    drafted=st["spec_draft_tokens"],
                    acceptance=st["spec_accepted_tokens"]
                    / max(1, st["spec_draft_tokens"]))
    return line, {r.rid: list(r.out) for r in done}, eng


def zoo_parity(torch, cfg, params, frames=None):
    """The card's decode against the plain route's: one ring prefill (bf16,
    the ring traffic's prompts), then ``ZOO_PARITY_STEPS`` greedy decode
    steps through the attention kernel (``cuda``) and its plain version
    (``torch-ref``, passed explicitly) from copies of one cache, both fed
    the plain route's tokens (an encoder-decoder's cross-KV from
    ``frames``).  Gates, at the stated ``ZOO_PARITY_ATOL``
    of the config's family: every logit within its max, each step's mean
    absolute difference within its mean, and the kernel route's greedy
    token equal to the plain route's in every row whose top-2 margin
    clears twice the max (which the max bound implies; the count of such
    rows is reported)."""
    import numpy as np

    from repro_torch.models import registry

    atol, mean_atol = ZOO_PARITY_ATOL["moe" if cfg.n_experts else "dense"]
    reqs = zoo_requests(cfg, "ring")
    if not registry.supports_batched_prefill(cfg):
        for r in reqs:
            r.prompt = r.prompt[:ZOO_PARITY_SCANNED_LEN]
    lens = np.array([len(r.prompt) for r in reqs], np.int32)
    toks = np.zeros((8, int(lens.max())), np.int64)
    for i, r in enumerate(reqs):
        toks[i, :lens[i]] = r.prompt
    logits, cache = registry.apply_prefill(
        params, cfg, torch.from_numpy(toks).cuda(),
        torch.from_numpy(lens).cuda(), 1024, frames=frames)
    caches = {p: clone_tree(cache) for p in ("cuda", "torch-ref")}
    cur = torch.argmax(logits, -1)
    worst = mean = 0.0
    scale = math.inf
    compared = rows = 0
    for _ in range(ZOO_PARITY_STEPS):
        out = {}
        for path in caches:
            out[path], caches[path] = registry.apply_decode(
                params, cfg, cur, caches[path], backend=path)
        got, want = out["cuda"], out["torch-ref"]
        assert torch.isfinite(got).all()
        d = (got - want).abs()
        worst, mean = max(worst, d.max().item()), max(mean, d.mean().item())
        scale = min(scale, want.float().std().item())
        top2 = torch.topk(want, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * atol
        same = torch.argmax(got, -1) == torch.argmax(want, -1)
        assert bool(same[clear].all()), (cfg.name, same, clear)
        compared += int(clear.sum())
        rows += clear.numel()
        cur = torch.argmax(want, -1)
    assert worst <= atol and mean <= mean_atol, (cfg.name, worst, mean)
    return {"decode_steps": ZOO_PARITY_STEPS, "rows": rows,
            "rows_margin_cleared_and_equal": compared,
            "max_abs_logit_diff": worst, "max_mean_abs_logit_diff": mean,
            "atol": atol, "mean_atol": mean_atol,
            "min_plain_logit_std": scale}


def zoo_policy(torch, cfg, params, frames=None, prompt_len=None):
    """``ZOO_POLICY`` served under ``QuantPolicy(scheme="dither",
    backend="auto")`` (ring bf16, the ring traffic): every dense product —
    attention and LM head; the routed experts are fake-quantised einsums —
    through kernel 6's policy entry.  Gates: full budgets; kernel-6
    launches = (``layer_products`` × layers + 1) a prefill call or tick,
    all through the policy entry; attention launches = layers × ticks.
    Then one prefill and three decode steps with the matmul backend
    ``cuda`` against ``torch-ref``: logits within ``LOGIT_ATOL``.  An
    encoder-decoder serves over ``frames`` (its encoder quantised when
    the engine builds its cache) and its head is plain; ``prompt_len``
    cuts the prompts."""
    from repro_torch.models import registry
    from repro_torch.numerics.policy import QuantPolicy
    from repro_torch.serve import Engine
    from repro_torch.serve.graphs import KERNEL_WRAPPERS

    eng = Engine(params, cfg, 8, 1024, device="cuda", frames=frames,
                 policy=QuantPolicy(scheme="dither", backend="auto"))
    assert eng.policy.backend == "cuda" and eng._graphs is None
    recurrent = not registry.supports_batched_prefill(cfg)
    steps = []                 # a scanned prefill's steps, call by call
    if recurrent:
        inner = eng._prefill

        def counted(params, tokens, *a, **kw):
            steps.append(tokens.shape[1])
            return inner(params, tokens, *a, **kw)

        eng._prefill = counted
    reqs = zoo_requests(cfg, "ring")
    for req in reqs:
        req.max_new = ZOO_POLICY_NEW
        req.prompt = req.prompt[:prompt_len]
        eng.submit(req)
    torch.cuda.synchronize()
    for m in KERNEL_WRAPPERS.values():
        m.launches = 0
    t0 = time.perf_counter()
    done = eng.run(10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: m.launches for k, m in KERNEL_WRAPPERS.items()}
    st = eng.stats
    assert len(done) == len(reqs)
    assert all(r.finish_reason == "length" and len(r.out) == ZOO_POLICY_NEW
               for r in done)
    per_forward = model_products(cfg) + head_products(cfg)
    # a scanned prefill (recurrent state) is one forward a prompt position
    forwards = (sum(steps) if steps else st["prefill_calls"]) \
        + st["decode_calls"]
    assert launches["dither_matmul_scaled"] == per_forward * forwards, (
        launches, per_forward, forwards)
    assert launches["dither_matmul"] == launches["dither_matmul_scaled"]
    assert launches["decode_attention"] == attn_layers(cfg) * (
        st["decode_calls"] + sum(steps)), launches
    assert launches["quantize"] == 0, launches

    # the parity prompts: the traffic's, cut to ``ZOO_POLICY_PARITY_LEN``
    # tokens for a scanned prefill (one forward a position, the plain
    # version's products at its speed)
    cut = ZOO_POLICY_PARITY_LEN if recurrent else None
    prompts = [r.prompt[:cut] for r in reqs]
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                        device="cuda")
    toks = torch.zeros((8, int(lens.max())), dtype=torch.long,
                       device="cuda")
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    out = {}
    for backend in ("cuda", "torch-ref"):
        pol = QuantPolicy(scheme="dither", backend=backend)
        logits, cache = registry.apply_prefill(params, cfg, toks, lens, 1024,
                                               policy=pol, counter=0,
                                               frames=frames)
        seq = [logits]
        for step in range(3):
            logits, cache = registry.apply_decode(
                params, cfg, torch.argmax(seq[-1], -1), cache, policy=pol,
                counter=1 + step)
            seq.append(logits)
        out[backend] = seq
    diff = max((a - b).abs().max().item()
               for a, b in zip(out["cuda"], out["torch-ref"]))
    bitwise = all(torch.equal(a, b) for a, b in zip(out["cuda"],
                                                    out["torch-ref"]))
    assert diff <= LOGIT_ATOL, diff
    assert bitwise or not recurrent, diff
    return {"layout": "ring", "kv": "bf16", "policy": "dither",
            "backend": "cuda", "requests": len(reqs),
            "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
            "decode_tok_s": st["decode_tokens"] / st["decode_s"],
            "new_tokens_each": ZOO_POLICY_NEW,
            "prompt_tokens": sum(len(r.prompt) for r in reqs),
            "prefill_calls": st["prefill_calls"],
            "scanned_prefill_steps": steps,
            "decode_ticks": st["decode_calls"], "wall_s": wall,
            "kernel6_launches": launches["dither_matmul_scaled"],
            "kernel6_launches_per_call": per_forward,
            "decode_attention_launches": launches["decode_attention"],
            "parity_prompt_tokens": int(lens.sum()),
            "parity_max_abs_logit_diff": diff,
            "parity_logits_bitwise_equal": bitwise}


def zoo_train(torch, dm, cfg):
    """``ZOO_TRAIN_STEPS`` train steps at batch ``TRAIN_BATCH`` ×
    ``TRAIN_SEQ`` (the VLM with its 256 stub embeds prepended), remat,
    cosine schedule, with no policy and under the dither policy; launch
    counts set to 0 just before each step and read just after.  Gates:
    every loss finite; kernel 6 launched ``train_launches`` times a step
    through its policy entry (0 without a policy).  Then ``train_parity``:
    one step through kernel 6 bit for bit the step through its plain
    version (also repeated and without remat)."""
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.numerics.policy import QuantPolicy
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedules import cosine_schedule
    from repro_torch.train import trainer

    steps = ZOO_TRAIN_STEPS
    out = {"batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "frontend_tokens": cfg.n_frontend_tokens, "steps": steps,
           "runs": []}
    for pol in (None, QuantPolicy(scheme="dither", bits=8, backend="auto")):
        opt = AdamW(lr=cosine_schedule(TRAIN_LR[0], 2, steps))
        step_fn = trainer.make_train_step(cfg, opt, policy=pol)
        state = trainer.init_train_state(cfg, seed=0, device="cuda")
        dcfg = DataConfig(batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0)
        want = train_launches(cfg, True) if pol is not None else 0
        losses, ms, launches = [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for s in range(steps):
            data = synthetic_batch(cfg, dcfg, s, device="cuda")
            dm.dither_matmul.launches = dm.dither_matmul_scaled.launches = 0
            t0 = time.perf_counter()
            state, metrics = step_fn(state, data)
            losses.append(float(metrics["loss"]))
            ms.append(1e3 * (time.perf_counter() - t0))
            launches.append(dm.dither_matmul_scaled.launches)
            assert dm.dither_matmul.launches == launches[-1]
        assert all(math.isfinite(x) for x in losses), losses
        assert launches == [want] * steps, (launches, want)
        median = sorted(ms[1:])[(steps - 1) // 2]
        tokens = TRAIN_BATCH * (TRAIN_SEQ + cfg.n_frontend_tokens)
        out["runs"].append({
            "policy": pol.scheme if pol else "none", "losses": losses,
            "step_host_ms": ms, "median_step_host_ms": median,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (median / 1e3),
            "positions_per_s": tokens / (median / 1e3),
            "peak_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "kernel6_launches_per_step": want,
            "kernel6_launches": sum(launches)})
        del state, step_fn
        torch.cuda.empty_cache()
    out["parity"] = train_parity(torch, dm, cfg, QuantPolicy, "cuda")
    return out


def zoo_phase(torch, name, da, pda, va, pva, dm, ref):
    """One config of the rest of the zoo at full width on the card, random
    bf16 weights from seed 0, loaded alone and freed after: its kernels at
    its shapes; the ring traffic in bf16 (MoE: the dropped share of routed
    assignments, decode and prefill) and int8, and paged in bf16 with the
    prefix cache off (its streams must equal the ring bf16 ones: paged ≡
    ring, which the reference holds for every config here, MoE included),
    and the paged traffic in int8 with a shared system prompt (prefix hits
    asserted); a speculative run (dense attention only: draft_k 4, prompt
    lookup), streams equal to the plain ones; MoE: one W = 8 window
    replayed and run eagerly from one state, byte for byte; the kernel
    route against the plain one; three steady ring bf16 ticks under the
    profiler (``profile_phase``); the policy run (``ZOO_POLICY``); the
    train runs (``ZOO_TRAIN``).  Peak memory per config."""
    import gc

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import moe, registry

    cfg = get_config(name)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    mark, parts = part_timer()
    res = {"phase": "zoo", "model": cfg.name, "family": cfg.family,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.hd()],
           "vocab_padded": cfg.vocab_padded(),
           "experts": [cfg.n_experts, cfg.n_experts_active, cfg.shared_d_ff],
           "kernels": zoo_kernel_checks(torch, cfg, da, pda, va, pva, ref),
           "matmuls": zoo_matmul_checks(torch, name, dm, ref)}
    t0 = time.perf_counter()
    params = registry.init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    res["init_s"] = time.perf_counter() - t0
    res["weights_gb"] = sum(t.numel() * t.element_size()
                            for t in tree.leaves(params)) / 1e9
    mark("kernels_and_init")
    runs = {}
    runs["ring_bf16"], ring_bf16, _ = zoo_serve(torch, cfg, params, "ring",
                                                False)
    if cfg.n_experts:
        # the drop counter's adds are captured into the decode graphs, so
        # it counts a second run of the same traffic, not the timed one
        with moe_drops(torch, 8) as acc:
            _, counted, _ = zoo_serve(torch, cfg, params, "ring", False)
        assert counted == ring_bf16, (cfg.name, "counted run != ring bf16")
        res["moe_dropped_share"] = {
            k: {"dropped": int(v[0]), "assignments": int(v[1]),
                "share": int(v[0]) / max(1, int(v[1]))}
            for k, v in acc.items()}
        res["moe_decode_capacity"] = moe.moe_capacity(8, cfg)
    mark("ring_bf16")
    runs["ring_int8"], _, _ = zoo_serve(torch, cfg, params, "ring", True)
    mark("ring_int8")
    runs["paged_bf16_cold"], paged_bf16, _ = zoo_serve(
        torch, cfg, params, "paged", False, traffic="ring",
        prefix_cache=False)
    assert paged_bf16 == ring_bf16, (cfg.name, "paged != ring",
                                     [r for r in ring_bf16
                                      if paged_bf16[r] != ring_bf16[r]])
    runs["paged_bf16_cold"]["streams_equal_ring_bf16"] = True
    runs["paged_int8_prefix"], _, _ = zoo_serve(torch, cfg, params, "paged",
                                                True, staged=True)
    assert runs["paged_int8_prefix"]["prefix_hit_tokens"] > 0
    mark("paged")
    if registry.supports_spec_decode(cfg):
        runs["spec_ring_bf16"], spec, _ = zoo_serve(
            torch, cfg, params, "ring", False, spec_decode=True,
            draft_k=SPEC_K)
        assert spec == ring_bf16, (cfg.name, "spec != plain")
        runs["spec_ring_bf16"]["streams_equal_plain"] = True
    else:
        from repro_torch.serve import Engine

        eng = Engine(params, cfg, 8, 1024, device="cuda",
                     decode_ticks=WINDOW)
        for req in zoo_requests(cfg, "ring"):
            eng.submit(req)
        eng._admit_and_prefill()
        res["window_graph_vs_eager"] = graph_against_eager(torch, eng, cfg,
                                                           params)
        done = eng.run(1000)
        assert len(done) == ZOO_REQUESTS
        assert all(len(r.out) == ZOO_NEW for r in done)
        del eng
    res["runs"] = runs
    mark("spec_or_window")
    res["parity"] = zoo_parity(torch, cfg, params)
    mark("parity")
    res["profile_tick"] = profile_phase(torch, cfg, params, False)
    mark("profile")
    if name == ZOO_POLICY:
        res["policy"] = zoo_policy(torch, cfg, params)
        mark("policy")
        res["fault"] = zoo_fault(torch, cfg, params, ring_bf16)
        mark("fault")
    res["serve_peak_memory_allocated_gb"] = (
        torch.cuda.max_memory_allocated() / 1e9)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if name in ZOO_TRAIN:
        res["train"] = zoo_train(torch, dm, dataclasses.replace(
            cfg, n_layers=ZOO_TRAIN_LAYERS.get(name, cfg.n_layers)))
        mark("train")
    res["part_s"] = parts
    res["peak_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["seconds"] = time.perf_counter() - t_start
    gc.collect()
    torch.cuda.empty_cache()
    return res


def ring_kernel_checks(torch, cfg, da, ref, cases, quants=(False, True),
                       profiled=False):
    """Kernel 1 at a config's attention (B 8; ``cases``: (cap, window,
    positions)), each cache type of ``quants``: against its plain
    version with the kernel's tiles and split and in the plain version's
    own order (``check_kernel``, within ``KERNEL_TOL``); cold event ms of
    the kernel, the plain version and SDPA (``cold_times``), the kernel's
    device ms (its named kernels in the profiler; with ``profiled`` also
    SDPA's and the host ms) and the bound.  recurrentgemma's
    (``HD256_CASES``: 1 KV head, group 16, head dim 256) runs unprofiled
    SDPA: late in a run the profiler caught no SDPA device time there."""
    gen = torch.Generator().manual_seed(21)
    sh = zoo_shape(cfg)
    ring_kw = dict(block=(da.KERNEL_BLOCK,), split=da.SPLIT_TILES)
    rows = []
    for cap, window, pos_vals in cases:
        for quant in quants:
            t = ring_inputs(gen, quant=quant, pos_vals=pos_vals, b=8,
                            cap=cap, **sh)
            _, res = check_kernel(torch, da.decode_attention,
                                  ref.decode_attention_ref, t, window,
                                  ring_kw)
            res.update(cold_times(
                t, functools.partial(da.decode_attention, window=window),
                functools.partial(ref.decode_attention_ref, window=window),
                lambda c: library_call(c, window), (100, 5, 50),
                profiled=profiled))
            if not profiled:
                # the kernel's device ms, inputs rotated past the L2
                copies = itertools.cycle(
                    [t] + [[None if x is None else x.clone() for x in t]
                           for _ in range(res["copies_rotated"] - 1)])
                res["device_ms"] = device_ms(
                    torch, lambda: da.decode_attention(*next(copies),
                                                       window=window),
                    50, ATTN_KERNELS)
            bound = decode_bound(pos_vals, b=8, cap=cap, quant=quant,
                                 window=window, **sh)
            rows.append({"name": f"decode_attention[{'int8' if quant else 'bf16'}]",
                         "model_shapes": cfg.name.replace("-", "_"),
                         "window": window, "pos": pos_vals,
                         "shape": {"B": 8, "cap": cap, **sh}, **res,
                         "bound_ms": bound[0], "bound_by": bound[1]})
    return rows


def prefill_step_times(torch, eng, params, steps=20):
    """One scanned-prefill step of ``eng`` (its ``PrefillGraphs``) timed
    alone: ``steps`` replays of the captured step between CUDA events
    (device ms a step), beside its bound: every weight read once at HBM
    bandwidth (the step reads the recurrent states and the ring too,
    which the bound leaves out)."""
    from repro_torch import tree

    g = eng._prefill
    g.lengths.fill_(1 << 30)             # every row active, as in a wave
    g.t.zero_()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        g._graph.replay()
    end.record()
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in tree.leaves(params))
    return {"replays_timed": steps,
            "device_ms_per_step": start.elapsed_time(end) / steps,
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
            "weight_bytes": nbytes, "launches_per_step": g.step_launches}


def zoo_fault(torch, cfg, params, want, frames=None):
    """A zoo config's ring bf16 traffic through ``run_serve_with_restarts``
    with a snapshot file every window and one crash (``mid_window`` at
    tick ``ZOO_FAULT_TICK``), the restarted engine restored from the file.
    Gates: one recovery, every request its full budget.  ``want`` (the
    uninterrupted streams, rid → tokens) must be equal where the restore
    is exact, which it is for every config but MoE; for MoE the restore
    is the reference's (one prefill call, a replay with the rows out of
    tokens at token 0), so only the budgets are held and the streams
    that differ are counted."""
    import os

    from repro_torch.dist.fault_tolerance import (FailureInjector,
                                                  run_serve_with_restarts)
    from repro_torch.serve import Engine

    SCRATCH.mkdir(parents=True, exist_ok=True)
    path = str(SCRATCH / f"fault-{cfg.name}.json")
    if os.path.exists(path):
        os.remove(path)
    injector = FailureInjector({ZOO_FAULT_TICK: "mid_window"})
    restores = []

    def make_engine():
        eng = Engine(params, cfg, 8, 1024, device="cuda", injector=injector,
                     snapshot_path=path, frames=frames)
        restore = eng.restore

        def timed(snap, streams=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            restore(snap, streams=streams)
            torch.cuda.synchronize()
            restores.append({"tick": eng.tick,
                             "seconds": time.perf_counter() - t0,
                             **eng.last_restore})
            return eng

        eng.restore = timed
        return eng

    def submit(eng):
        for req in zoo_requests(cfg, "ring"):
            eng.submit(req)

    t0 = time.perf_counter()
    eng = run_serve_with_restarts(make_engine, submit, snapshot_path=path,
                                  ticks=10_000, max_restarts=2)
    torch.cuda.synchronize()
    assert injector.fired == {(ZOO_FAULT_TICK, "mid_window")}, injector.fired
    assert eng.metrics.counters["recoveries"] == 1
    done = {r.rid: list(r.out) for r in eng.finished}
    assert sorted(done) == sorted(want)
    assert all(len(v) == ZOO_NEW for v in done.values())
    differ = sorted(r for r in want if done[r] != want[r])
    if not cfg.n_experts:
        assert not differ, (cfg.name, "restored streams differ", differ)
    assert_drained(eng, cfg.name + " fault")
    return {"crash_at": {str(ZOO_FAULT_TICK): "mid_window"},
            "recoveries": 1, "restores": restores,
            "streams_equal_uninterrupted": not differ,
            "streams_differing": differ, "exact_restore": not cfg.n_experts,
            "wall_s": time.perf_counter() - t0}


def recurrent_phase(torch, name, da, dm, ref):
    """One recurrent config (``RECURRENT_ZOO``) at full width on the card,
    its depth cut to ``RECURRENT_LAYERS``, random bf16 weights from seed
    0, loaded alone and freed after: kernel 1 at head dim 256 (recurrentgemma) and kernel 6's
    policy entry at mamba2's products against their plain versions; the
    zoo's ring traffic in bf16 and int8 (mamba2 has no KV, so int8 must
    serve the bf16 streams), every prompt prefilled by the scanned prefill
    replayed from its captured step (``PrefillGraphs``) and timed alone
    against its bound; one W = 8 window replayed and run eagerly from one
    state, byte for byte (recurrent states included); the kernel route
    against the plain one (``zoo_parity``); mamba2 under the dither
    policy (``zoo_policy``: kernel 6 launches per forward, logits bit
    for bit the plain route) and trained (``zoo_train``); recurrentgemma
    through a crashed and restored run whose streams equal the
    uninterrupted ones (``zoo_fault``).  Peak memory."""
    import gc

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.serve import Engine

    cfg = dataclasses.replace(get_config(name),
                              n_layers=RECURRENT_LAYERS[name])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    mark, parts = part_timer()
    res = {"phase": "zoo", "model": cfg.name, "family": cfg.family,
           "nvidia_smi": nvidia_smi(),
           "layers": cfg.n_layers, "full_layers": get_config(name).n_layers, "d_model": cfg.d_model,
           "attention_layers": attn_layers(cfg),
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.hd()],
           "vocab_padded": cfg.vocab_padded(),
           "kernels": (ring_kernel_checks(torch, cfg, da, ref, HD256_CASES)
                       if attn_layers(cfg) else []),
           "matmuls": (zoo_matmul_checks(torch, name, dm, ref)
                       if name in ZOO_MATMULS else [])}
    t0 = time.perf_counter()
    params = registry.init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    res["init_s"] = time.perf_counter() - t0
    res["weights_gb"] = sum(t.numel() * t.element_size()
                            for t in tree.leaves(params)) / 1e9
    mark("kernels_and_init")
    runs = {}
    runs["ring_bf16"], ring_bf16, eng = zoo_serve(torch, cfg, params, "ring",
                                                  False)
    mark("ring_bf16")
    pf = eng._prefill
    runs["ring_bf16"].update(
        prefill_graph_replays=pf.replays,
        prefill_graph_steps_per_call=pf.replays / eng.stats["prefill_calls"],
        prefill_graph_capture_s=pf.capture_s)
    res["prefill_step"] = prefill_step_times(torch, eng, params)
    mark("prefill_step")
    del eng, pf
    runs["ring_int8"], ring_int8, eng = zoo_serve(torch, cfg, params, "ring",
                                                  True)
    del eng
    if not attn_layers(cfg):
        assert ring_int8 == ring_bf16, (cfg.name, "int8 flag not inert")
        runs["ring_int8"]["streams_equal_ring_bf16"] = True
    res["runs"] = runs
    mark("ring_int8")
    eng = Engine(params, cfg, 8, 1024, device="cuda", decode_ticks=WINDOW)
    for req in zoo_requests(cfg, "ring"):
        eng.submit(req)
    eng._admit_and_prefill()
    res["window_graph_vs_eager"] = graph_against_eager(torch, eng, cfg,
                                                       params)
    done = eng.run(1000)
    assert len(done) == ZOO_REQUESTS
    assert {r.rid: list(r.out) for r in done} == ring_bf16, (
        cfg.name, "W = 8 != W = 1")
    res["window_streams_equal_w1"] = True
    del eng
    mark("window")
    res["parity"] = zoo_parity(torch, cfg, params)
    mark("parity")
    if name in RECURRENT_POLICY:
        # prompts cut to the parity's 16 tokens: the eager scanned
        # prefill under the policy is one forward a position
        res["policy"] = zoo_policy(torch, cfg, params,
                                   prompt_len=ZOO_POLICY_PARITY_LEN)
    mark("policy")
    if not cfg.n_experts and attn_layers(cfg):
        res["fault"] = zoo_fault(torch, cfg, params, ring_bf16)
    mark("fault")
    res["serve_peak_memory_allocated_gb"] = (
        torch.cuda.max_memory_allocated() / 1e9)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if name in RECURRENT_TRAIN:
        res["train"] = zoo_train(torch, dm, cfg)
    mark("train")
    res["part_s"] = parts
    res["peak_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["seconds"] = time.perf_counter() - t_start
    gc.collect()
    torch.cuda.empty_cache()
    return res


def encdec_frames(torch, cfg, batch=8):
    """An encoder-decoder engine's frames (batch, T_enc, d) bf16: row i
    the data pipeline's audio-stub frames at step i, so every slot hears
    its own audio."""
    from repro_torch.data.pipeline import DataConfig, synthetic_batch

    return torch.cat([synthetic_batch(cfg, DataConfig(batch=1, seq=1),
                                      i, device="cuda")["frames"]
                      for i in range(batch)])


def tick_times(torch, eng, replays=20):
    """Device ms of one decode tick: the engine's one-tick window graph
    replayed ``replays`` times between CUDA events after its run (every
    row dead then: the same kernels at the same shapes, the rows' last
    positions), beside its bound, every byte a tick must read once at
    HBM bandwidth: the decoder's weights and the tied head (the
    cross-attention's K/V projections excepted), the cross-KV and the
    written self-KV."""
    win = next(w for (n, _), w in eng._graphs._windows.items() if n == 1)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        win.graph.replay()
    end.record()
    torch.cuda.synchronize()
    cfg, params = eng.cfg, eng.params
    dec = params["dec_blocks"]
    nbytes = sum(t.numel() * t.element_size() for k, t in _leaves(dec)
                 if k not in ("xattn.wk", "xattn.wv"))
    nbytes += params["embed"].numel() * 2
    nbytes += sum(t.numel() * t.element_size()
                  for t in eng.cache["cross"].values())
    written = int(eng.cache["pos"].sum())
    nbytes += written * cfg.n_layers * cfg.n_kv_heads * cfg.hd() * 2 * 2
    return {"replays_timed": replays,
            "device_ms_per_tick": start.elapsed_time(end) / replays,
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
            "bytes": nbytes, "launches_per_tick": win.launches}


def _leaves(tree, prefix=""):
    """(dotted key, leaf) of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def encdec_phase(torch, da, dm, ref):
    """The encoder-decoder (``ENCDEC``, whisper-small) at full width and
    depth on the card, random bf16 weights from seed 0, frames from the
    data pipeline's audio stub (``encdec_frames``), loaded alone and
    freed after: kernel 1 at its self-attention (``ENCDEC_CASES``) within
    ``ENCDEC_KERNEL_TOL`` of its plain version, with SDPA's times, and
    kernel 6's policy entry at its products (``ZOO_MATMULS``) bit for
    bit; the encoder's time to build a cache and the cross-KV's bytes;
    the zoo's ring traffic in bf16 and with ``kv_quant`` (inert: its
    self-KV is bf16, so the streams must be equal), prompts prefilled by
    the scanned prefill replayed from its captured step, the launch gates
    counting those replays, a tick's and a prefill step's device ms; one
    W = 8 window replayed and run eagerly, byte for byte, the cross-KV
    equal and unchanged, then an in-place restore whose rebuilt self-KV
    and cross-KV equal the written ones byte for byte, and the W = 8
    streams equal to W = 1's; the kernel route against the plain one;
    the dither policy (16-token prompts, 4 new tokens; logits bit for bit
    the plain route); a crashed run restored, streams equal to
    uninterrupted; 2 train steps with and without the policy, one step
    through kernel 6 bit for bit the plain one.  Peak memory."""
    import gc
    import json

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.serve import Engine

    cfg = get_config(ENCDEC)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    mark, parts = part_timer()
    res = {"phase": "zoo", "model": cfg.name, "family": cfg.family,
           "nvidia_smi": nvidia_smi(), "layers": cfg.n_layers,
           "encoder_layers": cfg.n_enc_layers,
           "encoder_tokens": cfg.n_enc_tokens, "d_model": cfg.d_model,
           "attention_layers": attn_layers(cfg),
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.hd()],
           "vocab_padded": cfg.vocab_padded(),
           "kernels": ring_kernel_checks(torch, cfg, da, ref, ENCDEC_CASES,
                                         quants=(False,), profiled=True),
           "matmuls": zoo_matmul_checks(torch, ENCDEC, dm, ref)}
    for row in res["kernels"]:
        assert row["max_abs_err"] <= ENCDEC_KERNEL_TOL, row
    t0 = time.perf_counter()
    params = registry.init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    res["init_s"] = time.perf_counter() - t0
    res["weights_gb"] = sum(t.numel() * t.element_size()
                            for t in tree.leaves(params)) / 1e9
    frames = encdec_frames(torch, cfg)
    build_ms = []
    for _ in range(2):                 # the first call warms the libraries
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = registry.make_cache(params, cfg, 8, 1024, frames,
                                    device="cuda")
        torch.cuda.synchronize()
        build_ms.append(1e3 * (time.perf_counter() - t0))
    res["cache_build_ms"] = build_ms
    res["cross_kv_gb"] = sum(t.numel() * t.element_size()
                             for t in cache["cross"].values()) / 1e9
    del cache
    mark("kernels_init_cache")
    runs = {}
    runs["ring_bf16"], ring_bf16, eng = zoo_serve(torch, cfg, params, "ring",
                                                  False, frames=frames)
    pf = eng._prefill
    runs["ring_bf16"].update(
        prefill_graph_replays=pf.replays,
        prefill_graph_steps_per_call=pf.replays / eng.stats["prefill_calls"],
        prefill_graph_capture_s=pf.capture_s)
    mark("ring_bf16")
    res["tick"] = tick_times(torch, eng)
    res["prefill_step"] = prefill_step_times(torch, eng, params)
    mark("tick_prefill_step")
    del eng, pf
    runs["ring_kv_quant_flag"], flagged, eng = zoo_serve(
        torch, cfg, params, "ring", True, frames=frames)
    assert eng.cache["layers"][0]["k"].dtype == torch.bfloat16
    assert flagged == ring_bf16, (cfg.name, "kv_quant flag not inert")
    runs["ring_kv_quant_flag"]["streams_equal_ring_bf16"] = True
    del eng
    res["runs"] = runs
    mark("ring_flag")
    eng = Engine(params, cfg, 8, 1024, device="cuda", decode_ticks=WINDOW,
                 frames=frames)
    for req in zoo_requests(cfg, "ring"):
        eng.submit(req)
    eng._admit_and_prefill()
    res["window_graph_vs_eager"] = graph_against_eager(torch, eng, cfg,
                                                       params)
    before = eng.written_kv()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.restore(json.loads(json.dumps(eng.snapshot())))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n, nbytes = eng.compare_written_kv(before, eng.written_kv())
    res["in_place_restore"] = {"tensors_equal": n, "bytes_equal": nbytes,
                               "seconds": seconds, **eng.last_restore}
    del before
    done = eng.run(1000)
    assert len(done) == ZOO_REQUESTS
    assert {r.rid: list(r.out) for r in done} == ring_bf16, (
        cfg.name, "W = 8 != W = 1")
    res["window_streams_equal_w1"] = True
    del eng
    mark("window_restore")
    res["parity"] = zoo_parity(torch, cfg, params, frames=frames)
    mark("parity")
    res["policy"] = zoo_policy(torch, cfg, params, frames=frames,
                               prompt_len=ZOO_POLICY_PARITY_LEN)
    mark("policy")
    res["fault"] = zoo_fault(torch, cfg, params, ring_bf16, frames=frames)
    mark("fault")
    res["serve_peak_memory_allocated_gb"] = (
        torch.cuda.max_memory_allocated() / 1e9)
    del params, frames
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res["train"] = zoo_train(torch, dm, cfg)
    mark("train")
    res["part_s"] = parts
    res["train_peak_memory_allocated_gb"] = (
        torch.cuda.max_memory_allocated() / 1e9)
    res["seconds"] = time.perf_counter() - t_start
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# sharded serving (ROADMAP Queue 1 item 10): the mesh block
# ---------------------------------------------------------------------------

MESH_MODEL = "qwen2_1_5b"        # full width: d 1,536, 12 / 2 heads of 128
MESH_LAYERS = 28                 # its full depth, on the (1, 1) mesh
# the meshes of ranks sharing the card run eagerly at tp 2 (28 layers: ≈ 35 s
# a mesh); their depth is cut as SmolLM's serve phases are — the widths,
# and so every library shape and the purity table, stay the model's
MESH_SHARED_LAYERS = 8
MESH_SHARED = ((1, 2), (2, 1), (2, 2))   # ranks sharing the one card (gloo)
MESH_GQA = "smollm_135m"         # 3 KV heads: replicated on a 2-way axis
# the margin gate: where the shard-purity probe finds a library op that sums
# in another order at a shard's shape, the sharded logits of every decision
# made on the single-device context (the stream equal so far) must lie
# within this of the single-device logits — the MoE zoo parity's bound;
# a head or row in the wrong place moves logits by whole units — and a
# stream may leave the single-device one only at a decision whose margin
# (greedy: the top-2 logit gap; sampled: the deciding scores' gap, in logit
# units) is below twice the error measured there
MESH_LOGIT_CAP = 2.0 ** 0
MESH_TOP = 64         # logits of a decision the ranks send back: its top 64
# the purity probe's prefill rows: every length bucket of the zoo's ring
# traffic (prompts of 32–256 tokens)
MESH_PREFILL_ROWS = (32, 64, 128, 256)


def mesh_cfg(name, layers=None):
    from repro_torch.configs import get_config

    cfg = get_config(name)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def mesh_runs(torch, cfg, params, mesh, cases):
    """``zoo_serve`` of each (layout, kv_quant) in ``cases`` on ``mesh``
    (paged: the ring traffic, prefix cache off), with this process's
    all-gathers counted, in decode windows apart: each line gains the
    gathers and bytes of a decode tick (head all-gathers over 'model',
    row gathers over 'data') and of the whole run (prefill calls
    included), the decode ms a tick (the host time of windows over
    ticks), the engine's window mode and its local shapes."""
    from repro_torch.dist import ctx
    from repro_torch.serve import engine as engine_mod

    def snap():
        return {k: dict(v) for k, v in ctx.GATHERS.items()}

    def delta(a, b):
        return {k: {f: b[k][f] - a[k][f] for f in ("calls", "bytes")}
                for k in a}

    decode = {}
    original = engine_mod.Engine._decode_tick

    def counted(self):
        before = snap()
        original(self)
        for k, v in delta(before, snap()).items():
            for f, n in v.items():
                decode[k][f] += n

    out = {}
    engine_mod.Engine._decode_tick = counted
    try:
        for layout, kv_quant in cases:
            kw = dict(traffic="ring", prefix_cache=False) \
                if layout == "paged" else {}
            decode.update({k: {"calls": 0, "bytes": 0} for k in ctx.GATHERS})
            before = snap()
            line, streams, eng = zoo_serve(torch, cfg, params, layout,
                                           kv_quant, mesh=mesh, **kw)
            ticks = max(1, line["decode_ticks"])
            whole = delta(before, snap())
            line.update(
                window_mode=eng.window_mode, heads_sharded=eng.heads_sharded,
                eager_windows=eng.stats["eager_windows"],
                local_heads=[eng._cfg_local.n_kv_heads,
                             eng._cfg_local.n_heads // max(
                                 1, eng._cfg_local.n_kv_heads),
                             eng._cfg_local.hd()],
                local_rows=eng._rows,
                local_kv_shape=list(eng.cache["layers"][0]["k"].shape),
                gathers_run=whole,
                gathers_decode={k: dict(v) for k, v in decode.items()},
                head_gathers_a_tick=decode["heads"]["calls"] / ticks,
                row_gathers_a_tick=decode["rows"]["calls"] / ticks,
                gathered_bytes_a_tick=(decode["heads"]["bytes"]
                                       + decode["rows"]["bytes"]) / ticks,
                decode_ms_a_tick=1e3 * eng.stats["decode_s"] / ticks)
            out[f"{layout}_{'int8' if kv_quant else 'bf16'}"] = (line,
                                                                 streams)
            del eng
    finally:
        engine_mod.Engine._decode_tick = original
    return out


def mesh_codes(torch, cfg, mesh_shape, coord, seed=5):
    """This rank's int8 KV codes and scales for its heads against the
    single-device quantiser's for the same global heads, given the same
    K/V (a (8, 1, n_kv, hd) draw from ``seed``, positions 0..7 plus
    offsets): byte for byte.  Returns the bytes compared."""
    from repro_torch.dist import ctx
    from repro_torch.dist.sharding import serve_heads_shardable
    from repro_torch.models import transformer

    gen = torch.Generator(device="cuda").manual_seed(seed)
    nkv, hd = cfg.n_kv_heads, cfg.hd()
    kv = torch.randn((8, 1, nkv, hd), generator=gen, device="cuda")
    kv = kv.to(torch.bfloat16)
    ctr = (torch.arange(8, device="cuda") * 1000 + 37).reshape(8, 1, 1, 1)
    want, wscale = transformer._kv_q8(
        kv, ctr, transformer._kv_elem_idx(nkv, hd, "cuda"), 101)
    tp = mesh_shape[1]
    split = serve_heads_shardable(cfg, tp)
    n = nkv // tp if split else nkv
    h0 = coord["model"] * n if split else 0
    with ctx.serve_shard_scope(head0=h0, heads_sharded=split):
        got, gscale = transformer._kv_q8(
            kv[:, :, h0:h0 + n], ctr,
            transformer._kv_elem_idx(n, hd, "cuda"), 101)
    torch.cuda.synchronize()
    assert torch.equal(got, want[:, :, h0:h0 + n]), (mesh_shape, coord)
    assert torch.equal(gscale, wscale[:, :, h0:h0 + n]), (mesh_shape, coord)
    return got.numel() + 4 * gscale.numel()


def mesh_rank(rank, world, store, q, plans):
    """One rank of meshes whose ranks share the card (spawned; prints
    nothing: its result goes back on ``q``): gloo over a file store, every
    rank on ``cuda:0``; for each (shape, jobs, record) of ``plans`` in
    turn, on its own mesh over the same processes, and for each (model,
    layers, cases) of ``jobs`` in turn, the model's seed-0 weights,
    ``mesh_runs`` of ``cases`` and ``mesh_codes``.  Results by shape."""
    import traceback

    try:
        import torch
        import torch.distributed as dist

        from repro_torch.dist import ctx
        from repro_torch.launch.mesh import make_serve_mesh
        from repro_torch.models import registry

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
        res = {}
        for shape, jobs, record in plans:
            mesh = make_serve_mesh(*shape, device="cuda")
            coord = ctx.mesh_coordinate(mesh)
            out = res[shape] = {"coord": coord}
            for model, layers, cases in jobs:
                cfg = mesh_cfg(model, layers)
                params = registry.init_model(cfg, seed=0, device="cuda")
                out[model] = {"runs": mesh_runs(torch, cfg, params, mesh,
                                                cases),
                              "codes_bytes": mesh_codes(torch, cfg, shape,
                                                        coord)}
                if record and model == MESH_MODEL:
                    # the sharded decisions, eagerly, for the margin gate
                    out[model]["decisions"] = {
                        f"{lay}_{'int8' if q8 else 'bf16'}":
                            record_decisions(torch, cfg, params, lay, q8,
                                             mesh)
                        for lay, q8 in cases}
                del params
                torch.cuda.empty_cache()
        q.put((rank, res))
        dist.destroy_process_group()
    except BaseException:
        q.put((rank, {"error": traceback.format_exc()}))


def record_decisions(torch, cfg, params, layout, kv_quant, mesh=None):
    """Every sampling decision of an engine (this rank's rows on a mesh) on
    the zoo's ring traffic, eagerly (a replayed window is bit for bit its
    eager window: the graph phase's gate), by request and token: its
    margin in logit units (greedy: the top-2 logit gap; sampled: the gap
    of the deciding scores — logits / T + the sampler's Gumbel noise over
    the top-k set — times T), its ``MESH_TOP`` largest logits (indices,
    values) and, on one device, the whole logit row (on the card).
    Returns ({rid: [decision, ...]}, streams)."""
    import repro_torch.serve.engine as engine_mod
    from repro_torch.core import rounding
    from repro_torch.serve import Engine

    out = {}
    original = engine_mod.sample_tokens
    call = {"lens": None}      # the lengths of the prefill call just made

    def record(logits, temps, topks, seeds, counters):
        # a prefill call decides its group's rows (length > 0) only; a
        # decode tick every occupied row
        lens, call["lens"] = call["lens"], None
        lf = logits.float()
        for b, s in enumerate(eng.slots[eng._lo:eng._lo + eng._rows]):
            if s is None or (lens is not None and int(lens[b]) == 0):
                continue
            row = lf[b]
            top = torch.topk(row, MESH_TOP)
            d = {"temp": float(temps[b]), "k": int(topks[b]),
                 "seed": int(seeds[b]), "counter": int(counters[b]),
                 "idx": top.indices.tolist(), "vals": top.values.tolist(),
                 "row": row.clone() if mesh is None else None}
            if mesh is None:
                d["margin"] = decision_margin(torch, rounding, d, 0.0)
            out.setdefault(s.rid, []).append(d)
        return original(logits, temps, topks, seeds, counters)

    kw = dict(block_size=64, prefix_cache=False) if layout == "paged" else {}
    eng = Engine(params, cfg, 8, 1024, kv_quant=kv_quant, kv_layout=layout,
                 device="cuda", mesh=mesh, **kw)
    eng._graphs = None                   # eager: the sampler sees its rows
    for name in ("_prefill", "_prefill_paged"):
        fn = getattr(eng, name, None)
        if fn is not None:
            def seen(params, toks, lens, *a, _fn=fn, **kw):
                call["lens"] = lens
                return _fn(params, toks, lens, *a, **kw)
            setattr(eng, name, seen)
    engine_mod.sample_tokens = record
    try:
        for req in zoo_requests(cfg, "ring"):
            eng.submit(req)
        done = eng.run(10_000)
    finally:
        engine_mod.sample_tokens = original
    return out, {r.rid: list(r.out) for r in done}


def decision_margin(torch, rounding, d, tol):
    """A decision's margin in logit units, from its single-device logit
    row: greedy, the top-2 gap; sampled, the gap of the deciding scores
    (logits / T + the sampler's Gumbel noise) over the widest top-k set a
    logit error of ``tol`` allows (logits within 2 tol of the k-th
    largest), times T — ``tests/test_torch_serve._check_decision``'s."""
    row, temp, k = d["row"], d["temp"], d["k"]
    if temp <= 0:
        top = torch.topk(row, 2).values
        return float(top[0] - top[1])
    v = row.shape[0]
    thresh = torch.topk(row, k).values[-1] if 0 < k < v else -math.inf
    keep = row >= thresh - 2 * tol
    u = rounding.hash_uniform(d["seed"], torch.arange(v, device=row.device),
                              d["counter"])
    g = -torch.log(-torch.log(u + 1e-12) + 1e-12)
    sc = torch.where(keep, row / max(temp, 1e-6) + g,
                     torch.tensor(-1e30, device=row.device))
    best = torch.topk(sc, 2).values
    return float(best[0] - best[1]) * temp


def margin_gate(torch, got, want, single, sharded):
    """Stream equality where the margin clears, against a measured logit
    error.  ``single``: the single-device decisions; ``sharded``: the
    sharded run's (its top logits).  Every decision made on the
    single-device context — each token up to and including a request's
    first differing one — gives the sharded logits' largest distance from
    the single-device row at its top ``MESH_TOP`` tokens; the largest, E,
    must be at most ``MESH_LOGIT_CAP``, and a stream may leave the
    single-device one only at a decision whose single-device margin
    (``decision_margin`` at an error of E) is below 2 E.  Returns E and
    the requests that left (token, margin)."""
    err, left = 0.0, {}
    for rid, w in want.items():
        g = got[rid]
        j = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        for t in range(len(w) if j is None else j + 1):
            mine, theirs = sharded[rid][t], single[rid][t]
            vals = torch.tensor(mine["vals"], device=theirs["row"].device)
            idx = torch.tensor(mine["idx"], device=theirs["row"].device)
            err = max(err, float((vals - theirs["row"][idx]).abs().max()))
        if j is not None:
            left[rid] = {"token": j}
        else:
            assert len(g) == len(w), rid
    assert err <= MESH_LOGIT_CAP, (err, "sharded logits off the single "
                                        "device's by more than the cap")
    from repro_torch.core import rounding

    for rid, at in left.items():
        at["margin"] = decision_margin(torch, rounding, single[rid][
            at["token"]], err)
        assert at["margin"] < 2 * err, (
            f"request {rid} leaves the single-device stream at token "
            f"{at['token']}, whose decision clears twice the measured "
            f"logit error ({at['margin']:.4f} >= 2 x {err:.4f})")
    return err, left


def local_kernel_checks(torch, da, pda, ref):
    """Kernels 1 and 2 at the local shape of qwen2-1.5b's heads under a
    2-way 'model' axis — one KV head, group 6, head dim 128; 8 slot rows
    (the (1, 2) mesh's), a 1,024-slot ring (int8, kernel 1) and a
    2,048-token table of 64-token blocks (bf16, kernel 2): against the
    plain version (``check_kernel``), with cold times, SDPA's, and the
    bound."""
    gen = torch.Generator().manual_seed(11)
    heads = dict(nkv=1, group=6, hd=128)
    rows = []
    t = ring_inputs(gen, b=8, cap=1024, quant=True, pos_vals=LONG_POS,
                    **heads)
    _, res = check_kernel(torch, da.decode_attention,
                          ref.decode_attention_ref, t, 0,
                          dict(block=(da.KERNEL_BLOCK,),
                               split=da.SPLIT_TILES))
    res.update(cold_times(t, da.decode_attention, ref.decode_attention_ref,
                          lambda c: library_call(c, 0), (200, 5, 100)))
    bound_ms, bound_by = decode_bound(LONG_POS, b=8, cap=1024, quant=True,
                                      window=0, **heads)
    rows.append({"name": "decode_attention[int8]", "shape": {
        "B": 8, "cap": 1024, **heads}, "pos": LONG_POS, **res,
        "bound_ms": bound_ms, "bound_by": bound_by})
    t = pool_inputs(gen, b=8, nbmax=32, bs=64, quant=False,
                    pos_vals=LONG_POS, share=(5, 6), **heads)
    _, res = check_kernel(torch, pda.paged_decode_attention,
                          ref.paged_decode_attention_ref, t, 0,
                          dict(split=da.SPLIT_TILES))
    res.update(cold_times(t, pda.paged_decode_attention,
                          ref.paged_decode_attention_ref,
                          lambda c: paged_library_call(c, 0), (200, 2, 50)))
    bound_ms, bound_by = paged_bound(t, 0, quant=False)[:2]
    rows.append({"name": "paged_decode_attention[bf16]", "shape": {
        "B": 8, "bs": 64, "nbmax": 32, **heads}, "pos": LONG_POS, **res,
        "bound_ms": bound_ms, "bound_by": bound_by})
    return rows


def mesh_phase(torch, da, pda, ref):
    """Sharded serving (one ``mesh`` line per mesh, then a summary line).

    The model is qwen2-1.5b at full width and depth with seed-0 bf16
    weights, the zoo's ring traffic (8 requests, prompts 32–256, 32 new
    tokens, batch 8, ``max_len`` 1,024, half greedy, half sampled at T 0.8
    and top-k 40).  First the shard-purity table: every library op of a
    forward at each mesh's local shape against the same slice at the
    single-device shape (``transformer.shard_purity``, decode rows and the
    prefill rows of every length bucket of the traffic, the prefill
    attention's batched products included).  Then the single-device
    engine: ring bf16 and int8, paged bf16 (graph replays).

    1. The (1, 1) mesh through NCCL, world size 1, in this process: the
       three runs bit for bit the single-device streams, windows still
       graph replays.
    2. (1, 2), (2, 1), (2, 2) as ranks sharing the card (gloo; NCCL
       refuses two ranks on one GPU), spawned, at ``MESH_SHARED_LAYERS``
       = 8 of the 28 layers: ring int8 and paged bf16.
       Gates: every rank's host streams equal; the streams bit for bit the
       single-device ones where the purity table reads 0 for the mesh,
       else equal where the margin clears (``margin_gate``); kernels 1
       and 2 launched layers × ticks at (1, 6, 128) on the (·, 2) meshes;
       each rank's int8 codes byte for byte the single-device codes of its
       heads.  Reported: all-gathers and bytes a tick, wall ms a tick —
       ranks sharing one card, not a sharded rate.
    3. The GQA fallback at full width: smollm-135m (3 KV heads, 8 of 30
       layers as the serve phases) on (1, 2), in that mesh's spawn, keeps
       its heads replicated and serves bit for bit the single-device
       engine, graph replays.

    Kernels 1 and 2 at the local shape are checked and timed
    (``local_kernel_checks``).  Returns the summary line."""
    import gc
    import tempfile

    import torch.distributed as dist

    from repro_torch.dist import ctx
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.models import registry, transformer

    t_start = time.perf_counter()
    cfg = mesh_cfg(MESH_MODEL, MESH_LAYERS)
    params = registry.init_model(cfg, seed=0, device="cuda")
    purity = {}
    for dp, tp in ((1, 1),) + MESH_SHARED:
        purity[f"{dp}x{tp}"] = {
            "decode": transformer.shard_purity(params, cfg, 8, dp, tp),
            **{f"prefill_{n}": transformer.shard_purity(params, cfg, 8, dp,
                                                        tp, rows=n)
               for n in MESH_PREFILL_ROWS}}
    pure = {k: not any(n for part in v.values() for n in part.values())
            for k, v in purity.items()}
    cases = (("ring", False), ("ring", True), ("paged", False))
    single = mesh_runs(torch, cfg, params, None, cases)
    want = {k: s for k, (_, s) in single.items()}
    shared_cases = (("ring", True), ("paged", False))

    # 1 — (1, 1) through NCCL, world size 1
    store = tempfile.mktemp(prefix="mesh_store_", dir=str(ROOT / "build"))
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        runs = mesh_runs(torch, cfg, params, make_serve_mesh(1, 1), cases)
    finally:
        dist.destroy_process_group()
    for key, (line, streams) in runs.items():
        assert streams == want[key], ("(1, 1)", key)
        assert line["window_mode"] == "graph" and line["graph_replays"] > 0
        line["streams_equal_single_device_bitwise"] = True
    emit({"phase": "mesh", "mesh": [1, 1], "backend": "nccl",
          "world_size": 1, "purity": purity["1x1"],
          "runs": {k: line for k, (line, _) in runs.items()}})
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # 2 — ranks sharing the card, at MESH_SHARED_LAYERS: the single-device
    # streams at that depth, and its decisions where a probe differs
    for name in pure:
        emit({"phase": "mesh", "purity_table": name, "purity": purity[name],
              "gate": "bitwise" if pure[name] else "margin"})
    scfg = mesh_cfg(MESH_MODEL, MESH_SHARED_LAYERS)
    params = registry.init_model(scfg, seed=0, device="cuda")
    swant = {k: s for k, (_, s) in mesh_runs(torch, scfg, params, None,
                                             shared_cases).items()}
    sdec = {}                   # the single-device decisions
    if not all(pure[f"{d}x{m}"] for d, m in MESH_SHARED):
        for layout, kv_quant in shared_cases:
            key = f"{layout}_{'int8' if kv_quant else 'bf16'}"
            sdec[key], streams = record_decisions(torch, scfg, params,
                                                  layout, kv_quant)
            assert streams == swant[key], ("eager recording run", key)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # the GQA fallback's single-device streams, for its run in the (1, 2)
    # spawn: smollm-135m at the serve phases' depth
    gcfg = mesh_cfg(MESH_GQA, SMOLLM_LAYERS)
    gparams = registry.init_model(gcfg, seed=0, device="cuda")
    gwant = mesh_runs(torch, gcfg, gparams, None, (("ring", True),))
    del gparams
    gc.collect()
    torch.cuda.empty_cache()
    # the two-rank meshes in one spawn, the four-rank one in another
    plans = {}
    for shape in MESH_SHARED:
        jobs = [(MESH_MODEL, MESH_SHARED_LAYERS, shared_cases)]
        if shape == (1, 2):
            jobs.append((MESH_GQA, SMOLLM_LAYERS, (("ring", True),)))
        plans.setdefault(shape[0] * shape[1], []).append(
            (shape, jobs, not pure[f"{shape[0]}x{shape[1]}"]))
    spawned, spawn_s = {}, {}
    for world, plan in plans.items():
        t0 = time.perf_counter()
        spawned[world] = spawn_ranks(world, mesh_rank, (plan,))
        spawn_s[world] = time.perf_counter() - t0
    shared, gqa = {}, None
    for shape in MESH_SHARED:
        name = f"{shape[0]}x{shape[1]}"
        world = shape[0] * shape[1]
        out = [r[shape] for r in spawned[world]]
        ranks = [r[MESH_MODEL] for r in out]
        if shape == (1, 2):
            gqa = [r[MESH_GQA] for r in out]
        line = {"phase": "mesh", "mesh": list(shape), "backend": "gloo",
                "shared_card": True, "world_size": len(ranks),
                "layers": scfg.n_layers,
                "purity": purity[name],
                "gate": "bitwise" if pure[name] else "margin",
                "spawn_seconds": spawn_s[world],
                "spawn_shapes": [list(p[0]) for p in plans[world]],
                "runs": {}}
        for key in ("ring_int8", "paged_bf16"):
            lines = [r["runs"][key][0] for r in ranks]
            streams = [r["runs"][key][1] for r in ranks]
            assert all(s == streams[0] for s in streams), (shape, key)
            err, left = None, {}
            if pure[name]:
                assert streams[0] == swant[key], (shape, key)
            else:
                # the sharded decisions: each data shard's model rank 0's
                sharded = {}
                for r, o in zip(ranks, out):
                    if o["coord"]["model"] == 0:
                        decisions, dstreams = r["decisions"][key]
                        assert dstreams == streams[0], (shape, key, "eager")
                        sharded.update(decisions)
                err, left = margin_gate(torch, streams[0], swant[key],
                                        sdec[key], sharded)
            first = lines[0]
            if shape[1] > 1:
                assert first["heads_sharded"] and first["local_heads"] == [
                    1, 6, 128], first["local_heads"]
                assert first["window_mode"] == "eager"
            else:
                assert first["window_mode"] == "graph"
            kernel = ("paged_decode_attention" if key.startswith("paged")
                      else "decode_attention")
            # every rank's run held ``launch_gates`` (zoo_serve): the
            # kernel launched layers × ticks, by graph replays or eagerly
            assert all(ln[f"{kernel}_launches"] >= scfg.n_layers
                       * ln["decode_ticks"] > 0 for ln in lines), lines
            line["runs"][key] = {
                **{k: first[k] for k in (
                    "decode_ticks", "windows", "prefill_calls",
                    "graph_replays", "window_mode", "heads_sharded",
                    "local_heads", "local_rows", "local_kv_shape",
                    f"{kernel}_launches", "eager_windows",
                    "head_gathers_a_tick", "row_gathers_a_tick",
                    "gathered_bytes_a_tick", "gathers_run",
                    "decode_ms_a_tick", "wall_s", "decode_tok_s",
                    "prefill_tok_s")},
                "rank_streams_equal": True,
                "streams_equal_single_device_bitwise":
                    streams[0] == swant[key],
                "measured_logit_error": err,
                "left_at_near_ties": left,
                "decode_ms_a_tick_by_rank": [ln["decode_ms_a_tick"]
                                             for ln in lines]}
        line["int8_codes_bytes_equal"] = [r["codes_bytes"] for r in ranks]
        line["note"] = ("ranks sharing one card: times are not a sharded "
                        "rate; gathers a tick count decode windows only")
        shared[name] = line
        emit(line)

    # 3 — the GQA fallback at full width (run in the (1, 2) spawn)
    for r in gqa:
        line, streams = r["runs"]["ring_int8"]
        assert streams == gwant["ring_int8"][1], "GQA fallback"
        assert not line["heads_sharded"] and line["local_heads"][0] == 3
        assert line["window_mode"] == "graph"
        assert line["gathers_run"]["heads"]["calls"] == 0
    emit({"phase": "mesh", "mesh": [1, 2], "backend": "gloo",
          "shared_card": True, "model": gcfg.name, "layers": gcfg.n_layers,
          "gqa_fallback": True, "heads_sharded": False,
          "streams_equal_single_device_bitwise": True,
          "int8_codes_bytes_equal": [r["codes_bytes"] for r in gqa],
          "runs": {"ring_int8": {k: gqa[0]["runs"]["ring_int8"][0][k]
                                 for k in ("decode_ticks", "graph_replays",
                                           "window_mode", "local_heads",
                                           "decode_attention_launches",
                                           "gathers_run")}}})
    kernels = local_kernel_checks(torch, da, pda, ref)
    return {"phase": "mesh", "summary": True, "model": cfg.name,
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.hd()],
            "vocab": cfg.vocab_size, "single_device": {
                k: {f: line[f] for f in ("decode_ticks", "graph_replays",
                                         "decode_tok_s", "prefill_tok_s",
                                         "wall_s", "decode_ms_a_tick")}
                for k, (line, _) in single.items()},
            "gates": {k: v["gate"] for k, v in shared.items()},
            "local_kernels": kernels,
            "launches_1x2": {k: v for k, v in (
                ("decode_attention[int8]", shared["1x2"]["runs"][
                    "ring_int8"]["decode_attention_launches"]),
                ("paged_decode_attention[bf16]", shared["1x2"]["runs"][
                    "paged_bf16"]["paged_decode_attention_launches"]))},
            "seconds": time.perf_counter() - t_start}


# ------------------------------------------------ the training mesh (10b)

TRAIN_MESH_LAYERS = 28           # qwen2-1.5b's depth, on the (1, 1) mesh
TRAIN_MESH_FULL_STEPS = 3
# the meshes of ranks sharing the card, at the mesh block's cut depth:
# four ranks each hold their blocks of the 8-layer state (≈ 8 GB a rank)
TRAIN_MESH_SHARED = ((2, 2), (2, 1), (1, 2))
TRAIN_MESH_STEPS = 2
TRAIN_MESH_LR = 1e-3
TRAIN_MESH_SEQ_SPLIT = "smollm_135m"     # 9 heads: the sequence split at tp 2
TRAIN_MESH_MOE = "granite_moe_1b_a400m"
TRAIN_MESH_CKPT = ("smollm_135m", 2)     # the elastic checkpoint's model
# tensor-parallel training of the recurrent and encoder-decoder families
# (ROADMAP item 10c) at (1, 2), full width: model → (layers, one step
# under the dither policy through kernel 6's sharded entry?).  mamba2 at
# the zoo's 16 of 48 layers, recurrentgemma at one (rglru, rglru, attn)
# period of 38 layers (2.54 B parameters, most of them its untied 256,000
# × 4,096 embedding and head), whisper at its full 12 + 12
TRAIN_MESH_TP = {"mamba2_370m": (16, True), "recurrentgemma_9b": (3, False),
                 "whisper_small": (12, True)}
# tests/test_torch_train.py's step-1 loss tolerances (no policy, policy)
TRAIN_MESH_LOSS_TOL = {False: 2.0 ** -10, True: 2.0 ** -6}
# the item-10c families' step-1 loss without a policy, against one
# device's: a row-parallel product's two K blocks are each rounded to
# bf16 before their sum (``policy.dense``, as the reference's GSPMD dot),
# which one device does not do; through mamba2's 16 ``out_proj`` products
# alone that moved its loss by 1.18e-3 on the H100, over 2⁻¹⁰ (PERF.md
# §6; recurrentgemma 1.85e-4, whisper 7.3e-5), so the gate is the next
# power of two above it
TRAIN_MESH_TP_LOSS_TOL = 2.0 ** -9
# sharded decode of the same families on the training layout (ROADMAP
# Queue 3, the dry run's decode cells), in the same (1, 2) spawn: one
# device prefills TP_DECODE_BATCH rows of a TP_DECODE_PROMPT-token prompt
# into a TP_DECODE_LEN ring, then TP_DECODE_TICKS greedy ticks run on one
# device and the same tokens on the mesh
TP_DECODE_BATCH = 8
TP_DECODE_PROMPT = 64
TP_DECODE_TICKS = 8
TP_DECODE_LEN = 128
# the mesh's logits (absolute) and state (each leaf's largest gap over its
# largest magnitude) against one device's, no policy: a row-parallel
# product's K blocks are rounded to bf16 before their sum on the mesh, as
# the reference's GSPMD decode rounds them, and cuBLAS sums a column
# block in another order than the whole; the next powers of two above
# the first card runs' largest gaps, mamba2's 0.299 and 0.089 after 8
# ticks of 16 layers (recurrentgemma 0.0625 / 0.0074, whisper 0.029 /
# 0.0099; PERF.md §6)
TP_DECODE_LOGIT_TOL = 2.0 ** -1
TP_DECODE_STATE_TOL = 2.0 ** -3
# tests/conftest.assert_argmax_margin's floor: greedy tokens must agree
# where the one-device margin clears it and twice the logit gap
ARGMAX_FLOOR = 1e-4
# kernel 1 at the decode's local heads on a 2-way 'model' axis: the
# family → (n_kv, group, head dim, window)
TP_DECODE_HEADS = {"recurrentgemma_9b": (1, 8, 256, 2048),
                   "whisper_small": (6, 1, 64, 0)}


def train_mesh_policy(backend):
    from repro_torch.numerics.policy import QuantPolicy

    return (None if backend is None else
            QuantPolicy(scheme="dither", bits=8, backend=backend))


def train_mesh_batch(cfg, step=0):
    """The global batch of every training-mesh run: 8 × 512 synthetic
    tokens (seed 0) on the card."""
    from repro_torch.data.pipeline import DataConfig, synthetic_batch

    return synthetic_batch(cfg, DataConfig(batch=TRAIN_BATCH,
                                           seq=TRAIN_SEQ, seed=0), step,
                           device="cuda")


def tensor_digest(torch, t):
    """A device-side digest of a tensor's bytes: the int64 sums of its
    16- or 32-bit words, plain and position-weighted (integer sums do not
    depend on their order)."""
    flat = t.detach().reshape(-1)
    word = torch.int16 if flat.element_size() == 2 else torch.int32
    w = flat.contiguous().view(word).to(torch.int64)
    pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
    return [int(w.sum()), int((w * pos).sum())]


def state_digests(torch, state):
    from repro_torch import tree

    return {k: [tensor_digest(torch, t) for t in tree.leaves(v)]
            for k, v in (("params", state["params"]),
                         ("m", state["opt"]["m"]), ("v", state["opt"]["v"]))}


def train_mesh_steps(torch, cfg, mesh, backend, steps, plain_check=False):
    """``steps`` sharded AdamW steps of ``cfg`` on this rank of ``mesh``
    from the seed-0 state, the global batch's rows of this data shard:
    losses, digests of the local params, m and v after every step, step
    ms (wall, ranks sharing the card), the sharded kernel's launches and
    the collectives of the last step, peak memory.  ``plain_check``: the
    first step again from the same state through kernel 6's plain version
    (``torch-ref``), its loss and digests bit for bit the kernel's."""
    import gc

    from repro_torch.dist import ctx
    from repro_torch.kernels import dither_matmul as dm
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import trainer

    sh = ctx.train_shard_of(mesh)
    coord = {"data": sh.data, "model": sh.model}
    batch = train_mesh_batch(cfg)
    rows = slice(sh.data * TRAIN_BATCH // sh.dp,
                 (sh.data + 1) * TRAIN_BATCH // sh.dp)
    local = {k: v[rows] for k, v in batch.items()}

    torch.cuda.reset_peak_memory_stats()
    # this rank's blocks of the seed-0 state, as the launcher makes them
    state = trainer.init_train_state(cfg, seed=0, device="cuda", mesh=mesh,
                                     coords=coord)
    gc.collect()
    torch.cuda.empty_cache()
    step = trainer.make_train_step(cfg, AdamW(lr=TRAIN_MESH_LR),
                                   policy=train_mesh_policy(backend),
                                   mesh=mesh)
    out = {"losses": [], "digests": [], "step_ms": []}
    dm.dither_matmul_sharded.launches = 0
    dm.dither_matmul_sharded.by_block = dict.fromkeys(
        dm.dither_matmul_sharded.by_block, 0)
    dm.dither_matmul_epilogue.launches = 0
    for i in range(steps):
        before = {k: dict(v) for k, v in ctx.COLLECTIVES.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, local)
        out["losses"].append(float(metrics["loss"]))
        torch.cuda.synchronize()
        out["step_ms"].append(1e3 * (time.perf_counter() - t0))
        out["digests"].append(state_digests(torch, state))
        out["collectives_a_step"] = {
            k: {f: ctx.COLLECTIVES[k][f] - before[k][f]
                for f in ("calls", "bytes")} for k in ctx.COLLECTIVES}
    out["kernel6_sharded_launches"] = dm.dither_matmul_sharded.launches
    out["kernel6_sharded_by_block"] = dict(dm.dither_matmul_sharded.by_block)
    out["kernel6_epilogue_launches"] = dm.dither_matmul_epilogue.launches
    out["peak_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del state
    gc.collect()
    torch.cuda.empty_cache()
    if plain_check:
        plain = trainer.make_train_step(
            cfg, AdamW(lr=TRAIN_MESH_LR),
            policy=train_mesh_policy("torch-ref"), mesh=mesh)
        state, metrics = plain(trainer.init_train_state(
            cfg, seed=0, device="cuda", mesh=mesh, coords=coord), local)
        out["plain_step1_equal"] = (
            float(metrics["loss"]) == out["losses"][0]
            and state_digests(torch, state) == out["digests"][0])
        del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_mesh_ckpt(torch, mesh, path, save):
    """The elastic checkpoint: ``save``: one step of smollm-135m (2
    layers) on this mesh, checkpointed (rank (0, 0) writes the gathered
    state); else restored onto this mesh from what (2, 2) wrote, each
    local leaf byte for byte its block of the checkpoint's global array."""
    import numpy as np

    from repro_torch import interop, tree
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.dist import ctx
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import trainer

    name, layers = TRAIN_MESH_CKPT
    cfg = mesh_cfg(name, layers)
    sh = ctx.train_shard_of(mesh)
    coord = {"data": sh.data, "model": sh.model}
    state = trainer.init_train_state(cfg, seed=0, device="cuda", mesh=mesh,
                                     coords=coord)
    ck = Checkpointer(path, mesh=mesh, cfg=cfg)
    if save:
        batch = train_mesh_batch(cfg)
        rows = slice(sh.data * TRAIN_BATCH // sh.dp,
                     (sh.data + 1) * TRAIN_BATCH // sh.dp)
        step = trainer.make_train_step(cfg, AdamW(lr=TRAIN_MESH_LR),
                                       mesh=mesh)
        state, _ = step(state, {k: v[rows] for k, v in batch.items()})
        t0 = time.perf_counter()
        ck.save(1, state)
        return {"saved": True, "save_s": time.perf_counter() - t0}
    places = interop.train_state_shardings(state, cfg, mesh, coord)
    t0 = time.perf_counter()
    got = ck.restore(1, state, places)
    restore_s = time.perf_counter() - t0
    with np.load(os.path.join(path, "step_00000001",
                              "arrays.npz")) as data:
        glob = [torch.from_numpy(np.array(data[f"leaf_{i}"]))
                for i in range(len(data.files))]
    equal = all(
        torch.equal(g.cpu().float(), p.local(w)) and g.dtype == like.dtype
        for g, w, p, like in zip(tree.leaves(got), glob, tree.leaves(places),
                                 tree.leaves(state)))
    return {"restored_equal": equal, "restore_s": restore_s,
            "bytes": sum(w.numel() * w.element_size() for w in glob)}


def _clone_tree(tree_):
    from repro_torch import tree

    return tree.tree_map(lambda t: t.clone(), tree_)


def train_mesh_decode(torch, cfg, mesh, with_policy):
    """Sharded decode of ``cfg`` on this rank of ``mesh`` (the training
    layout: ``interop.shard_train_params``, ``interop.shard_cache``,
    ``train_shard_scope``), against one device's.  One device prefills
    ``TP_DECODE_BATCH`` seeded prompts (whisper: seeded frames) with
    ``registry.apply_prefill`` and decodes ``TP_DECODE_TICKS`` greedy
    ticks from a copy of that cache; the mesh decodes the same tokens from
    its blocks of the same cache.  Returns, with no policy: each tick's
    largest logit gap, the largest relative state gap (each float leaf of
    the rank's cache against its block of one device's final cache, over
    that block's largest magnitude; integer leaves must be equal), every
    greedy token that differs with its one-device margin, digests of the
    logits and of every local cache leaf, tick ms on the mesh and on one
    device (ranks sharing the card), and the mesh run's kernel 1 launches
    by head shape and its collectives a tick.  ``with_policy``: the same
    ticks under the dither policy (``backend="auto"``) on both sides, the
    logits and the state compared bit for bit, and kernel 6's sharded
    launches, and the seconds the whole job took."""
    import gc

    from repro_torch import interop, tree
    from repro_torch.dist import ctx
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import dither_matmul as dm
    from repro_torch.models import registry

    sh = ctx.train_shard_of(mesh)
    coord = {"data": sh.data, "model": sh.model}
    b = TP_DECODE_BATCH
    rows = slice(sh.data * b // sh.dp, (sh.data + 1) * b // sh.dp)

    t_job = time.perf_counter()
    gc.collect()
    params = registry_init(cfg)
    gen = torch.Generator(device="cuda").manual_seed(7)
    prompt = torch.randint(0, cfg.vocab_size, (b, TP_DECODE_PROMPT),
                           generator=gen, device="cuda", dtype=torch.int32)
    frames = (torch.randn((b, cfg.n_enc_tokens, cfg.d_model), generator=gen,
                          device="cuda").bfloat16() if cfg.is_encdec
              else None)
    with torch.no_grad():
        last, start = registry.apply_prefill(
            params, cfg, prompt, torch.full((b,), TP_DECODE_PROMPT,
                                            dtype=torch.int32,
                                            device="cuda"),
            TP_DECODE_LEN, frames=frames)
    local_p = interop.shard_train_params(params, cfg, coord, mesh)

    def run(p, cache, tokens, policy=None, scope=None):
        """The ticks from ``cache``, under ``scope()`` where given (the
        rows of this data shard): logits a tick, the cache, ms a tick, the
        collectives of the first tick.  Greedy where ``tokens`` holds only
        the first token (each tick appends its argmax), else the tokens
        given."""
        out, coll = [], None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for t in range(TP_DECODE_TICKS):
                before = {k: dict(v) for k, v in ctx.COLLECTIVES.items()}
                tok = tokens[t] if scope is None else tokens[t][rows]
                with scope() if scope else contextlib.nullcontext():
                    logits, cache = registry.apply_decode(
                        p, cfg, tok, cache, policy=policy, counter=t + 1)
                out.append(logits)
                if len(tokens) == t + 1:
                    tokens.append(logits.argmax(-1).to(torch.int32))
                coll = coll or {
                    k: {f: ctx.COLLECTIVES[k][f] - before[k][f]
                        for f in ("calls", "bytes")}
                    for k in ctx.COLLECTIVES
                    if ctx.COLLECTIVES[k]["calls"] != before[k]["calls"]}
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / TP_DECODE_TICKS
        return out, cache, ms, coll

    def state_gap(mine, one):
        """Largest relative gap of the float leaves, integer leaves
        equal."""
        gap, ints = 0.0, True
        for a, c in zip(tree.leaves(mine), tree.leaves(
                interop.shard_cache(one, cfg, coord, mesh))):
            if a.is_floating_point():
                c = c.float()
                gap = max(gap, float((a.float() - c).abs().max()) /
                          max(float(c.abs().max()), 1e-30))
            else:
                ints = ints and torch.equal(a, c)
        return gap, ints

    tokens = [last.argmax(-1).to(torch.int32)]
    want, one, one_ms, _ = run(params, _clone_tree(start), tokens)
    da.decode_attention.launches = 0
    da.decode_attention.by_heads = {}
    got, cache, mesh_ms, coll = run(
        local_p, interop.shard_cache(start, cfg, coord, mesh), tokens,
        scope=lambda: ctx.train_shard_scope(mesh))
    out = {"kernel1_launches": da.decode_attention.launches,
           "kernel1_by_heads": {"x".join(map(str, k)): v for k, v in
                                da.decode_attention.by_heads.items()},
           "collectives_a_tick": coll, "tick_ms": mesh_ms,
           "one_device_tick_ms": one_ms,
           "logit_digests": [tensor_digest(torch, x) for x in got],
           "logit_gap_by_tick": [float((g - w[rows]).abs().max())
                                 for g, w in zip(got, want)],
           "logit_scale": max(float(w.abs().max()) for w in want),
           "greedy_flips": []}
    out["logit_gap"] = max(out["logit_gap_by_tick"])
    for t, (g, w) in enumerate(zip(got, want)):
        top = torch.topk(w[rows], 2, dim=-1).values
        margin = top[:, 0] - top[:, 1]
        for i in torch.nonzero(g.argmax(-1) != w[rows].argmax(-1)).flatten():
            out["greedy_flips"].append((t, int(i), float(margin[i])))
    out["state_gap"], out["int_leaves_equal"] = state_gap(cache, one)
    out["digests"] = [tensor_digest(torch, t) for t in tree.leaves(cache)]
    del cache, one
    if with_policy:
        policy = train_mesh_policy("auto")
        want, one, _, _ = run(params, _clone_tree(start), tokens,
                              policy)
        dm.dither_matmul_sharded.launches = 0
        dm.dither_matmul_sharded.by_block = dict.fromkeys(
            dm.dither_matmul_sharded.by_block, 0)
        dm.dither_matmul_epilogue.launches = 0
        got, cache, ms, _ = run(
            local_p, interop.shard_cache(start, cfg, coord, mesh), tokens,
            policy, lambda: ctx.train_shard_scope(mesh))
        gap, ints = state_gap(cache, one)
        out["policy"] = {
            "bitwise": all(torch.equal(g, w[rows]) for g, w in zip(got,
                                                                   want)),
            "logit_gap": max(float((g - w[rows]).abs().max())
                             for g, w in zip(got, want)),
            "state_bitwise": gap == 0.0 and ints, "state_gap": gap,
            "tick_ms": ms,
            "kernel6_sharded_launches": dm.dither_matmul_sharded.launches,
            "kernel6_sharded_by_block": dict(
                dm.dither_matmul_sharded.by_block),
            "kernel6_epilogue_launches": dm.dither_matmul_epilogue.launches,
            "logit_digests": [tensor_digest(torch, x) for x in got]}
        del one, cache
    del params, local_p, start
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_job
    return out


# the training ranks' allocators grow segments instead of caching fixed
# ones: four ranks each hold ≈ 11 GB of the card's 80 GB at once
TRAIN_MESH_ALLOC = "expandable_segments:True"


def train_mesh_rank(rank, world, store, q, jobs):
    """One rank of training meshes whose ranks share the card (spawned;
    prints nothing, results go back on ``q``): gloo over a file store,
    every rank on ``cuda:0``; each job in turn on its own ('data',
    'model') mesh over the same processes."""
    import traceback

    try:
        import torch
        import torch.distributed as dist

        from repro_torch.dist import ctx
        from repro_torch.launch.mesh import make_serve_mesh

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
        out = {}
        for job in jobs:
            kind, shape = job[0], job[1]
            mesh = make_serve_mesh(*shape, device="cuda")
            res = {"coord": ctx.mesh_coordinate(mesh)}
            if kind == "steps":
                _, _, model, layers, backend, steps, plain = job
                res.update(train_mesh_steps(torch, mesh_cfg(model, layers),
                                            mesh, backend, steps, plain))
            elif kind == "ckpt":
                res.update(train_mesh_ckpt(torch, mesh, job[2], job[3]))
            elif kind == "decode":
                _, _, model, layers, pol = job
                res.update(train_mesh_decode(torch, mesh_cfg(model, layers),
                                             mesh, pol))
            out[tuple(job[:2]) + tuple(str(j) for j in job[2:5])] = res
        q.put((rank, out))
        dist.destroy_process_group()
    except BaseException:
        q.put((rank, {"error": traceback.format_exc()}))


def replicas_equal(specs, shape, ranks, key):
    """After every step: the data replicas' params, m and v digests equal
    (ranks of one 'model' coordinate), and the 'model' ranks' replicated
    leaves' (``specs``: the training layout's spec of each leaf)."""
    runs = [r[key] for r in ranks]
    for s in range(len(runs[0]["digests"])):
        by_model = {}
        for r in runs:
            by_model.setdefault(r["coord"]["model"], []).append(
                r["digests"][s])
        for group in by_model.values():
            assert all(g == group[0] for g in group), (shape, key, s)
        for kind in ("params", "m", "v"):
            for i, spec in enumerate(specs):
                if "model" not in spec:
                    assert len({str(r["digests"][s][kind][i])
                                for r in runs}) == 1, (shape, key, s, kind)
    return True


def spawn_ranks(world, target, args, timeout=900, alloc_conf=None):
    """``target(rank, world, store, q, *args)`` on ``world`` spawned
    ranks, all on the one card (``alloc_conf``: their
    ``PYTORCH_CUDA_ALLOC_CONF``); returns their results in rank order
    (raises with a rank's traceback)."""
    import queue
    import tempfile

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = tempfile.mktemp(prefix="mesh_store_", dir=str(ROOT / "build"))
    procs = [ctx.Process(target=target, args=(r, world, store, q, *args))
             for r in range(world)]
    old = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    if alloc_conf is not None:
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    try:
        for p in procs:
            p.start()
    finally:
        if old is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = old
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < world:
            try:
                rank, res = q.get(timeout=5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in got]
                if (dead and q.empty()) or time.monotonic() > deadline:
                    raise RuntimeError(f"ranks {dead or '?'} of {world} "
                                       "gave no result") from None
                continue
            if "error" in res:
                raise RuntimeError(f"rank {rank} of {world}:\n"
                                   f"{res['error']}")
            got[rank] = res
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]


def partials_bound(m, k, n):
    """Least time for kernel 6's sharded entry in partials mode: the bf16
    operands read once and the int32 accumulator and code sums written
    once; its int8 tensor ops, the codes' INT32 ops and f32 ops (with the
    normalisation); no epilogue."""
    codes = m * k + k * n
    return least_time({
        "bytes": (2 * codes + 4 * (m * n + m + n)) / HBM_BYTES_PER_S,
        "int8 tensor ops": 2 * m * k * n / PEAK_OPS["int8"],
        "INT32 ops": QUANT_INT_OPS * codes / int32_ops_per_s()[0],
        "f32 ops": (QUANT_F32_OPS + NORM_F32_OPS) * codes / PEAK_F32})


def epilogue_bound(m, n):
    """Least time for kernel 6's epilogue over all-reduced partials: the
    int32 accumulator and code sums read once, the bf16 product written
    once; its f32 ops and the rescale per output."""
    return least_time({
        "bytes": (4 * (m * n + m + n) + 2 * m * n) / HBM_BYTES_PER_S,
        "f32 ops": (EPILOGUE_F32_OPS + 1) * m * n / PEAK_F32})


# kernel 6's sharded entry at the training meshes' local shapes: (kind of
# block, label or None for qwen2-1.5b's, global M, K, N).  qwen2-1.5b's
# ``wu`` as a data shard's rows and as a column block, ``wd`` as K halves;
# (ROADMAP item 10c, 8 × 512 tokens at tp 2) mamba2-370m's ``in_proj``
# column block and ``out_proj`` K halves, whisper-small's encoder QKV
# column block over 8 × 1,500 frames
SHARDED_CASES = (("rows", None, 4096, 1536, 8960),
                 ("columns", None, 4096, 1536, 8960),
                 ("k_block", None, 4096, 8960, 1536),
                 ("columns", "mamba2 in_proj", 4096, 1024, 4384),
                 ("k_block", "mamba2 out_proj", 4096, 2048, 1024),
                 ("columns", "whisper encoder QKV", 12000, 768, 768),
                 # the (1, 2) decode's policy tick: one row a slot
                 ("columns", "mamba2 in_proj decode", TP_DECODE_BATCH, 1024,
                  4384),
                 ("k_block", "mamba2 out_proj decode", TP_DECODE_BATCH, 2048,
                  1024),
                 ("columns", "whisper wq decode", TP_DECODE_BATCH, 768, 768),
                 ("k_block", "whisper wo decode", TP_DECODE_BATCH, 768, 768))


def sharded_kernel_checks(torch, dm, ref, cases=SHARDED_CASES):
    """Kernel 6's sharded entry at the training meshes' local shapes
    (``SHARDED_CASES``), one row a wrapper call of the kind the mesh
    launches: a data shard's half of the rows, a column block at N / 2,
    one K half in partials mode (the int32 accumulator and code sums of
    its K slice) and the epilogue over the two halves' summed partials
    (what the all-reduce over 'model' computes).  Each result bit for bit
    its plain version on the same inputs; the rows and columns blocks and
    the reassembled K blocks bit for bit the slice of the unsharded
    product.  Event ms (back-to-back calls), device ms
    (``torch.profiler``: everything the call launches), the plain
    version's ms, the bound, and ``torch.matmul``'s bf16 time on the same
    local operands (the epilogue: none)."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    kw = dict(bits=8, scheme="dither", counter=3, seed=6)

    def sharded(xs, w, ax, aw, block, partials=False):
        return (lambda: dm.dither_matmul_sharded(
            xs, w, ax, aw, block=block, partials=partials, **kw),
            lambda: ref.dither_matmul_scaled_ref(
                xs, w, aw, x_absmax=ax, block=block, partials=partials,
                **kw))

    def row(kind, label, call, plain, shape, glob, bound, lib, note=None):
        bound_ms, term = bound
        tag = kind if label is None else f"{kind}, {label}"
        name = (f"dither_matmul_sharded[{tag}]" if kind != "epilogue" else
                "dither_matmul_epilogue" + ("" if label is None
                                            else f"[{label}]"))
        return {
            "name": name, "block": kind, "model_shapes": label,
            "shape": shape, "global": glob,
            "max_abs_err": 0.0, "bitwise_plain": True,
            "bitwise_unsharded_slice": True,
            "ms": cuda_ms(call, 10), "device_ms": device_ms(torch, call, 5),
            "plain_ms": cuda_ms(plain, 2, warmup=1),
            "bound_ms": bound_ms, "bound_term": term,
            "bound_by": "bytes" if term == "bytes" else "operations",
            "library_ms": None if lib is None else cuda_ms(lib, 10),
            "library": None if lib is None else
            "torch.matmul bf16, the same local operands", "note": note}

    rows = []
    for kind, label, m, k, n in cases:
        x = (torch.randn((m, k), generator=gen, device="cuda")).bfloat16()
        w = (torch.randn((k, n), generator=gen, device="cuda")
             / math.sqrt(k)).bfloat16()
        ax, aw = ref.policy_absmax(x), ref.policy_absmax(w)
        full = dm.dither_matmul_scaled(x, w, aw, **kw)
        if kind != "k_block":
            xs, ws, block, want = (
                (x[:m // 2].contiguous(), w, ref.MatmulBlock(m, k, n, m0=0),
                 full[:m // 2]) if kind == "rows" else
                (x, w[:, :n // 2].contiguous(),
                 ref.MatmulBlock(m, k, n, n0=0), full[:, :n // 2]))
            call, plain = sharded(xs, ws, ax, aw, block)
            got = call()
            torch.cuda.synchronize()
            assert torch.equal(got, plain()), (kind, label)
            assert torch.equal(got, want), (kind, label)
            rows.append(row(kind, label, call, plain,
                            [xs.shape[0], k, ws.shape[1]], [m, k, n],
                            matmul_bound(xs.shape[0], k, ws.shape[1],
                                         policy=True),
                            lambda xs=xs, ws=ws: torch.matmul(xs, ws)))
            continue
        # K blocks: two halves' partials, summed, one epilogue
        halves = [(x[:, i * k // 2:(i + 1) * k // 2].contiguous(),
                   w[i * k // 2:(i + 1) * k // 2].contiguous(),
                   ref.MatmulBlock(m, k, n, k0=i * k // 2)) for i in range(2)]
        parts, calls = [], []
        for xs, ws, block in halves:
            call, plain = sharded(xs, ws, ax, aw, block, partials=True)
            got, want = call(), plain()
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (
                "k_block", label)
            parts.append(got)
            calls.append((call, plain))
        summed = [(parts[0][i] + parts[1][i]).contiguous() for i in range(3)]

        def epi(summed=summed, ax=ax, aw=aw, k=k):
            return dm.dither_matmul_epilogue(*summed, ax, aw, bits=8, k=k)

        def epi_plain(summed=summed, ax=ax, aw=aw, k=k):
            return ref.dither_matmul_scaled_epilogue_ref(*summed, ax, aw,
                                                         bits=8, k=k)
        got = epi()
        torch.cuda.synchronize()
        assert torch.equal(got, epi_plain()), ("epilogue", label)
        assert torch.equal(got, full), ("k blocks reassembled", label)
        xs, ws, _ = halves[0]
        rows.append(row("k_block", label, *calls[0], [m, k // 2, n],
                        [m, k, n], partials_bound(m, k // 2, n),
                        lambda xs=xs, ws=ws: torch.matmul(xs, ws),
                        "one K half's int32 partials (a rank at tp 2)"))
        rows.append(row("epilogue", label, epi, epi_plain, [m, n], [m, k, n],
                        epilogue_bound(m, n), None,
                        "over the two K halves' summed partials"))
        del x, w, full, halves, parts, summed
    return rows


def tp_decode_kernel_checks(torch, da, ref):
    """Kernel 1 at the (1, 2) decode's local heads (``TP_DECODE_HEADS``):
    ``TP_DECODE_BATCH`` rows of a ``TP_DECODE_LEN``-slot bf16 ring at the
    decode's positions (the prompt and its ticks), against the plain
    version (``check_kernel``), with cold times, SDPA's, and the bound."""
    gen = torch.Generator().manual_seed(13)
    pos = [TP_DECODE_PROMPT + t for t in range(TP_DECODE_TICKS)]
    rows = []
    for fam, (nkv, group, hd, window) in TP_DECODE_HEADS.items():
        heads = dict(nkv=nkv, group=group, hd=hd)
        dims = dict(b=TP_DECODE_BATCH, cap=TP_DECODE_LEN, **heads)
        t = ring_inputs(gen, quant=False, pos_vals=pos, **dims)
        _, res = check_kernel(torch, da.decode_attention,
                              ref.decode_attention_ref, t, window,
                              dict(block=(da.KERNEL_BLOCK,),
                                   split=da.SPLIT_TILES))
        res.update(cold_times(
            t, functools.partial(da.decode_attention, window=window),
            functools.partial(ref.decode_attention_ref, window=window),
            lambda c, w=window: library_call(c, w), (200, 5, 100)))
        bound_ms, bound_by = decode_bound(pos, quant=False, window=window,
                                          **dims)
        rows.append({"name": f"decode_attention[bf16, {fam} tp 2 local]",
                     "model": fam, "heads": "x".join(map(str, (nkv, group,
                                                               hd))),
                     "shape": {"B": TP_DECODE_BATCH, "cap": TP_DECODE_LEN,
                               **heads}, "window": window, "pos": pos,
                     **res, "bound_ms": bound_ms, "bound_by": bound_by})
    return rows


def train_full_depth(torch, cfg, mesh):
    """``TRAIN_MESH_FULL_STEPS`` AdamW steps of ``cfg`` (no policy) from
    the seed-0 state on the whole global batch, on one device
    (``mesh`` None) or on the (1, 1) mesh's path (the scope, the gradient
    bucket and the loss reduced over its one-rank 'data' group): losses,
    digests of params, m and v after every step, the 'data' reduces run,
    wall seconds and peak memory of this run alone (the state freed
    after)."""
    import gc

    from repro_torch import tree
    from repro_torch.dist import ctx
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import trainer

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_train_state(cfg, seed=0, device="cuda")
    step = trainer.make_train_step(cfg, AdamW(lr=TRAIN_MESH_LR), mesh=mesh)
    before = {k: ctx.COLLECTIVES[k]["calls"] for k in ("grads", "loss")}
    out = {"losses": [], "digests": [],
           "params": sum(t.numel() for t in tree.leaves(state["params"]))}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TRAIN_MESH_FULL_STEPS):
        state, metrics = step(state, train_mesh_batch(cfg, i))
        out["losses"].append(float(metrics["loss"]))
        out["digests"].append(state_digests(torch, state))
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    out["reduces"] = {k: ctx.COLLECTIVES[k]["calls"] - before[k]
                      for k in before}
    out["peak_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_mesh_phase(torch, dm, ref, dry=None):
    """The training mesh (ROADMAP Queue 1 item 10b): one summary line.

    1. Kernel 6's sharded entry at this block's local shapes
       (``sharded_kernel_checks``).
    2. qwen2-1.5b at full width and depth (28 layers) on the (1, 1) mesh
       through NCCL (``train_full_depth``: the mesh path, its gradient
       bucket and loss reduced over the one-rank 'data' group): 3 steps
       of 8 × 512, no policy; losses and params, m and v after every step
       bit for bit the same steps on one device.
    3. Ranks sharing the card (gloo), qwen2-1.5b at 8 layers, 2 steps, no
       policy and ``QuantPolicy(scheme="dither", bits=8, backend="auto")``:
       (2, 2) in a spawn of four ranks (and the elastic checkpoint's save),
       (2, 1) and (1, 2) in one spawn of two (two meshes over the same
       processes, and the checkpoint's restore at (2, 1), granite-moe at
       (2, 1) and smollm-135m's sequence split at (1, 2), each at 8
       layers).  Gates: every
       step, the data replicas' params, m and v bit for bit equal, and the
       'model' ranks' replicated leaves; step-1 loss within
       ``tests/test_torch_train.py``'s tolerance of the single-device
       step at the same depth; at (2, 2) one policy step through kernel
       6 bit for bit the same step through its plain version; kernel 6's
       sharded entry launched; the checkpoint restored at (2, 1) and
       (1, 1) byte for byte.  granite-moe's (2, 1) loss is the port's own
       step with two capacity groups (the mean of the halves' losses)
       bit for bit; smollm's (1, 2) loss within the tolerance of its
       single-device one.  Ranks sharing one card give no sharded rate.
    4. (ROADMAP item 10c) ``TRAIN_MESH_TP`` at (1, 2) in the two-rank
       spawn: 2 steps without a policy, and for mamba2 and whisper one
       dither step through kernel 6's sharded entry.  Gates: replicas
       and replicated leaves bit for bit after every step; the step-1
       loss against one device's, computed by the forward alone: within
       ``TRAIN_MESH_TP_LOSS_TOL`` without a policy (the mesh rounds a
       row-parallel product's K blocks to bf16 before their sum, one
       device does not), within the policy tolerance under it (the
       dither step's K blocks are exact int32 partials); launches of
       column blocks, K blocks and epilogues.  The kernel rows hold the
       entry bit for bit at these runs' shapes.
    4b. (ROADMAP Queue 3) the same families' sharded decode on the
       training layout, in the same spawn after each family's steps
       (``train_mesh_decode``): a one-device prefill of 8 × 64 tokens,
       then 8 greedy ticks on one device and the same tokens on the (1, 2)
       mesh.  Gates: the logits within ``TP_DECODE_LOGIT_TOL`` and each
       rank's state and KV within ``TP_DECODE_STATE_TOL`` (relative) of
       one device's (integer leaves equal), greedy tokens equal where the
       one-device margin clears the floor and twice the logit gap, the
       logits and the replicated cache leaves bit for bit equal on both
       ranks; kernel 1 launched at the local heads only
       (``TP_DECODE_HEADS``, attention layers × ticks); under the dither
       policy (mamba2, whisper: the same ticks) the logits and the state
       bit for bit one device's and kernel 6's column blocks, K halves and
       epilogues launched.  Kernel 1 at those heads is checked and timed
       (``tp_decode_kernel_checks``), kernel 6's sharded entry at the
       decode's shapes with the rest (``SHARDED_CASES``).
    5. The dry run against this block (``dryrun_checks``), its counts
       made in a spawned CPU process (``dry``: started by ``main`` before
       the zoo; else from the block's start); its (1, 2) decode cells'
       collectives against 4b's."""
    import gc
    import tempfile

    import torch.distributed as dist

    from repro_torch import interop, tree
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import MeshShape
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.models import registry
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import trainer

    t_start = time.perf_counter()
    scfg = mesh_cfg(MESH_MODEL, MESH_SHARED_LAYERS)
    fcfg = mesh_cfg(MESH_MODEL, TRAIN_MESH_LAYERS)
    # the dry run's counts, made on the CPU while the card works (step 5):
    # ``dry``, started before the zoo by ``main``, or from here
    started = dry or start_dryrun(scfg, fcfg)
    res = {"phase": "train_mesh", "model": MESH_MODEL,
           "nvidia_smi": nvidia_smi(), "batch": [TRAIN_BATCH, TRAIN_SEQ]}
    from repro_torch.kernels import decode_attention as da

    res["kernels"] = sharded_kernel_checks(torch, dm, ref)
    t0 = time.perf_counter()
    res["decode_kernels"] = tp_decode_kernel_checks(torch, da, ref)
    res["decode_kernels_s"] = time.perf_counter() - t0
    emit({"phase": "train_mesh", "kernels": res["kernels"],
          "decode_kernels": res["decode_kernels"]})

    # single-device baselines at the shared meshes' depth
    base = {}
    for backend in (None, "auto"):
        state = trainer.init_train_state(scfg, seed=0, device="cuda")
        step = trainer.make_train_step(scfg, AdamW(lr=TRAIN_MESH_LR),
                                       policy=train_mesh_policy(backend))
        base[backend] = float(step(state, train_mesh_batch(scfg))[1]["loss"])
        specs = {s: sharding.spec_leaves(sharding.train_param_specs(
            state["params"], scfg, MeshShape(("data", "model"), s)))
            for s in TRAIN_MESH_SHARED}
        del state, step
    qcfg = mesh_cfg(TRAIN_MESH_SEQ_SPLIT, SMOLLM_LAYERS)
    state = trainer.init_train_state(qcfg, seed=0, device="cuda")
    base["seq"] = float(trainer.make_train_step(qcfg, AdamW(
        lr=TRAIN_MESH_LR))(state, train_mesh_batch(qcfg))[1]["loss"])
    del state
    mcfg = mesh_cfg(TRAIN_MESH_MOE, MESH_SHARED_LAYERS)
    params = registry_init(mcfg)
    batch = train_mesh_batch(mcfg)
    with torch.no_grad():
        halves = [float(trainer.loss_fn(params, mcfg, {
            k: v[i * TRAIN_BATCH // 2:(i + 1) * TRAIN_BATCH // 2]
            for k, v in batch.items()}, None, 0)) for i in range(2)]
    base["moe_groups"] = float(
        (torch.tensor(halves[0]) + torch.tensor(halves[1])) / 2)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()

    # 2 — the (1, 1) mesh through NCCL at full depth, against one device
    store = tempfile.mktemp(prefix="mesh_store_", dir=str(ROOT / "build"))
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        single = train_full_depth(torch, fcfg, None)
        meshed = train_full_depth(torch, fcfg, make_serve_mesh(1, 1))
    finally:
        dist.destroy_process_group()
    assert meshed["losses"] == single["losses"], (meshed, single)
    assert meshed["digests"] == single["digests"], "(1, 1) mesh != one device"
    assert meshed["reduces"] == {"grads": TRAIN_MESH_FULL_STEPS,
                                 "loss": TRAIN_MESH_FULL_STEPS}, meshed
    one = {"mesh": [1, 1], "backend": "nccl", "layers": fcfg.n_layers,
           "steps": TRAIN_MESH_FULL_STEPS, "losses": meshed["losses"],
           "bitwise_single_device": True, "nccl_reduces": meshed["reduces"],
           "params": meshed["params"], "run_s": meshed["run_s"],
           "single_run_s": single["run_s"],
           "peak_memory_allocated_gb": meshed["peak_memory_allocated_gb"],
           "single_peak_memory_allocated_gb":
               single["peak_memory_allocated_gb"]}
    emit({"phase": "train_mesh", **one})

    # 3 — ranks sharing the card
    ckpt = tempfile.mkdtemp(prefix="train_mesh_ckpt_", dir=str(ROOT / "build"))
    steps = [("steps", (2, 2), MESH_MODEL, MESH_SHARED_LAYERS, None,
              TRAIN_MESH_STEPS, False),
             ("steps", (2, 2), MESH_MODEL, MESH_SHARED_LAYERS, "auto",
              TRAIN_MESH_STEPS, True),
             ("ckpt", (2, 2), ckpt, True)]
    emit({"phase": "train_mesh", "before": "four-rank spawn",
          "at": time.time(), "device_memory": device_memory(torch)})
    t0 = time.perf_counter()
    four = spawn_ranks(4, train_mesh_rank, (steps,),
                       alloc_conf=TRAIN_MESH_ALLOC)
    four_s = time.perf_counter() - t0
    pairs = [("ckpt", (2, 1), ckpt, False)]
    for shape in ((2, 1), (1, 2)):
        for backend in (None, "auto"):
            pairs.append(("steps", shape, MESH_MODEL, MESH_SHARED_LAYERS,
                          backend, TRAIN_MESH_STEPS, False))
    pairs.append(("steps", (2, 1), TRAIN_MESH_MOE, MESH_SHARED_LAYERS, None,
                  1, False))
    pairs.append(("steps", (1, 2), TRAIN_MESH_SEQ_SPLIT, SMOLLM_LAYERS, None,
                  1, False))
    for fam, (depth, pol) in TRAIN_MESH_TP.items():
        pairs.append(("steps", (1, 2), fam, depth, None, TRAIN_MESH_STEPS,
                      False))
        if pol:
            pairs.append(("steps", (1, 2), fam, depth, "auto", 1, False))
        pairs.append(("decode", (1, 2), fam, depth, pol))
    emit({"phase": "train_mesh", "before": "two-rank spawn",
          "at": time.time(), "device_memory": device_memory(torch)})
    t0 = time.perf_counter()
    two = spawn_ranks(2, train_mesh_rank, (pairs,),
                      alloc_conf=TRAIN_MESH_ALLOC)
    two_s = time.perf_counter() - t0
    # the 10c families' one-device step-1 loss: the loss of the seed-0
    # params (the forward alone: recurrentgemma's whole step, ≈ 59 GB,
    # would not fit beside the card's other tenants); after the spawns,
    # so that the ranks start beside a main process as the parent's did
    tp_specs = {}
    for fam, (depth, pol) in TRAIN_MESH_TP.items():
        tcfg = mesh_cfg(fam, depth)
        params = registry_init(tcfg)
        batch = train_mesh_batch(tcfg)
        with torch.no_grad():
            base[fam, None] = float(trainer.loss_fn(params, tcfg, batch,
                                                    None, 0))
            if pol:
                base[fam, "auto"] = float(trainer.loss_fn(
                    params, tcfg, batch, train_mesh_policy("auto"), 0))
        del params, batch
        gc.collect()
        torch.cuda.empty_cache()
        tp_specs[fam] = sharding.spec_leaves(sharding.train_param_specs(
            registry.init_model(tcfg, device="meta"), tcfg,
            MeshShape(("data", "model"), (1, 2))))
    ranks_of = {(2, 2): four, (2, 1): two, (1, 2): two}
    meshes = {}
    for shape in TRAIN_MESH_SHARED:
        line = {"mesh": list(shape), "backend": "gloo", "shared_card": True,
                "layers": MESH_SHARED_LAYERS, "runs": {}}
        for backend in (None, "auto"):
            key = ("steps", shape, MESH_MODEL, str(MESH_SHARED_LAYERS),
                   str(backend))
            ranks = ranks_of[shape]
            replicas_equal(specs[shape], shape, ranks, key)
            r0 = ranks[0][key]
            losses = [r[key]["losses"] for r in ranks]
            assert all(x == losses[0] for x in losses), (shape, backend)
            tol = TRAIN_MESH_LOSS_TOL[backend is not None]
            assert abs(r0["losses"][0] - base[backend]) <= tol, (
                shape, backend, r0["losses"][0], base[backend])
            if backend is not None:
                assert all(r[key]["kernel6_sharded_launches"] > 0
                           for r in ranks), (shape, "kernel 6 not launched")
            if shape == (2, 2) and backend is not None:
                assert all(r[key]["plain_step1_equal"] for r in ranks), (
                    "kernel 6 != plain on the (2, 2) step")
            line["runs"]["dither" if backend else "none"] = {
                "losses": r0["losses"], "single_device_step1": base[backend],
                "replicas_bitwise": True,
                "kernel_equals_plain_step1": r0.get("plain_step1_equal"),
                "step_ms_by_rank": [r[key]["step_ms"] for r in ranks],
                "kernel6_sharded_launches": r0["kernel6_sharded_launches"],
                "kernel6_sharded_by_block": r0["kernel6_sharded_by_block"],
                "kernel6_epilogue_launches": r0["kernel6_epilogue_launches"],
                "collectives_a_step": r0["collectives_a_step"],
                "peak_memory_allocated_gb_by_rank": [
                    r[key]["peak_memory_allocated_gb"] for r in ranks]}
        line["note"] = "ranks sharing one card: no sharded rate"
        meshes[f"{shape[0]}x{shape[1]}"] = line
        emit({"phase": "train_mesh", **line})
    # the checkpoint written at (2, 2): restored at (2, 1) and (1, 1)
    ck_key = ("ckpt", (2, 1), ckpt, "False")
    assert all(r[ck_key]["restored_equal"] for r in two), "(2, 1) restore"
    name, layers = TRAIN_MESH_CKPT
    ccfg = mesh_cfg(name, layers)
    like = trainer.init_train_state(ccfg, seed=0, device="cuda")
    got = Checkpointer(ckpt).restore(1, like, interop.train_state_shardings(
        like, ccfg, MeshShape(("data", "model"), (1, 1)),
        {"data": 0, "model": 0}))
    import numpy as np
    with np.load(os.path.join(ckpt, "step_00000001", "arrays.npz")) as data:
        assert all(torch.equal(g.cpu().float(),
                               torch.from_numpy(np.array(data[f"leaf_{i}"])))
                   for i, g in enumerate(tree.leaves(got))), "(1, 1) restore"
    del like, got
    moe_key = ("steps", (2, 1), TRAIN_MESH_MOE, str(MESH_SHARED_LAYERS),
               "None")
    moe = two[0][moe_key]
    assert [r[moe_key]["losses"] for r in two] == [moe["losses"]] * 2
    assert moe["losses"][0] == base["moe_groups"], (moe["losses"],
                                                     base["moe_groups"])
    seq = two[0][("steps", (1, 2), TRAIN_MESH_SEQ_SPLIT, str(SMOLLM_LAYERS),
                  "None")]
    assert abs(seq["losses"][0] - base["seq"]) <= TRAIN_MESH_LOSS_TOL[False]
    assert seq["collectives_a_step"]["gather_from_model"]["calls"] > 0
    launches = {f"{k} dither": {
        **v["runs"]["dither"]["kernel6_sharded_by_block"],
        "epilogue": v["runs"]["dither"]["kernel6_epilogue_launches"]}
        for k, v in meshes.items()}
    # the recurrent and encoder-decoder families at (1, 2) (item 10c)
    tp_lines, off = {}, []
    for fam, (depth, pol) in TRAIN_MESH_TP.items():
        line = {"mesh": [1, 2], "backend": "gloo", "shared_card": True,
                "model": fam, "layers": depth, "runs": {}}
        for backend in (None, "auto") if pol else (None,):
            key = ("steps", (1, 2), fam, str(depth), str(backend))
            replicas_equal(tp_specs[fam], (1, 2), two, key)
            r0 = two[0][key]
            assert all(r[key]["losses"] == r0["losses"] for r in two), key
            tol = (TRAIN_MESH_LOSS_TOL[True] if backend is not None
                   else TRAIN_MESH_TP_LOSS_TOL)
            if abs(r0["losses"][0] - base[fam, backend]) > tol:
                off.append((fam, backend, r0["losses"][0],
                            base[fam, backend]))
            if backend is not None:
                by = {**r0["kernel6_sharded_by_block"],
                      "epilogue": r0["kernel6_epilogue_launches"]}
                for kind in ("columns", "k_block", "epilogue"):
                    assert by[kind] > 0, (fam, kind, "kernel 6 not launched")
                launches[f"1x2 {fam} dither"] = by
            line["runs"]["dither" if backend else "none"] = {
                "losses": r0["losses"],
                "single_device_step1": base[fam, backend],
                "step1_gap": abs(r0["losses"][0] - base[fam, backend]),
                "step1_tolerance": tol,
                "replicas_bitwise": True,
                "step_ms_by_rank": [r[key]["step_ms"] for r in two],
                "kernel6_sharded_by_block": r0["kernel6_sharded_by_block"],
                "kernel6_epilogue_launches": r0["kernel6_epilogue_launches"],
                "collectives_a_step": {
                    k: v for k, v in r0["collectives_a_step"].items()
                    if v["calls"]},
                "peak_memory_allocated_gb_by_rank": [
                    r[key]["peak_memory_allocated_gb"] for r in two]}
        line["decode"] = decode_gates(torch, two, fam, depth, pol, off,
                                      launches)
        line["note"] = "ranks sharing one card: no sharded rate"
        tp_lines[fam] = line
        emit({"phase": "train_mesh", **line})
    # every family's line is out before the first gap fails the run
    assert not off, off
    for mesh_key, kind in (("2x1", "rows"), ("1x2", "columns"),
                           ("1x2", "k_block"), ("1x2", "epilogue")):
        assert launches[f"{mesh_key} dither"][kind] > 0, (
            mesh_key, kind, "kernel 6 not launched")
    dry = dryrun_checks(started, meshes, one, tp_lines)
    emit({"phase": "train_mesh", "dryrun": dry})
    res.update(
        one_by_one=one, meshes=meshes,
        elastic={"saved_at": [2, 2], "restored_at": [[2, 1], [1, 1]],
                 "bytes_equal": True, "model": f"{name}, {layers} layers",
                 "save_s": four[0][("ckpt", (2, 2), ckpt, "True")]["save_s"],
                 "restore_s_2x1": two[0][ck_key]["restore_s"],
                 "bytes": two[0][ck_key]["bytes"]},
        moe_2x1={"loss": moe["losses"][0], "two_capacity_groups":
                 base["moe_groups"], "bitwise": True,
                 "peak_memory_allocated_gb": moe["peak_memory_allocated_gb"]},
        seq_split_1x2={"model": TRAIN_MESH_SEQ_SPLIT, "loss":
                       seq["losses"][0], "single_device": base["seq"],
                       "gathers_a_step":
                           seq["collectives_a_step"]["gather_from_model"]},
        spawn_s={"four_ranks": four_s, "two_ranks": two_s},
        launches=launches, tp_families=tp_lines, dryrun=dry,
        seconds=time.perf_counter() - t_start)
    shutil.rmtree(ckpt, ignore_errors=True)
    return res


def decode_gates(torch, ranks, fam, depth, pol, off, launches):
    """Step 4b's gates on the ranks' ``train_mesh_decode`` results (gaps
    over their tolerance go to ``off``, the policy tick's kernel 6
    launches to ``launches``); returns the family's ``decode`` entry."""
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import MeshShape
    from repro_torch.models import registry

    cfg = mesh_cfg(fam, depth)
    key = ("decode", (1, 2), fam, str(depth), str(pol))
    dec = [r[key] for r in ranks]
    d0 = dec[0]
    assert all(d["logit_digests"] == d0["logit_digests"] for d in dec), (
        fam, "decode logits differ across 'model' ranks")
    meta = registry.init_model(cfg, device="meta")
    frames = (torch.zeros((TP_DECODE_BATCH, cfg.n_enc_tokens, cfg.d_model),
                          dtype=torch.bfloat16, device="meta")
              if cfg.is_encdec else None)
    with torch.no_grad():
        cache = registry.make_cache(meta, cfg, TP_DECODE_BATCH,
                                    TP_DECODE_LEN, frames, device="meta")
    specs = sharding.spec_leaves(sharding.cache_specs(
        cache, cfg, MeshShape(("data", "model"), (1, 2))))
    for i, spec in enumerate(specs):
        if "model" not in spec:
            assert len({str(d["digests"][i]) for d in dec}) == 1, (
                fam, "a replicated cache leaf differs across ranks", i)
    for d in dec:
        assert d["int_leaves_equal"], (fam, "integer cache leaves")
        clear = max(ARGMAX_FLOOR, 2 * d["logit_gap"])
        assert all(m < clear for _, _, m in d["greedy_flips"]), (
            fam, "a greedy token left one device's where the margin clears",
            d["greedy_flips"])
        for what, tol in (("logit_gap", TP_DECODE_LOGIT_TOL),
                          ("state_gap", TP_DECODE_STATE_TOL)):
            if d[what] > tol:
                off.append((fam, "decode", what, d[what]))
    attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers)) \
        if not cfg.is_encdec else cfg.n_layers
    if fam in TP_DECODE_HEADS:
        heads = "x".join(map(str, TP_DECODE_HEADS[fam][:3]))
        for d in dec:
            assert d["kernel1_by_heads"] == {heads: attn * TP_DECODE_TICKS}, (
                fam, "kernel 1 not at the local heads", d["kernel1_by_heads"])
    out = {k: d0[k] for k in ("logit_gap", "logit_gap_by_tick",
                              "logit_scale", "state_gap", "greedy_flips",
                              "kernel1_launches", "kernel1_by_heads",
                              "collectives_a_tick")}
    out.update(seconds_by_rank=[d["seconds"] for d in dec],
               ticks=TP_DECODE_TICKS, batch=TP_DECODE_BATCH,
               prompt=TP_DECODE_PROMPT, ring=TP_DECODE_LEN,
               logit_tolerance=TP_DECODE_LOGIT_TOL,
               state_tolerance=TP_DECODE_STATE_TOL, replicas_bitwise=True,
               logit_gap_by_rank=[d["logit_gap"] for d in dec],
               state_gap_by_rank=[d["state_gap"] for d in dec],
               tick_ms_by_rank=[d["tick_ms"] for d in dec],
               one_device_tick_ms_by_rank=[d["one_device_tick_ms"]
                                           for d in dec],
               note="ranks sharing one card: no sharded rate")
    if pol:
        p0 = d0["policy"]
        assert all(d["policy"]["logit_digests"] == p0["logit_digests"]
                   for d in dec), (fam, "policy logits differ across ranks")
        by = {**p0["kernel6_sharded_by_block"],
              "epilogue": p0["kernel6_epilogue_launches"]}
        for kind in ("columns", "k_block", "epilogue"):
            assert by[kind] > 0, (fam, kind, "kernel 6 not launched")
        launches[f"1x2 {fam} decode dither"] = by
        if not all(d["policy"]["bitwise"] and d["policy"]["state_bitwise"]
                   for d in dec):
            off.append((fam, "decode policy ticks", p0["logit_gap"],
                        p0["state_gap"]))
        out["policy"] = {k: p0[k] for k in (
            "bitwise", "state_bitwise", "logit_gap", "state_gap", "tick_ms",
            "kernel6_sharded_by_block", "kernel6_epilogue_launches")}
    return out


def dryrun_predictions(q, scfg, fcfg):
    """(spawned, on the CPU: it runs beside the block's card work) The dry
    run's counts (``launch/dryrun.py``, meta tensors on a fake process
    group) for ``dryrun_checks``: the collectives of one qwen2-1.5b step
    at 8 layers (``scfg``) on (2, 2), 8 × 512, with no policy and under
    the dither policy; the state bytes, FLOPs and peak of live bytes of
    the 28-layer (``fcfg``) step on (1, 1).  Put on ``q``."""
    import traceback

    try:
        import torch.distributed as dist

        from repro_torch.launch import dryrun

        t0 = time.perf_counter()
        out = {"collectives": {}}
        try:
            mesh = dryrun.fake_mesh(2, 2)
            for backend in (None, "auto"):
                got = dryrun.measure(scfg, "train", TRAIN_SEQ, TRAIN_BATCH,
                                     mesh, policy=train_mesh_policy(backend))
                out["collectives"]["dither" if backend else "none"] = \
                    got["collectives"]
            # step 4b's decode cells (1, 2): one tick each, no policy
            mesh = dryrun.fake_mesh(1, 2)
            out["decode"] = {}
            for fam, (depth, _) in TRAIN_MESH_TP.items():
                got = dryrun.measure(mesh_cfg(fam, depth), "decode",
                                     TP_DECODE_LEN, TP_DECODE_BATCH, mesh)
                out["decode"][fam] = {k: got[k] for k in (
                    "collectives", "layout", "state_bytes")}
            full = dryrun.measure(fcfg, "train", TRAIN_SEQ, TRAIN_BATCH,
                                  dryrun.fake_mesh(1, 1))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        out["full"] = {k: full[k] for k in ("peak_bytes", "state_bytes",
                                            "flops")}
        out["seconds"] = time.perf_counter() - t0
        out["ended_at"] = time.time()
        q.put(out)
    except BaseException:
        q.put({"error": traceback.format_exc()})


def start_dryrun(scfg, fcfg):
    """``dryrun_predictions`` in a spawned process; returns (process,
    queue) for ``dryrun_checks``."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    proc = ctx.Process(target=dryrun_predictions, args=(q, scfg, fcfg),
                       daemon=True)
    proc.start()
    return proc, q


def dryrun_checks(started, meshes, one, tp_lines, timeout=600):
    """The dry run's counts (``start_dryrun``) against this block's own
    runs: its collectives of the qwen2-1.5b (2, 2) step, with no policy
    and under the dither policy, equal to rank 0's last step by kind,
    calls and bytes; its (1, 2) decode cells of the item-10c families on
    the training layout, their collectives equal to a tick of step 4b
    (rank 0); its peak of live bytes for the 28-layer (1, 1) step beside
    the measured peak of that run (init and 3 steps).  Stops the
    process."""
    import queue

    proc, q = started
    deadline = time.monotonic() + timeout
    try:
        while True:
            try:
                pred = q.get(timeout=5)
                break
            except queue.Empty:
                if not proc.is_alive() and q.empty():
                    raise RuntimeError("the dry run gave no result") from None
                if time.monotonic() > deadline:
                    raise RuntimeError("the dry run timed out") from None
    finally:
        proc.join(timeout=10)
        if proc.is_alive():
            proc.kill()
            proc.join()
    if "error" in pred:
        raise RuntimeError(f"the dry run:\n{pred['error']}")
    out = {"collectives_equal": {}}
    for run, got in pred["collectives"].items():
        real = {k: v for k, v in meshes["2x2"]["runs"][run][
            "collectives_a_step"].items() if v["calls"]}
        assert got == real, (run, got, real)
        out["collectives_equal"][run] = got
    out["decode_collectives_equal"] = {}
    for fam, got in pred["decode"].items():
        real = tp_lines[fam]["decode"]["collectives_a_tick"]
        assert got["layout"] == "train", (fam, got["layout"])
        assert got["collectives"] == real, (fam, got["collectives"], real)
        out["decode_collectives_equal"][fam] = got["collectives"]
        out.setdefault("decode_state_bytes", {})[fam] = got["state_bytes"]
    full = pred["full"]
    out.update(
        peak_1x1_predicted_gb=full["peak_bytes"] / 1e9,
        peak_1x1_measured_gb=one["peak_memory_allocated_gb"],
        state_1x1_gb=full["state_bytes"] / 1e9,
        flops_1x1_step=full["flops"], seconds=pred["seconds"],
        ended_at=pred["ended_at"])
    return out


# ------------------------------------------------------- the autotuner

AUTOTUNE_RING = dict(b=8, cap=1024, nkv=3, group=3, hd=64)   # SmolLM-135M
AUTOTUNE_MATMULS = MATMUL_SHAPES[:5]   # the policy serve's decode products
AUTOTUNE_QUANTIZE = (576, 1536)
AUTOTUNE_REQUESTS = 8      # the tuned engines' traffic: 8 ring requests,
AUTOTUNE_NEW = 16          # 16 new tokens each
AUTOTUNE_REPEATS, AUTOTUNE_LAUNCHES = 5, 50   # samples, calls a sample


def candidate_rows(results, smi, errs):
    """A sweep's results as printed: each candidate's least, median and
    largest ms a call over its samples, and its error against the plain
    version."""
    import statistics

    rows = []
    for r in results:
        ms = sorted(s * 1e3 for s in r["samples"])
        rows.append({"block": r["block"], "ms": ms[0],
                     "median_ms": statistics.median(ms), "max_ms": ms[-1],
                     "max_abs_err": errs[tuple(r["block"])], "card": smi})
    return rows


def autotune_phase(torch, kmods, cfg, params, smi):
    """The kernel autotuner (``kernels/autotune.py``) on the card, at
    SmolLM-135M's full width, with ``REPRO_AUTOTUNE_CACHE`` pointed at a
    temporary file:

    1. every candidate held against its plain version — kernels 1 and 3
       at each ring tile (B 8, a 1,024-slot ring, bf16 and int8) within
       ``KERNEL_TOL``, every verify row (K 4) equal to the decode kernel
       at its position and tile bit for bit, kernels 2 and 4 on the same
       snapshot as a pool of blocks of the tile's size equal to the ring
       kernels bit for bit and within ``KERNEL_TOL`` of their plain
       versions; kernel 6's policy entry at the policy serve's four
       decode products and the LM head at every ``(mt, cps, splits)``, and
       kernel 5 at (576, 1536), bit for bit;
    2. each kernel swept (CUDA events around ``AUTOTUNE_LAUNCHES``
       back-to-back calls, ``AUTOTUNE_REPEATS`` samples): the verify
       kernel first, then the decode kernel, whose winner is the shared
       ring tile; the pool block, one pool per candidate; kernel 6 per
       product; kernel 5's one candidate — every candidate's times printed
       on a line of its own with the card's name and power limit;
    3. the winners written to the file, the in-memory cache cleared;
    4. a ring int8 engine at W = 1 and W = 8 and a speculative one served
       under the winners (read back from the file), with a tracer: the
       engines hold the winning tile, the tracer saw the cache hits, W = 8
       ≡ W = 1 and spec ≡ plain, and the dither-policy streams under the
       winners equal those without a cache;
    5. the cache cleared and the variable unset, so later phases take the
       model picks.

    Returns the phase line."""
    import shutil
    import tempfile

    from repro_torch.kernels import autotune, dispatch, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import dither_matmul as dm
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_verify_attention as pva
    from repro_torch.kernels import quantize as qk
    from repro_torch.kernels import verify_attention as va
    from repro_torch.numerics.policy import QuantPolicy
    from repro_torch.serve import Engine, Tracer

    mark, parts = part_timer()
    tmp = tempfile.mkdtemp(prefix="autotune_")
    path = os.path.join(tmp, "autotune.json")
    os.environ["REPRO_AUTOTUNE_CACHE"] = path
    autotune.clear_cache()
    gen = torch.Generator().manual_seed(17)
    sh = AUTOTUNE_RING
    b, cap, nkv, group, hd = (sh[k] for k in ("b", "cap", "nkv", "group",
                                              "hd"))
    split = dict(split=da.SPLIT_TILES)
    winners, checked = {}, 0

    def sweep_line(kernel, shape, winner, results, errs, **extra):
        emit({"phase": "autotune_candidates", "kernel": kernel,
              "shape": list(shape), "winner": list(winner),
              "candidates": candidate_rows(results, smi, errs), **extra})

    # kernels 1-4: every ring tile, the pools of the same block size
    for quant in (False, True):
        kv = "int8" if quant else "bfloat16"
        t = ring_inputs(gen, **sh, quant=quant, pos_vals=SERVE_POS)
        tv = ring_inputs(gen, **sh, quant=quant, pos_vals=SERVE_POS,
                         kq=SPEC_K)
        errs = {"decode": {}, "verify": {}, "paged": {}}
        pools, pools_v = {}, {}
        for blk in autotune.decode_attention_candidates(
                cap, hd=hd, group=group, quantized=quant):
            got = da.decode_attention(*t, block=blk)
            gv = va.verify_attention(*tv, block=blk)
            pools[blk] = ring_as_pool(torch, gen, t, bs=blk[0])
            pools_v[blk] = ring_as_pool(torch, gen, tv, bs=blk[0])
            paged = pda.paged_decode_attention(*pools[blk])
            paged_v = pva.paged_verify_attention(*pools_v[blk])
            torch.cuda.synchronize()
            for name, out, want in (
                    ("decode", got,
                     ref.decode_attention_ref(*t, block=blk, **split)),
                    ("verify", gv,
                     ref.verify_attention_ref(*tv, block=blk, **split)),
                    ("paged", paged,
                     ref.paged_decode_attention_ref(*pools[blk], **split))):
                assert torch.isfinite(out).all(), (name, blk, kv)
                torch.testing.assert_close(out, want, atol=KERNEL_TOL,
                                           rtol=KERNEL_TOL)
                errs[name][blk] = (out - want).abs().max().item()
            torch.testing.assert_close(
                paged_v, ref.paged_verify_attention_ref(*pools_v[blk],
                                                        **split),
                atol=KERNEL_TOL, rtol=KERNEL_TOL)
            assert torch.equal(paged, got), ("ring != paged", blk, kv)
            assert torch.equal(paged_v, gv), ("ring != paged verify", blk,
                                              kv)
            assert rows_equal(torch, gv, functools.partial(
                da.decode_attention, block=blk), tv, 0), (blk, kv)
            checked += 1
        _, res = autotune.autotune_verify_attention(
            b, cap, nkv, SPEC_K, group, hd, backend="cuda", dtype=kv,
            repeats=AUTOTUNE_REPEATS, launches=AUTOTUNE_LAUNCHES,
            run=lambda blk: va.verify_attention(*tv, block=blk))
        sweep_line("verify_attention", (b, cap, nkv, SPEC_K, group, hd),
                   res[0]["block"], res, errs["verify"], kv=kv,
                   note="timed only: the decode sweep below sets the "
                        "shared tile")
        win, res = autotune.autotune_decode_attention(
            b, cap, nkv, group, hd, backend="cuda", dtype=kv,
            repeats=AUTOTUNE_REPEATS, launches=AUTOTUNE_LAUNCHES,
            run=lambda blk: da.decode_attention(*t, block=blk))
        winners[f"decode_attention[{kv}]"] = list(win)
        sweep_line("decode_attention", (b, cap, nkv, group, hd), win, res,
                   errs["decode"], kv=kv)
        win, res = autotune.autotune_paged_attention(
            b, cap, nkv, group, hd, backend="cuda", dtype=kv,
            repeats=AUTOTUNE_REPEATS, launches=AUTOTUNE_LAUNCHES,
            run=lambda blk: pda.paged_decode_attention(*pools[tuple(blk)]))
        winners[f"paged_attention[{kv}]"] = list(win)
        sweep_line("paged_decode_attention", (b, cap, nkv, group, hd), win,
                   res, errs["paged"], kv=kv)
    mark("attention")
    # kernel 6's policy entry at the serve products, kernel 5
    kw = dict(bits=8, scheme="dither", counter=77, seed=3)
    for m, k, n in AUTOTUNE_MATMULS:
        x, w = policy_operands(torch, gen, m, k, n)
        aw = dm.weight_absmax(w)
        want = ref.dither_matmul_scaled_ref(x, w, **kw)
        cands = autotune.matmul_candidates(m, k, n)
        for blk in cands:
            got = dm.dither_matmul_scaled(x, w, aw, block=blk, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), ((m, k, n), blk)
            checked += 1
        win, res = autotune.autotune_matmul(
            m, k, n, bits=8, scheme="dither", backend="cuda",
            dtype="bfloat16", repeats=AUTOTUNE_REPEATS,
            launches=AUTOTUNE_LAUNCHES,
            run=lambda blk: dm.dither_matmul_scaled(x, w, aw, block=blk,
                                                    **kw))
        winners[f"matmul{[m, k, n]}"] = list(win)
        sweep_line("dither_matmul_scaled", (m, k, n), win, res,
                   {tuple(c): 0 for c in cands},
                   model_pick=list(autotune.model_block("matmul", (m, k, n),
                                                        "bfloat16")))
    m, n = AUTOTUNE_QUANTIZE
    x = (torch.rand((m, n), generator=gen) * 2.4 - 1.2).cuda()
    qkw = dict(bits=8, lo=-1.2, hi=1.2, scheme="dither", counter=12345,
               seed=7)
    want = dispatch.quantize(x, backend="torch-ref", **qkw)
    assert torch.equal(dispatch.quantize(x, block=(), **qkw), want)
    checked += 1
    win, res = autotune.autotune_quantize(
        m, n, bits=8, scheme="dither", backend="cuda",
        repeats=AUTOTUNE_REPEATS, launches=AUTOTUNE_LAUNCHES,
        run=lambda blk: dispatch.quantize(x, block=blk, **qkw))
    winners["quantize"] = list(win)
    sweep_line("quantize", (m, n), win, res, {(): 0})
    mark("kernels_5_6")
    # the winners on disk; the engines read them back from the file
    saved = json.load(open(path))
    assert len(saved) == 2 + 2 + len(AUTOTUNE_MATMULS) + 1, sorted(saved)
    autotune.clear_cache()
    ring_win = tuple(winners["decode_attention[int8]"])
    reqs = lambda: ring_requests(cfg, AUTOTUNE_REQUESTS,   # noqa: E731
                                 ring_lens()[:AUTOTUNE_REQUESTS],
                                 AUTOTUNE_NEW)
    tracer = Tracer(sink=None)

    def serve(**knobs):
        eng = Engine(params, cfg, 8, 1024, kv_quant=True, device="cuda",
                     trace=tracer, **knobs)
        for req in reqs():
            eng.submit(req)
        for mod in kmods.values():
            mod.launches = 0
        done = eng.run(10_000)
        torch.cuda.synchronize()
        assert len(done) == AUTOTUNE_REQUESTS and all(
            len(r.out) == AUTOTUNE_NEW for r in done)
        return eng, {tuple(r.prompt): r.out for r in done}

    eng, w1 = serve()
    assert eng.attn_block == ring_win, (eng.attn_block, ring_win)
    assert eng._graphs.launches()["decode_attention"] > 0
    eng, w8 = serve(decode_ticks=WINDOW)
    assert eng.attn_block == ring_win and w8 == w1, "W = 8 != W = 1"
    eng, spec = serve(spec_decode=True, draft_k=SPEC_K)
    assert eng.attn_block == ring_win and spec == w1, "spec != plain"
    assert kmods["verify_attention"].launches > 0
    policy = QuantPolicy(scheme="dither", backend="auto")
    _, tuned_policy = serve(policy=policy)
    assert kmods["dither_matmul_scaled"].launches > 0
    hits = [r for r in tracer.records()
            if r.get("name") == "autotune_cache_hit"]
    keys = {r["key"] for r in hits}
    assert len(hits) >= 4 and any(k.startswith("decode_attention|")
                                  for k in keys), keys
    assert sum(k.startswith("matmul|8x") for k in keys) >= 4, keys
    mark("tuned_serve")
    autotune.clear_cache()
    del os.environ["REPRO_AUTOTUNE_CACHE"]
    shutil.rmtree(tmp)
    _, untuned_policy = serve(policy=policy)
    assert untuned_policy == tuned_policy, "tuned policy streams differ"
    autotune.clear_cache()
    mark("untuned_policy")
    return {"phase": "autotune", "card": smi, "winners": winners,
            "candidates_checked": checked,
            "model_picks": {"decode_attention": list(autotune.model_block(
                "decode_attention", (b, cap, nkv, group, hd), "int8")),
                "paged_attention": list(autotune.model_block(
                    "paged_attention", (b, cap, nkv, group, hd), "int8"))},
            "tuned_ring_tile": list(ring_win), "cache_hits": len(hits),
            "w8_equals_w1": True, "spec_equals_plain": True,
            "policy_tuned_equals_untuned": True,
            "requests": AUTOTUNE_REQUESTS, "new_tokens_each": AUTOTUNE_NEW,
            "seconds": parts}


def autotune_main() -> int:
    """``--autotune``: the device and build phases, then the autotune
    phase alone (for a short call on the card)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import registry
    from repro_torch.serve.graphs import KERNEL_WRAPPERS

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__})
    emit({"phase": "build", "seconds": _build.build()})
    cfg = dataclasses.replace(get_config("smollm_135m"),
                              n_layers=SMOLLM_LAYERS)
    params = registry.init_model(cfg, seed=0, device="cuda")
    emit(autotune_phase(torch, KERNEL_WRAPPERS, cfg, params, smi))
    return 0


def device_memory(torch):
    """The card's free and total memory (every process's use), and this
    process's allocated and reserved bytes, in GB."""
    free, total = torch.cuda.mem_get_info()
    return {"free_gb": free / 1e9, "total_gb": total / 1e9,
            "allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "reserved_gb": torch.cuda.memory_reserved() / 1e9}


def registry_init(cfg):
    from repro_torch.models import registry

    return registry.init_model(cfg, seed=0, device="cuda")


def mesh_main() -> int:
    """``--mesh-block``: the device and build phases, then the mesh block
    and the training-mesh block alone (for a short call on the card)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_decode_attention as pda

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__})
    emit({"phase": "build", "seconds": _build.build()})
    emit(mesh_phase(torch, da, pda, ref))
    from repro_torch.kernels import dither_matmul as dm

    emit(train_mesh_phase(torch, dm, ref))
    return 0


def device_fields(main, serve_times):
    """A kernels-line entry's device numbers: the kernels phase's device ms
    of the kernel and of its library call, and the same at the serve
    profile's shapes (``attention_times``)."""
    serve = next(r for r in serve_times if r["name"] == main["name"])
    return {"device_ms": main["device_ms"],
            "library_device_ms": main["library_device_ms"],
            "serve_shapes": {k: serve[k] for k in (
                "pos", "ms", "device_ms", "library_ms", "library_device_ms",
                "bound_ms")}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs on an NVIDIA GPU only")
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import dither_matmul as dm
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import quantize as qk
    from repro_torch.kernels import paged_verify_attention as pva
    from repro_torch.kernels import verify_attention as va
    from repro_torch.models import registry
    from repro_torch.numerics import policy
    from repro_torch.serve.graphs import KERNEL_WRAPPERS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1 — device
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2 — build
    secs = _build.build()
    logs = {n: _build.library_path(n).with_suffix(".log").read_text()
            for n in _build.KERNELS}
    emit({"phase": "build", "seconds": secs,
          "ptxas": {n: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, log in logs.items()}})

    # 3 — kernels
    checks = kernel_phase(torch, da, ref)
    emit({"phase": "kernels", "checks": checks})
    paged_checks, bitwise = paged_kernel_phase(torch, da, pda, ref)
    emit({"phase": "kernels", "layout": "paged", "checks": paged_checks,
          "paged_equals_ring_bitwise": bitwise})
    verify_checks, paged_verify_checks, verify_bitwise = verify_kernel_phase(
        torch, da, pda, va, pva, ref)
    emit({"phase": "kernels", "layout": "ring", "verify": True,
          "checks": verify_checks})
    emit({"phase": "kernels", "layout": "paged", "verify": True,
          "checks": paged_verify_checks,
          "paged_verify_equals_ring_verify_bitwise": verify_bitwise})
    serve_times = attention_times(torch, ("serve",))
    emit({"phase": "kernels", "serve_shapes": True, "times": serve_times})
    dither_rows, dither_cases = dither_kernel_phase(torch, qk, dm, ref,
                                                    policy)
    emit({"phase": "kernels", "dither": True, "cases_bitwise": dither_cases,
          "int32_ops_per_s": int32_ops_per_s()[0],
          "clocks_max_sm_mhz": int32_ops_per_s()[1], "times": dither_rows})

    # 4 — serve (plain, then speculative on the same traffic), 5 — parity
    cfg = dataclasses.replace(get_config("smollm_135m"),
                              n_layers=SMOLLM_LAYERS)
    params = registry.init_model(cfg, seed=0, device="cuda")
    emit(row_purity_phase(torch, cfg, params))
    kmods = KERNEL_WRAPPERS
    emit(autotune_phase(torch, kmods, cfg, params, smi))
    serve, paged, spec = {}, {}, {}
    w1_streams = {}
    for kv_quant in (False, True):
        serve[kv_quant], ring_streams = serve_phase(torch, da, pda, cfg,
                                                    params, kv_quant)
        emit(serve[kv_quant])
        paged[kv_quant], paged_streams = paged_serve_phase(
            torch, da, pda, cfg, params, kv_quant)
        emit(paged[kv_quant])
        w1_streams["ring", kv_quant] = ring_streams
        w1_streams["paged", kv_quant] = paged_streams
        for layout, plain, streams in (("ring", serve, ring_streams),
                                       ("paged", paged, paged_streams)):
            for drafter in ("replay", "lookup"):
                spec[layout, kv_quant, drafter] = res = spec_serve_phase(
                    torch, kmods, cfg, params, kv_quant, layout,
                    plain[kv_quant], streams, drafter)
                emit(res)
    # windows of WINDOW ticks, each one graph replay; graph ≡ eager; chunks
    window_runs = {}
    for layout, kv_quant in (("ring", False), ("ring", True),
                             ("paged", True)):
        plain = (serve if layout == "ring" else paged)[kv_quant]
        window_runs[layout, kv_quant] = res = window_serve_phase(
            torch, da, pda, cfg, params, layout, kv_quant, plain,
            w1_streams[layout, kv_quant])
        emit(res)
    for layout in ("ring", "paged"):
        for kv_quant in (False, True):
            emit(graph_phase(torch, cfg, params, layout, kv_quant))
    chunked, chunked_streams = chunked_phase(torch, da, pda, cfg, params,
                                             w1_streams["ring", True])
    emit(chunked)
    # fault tolerance and observability, on the serve phases' traffic
    # (the ring int8 run serves FAULT_NEW_W8 tokens a request: its six
    # engines each capture an int8 W = 8 graph, PERF.md §4)
    for layout, kv_quant, knobs, want, ticks, new in (
            ("ring", False, {}, w1_streams["ring", False], FAULT_TICKS, 64),
            ("ring", True, dict(decode_ticks=WINDOW, prefill_chunk=CHUNK),
             chunked_streams, FAULT_TICKS_W8, FAULT_NEW_W8),
            ("paged", False, {}, w1_streams["paged", False], FAULT_TICKS,
             64),
            ("paged", True, {}, w1_streams["paged", True], FAULT_TICKS, 64)):
        emit(fault_phase(torch, cfg, params, layout, kv_quant, knobs, want,
                         ticks, new))
    emit(observe_phase(torch, cfg, params, "ring", False, WINDOW,
                       w1_streams["ring", False]))
    emit(observe_phase(torch, cfg, params, "paged", True, 1,
                       w1_streams["paged", True]))
    emit(overload_phase(torch, cfg, params, w1_streams["paged", True]))
    # the quantised-matmul policy path on the ring and paged traffic
    pol_runs = {}
    for layout, kv_quant in (("ring", False), ("ring", True),
                             ("paged", True)):
        plain = (serve if layout == "ring" else paged)[kv_quant]
        pol_runs[layout, kv_quant] = res = policy_serve_phase(
            torch, kmods, cfg, params, kv_quant, layout, plain)
        emit(res)
    emit(policy_restart_phase(torch, cfg, params))
    for kv_quant in (False, True):
        emit(profile_phase(torch, cfg, params, kv_quant))
    emit(profile_phase(torch, cfg, params, True, kv_layout="paged"))
    # the bf16 window only, for time: the int8 W = 8 window's graph ≡
    # eager is the graph phase's, byte for byte
    emit(window_profile_phase(torch, cfg, params, False))
    # the spec window and the policy tick profiled in bf16 only, for time
    # (their int8 profiles are measurements, no gate; PERF.md §5 keeps
    # the last ones taken)
    emit(profile_phase(torch, cfg, params, False, spec=True))
    from repro_torch.numerics.policy import QuantPolicy

    emit(profile_phase(torch, cfg, params, False,
                       policy=QuantPolicy(scheme="dither", backend="auto")))
    for kv_quant in (False, True):
        emit(parity_phase(torch, cfg, params, kv_quant))
        emit(paged_parity_phase(torch, cfg, params, kv_quant))
        emit(prefill_invariance_phase(torch, cfg, params, kv_quant))
        emit(policy_parity_phase(torch, cfg, params, kv_quant))
    emit(policy_error_phase(torch, cfg, params))
    # training (full width, both policies) and the pulse-stream core
    train = train_phase(torch, dm, cfg)
    emit(train)
    emit(core_phase(torch))
    # the training mesh block's dry-run counts: a CPU process from here on,
    # beside the single-process phases, away from the mesh blocks' ranks
    dry = start_dryrun(mesh_cfg(MESH_MODEL, MESH_SHARED_LAYERS),
                       mesh_cfg(MESH_MODEL, TRAIN_MESH_LAYERS))
    # the rest of the zoo, one config at a time (ROADMAP Queue 1 item 11)
    zoo = {}
    for name in ZOO:
        zoo[name] = res = zoo_phase(torch, name, da, pda, va, pva, dm, ref)
        emit(res)
    # the recurrent configs (ROADMAP Queue 1 item 11b-i)
    for name in RECURRENT_ZOO:
        zoo[name] = res = recurrent_phase(torch, name, da, dm, ref)
        emit(res)
    # the encoder-decoder (ROADMAP Queue 1 item 11b-ii)
    zoo[ENCDEC] = res = encdec_phase(torch, da, dm, ref)
    emit(res)
    # sharded serving on a (data, model) mesh (ROADMAP Queue 1 item 10)
    mesh = mesh_phase(torch, da, pda, ref)
    emit(mesh)
    # the training mesh (ROADMAP Queue 1 item 10b)
    train_mesh = train_mesh_phase(torch, dm, ref, dry)
    emit(train_mesh)

    kernels = []
    for kv_quant in (False, True):
        for rows, source, replaces, runs, key, layout in (
                (checks, da.SOURCE, REPLACES, serve,
                 "decode_attention_launches", "ring"),
                ([c for c in paged_checks if c["shape"]["bs"] == 64],
                 pda.SOURCE, PAGED_REPLACES, paged,
                 "paged_decode_attention_launches", "paged")):
            main = next(c for c in rows
                        if c["model_shapes"] == "smollm_135m"
                        and c["window"] == 0 and "ms" in c
                        and c["name"].endswith("[int8]") == kv_quant)
            kernels.append({
                "name": main["name"], "route": "cuda", "source": source,
                "replaces": replaces, "launches": runs[kv_quant][key],
                "launches_note": "W = 1 serve run: graph replays × "
                                 "launches per graph, plus the warm-up "
                                 "window's",
                "window_serve_launches": window_runs[layout, kv_quant][key]
                if (layout, kv_quant) in window_runs else None,
                "max_abs_err": main["max_abs_err"], "ms": main["ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"],
                "library_ms": main["library_ms"],
                **device_fields(main, serve_times),
                "kernel_ms": main["kernel_ms"], "shape": main["shape"]})
        for rows, source, replaces, layout in (
                (verify_checks, va.SOURCE, VERIFY_REPLACES, "ring"),
                ([c for c in paged_verify_checks if c["shape"]["bs"] == 64],
                 pva.SOURCE, PAGED_VERIFY_REPLACES, "paged")):
            main = next(c for c in rows
                        if c["model_shapes"] == "smollm_135m"
                        and c["window"] == 0 and c["kq"] == SPEC_K
                        and "ms" in c
                        and c["name"].endswith("[int8]") == kv_quant)
            run = spec[layout, kv_quant, "lookup"]
            kernels.append({
                "name": main["name"], "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": run["launches"][main["name"].split("[")[0]],
                "max_abs_err": main["max_abs_err"], "ms": main["ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"],
                "library_ms": main["library_ms"],
                **device_fields(main, serve_times),
                "kernel_ms": main["kernel_ms"], "shape": main["shape"]})
    zoo_runs = {"decode_attention[bf16]": "ring_bf16",
                "decode_attention[int8]": "ring_int8",
                "paged_decode_attention[bf16]": "paged_bf16_cold",
                "paged_decode_attention[int8]": "paged_int8_prefix",
                "verify_attention[bf16]": "spec_ring_bf16"}
    for entry in kernels:
        entry["zoo_shapes"] = [
            {k: row[k] for k in ("model_shapes", "shape", "max_abs_err",
                                 "ms", "plain_ms", "library_ms", "bound_ms",
                                 "bound_by")}
            for z in zoo.values() for row in z["kernels"]
            if row["name"] == entry["name"]]
        run = zoo_runs.get(entry["name"])
        kernel = entry["name"].split("[")[0]
        entry["zoo_launches"] = {
            z["model"]: z["runs"][run][f"{kernel}_launches"]
            for z in zoo.values() if run in z["runs"]}
    # kernel 1 at head dim 256 (recurrentgemma), its own entry
    rg = zoo["recurrentgemma_9b"]
    for kv in ("bf16", "int8"):
        main = next(r for r in rg["kernels"]
                    if r["name"] == f"decode_attention[{kv}]"
                    and r["shape"]["cap"] == HD256_CASES[0][0])
        kernels.append({
            "name": f"decode_attention[{kv}, hd 256]", "route": "cuda",
            "source": da.SOURCE, "replaces": REPLACES,
            "launches": rg["runs"][f"ring_{kv}"]["decode_attention_launches"],
            "launches_note": "recurrentgemma-9b ring serve run: window and "
                             "scanned-prefill graph replays × launches per "
                             "graph, plus the warm-ups'",
            **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "device_ms", "library_device_ms",
                                    "shape", "window", "pos")}})
    # kernel 1 at whisper's self-attention (12 KV heads of 64), its entry
    wh = zoo[ENCDEC]
    main = wh["kernels"][0]
    kernels.append({
        "name": "decode_attention[bf16, whisper-small]", "route": "cuda",
        "source": da.SOURCE, "replaces": REPLACES,
        "launches": wh["runs"]["ring_bf16"]["decode_attention_launches"],
        "launches_note": "whisper-small ring serve run: window and "
                         "scanned-prefill graph replays x launches per "
                         "graph, plus the warm-ups'",
        **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "device_ms",
                                "library_device_ms", "host_ms", "shape",
                                "window", "pos")}})
    # kernels 1 and 2 at the local shape of a 2-way 'model' axis, their
    # launches from the (1, 2) mesh's runs (rank 0)
    for row, source, replaces in zip(
            mesh["local_kernels"], (da.SOURCE, pda.SOURCE),
            (REPLACES, PAGED_REPLACES)):
        kernels.append({
            "name": f"{row['name'][:-1]}, qwen2-1.5b tp 2 local]",
            "route": "cuda", "source": source, "replaces": replaces,
            "launches": mesh["launches_1x2"][row["name"]],
            "launches_note": "(1, 2) mesh, rank 0: eager windows, layers "
                             "x ticks",
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms",
                                   "device_ms", "library_device_ms",
                                   "host_ms", "shape", "pos")}})
    qmain = next(c for c in dither_rows if c["name"] == "quantize"
                 and c["shape"] == [576, 1536])
    kernels.append({
        "name": "quantize", "route": "cuda", "source": qk.SOURCE,
        "replaces": QUANTIZE_REPLACES,
        "launches": pol_runs["ring", True]["launches"]["quantize"],
        "launches_note": "not on the serve path: the dither matmul "
                         "quantises its operands itself",
        **{k: qmain[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "bound_term", "library_ms",
                                 "device_ms", "shape")},
        "library_device_ms": None})
    mmain = {c["name"]: c for c in dither_rows
             if c["shape"] == [8, 576, 1536]}
    for (layout, kv_quant), run in pol_runs.items():
        for entry in ("policy_product", "dither_matmul"):
            row = mmain[entry]
            kernels.append({
                "name": "dither_matmul" + ("_scaled" if entry ==
                                           "policy_product" else ""),
                "route": "cuda", "source": dm.SOURCE,
                "replaces": MATMUL_REPLACES,
                "run": f"{layout} {'int8' if kv_quant else 'bf16'} policy "
                       "serve",
                "launches": run["launches"]["dither_matmul"
                                            if entry == "dither_matmul"
                                            else "dither_matmul_scaled"],
                **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "bound_term",
                                       "library_ms", "device_ms", "shape")},
                "library_device_ms": None,
                **{k: row[k] for k in ("unquantised_bf16_matmul_ms",
                                       "torch_ops_route_ms",
                                       "torch_ops_route_device_ms") if k in row}})
    k6 = next(e for e in kernels if e["name"] == "dither_matmul_scaled")
    k6["zoo_shapes"] = [{"model": z["model"], **row} for z in zoo.values()
                        for row in z["matmuls"]]
    k6["zoo_launches"] = {
        f"{z['model']} policy serve, ring bf16":
            z["policy"]["kernel6_launches"]
        for z in zoo.values() if "policy" in z}
    k6["zoo_launches"].update({
        f"{z['model']} train, dither policy, {ZOO_TRAIN_STEPS} steps":
            z["train"]["runs"][1]["kernel6_launches"]
        for z in zoo.values() if "train" in z})
    head = next(c for c in dither_rows if c["name"] == "policy_product"
                and c["shape"] == TRAIN_HEAD)
    kernels.append({
        "name": "dither_matmul_scaled", "route": "cuda", "source": dm.SOURCE,
        "replaces": MATMUL_REPLACES,
        "run": f"train, dither policy, {TRAIN_STEPS} steps of "
               f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, remat",
        "launches": train["runs"][1]["kernel6_launches"],
        "launches_per_step": train["runs"][1]["kernel6_launches_per_step"],
        **{k: head[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "bound_term", "library_ms",
                                "device_ms", "shape", "weight")},
        "library_device_ms": None,
        "train_shapes": [{k: c[k] for k in ("shape", "ms", "device_ms",
                                            "plain_ms", "bound_ms",
                                            "bound_term")}
                         for c in dither_rows
                         if c["name"] == "policy_product"
                         and c["shape"][0] == TRAIN_BATCH * TRAIN_SEQ]})
    # kernel 6's sharded entry at the training mesh's local shapes, each
    # row's launches of its own kind from a shared-card mesh's dither run
    # (rank 0): row blocks at (2, 1), the rest at (1, 2)
    for row in train_mesh["kernels"]:
        label = row["model_shapes"]
        if label is None:
            run = "2x1 dither" if row["block"] == "rows" else "1x2 dither"
            steps = TRAIN_MESH_STEPS
        else:
            model = next(m for m in TRAIN_MESH_TP
                         if m.startswith(label.split()[0]))
            decode = label.endswith("decode")
            run = f"1x2 {model} {'decode ' if decode else ''}dither"
            steps = 1
        kernels.append({
            "name": row["name"], "route": "cuda", "source": dm.SOURCE,
            "replaces": MATMUL_REPLACES,
            "launches": train_mesh["launches"][run][row["block"]],
            "launches_note": (
                f"(1, 2) training-layout decode of {model}, rank 0: "
                f"{TP_DECODE_TICKS} dither-policy ticks ({row['block']} "
                "launches of every product)"
                if label is not None and decode else
                f"{run} training mesh, rank 0: {steps} "
                f"dither-policy step(s) ({row['block']} "
                "launches of every product, remat)"),
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "bound_term",
                                   "library_ms", "device_ms", "shape",
                                   "global", "note")}})
    # kernel 1 at the local heads of the (1, 2) training-layout decode,
    # its launches from that run (rank 0)
    for row in train_mesh["decode_kernels"]:
        dec = train_mesh["tp_families"][row["model"]]["decode"]
        kernels.append({
            "name": row["name"], "route": "cuda", "source": da.SOURCE,
            "replaces": REPLACES,
            "launches": dec["kernel1_by_heads"][row["heads"]],
            "launches_note": "(1, 2) training-layout decode, rank 0: "
                             "attention layers x ticks, eager",
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms",
                                   "device_ms", "library_device_ms",
                                   "host_ms", "shape", "window", "pos")}})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    # no winner cache from the environment (this process and the ones it
    # starts): the gates check the launches the model picks
    os.environ.pop("REPRO_AUTOTUNE_CACHE", None)
    if sys.argv[1:2] in (["--attention-times"], ["--dither-times"]):
        sys.exit(times_main(sys.argv[1], sys.argv[2:]))
    if sys.argv[1:2] == ["--attention-times-of"]:
        sys.exit(attention_times_worker(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--dither-times-of"]:
        sys.exit(dither_times_worker(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--mesh-block"]:
        sys.exit(mesh_main())
    if sys.argv[1:2] == ["--autotune"]:
        sys.exit(autotune_main())
    sys.exit(main())
