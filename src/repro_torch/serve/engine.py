"""Serving engine of the port: batched or chunked prefill, then decode
windows of ``decode_ticks`` ticks — or, with ``spec_decode``, one
draft-and-verify window at a time — over the ring or the paged KV cache
(counterpart of the reference's ``serve/engine.py``, its single-device
subset; DESIGN.md §6, §11, §14).

``make_serve_fns``, ``make_paged_prefill``, ``make_chunked_prefill``,
``make_fused_decode`` and ``make_spec_verify`` build the prefill, decode
and verify steps; ``Engine`` is the host-side loop that drives them: a
:class:`Scheduler` admits queued requests into free decode slots,
admitted prompts run through batched prefills (right-padded prompts, one
call per length bucket — or, under a matmul policy or for MoE, one per
wave — KV written per slot into the cache, prefill logits seeding each
request's first token) or, with ``prefill_chunk``, through one chunk per engine step
between decode windows, and each window decodes and samples every active
slot ``decode_ticks`` times with finish detection on the device and one
host drain.  On the card a policy-free window is one CUDA-graph replay
(:class:`WindowGraphs`).  A model with recurrent state (SSD, RG-LRU)
and the encoder-decoder serve on the ring only and prefill by the scanned
prefill, one decode step a prompt position, on the card replayed from one
captured step (:class:`PrefillGraphs`); the encoder-decoder encodes each
slot's ``frames`` once, into the cache's static cross-KV.  Under a
``QuantPolicy`` every dense product is quantised (on the card through
the CUDA dither-matmul kernel) with the engine tick as its counter.
Per-request :class:`SamplingParams` drive greedy/temperature/top-k
sampling, EOS/stop handling and the per-request dither-counter offsets.

Two KV layouts:

* ``ring`` — one ring per slot; slots are preempted at ``max_len`` and
  recycled.
* ``paged`` — one shared block pool (:class:`KVPool` on the host, per-layer
  pools plus a trash block on the device, ``block_tables`` (B, nbmax)
  mapping each slot's logical blocks to physical ones).  Continuous
  batching admits while the pool has blocks; sealed blocks are
  content-addressed, so a prompt whose leading blocks another request
  already wrote shares them and prefills only its suffix; a slot that
  runs the pool dry is preempted with its blocks intact and resumed
  later; a deadlock breaker makes queued block holders re-prefill.

PyTorch runs eagerly, so the reference's jitted dispatches become plain
calls (or, for the policy-free decode window on the card, graph replays);
the per-slot sampling state, the last sampled tokens and the block tables
stay on the device and are re-uploaded only when they change, and the
cache is updated in place.

Fault tolerance and observability (DESIGN.md §10, §12, §13), as the
reference's: per-request deadlines, a queue TTL, a bounded queue with a
shed policy, degradation under pool pressure (single-tick windows, prefix
insertion paused), a straggler watchdog, five ``FailureInjector`` crash
points, atomic JSON snapshots every ``snapshot_every`` windows and
:meth:`Engine.restore`, which re-materialises the device KV bit for bit
(policy-free and deterministic-scheme serving); :class:`Metrics` counters,
gauges and TTFT/ITL histograms, and :class:`Tracer` spans, all host-side.
On the card the restore refills the cache's own tensors, so the captured
decode graphs stay valid.

``Engine(..., mesh=...)`` serves sharded over a ('data', 'model')
``DeviceMesh`` (DESIGN.md §9), SPMD: one process per shard, each running
this same host loop over the global slot table — the scheduler, every
data shard's host ``KVPool``, the stats, metrics and snapshot are
replicated — while its device holds only its data shard's B/dp slot rows
(or its shard's pool blocks) and its model shard's KV heads.  QKV is
column-parallel, the heads are all-gathered before a replicated W_O
(``dist.ctx.gather_heads``), and after every prefill call, decode window
and verify window the per-row outputs are all-gathered over 'data'
(``dist.ctx.gather_rows``), so every rank's host mirrors stay equal.  No
contraction is split, so for policy-free bf16 and int8 serving the
sharded stream is the single-device stream bit for bit.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import interop
from repro_torch.dist import ctx as dist_ctx
from repro_torch.dist import sharding as dist_sharding
from repro_torch.dist.fault_tolerance import StragglerWatchdog
from repro_torch.kernels import autotune
from repro_torch.kernels.paged_decode_attention import MAX_BLOCK_SIZE
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.serve.draft import Drafter, PromptLookupDrafter
from repro_torch.serve.graphs import (PrefillGraphs, WindowGraphs,
                                     cache_view)
from repro_torch.serve.kvpool import KVPool
from repro_torch.serve.metrics import Metrics
from repro_torch.serve.sampling import SamplingParams, sample_tokens
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.trace import Tracer

__all__ = ["make_serve_fns", "make_decode_and_sample", "make_fused_decode",
           "make_paged_prefill", "make_chunked_prefill", "make_spec_verify",
           "Engine", "Request", "SamplingParams", "Scheduler", "KVPool",
           "Metrics", "Tracer", "WindowGraphs", "PrefillGraphs",
           "mesh_layout"]


def mesh_layout(cfg: ModelConfig, batch: int, mesh
                ) -> Tuple[int, int, bool, ModelConfig]:
    """How the engine serves ``cfg`` with ``batch`` slots on ``mesh``
    (DESIGN.md §9): (dp, tp, whether the KV heads shard on 'model', the
    local config the model code sees).  Slots partition on 'data'; the
    heads shard when ``dist.sharding.serve_heads_shardable`` says so
    (head counts scaled down, head_dim pinned so ``cfg.hd()`` is
    unchanged), else they stay replicated.  Raises ``ValueError`` for
    what the sharded engine does not serve: recurrent state or an
    encoder, and a batch the data axis does not divide."""
    sizes = dist_ctx.mesh_sizes(mesh)
    dp, tp = int(sizes.get("data", 1)), int(sizes.get("model", 1))
    if not registry.supports_batched_prefill(cfg):
        raise ValueError(
            "mesh serving requires an attention-only decoder "
            f"(arch {cfg.name!r} has recurrent state / an encoder)")
    if batch % dp:
        raise ValueError(f"batch {batch} must be a multiple of the "
                         f"mesh's data axis ({dp})")
    sharded = dist_sharding.serve_heads_shardable(cfg, tp)
    local = (_dc_replace(cfg, n_heads=cfg.n_heads // tp,
                         n_kv_heads=cfg.n_kv_heads // tp, head_dim=cfg.hd())
             if sharded else cfg)
    return dp, tp, sharded, local


def _resolved(policy):
    """``policy.resolved()`` once at build, as the reference's builders do
    (an engine passes a policy it already resolved for its device)."""
    return policy.resolved() if policy is not None else None


def make_serve_fns(cfg: ModelConfig, policy=None, *, max_len: int,
                   kv_quant: bool = False, cross=None, attn_block=None):
    """The two serving steps: ``prefill_step(params, tokens, lengths,
    kv_offset, counter)`` maps a right-padded (B, S) prompt batch and its
    (B,) true lengths to the last-prompt-token logits and a ring cache whose
    positions equal ``lengths``; ``decode_step(params, token, cache,
    kv_offset, counter)`` is one token for every slot.  Under an enabled
    ``policy`` every dense product is quantised with the given counter.
    The encoder-decoder's prefill starts from a fresh self-KV sharing
    ``cross``, a cache's cross-KV (the engine's: the reference encodes
    its frames again at every call, to the same values).  ``attn_block``:
    the ring attention kernel's tile (``Engine.attn_block``; None: the
    dispatcher's default), in decode and the scanned prefill."""
    policy = _resolved(policy)

    def prefill_step(params, tokens, lengths, kv_offset=None, counter=0):
        cache0 = None
        if cfg.is_encdec:
            cache0 = registry.make_cache(params, cfg, tokens.shape[0],
                                         max_len, device=tokens.device,
                                         cross=cross)
        return registry.apply_prefill(
            params, cfg, tokens, lengths, max_len, policy=policy,
            counter=counter, kv_quant=kv_quant, kv_offset=kv_offset,
            cache0=cache0, attn_block=attn_block)

    def decode_step(params, token, cache, kv_offset=None, counter=0):
        return registry.apply_decode(params, cfg, token, cache, policy=policy,
                                     counter=counter, kv_offset=kv_offset,
                                     attn_block=attn_block)

    return prefill_step, decode_step


def make_decode_and_sample(cfg: ModelConfig, policy=None):
    """``decode_and_sample(params, token, cache, kv_offset, counter, temps,
    topks, seeds, counters)`` → ``(tokens (B,) int32, counters + 1,
    cache)``: the model decode step and the per-slot sampler in one call."""
    policy = _resolved(policy)

    def decode_and_sample(params, token, cache, kv_offset, counter,
                          temps, topks, seeds, counters):
        logits, new_cache = registry.apply_decode(
            params, cfg, token, cache, policy=policy, counter=counter,
            kv_offset=kv_offset)
        toks = sample_tokens(logits, temps, topks, seeds, counters)
        return toks, counters + 1, new_cache

    return decode_and_sample


def make_fused_decode(cfg: ModelConfig, policy=None, *, n_ticks: int = 1,
                      attn_block=None):
    """The engine's decode window: ``fused_decode(params, token, cache,
    kv_offset, counter, temps, topks, seeds, counters, alive, budgets,
    stops)`` runs ``n_ticks`` decode-and-sample ticks (the reference's
    ``lax.scan`` as a loop over j, tick j's counter ``counter + j``) and
    returns ``(tokens (n_ticks, B), last_token (B,), counters, cache)``.
    Finish detection runs on the device as the ``alive`` mask: a slot dies
    when its sampled token is in its ``stops`` row ((B, W) int32, -1
    padded, EOS folded in) or once it has emitted ``budgets[b]`` tokens in
    the window.  Dead and idle rows still run but are inert: their token,
    sampling counter and cache position freeze and, on a paged cache,
    their block-table rows read as the trash block, so their writes land
    there.  In a model with recurrent state they also keep their state
    and ring contents (``decode_step``'s ``active``): a step cannot be
    undone there, and a capture's warm-up or a restore's replay runs
    rows that must not move (the reference freezes only the position, as
    the port does for the encoder-decoder, a ring model).
    A live slot's ops are those of a one-tick window, so a window of n
    ticks is n single ticks bit for bit.  The cache's layer tensors are
    written in place.  ``attn_block``: the ring attention kernel's tile."""
    policy = _resolved(policy)
    recurrent = not registry.supports_batched_prefill(cfg) \
        and not cfg.is_encdec
    n_ticks = int(n_ticks)
    if n_ticks < 1:
        raise ValueError(f"n_ticks must be >= 1, got {n_ticks}")

    def fused_decode(params, token, cache, kv_offset, counter, temps, topks,
                     seeds, counters, alive, budgets, stops):
        paged = "block_tables" in cache
        emitted = torch.zeros_like(counters)
        out = []
        for j in range(n_ticks):
            pos0 = cache["pos"]
            step_cache = cache
            if paged:
                step_cache = dict(cache)
                step_cache["block_tables"] = torch.where(
                    alive[:, None], cache["block_tables"],
                    _trash_id(cache)).to(torch.int32)
            logits, new_cache = registry.apply_decode(
                params, cfg, token, step_cache, policy=policy,
                counter=counter + j, kv_offset=kv_offset,
                active=alive if recurrent else None, attn_block=attn_block)
            toks = sample_tokens(logits, temps, topks, seeds, counters)
            toks = torch.where(alive, toks, token)
            new_cache["pos"] = torch.where(alive, new_cache["pos"], pos0)
            if paged:
                new_cache["block_tables"] = cache["block_tables"]
            counters = torch.where(alive, counters + 1, counters)
            emitted = emitted + alive.to(torch.int32)
            hit = torch.any(toks[:, None] == stops, dim=1)
            alive = alive & ~hit & (emitted < budgets)
            token, cache = toks, new_cache
            out.append(toks)
        return torch.stack(out), token, counters, cache

    return fused_decode


def make_spec_verify(cfg: ModelConfig, policy=None, *, draft_k: int,
                     fused_ops=frozenset(), attn_block=None):
    """The speculative verify step: ``spec_verify(params, drafts, cache,
    kv_offset, counter, temps, topks, seeds, counters, alive, wcap)`` scores
    ``draft_k`` positions per slot in one call and returns ``(sampled (B, K)
    int32, cache)``.  ``drafts[:, 0]`` is each slot's last committed token
    and ``drafts[:, 1:]`` the drafter's proposals; ``sampled[:, t]`` is what
    the sampler — stateless in (seed, counter) — draws from row t's logits
    with counter ``counters + t``, at decode's (B, vocab) shape, so it is
    the plain tick's draw whenever rows 1..t matched.  All K positions are
    written in place up to each row's ``wcap``; ``pos`` does not advance
    (``registry.spec_commit`` follows).  Rows that are not ``alive`` write
    nothing: on a paged cache their block tables read as the trash block.
    ``fused_ops``: the verify forward's library ops to run over all K rows
    at once (``registry.verify_row_purity``); the rest run per row.
    ``attn_block``: the ring tile, the decode window's (verify row t is
    decode at pos + t only at decode's tile)."""
    policy = _resolved(policy)

    def spec_verify(params, drafts, cache, kv_offset, counter, temps, topks,
                    seeds, counters, alive, wcap):
        step_cache = cache
        if "block_tables" in cache:
            step_cache = dict(cache)
            step_cache["block_tables"] = torch.where(
                alive[:, None], cache["block_tables"],
                _trash_id(cache)).to(torch.int32)
        logits, new_cache = registry.apply_verify(
            params, cfg, drafts, step_cache, policy=policy, counter=counter,
            kv_offset=kv_offset, alive=alive, wcap=wcap, fused_ops=fused_ops,
            attn_block=attn_block)
        if "block_tables" in cache:
            new_cache["block_tables"] = cache["block_tables"]
        sampled = torch.stack(
            [sample_tokens(logits[:, t].contiguous(), temps, topks, seeds,
                           counters + t) for t in range(draft_k)], dim=1)
        return sampled, new_cache

    return spec_verify


def _trash_id(cache) -> int:
    """The paged pool's trash block id: its leading dim is blocks + 1."""
    if cache["layers"]:
        return cache["layers"][0]["k"].shape[1] - 1
    return cache["remainder"][0]["k"].shape[0] - 1


def make_chunked_prefill(cfg: ModelConfig, policy=None, *,
                         kv_quant: bool = False):
    """The chunked ring prefill step: ``chunked_prefill(params, tokens,
    lengths, starts, cache, kv_offset, counter)`` runs one batched forward
    over per-slot prompt *chunks* at absolute positions ``starts + t``,
    joins each slot's already-written ring history inside attention,
    merges the chunk K/V into the live ring cache in place and returns
    ``(last_chunk_logits, cache)``.  The paged engine needs none:
    ``make_paged_prefill`` takes block-aligned ``starts``, so a paged chunk
    is a suffix call."""
    policy = _resolved(policy)

    def chunked_prefill(params, tokens, lengths, starts, cache, kv_offset,
                        counter):
        return registry.apply_prefill_chunked(
            params, cfg, tokens, lengths, starts, cache, policy=policy,
            counter=counter, kv_quant=kv_quant, kv_offset=kv_offset)

    return chunked_prefill


def make_paged_prefill(cfg: ModelConfig, policy=None, *,
                       kv_quant: bool = False):
    """The paged prefill step: ``paged_prefill(params, tokens, lengths,
    starts, block_tables, cache, kv_offset, counter, prefix_blocks=...)``
    runs one batched forward over the prompt *suffixes*, writes their K/V
    into the pool blocks named by ``block_tables`` (in place) and returns
    ``(last_logits, cache)``.  ``prefix_blocks`` is 0 on cold waves —
    exactly the cold batched prefill — or the table width when an admitted
    request hit the prefix cache."""
    policy = _resolved(policy)

    def paged_prefill(params, tokens, lengths, starts, block_tables, cache,
                      kv_offset, counter, *, prefix_blocks: int = 0):
        return registry.apply_prefill_paged(
            params, cfg, tokens, lengths, starts, block_tables, cache,
            policy=policy, counter=counter, kv_quant=kv_quant,
            kv_offset=kv_offset, prefix_blocks=prefix_blocks)

    return paged_prefill


@dataclass
class Request:
    """One generation request.

    Lifecycle: ``queued`` → (scheduler admits) → [``prefilling`` →]
    ``active`` → ``done`` with ``finish_reason`` ∈ {"eos", "stop",
    "length", "preempted", "rejected", "deadline", "shed"}; a paged
    request preempted for blocks goes back to ``queued`` and resumes
    later.  ``sampling`` carries the per-request decode controls;
    ``max_new`` overrides ``sampling.max_new``.  ``stream`` (if set) is
    called as ``stream(request, token)`` for every emitted token.  Timing
    fields are host-clock seconds: ``ttft`` = time-to-first-token from
    submission, ``itl`` = inter-token latencies.  ``deadline_s`` is a
    budget from submission, measured on the engine's clock (``_now``): the
    engine expires the request — queued or running — once it elapses,
    checked once per window with no device work (DESIGN.md §12).
    """

    rid: int
    prompt: List[int]
    sampling: SamplingParams = field(default_factory=SamplingParams)
    priority: int = 0
    max_new: Optional[int] = None
    deadline_s: Optional[float] = None
    stream: Optional[Callable[["Request", int], None]] = None
    out: List[int] = field(default_factory=list)
    done: bool = False
    finish_reason: Optional[str] = None
    state: str = "new"
    t_submit: Optional[float] = None
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    itl: List[float] = field(default_factory=list)
    # paged-pool lifecycle state (engine-internal): a preempted request's
    # frozen decode position / pending input token (blocks stay in the
    # pool, so re-admission resumes instead of re-prefilling), and the
    # count of its pool blocks sealed into the prefix cache so far
    _resume: Optional[dict] = None
    _sealed: int = 0
    # prefill progress (engine-internal): tokens of the prompt already
    # written to the cache while state == "prefilling"
    _pf_pos: int = 0
    # where this request's own prefill began: the prefix-hit tokens at its
    # (paged) admission, 0 otherwise — restore replays its prefill chunks
    # from here (a snapshot key the reference does not write; 0 if absent)
    _pf_start: int = 0

    @property
    def ttft(self) -> Optional[float]:
        if self.t_first is None or self.t_submit is None:
            return None
        return self.t_first - self.t_submit

    def effective_max_new(self) -> int:
        return self.max_new if self.max_new is not None else self.sampling.max_new


def _bucket(n: int) -> int:
    """Round a prompt length up to a power of two (≥ 8), as the reference
    does, so the padded prefill batches have the same shapes."""
    b = 8
    while b < n:
        b *= 2
    return b


@dataclass
class _WindowPlan:
    """One decode window's host rows: ticks, the active (slot, request)
    pairs, and the (B,) alive mask, (B,) budgets and (B, W) stop rows."""
    n: int
    active: list
    alive: np.ndarray
    budgets: np.ndarray
    stops: np.ndarray
    stop_sets: dict


@dataclass
class _Unit:
    """An admission whose KV :meth:`Engine.restore` rebuilds: a slot's, a
    queued block holder's, or a *ghost*'s — the admission that wrote
    blocks other requests read in their shared prefix or that sit in the
    prefix cache, when its request no longer holds them (finished,
    requeued to re-prefill, or re-admitted since).  ``row`` is its slot
    (None: any free row of a call), ``table`` its pool blocks (None on the
    ring; a ghost's blocks gone from the pool are free blocks used as
    scratch), ``pieces`` its prefill calls' [start, end) in order, ``gen``
    the tokens replayed from ``pf_end`` on, ``level`` its place in the
    order of writes: the blocks it reads are written by lower levels;
    ``shard`` the data shard whose pool (and rows) it uses."""
    req: "Request"
    row: Optional[int]
    table: Optional[list]
    seq: list
    pieces: list
    gen: list
    pf_start: int
    pf_end: int
    ghost: bool = False
    level: int = 0
    shard: int = 0


def _prefill_groups(rows: dict) -> List[List[int]]:
    """Slots of one admission wave, grouped by (padded length bucket, prefix
    hit or not) — ``rows`` maps slot → (tokens to prefill, has a prefix).
    Each group is one prefill call, so a request's prefill runs at a shape
    set by its own prompt, never by the other requests of its wave: on the
    card a longer padded batch can change the bits of every row (the
    library picks its summation order by shape), and which requests share
    a wave depends on when slots free up — which speculative decoding
    changes.  Groups come in ascending order."""
    groups: dict = {}
    for i, (n, hit) in sorted(rows.items()):
        groups.setdefault((_bucket(n), hit), []).append(i)
    return [groups[key] for key in sorted(groups)]



class Engine:
    """Host-side continuous-batching loop over the ring or the paged KV
    cache.

    Fixed decode batch B (the slot count).  Each :meth:`step`:

    1. asks the scheduler for requests to fill free slots; admitted prompts
       are right-padded into (B, S_bucket) batches, one batched prefill per
       length bucket, or per wave under a policy or for MoE
       (``_prefill_waves``), and
       the prefill logits seed each request's first sampled token.  The
       ring layout merges the
       prefill's cache rows into the admitted slots; the paged layout
       admits while the pool can supply blocks, shares cached prefix
       blocks and prefills only the suffix, and resumes preempted requests
       where they stopped.  With ``prefill_chunk`` a prompt enters
       ``prefill_chunk`` tokens per step instead (piggyback prefill,
       DESIGN.md §11): its slot stays ``prefilling``, out of the decode
       window, until its last chunk samples its first token;
    2. decodes and samples every active slot ``decode_ticks`` times in one
       window (:meth:`_decode_tick`): finish detection on the device, one
       host drain of the (n, B) tokens.  On the card without a policy the
       window is one CUDA-graph replay (:class:`WindowGraphs`); on the CPU
       or under a policy it runs eagerly;
    3. retires slots on EOS/stop tokens, ``max_new``, or ``max_len``
       (ring: preempted; paged: a 'length' stop), freeing them for the
       next admission wave.

    Any window length and any chunk size give the same streams as
    ``decode_ticks=1`` and whole-prompt prefill: a window replays the
    single tick's ops, and a chunk writes the codes whole-prompt prefill
    writes (its history join re-associates the softmax, so chunked logits
    agree to rounding).

    With ``spec_decode`` step 2 is a speculative window instead
    (:meth:`_spec_decode_tick`, eager): ``drafter`` (default
    :class:`PromptLookupDrafter`) proposes ``draft_k - 1`` tokens per slot,
    one verify call scores all ``draft_k`` positions, and the longest prefix
    the engine's own sampler agrees with is committed — the stream stays
    bit for bit the plain one.  It supersedes ``decode_ticks``.

    ``device`` is where the cache and the per-slot state live; ``params``
    must be there already.  Paged knobs: ``block_size`` (default from the
    autotuner, ``autotune.best_block("paged_attention", ...)`` as the
    reference's engine takes it: a sweep's cached winner, else the
    reference's rule over the card's candidates — the largest of 8, 16,
    32, 64 that gives a full-length request at least 4 blocks, so 64 at
    ``max_len`` ≥ 256, where ring == paged holds bit for bit on the card
    at the ring's default tile, and the reference's pick at the reduced
    config; the CUDA paged kernel takes 1 ≤ block_size ≤ 64),
    ``num_blocks`` (default batch × ceil(max_len / block_size), the dense
    ring's token count) and ``prefix_cache`` (on
    only without a matmul policy or under its deterministic scheme, as the
    reference's).  ``prefill_chunk`` is clamped to the ring's capacity, or
    rounded down to a multiple of the block size (at least one block).

    ``policy``: a ``QuantPolicy`` for every dense product, resolved once
    for ``device``; its counter is ``tick`` (+ j within a window).
    Speculative decoding refuses an enabled policy.

    Fault tolerance (DESIGN.md §12), the reference's knobs: per-request
    deadlines and a queue TTL (``queue_ttl_s``) expire stale work once per
    window, on the engine's clock ``_now`` (injectable); ``queue_cap``
    bounds the queue with a ``shed_policy`` ('reject-new' /
    'evict-lowest-priority'); pool pressure past ``degrade_high`` steps
    the decode window down to single ticks and pauses prefix-cache
    insertion until pressure clears past ``degrade_low``
    (``degrade_high=None``, which the reference lacks, never degrades);
    ``watchdog``
    (default a :class:`StragglerWatchdog`) flags slow windows;
    ``injector`` crashes the step at its five points; with
    ``snapshot_path`` every ``snapshot_every``-th window persists
    :meth:`snapshot`, and :meth:`restore` continues bit for bit (for MoE
    it rebuilds as the reference's restore does, see there).
    Observability (DESIGN.md §10, §13): ``metrics`` (a :class:`Metrics`
    or a sink spec) and ``trace`` (a :class:`Tracer` or a spec such as
    ``"mem"``), host-side only.
    """

    SHED_POLICIES = ("reject-new", "evict-lowest-priority")

    def __init__(self, params, cfg: ModelConfig, batch: int, max_len: int,
                 policy=None, kv_quant: bool = False,
                 scheduler: Union[str, Scheduler] = "fcfs",
                 kv_layout: str = "ring", *, device="cuda",
                 block_size=None, num_blocks=None, prefix_cache: bool = True,
                 mesh=None, metrics=None, trace=None, decode_ticks: int = 1,
                 prefill_chunk=None, queue_cap=None,
                 shed_policy: str = "reject-new", queue_ttl_s=None,
                 injector=None,
                 watchdog: Union[None, bool, StragglerWatchdog] = True,
                 snapshot_path: Optional[str] = None,
                 snapshot_every: int = 1,
                 degrade_high: Optional[float] = 0.90,
                 degrade_low: float = 0.70,
                 spec_decode: bool = False, draft_k: int = 4,
                 drafter: Optional[Drafter] = None, frames=None):
        if kv_layout not in ("ring", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        self.decode_ticks = int(decode_ticks)
        if self.decode_ticks < 1:
            raise ValueError(f"decode_ticks must be >= 1, got {decode_ticks}")
        if prefill_chunk is not None:
            prefill_chunk = int(prefill_chunk)
            if prefill_chunk < 1:
                raise ValueError("prefill_chunk must be >= 1 (or None)")
            if not registry.supports_chunked_prefill(cfg):
                raise ValueError("chunked prefill requires an attention-only "
                                 f"decoder; {cfg.name!r} is not one")
        self.prefill_chunk = prefill_chunk
        # speculative decoding (DESIGN.md §14): each gate protects the
        # bitwise stream contract, and raises as the reference's does
        self.spec_decode = bool(spec_decode)
        self.draft_k = int(draft_k)
        self.drafter = (drafter if drafter is not None
                        else PromptLookupDrafter())
        if self.spec_decode:
            if self.draft_k < 2:
                raise ValueError(f"draft_k must be >= 2, got {draft_k}")
            if not registry.supports_spec_decode(cfg):
                raise ValueError(
                    "spec_decode requires an attention-only decoder without "
                    f"MoE; {cfg.name!r} is not one (SSM/RG-LRU recurrences "
                    "have no multi-token verify form, and MoE capacity ranks "
                    "couple a verify row to its own future draft positions)")
            if policy is not None and getattr(policy, "enabled", True):
                raise ValueError(
                    "spec_decode requires policy=None: the activation "
                    "quantiser's tensor-global absmax couples verify rows, "
                    "so they would not be bitwise the sequential steps")
            if kv_layout == "ring" and cfg.window and cfg.window < max_len:
                raise ValueError(
                    "spec_decode over the ring layout needs ring capacity "
                    f"= max_len; window={cfg.window} < max_len={max_len} "
                    "would let the verify forward overwrite positions its "
                    "own earlier rows still attend (use kv_layout='paged')")
            if kv_layout == "ring" and self.draft_k > max_len:
                raise ValueError(f"draft_k={draft_k} exceeds the ring's "
                                 f"{max_len} slots")
        if kv_layout == "paged" and not registry.supports_paged_kv(cfg):
            raise ValueError("kv_layout='paged' requires an attention-only "
                             f"decoder; {cfg.name!r} is not one")
        # fault-tolerance / overload knobs (DESIGN.md §12), checked as the
        # reference checks them
        if shed_policy not in self.SHED_POLICIES:
            raise ValueError(f"unknown shed_policy {shed_policy!r}; expected "
                             f"one of {self.SHED_POLICIES}")
        if queue_cap is not None and int(queue_cap) < 1:
            raise ValueError(f"queue_cap must be >= 1 (or None), got "
                             f"{queue_cap}")
        if degrade_high is not None and \
                not (0.0 < degrade_low <= degrade_high <= 1.0):
            raise ValueError("need 0 < degrade_low <= degrade_high <= 1, got "
                             f"({degrade_low}, {degrade_high})")
        self.queue_cap = None if queue_cap is None else int(queue_cap)
        self.shed_policy = shed_policy
        self.queue_ttl_s = queue_ttl_s
        self.injector = injector
        self.watchdog = (StragglerWatchdog() if watchdog is True
                         else (watchdog or None))
        self.snapshot_path = snapshot_path
        self.snapshot_every = max(1, int(snapshot_every))
        self.degrade_high, self.degrade_low = degrade_high, degrade_low
        self._degraded = False
        self._now = time.time          # injectable clock (deadline tests)
        self._steps_since_snap = 0
        self._step_tick = 0            # tick at window start (injector key)
        self._last_window_s = 0.0
        self.device = torch.device(device)
        pdev = params["embed"].device
        if pdev.type != self.device.type or (
                self.device.index is not None
                and pdev.index != self.device.index):
            raise ValueError(f"params live on {pdev}, engine device is "
                             f"{self.device}")
        self.cfg, self.batch, self.max_len = cfg, batch, max_len
        # ---- mesh layout (DESIGN.md §9, ``mesh_layout``): the model code
        # sees local shapes and this data shard's slot rows
        self.mesh = mesh
        self.dp = self.tp = 1
        self.heads_sharded, self._cfg_local = False, cfg
        self._data_group = self._model_group = None
        coord = {}
        if mesh is not None:
            self.dp, self.tp, self.heads_sharded, self._cfg_local = \
                mesh_layout(cfg, batch, mesh)
            coord = dist_ctx.mesh_coordinate(mesh)
            if self.dp > 1:
                self._data_group = mesh.get_group("data")
            if self.tp > 1:
                self._model_group = mesh.get_group("model")
        self._rows = batch // self.dp
        self._shard = coord.get("data", 0)
        self._lo = self._shard * self._rows
        self._head0 = (coord.get("model", 0) * self._cfg_local.n_kv_heads
                       if self.heads_sharded else 0)
        self._writer = not any(coord.values())       # rank (0, 0) writes
        self.params = (interop.shard_serve_params(params, cfg, coord, mesh)
                       if self.heads_sharded else params)
        params = self.params
        cfg_l = self._cfg_local
        # the encoder-decoder's audio, row i slot i's (a decoder-only model
        # ignores it, as the reference's does)
        self._frames = frames if cfg.is_encdec else None
        if cfg.is_encdec:
            want = (batch, cfg.n_enc_tokens, cfg.d_model)
            if frames is None or tuple(frames.shape) != want:
                raise ValueError(f"{cfg.name!r} needs frames of shape {want}, "
                                 f"got {getattr(frames, 'shape', None)}")
            if frames.device.type != self.device.type:
                raise ValueError(f"frames live on {frames.device}, engine "
                                 f"device is {self.device}")
        # the matmul policy, resolved once for this engine's device; its
        # counter is the engine tick ("rounding in time", §VII)
        policy = policy.resolved(self.device) if policy is not None else None
        self.policy = policy
        self.kv_quant = kv_quant
        self.kv_layout = kv_layout
        # the tracer first: it observes the autotuner's picks below
        self.trace = Tracer.from_spec(trace)
        # the paged layout's block pools, one per data shard (none on the
        # ring layout); every rank keeps all of them on the host
        self.pools: List[KVPool] = []
        self._rid_shard: dict = {}            # rid → data shard holding it
        if kv_layout == "paged":
            bs = int(block_size) if block_size is not None \
                else self._default_block_size()
            if bs < 1 or (self.device.type == "cuda" and bs > MAX_BLOCK_SIZE):
                raise ValueError(
                    f"block_size {bs} not in [1, {MAX_BLOCK_SIZE}] (the CUDA "
                    "paged kernel's tile is the pool block)")
            self.block_size = bs
            self.nbmax = -(-max_len // bs)
            if self.prefill_chunk is not None:
                # block-aligned, so every continuation chunk starts at a
                # block boundary (the paged prefill's contract)
                self.prefill_chunk = max(bs, self.prefill_chunk // bs * bs)
            # each data shard owns num_blocks / dp blocks (its admission
            # budget) plus its own trash block; block tables carry
            # shard-local physical ids
            total = (int(num_blocks) if num_blocks is not None
                     else batch * self.nbmax)
            self.num_blocks = -(-total // self.dp) * self.dp
            self._nb_local = self.num_blocks // self.dp
            # prefix reuse needs prefill numerics that depend only on token
            # identity + absolute position: no matmul policy, or the
            # counter-independent deterministic scheme (the int8 KV
            # quantiser's per-request offset seeds the hash chain)
            prefix = bool(prefix_cache) and (
                policy is None or policy.scheme == "deterministic")
            self.pools = [KVPool(self._nb_local, bs, prefix_cache=prefix)
                          for _ in range(self.dp)]
            self._trash = self._nb_local
            self.cache = self._make_cache()
            self._bt = np.full((batch, self.nbmax), self._trash, np.int32)
            self._bt_dirty = True
            self._prefill_paged = make_paged_prefill(cfg_l, policy,
                                                     kv_quant=kv_quant)
            self.attn_block = None
        else:
            self.cache = self._make_cache()
            self.attn_block = self._ring_tile()
            self._prefill, _ = make_serve_fns(cfg_l, policy, max_len=max_len,
                                              kv_quant=kv_quant,
                                              cross=self.cache.get("cross"),
                                              attn_block=self.attn_block)
            if (not registry.supports_batched_prefill(cfg)
                    and self.device.type == "cuda"
                    and (policy is None or not policy.enabled)):
                # the scanned prefill of a recurrent model or the
                # encoder-decoder: one captured decode step, replayed once
                # per prompt position
                self._prefill = PrefillGraphs(params, cfg, self.cache,
                                              max_len, self.device,
                                              self.attn_block)
            if self.prefill_chunk is not None:
                # a chunk covers each ring slot at most once only while it
                # fits the ring
                ring_cap = min(cfg.window, max_len) if cfg.window else max_len
                self.prefill_chunk = min(self.prefill_chunk, ring_cap)
                self._prefill_chunked = make_chunked_prefill(
                    cfg_l, policy, kv_quant=kv_quant)
        # eager decode windows, one per window length
        self._fused_variants = {}
        # the policy-free decode window on the card: CUDA-graph replays,
        # fixed here (a policy's kernels take the tick as a host constant;
        # a speculative engine runs verify windows instead).  With heads
        # sharded the window holds the 'model' all-gather, which this port
        # does not capture (a gloo collective cannot be, and an NCCL capture
        # is unverified on one card): those windows run eagerly
        # (``window_mode``).  The 'data' gather sits outside the window.
        self._graphs: Optional[WindowGraphs] = None
        if (self.device.type == "cuda" and not self.spec_decode
                and (policy is None or not policy.enabled)
                and not self.heads_sharded):
            self._graphs = WindowGraphs(
                params, self.cache,
                lambda n: make_fused_decode(cfg_l, None, n_ticks=n,
                                            attn_block=self.attn_block))
        self.window_mode = "graph" if self._graphs is not None else "eager"
        self._spec = None
        # the verify forward's library ops that this device sums in the same
        # order over K rows as over decode's one: probed once at this
        # engine's shapes, they run fused; the others run per row
        self.verify_fused_ops = frozenset()
        if self.spec_decode:
            self.verify_fused_ops = frozenset(
                op for op, n in registry.verify_row_purity(
                    params, cfg_l, self._rows, self.draft_k).items()
                if n == 0)
            self._spec = make_spec_verify(cfg_l, policy, draft_k=self.draft_k,
                                          fused_ops=self.verify_fused_ops,
                                          attn_block=self.attn_block)
        # per-window write budget of each paged slot (``_pre_decode_paged``)
        self._paged_cap = {}
        # the teacher-forced replay step of a restore, built on first use
        self.last_restore = None

        self.scheduler = (Scheduler(scheduler) if isinstance(scheduler, str)
                          else scheduler)
        self.slots: List[Optional[Request]] = [None] * batch
        self.finished: List[Request] = []
        self.tick = 0
        # per-slot state: host mirrors for bookkeeping, plus device copies
        # refreshed only when slot membership changes (admission)
        self._last_token = np.zeros((batch,), np.int32)
        self._slot_pos = np.zeros((batch,), np.int64)
        self._temps = np.zeros((batch,), np.float32)
        self._topks = np.zeros((batch,), np.int32)
        self._seeds = np.zeros((batch,), np.int32)
        self._offsets = np.zeros((batch,), np.int32)
        self._counters = np.zeros((batch,), np.int32)
        self._dev = {}
        self._dev_dirty = True
        # speculative windows count in decode_calls; the spec_* counts
        # stand here as well as in the metrics' counters
        self.stats = {"prefill_s": 0.0, "prefill_tokens": 0,
                      "prefill_calls": 0, "decode_s": 0.0,
                      "decode_tokens": 0, "decode_calls": 0,
                      "prefix_hit_tokens": 0, "preemptions": 0,
                      "spec_windows": 0, "spec_draft_tokens": 0,
                      "spec_accepted_tokens": 0, "spec_emitted_tokens": 0,
                      "eager_windows": 0}
        # sealed pool block → (writer rid, logical index, and the writing
        # admission's prefill start and end): what restore needs to rebuild
        # a shared or cached block whose writer no longer holds it
        self._block_src = [{} for _ in self.pools]
        # observability (DESIGN.md §10, §13): host-side counters, per-window
        # gauges and TTFT/ITL histograms behind a buffered crash-isolated
        # sink; span timelines, off unless ``trace`` is given
        self.metrics = (metrics if isinstance(metrics, Metrics)
                        else Metrics(sink=metrics))
        if self.trace.enabled:
            # queue/block provenance rides the tracer's event feed; the
            # hooks stay None (and cost nothing) on an untraced engine
            self.scheduler.on_event = self.trace.event
            for pool in self.pools:
                pool.on_event = self.trace.event

    def _default_block_size(self) -> int:
        """The paged pool's block when none is given: the autotuner's
        (``best_block("paged_attention", (batch, max_len, n_kv, group,
        hd), ...)``, the reference engine's key and rule)."""
        cfg = self.cfg
        nkv = max(1, cfg.n_kv_heads)
        shape = (self.batch, self.max_len, nkv, max(1, cfg.n_heads // nkv),
                 cfg.hd())
        backend = "cuda" if self.device.type == "cuda" else "torch-ref"
        return autotune.best_block(
            "paged_attention", shape, "int8" if self.kv_quant else "bfloat16",
            8 if self.kv_quant else 16, "flash", backend)[0]

    def _ring_tile(self) -> Optional[tuple]:
        """The ring attention kernels' tile ``(bk,)``, read once from the
        autotuner (``best_block("decode_attention", ...)`` at this engine's
        rows and its cache's shape: a sweep's cached winner, else the
        largest tile of at most 64 slots dividing the cap) and held for the
        engine's life, so that its captured windows and prefill graph,
        its verify windows (verify row t ≡ decode at pos + t needs decode's
        tile) and a restore's replay all run one tile.  None on the CPU,
        where the plain version runs the reference's whole-cap
        recurrence, and where no layer has a ring."""
        if self.device.type != "cuda":
            return None
        rings = [e["k"] for e in self.cache["layers"] + self.cache["remainder"]
                 if "k_pos" in e]
        if not rings:
            return None
        k = rings[0]
        cap, nkv, hd = k.shape[-3:]
        cfg = self._cfg_local
        quantized = k.dtype == torch.int8
        return autotune.best_block(
            "decode_attention",
            (self._rows, cap, nkv, cfg.n_heads // cfg.n_kv_heads, hd),
            k.dtype, 8 if quantized else 16, "flash", "cuda")

    def _make_cache(self):
        """A fresh decode cache of this engine's layout on its device: this
        rank's data shard's rows (its pool blocks) and model shard's
        heads."""
        if self.kv_layout == "paged":
            return registry.make_cache(
                self.params, self._cfg_local, self._rows, self.max_len,
                kv_quant=self.kv_quant, kv_layout="paged",
                block_size=self.block_size, num_blocks=self._nb_local,
                device=self.device)
        return registry.make_cache(self.params, self._cfg_local, self._rows,
                                   self.max_len, self._frames,
                                   policy=self.policy, kv_quant=self.kv_quant,
                                   device=self.device)

    def _scope(self):
        """The serve shard scope of this rank's device work (DESIGN.md §9):
        global head offset for the KV quantiser, the 'model' group for the
        head all-gather."""
        return dist_ctx.serve_shard_scope(head0=self._head0,
                                          heads_sharded=self.heads_sharded,
                                          group=self._model_group)

    # ------------------------------------------------------ pool aggregates

    @property
    def pool(self) -> Optional[KVPool]:
        """Data shard 0's block pool — the whole pool on a one-shard
        engine; :attr:`pools` / :meth:`pool_stats` for every shard."""
        return self.pools[0] if self.pools else None

    def pool_stats(self) -> dict:
        """Allocator stats summed across the per-data-shard pools, plus the
        aggregate ``live``/``cached`` block counts."""
        agg = {"live": 0, "cached": 0}
        for p in self.pools:
            for k, v in p.stats.items():
                agg[k] = agg.get(k, 0) + v
            agg["live"] += p.live_blocks
            agg["cached"] += p.cached_blocks
        return agg

    def _slot_shard(self, i: int) -> int:
        return i // self._rows

    def _pool_of(self, rid: int) -> KVPool:
        return self.pools[self._rid_shard[rid]]

    def _mine(self, i: int) -> bool:
        """Is slot ``i`` on this rank's data shard?"""
        return self._slot_shard(i) == self._shard

    # ------------------------------------------------------------------ API

    def reset_stats(self):
        """Zero the throughput counters *and* the metrics surface (a
        warm-up wave's numbers stay out of the measured ones)."""
        self.stats = {k: type(v)() for k, v in self.stats.items()}
        self.metrics.reset()

    def submit(self, req: Request):
        """Enqueue a request (FCFS or priority order, per the scheduler),
        applying overload admission control when ``queue_cap`` is set: a
        full queue either sheds the newcomer ('reject-new') or evicts the
        queued request with the lowest priority — latest arrival among
        ties — when the newcomer outranks it ('evict-lowest-priority').
        Preempted requests re-enter through the scheduler's ``requeue`` and
        are never shed: they hold pool blocks and their place in line."""
        req.state = "queued"
        if req.t_submit is None:
            req.t_submit = time.time()
        self.trace.begin(req.rid, req.t_submit, priority=req.priority)
        if self.queue_cap is not None and \
                len(self.scheduler) >= self.queue_cap:
            victim = req
            if self.shed_policy == "evict-lowest-priority":
                lowest = min(self.scheduler.queued(),
                             key=lambda r: (r.priority, -r._arrival))
                if lowest.priority < req.priority:
                    self.scheduler.pop(lowest)
                    victim = lowest
            self._finish_queued(victim, "shed")
            if victim is req:
                return
        self.scheduler.submit(req)

    def explain(self, rid: int) -> dict:
        """Latency-attribution report for a traced request (DESIGN.md §13):
        wall time decomposed into queue / prefill / decode / preempt_stall /
        degraded / recovery shares that sum to 100%, with the dominant term
        named.  Needs ``trace=...``; raises ``KeyError`` for an unknown
        rid."""
        if not self.trace.enabled:
            raise RuntimeError("tracing is disabled; construct the Engine "
                               "with trace='mem' (or a sink spec) to explain "
                               "requests")
        return self.trace.explain(rid, now=self._now())

    def step(self) -> List[Request]:
        """One engine window: expire deadlines, admit + prefill, decode
        every active slot, observe the window's wall time, persist a
        snapshot.  Returns the requests still active.  The five
        ``injector`` crash points fire in this order, keyed on the tick at
        window start (``pool_alloc`` and ``mid_window`` inside the decode
        window); a crashed engine's host state is mid-mutation — discard
        it and restore a fresh engine from the snapshot
        (``run_serve_with_restarts``)."""
        with self._scope():
            return self._step()

    def _step(self) -> List[Request]:
        self._step_tick = self.tick
        t0 = self._now()
        self._maybe_fail("pre_admit")
        self._expire_deadlines()
        self._update_pressure()
        self._admit_and_prefill()
        if any(s is not None for s in self.slots):
            if self.spec_decode:
                self._spec_decode_tick()
            else:
                self._decode_tick()
        self._observe_window(self._now() - t0)
        self._maybe_fail("sink_write")
        self._record_tick_metrics()
        self._maybe_fail("post_drain")
        self._maybe_snapshot()
        return [s for s in self.slots if s is not None]

    def run(self, ticks: int) -> List[Request]:
        """Drive :meth:`step` until the queue and slots drain (or ``ticks``
        elapse); returns every request finished so far."""
        for _ in range(ticks):
            self.step()
            if not len(self.scheduler) and all(s is None for s in self.slots):
                break
        self.metrics.flush()          # drain the tail of the gauge buffer
        self.trace.flush()
        if self.snapshot_path is not None:
            self.write_snapshot(self.snapshot_path)
        return self.finished

    # ----------------------------------------- fault tolerance (DESIGN.md §12)

    def _maybe_fail(self, phase: str):
        """One injector crash point, keyed on the tick at window start so a
        chaos test can name any phase of a specific window."""
        if self.injector is not None:
            self.injector.maybe_fail(self._step_tick, phase)

    def _finish_queued(self, req: Request, reason: str):
        """Retire a request that never reaches a slot this time (shed at
        submission, or expired while queued).  A preempted block holder
        releases its blocks — expiry must not leak pool capacity."""
        if req.rid in self._rid_shard:
            self._pool_of(req.rid).release(req.rid)
            self._rid_shard.pop(req.rid)
        req._resume = None
        self._retire(req, reason)

    def _retire(self, req: Request, reason: str, t=None, **tags):
        """Mark ``req`` done with ``reason``: the finished list, the
        metrics' finish counters, the end of its trace timeline."""
        req.done, req.finish_reason, req.state = True, reason, "done"
        self.finished.append(req)
        self.metrics.inc("finished_requests")
        self.metrics.inc(f"finish_{reason}")
        self.trace.finish(req.rid, self._now() if t is None else t, reason,
                          **tags)

    def _expire_deadlines(self):
        """Expire overdue requests, once per window, *before* admission — a
        host-side scan over the queue and the slots, no device work (a
        cancelled running slot takes the normal finish path).  Queued
        requests expire on their own ``deadline_s`` or the engine-wide
        ``queue_ttl_s``; running ones only on their ``deadline_s`` (the
        TTL bounds queue staleness, not execution)."""
        ttl = self.queue_ttl_s
        now = self._now()

        def age(r):
            return now - (r.t_submit if r.t_submit is not None else now)

        for req in self.scheduler.queued():
            if (req.deadline_s is not None and age(req) > req.deadline_s) or \
                    (ttl is not None and age(req) > ttl):
                self.scheduler.pop(req)
                self._finish_queued(req, "deadline")
        for i, req in enumerate(self.slots):
            if req is not None and req.deadline_s is not None \
                    and age(req) > req.deadline_s:
                self._finish(i, req, "deadline")

    def _window_ticks(self) -> int:
        """The decode window length this step: ``decode_ticks``, stepped
        down to 1 while degraded (shorter windows = more frequent
        admission/preemption decisions under block scarcity).  Window
        length preserves the streams bit for bit (DESIGN.md §11); on the
        card the first degraded window captures a one-tick graph."""
        return 1 if self._degraded else self.decode_ticks

    def _update_pressure(self):
        """Graceful degradation under pool pressure (DESIGN.md §12), with
        hysteresis so the engine does not flap at the watermark: when live
        blocks cross ``degrade_high`` of capacity, decode windows drop to
        single ticks and prefix-cache *insertion* pauses (finished blocks
        return to the free list instead of lingering as cached copies;
        sealing resumes where it left off once pressure clears below
        ``degrade_low``).  Both leave the streams as they are."""
        if not self.pools or self.degrade_high is None:
            return
        share = sum(p.live_blocks for p in self.pools) / self.num_blocks
        if not self._degraded and share >= self.degrade_high:
            self._degraded = True
            self.metrics.inc("degrade_events")
            now = self._now()
            self.trace.event("degraded", t=now, tick=self.tick,
                             live_share=share)
            self.trace.set_degraded(True, now)
        elif self._degraded and share <= self.degrade_low:
            self._degraded = False
            now = self._now()
            self.trace.event("restored", t=now, tick=self.tick,
                             live_share=share)
            self.trace.set_degraded(False, now)

    def _observe_window(self, seconds: float):
        """Feed the straggler watchdog one window's wall time; a flagged
        window bumps the ``slow_windows`` counter and logs an event on the
        tracer's feed."""
        self._last_window_s = seconds
        if self.watchdog is not None and \
                self.watchdog.observe(self._step_tick, seconds):
            self.metrics.inc("slow_windows")
            self.trace.event("slow_window", tick=self._step_tick,
                             window_s=seconds)

    def _maybe_snapshot(self):
        if self.snapshot_path is None:
            return
        self._steps_since_snap += 1
        if self._steps_since_snap >= self.snapshot_every:
            self._steps_since_snap = 0
            self.write_snapshot(self.snapshot_path)

    def write_snapshot(self, path: str):
        """Atomically persist :meth:`snapshot` as JSON (tmp + ``os.replace``
        — a crash mid-write never corrupts the previous snapshot).  On a
        mesh every rank holds the same host truth: rank 0 writes, and the
        ranks meet after the write, so a restore on any rank reads it."""
        if self._writer:
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(self.snapshot(), fh)
            os.replace(tmp, path)
        if self.mesh is not None:
            dist_ctx.barrier()

    def _record_tick_metrics(self):
        """One per-window gauge record (DESIGN.md §10).  Every value is a
        host-side int/float the engine already tracks — scheduler depth,
        slot occupancy, the cumulative ``stats`` counters and the pool
        allocator's bookkeeping — so it adds no launch and no sync."""
        active = sum(1 for s in self.slots if s is not None)
        gauges = dict(
            queue_depth=len(self.scheduler),
            active_slots=active,
            batch_occupancy=active / self.batch,
            finished_total=len(self.finished),
            prefill_tokens=self.stats["prefill_tokens"],
            decode_tokens=self.stats["decode_tokens"],
            prefix_hit_tokens=self.stats["prefix_hit_tokens"],
            preemptions=self.stats["preemptions"],
            window_s=self._last_window_s,
            degraded=int(self._degraded),
        )
        if self.pools:
            ps = self.pool_stats()
            gauges.update(live_blocks=ps["live"], cached_blocks=ps["cached"],
                          free_blocks=sum(p.free_blocks for p in self.pools))
        self.metrics.tick(**gauges)
        self.trace.counters(t=self._now(), **gauges)

    # ------------------------------------------------------------ internals

    def _local(self, arr: np.ndarray) -> np.ndarray:
        """This rank's data shard's rows of a per-slot host array (B, …)."""
        return arr[self._lo:self._lo + self._rows]

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        """A copy of a per-slot host array (B, …) on the engine's device —
        this rank's data shard's rows — never a view of the host mirror,
        which ``_emit`` goes on updating."""
        return torch.tensor(self._local(arr), device=self.device)

    def _host(self, t: torch.Tensor, dim: int = 0) -> np.ndarray:
        """A per-slot device result (this shard's rows along ``dim``) → the
        global rows on the host, gathered over 'data' on a mesh (the
        host-state gather: every rank's host mirrors stay equal)."""
        return dist_ctx.gather_rows(t, self._data_group, dim).cpu().numpy()

    def _refresh_device_state(self):
        """Re-upload the per-slot sampling state and last tokens if any slot
        changed since the previous tick; a no-op in steady state."""
        if self._dev_dirty:
            self._dev = {
                "temps": self._tensor(self._temps),
                "topks": self._tensor(self._topks),
                "seeds": self._tensor(self._seeds),
                "offsets": self._tensor(self._offsets),
                "counters": self._tensor(self._counters),
                "last_token": self._tensor(self._last_token),
            }
            self._dev_dirty = False

    def _fused_for(self, n: int):
        """The eager decode window of ``n`` ticks, built on first use."""
        if n not in self._fused_variants:
            self._fused_variants[n] = make_fused_decode(
                self._cfg_local, self.policy, n_ticks=n,
                attn_block=self.attn_block)
        return self._fused_variants[n]

    def _prefill_waves(self, rows: dict) -> List[List[int]]:
        """The prefill calls of one admission wave (``rows``: slot → (tokens
        to prefill, has a prefix)).  Under an enabled matmul policy, and
        for a model with experts: one call for the whole wave at its
        longest prompt's bucket, as the reference makes.  A row's result
        depends on the other rows of its call either way: the quantiser's
        absmax, hash indices and pulse count cover every row, and MoE
        capacity ranks are a cumulative count over every token of the
        call, padding and idle rows included.  Splitting the wave would
        change streams against the reference's.  Otherwise one call per
        length bucket (``_prefill_groups``)."""
        if (self.policy is not None and self.policy.enabled) \
                or self.cfg.n_experts:
            return [sorted(rows)]
        return _prefill_groups(rows)

    def _prefill_wave_trace(self, t0, dt, group, lens, starts, chunk):
        """One prefill call on the trace: an engine-track ``prefill_wave``
        span and a ``prefill[c]`` span (c the chunk index) per request."""
        if not self.trace.enabled:
            return
        self.trace.wave(
            "prefill_wave", t0, t0 + dt,
            [(self.slots[i].rid,
              f"prefill[{int(starts[i]) // chunk if chunk else 0}]",
              {"slot": i, "tokens": int(lens[i])}) for i in group],
            tick=self._step_tick)

    def _admit_and_prefill(self):
        if self.kv_layout == "paged":
            return self._admit_and_prefill_paged()
        if self.prefill_chunk is not None:
            return self._admit_and_prefill_ring_chunked()
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free:
            return
        admitted = []
        for req in self.scheduler.admit(len(free)):
            if len(req.prompt) > self.max_len:
                self._retire(req, "rejected")
                continue
            admitted.append(req)
        if not admitted:
            return

        now = time.time()
        lens = np.zeros((self.batch,), np.int32)
        prompts = {}
        for req in admitted:
            i = free.pop(0)
            self.slots[i] = req
            req.state, req.t_admit = "active", now
            self.trace.phase(req.rid, "prefill", now, slot=i)
            prompts[i] = list(req.prompt) or [1]          # empty prompt → BOS
            lens[i] = len(prompts[i])
            self._set_slot_sampling(i, req)
            self._slot_pos[i] = lens[i]

        self._dev_dirty = True            # admission changed per-slot state
        self._refresh_device_state()
        first = np.zeros((self.batch,), np.int32)
        for group in self._prefill_waves({i: (len(p), False)
                                          for i, p in prompts.items()}):
            g_lens = np.zeros((self.batch,), np.int32)
            g_lens[group] = lens[group]
            toks = np.zeros((self.batch, _bucket(int(g_lens.max()))),
                            np.int32)
            for i in group:
                toks[i, : lens[i]] = prompts[i]
            t0, tw = time.perf_counter(), time.time()
            lens_dev = self._tensor(g_lens)
            last_logits, pf_cache = self._prefill(
                self.params, self._tensor(toks).long(), lens_dev,
                self._dev["offsets"], self.tick)
            self.cache = registry.merge_prefill(self._cfg_local, self.cache,
                                                pf_cache, lens_dev > 0)
            sampled = self._host(sample_tokens(
                last_logits, self._dev["temps"], self._dev["topks"],
                self._dev["seeds"], self._dev["counters"]))
            first[group] = sampled[group]
            dt = time.perf_counter() - t0
            self.stats["prefill_s"] += dt
            self.stats["prefill_tokens"] += int(g_lens.sum())
            self.stats["prefill_calls"] += 1
            self._prefill_wave_trace(tw, dt, group, g_lens, np.zeros_like(
                g_lens), None)

        now = time.time()
        for i in prompts:
            self._emit(i, self.slots[i], int(first[i]), now)
        # _emit advanced host counters / last tokens for the admitted slots;
        # re-sync the device copies before the first decode tick reads them
        self._dev_dirty = True

    def _admit_and_prefill_ring_chunked(self):
        """Piggyback prefill on the ring (DESIGN.md §11): admitted prompts
        enter ``prefill_chunk`` tokens per engine step, so a long prompt
        never stalls the running decodes for its whole length.  A slot
        stays ``prefilling`` — out of the decode window's alive mask —
        until its last chunk lands, which also samples its first token.
        The KV codes key on absolute position and the first token on the
        last chunk's logits, so the stream is the whole-prompt stream (to
        the rounding of the history join)."""
        chunk = self.prefill_chunk
        free = [i for i, s in enumerate(self.slots) if s is None]
        now = time.time()
        for req in self.scheduler.admit(len(free)):
            if len(req.prompt) > self.max_len:
                self._retire(req, "rejected", t=now)
                continue
            i = free.pop(0)
            self.slots[i] = req
            req.state, req.t_admit = "prefilling", now
            self.trace.phase(req.rid, "prefill", now, slot=i)
            req._pf_pos = req._pf_start = 0
            self._set_slot_sampling(i, req)
            self._slot_pos[i] = 0

        waving = [(i, s) for i, s in enumerate(self.slots)
                  if s is not None and s.state == "prefilling"]
        if not waving:
            return
        pieces = {i: (list(req.prompt) or [1])[req._pf_pos:
                                               req._pf_pos + chunk]
                  for i, req in waving}
        self._dev_dirty = True
        self._refresh_device_state()
        first = np.zeros((self.batch,), np.int32)
        for group in self._prefill_waves({
                i: (len(pieces[i]), req._pf_pos > 0) for i, req in waving}):
            lens = np.zeros((self.batch,), np.int32)
            starts = np.zeros((self.batch,), np.int32)
            toks = np.zeros((self.batch, _bucket(max(len(pieces[i])
                                                     for i in group))),
                            np.int32)
            for i in group:
                lens[i] = len(pieces[i])
                starts[i] = self.slots[i]._pf_pos
                toks[i, : lens[i]] = pieces[i]
            t0, tw = time.perf_counter(), time.time()
            last_logits, self.cache = self._prefill_chunked(
                self.params, self._tensor(toks).long(), self._tensor(lens),
                self._tensor(starts), self.cache, self._dev["offsets"],
                self.tick)
            sampled = self._host(sample_tokens(
                last_logits, self._dev["temps"], self._dev["topks"],
                self._dev["seeds"], self._dev["counters"]))
            first[group] = sampled[group]
            dt = time.perf_counter() - t0
            self.stats["prefill_s"] += dt
            self.stats["prefill_tokens"] += int(lens.sum())
            self.stats["prefill_calls"] += 1
            self._prefill_wave_trace(tw, dt, group, lens, starts, chunk)

        now = time.time()
        for i, req in waving:
            req._pf_pos += len(pieces[i])
            self._slot_pos[i] = req._pf_pos
            if req._pf_pos >= len(list(req.prompt) or [1]):
                req.state = "active"
                self._emit(i, req, int(first[i]), now)
        self._dev_dirty = True

    # ----------------------------------------------------- paged internals

    def _tokens_written(self, req: Request) -> List[int]:
        """Every token with (or about to get) a cache position: the prompt
        (BOS-substituted if empty) followed by the generated stream —
        position p holds ``seq[p]``, which is what block sealing and
        resume-by-reprefill both rely on."""
        return (list(req.prompt) or [1]) + list(req.out)

    def _set_bt_row(self, i: int, table: List[int]):
        self._bt[i, :] = self._trash
        if table:
            self._bt[i, : len(table)] = table
        self._bt_dirty = True

    def _sync_block_tables(self):
        """Upload the host block table if it changed since the last upload;
        a no-op in steady state."""
        if self._bt_dirty:
            self.cache["block_tables"] = self._tensor(self._bt)
            self._bt_dirty = False

    def _set_slot_sampling(self, i: int, req: Request):
        sp = req.sampling
        self._temps[i] = sp.temperature
        self._topks[i] = sp.top_k
        self._seeds[i] = sp.seed
        self._offsets[i] = sp.counter_offset
        self._counters[i] = sp.counter_offset + len(req.out)

    def _set_device_pos(self, i: int, p: int):
        if self._mine(i):
            self.cache["pos"][i - self._lo] = p

    def _release_slot_blocks(self, i: int, req: Request):
        self._pool_of(req.rid).release(req.rid)
        self._rid_shard.pop(req.rid, None)
        self._set_bt_row(i, [])
        self._set_device_pos(i, 0)
        self._slot_pos[i] = 0

    def _preempt_requeue(self, i: int, req: Request):
        """Out-of-blocks preemption: freeze the slot's host state and send
        the request back through the scheduler *with its blocks intact* —
        re-admission resumes decode from the frozen position instead of
        re-prefilling."""
        req._resume = {"pos": int(self._slot_pos[i]),
                       "last_token": int(self._last_token[i]),
                       "t": time.time(), "reprefill": False,
                       "prefilling": req.state == "prefilling"}
        self.trace.phase(req.rid, "preempt_stall", req._resume["t"], slot=i,
                         blocks=len(self._pool_of(req.rid).table(req.rid)))
        req.state = "queued"
        self.slots[i] = None
        self._set_bt_row(i, [])
        self._set_device_pos(i, 0)
        self.scheduler.requeue(req)
        self.stats["preemptions"] += 1

    def _release_for_reprefill(self, req: Request):
        """Deadlock breaker (last resort): a *queued* preempted request
        gives its blocks back to the pool; on re-admission it re-prefills
        its full history (prompt + generated so far).  Counters replay
        exactly — KV quantiser = absolute position + offset, sampling =
        offset + emitted count — so the first layer's int8 codes are bit
        for bit the same; deeper layers re-enter through the batched
        prefill and agree with the decode-written cache to rounding only,
        so a greedy near-tie after resume may break differently.  The
        primary preemption path (blocks intact) has no such divergence."""
        self._pool_of(req.rid).forget(req.rid)
        self._rid_shard.pop(req.rid, None)
        req._sealed = 0
        if req._resume is None:
            req._resume = {"pos": 0, "last_token": 0, "t": time.time()}
        req._resume["reprefill"] = True
        self.trace.event("reprefill", rid=req.rid, t=self._now(),
                         pos=req._resume["pos"])
        # 'preemptions' counts preemption *events*: a requeue-with-blocks
        # and a later block reclamation are two events for one request
        self.stats["preemptions"] += 1

    def _resume_slot(self, i: int, req: Request):
        # slot i is on the data shard holding req's blocks (admission
        # resumes only onto the home shard)
        pool = self._pool_of(req.rid)
        st = req._resume
        req._resume = None
        self.slots[i] = req
        # a request preempted mid-prefill rejoins the prefill waves where it
        # stopped (its _pf_pos and blocks survived the round trip)
        req.state = "prefilling" if st.get("prefilling") else "active"
        self.trace.phase(req.rid, "prefill" if st.get("prefilling")
                         else "decode", self._now(), slot=i, resumed=1,
                         blocks=len(pool.table(req.rid)))
        self._set_slot_sampling(i, req)
        self._last_token[i] = st["last_token"]
        self._slot_pos[i] = st["pos"]
        self._set_bt_row(i, pool.table(req.rid))
        self._set_device_pos(i, st["pos"])
        self._dev_dirty = True

    def _seal_full_blocks(self, req: Request, n_tokens: int):
        """Publish every full block below ``n_tokens`` into the prefix
        cache (chained-hash order).  Callers only invoke this after the
        device writes for those blocks were issued; work on one stream runs
        in order, so a later gather reads them complete.  Paused while
        degraded (DESIGN.md §12): ``req._sealed`` does not advance, so
        sealing resumes from the same block once pressure clears.  Each
        sealed block's writer and the prefill span of the admission that
        wrote it are noted for :meth:`restore`."""
        shard = self._rid_shard[req.rid]
        pool = self.pools[shard]
        if not pool.prefix_cache or self._degraded:
            return
        bs = self.block_size
        seq = self._tokens_written(req)
        table = pool.table(req.rid)
        pf_end = len(seq) if req.state == "prefilling" else req._pf_pos
        while req._sealed < n_tokens // bs:
            j = req._sealed
            pool.seal_block(req.rid, j, seq[j * bs:(j + 1) * bs])
            self._block_src[shard][table[j]] = (req.rid, j, req._pf_start,
                                                pf_end)
            req._sealed += 1

    def _admit_and_prefill_paged(self):
        """Continuous-batching admission: admit while a slot *and* that
        slot's data-shard pool allow — prefix-hit requests only need blocks
        (and prefill compute) for their unshared suffix; preempted requests
        resume in place on their home shard (their blocks live in that
        shard's pool).  New requests pick the shard with the longest cached
        prefix, then the most free blocks, then the lowest index, as the
        reference's do.  Head-of-line order is kept: the first request no
        eligible shard can serve stops admission (after the deadlock
        breaker has had its chance)."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free:
            self._prefill_wave_paged()
            return
        bs = self.block_size
        free_by_shard: dict = {}
        for i in free:                       # slot order ⇒ shard-local order
            free_by_shard.setdefault(self._slot_shard(i), []).append(i)

        def take_slot(shard: int) -> int:
            slots_d = free_by_shard[shard]
            i = slots_d.pop(0)
            if not slots_d:
                del free_by_shard[shard]
            return i

        admitted = []                       # (slot, req, start)
        while free_by_shard:
            req = self.scheduler.peek()
            if req is None:
                break
            if req._resume is not None and not req._resume.get("reprefill"):
                # resume with blocks intact; may need one block to continue
                shard = self._rid_shard[req.rid]
                if shard not in free_by_shard:
                    break        # HOL: the home shard has no free slot yet
                pool = self.pools[shard]
                pos = req._resume["pos"]
                needs_block = (pos % bs == 0
                               and pos // bs >= len(pool.table(req.rid)))
                if needs_block and pool.free_blocks < 1:
                    if self._break_deadlock(req, 1, shard):
                        continue
                    break
                self.scheduler.pop(req)
                if needs_block:
                    phys = pool.append_block(req.rid)
                    assert phys is not None
                self._resume_slot(take_slot(shard), req)
                continue

            seq = self._tokens_written(req)      # prompt (+ out on reprefill)
            if len(req.prompt) > self.max_len or \
                    self.pools[0].blocks_needed(
                        min(len(seq) + 1, self.max_len)) > self._nb_local:
                self.scheduler.pop(req)
                # a reprefill-resumed request whose grown history no longer
                # fits was *served* up to the pool's capacity — that is a
                # 'length' stop, not a rejection of an unserved request
                self._retire(req, "length" if req.out else "rejected")
                continue
            seed = req.sampling.counter_offset if self.kv_quant else 0
            ranked = sorted(
                ((self.pools[d].match_prefix(seq, seed), d)
                 for d in free_by_shard),
                key=lambda t: (-len(t[0][0]), -self.pools[t[1]].free_blocks,
                               t[1]))
            table = shard = None
            for (shared, chain), cand in ranked:
                table = self.pools[cand].allocate(req.rid, len(seq), shared,
                                                  chain)
                if table is not None:
                    shard = cand
                    break
            if table is None:
                (shared, _), cand = ranked[0]
                if self._break_deadlock(
                        req, self.pools[cand].blocks_needed(len(seq))
                        - len(shared), cand):
                    continue
                break
            self._rid_shard[req.rid] = shard
            self.scheduler.pop(req)
            req._sealed = len(shared)
            req._resume = None
            admitted.append((take_slot(shard), req, len(shared) * bs))

        # place admitted requests into their slots in ``prefilling`` state:
        # their blocks are allocated, the wave below only writes into them
        now = time.time()
        for i, req, start in admitted:
            table = self._pool_of(req.rid).table(req.rid)
            self.slots[i] = req
            req.state = "prefilling"
            req._pf_pos = req._pf_start = start
            if req.t_admit is None:
                req.t_admit = now
            self.trace.phase(req.rid, "prefill", now, slot=i,
                             blocks=len(table), prefix_tokens=start)
            self._set_slot_sampling(i, req)
            self._slot_pos[i] = start
            self._set_bt_row(i, table)
            self.stats["prefix_hit_tokens"] += start

        self._prefill_wave_paged()

    def _prefill_wave_paged(self):
        """One prefill wave over every ``prefilling`` slot, one batched
        call per group of ``_prefill_waves``: the next ``prefill_chunk``
        tokens of each slot's unshared suffix (all of it when
        ``prefill_chunk`` is None).  The chunk is block-aligned, so every
        continuation chunk starts at a block boundary and rides the
        prefix-hit path — earlier chunks' K/V is gathered from the slot's
        own blocks inside attention (DESIGN.md §11).  Each slot's full
        blocks are then sealed; a slot whose last chunk landed samples its
        first token and turns ``active``."""
        chunk = self.prefill_chunk or (self.max_len + 1)
        waving = [(i, s) for i, s in enumerate(self.slots)
                  if s is not None and s.state == "prefilling"]
        if not waving:
            return
        pieces = {}
        for i, req in waving:
            pieces[i] = self._tokens_written(req)[req._pf_pos:
                                                  req._pf_pos + chunk]

        self._dev_dirty = True
        self._refresh_device_state()
        bt_dev = self._tensor(self._bt)
        self._bt_dirty = False
        first = np.zeros((self.batch,), np.int32)
        for group in self._prefill_waves({
                i: (len(pieces[i]), req._pf_pos > 0) for i, req in waving}):
            lens = np.zeros((self.batch,), np.int32)
            starts = np.zeros((self.batch,), np.int32)
            toks = np.zeros((self.batch, _bucket(max(len(pieces[i])
                                                     for i in group))),
                            np.int32)
            for i in group:
                lens[i] = len(pieces[i])
                starts[i] = self.slots[i]._pf_pos
                toks[i, : lens[i]] = pieces[i]
            t0, tw = time.perf_counter(), time.time()
            last_logits, self.cache = self._prefill_paged(
                self.params, self._tensor(toks).long(), self._tensor(lens),
                self._tensor(starts), bt_dev, self.cache,
                self._dev["offsets"], self.tick,
                prefix_blocks=self.nbmax if starts.any() else 0)
            sampled = self._host(sample_tokens(
                last_logits, self._dev["temps"], self._dev["topks"],
                self._dev["seeds"], self._dev["counters"]))
            first[group] = sampled[group]
            dt = time.perf_counter() - t0
            self.stats["prefill_s"] += dt
            self.stats["prefill_tokens"] += int(lens.sum())
            self.stats["prefill_calls"] += 1
            self._prefill_wave_trace(tw, dt, group, lens, starts, chunk)

        now = time.time()
        for i, req in waving:
            req._pf_pos += len(pieces[i])
            self._slot_pos[i] = req._pf_pos
            self._seal_full_blocks(req, req._pf_pos)
            if req._pf_pos >= len(self._tokens_written(req)):
                req.state = "active"
                self._emit(i, req, int(first[i]), now)
        self._dev_dirty = True

    def _break_deadlock(self, head: Request, blocks_short: int,
                        shard: int = 0) -> bool:
        """Admission stalled on the queue head with every slot of ``shard``
        idle: make room in that shard's pool by taking blocks back from
        *queued* preempted requests holding blocks there (youngest
        preemption first — the least progress to re-prefill), or, if the
        head itself holds everything, flip it to reprefill mode so its own
        blocks free up.  Returns True when the caller should retry
        admission."""
        lo = shard * self._rows
        if any(s is not None for s in self.slots[lo:lo + self._rows]):
            return False     # active slots will finish/preempt and free blocks
        pool = self.pools[shard]
        holders = [r for r in self.scheduler.queued()
                   if r is not head and r._resume is not None
                   and self._rid_shard.get(r.rid) == shard
                   and pool.table(r.rid)]
        holders.sort(key=lambda r: -r._resume["t"])
        made_room = False
        for victim in holders:
            self._release_for_reprefill(victim)
            made_room = True
            if pool.free_blocks >= blocks_short:
                return True
        if (not made_room and head._resume is not None
                and self._rid_shard.get(head.rid) == shard
                and pool.table(head.rid)):
            self._release_for_reprefill(head)
            return True
        return made_room

    def _pre_decode_paged(self, window: Optional[int] = None):
        """Before each decode window: the window writes each active slot's
        next ``w = min(window, max_len - p, tokens left)`` positions, so the
        blocks covering ``[p, p + w)`` must exist *now*.  Filled blocks are
        sealed here (their device writes are issued).  When the pool covers
        only part of the window, the slot's budget for it is capped
        (``_paged_cap``, the reference's per-window budget); a slot the pool
        cannot cover at all is preempted and requeued with its blocks (or,
        as the pool's lone holder, stopped at 'length'); ``max_len`` is a
        hard 'length' stop (the pool has no ring wrap).  Slots still
        prefilling are skipped: their blocks are allocated already.
        ``window`` is ``decode_ticks`` by default and ``draft_k`` for a
        speculative window, whose rollback gives surplus blocks back."""
        if window is None:
            window = self._window_ticks()
        bs = self.block_size
        for i, req in [(i, s) for i, s in enumerate(self.slots)
                       if s is not None and s.state == "active"]:
            pool = self.pools[self._slot_shard(i)]
            p = int(self._slot_pos[i])
            if p >= self.max_len:
                self._finish(i, req, "length")
                continue
            self._seal_full_blocks(req, p)
            w = min(window, self.max_len - p,
                    max(1, req.effective_max_new() - len(req.out)))
            pre = len(pool.table(req.rid))
            need = (p + w - 1) // bs + 1          # the block of p + w - 1
            while len(pool.table(req.rid)) < need:
                phys = pool.append_block(req.rid)
                if phys is None:
                    break
                self._bt[i, len(pool.table(req.rid)) - 1] = phys
                self._bt_dirty = True
            covered = len(pool.table(req.rid)) * bs - p
            if covered <= 0:
                if pool.holders == 1:
                    # nothing to evict or preempt — the pool itself is the
                    # capacity limit for its lone request
                    self._finish(i, req, "length")
                else:
                    self._preempt_requeue(i, req)
                continue
            self._paged_cap[i] = covered
            if p // bs < pre:
                # the tick writes into a pre-existing block (partial tail
                # or a resume) — copy-on-write guard before writing
                self._ensure_tail_writable(i, req, p // bs)

    def _ensure_tail_writable(self, i: int, req: Request, logical: int):
        """Copy-on-write guard before this tick's decode write: the tail
        block is uniquely owned by construction (only full blocks are ever
        sealed and shared), so this is normally a refcount check and
        nothing more — but if a sharing path ever hands out a partial
        block, the write copies it private instead of corrupting every
        other holder.  Pool exhaustion during the copy preempts."""
        old = int(self._bt[i, logical])
        try:
            phys, copied = self._pool_of(req.rid).ensure_writable(req.rid,
                                                                  logical)
        except MemoryError:
            self._preempt_requeue(i, req)
            return
        if copied and self._mine(i):
            self._copy_pool_block(old, int(phys))
        if copied:
            self._bt[i, logical] = phys
            self._bt_dirty = True

    def _copy_pool_block(self, src: int, dst: int):
        """Duplicate one physical block's contents across every layer's
        pool tensors, in place (stacked entries carry a leading repeat
        axis)."""
        for entry in self.cache["layers"]:
            for t in entry.values():
                t[:, dst] = t[:, src]
        for entry in self.cache["remainder"]:
            for t in entry.values():
                t[dst] = t[src]

    def _decode_tick(self):
        """One decode *window* of ``decode_ticks`` ticks in one call — on
        the card without a policy one CUDA-graph replay — then one host
        drain of the (n, B) token matrix.  Per-slot window budgets
        (``max_new``, ``max_len``, paged block coverage) and stop sets go
        down as device rows, so finish detection never syncs mid-window;
        the drain walks each slot's column up to its first stop and runs
        the one-tick engine's per-token finish logic (``_emit``)."""
        plan = self._window_plan()
        if plan is None:
            return
        t0, tw = time.perf_counter(), time.time()
        toks = self._run_window(plan)
        # crash point between the device window and the host drain: the
        # window's tokens are lost with the process, never half-emitted
        self._maybe_fail("mid_window")
        dt = time.perf_counter() - t0
        self.stats["decode_s"] += dt
        self.stats["decode_calls"] += 1
        self.tick += plan.n
        kept = self._drain(plan, toks)
        if self.trace.enabled:
            self.trace.wave(
                "decode_window", tw, tw + dt,
                [(req.rid, f"decode[w{self._step_tick}]",
                  {"slot": i, "tokens": kept[i]}) for i, req in plan.active],
                tick=self._step_tick, n_ticks=plan.n)

    def _window_plan(self) -> Optional["_WindowPlan"]:
        """Everything a window needs from the host: paged block coverage
        first, then each active slot's budget and stop row (stop sets
        bucketed to a power-of-two width W, so windows share few shapes).
        None when no slot is active.  The ``pool_alloc`` crash point comes
        first: where the paged engine allocates the window's blocks (the
        ring engine has the point at the same place in the step)."""
        n = self._window_ticks()
        self._paged_cap = {}
        self._maybe_fail("pool_alloc")
        if self.kv_layout == "paged":
            self._pre_decode_paged()
            self._sync_block_tables()
        active = [(i, s) for i, s in enumerate(self.slots)
                  if s is not None and s.state == "active"]
        if not active:
            return None
        alive = np.zeros((self.batch,), bool)
        budgets = np.zeros((self.batch,), np.int32)
        stop_sets = {}
        for i, req in active:
            b = min(n, req.effective_max_new() - len(req.out),
                    self.max_len - int(self._slot_pos[i]))
            if self.kv_layout == "paged":
                b = min(b, self._paged_cap[i])
            alive[i] = True
            budgets[i] = b
            stop_sets[i] = req.sampling.stop_set()     # EOS included
        width = 1
        while width < max(len(ss) for ss in stop_sets.values()):
            width *= 2
        stops = np.full((self.batch, width), -1, np.int32)  # never sampled
        for i, ss in stop_sets.items():
            stops[i, : len(ss)] = sorted(ss)
        self._refresh_device_state()
        return _WindowPlan(n, active, alive, budgets, stops, stop_sets)

    def _run_window(self, plan: "_WindowPlan") -> np.ndarray:
        """The window on the device → its (n, B) tokens on the host.  The
        window advanced the counters and produced the next input tokens on
        the device; the engine keeps those copies (dead rows froze, as the
        host mirrors do)."""
        if self._graphs is not None:
            toks = self._graphs.run(plan.n, self._dev, self.cache,
                                    self._local(plan.alive),
                                    self._local(plan.budgets),
                                    self._local(plan.stops))
        else:
            self.stats["eager_windows"] += 1
            toks, last, counters, self.cache = self._fused_for(plan.n)(
                self.params, self._dev["last_token"], self.cache,
                self._dev["offsets"], self.tick, self._dev["temps"],
                self._dev["topks"], self._dev["seeds"],
                self._dev["counters"], self._tensor(plan.alive),
                self._tensor(plan.budgets), self._tensor(plan.stops))
            self._dev["counters"] = counters
            self._dev["last_token"] = last
        return self._host(toks, dim=1)

    def _drain(self, plan: "_WindowPlan", toks: np.ndarray) -> dict:
        """Emit each active slot's kept tokens: its column up to its budget
        or first stop.  The m tokens of a slot arrive in one drain, each
        stamped at an even share of the interval since its last token (so
        the ITL histogram holds one observation per token).  Returns slot
        → tokens kept."""
        now = time.time()
        kept = {}
        for i, req in plan.active:
            col = toks[:, i]
            m = int(plan.budgets[i])
            for j in range(m):
                if int(col[j]) in plan.stop_sets[i]:
                    m = j + 1
                    break
            t_prev = req.t_last if req.t_last is not None else now
            for j in range(m):
                self._slot_pos[i] += 1
                self._emit(i, req, int(col[j]),
                           t_prev + (now - t_prev) * (j + 1) / m)
            self.stats["decode_tokens"] += m
            kept[i] = m
        return kept

    def _spec_decode_tick(self):
        """One speculative window (DESIGN.md §14), the reference's
        ``_spec_decode_tick``: draft ``draft_k - 1`` tokens per slot on the
        host, score all ``draft_k`` positions in one verify call, then
        commit the longest prefix each slot's own sampler agrees with.
        Acceptance is exact token match — row t's logits are bit for bit
        the sequential decode's whenever rows 1..t matched, and the sampler
        is stateless in (seed, counter) — so the stream is the plain one,
        greedy and sampled alike; a window always commits at least row 0's
        token (the plain tick's).  The rejected suffix is scrubbed in one
        commit call; paged slots then give surplus blocks back with
        ``KVPool.truncate``, leaving the pool as if it never drafted."""
        K = self.draft_k
        self._paged_cap = {}
        self._maybe_fail("pool_alloc")
        if self.kv_layout == "paged":
            self._pre_decode_paged(window=K)
            self._sync_block_tables()
        active = [(i, s) for i, s in enumerate(self.slots)
                  if s is not None and s.state == "active"]
        if not active:
            return
        # a window's decode time spans drafting, verify, the accept walk
        # and the commit call
        t0, td0 = time.perf_counter(), time.time()
        n_drafted = {}
        alive = np.zeros((self.batch,), bool)
        budgets = np.zeros((self.batch,), np.int32)
        drafts = np.zeros((self.batch, K), np.int32)
        for i, req in active:
            b = min(K, req.effective_max_new() - len(req.out),
                    self.max_len - int(self._slot_pos[i]))
            if self.kv_layout == "paged":
                b = min(b, self._paged_cap[i])
            alive[i] = True
            budgets[i] = b
            drafts[i, 0] = self._last_token[i]
            prop = self.drafter.propose(list(req.prompt) + req.out, K - 1)
            nd = min(len(prop), K - 1)
            if nd:
                drafts[i, 1:1 + nd] = prop[:nd]
            n_drafted[i] = nd
        td1 = time.time()

        self._refresh_device_state()
        tv0 = time.time()
        toks_dev, self.cache = self._spec(
            self.params, self._tensor(drafts), self.cache,
            self._dev["offsets"], self.tick, self._dev["temps"],
            self._dev["topks"], self._dev["seeds"], self._dev["counters"],
            self._tensor(alive), self._tensor(budgets))
        toks = self._host(toks_dev)                   # (B, K) sampled per row
        self._maybe_fail("mid_window")
        tv1 = time.time()

        # host accept walk: row t commits iff its *input* draft matched row
        # t-1's sampled token (what sequential decode would have fed), cut
        # at the first stop/EOS hit
        accept = {}
        for i, req in active:
            b = int(budgets[i])
            m = 1
            while m < b and drafts[i, m] == toks[i, m - 1]:
                m += 1
            stops = req.sampling.stop_set()
            for j in range(m):
                if int(toks[i, j]) in stops:
                    m = j + 1
                    break
            accept[i] = m
        # bulk commit + rejected-suffix scrub, against the pre-truncation
        # block tables (the scrub needs the draft mapping)
        new_pos = np.asarray(self._slot_pos, np.int32)
        for i, _ in active:
            new_pos[i] += accept[i]
        self.cache = registry.spec_commit(self.cache, self._tensor(new_pos),
                                          self._tensor(budgets), draft_k=K)
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_calls"] += 1
        self.tick += 1
        if self.kv_layout == "paged":
            bs = self.block_size
            # reverse slot order, each truncate returning newest-first: the
            # pushes onto the free list mirror the pops of this window's
            # allocations, so the free list (order included) is as if the
            # window never drafted
            for i, req in reversed(active):
                keep = max(1, -(-int(new_pos[i]) // bs))
                pool = self._pool_of(req.rid)
                have = len(pool.table(req.rid))
                if have > keep:
                    pool.truncate(req.rid, keep)
                    self._bt[i, keep:have] = self._trash
                    self._bt_dirty = True
        tc1 = time.time()

        now = time.time()
        for i, req in active:
            m = accept[i]
            # a window's m tokens surface together: each is stamped at an
            # even share of the interval since the slot's last token
            t_prev = req.t_last if req.t_last is not None else now
            for j in range(m):
                self._slot_pos[i] += 1
                self._emit(i, req, int(toks[i, j]),
                           t_prev + (now - t_prev) * (j + 1) / m)
            self.stats["decode_tokens"] += m
            for name, v in (("spec_draft_tokens", int(budgets[i]) - 1),
                            ("spec_accepted_tokens", m - 1),
                            ("spec_emitted_tokens", m)):
                self.stats[name] += v
                self.metrics.inc(name, v)
        self.stats["spec_windows"] += 1
        self.metrics.inc("spec_windows")
        # the device sampling counters ran ahead (all K rows drew); the host
        # mirrors advanced by the accept length in _emit: re-upload
        self._dev_dirty = True
        if self.trace.enabled:
            tick = self._step_tick
            self.trace.wave(
                "spec_draft", td0, td1,
                [(req.rid, f"draft[w{tick}]",
                  {"slot": i, "drafted": n_drafted[i]}) for i, req in active],
                tick=tick)
            self.trace.wave(
                "spec_verify", tv0, tv1,
                [(req.rid, f"verify[w{tick}]",
                  {"slot": i, "k": K, "budget": int(budgets[i])})
                 for i, req in active], tick=tick, n_ticks=K)
            self.trace.wave(
                "spec_commit", tv1, tc1,
                [(req.rid, f"commit[w{tick}]",
                  {"slot": i, "accepted": accept[i]}) for i, req in active],
                tick=tick)

    def _emit(self, i: int, req: Request, tok: int, now: float):
        req.out.append(tok)
        if req.t_first is None:
            req.t_first = now
            self.trace.phase(req.rid, "decode", now, slot=i)
            if req.ttft is not None:
                self.metrics.observe_ttft(req.ttft)
        else:
            req.itl.append(now - req.t_last)
            self.metrics.observe_itl(now - req.t_last)
        req.t_last = now
        self._counters[i] += 1
        self._last_token[i] = tok
        if req.stream is not None:
            req.stream(req, tok)

        sp = req.sampling
        if sp.eos_id is not None and tok == sp.eos_id:
            self._finish(i, req, "eos")
        elif tok in sp.stop_set():
            self._finish(i, req, "stop")
        elif len(req.out) >= req.effective_max_new():
            self._finish(i, req, "length")
        elif self.kv_layout == "ring" and self._slot_pos[i] >= self.max_len:
            # the slot's ring cache is full: preempt so the next admission
            # wave can recycle it (the request keeps what it generated).
            # The paged engine requeues-with-blocks on pool pressure
            # instead and stops at max_len in _pre_decode_paged.
            self._finish(i, req, "preempted")

    def _finish(self, i: int, req: Request, reason: str):
        self._retire(req, reason, t=req.t_last, slot=i)
        self.slots[i] = None
        if self.kv_layout == "paged":
            # seal what the prompt + generation filled (future prefix hits),
            # then drop the references — sealed blocks linger in the pool's
            # LRU prefix cache until allocation pressure evicts them
            self._seal_full_blocks(req, int(self._slot_pos[i]))
            self._release_slot_blocks(i, req)

    # --------------------------------- snapshot / restore (DESIGN.md §12)

    def _layout(self) -> dict:
        return {"kv_layout": self.kv_layout, "batch": self.batch,
                "max_len": self.max_len, "kv_quant": bool(self.kv_quant),
                "decode_ticks": self.decode_ticks,
                "prefill_chunk": self.prefill_chunk,
                "block_size": getattr(self, "block_size", None),
                "num_blocks": getattr(self, "num_blocks", None),
                "dp": self.dp, "tp": self.tp}

    @staticmethod
    def _req_to_state(req: Request) -> dict:
        sp = req.sampling
        return {
            "rid": req.rid, "prompt": list(req.prompt),
            "out": list(req.out), "priority": req.priority,
            "max_new": req.max_new, "deadline_s": req.deadline_s,
            "done": req.done, "finish_reason": req.finish_reason,
            "state": req.state,
            "t_submit": req.t_submit, "t_admit": req.t_admit,
            "t_first": req.t_first, "t_last": req.t_last,
            "itl": list(req.itl),
            "arrival": getattr(req, "_arrival", None),
            "resume": req._resume, "sealed": req._sealed,
            "pf_pos": req._pf_pos, "pf_start": req._pf_start,
            "sampling": {"temperature": sp.temperature, "top_k": sp.top_k,
                         "seed": sp.seed, "max_new": sp.max_new,
                         "eos_id": sp.eos_id,
                         "stop_ids": list(sp.stop_ids),
                         "counter_offset": sp.counter_offset},
        }

    @staticmethod
    def _req_from_state(st: dict, streams: Optional[dict] = None) -> Request:
        sps = st["sampling"]
        req = Request(
            rid=st["rid"], prompt=list(st["prompt"]),
            sampling=SamplingParams(
                temperature=sps["temperature"], top_k=sps["top_k"],
                seed=sps["seed"], max_new=sps["max_new"],
                eos_id=sps["eos_id"], stop_ids=tuple(sps["stop_ids"]),
                counter_offset=sps["counter_offset"]),
            priority=st["priority"], max_new=st["max_new"],
            deadline_s=st["deadline_s"])
        req.out = list(st["out"])
        req.done, req.finish_reason = st["done"], st["finish_reason"]
        req.state = st["state"]
        req.t_submit, req.t_admit = st["t_submit"], st["t_admit"]
        req.t_first, req.t_last = st["t_first"], st["t_last"]
        req.itl = list(st["itl"])
        if st["arrival"] is not None:
            req._arrival = st["arrival"]
        req._resume = st["resume"]
        req._sealed, req._pf_pos = st["sealed"], st["pf_pos"]
        req._pf_start = st.get("pf_start", 0)
        if streams is not None:
            req.stream = streams.get(req.rid)
        return req

    def snapshot(self) -> dict:
        """Serialize **all host-side truth** as one JSON-able dict — the
        reference's schema (``version`` 1), so either package reads what
        the other writes: queue and per-slot request states (tokens
        emitted, prefill progress, preempt-resume records), the pool's
        tables, refcounts and prefix index, the per-slot sampler mirrors,
        stats, metrics and trace.  Device state is absent — it is a pure
        function of this host truth (dither KV codes are position-pure,
        the sampler is a stateless hash), which :meth:`restore` exploits.
        Two keys the reference ignores are added: each request's
        ``pf_start`` and ``block_src`` (sealed block → its writer's rid,
        logical index and the writing admission's prefill start and end),
        which let a restore rebuild prefix-hit prefills and shared and
        cached blocks.  Streaming callbacks are not
        serialized; ``restore(..., streams={rid: cb})`` re-attaches them."""
        pools = [p.snapshot() for p in self.pools]
        snap = {
            "version": 1,
            "layout": self._layout(),
            "tick": self.tick,
            "degraded": self._degraded,
            "scheduler": self.scheduler.snapshot(),
            "queue": [self._req_to_state(r) for r in self.scheduler.queued()],
            "slots": [None if s is None else self._req_to_state(s)
                      for s in self.slots],
            "finished": [self._req_to_state(r) for r in self.finished],
            "slot_state": {
                "last_token": [int(x) for x in self._last_token],
                "slot_pos": [int(x) for x in self._slot_pos],
                "temps": [float(x) for x in self._temps],
                "topks": [int(x) for x in self._topks],
                "seeds": [int(x) for x in self._seeds],
                "offsets": [int(x) for x in self._offsets],
                "counters": [int(x) for x in self._counters],
            },
            "pools": pools,
            "rid_shard": {str(r): d for r, d in self._rid_shard.items()},
            "stats": dict(self.stats),
            "metrics": self.metrics.snapshot(),
            "trace": self.trace.snapshot(self._now()),
        }
        if pools:
            # one map per data shard (a list under a mesh, the reference's
            # schema has no such key)
            srcs = [{str(phys): list(src[phys])
                     for phys, h in enumerate(ps["hash"])
                     if h is not None and phys in src}
                    for ps, src in zip(pools, self._block_src)]
            snap["block_src"] = srcs[0] if self.dp == 1 else srcs
        return snap

    def restore(self, snap: dict, streams: Optional[dict] = None) -> "Engine":
        """Adopt a :meth:`snapshot` and re-materialise the device KV so the
        engine continues **bit for bit** where the snapshot was taken
        (policy-free and deterministic-scheme serving, DESIGN.md §12).
        Works on a freshly built engine of the same layout or in place on
        a crashed one: every mutable field is overwritten, and the cache's
        own tensors are reset to a fresh cache's bytes and refilled, so the
        decode graphs captured on them stay valid and are replayed as
        they are.

        Host truth is copied back verbatim; :meth:`_replay_device_state`
        then rebuilds the KV of every request that holds some: its prefill
        region through the calls admission made — the same length buckets,
        chunks and prefix-hit starts, so on the card every call has the
        original's shape — and its generated region by teacher-forced
        replay of the decode step the windows run.  A block shared by a
        prefix hit is rebuilt by the admission that wrote it, so at its
        writer's length buckets.  Unlike the reference, queued preempted
        requests keep their blocks' contents and prefix-cached blocks
        nobody holds are rebuilt from their writer (a snapshot without
        ``block_src`` drops them, as the reference does).

        An MoE engine restores as the reference's restore does instead
        (:meth:`_replay_as_reference`): one prefill call over every
        occupied row, then a teacher-forced replay with every row in its
        slot and the rows out of tokens inert at token 0.  MoE capacity
        ranks count every token of a call, so an exact rebuild would have
        to re-run every call since the slots were last all empty, the
        rows of finished requests too: an MoE restore is not the
        uninterrupted run (ROADMAP Findings).  Unheld prefix-cached
        blocks are dropped, as there; a queued block holder gives its
        blocks back and re-prefills its history on re-admission, where
        the reference would resume it on zeroed blocks."""
        lay, mine = snap["layout"], self._layout()
        diff = {k for k in mine if lay.get(k) != mine[k]}
        if diff:
            raise ValueError("snapshot layout does not match this engine: "
                             + ", ".join(f"{k}={lay.get(k)!r}!={mine[k]!r}"
                                         for k in sorted(diff)))
        self.tick = int(snap["tick"])
        self._degraded = bool(snap["degraded"])
        queue = [self._req_from_state(st, streams) for st in snap["queue"]]
        self.scheduler.restore(snap["scheduler"], queue)
        self.slots = [None if st is None else self._req_from_state(st, streams)
                      for st in snap["slots"]]
        self.finished = [self._req_from_state(st, streams)
                         for st in snap["finished"]]
        ss = snap["slot_state"]
        self._last_token = np.asarray(ss["last_token"], np.int32)
        self._slot_pos = np.asarray(ss["slot_pos"], np.int64)
        self._temps = np.asarray(ss["temps"], np.float32)
        self._topks = np.asarray(ss["topks"], np.int32)
        self._seeds = np.asarray(ss["seeds"], np.int32)
        self._offsets = np.asarray(ss["offsets"], np.int32)
        self._counters = np.asarray(ss["counters"], np.int32)
        self.stats = {**{k: type(v)() for k, v in self.stats.items()},
                      **snap["stats"]}
        self.metrics.restore(snap["metrics"])
        # resume the request timelines (spans open at the crash close with
        # a recovery marker)
        self.trace.restore(snap.get("trace"), t=self._now())
        self._paged_cap = {}
        self._steps_since_snap = 0
        moe = bool(self.cfg.n_experts)
        self._block_src = [{} for _ in self.pools]
        if self.pools:
            for pool, ps in zip(self.pools, snap["pools"]):
                pool.restore(ps, drop_unheld=moe)
            self._rid_shard = {int(r): int(d)
                               for r, d in snap["rid_shard"].items()}
            srcs = snap.get("block_src", {})
            if self.dp == 1:
                srcs = [srcs]
            if not moe:
                self._block_src = [{int(p): tuple(int(x) for x in w)
                                    for p, w in src.items()} for src in srcs]
            if moe:
                # the replay rebuilds the slots alone: a queued block
                # holder gives its blocks back and re-prefills its history
                # when admitted again (the reference resumes it on zeroed
                # blocks, ROADMAP Queue 3)
                for req in self.scheduler.queued():
                    if (req._resume is not None
                            and not req._resume.get("reprefill")):
                        self._release_for_reprefill(req)
        with self._scope():
            if moe:
                self._replay_as_reference()
            else:
                self._replay_device_state()
        self._dev_dirty = True
        self.metrics.inc("recoveries")
        return self

    def written_kv(self) -> dict:
        """rid → clones of the cache contents at every position that
        request has written — each cache tensor's rows in order, a
        recurrent layer's whole state row and an encoder-decoder slot's
        cross-KV row — for the slots and the queued block holders: exactly
        what :meth:`restore` rebuilds, so a restore is checked by
        comparing these bytes with the uninterrupted engine's.  On a mesh:
        the requests of this rank's data shard, at its model shard's
        heads."""
        held = [(i, r, int(self._slot_pos[i]))
                for i, r in enumerate(self.slots)
                if r is not None and self._mine(i)]
        if self.pools:
            held += [(None, r, int(r._resume["pos"]))
                     for r in self.scheduler.queued()
                     if r._resume is not None
                     and not r._resume.get("reprefill")
                     and self._rid_shard.get(r.rid) == self._shard
                     and self._pool_of(r.rid).table(r.rid)]
        out = {}
        for i, req, w in held:
            if i is not None:
                i -= self._lo
            parts = []
            for stacked, entries in ((True, self.cache["layers"]),
                                     (False, self.cache["remainder"])):
                for entry in entries:
                    for name in sorted(entry):
                        t = entry[name] if stacked else entry[name][None]
                        if "k" not in entry:       # a recurrent state
                            parts.append(t[:, i].clone())
                        elif self.pools:
                            blocks = self._pool_of(req.rid).table(req.rid)[
                                :-(-w // self.block_size)]
                            parts.append(t[:, blocks].flatten(1, 2)[:, :w]
                                         .clone())
                        else:
                            cap = t.shape[2]
                            parts.append(t[:, i, [p % cap for p in range(
                                max(0, w - cap), w)]].clone())
            for name in sorted(self.cache.get("cross", {})):
                parts.append(self.cache["cross"][name][:, i].clone())
            out[req.rid] = parts
        return out

    @staticmethod
    def compare_written_kv(want: dict, got: dict) -> Tuple[int, int]:
        """Byte compare of two :meth:`written_kv` results → (tensors, bytes)
        compared; raises ``ValueError`` at the first request set, shape or
        byte that differs."""
        if sorted(want) != sorted(got):
            raise ValueError(f"written KV of requests {sorted(got)}, "
                             f"expected {sorted(want)}")
        n = nbytes = 0
        for rid in want:
            if len(want[rid]) != len(got[rid]):
                raise ValueError(f"request {rid}: {len(got[rid])} cache "
                                 f"tensors, expected {len(want[rid])}")
            for k, (a, b) in enumerate(zip(want[rid], got[rid])):
                if a.shape != b.shape or not torch.equal(a, b):
                    raise ValueError(f"request {rid}: cache tensor {k} "
                                     "differs")
                n += 1
                nbytes += a.numel() * a.element_size()
        return n, nbytes

    def _restore_unit(self, req: Request, row, written: int, table,
                      plan: Optional[Tuple[int, int]] = None) -> _Unit:
        """The restore plan of one request that wrote ``written`` cache
        positions through the admission whose prefill spanned ``plan``
        (start, end) — by default its current one (see :class:`_Unit`)."""
        seq = self._tokens_written(req)
        if self.kv_layout == "ring" and self.prefill_chunk is None:
            pf_start, pf_end = 0, min(written, len(list(req.prompt) or [1]))
        elif plan is None:
            pf_start, pf_end = req._pf_start, req._pf_pos
        else:
            pf_start, pf_end = plan
        chunk = self.prefill_chunk or (self.max_len + 1)
        # a piece keeps the end admission gave it (so its length bucket),
        # even where only its head is still needed
        pieces = [(s, min(s + chunk, pf_end))
                  for s in range(pf_start, pf_end, chunk) if s < written]
        return _Unit(req, row, table, seq, pieces, seq[pf_end:written],
                     pf_start, pf_end, ghost=plan is not None)

    def _restore_units(self) -> Tuple[List[_Unit], List[dict]]:
        """Every admission whose KV the restore rebuilds, and, per data
        shard, the writer of each of its pool's blocks (block → unit
        index): the slots', the queued preempted block holders', and a
        ghost for each admission that wrote a block some unit reads in its
        shared prefix, or a prefix-cached block nobody holds, with no unit
        writing it (``_restore_ghosts``).  Each unit's level follows from
        whose blocks it reads, within its shard's pool."""
        units = []
        for i, req in enumerate(self.slots):
            if req is not None:
                units.append(self._restore_unit(
                    req, i, int(self._slot_pos[i]),
                    self._pool_of(req.rid).table(req.rid) if self.pools
                    else None))
                units[-1].shard = self._slot_shard(i)
        if not self.pools:
            return units, [{}]
        for req in self.scheduler.queued():
            st = req._resume
            if st is not None and not st.get("reprefill") \
                    and self._pool_of(req.rid).table(req.rid):
                units.append(self._restore_unit(
                    req, None, int(st["pos"]),
                    self._pool_of(req.rid).table(req.rid)))
                units[-1].shard = self._rid_shard[req.rid]
        bs = self.block_size
        owners = [{} for _ in self.pools]
        for k, u in enumerate(units):
            for j in range(u.pf_start // bs, len(u.table)):
                owners[u.shard].setdefault(u.table[j], k)
        for d, owner in enumerate(owners):
            for u in self._restore_ghosts(
                    [u for u in units if u.shard == d], owner, d):
                k = len(units)
                u.shard = d
                units.append(u)
                for j in range(u.pf_start // bs, len(u.table)):
                    owner[u.table[j]] = k

        def level(k, seen=()):
            u = units[k]
            owner = owners[u.shard]
            if k in seen or any(u.table[j] not in owner
                                for j in range(u.pf_start // bs)):
                raise RuntimeError("restore cannot order the writes of "
                                   f"request {u.req.rid}'s blocks")
            u.level = 1 + max((level(owner[u.table[j]], seen + (k,))
                               for j in range(u.pf_start // bs)), default=-1)
            return u.level

        for k in range(len(units)):
            level(k)
        return units, owners

    def _restore_ghosts(self, units: List[_Unit], owner: dict,
                        shard: int) -> List[_Unit]:
        """The ghost units of data shard ``shard``'s pool in a restore (see
        :meth:`_restore_units`; ``units`` are that shard's).  A
        block's writing admission comes from ``block_src`` (writer rid,
        logical index, prefill start and end), so a ghost re-runs that
        admission's prefill pieces — its length buckets and chunks — and
        replays its generated tokens up to the block.  A ghost's table is
        the blocks its readers map at the same logical indices (the index
        chain before a cached block), its own blocks gone from the pool
        are scratch blocks.  A held block with no known writer raises; a
        cached one, or one whose chain or scratch is missing, is dropped
        from the pool (it can no longer be hit)."""
        pool, bs = self.pools[shard], self.block_size
        block_src = self._block_src[shard]
        writers = {r.rid: r for r in self.finished}
        writers.update((r.rid, r) for r in self.scheduler.queued())
        writers.update((r.rid, r) for r in self.slots if r is not None)

        def source(phys):
            src = block_src.get(phys)
            if src is None or src[0] not in writers:
                return None
            return (src[0], src[2], src[3]), src[1]

        plans: dict = {}            # (rid, pf_start, pf_end) → {j: block}
        held = set()
        for u in units:
            for j in range(u.pf_start // bs):
                if u.table[j] in owner:
                    continue
                src = source(u.table[j])
                if src is None:
                    raise RuntimeError(
                        f"restore cannot rebuild block {u.table[j]} of "
                        f"request {u.req.rid}'s shared prefix: no record of "
                        "its writer")
                key, jj = src
                rows = plans.setdefault(key, {})
                for j2 in range(jj):
                    rows.setdefault(j2, u.table[j2])
                rows[jj] = u.table[jj]
                held.add(key)
        state = pool.snapshot()
        cached = set(state["cached"])
        drop = set()
        # by logical index, so a cached block's chain is settled first
        for phys in sorted(state["cached"],
                           key=lambda p: block_src.get(p, (0, 0))[1]):
            src = source(phys)
            if src is None:
                drop.add(phys)
                continue
            key, j = src
            rows = plans.setdefault(key, {})
            if rows.get(j) == phys:
                continue
            req = writers[key[0]]
            seed = req.sampling.counter_offset if self.kv_quant else 0
            # one token past the block lifts match_prefix's cap
            chain, _ = pool.match_prefix(
                self._tokens_written(req)[:(j + 1) * bs] + [0], seed)
            if len(chain) <= j or chain[j] != phys \
                    or any(b in drop for b in chain[:j]):
                drop.add(phys)
                continue
            rows[j] = phys
            for j2 in range(key[1] // bs):
                rows.setdefault(j2, chain[j2])
        scratch = list(state["free"])
        ghosts = {}
        for key, rows in plans.items():
            rid, pf_start, pf_end = key
            mine = [j for j, b in rows.items() if source(b) == (key, j)]
            if not mine:
                continue
            table = []
            for j in range(max(mine) + 1):
                b = rows.get(j)
                if j >= pf_start // bs and (b is None
                                            or source(b) != (key, j)):
                    # its own block, no longer in the pool
                    b = scratch.pop() if scratch else None
                table.append(b)
            ghosts[key] = self._restore_unit(
                writers[rid], None, len(table) * bs, table,
                plan=(pf_start, pf_end))
        # a ghost short of a block (no scratch left) or reading a dropped
        # one cannot be rebuilt; nor can the cached ghosts reading its
        while True:
            gone = [key for key, g in ghosts.items()
                    if any(b is None or b in drop for b in g.table)]
            if not gone:
                break
            for key in gone:
                if key in held:
                    raise RuntimeError(
                        f"restore cannot rebuild request {key[0]}'s shared "
                        "blocks: no free block to rebuild them on")
                g = ghosts.pop(key)
                drop.update(b for b in g.table[g.pf_start // bs:]
                            if b in cached)
        pool.drop_cached(sorted(drop))
        for phys in drop:
            block_src.pop(phys, None)
        return list(ghosts.values())

    def _restore_calls(self, items: list) -> List[dict]:
        """Pack ``items`` [(unit, payload)] into calls of ``batch`` rows: a
        unit with a slot keeps its row, the others take free rows of their
        data shard (a row's bits do not depend on its index or on the
        other rows); each shard's rows fill independently."""
        calls = [{}]
        for it in sorted(items, key=lambda it: it[0].row is None):
            row, c = it[0].row, 0
            lo = it[0].shard * self._rows
            while row is None:
                if c == len(calls):
                    calls.append({})
                row = next((r for r in range(lo, lo + self._rows)
                            if r not in calls[c]), None)
                if row is None:
                    c += 1
            calls[c][row] = it
        return calls

    def _reset_cache(self):
        """The cache's layer tensors get a fresh cache's bytes, in place
        (the encoder-decoder's cross-KV encoded again from its frames)."""
        fresh = self._make_cache()
        for old, new in zip(self.cache["layers"] + self.cache["remainder"]
                            + [self.cache.get("cross", {})],
                            fresh["layers"] + fresh["remainder"]
                            + [fresh.get("cross", {})]):
            for name, t in old.items():
                t.copy_(new[name])

    def _replay_as_reference(self):
        """The reference's ``_replay_device_state`` (an MoE restore): every
        occupied slot's prefill part (its prompt, or what a slot still
        prefilling wrote) in one prefill call at the longest part's
        bucket, each row in its slot (paged: through its table, from
        position 0); then one teacher-forced decode step per generated
        token through the one-tick window, every row in its slot, the
        rows out of tokens inert at token 0 (their position frozen).
        Last, ``pos`` and the block tables are the host's."""
        self._reset_cache()
        b = self.batch
        paged = self.kv_layout == "paged"
        occupied = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        lens = np.zeros((b,), np.int32)
        gen = {}
        for i, req in occupied:
            written = int(self._slot_pos[i])
            prompt = self._tokens_written(req)[:written]
            if req.state != "prefilling":
                prompt = prompt[:min(written, len(list(req.prompt) or [1]))]
            lens[i] = len(prompt)
            gen[i] = list(req.out)[:written - lens[i]]
        bt = None
        if paged:
            bt = np.full((b, self.nbmax), self._trash, np.int32)
            for i, req in occupied:
                table = self._pool_of(req.rid).table(req.rid)
                bt[i, :len(table)] = table
        offs = self._tensor(self._offsets)
        t0 = time.perf_counter()
        n_prefill = 0
        if lens.max() > 0:
            toks = np.zeros((b, _bucket(int(lens.max()))), np.int32)
            for i, req in occupied:
                toks[i, :lens[i]] = self._tokens_written(req)[:lens[i]]
            tok_dev, lens_dev = self._tensor(toks).long(), self._tensor(lens)
            view = self._cache_view(np.zeros((b,), np.int32), bt)
            if paged:
                self._prefill_paged(self.params, tok_dev, lens_dev,
                                    self._tensor(np.zeros((b,), np.int32)),
                                    view["block_tables"], view, offs,
                                    self.tick, prefix_blocks=0)
            else:
                _, pf_cache = self._prefill(self.params, tok_dev, lens_dev,
                                            offs, self.tick)
                registry.merge_prefill(self.cfg, view, pf_cache,
                                       lens_dev > 0)
            n_prefill = 1
        self._sync()
        t1 = time.perf_counter()
        depth = max((len(g) for g in gen.values()), default=0)
        for t in range(depth):
            token = np.zeros((b,), np.int32)
            alive = np.zeros((b,), bool)
            pos = np.zeros((b,), np.int32)
            for i, _ in occupied:
                pos[i] = lens[i] + min(t, len(gen[i]))
                if t < len(gen[i]):
                    token[i], alive[i] = gen[i][t], True
            self._replay_step(self._cache_view(pos, bt), token, alive,
                              self._offsets)
        self._sync()
        self._finish_replay({
            "units": len(occupied), "ghosts": 0, "levels": 1,
            "prefill_calls": n_prefill, "prefill_s": t1 - t0,
            "replay_steps": depth, "replay_s": time.perf_counter() - t1})

    def _replay_step(self, view: dict, token: np.ndarray, alive: np.ndarray,
                     offsets: np.ndarray):
        """One teacher-forced decode step of a restore on ``view``: the
        one-tick window with ``token`` as its input (its sampled token is
        discarded), a CUDA-graph replay on the card and the eager window
        elsewhere, as ``_run_window`` runs it; rows not ``alive`` are
        inert."""
        b = self.batch
        zeros = np.zeros((b,), np.int32)
        dev = {"last_token": self._tensor(token.astype(np.int32)),
               "offsets": self._tensor(np.asarray(offsets, np.int32)),
               "temps": self._tensor(zeros.astype(np.float32)),
               "topks": self._tensor(zeros),
               "seeds": self._tensor(zeros),
               "counters": self._tensor(zeros)}
        budgets = alive.astype(np.int32)
        stops = np.full((b, 1), -1, np.int32)
        if self._graphs is not None:
            self._graphs.run(1, dev, view, self._local(alive),
                             self._local(budgets), self._local(stops))
        else:
            self._fused_for(1)(
                self.params, dev["last_token"], view, dev["offsets"],
                self.tick, dev["temps"], dev["topks"], dev["seeds"],
                dev["counters"], self._tensor(alive), self._tensor(budgets),
                self._tensor(stops))

    def _finish_replay(self, stats: dict):
        """``pos`` and the block tables as the host has them, after a
        restore's rebuild; ``stats`` becomes ``last_restore``."""
        pos = np.asarray(self._slot_pos, np.int32)
        if self.kv_layout == "paged":
            pos = np.where([s is not None for s in self.slots], pos, 0)
            self._bt[:] = self._trash
            for i, req in enumerate(self.slots):
                if req is not None:
                    self._set_bt_row(i, self._pool_of(req.rid).table(req.rid))
            self._bt_dirty = True
            self._sync_block_tables()
        self.cache["pos"] = self._tensor(pos.astype(np.int32))
        self._sync()
        self.last_restore = stats

    def _replay_device_state(self):
        """Re-materialise the device KV of every restore unit, bit for bit.

        The cache's tensors first get a fresh cache's bytes, in place.
        Then level by level (a unit reads only blocks that lower levels
        wrote): the level's prefill pieces run in rounds — each unit's
        next piece — grouped by (length bucket, continuation) as admission
        grouped them, through the same calls (ring: prefill and merge, or
        the chunked prefill; paged: the paged prefill, ``prefix_blocks`` =
        the table width for continuations), each pool block written by its
        writer's unit only (the other rows map it to the trash block);
        then its generated tokens replay teacher-forced, one decode step
        per round with every other row inert.  Last, ``pos`` and the block
        tables are the host's."""
        self._reset_cache()
        units, owners = self._restore_units()
        n_prefill = n_replay = 0
        prefill_s = replay_s = 0.0
        for level in range(1 + max((u.level for u in units), default=-1)):
            ks = [k for k, u in enumerate(units) if u.level == level]
            t0 = time.perf_counter()
            n_prefill += self._restore_prefill(units, ks, owners)
            self._sync()
            t1 = time.perf_counter()
            n_replay += self._restore_replay([units[k] for k in ks])
            self._sync()
            prefill_s += t1 - t0
            replay_s += time.perf_counter() - t1
        self._finish_replay({
            "units": len(units), "ghosts": sum(u.ghost for u in units),
            "levels": 1 + max((u.level for u in units), default=-1),
            "prefill_calls": n_prefill, "prefill_s": prefill_s,
            "replay_steps": n_replay, "replay_s": replay_s})

    def _sync(self):
        """Wait for the device (a restore's own timing only)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _cache_view(self, pos: np.ndarray, bt: Optional[np.ndarray] = None):
        view = cache_view(self.cache, self._tensor(pos.astype(np.int32)))
        if bt is not None:
            view["block_tables"] = self._tensor(bt)
        return view

    def _restore_prefill(self, units: List[_Unit], ks: List[int],
                         owners: List[dict]) -> int:
        """The prefill rounds of units ``ks`` (one level) in
        :meth:`_replay_device_state`; returns the number of calls made."""
        calls = 0
        for r in range(max((len(units[k].pieces) for k in ks), default=0)):
            groups: dict = {}
            for k in ks:
                if r < len(units[k].pieces):
                    s, e = units[k].pieces[r]
                    groups.setdefault((_bucket(e - s), s > 0), []).append(
                        (units[k], (k, s, e)))
            for key in sorted(groups):
                for call in self._restore_calls(groups[key]):
                    self._restore_prefill_call(call, owners)
                    calls += 1
        return calls

    def _restore_prefill_call(self, call: dict, owners: List[dict]):
        """One prefill call of a restore: ``call`` maps row → (unit, (unit
        index, start, end)).  Paged rows map blocks below the start to the
        unit's blocks (read) and blocks from it on to the unit's where it
        is their writer, else to the trash block."""
        b = self.batch
        n = max(e - s for _, (_, s, e) in call.values())
        toks = np.zeros((b, _bucket(n)), np.int32)
        lens = np.zeros((b,), np.int32)
        starts = np.zeros((b,), np.int32)
        offs = np.zeros((b,), np.int32)
        bt = None
        if self.kv_layout == "paged":
            bt = np.full((b, self.nbmax), self._trash, np.int32)
        for row, (u, (k, s, e)) in call.items():
            toks[row, :e - s] = u.seq[s:e]
            lens[row], starts[row] = e - s, s
            offs[row] = u.req.sampling.counter_offset
            if bt is not None:
                for j, phys in enumerate(u.table):
                    if j < s // self.block_size or owners[u.shard][phys] == k:
                        bt[row, j] = phys
        tok_dev = self._tensor(toks).long()
        lens_dev, offs_dev = self._tensor(lens), self._tensor(offs)
        view = self._cache_view(np.zeros((b,), np.int32))
        if bt is not None:
            self._prefill_paged(
                self.params, tok_dev, lens_dev, self._tensor(starts),
                self._tensor(bt), view, offs_dev, self.tick,
                prefix_blocks=self.nbmax if starts.any() else 0)
        elif self.prefill_chunk is not None:
            self._prefill_chunked(self.params, tok_dev, lens_dev,
                                  self._tensor(starts), view, offs_dev,
                                  self.tick)
        else:
            _, pf_cache = self._prefill(self.params, tok_dev, lens_dev,
                                        offs_dev, self.tick)
            registry.merge_prefill(self.cfg, view, pf_cache, lens_dev > 0)

    def _restore_replay(self, units: List[_Unit]) -> int:
        """Teacher-forced replay of every unit's generated tokens: round t
        feeds each unit its token t at position ``pf_end + t`` through the
        decode step the windows run (``_replay_step``).  Other rows are
        inert (ring rows write where their next live step writes first,
        paged rows write to the trash block, recurrent rows keep their
        state).  Returns the steps made."""
        depth = max((len(u.gen) for u in units), default=0)
        if not depth:
            return 0
        paged = self.kv_layout == "paged"
        b = self.batch
        steps = 0
        for t in range(depth):
            items = [(u, t) for u in units if t < len(u.gen)]
            for call in self._restore_calls(items):
                token = np.zeros((b,), np.int32)
                alive = np.zeros((b,), bool)
                offs = np.zeros((b,), np.int32)
                if paged:
                    pos = np.zeros((b,), np.int32)
                    bt = np.full((b, self.nbmax), self._trash, np.int32)
                else:
                    # inert ring rows write at their own next position
                    pos, bt = np.asarray(self._slot_pos, np.int32), None
                for row, (u, _) in call.items():
                    token[row], alive[row] = u.gen[t], True
                    pos[row] = u.pf_end + t
                    offs[row] = u.req.sampling.counter_offset
                    if paged:
                        bt[row, :len(u.table)] = u.table
                self._replay_step(self._cache_view(pos, bt), token, alive,
                                  offs)
                steps += 1
        return steps
