"""Serving engine of the port: batched prefill, then one decode tick at a
time over the ring KV cache (counterpart of the reference's
``serve/engine.py``, its single-device, ring-layout, ``decode_ticks=1``
subset; DESIGN.md §6).

``make_serve_fns`` builds the prefill and decode steps, ``Engine`` is the
host-side loop that drives them: a :class:`Scheduler` admits queued
requests into free decode slots, admitted prompts run through one batched
prefill (right-padded prompts, KV written per slot into the shared ring
cache, prefill logits seeding each request's first token), and each tick
decodes and samples every active slot.  Per-request :class:`SamplingParams`
drive greedy/temperature/top-k sampling, EOS/stop handling and the
per-request dither-counter offsets; slots are preempted at ``max_len`` and
recycled.

PyTorch runs eagerly, so the reference's jitted dispatches become plain
calls; the per-slot sampling state and the last sampled tokens stay on the
device and are re-uploaded only when slot membership changes, and the ring
cache is updated in place.  Every constructor knob of the reference that
this slice does not port raises ``NotImplementedError`` naming its ROADMAP
item.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.serve.sampling import SamplingParams, sample_tokens
from repro_torch.serve.scheduler import Scheduler

__all__ = ["make_serve_fns", "make_decode_and_sample", "make_fused_decode",
           "Engine", "Request", "SamplingParams", "Scheduler"]


def _check_policy(policy) -> None:
    if policy is not None and getattr(policy, "enabled", True):
        raise NotImplementedError("quantised-matmul serving is not ported "
                                  "yet (ROADMAP Queue 1 item 9)")


def make_serve_fns(cfg: ModelConfig, policy=None, *, max_len: int,
                   kv_quant: bool = False):
    """The two serving steps: ``prefill_step(params, tokens, lengths,
    kv_offset, counter)`` maps a right-padded (B, S) prompt batch and its
    (B,) true lengths to the last-prompt-token logits and a ring cache whose
    positions equal ``lengths``; ``decode_step(params, token, cache,
    kv_offset, counter)`` is one token for every slot."""
    _check_policy(policy)

    def prefill_step(params, tokens, lengths, kv_offset=None, counter=0):
        return registry.apply_prefill(
            params, cfg, tokens, lengths, max_len, policy=policy,
            counter=counter, kv_quant=kv_quant, kv_offset=kv_offset)

    def decode_step(params, token, cache, kv_offset=None, counter=0):
        return registry.apply_decode(params, cfg, token, cache, policy=policy,
                                     counter=counter, kv_offset=kv_offset)

    return prefill_step, decode_step


def make_decode_and_sample(cfg: ModelConfig, policy=None):
    """``decode_and_sample(params, token, cache, kv_offset, counter, temps,
    topks, seeds, counters)`` → ``(tokens (B,) int32, counters + 1,
    cache)``: the model decode step and the per-slot sampler in one call."""
    _check_policy(policy)

    def decode_and_sample(params, token, cache, kv_offset, counter,
                          temps, topks, seeds, counters):
        logits, new_cache = registry.apply_decode(
            params, cfg, token, cache, policy=policy, counter=counter,
            kv_offset=kv_offset)
        toks = sample_tokens(logits, temps, topks, seeds, counters)
        return toks, counters + 1, new_cache

    return decode_and_sample


def make_fused_decode(cfg: ModelConfig, policy=None, *, n_ticks: int = 1):
    """The engine's decode tick: ``fused_decode(params, token, cache,
    kv_offset, counter, temps, topks, seeds, counters, alive)`` decodes and
    samples every slot once and returns ``(tokens (1, B), last_token (B,),
    counters, cache)``.  Rows that are not ``alive`` (idle or finished
    slots) still run but are inert: their token, sampling counter and cache
    position freeze, as in the reference's window at one tick.  Windows of
    more than one tick are ROADMAP Queue 1 item 6."""
    _check_policy(policy)
    if n_ticks != 1:
        raise NotImplementedError("fused decode windows (n_ticks > 1) are "
                                  "not ported yet (ROADMAP Queue 1 item 6)")

    def fused_decode(params, token, cache, kv_offset, counter,
                     temps, topks, seeds, counters, alive):
        pos0 = cache["pos"]
        logits, new_cache = registry.apply_decode(
            params, cfg, token, cache, policy=policy, counter=counter,
            kv_offset=kv_offset)
        toks = sample_tokens(logits, temps, topks, seeds, counters)
        toks = torch.where(alive, toks, token)
        new_cache["pos"] = torch.where(alive, new_cache["pos"], pos0)
        counters = torch.where(alive, counters + 1, counters)
        return toks[None], toks, counters, new_cache

    return fused_decode


@dataclass
class Request:
    """One generation request.

    Lifecycle: ``queued`` → (scheduler admits) → ``active`` → ``done`` with
    ``finish_reason`` ∈ {"eos", "stop", "length", "preempted",
    "rejected"}.  ``sampling`` carries the per-request decode controls;
    ``max_new`` overrides ``sampling.max_new``.  ``stream`` (if set) is
    called as ``stream(request, token)`` for every emitted token.  Timing
    fields are host-clock seconds.  ``deadline_s`` exists for the
    reference's API; deadlines are ROADMAP Queue 1 item 8, so a request
    that sets one is refused at submission.
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


# reference knob → (value that means "off", ROADMAP Queue 1 item porting it)
_OUT_OF_SLICE = {
    "block_size": (None, 5), "num_blocks": (None, 5),
    "mesh": (None, 10), "metrics": (None, 8), "trace": (None, 8),
    "decode_ticks": (1, 6), "prefill_chunk": (None, 6),
    "queue_cap": (None, 8), "shed_policy": ("reject-new", 8),
    "queue_ttl_s": (None, 8), "injector": (None, 8),
    "snapshot_path": (None, 8), "spec_decode": (False, 7),
    "frames": (None, 11),
}


class Engine:
    """Host-side continuous-batching loop over the ring KV cache.

    Fixed decode batch B (the slot count).  Each :meth:`step`:

    1. asks the scheduler for requests to fill free slots; admitted prompts
       are right-padded into a (B, S_bucket) batch and run through one
       batched prefill whose cache rows are merged into the admitted slots,
       and the prefill logits seed each request's first sampled token;
    2. decodes and samples every active slot once;
    3. retires slots on EOS/stop tokens, ``max_new``, or ``max_len``
       preemption, freeing them for the next admission wave.

    ``device`` is where the cache and the per-slot state live; ``params``
    must be there already.
    """

    def __init__(self, params, cfg: ModelConfig, batch: int, max_len: int,
                 policy=None, kv_quant: bool = False,
                 scheduler: Union[str, Scheduler] = "fcfs",
                 kv_layout: str = "ring", *, device="cuda",
                 block_size=None, num_blocks=None, mesh=None, metrics=None,
                 trace=None, decode_ticks: int = 1, prefill_chunk=None,
                 queue_cap=None, shed_policy: str = "reject-new",
                 queue_ttl_s=None, injector=None, snapshot_path=None,
                 spec_decode: bool = False, frames=None):
        _check_policy(policy)
        if kv_layout == "paged":
            raise NotImplementedError("kv_layout='paged' is not ported yet "
                                      "(ROADMAP Queue 1 item 5)")
        if kv_layout != "ring":
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        given = dict(block_size=block_size, num_blocks=num_blocks, mesh=mesh,
                     metrics=metrics, trace=trace, decode_ticks=decode_ticks,
                     prefill_chunk=prefill_chunk, queue_cap=queue_cap,
                     shed_policy=shed_policy, queue_ttl_s=queue_ttl_s,
                     injector=injector, snapshot_path=snapshot_path,
                     spec_decode=spec_decode, frames=frames)
        for name, (off, item) in _OUT_OF_SLICE.items():
            if given[name] != off:
                raise NotImplementedError(
                    f"Engine({name}=...) is not ported yet (ROADMAP Queue 1 "
                    f"item {item})")
        if not registry.supports_batched_prefill(cfg):
            raise NotImplementedError(
                f"{cfg.name!r} is not a dense attention-only decoder; the "
                "rest of the zoo is ROADMAP Queue 1 item 11")
        self.device = torch.device(device)
        pdev = params["embed"].device
        if pdev.type != self.device.type or (
                self.device.index is not None
                and pdev.index != self.device.index):
            raise ValueError(f"params live on {pdev}, engine device is "
                             f"{self.device}")
        self.params, self.cfg, self.batch, self.max_len = (
            params, cfg, batch, max_len)
        self.cache = registry.make_cache(params, cfg, batch, max_len,
                                         kv_quant=kv_quant,
                                         device=self.device)
        self._prefill, _ = make_serve_fns(cfg, policy, max_len=max_len,
                                          kv_quant=kv_quant)
        self._fused = make_fused_decode(cfg, policy, n_ticks=1)

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
        self.stats = {"prefill_s": 0.0, "prefill_tokens": 0,
                      "prefill_calls": 0, "decode_s": 0.0,
                      "decode_tokens": 0, "decode_calls": 0}

    # ------------------------------------------------------------------ API

    def submit(self, req: Request):
        """Enqueue a request (FCFS or priority order, per the scheduler)."""
        if req.deadline_s is not None:
            raise NotImplementedError("request deadlines are not ported yet "
                                      "(ROADMAP Queue 1 item 8)")
        req.state = "queued"
        if req.t_submit is None:
            req.t_submit = time.time()
        self.scheduler.submit(req)

    def step(self) -> List[Request]:
        """Admit + batched-prefill, then decode every active slot once.
        Returns the requests still active."""
        self._admit_and_prefill()
        if any(s is not None for s in self.slots):
            self._decode_tick()
        return [s for s in self.slots if s is not None]

    def run(self, ticks: int) -> List[Request]:
        """Drive :meth:`step` until the queue and slots drain (or ``ticks``
        elapse); returns every request finished so far."""
        for _ in range(ticks):
            self.step()
            if not len(self.scheduler) and all(s is None for s in self.slots):
                break
        return self.finished

    # ------------------------------------------------------------ internals

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        """A copy of a host array on the engine's device (never a view of
        the host mirror, which ``_emit`` goes on updating)."""
        return torch.tensor(arr, device=self.device)

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

    def _admit_and_prefill(self):
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free:
            return
        admitted = []
        for req in self.scheduler.admit(len(free)):
            if len(req.prompt) > self.max_len:
                req.done, req.finish_reason, req.state = True, "rejected", "done"
                self.finished.append(req)
                continue
            admitted.append(req)
        if not admitted:
            return

        now = time.time()
        lens = np.zeros((self.batch,), np.int32)
        prompts = {}
        for req in admitted:
            i = free.pop(0)
            sp = req.sampling
            self.slots[i] = req
            req.state, req.t_admit = "active", now
            prompts[i] = list(req.prompt) or [1]          # empty prompt → BOS
            lens[i] = len(prompts[i])
            self._temps[i] = sp.temperature
            self._topks[i] = sp.top_k
            self._seeds[i] = sp.seed
            self._offsets[i] = sp.counter_offset
            self._counters[i] = sp.counter_offset
            self._slot_pos[i] = lens[i]

        s_bucket = _bucket(int(lens.max()))
        toks = np.zeros((self.batch, s_bucket), np.int32)
        for i, p in prompts.items():
            toks[i, : len(p)] = p

        self._dev_dirty = True            # admission changed per-slot state
        self._refresh_device_state()
        t0 = time.perf_counter()
        lens_dev = self._tensor(lens)
        last_logits, pf_cache = self._prefill(
            self.params, self._tensor(toks).long(), lens_dev,
            self._dev["offsets"], self.tick)
        self.cache = registry.merge_prefill(self.cfg, self.cache, pf_cache,
                                            lens_dev > 0)
        first = sample_tokens(last_logits, self._dev["temps"],
                              self._dev["topks"], self._dev["seeds"],
                              self._dev["counters"]).cpu().numpy()
        self.stats["prefill_s"] += time.perf_counter() - t0
        self.stats["prefill_tokens"] += int(lens.sum())
        self.stats["prefill_calls"] += 1

        now = time.time()
        for i in prompts:
            self._emit(i, self.slots[i], int(first[i]), now)
        # _emit advanced host counters / last tokens for the admitted slots;
        # re-sync the device copies before the first decode tick reads them
        self._dev_dirty = True

    def _decode_tick(self):
        """One decode tick over every slot; the host reads the sampled
        tokens back once and runs the per-token finish logic (``_emit``)."""
        active = [(i, s) for i, s in enumerate(self.slots)
                  if s is not None and s.state == "active"]
        if not active:
            return
        alive = np.zeros((self.batch,), bool)
        for i, _ in active:
            alive[i] = True
        self._refresh_device_state()
        t0 = time.perf_counter()
        _, last_dev, counters_dev, self.cache = self._fused(
            self.params, self._dev["last_token"], self.cache,
            self._dev["offsets"], self.tick, self._dev["temps"],
            self._dev["topks"], self._dev["seeds"], self._dev["counters"],
            self._tensor(alive))
        toks = last_dev.cpu().numpy()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_calls"] += 1
        # the tick advanced counters and produced the next input token on
        # the device — keep those copies (idle rows froze, as the mirrors)
        self._dev["counters"] = counters_dev
        self._dev["last_token"] = last_dev
        self.tick += 1

        now = time.time()
        for i, req in active:
            self._slot_pos[i] += 1
            self._emit(i, req, int(toks[i]), now)
            self.stats["decode_tokens"] += 1

    def _emit(self, i: int, req: Request, tok: int, now: float):
        req.out.append(tok)
        if req.t_first is None:
            req.t_first = now
        else:
            req.itl.append(now - req.t_last)
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
        elif self._slot_pos[i] >= self.max_len:
            # the slot's ring cache is full: preempt so the next admission
            # wave can recycle it (the request keeps what it generated)
            self._finish(i, req, "preempted")

    def _finish(self, i: int, req: Request, reason: str):
        req.done, req.finish_reason, req.state = True, reason, "done"
        self.finished.append(req)
        self.slots[i] = None
