"""CUDA-graph replay of the engine's policy-free decode window (DESIGN.md
§11 on the card).

The reference runs a window of n decode-and-sample ticks as one jitted
dispatch (``make_fused_decode``'s ``lax.scan``).  Eager PyTorch instead
dispatches every op of every tick from the host, one at a time: ≈ 2,400
kernel launches a bf16 tick of SmolLM-135M and ≈ 11,000 with the int8 KV
quantiser, so the card idles most of a tick (PERF.md §5).  The port's
counterpart of the one dispatch is one replay of a CUDA graph that holds
the whole window.

:class:`WindowGraphs` captures the engine's eager ``fused_decode`` once
per key (ticks n, stop-set width W) and replays it.  A graph bakes in
every address it touches, so every tensor the window reads or writes
lives at a fixed address: the per-slot sampling state, the last tokens,
``pos``, the block tables and the window's alive/budget/stop rows are
static buffers the host ``copy_``s fresh values into before a replay
(:meth:`WindowGraphs.run` rebinds the engine's references to them, so in
steady state nothing is copied); the cache's layer tensors are the
engine's own, updated in place by every step of the engine, and are
checked to be the captured ones before each replay.  Inside the graph the
window's results — next tokens, counters, ``pos`` — are written back into
their buffers in place.

Only the policy-free window is captured: under a matmul policy the dither
kernels take the tick counter as a host constant, which a capture would
freeze (a follow-up of ROADMAP Queue 1 item 6).  Under sharded serving
(DESIGN.md §9) a rank's window holds its data shard's rows: with the
'model' axis at 1 it is captured as here, the 'data' all-gather of its
tokens sitting outside the graph, on the host side; with the heads
sharded the window holds a 'model' all-gather per layer, which this port
does not capture (a gloo collective cannot be, and an NCCL capture has
no multi-card host to be checked on), so those windows run eagerly.  The
engine decides at construction whether it replays (CUDA, no policy, no
sharded heads) or runs eagerly (``Engine.window_mode``, and its
``eager_windows`` count); a capture that fails raises, and nothing falls
back.

:class:`PrefillGraphs` does the same for the scanned prefill of a model
with recurrent state (SSD, RG-LRU) or of the encoder-decoder (whose
static cross-KV the step reads in place): one decode step per prompt
position, which eager PyTorch would dispatch op by op S times a prompt.  It
captures one step (``registry.scanned_prefill_step``) on the engine's
cache tensors and static buffers, the position t a device counter the
step advances, and replays it S_bucket times a prefill call.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch import coldstart
from repro_torch.models import registry
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import dither_matmul as _dm
from repro_torch.kernels import paged_decode_attention as _pda
from repro_torch.kernels import paged_verify_attention as _pva
from repro_torch.kernels import quantize as _q
from repro_torch.kernels import verify_attention as _va

__all__ = ["WindowGraphs", "PrefillGraphs", "KERNEL_WRAPPERS",
           "cache_view"]

# every kernel wrapper of the port, each with its host ``launches`` count
KERNEL_WRAPPERS = {"decode_attention": _da.decode_attention,
                   "paged_decode_attention": _pda.paged_decode_attention,
                   "verify_attention": _va.verify_attention,
                   "paged_verify_attention": _pva.paged_verify_attention,
                   "quantize": _q.quantize,
                   "dither_matmul": _dm.dither_matmul,
                   "dither_matmul_scaled": _dm.dither_matmul_scaled}

# the per-slot state the window reads, by the engine's ``_dev`` names
_SLOT_STATE = {"last_token": torch.int32, "offsets": torch.int32,
               "temps": torch.float32, "topks": torch.int32,
               "seeds": torch.int32, "counters": torch.int32}


def _counts() -> Dict[str, int]:
    return {n: f.launches for n, f in KERNEL_WRAPPERS.items()}


def _bind(holder: dict, key: str, static: torch.Tensor) -> None:
    """Make ``holder[key]`` the static buffer: copy its value in unless it
    already is that buffer, then rebind the reference."""
    if holder[key] is not static:
        static.copy_(holder[key])
        holder[key] = static


def _record(stream, device, warm_up: Callable, body: Callable):
    """Capture ``body()`` as a CUDA graph on ``stream`` → (graph, what
    ``body`` returned, the kernel launches it recorded).  ``warm_up()``
    runs first, eagerly on the same stream: it loads the kernel libraries
    and lets them set up their state for that stream (cuBLAS's workspace)
    outside the capture, so it must change nothing a later replay reads.
    A graph freed during a capture (an engine collected as garbage) would
    invalidate it: the collector runs first, and not during the capture."""
    current = torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        warm_up()
    current.wait_stream(stream)
    gc.collect()
    gc_was_on = gc.isenabled()
    gc.disable()
    before = _counts()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, stream=stream):
            out = body()
    finally:
        if gc_was_on:
            gc.enable()
    after = _counts()
    return graph, out, {k: after[k] - before[k] for k in after}


def _layer_tensors(cache: dict) -> Tuple[torch.Tensor, ...]:
    """Every cache tensor a step reads or writes in place: the layers'
    and, for the encoder-decoder, its cross-KV."""
    return tuple(t for entry in cache["layers"] + cache["remainder"]
                 + [cache.get("cross", {})] for t in entry.values())


def cache_view(cache: dict, pos: torch.Tensor) -> dict:
    """``cache`` with ``pos`` in place of its positions: the same layer
    tensors (and cross-KV)."""
    view = {"pos": pos, "layers": cache["layers"],
            "remainder": cache["remainder"]}
    if "cross" in cache:
        view["cross"] = cache["cross"]
    return view


class _Window:
    """One captured window: its graph, its (n, B) token output in the
    graph's own memory, the kernel launches one replay makes, the host
    seconds its warm-up and capture took, and how many times it was
    replayed."""

    def __init__(self, graph, toks, launches, seconds):
        self.graph, self.toks, self.launches = graph, toks, launches
        self.seconds = seconds
        self.replays = 0


class WindowGraphs:
    """The engine's decode windows as CUDA-graph replays, one graph per
    (ticks, stop width).

    ``fused_for(n)`` builds the eager window of ``n`` ticks
    (``engine.make_fused_decode`` without a policy); ``cache`` is the
    engine's live cache, whose layer tensors every graph writes in place.
    """

    def __init__(self, params, cache: dict, fused_for: Callable):
        dev = cache["pos"].device
        if dev.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA cache, not {dev}")
        b = cache["pos"].shape[0]
        self.params, self._fused_for, self.device = params, fused_for, dev
        self.slot = {name: torch.zeros((b,), dtype=dtype, device=dev)
                     for name, dtype in _SLOT_STATE.items()}
        self.pos = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.block_tables = (cache["block_tables"].clone()
                             if "block_tables" in cache else None)
        self.alive = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.budgets = torch.zeros((b,), dtype=torch.int32, device=dev)
        self._stops: Dict[int, torch.Tensor] = {}
        self._layers = _layer_tensors(cache)
        self._windows: Dict[Tuple[int, int], _Window] = {}
        self._stream = torch.cuda.Stream(device=dev)
        # host seconds spent in warm-ups and captures
        self.capture_s = 0.0

    # ---------------------------------------------------------- counts

    def windows(self) -> Dict[Tuple[int, int], dict]:
        """(ticks, stop width) → the launches per kernel one replay of that
        graph makes, its replay count and its capture's seconds."""
        return {key: {"launches": dict(w.launches), "replays": w.replays,
                      "capture_s": w.seconds}
                for key, w in self._windows.items()}

    @property
    def replays(self) -> int:
        return sum(w.replays for w in self._windows.values())

    def launches(self) -> Dict[str, int]:
        """Kernel launches the replays made, per kernel: launches per
        replay × replays, summed over the graphs."""
        out = {n: 0 for n in KERNEL_WRAPPERS}
        for w in self._windows.values():
            for n, k in w.launches.items():
                out[n] += k * w.replays
        return out

    def recorded(self) -> Dict[str, int]:
        """Launches the captures recorded, per kernel: they added to the
        wrappers' host counts, but only replays run them."""
        out = {n: 0 for n in KERNEL_WRAPPERS}
        for w in self._windows.values():
            for n, k in w.launches.items():
                out[n] += k
        return out

    # ------------------------------------------------------------- run

    def run(self, n: int, dev: dict, cache: dict, alive: np.ndarray,
            budgets: np.ndarray, stops: np.ndarray) -> torch.Tensor:
        """One window of ``n`` ticks as a graph replay (captured at the
        key's first use) → the (n, B) sampled tokens, in the graph's memory
        until its next replay.  ``dev`` is the engine's per-slot device
        state and ``cache`` its cache: their entries are rebound to the
        static buffers, which the window updates in place (next tokens,
        counters, ``pos``).  ``alive``, ``budgets`` and ``stops`` (B, W)
        are the window's host rows."""
        for name, static in self.slot.items():
            _bind(dev, name, static)
        _bind(cache, "pos", self.pos)
        if self.block_tables is not None:
            _bind(cache, "block_tables", self.block_tables)
        layers = _layer_tensors(cache)
        if len(layers) != len(self._layers) or any(
                a is not b for a, b in zip(layers, self._layers)):
            raise RuntimeError("the cache's layer tensors are not the ones "
                               "the decode graphs were captured on")
        width = stops.shape[1]
        if width not in self._stops:
            self._stops[width] = torch.full(stops.shape, -1,
                                            dtype=torch.int32,
                                            device=self.device)
        self.alive.copy_(torch.from_numpy(alive))
        self.budgets.copy_(torch.from_numpy(budgets))
        self._stops[width].copy_(torch.from_numpy(stops))
        win = self._windows.get((n, width))
        if win is None:
            win = self._windows[n, width] = self._capture(n, width, cache)
        win.graph.replay()
        win.replays += 1
        return win.toks

    def _capture(self, n: int, width: int, cache: dict) -> _Window:
        """Capture the eager window of ``n`` ticks on the static buffers
        (``_record``).  Its warm-up is one eager window with every row
        dead, which changes nothing a later window reads: a dead row's
        token, counter and position freeze, its paged writes go to the
        trash block, its ring write lands where its next live tick writes
        first, and a recurrent row keeps its state."""
        t0 = time.perf_counter()
        fused = self._fused_for(n)
        view = cache_view(cache, self.pos)
        if self.block_tables is not None:
            view["block_tables"] = self.block_tables
        s = self.slot

        def window(alive):
            return fused(self.params, s["last_token"], view, s["offsets"], 0,
                         s["temps"], s["topks"], s["seeds"], s["counters"],
                         alive, self.budgets, self._stops[width])

        def body():
            toks, last, counters, new = window(self.alive)
            s["last_token"].copy_(last)
            s["counters"].copy_(counters)
            self.pos.copy_(new["pos"])
            return toks

        graph, toks, launches = _record(
            self._stream, self.device,
            lambda: window(torch.zeros_like(self.alive)), body)
        seconds = time.perf_counter() - t0
        self.capture_s += seconds
        # a cold-start stall: tracers put it on the timeline
        coldstart.notify("graph_capture", ticks=n, stop_width=width,
                         seconds=seconds)
        return _Window(graph, toks, launches, seconds)


class PrefillGraphs:
    """The scanned prefill of a model with recurrent state or of the
    encoder-decoder as replays of one captured decode step (policy-free,
    on the card).

    The step runs on ``cache``'s layer tensors (the engine's, written in
    place) and a position buffer of its own.  A call ``(params, tokens
    (B, S), lengths (B,), kv_offset (B,), counter)`` returns
    ``(last-token logits (B, vocab_size), cache)`` as
    ``registry.apply_prefill`` does, but in place: the rows with a length
    get a fresh row's values (state 0, ring empty, position 0), the
    prompts, lengths and offsets are copied into static buffers, and the
    captured step is replayed S times; it reads the column at the device
    counter t, updates the rows with t < length (the others keep their
    state, KV and position) and advances t.  The returned cache holds
    ``cache``'s own layer tensors, so merging it into them changes
    nothing.  ``attn_block``: the ring attention kernel's tile, the
    engine's."""

    def __init__(self, params, cfg, cache, max_len: int, device,
                 attn_block=None):
        self.params, self.cfg = params, cfg
        self.attn_block = attn_block
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {dev}")
        self.device = dev
        batch = cache["pos"].shape[0]
        self.cache = cache_view(cache, torch.zeros((batch,),
                                                   dtype=torch.int32,
                                                   device=dev))
        width = 8                 # a prompt's padded length: up to the
        while width < max_len:    # power of two at or above max_len
            width *= 2
        self.tokens = torch.zeros((batch, width), dtype=torch.int64,
                                  device=dev)
        self.lengths = torch.zeros((batch,), dtype=torch.int32, device=dev)
        self.offsets = torch.zeros((batch,), dtype=torch.int32, device=dev)
        self.t = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.last = torch.zeros((batch, cfg.vocab_size), dtype=torch.float32,
                                device=dev)
        self._graph = None
        self._stream = torch.cuda.Stream(device=dev)
        # the launches one replay makes, per kernel; replays so far; host
        # seconds of the warm-up and capture
        self.step_launches: Dict[str, int] = {}
        self.replays = 0
        self.capture_s = 0.0

    def launches(self) -> Dict[str, int]:
        """Kernel launches the replays made, per kernel."""
        return {n: k * self.replays for n, k in self.step_launches.items()}

    def _step(self):
        token = self.tokens.index_select(1, self.t)[:, 0]
        registry.scanned_prefill_step(
            self.params, self.cfg, token, self.t, self.lengths, self.cache,
            self.last, kv_offset=self.offsets, attn_block=self.attn_block)
        self.t.add_(1)

    def _reset(self):
        """The rows with a length to a fresh row's values (stacked leaves
        carry the row at axis 1, remainder leaves at axis 0), t and the
        kept logits to 0.  An encoder-decoder's cross-KV is not a layer
        entry: it stays."""
        rows = self.lengths > 0
        for axis, entries in ((1, self.cache["layers"]),
                              (0, self.cache["remainder"])):
            for entry in entries:
                for name, x in entry.items():
                    shape = [1] * x.dim()
                    shape[axis] = -1
                    x.masked_fill_(rows.view(shape),
                                   -1 if name == "k_pos" else 0)
        self.cache["pos"].masked_fill_(rows, 0)
        self.last.zero_()
        self.t.zero_()

    def _capture(self):
        """Capture one step (``_record``); its warm-up is one eager step
        with every row inactive (lengths 0), which changes nothing."""
        t0 = time.perf_counter()
        self.lengths.zero_()
        self._graph, _, self.step_launches = _record(
            self._stream, self.device, self._step, self._step)
        self.capture_s += time.perf_counter() - t0
        coldstart.notify("graph_capture", ticks=0, stop_width=0,
                         seconds=self.capture_s)

    def __call__(self, params, tokens, lengths, kv_offset=None, counter=0):
        if params is not self.params:
            raise ValueError("the prefill graph was captured on other "
                             "params")
        if self._graph is None:
            self._capture()
        s = tokens.shape[1]
        self.lengths.copy_(lengths)
        self._reset()
        self.tokens[:, :s].copy_(tokens)
        if kv_offset is None:
            self.offsets.zero_()
        else:
            self.offsets.copy_(kv_offset)
        for _ in range(s):
            self._graph.replay()
        self.replays += s
        return self.last, self.cache
