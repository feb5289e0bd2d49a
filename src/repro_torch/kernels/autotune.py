"""Launch-parameter autotuner of the port's CUDA kernels, for the H100: the
port's counterpart of the reference's ``kernels/autotune.py``.

Two modes, both keyed by ``(kind, shape, dtype, bits, scheme, backend)``
in the reference's key format (``cache_key``):

* **model-driven pick** (``best_block``) — no execution: the cached winner
  of a sweep if one ran for the key, else the card's model pick
  (``model_block``), which is the launch the wrappers took before this
  module existed: kernels 1 and 3 the largest tile of at most 64 ring
  slots that divides the cap, kernel 6 in its decode regime ``plan``'s
  grid, the paged pool the reference's rule.  With no cache every launch
  therefore takes the same parameters as without the autotuner.
* **measured sweep** (``autotune_matmul``, ``autotune_quantize``,
  ``autotune_decode_attention``, ``autotune_verify_attention``,
  ``autotune_paged_attention``) — each candidate timed through a
  caller-supplied runner, on the card by CUDA events around back-to-back
  calls after a warm-up call, and the least time cached as the winner, in
  memory and (when ``REPRO_AUTOTUNE_CACHE`` names a JSON file) on disk.
  ``chip_smoke.py --autotune`` runs the sweeps on the card.

Candidates are the launch parameters the kernels' C entries take at run
time (a block is a tuple, as the reference's):

* ``decode_attention`` / ``verify_attention`` (kernels 1 and 3): ``(bk,)``,
  the ring tile: 8, 16, 32 and 64 where they divide the cap, and the
  largest divisor of the cap up to ``KERNEL_BLOCK`` (the csrc's kMaxBk).
  The two kernels share one pick, under the decode key: verify row t is
  the decode kernel at pos + t bit for bit only at the same tile.
* ``paged_attention`` (kernels 2 and 4): ``(bs,)``, the pool block, which
  is their tile; fixed when the pool is allocated (``serve/kvpool.py``), so
  a sweep builds a pool per candidate.  The kernels take 1..64; the
  candidates are the reference's grid (8, 16, 32, ... up to ``max_len``)
  capped at 64, so the model pick is the reference's wherever that is at
  most 64.
* ``matmul`` (kernel 6): in the decode regime (M <= ``DECODE_MAX_M``)
  ``(mt, cps, splits)``: 8-row MMA tiles, K chunks of 32 a block and the
  split count over K; the prefill regime's tiles are compile-time
  (``PREFILL_BLOCK``), its one candidate.
* ``quantize`` (kernel 5): its launch takes no parameter at run time; one
  candidate, ``()``.

A working-set model of each kernel's shared-memory staging, written from
the kernels' own layouts (``csrc/flash_decode.cuh:Layout``,
``csrc/dither_matmul.cu:Dec`` and ``kGemmSmem``), rejects a candidate over
what a block may use: 227 KB opted in for the dynamic stages, 48 KB for
the decode regime's static ones.  The attention stages are sized for
``KERNEL_BLOCK`` keys whatever the tile, so there the model rejects a
shape (rows, head dim), not a tile.

Kernels 5 and 6 give the same codes and products bit for bit at every
candidate (elementwise codes, exact int32 partials, an elementwise
epilogue); kernels 1-4 sum the online softmax in the order the tile sets
(within ``chip_smoke.KERNEL_TOL`` of each other; ring ≡ paged where
``bs == bk``).

The runner indirection keeps this module free of the kernel wrappers (they
import it for their launch parameters); it takes ``shrink_block`` from the
plain versions and torch to time on the card.
"""

from __future__ import annotations

import json
import os
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.kernels.ref import shrink_block

__all__ = [
    "SMEM_OPTIN_BYTES", "SMEM_STATIC_BYTES", "SM_COUNT", "KERNEL_BLOCK",
    "SPLIT_TILES", "RING_TILES", "DECODE_MAX_M", "MIN_BLOCKS",
    "TARGET_BLOCKS", "ROW_TILES", "PREFILL_BLOCK",
    "attention_smem_bytes", "matmul_smem_bytes",
    "matmul_candidates", "quantize_candidates", "decode_attention_candidates",
    "paged_attention_candidates", "verify_attention_candidates",
    "model_block", "best_block", "check_block", "resolve",
    "autotune_matmul", "autotune_quantize", "autotune_decode_attention",
    "autotune_paged_attention", "autotune_verify_attention",
    "cache_key", "load_cache", "save_cache", "clear_cache",
    "register_observer",
]

# Observability (DESIGN.md §13): tracers register here so winner-cache hits,
# model picks and measured sweeps show up on the serving timeline.
# WeakSet: a dropped tracer unregisters itself.  Observers are duck-typed —
# anything with an ``autotune_event(kind, **fields)`` method.
_OBSERVERS: "weakref.WeakSet" = weakref.WeakSet()


def register_observer(obs) -> None:
    """Register an object (held weakly) whose ``autotune_event`` method
    receives autotuner cache events: ``autotune_cache_hit``,
    ``autotune_model_pick``, ``autotune_sweep``."""
    _OBSERVERS.add(obs)


def _notify(kind: str, **fields) -> None:
    for obs in list(_OBSERVERS):
        obs.autotune_event(kind, **fields)


# ---------------------------------------------------------------------------
# the card and the kernels' launch constants
# ---------------------------------------------------------------------------

SMEM_OPTIN_BYTES = 232448    # dynamic shared memory a block may opt into
SMEM_STATIC_BYTES = 49152    # static shared memory of a block
SM_COUNT = 132               # the H100 SXM's SMs

# kernels 1-4 (csrc/flash_decode.cuh)
KERNEL_BLOCK = 64            # kMaxBk: keys a tile holds at most
SPLIT_TILES = 2              # kSplitTiles: tiles a split covers
RING_TILES = (8, 16, 32, 64)
_MAX_WARPS, _ROWS_PER_WARP, _MAX_ROWS = 16, 4, 64
_BUFFERS = min(SPLIT_TILES, 3)   # kBuffers: min(kSplitTiles, kStages)

# kernel 6 (csrc/dither_matmul.cu)
DECODE_MAX_M = 128           # the decode regime: one row tile of the MMA
MIN_BLOCKS = SM_COUNT        # the decode model pick's floor at serve shapes
TARGET_BLOCKS = 4 * SM_COUNT  # at most: 4 blocks of 256 an SM, one wave
ROW_TILES = (1, 4, 16)       # launch_decode_mt: 8-row MMA tiles
_STRIP, _CHUNK = 16, 32      # decode: weight columns a block, K a chunk
PREFILL_BLOCK = (128, 128, 64)   # kBM, kBN, kBK: compile-time
_GEMM_SMEM = 3 * (128 + 128) * (64 + 16)   # kGemmSmem: 61,440 bytes


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def attention_smem_bytes(*, hd: int, rows: int, quantized: bool) -> int:
    """Dynamic shared memory of one block of kernels 1-4
    (``flash_decode.cuh:Layout::bytes``): the split's base words, two
    stages of K (rows padded by 16 bytes), V, both scales and the key
    positions for ``KERNEL_BLOCK`` keys, the block's query rows in f32 and
    each warp's softmax weights.  ``rows`` is kq·group, taken in chunks of
    at most 64 a block."""
    row_words = hd * (1 if quantized else 2) // 4
    stage = KERNEL_BLOCK * (row_words + 4) + KERNEL_BLOCK * row_words \
        + 3 * KERNEL_BLOCK
    chunk = min(rows, _MAX_ROWS)
    per_warp = _cdiv(chunk, _MAX_WARPS)
    nwarps = _cdiv(chunk, per_warp)
    base = (2 * SPLIT_TILES + 3) & ~3
    return 4 * (base + _BUFFERS * stage + chunk * hd
                + nwarps * _ROWS_PER_WARP * KERNEL_BLOCK)


def matmul_smem_bytes(block: tuple, *, m: int) -> int:
    """Shared memory of one block of kernel 6 at ``block``.  Decode regime
    (static, ``dither_matmul.cu:fused_decode`` over ``Dec``): two stages of
    a K group's weight rows and A's codes, the codes in fragment order,
    the int32 partial tile and the column sums — the largest of the f32,
    bf16 and transposed-bf16 weight layouts.  Prefill: the pipelined
    GEMM's three stages of 128 x 64-byte A and B tiles (dynamic)."""
    if m > DECODE_MAX_M:
        return _GEMM_SMEM
    mt = block[0]
    groups = 2 if mt >= 16 else 4          # Dec::kG
    rows_k = 32 * groups
    weight = max(rows_k * 16 * 4,          # f32, row-major
                 16 * (2 * rows_k + 32))   # bf16, the transposed view
    stage = weight + 8 * mt * rows_k
    return 2 * stage + groups * 4 * 33 * 4 + 8 * mt * 16 * 4 + 16 * 4 + 4


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------


def _tile_sizes(dim: int, quantum: int, ceiling: int) -> List[int]:
    """Power-of-two multiples of ``quantum`` up to min(dim, ceiling), falling
    back to the (smaller) dim itself (the reference's ``_tile_sizes``)."""
    sizes = []
    t = quantum
    while t <= min(dim, ceiling):
        sizes.append(t)
        t *= 2
    return sizes or [dim]


def decode_attention_candidates(cap: int, *, hd: int, group: int,
                                quantized: bool) -> List[Tuple[int]]:
    """(bk,) ring tiles of kernel 1: ``RING_TILES`` dividing ``cap`` and
    the largest divisor of ``cap`` up to ``KERNEL_BLOCK``; none where the
    working set of ``group`` rows at ``hd`` is over the opt-in limit."""
    if attention_smem_bytes(hd=hd, rows=group,
                            quantized=quantized) > SMEM_OPTIN_BYTES:
        return []
    tiles = {bk for bk in RING_TILES if cap % bk == 0}
    tiles.add(shrink_block(KERNEL_BLOCK, cap))
    return [(bk,) for bk in sorted(tiles)]


def verify_attention_candidates(cap: int, *, hd: int, kq: int, group: int,
                                quantized: bool) -> List[Tuple[int]]:
    """(bk,) ring tiles of kernel 3: the decode candidates, filtered
    through the working set of its kq·group rows."""
    if attention_smem_bytes(hd=hd, rows=kq * group,
                            quantized=quantized) > SMEM_OPTIN_BYTES:
        return []
    return decode_attention_candidates(cap, hd=hd, group=group,
                                       quantized=quantized)


def paged_attention_candidates(max_len: int, *, hd: int, group: int,
                               quantized: bool) -> List[Tuple[int]]:
    """(bs,) pool blocks of kernels 2 and 4: the reference's grid (powers
    of two from 8, up to ``max_len``; ``max_len`` itself below 8) capped
    at ``KERNEL_BLOCK``, the kernels' largest tile."""
    if attention_smem_bytes(hd=hd, rows=group,
                            quantized=quantized) > SMEM_OPTIN_BYTES:
        return []
    return [(bs,) for bs in _tile_sizes(max(1, max_len), 8, KERNEL_BLOCK)]


def _decode_pick(m: int, k: int, n: int) -> Tuple[int, int, int]:
    """The decode regime's model pick (``dither_matmul.plan``'s grid until
    the autotuner): the smallest row tile that holds every row; as many
    splits over K's 32-deep chunks as keep ``strips × splits`` within
    ``TARGET_BLOCKS``, one wave (a second wave would wait out the split
    merge's round trips again)."""
    mt = next(t for t in ROW_TILES if 8 * t >= m)
    strips, chunks = _cdiv(n, _STRIP), _cdiv(k, _CHUNK)
    cps = _cdiv(chunks, max(1, TARGET_BLOCKS // strips))
    return mt, cps, _cdiv(chunks, cps)


def matmul_candidates(m: int, k: int, n: int) -> List[tuple]:
    """Kernel 6's launch parameters at (m, k) @ (k, n).  Decode regime:
    ``(mt, cps, splits)`` for every row tile that holds m rows, with K
    chunks per block ``cps`` = 1 (every chunk a block of its own), the
    chunks over 1, 2, 4, ... splits, and the model pick's; prefill:
    ``PREFILL_BLOCK``."""
    if m > DECODE_MAX_M:
        return [PREFILL_BLOCK]
    chunks = _cdiv(k, _CHUNK)
    cps = {1, _decode_pick(m, k, n)[1]}
    s = 1
    while s <= chunks:
        cps.add(_cdiv(chunks, s))
        s *= 2
    return [(mt, c, _cdiv(chunks, c))
            for mt in ROW_TILES if 8 * mt >= m
            for c in sorted(cps)
            if matmul_smem_bytes((mt, c, 0), m=m) <= SMEM_STATIC_BYTES]


def quantize_candidates(m: int, n: int) -> List[tuple]:
    """Kernel 5 takes no launch parameter at run time: one candidate."""
    del m, n
    return [()]


def _dtype_name(dtype) -> str:
    """``torch.int8`` → ``"int8"`` (the reference's key spelling)."""
    return str(dtype).replace("torch.", "")


def _candidates(kind: str, shape: tuple, dtype: str) -> List[tuple]:
    q = "int8" in dtype
    if kind == "matmul":
        return matmul_candidates(*shape)
    if kind == "quantize":
        return quantize_candidates(*shape)
    if kind == "decode_attention":
        _b, cap, _nkv, group, hd = shape
        return decode_attention_candidates(cap, hd=hd, group=group,
                                           quantized=q)
    if kind == "verify_attention":
        _b, cap, _nkv, kq, group, hd = shape
        return verify_attention_candidates(cap, hd=hd, kq=kq, group=group,
                                           quantized=q)
    if kind == "paged_attention":
        _b, max_len, _nkv, group, hd = shape
        return paged_attention_candidates(max_len, hd=hd, group=group,
                                          quantized=q)
    raise ValueError(f"unknown kernel kind {kind!r}")


_CANDS: Dict[tuple, Tuple[tuple, ...]] = {}


def _candidate_set(kind: str, shape: tuple, dtype) -> Tuple[tuple, ...]:
    """``_candidates`` as a tuple, computed once per (kind, shape, dtype)."""
    key = (kind, shape, _dtype_name(dtype))
    hit = _CANDS.get(key)
    if hit is None:
        hit = _CANDS[key] = tuple(_candidates(*key))
    return hit


def check_block(kind: str, shape: tuple, dtype, block) -> tuple:
    """``block`` as a tuple if it is a candidate of ``kind`` at ``shape``;
    else ``ValueError`` (raised before any launch)."""
    block = tuple(int(x) for x in block)
    shape = tuple(shape)
    if block not in _candidate_set(kind, shape, dtype):
        raise ValueError(
            f"{kind} block {block} is not a candidate at shape {shape} "
            f"{_dtype_name(dtype)}: "
            f"{list(_candidate_set(kind, shape, dtype))}")
    return block


def model_block(kind: str, shape: tuple, dtype) -> tuple:
    """The card's model pick, no cache consulted: the largest ring tile
    (kernels 1 and 3: the fewest tiles a row, the split spans the most
    keys), the decode regime's ``_decode_pick`` (kernel 6), the
    reference's pool block rule (the largest candidate that still gives a
    full-length request ≥ 4 blocks, else the smallest), the one candidate
    (kernel 5 and kernel 6's prefill regime).  Raises ``ValueError``
    where no candidate fits."""
    shape = tuple(shape)
    cands = _candidate_set(kind, shape, dtype)
    if not cands:
        raise ValueError(f"no {kind} candidate fits the card at {shape} "
                         f"{_dtype_name(dtype)}")
    if kind == "matmul" and shape[0] <= DECODE_MAX_M:
        return _decode_pick(*shape)
    if kind == "paged_attention":
        max_len = shape[1]
        fitting = [c for c in cands if c[0] * 4 <= max_len]
        return max(fitting) if fitting else min(cands)
    return max(cands)


# ---------------------------------------------------------------------------
# winner cache: in-memory dict, optionally persisted to a JSON file
# ---------------------------------------------------------------------------

_CACHE: Dict[str, tuple] = {}
_CACHE_LOADED_FROM: Optional[str] = None


def cache_key(kind: str, shape: tuple, dtype, bits: int, scheme: str,
              backend: str) -> str:
    return "|".join([kind, "x".join(map(str, shape)), _dtype_name(dtype),
                     str(bits), scheme, backend])


def _key(kind: str, shape: tuple, dtype, bits: int, scheme: str,
         backend: str) -> str:
    """The winner's key: kernel 3 (verify, shape (B, cap, n_kv, kq, group,
    hd)) resolves to kernel 1's at its shape, so the two take one tile."""
    if kind == "verify_attention":
        b, cap, nkv, _kq, group, hd = shape
        kind, shape = "decode_attention", (b, cap, nkv, group, hd)
    return cache_key(kind, shape, dtype, bits, scheme, backend)


def _cache_path() -> Optional[str]:
    return os.environ.get("REPRO_AUTOTUNE_CACHE") or None


def load_cache(path: Optional[str] = None) -> Dict[str, tuple]:
    """Merge the JSON winner cache at ``path`` (or $REPRO_AUTOTUNE_CACHE)
    into the in-memory cache.  Missing/corrupt files are treated as empty."""
    global _CACHE_LOADED_FROM
    path = path or _cache_path()
    if path and os.path.exists(path):
        try:
            with open(path) as f:
                _CACHE.update({k: tuple(v) for k, v in json.load(f).items()})
            _CACHE_LOADED_FROM = path
        except (OSError, ValueError):
            pass
    return _CACHE


def save_cache(path: Optional[str] = None) -> Optional[str]:
    """Write the in-memory winners to ``path`` (or $REPRO_AUTOTUNE_CACHE):
    merged with what the file holds (this process's entries win on key
    conflicts), written to a temporary file and swapped in with
    ``os.replace``, so a concurrent reader or writer never sees a
    truncated cache.  Returns the path, or None without one."""
    path = path or _cache_path()
    if not path:
        return None
    merged: Dict[str, list] = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                merged.update(json.load(f))
        except (OSError, ValueError):
            pass
    merged.update({k: list(v) for k, v in _CACHE.items()})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(dict(sorted(merged.items())), f, indent=1)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def clear_cache() -> None:
    """Forget every winner, and that a file was loaded: the next lookup
    reads $REPRO_AUTOTUNE_CACHE again."""
    global _CACHE_LOADED_FROM
    _CACHE.clear()
    _RESOLVED.clear()
    _CACHE_LOADED_FROM = None


def best_block(kind: str, shape: tuple, dtype, bits: int, scheme: str,
               backend: str) -> tuple:
    """The cached winner if a sweep ran for this key (``ValueError`` if it
    is not a candidate at ``shape``: no fallback), else ``model_block``.
    Each call tells the observers which of the two it was."""
    if _cache_path() and _CACHE_LOADED_FROM != _cache_path():
        load_cache()
    shape = tuple(shape)
    key = _key(kind, shape, dtype, bits, scheme, backend)
    hit = _CACHE.get(key)
    if hit is not None:
        _notify("autotune_cache_hit", key=key, block=list(hit))
        return check_block(kind, shape, dtype, hit)
    _notify("autotune_model_pick", key=key)
    return model_block(kind, shape, dtype)


_RESOLVED: Dict[tuple, tuple] = {}


def resolve(kind: str, shape: tuple, dtype, bits: int, scheme: str,
            backend: str) -> tuple:
    """``best_block`` for a launch path that asks every call: the answer
    is kept per key and asked again only when the winner cache changed
    for that key (or $REPRO_AUTOTUNE_CACHE names another file), so the
    observers hear of each key once per change, as the reference's hear
    of it once per trace."""
    path = _cache_path()
    if path and _CACHE_LOADED_FROM != path:
        load_cache()
    args = (kind, tuple(shape), _dtype_name(dtype), bits, scheme, backend)
    hit = _RESOLVED.get(args)
    if hit is not None and _CACHE.get(hit[0]) == hit[1]:
        return hit[2]
    block = best_block(*args)
    key = _key(*args)
    _RESOLVED[args] = (key, _CACHE.get(key), block)
    return block


# ---------------------------------------------------------------------------
# measured sweeps
# ---------------------------------------------------------------------------


def _on_cuda(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, (tuple, list)):
        return any(_on_cuda(o) for o in out)
    return False


def _time_block(run: Callable[[tuple], object], block: tuple, repeats: int,
                launches: int) -> List[float]:
    """Seconds a call of ``run(block)``, ``repeats`` samples: one warm-up
    call outside them (a build, an allocation), then each sample times
    ``launches`` back-to-back calls — by CUDA events on the current stream
    when ``run`` returns CUDA tensors (a host clock would time the
    enqueue), by the host clock otherwise."""
    out = run(block)
    samples = []
    if _on_cuda(out):
        torch.cuda.synchronize()
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(launches):
                run(block)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / 1e3 / launches)
        return samples
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(launches):
            run(block)
        samples.append((time.perf_counter() - t0) / launches)
    return samples


def _sweep(kind: str, shape: tuple, dtype, bits: int, scheme: str,
           backend: str, candidates: List[tuple],
           run: Callable[[tuple], object], repeats: int, launches: int):
    """Time every candidate, cache the least time's (the first among ties)
    and return ``(winner, results sorted by seconds)``; each result holds
    its block, ``seconds`` (its least sample) and every sample.  A
    candidate whose runner raises ``ValueError`` (a wrapper's check,
    before any launch) is dropped; any other error propagates: a CUDA
    fault leaves the context unusable."""
    key = _key(kind, shape, dtype, bits, scheme, backend)
    recompute = key in _CACHE
    t0 = time.perf_counter()
    results = []
    for block in candidates:
        try:
            samples = _time_block(run, tuple(block), repeats, launches)
        except ValueError:
            continue
        results.append({"block": list(block), "seconds": min(samples),
                        "samples": samples})
    if not results:
        raise RuntimeError(f"no runnable {kind} block candidate for {shape}")
    results.sort(key=lambda r: r["seconds"])
    winner = tuple(results[0]["block"])
    _CACHE[key] = winner
    save_cache()
    _notify("autotune_sweep", key=key, winner=list(winner),
            candidates=len(results), recompute=recompute,
            sweep_s=time.perf_counter() - t0)
    return winner, results


def autotune_matmul(m: int, k: int, n: int, *, bits: int, scheme: str,
                    backend: str, run: Callable[[tuple], object],
                    dtype="float32", repeats: int = 5, launches: int = 20,
                    candidates: Optional[List[tuple]] = None):
    """Measure ``run(block)`` over kernel 6's candidates at (m, k, n),
    cache and return the winner.  ``dtype``: the operands' (``float32``
    for the f32 entry, ``bfloat16`` for the policy entry).  Returns
    (winner_block, per-candidate results sorted by time)."""
    cands = candidates or matmul_candidates(m, k, n)
    return _sweep("matmul", (m, k, n), dtype, bits, scheme, backend, cands,
                  run, repeats, launches)


def autotune_quantize(m: int, n: int, *, bits: int, scheme: str, backend: str,
                      run: Callable[[tuple], object], dtype="float32",
                      repeats: int = 5, launches: int = 20,
                      candidates: Optional[List[tuple]] = None):
    """Kernel 5's sweep: its one candidate, timed and cached."""
    cands = candidates or quantize_candidates(m, n)
    return _sweep("quantize", (m, n), dtype, bits, scheme, backend, cands,
                  run, repeats, launches)


def autotune_decode_attention(b: int, cap: int, nkv: int, group: int, hd: int,
                              *, backend: str, run: Callable[[tuple], object],
                              dtype="int8", repeats: int = 5,
                              launches: int = 20,
                              candidates: Optional[List[tuple]] = None):
    """Measured (bk,) sweep of kernel 1.  ``dtype`` is the cache's storage
    dtype ('int8' or 'bfloat16'); bits follow from it.  The winner is
    kernel 3's tile too."""
    quantized = "int8" in _dtype_name(dtype)
    cands = candidates or decode_attention_candidates(
        cap, hd=hd, group=group, quantized=quantized)
    return _sweep("decode_attention", (b, cap, nkv, group, hd), dtype,
                  8 if quantized else 16, "flash", backend, cands, run,
                  repeats, launches)


def autotune_verify_attention(b: int, cap: int, nkv: int, kq: int,
                              group: int, hd: int, *, backend: str,
                              run: Callable[[tuple], object],
                              dtype="int8", repeats: int = 5,
                              launches: int = 20,
                              candidates: Optional[List[tuple]] = None):
    """Measured (bk,) sweep of kernel 3 over its candidates at draft depth
    ``kq``.  Its winner lands under kernel 1's key (``_key``): the two
    kernels take one tile, set by whichever of the two sweeps ran last."""
    quantized = "int8" in _dtype_name(dtype)
    cands = candidates or verify_attention_candidates(
        cap, hd=hd, kq=kq, group=group, quantized=quantized)
    return _sweep("verify_attention", (b, cap, nkv, kq, group, hd), dtype,
                  8 if quantized else 16, "flash", backend, cands, run,
                  repeats, launches)


def autotune_paged_attention(b: int, max_len: int, nkv: int, group: int,
                             hd: int, *, backend: str,
                             run: Callable[[tuple], object],
                             dtype="int8", repeats: int = 5,
                             launches: int = 20,
                             candidates: Optional[List[tuple]] = None):
    """Measured (bs,) pool-block sweep of kernels 2 and 4.

    ``run((bs,))`` must decode over a pool with that block size — the
    block is baked into the pool's layout, so each candidate has a pool of
    its own (built in the runner's first, untimed, call).  The winner is
    what the engine (``kv_layout='paged'``) takes when no ``block_size``
    is given."""
    quantized = "int8" in _dtype_name(dtype)
    cands = candidates or paged_attention_candidates(
        max_len, hd=hd, group=group, quantized=quantized)
    return _sweep("paged_attention", (b, max_len, nkv, group, hd), dtype,
                  8 if quantized else 16, "flash", backend, cands, run,
                  repeats, launches)
