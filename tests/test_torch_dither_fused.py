"""Kernel 6's policy entry and the host side of the redesigned dither
kernels, on the CPU: the plain version of the policy's product
(``ref.dither_matmul_scaled_ref``, which ``dither_matmul_scaled`` takes on
CPU tensors) against the reference's ``_fused_matmul``; the kernels'
``Params`` (``quantize.quant_params``) through a Python mirror of
``csrc/dither_quant.cuh``'s per-element arithmetic; the multiply-high
modulo; the decode regime's grid plan; and the weight-absmax cache.

Every comparison is bitwise: integer codes, exact integer products and the
same f32 and bf16 operations in the same order.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.numerics import policy as ref_policy
from repro_torch.core import rounding
from repro_torch.kernels import dither_matmul as dm
from repro_torch.kernels import quantize as qk
from repro_torch.kernels import ref
from repro_torch.numerics import policy
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCHEMES = ["deterministic", "stochastic", "dither"]
# the serve path's pulse counts (N_A = N, N_B = max(M, 2)) and odd ones
DIVISORS = [2, 8, 192, 576, 1536, 49152, 1, 3, 7, 641, 6700417,
            2 ** 31 - 1, 2 ** 31 + 1, 2 ** 32 - 1]
SERVE_DECODE = [(8, 576, 576), (8, 576, 192), (8, 576, 1536),
                (8, 1536, 576), (8, 576, 49152)]


def _u32_bits(t):
    return t.float().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# the policy's product: plain version against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_scaled_ref_is_the_references_fused_matmul(scheme, transposed):
    """``dither_matmul_scaled_ref`` (and the wrapper on CPU tensors) equals
    the reference's ``_fused_matmul`` on its ``xla-ref`` backend bit for
    bit: bf16 operands, decode- and prefill-like and ragged shapes, the
    weight row-major or the transposed view of an (N, K) tensor (the tied
    LM head), counters past 2^16."""
    rng = np.random.default_rng(20 + SCHEMES.index(scheme))
    rp = ref_policy.QuantPolicy(scheme=scheme, backend="xla-ref")
    for m, k, n in ((8, 128, 384), (3, 40, 24), (5, 7, 3), (19, 96, 50)):
        x = rng.normal(size=(m, k)).astype(np.float32)
        w = (rng.normal(size=(n, k) if transposed else (k, n)) * 0.05
             ).astype(np.float32)
        tx = torch.from_numpy(x).bfloat16()
        tw = torch.from_numpy(w).bfloat16()
        jx = jnp.asarray(x, jnp.bfloat16)
        jw = jnp.asarray(w, jnp.bfloat16)
        if transposed:
            tw, jw = tw.T, jw.T
        for counter, seed in ((0, 1), (70001, 9)):
            want = ref_policy._fused_matmul(jx, jw, rp, seed, counter)
            kw = dict(bits=8, scheme=scheme, counter=counter, seed=seed)
            got = ref.dither_matmul_scaled_ref(tx, tw, **kw)
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                _u32_bits(got), np.asarray(want, np.float32).view(np.uint32))
            before = dm.dither_matmul.launches
            via = dm.dither_matmul_scaled(tx, tw, dm.weight_absmax(tw), **kw)
            assert torch.equal(via, got)
            assert dm.dither_matmul.launches == before


def test_fused_matmul_keeps_its_route_off_the_card():
    """On CPU tensors the policy's fused product takes the torch ops around
    the plain dither matmul (no kernel launch), bit for bit the policy
    entry's plain version."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(6, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(64, 40)).astype(np.float32) * .05)
    x, w = x.bfloat16(), w.bfloat16()
    pol = policy.QuantPolicy(scheme="dither", backend="auto").resolved("cpu")
    n0 = (dm.dither_matmul.launches, dm.dither_matmul_scaled.launches)
    got = policy._fused_matmul(x, w, pol, 4, 11.0)
    assert torch.equal(got, ref.dither_matmul_scaled_ref(
        x, w, bits=8, scheme="dither", counter=11, seed=4))
    assert (dm.dither_matmul.launches,
            dm.dither_matmul_scaled.launches) == n0


def test_scaled_wrapper_refuses_other_devices():
    x = torch.zeros((2, 4), dtype=torch.bfloat16, device="meta")
    w = torch.zeros((4, 3), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="runs on cuda"):
        dm.dither_matmul_scaled(x, w, torch.zeros((), device="meta"),
                                bits=8)


# ---------------------------------------------------------------------------
# the kernels' Params, through a mirror of dither_quant.cuh
# ---------------------------------------------------------------------------


def _mulhi(x: torch.Tensor, c: int) -> torch.Tensor:
    """floor(x * c / 2^32) for uint32 x (int64 tensor) and c < 2^32, with
    every partial product below 2^49."""
    return ((x >> 16) * c + (((x & 0xFFFF) * c) >> 16)) >> 16


def _mod_n(x: torch.Tensor, p) -> torch.Tensor:
    """dither_quant.cuh:mod_n on uint32 values held in int64."""
    t = _mulhi(x, p.magic)
    q = (t + ((x - t) >> p.sh1)) >> p.sh2
    return x - q * p.n_pulses


def _mirror_codes(x: torch.Tensor, p) -> torch.Tensor:
    """dither_quant.cuh:quantize of every element of a 2-D f32 tensor (row-
    major index), from the Params alone: h0, key and c2 in place of the
    seed and counter, the multiply-high modulo, and the dither pulse with
    its one division."""
    mask = rounding._MASK
    idx = rounding._flat_index(x)
    scaled = (x - p.zero) * p.scale
    fl = torch.floor(scaled)
    frac = scaled - fl
    h = rounding._mix(p.h0 ^ rounding._mul32(idx, rounding._M1))
    u = (rounding._mix(h ^ p.c2) >> 8).to(torch.float32) * (1.0 / (1 << 24))
    if p.scheme == qk.SCHEMES["deterministic"]:
        code = torch.floor(scaled + 0.5)
    elif p.scheme == qk.SCHEMES["stochastic"]:
        code = fl + (u < frac).to(torch.float32)
    else:
        phase = rounding._mix(idx ^ p.key)
        slot = _mod_n((p.counter + phase) & mask, p)
        if p.fmt == qk.FMTS["spread"]:
            slot = _mod_n((rounding._mul32(slot, p.mult) + (phase >> 8))
                          & mask, p)
        lo = frac <= 0.5
        nf = p.n_f * frac
        n = torch.where(lo, torch.floor(nf), torch.ceil(nf))
        num = torch.where(lo, nf - n, n - nf)
        den = torch.where(lo, p.n_f - n, n)
        delta = torch.where(den > 0, num / torch.clamp_min(den, 1.0), 0.0)
        head = slot.to(torch.float32) < n
        prob = torch.where(lo, torch.where(head, 1.0, delta),
                           torch.where(head, 1.0 - delta, 0.0))
        code = fl + (u < prob).to(torch.float32)
    return torch.clamp(code, 0.0, p.levels).to(torch.int32)


def test_params_layout_is_the_kernels():
    """15 four-byte fields, as ``Params`` in ``dither_quant.cuh``."""
    assert ctypes.sizeof(qk.QuantParams) == 60
    assert [f for f, _ in qk.QuantParams._fields_][:6] == [
        "scale", "zero", "levels", "n_f", "scheme", "fmt"]


@pytest.mark.parametrize("fmt", ["spread", "unary"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_params_mirror_gives_the_plain_codes(scheme, fmt):
    """The kernels' per-element arithmetic, fed only ``quant_params``,
    gives ``quantize_codes_ref``'s codes bit for bit: pulse counts of the
    serve path and odd ones, counters and seeds past 2^31, values within
    an ulp of a code boundary."""
    rng = np.random.default_rng(SCHEMES.index(scheme))
    for bits, n_pulses, counter, seed in ((8, 16, 0, 1), (8, 576, 2 ** 31 + 9,
                                                          7),
                                          (4, 49152, 5, 2 ** 32 - 1),
                                          (2, 3, 77, 3), (8, 1536, 12, 0),
                                          (1, 2, 1, 5)):
        levels = (1 << bits) - 1
        base = (rng.integers(0, levels + 1, size=(24, 37))
                + rng.choice([0.0, 0.5, 0.3], size=(24, 37))) / levels * 2 - 1
        x = torch.from_numpy(np.nextafter(
            base.astype(np.float32), np.float32(9)).astype(np.float32))
        kw = dict(scale=levels / 2.0, zero=-1.0, bits=bits, scheme=scheme,
                  counter=counter, seed=seed, n_pulses=n_pulses, fmt=fmt)
        p = qk.quant_params(**kw)
        assert torch.equal(_mirror_codes(x, p), ref.quantize_codes_ref(x, **kw))


@pytest.mark.parametrize("d", DIVISORS)
def test_modulo_magic_is_exact(d):
    """The kernels' ``x % d`` by multiply-high (``fastmod_magic``) equals
    ``%`` on the edge numerators — 0, d − 1, d, d + 1, 2^32 − 1, around
    2^31, the multiples of d next to 2^32, and the values ``a · q`` wraps
    to in the LCG step — and on random ones; the torch mirror of the
    kernel agrees."""
    magic, sh1, sh2 = qk.fastmod_magic(d)
    assert 0 < magic < 1 << 32 and sh1 in (0, 1) and 0 <= sh2 <= 31
    top = (1 << 32) - 1
    mult = rounding._coprime_multiplier(d)
    edges = {0, 1, d - 1, d, d + 1, 2 * d - 1, top, top - 1, 1 << 31,
             (1 << 31) - 1, (1 << 31) + 1, top // d * d, top // d * d - 1}
    edges |= {(mult * q + r) & top for q in (d - 1, d // 2, 1 << 16)
              for r in (0, (1 << 24) - 1)}
    rng = np.random.default_rng(d % 1000)
    xs = sorted(v for v in edges | set(rng.integers(0, 1 << 32, 4000,
                                                    dtype=np.uint64).tolist())
                if 0 <= v <= top)
    for x in xs:
        assert qk.fastmod(x, d, magic, sh1, sh2) == x % d, x
    p = qk.quant_params(scale=1.0, zero=0.0, bits=8, scheme="dither",
                        fmt="spread", seed=0, counter=0, n_pulses=d)
    t = torch.tensor(xs, dtype=torch.int64)
    assert torch.equal(_mod_n(t, p), t % d)


def test_modulo_magic_refuses_out_of_range():
    for d in (0, 1 << 32):
        with pytest.raises(ValueError):
            qk.fastmod_magic(d)


# ---------------------------------------------------------------------------
# the decode regime's plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", SERVE_DECODE + [
    (1, 7, 3), (128, 600, 200), (37, 100, 53), (8, 64, 16), (16, 4096, 8),
    (100, 32, 5000)])
def test_decode_plan_covers_every_column_and_chunk_once(m, k, n):
    """Every 16-column strip and every 32-row K chunk belongs to exactly
    one block of the grid; the 8-row MMA tiles hold every row; at the serve
    path's decode shapes the grid has at least 132 blocks."""
    p = dm.plan(m, k, n)
    assert p["regime"] == "decode"
    assert 8 * p["mt"] >= m and p["mt"] in (1, 4, 16)
    assert p["strips"] * 16 >= n > (p["strips"] - 1) * 16
    assert p["chunks"] * 32 >= k > (p["chunks"] - 1) * 32
    seen = np.zeros(p["chunks"], np.int64)
    for s in range(p["splits"]):
        lo, hi = s * p["cps"], min(p["chunks"], (s + 1) * p["cps"])
        assert hi > lo
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert p["blocks"] == p["strips"] * p["splits"]
    if (m, k, n) in SERVE_DECODE:
        assert p["blocks"] >= dm.MIN_BLOCKS
    elif p["blocks"] < dm.MIN_BLOCKS:     # only where K has too few chunks
        assert p["splits"] == p["chunks"]


@pytest.mark.parametrize("m,k,n", [(129, 576, 200), (4096, 576, 1536),
                                   (300, 100, 49152)])
def test_prefill_plan_pads_to_the_tiles(m, k, n):
    p = dm.plan(m, k, n)
    assert p["regime"] == "prefill"
    assert p["mp"] % 128 == 0 and p["mp"] - 128 < m <= p["mp"]
    assert p["np"] % 128 == 0 and p["np"] - 128 < n <= p["np"]
    assert p["kp"] % 64 == 0 and p["kp"] - 64 < k <= p["kp"]
    assert p["blocks"] == (p["mp"] // 128) * (p["np"] // 128)


# ---------------------------------------------------------------------------
# the weight-absmax cache
# ---------------------------------------------------------------------------


def test_weight_absmax_is_cached_and_follows_in_place_updates():
    """Computed once per weight (the same tensor comes back), equal to the
    policy's ``clamp_min(max |w|, 1e-6)``; an in-place update of the
    weight, or of the tensor a transposed view was taken from, recomputes
    it."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((64, 32), generator=gen).bfloat16()
    a = dm.weight_absmax(w)
    assert dm.weight_absmax(w) is a
    assert a.dim() == 0 and a.dtype == torch.bfloat16
    assert torch.equal(a, ref.policy_absmax(w))
    w.mul_(3)
    b = dm.weight_absmax(w)
    assert b is not a and torch.equal(b, ref.policy_absmax(w))
    assert not torch.equal(a, b)
    emb = torch.randn((48, 32), generator=gen).bfloat16()
    t = dm.weight_absmax(emb.T)
    assert dm.weight_absmax(emb.T) is t       # a new view, the same storage
    assert torch.equal(t, ref.policy_absmax(emb))
    emb[0, 0] = 100.0
    assert float(dm.weight_absmax(emb.T)) == 100.0


def test_weight_absmax_does_not_outlive_its_tensor():
    """A new tensor at a freed tensor's address does not inherit its
    absmax: the cache holds the owner weakly and checks it."""
    w = torch.full((16, 8), 2.0, dtype=torch.bfloat16)
    assert float(dm.weight_absmax(w)) == 2.0
    ptr = w.data_ptr()
    del w
    for _ in range(8):
        v = torch.full((16, 8), 5.0, dtype=torch.bfloat16)
        assert float(dm.weight_absmax(v)) == 5.0
        if v.data_ptr() == ptr:
            break
        del v
