"""The port's quantisers and its quantise-and-multiply — the plain versions
of CUDA kernels 5 and 6 (``kernels/ref.py``: ``quantize_codes_ref``,
``dither_matmul_ref``), the dispatch entry points, the rounding schemes of
``core/rounding.py``, ``core/quantizers.py`` and ``core/matmul.py`` —
against the reference's, on the same f32 inputs made with numpy.

What is held, and how tightly:

* **Codes are bitwise** the reference's ``xla-ref`` codes (jitted, the
  unpadded global row-major hash index), over the three schemes, both
  pulse formats, bits 1–16 and ragged shapes, adversarial inputs within an
  ulp of a rounding boundary included; and bitwise the Pallas kernel body
  in interpret mode at block-multiple shapes (off them the reference's
  ``ops.quantize_2d`` hashes with the padded width, its own NOTE).
* **The dither matmul is bitwise** ``xla-ref`` wherever K·(2^bits−1)² <
  2^24, where the reference's f32 dot of integer codes is exact: the port
  computes the integer product exactly and then the reference's
  dequantisation as it runs compiled (``ref.dequant_constants``: each
  division by a constant a multiplication by its f32 reciprocal, the first
  sum a fused multiply-add).  Above 2^24 the reference's f32 sum rounds
  and the port's does not: held to the rounding bound of a K-term f32 sum
  (``_sum_bound``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import matmul as ref_matmul
from repro.core import quantizers as ref_quantizers
from repro.core import rounding as ref_rounding
from repro.kernels import dispatch as ref_dispatch
from repro.kernels import ref as ref_kref
from repro_torch.core import matmul as port_matmul
from repro_torch.core import quantizers as port_quantizers
from repro_torch.core import rounding as port_rounding
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import dither_matmul as dm
from repro_torch.kernels import quantize as qk
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCHEMES = ["deterministic", "stochastic", "dither"]
FORMATS = ["spread", "unary"]


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _uniform(rng, shape, lo, hi):
    return rng.uniform(lo, hi, size=shape).astype(np.float32)


def _near_boundaries(rng, n, bits, lo, hi):
    """f32 values within an ulp of a code boundary (k and k + 1/2 on the
    scaled grid), where a fused multiply-add or a rounded constant would
    move a code."""
    levels = (1 << bits) - 1
    scale = levels / (hi - lo)
    base = (rng.integers(0, levels, size=n)
            + rng.choice([0.5, 0.0, 0.25], size=n)) / scale + lo
    x = base.astype(np.float32)
    away = np.where(rng.random(n) < 0.5, np.float32(-10), np.float32(10))
    return np.nextafter(x, away)


# ---------------------------------------------------------------------------
# core/rounding.py: the three rounding schemes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(7,), (5, 33), (2, 3, 17)])
def test_rounding_schemes_bitwise(shape):
    """``deterministic_round``, ``stochastic_round`` and ``dither_round``
    (scalar counters, and a per-element counter tensor for dither) on f32
    inputs of both signs give the reference's values bit for bit."""
    rng = np.random.default_rng(len(shape))
    x = _uniform(rng, shape, -9.0, 9.0)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_array_equal(
        _bits(port_rounding.deterministic_round(tx).numpy()),
        _bits(ref_rounding.deterministic_round(jx)))
    for seed, counter in ((0, 0), (7, 12345), (2**31 + 5, 2**32 - 2)):
        jc = jnp.uint32(counter)          # the reference's jit takes no
        np.testing.assert_array_equal(    # Python int ≥ 2^31
            _bits(port_rounding.stochastic_round(tx, seed, counter).numpy()),
            _bits(ref_rounding.stochastic_round(jx, seed, jc)))
        for n in (2, 16, 1000):
            np.testing.assert_array_equal(
                _bits(port_rounding.dither_round(tx, counter, seed,
                                                 n).numpy()),
                _bits(ref_rounding.dither_round(jx, jc, jnp.uint32(seed), n)))
    ctr = rng.integers(0, 2**31, size=shape).astype(np.int32)
    np.testing.assert_array_equal(
        _bits(port_rounding.dither_round(tx, torch.from_numpy(ctr), 3,
                                         16).numpy()),
        _bits(ref_rounding.dither_round(jx, jnp.asarray(ctr), 3, 16)))


# ---------------------------------------------------------------------------
# kernel 5's plain version: codes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_codes_bitwise_against_xla_ref(scheme, fmt):
    """``dispatch.quantize`` (the plain version on the CPU) against the
    reference's jitted ``xla-ref``: bits 1–16, ranges of both signs, ragged
    shapes, boundary-hugging inputs, counters and seeds past 2^31."""
    rng = np.random.default_rng(SCHEMES.index(scheme) * 2 + FORMATS.index(fmt))
    cases = [((37, 100), 8, -1.0, 1.0), ((1, 7), 2, 0.0, 1.0),
             ((48, 96), 4, -0.7, 1.3), ((13, 129), 1, 0.0, 1.0),
             ((16, 64), 12, -3.0, -1.0), ((9, 31), 16, -1.0, 1.0)]
    for shape, bits, lo, hi in cases:
        n = shape[0] * shape[1]
        x = np.concatenate([_near_boundaries(rng, n // 2, bits, lo, hi),
                            _uniform(rng, n - n // 2, lo - 0.2, hi + 0.2)]
                           ).reshape(shape)
        for counter, seed, n_pulses in ((0, 0, 16), (2**31 + 3, 2**32 - 1, 7),
                                        (977, 11, 1024)):
            kw = dict(bits=bits, lo=lo, hi=hi, scheme=scheme,
                      counter=counter, seed=seed, n_pulses=n_pulses, fmt=fmt)
            want = np.asarray(ref_dispatch.quantize(
                jnp.asarray(x), backend="xla-ref",
                **{**kw, "counter": jnp.uint32(counter).astype(jnp.int32),
                   "seed": jnp.uint32(seed).astype(jnp.int32)}))
            got = dispatch.quantize(torch.from_numpy(x), **kw)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{shape} {bits} {counter}")


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_codes_bitwise_against_pallas_interpret(scheme, fmt):
    """The TPU kernel's own body in interpret mode, at a block-multiple
    shape (two by two tiles), gives the same codes; so do the reference's
    ``dither_round_ref`` / ``stochastic_round_ref`` and the port's."""
    rng = np.random.default_rng(7)
    x = _uniform(rng, (64, 96), -1.1, 1.1)
    kw = dict(bits=6, lo=-1.0, hi=1.0, scheme=scheme, counter=5, seed=3,
              n_pulses=16, fmt=fmt)
    want = np.asarray(ref_dispatch.quantize(
        jnp.asarray(x), backend="pallas-interpret", block=(32, 48), **kw))
    got = dispatch.quantize(torch.from_numpy(x), backend="torch-ref", **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    if fmt == "spread" and scheme != "deterministic":
        sc = dict(scale=63 / 2.0, zero=-1.0, bits=6, counter=5, seed=3)
        fn = "dither_round_ref" if scheme == "dither" else \
            "stochastic_round_ref"
        extra = {"n_pulses": 16} if scheme == "dither" else {}
        np.testing.assert_array_equal(
            getattr(ref, fn)(torch.from_numpy(x), **sc, **extra).numpy(),
            np.asarray(getattr(ref_kref, fn)(jnp.asarray(x), **sc, **extra)))


# ---------------------------------------------------------------------------
# kernel 6's plain version: the quantise-and-multiply
# ---------------------------------------------------------------------------

# (M, K, N), range of both operands, bits: every K·(2^bits−1)² < 2^24
MATMUL_CASES = [((8, 128, 384), (-1.0, 1.0), 8), ((37, 100, 53), (-1.0, 1.0), 4),
                ((64, 256, 256), (-1.0, 1.0), 8), ((5, 7, 3), (-0.7, 1.3), 2),
                ((16, 96, 512), (0.0, 1.0), 8), ((1, 128, 9), (0.25, 2.0), 8),
                ((37, 100, 53), (-0.7, 1.3), 8), ((8, 128, 384), (0.0, 1.0), 2)]


def _sum_bound(k, bits, a_range, b_range):
    """How far the reference's f32 dot of K integer codes may round, at
    most, above 2^24 (K − 1 additions of at most half an ulp of the largest
    partial sum), mapped to the output's scale, plus four ulps of the
    epilogue's largest intermediate (the two sides round it from different
    sums)."""
    _, _, r_acc, c_col, c_row, _ = ref.dequant_constants(bits, a_range,
                                                         b_range, k)
    top = float(k * ((1 << bits) - 1) ** 2)
    big = max(top * r_acc, abs(c_col) * top, abs(c_row) * top, 1.0)
    return (r_acc * (k - 1) * np.spacing(np.float32(top)) / 2
            + 4 * np.spacing(np.float32(big)))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_matmul_bitwise_against_xla_ref(scheme, fmt):
    """``dispatch.matmul`` against the reference's jitted ``xla-ref`` over
    ranges of both signs (the cross terms) and bits 2/4/8, at ragged shapes
    with K·(2^bits−1)² < 2^24: bit for bit."""
    rng = np.random.default_rng(11 + SCHEMES.index(scheme))
    for (m, k, n), rg, bits in MATMUL_CASES:
        assert k * ((1 << bits) - 1) ** 2 < 2 ** 24
        a = _uniform(rng, (m, k), rg[0] - 0.1, rg[1] + 0.1)
        b = _uniform(rng, (k, n), rg[0] - 0.1, rg[1] + 0.1)
        kw = dict(bits=bits, scheme=scheme, counter=3, seed=5, a_range=rg,
                  b_range=rg, fmt=fmt)
        want = ref_dispatch.matmul(jnp.asarray(a), jnp.asarray(b),
                                   backend="xla-ref", **kw)
        got = dispatch.matmul(torch.from_numpy(a), torch.from_numpy(b), **kw)
        assert got.dtype == torch.float32 and got.shape == (m, n)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want),
                                      err_msg=f"{(m, k, n)} {rg} bits {bits}")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_matmul_above_exact_f32_range(scheme):
    """At K = 1024 and 1536 (SmolLM's widest K) and 8 bits, K·255² passes
    2^24: the port's exact integer product may differ from the reference's
    rounded f32 sum, within ``_sum_bound``."""
    rng = np.random.default_rng(3)
    for (m, k, n) in ((8, 1024, 64), (16, 1536, 96)):
        a, b = _uniform(rng, (m, k), -1, 1), _uniform(rng, (k, n), -1, 1)
        kw = dict(bits=8, scheme=scheme, counter=3, seed=5,
                  a_range=(-1.0, 1.0), b_range=(-1.0, 1.0))
        want = np.asarray(ref_dispatch.matmul(jnp.asarray(a), jnp.asarray(b),
                                              backend="xla-ref", **kw))
        got = dispatch.matmul(torch.from_numpy(a), torch.from_numpy(b),
                              **kw).numpy()
        bound = _sum_bound(k, 8, (-1.0, 1.0), (-1.0, 1.0))
        assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(),
                                                   bound)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_matmul_bitwise_against_pallas_interpret(scheme):
    """The TPU kernel body in interpret mode, tiled (2 × 2 × 2 blocks, so
    its f32 accumulator sums over K tiles, exact below 2^24), at a
    block-multiple shape: bit for bit."""
    rng = np.random.default_rng(5)
    a, b = _uniform(rng, (64, 128), -1, 1), _uniform(rng, (128, 96), -1, 1)
    kw = dict(bits=8, scheme=scheme, counter=9, seed=2, a_range=(-1.0, 1.0),
              b_range=(-1.0, 1.0))
    want = ref_dispatch.matmul(jnp.asarray(a), jnp.asarray(b),
                               backend="pallas-interpret", block=(32, 48, 64),
                               **kw)
    got = dispatch.matmul(torch.from_numpy(a), torch.from_numpy(b), **kw)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_fma_emulation_is_exact():
    """``ref.fma_f32`` rounds ``a·b + c`` once, as a hardware fused
    multiply-add: against an exact rational evaluation, on values chosen so
    that the f64 sum lands on f32 rounding ties."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**20, size=400).astype(np.float32)
    b = np.float32(1) / np.float32(16256.25)
    c = (rng.normal(size=400) * 64).astype(np.float32)
    # ties: c = -(a·b) rounded + half an f32 ulp of the result, then nudged
    # by the product's low bits
    p32 = (a.astype(np.float64) * float(b)).astype(np.float32)
    c[:200] = (-(p32[:200].astype(np.float64))
               + np.spacing(np.abs(p32[:200])) * 1.5).astype(np.float32)
    got = ref.fma_f32(torch.from_numpy(a), float(b),
                       torch.from_numpy(c)).numpy()
    for ai, ci, gi in zip(a, c, got):
        exact = Fraction(float(ai)) * Fraction(float(b)) + Fraction(float(ci))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.uint32)) & 1))
        assert gi == best, (ai, ci, gi, best)


def test_dequant_constants_are_the_compiled_references():
    """The constants are what XLA folds: 1/(sa·sb) in f32 and the zero
    times the f32 reciprocal, e.g. -1/127.5 at 8 bits over [-1, 1]."""
    sa, sb, r_acc, c_col, c_row, c_k = ref.dequant_constants(
        8, (-1.0, 1.0), (-1.0, 1.0), 576)
    assert (sa, sb) == (127.5, 127.5)
    assert r_acc == float(np.float32(1) / np.float32(16256.25))
    assert c_col == c_row == float(np.float32(-1) / np.float32(127.5))
    assert c_k == 576.0


# ---------------------------------------------------------------------------
# dispatch and the wrappers' device rule
# ---------------------------------------------------------------------------


def test_dispatch_backends_and_policy_resolution():
    """``auto``/None pick by device; ``cuda`` on CPU tensors and unknown
    names raise; the policy resolver passes the unfused name through and
    pins ``auto`` by device."""
    x = torch.zeros((4, 8))
    assert dispatch.resolve_backend(None, x) == "torch-ref"
    assert dispatch.resolve_backend("auto", x) == "torch-ref"
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        dispatch.matmul(x, torch.zeros((8, 3)), bits=8, backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        dispatch.quantize(x, bits=8, backend="cuda")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        dispatch.quantize(x, bits=8, backend="pallas")
    rp = dispatch.resolve_policy_backend
    assert rp("torch") == rp("torch", "cuda") == "torch"
    assert rp("auto") == "auto" and rp("auto", "cpu") == "torch-ref"
    assert rp("auto", torch.device("cuda", 0)) == "cuda"
    assert rp("torch-ref", "cuda") == "torch-ref"
    with pytest.raises(ValueError, match="unknown kernel backend"):
        rp("jnp")


def test_wrappers_take_cpu_to_the_plain_version_and_refuse_others():
    """On CPU tensors each wrapper runs its plain version (no launch
    counted); a tensor on any other non-CUDA device raises."""
    rng = np.random.default_rng(1)
    a, b = _uniform(rng, (6, 40), -1, 1), _uniform(rng, (40, 10), -1, 1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    n_mm, n_q = dm.dither_matmul.launches, qk.quantize.launches
    kw = dict(bits=8, scheme="dither", a_range=(-1.0, 1.0),
              b_range=(-1.0, 1.0), counter=4, seed=1)
    assert torch.equal(dm.dither_matmul(ta, tb, **kw),
                       ref.dither_matmul_ref(ta, tb, **kw))
    qkw = dict(scale=127.5, zero=-1.0, bits=8, scheme="stochastic",
               counter=2, seed=9, n_pulses=16)
    assert torch.equal(qk.quantize(ta, **qkw),
                       ref.quantize_codes_ref(ta, **qkw))
    assert (dm.dither_matmul.launches, qk.quantize.launches) == (n_mm, n_q)
    with pytest.raises(ValueError, match="runs on cuda"):
        dm.dither_matmul(ta.to("meta"), tb.to("meta"), **kw)
    with pytest.raises(ValueError, match="runs on cuda"):
        qk.quantize(ta.to("meta"), **qkw)


# ---------------------------------------------------------------------------
# core/quantizers.py and core/matmul.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", SCHEMES)
def test_quantizers_bitwise(scheme):
    """``quantize``, ``dequantize`` and ``quantize_dequantize`` of
    ``QuantSpec``s with constants that f32 does not hold exactly."""
    rng = np.random.default_rng(2)
    for bits, lo, hi in ((4, 0.0, 1.0), (8, -1.0, 1.0), (3, -0.3, 0.7)):
        x = _uniform(rng, (9, 21), lo - 0.1, hi + 0.1)
        js = ref_quantizers.QuantSpec(bits, lo, hi)
        ps = port_quantizers.QuantSpec(bits, lo, hi)
        assert (ps.levels, ps.scale) == (js.levels, js.scale)
        kw = dict(counter=7, seed=4, n_pulses=8)
        codes = port_quantizers.quantize(torch.from_numpy(x), ps, scheme,
                                         **kw)
        np.testing.assert_array_equal(
            codes.numpy(),
            np.asarray(ref_quantizers.quantize(jnp.asarray(x), js, scheme,
                                               **kw)))
        np.testing.assert_array_equal(
            _bits(port_quantizers.quantize_dequantize(
                torch.from_numpy(x), ps, scheme, **kw).numpy()),
            _bits(ref_quantizers.quantize_dequantize(jnp.asarray(x), js,
                                                     scheme, **kw)))


@pytest.mark.parametrize("variant", ["separate", "round_a_once",
                                     "per_partial"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_quantized_matmul_variants_bitwise(variant, scheme):
    """All three §VII–VIII variants, unsigned and signed ranges, against
    the reference's ``quantized_matmul`` (its research variants jitted):
    bit for bit — the codes are integers, and the map back is computed in
    the compiled reference's form (f32 reciprocals, one fused
    multiply-add)."""
    rng = np.random.default_rng(6)
    for lo, hi, bits in ((0.0, 1.0, 3), (-1.0, 1.0, 3), (-1.0, 1.0, 8)):
        a = _uniform(rng, (12, 20), lo, hi)
        b = _uniform(rng, (20, 9), lo, hi)
        kw = dict(bits=bits, scheme=scheme, variant=variant, seed=4, lo=lo,
                  hi=hi, counter=5)
        want = ref_matmul.quantized_matmul(jnp.asarray(a), jnp.asarray(b),
                                           **kw)
        got = port_matmul.quantized_matmul(torch.from_numpy(a),
                                           torch.from_numpy(b), **kw)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    err = port_matmul.matmul_error(torch.from_numpy(a), torch.from_numpy(b),
                                   got)
    ref_err = ref_matmul.matmul_error(jnp.asarray(a), jnp.asarray(b), want)
    np.testing.assert_allclose(float(err), float(ref_err), rtol=1e-5)


def test_dither_beats_deterministic_per_partial():
    """The paper's Fig. 8 regime (entries in [0, 0.5), one bit): dither and
    stochastic rounding beat deterministic rounding in the port as in the
    reference (``tests/test_matmul.py``)."""
    rs = np.random.RandomState(0)
    a = torch.from_numpy(rs.rand(50, 50).astype(np.float32) * 0.5)
    b = torch.from_numpy(rs.rand(50, 50).astype(np.float32) * 0.5)
    e = {s: float(port_matmul.matmul_error(a, b, port_matmul.quantized_matmul(
        a, b, bits=1, scheme=s, variant="per_partial"))) for s in SCHEMES}
    assert e["dither"] < e["deterministic"]
    assert e["stochastic"] < e["deterministic"]


def test_available_backends_are_the_dispatchers():
    """``dispatch.available_backends`` lists the port's kernel backends,
    sorted as the reference's lists its own: each resolves, and a name
    outside it raises with the list."""
    names = dispatch.available_backends()
    assert names == tuple(sorted(names)) == ("cuda", "torch-ref")
    assert ref_dispatch.available_backends() == tuple(
        sorted(ref_dispatch.available_backends()))
    x = torch.zeros(2, 2)
    assert dispatch.resolve_backend("torch-ref", x) == "torch-ref"
    with pytest.raises(ValueError, match="torch-ref"):
        dispatch.resolve_backend("xla-ref", x)
