"""The port's dither hash and pulse math (``repro_torch.core.rounding``)
against the reference's ``repro.core.rounding``: integer outputs are
**bitwise** equal, over random idx, counter and seed and over the uint32
edges 0xFFFFFFFF, 2**31 and counter + phase ≥ 2**32 (the sum that wraps
before the modulo in ``lcg_slot``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rounding as ref
from repro_torch.core import rounding as port
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

EDGES = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1],
                 dtype=np.uint64)


def _u32_inputs(seed, n=2048):
    """Random uint32 idx and counter, with the edge values in both and
    counters just below 2**32, so counter + phase wraps for most idx."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 2**32, size=n, dtype=np.uint64)
    ctr = rng.integers(0, 2**32, size=n, dtype=np.uint64)
    idx[: len(EDGES)] = EDGES
    ctr[: len(EDGES)] = EDGES[::-1]
    ctr[len(EDGES): 4 * len(EDGES)] = 2**32 - rng.integers(
        1, 16, size=3 * len(EDGES), dtype=np.uint64)
    return idx.astype(np.uint32), ctr.astype(np.uint32)


def _pair(a_u32):
    """The same uint32 values as a jnp uint32 array and a torch int64."""
    return jnp.asarray(a_u32), torch.from_numpy(a_u32.astype(np.int64))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 7, 0xD1CE, 2**31, 2**32 - 1])
def test_hash_uniform_bitwise(seed):
    idx, ctr = _u32_inputs(seed % 1000)
    (ji, ti), (jc, tc) = _pair(idx), _pair(ctr)
    want = _bits(ref.hash_uniform(seed, ji, jc))
    got = _bits(port.hash_uniform(seed, ti, tc).numpy())
    np.testing.assert_array_equal(got, want)


def test_hash_uniform_scalars_and_negative_int32():
    """Python-int inputs and negative int32 counters (two's complement in
    the reference's uint32 cast) hash the same."""
    for seed, idx, ctr in [(0, 0, 0), (2**32 - 1, 2**32 - 1, 2**31),
                           (5, 123456789, 2**32 - 3)]:
        assert _bits(port.hash_uniform(seed, idx, ctr)) == _bits(
            ref.hash_uniform(seed, idx, ctr))
    ctr = np.array([-1, -2**31, -7, 3], np.int32)
    idx = np.arange(4, dtype=np.uint32)
    want = _bits(ref.hash_uniform(3, jnp.asarray(idx), jnp.asarray(ctr)))
    got = _bits(port.hash_uniform(3, torch.from_numpy(idx.astype(np.int64)),
                                  torch.from_numpy(ctr)).numpy())
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_pulses", [16, 7, 64, 1000])
@pytest.mark.parametrize("seed", [0, 101, 2**32 - 1])
def test_lcg_slot_bitwise(n_pulses, seed):
    idx, ctr = _u32_inputs(n_pulses + seed % 97)
    (ji, ti), (jc, tc) = _pair(idx), _pair(ctr)
    # the fixture really exercises the wrap of counter + phase past 2**32
    phase = np.asarray(ref._mix(ji ^ np.uint32(seed & 0xFFFFFFFF)
                                ^ ref._GOLDEN)).astype(np.uint64)
    assert (ctr.astype(np.uint64) + phase >= 2**32).sum() > 100
    want = np.asarray(ref.lcg_slot(jc, ji, n_pulses, seed=seed))
    got = port.lcg_slot(tc, ti, n_pulses, seed=seed).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("fmt", ["spread", "unary"])
@pytest.mark.parametrize("n_pulses", [16, 33])
def test_slot_index_bitwise(fmt, n_pulses):
    idx, ctr = _u32_inputs(3)
    (ji, ti), (jc, tc) = _pair(idx), _pair(ctr)
    want = np.asarray(ref.slot_index(jc, ji, n_pulses, seed=9, fmt=fmt))
    got = port.slot_index(tc, ti, n_pulses, seed=9, fmt=fmt).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    with pytest.raises(ValueError):
        port.slot_index(tc, ti, n_pulses, fmt="bogus")


@pytest.mark.parametrize("n_pulses", [16, 5, 64])
def test_dither_bit_bitwise(n_pulses):
    rng = np.random.default_rng(n_pulses)
    frac = rng.uniform(0, 1, size=50_000).astype(np.float32)
    frac[:5] = [0.0, 0.5, 1.0, np.nextafter(0.5, 1, dtype=np.float32),
                1.0 / n_pulses]
    slot = rng.integers(0, n_pulses, size=frac.size)
    u = rng.uniform(0, 1, size=frac.size).astype(np.float32)
    want = np.asarray(ref.dither_bit(jnp.asarray(frac),
                                     jnp.asarray(slot, jnp.int32),
                                     jnp.asarray(u), n_pulses))
    got = port.dither_bit(torch.from_numpy(frac), torch.from_numpy(slot),
                          torch.from_numpy(u), n_pulses).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n_pulses", [4, 16, 64])
def test_dither_state_rounds_as_the_reference(n_pulses):
    """``DitherState.round`` threads the counter as the reference's: each
    call rounds at the state's counter and returns a state one further on,
    seed kept; the values of a sequence of calls equal the reference's
    bit for bit."""
    x = np.random.default_rng(n_pulses).normal(
        size=(7, 33)).astype(np.float32) * 4
    st, ref_st = port.DitherState(seed=5, counter=3), ref.DitherState(
        seed=5, counter=3)
    for _ in range(5):
        y, st = st.round(torch.from_numpy(x), n_pulses=n_pulses)
        want, ref_st = ref_st.round(jnp.asarray(x), n_pulses=n_pulses)
        assert np.array_equal(_bits(y.numpy()), _bits(want))
        assert (st.seed, st.counter) == (ref_st.seed, ref_st.counter)
    assert st.counter == 8
