"""The port's pulse arithmetic (``repro_torch.core.ops``) against the
reference's ``repro.core.ops``: the deterministic scheme bit for bit
(multiplication, scaled addition, the control sequence), and the random
schemes — drawn from a ``torch.Generator`` where the reference splits a
``jax.random`` key — by the statistics the reference's
``tests/test_ops.py`` holds (same bounds)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ops as ref_ops
from repro_torch.core import ops

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCHEMES = ["stochastic", "deterministic", "dither"]


def _xy(seed, n=500):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, generator=g), torch.rand(n, generator=g)


@pytest.mark.parametrize("n", [16, 128])
def test_deterministic_scheme_bitwise(n):
    x, y = _xy(n)
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
    key = jax.random.PRNGKey(0)
    for got, want in (
            (ops.multiply_estimate(None, x, y, n, "deterministic"),
             ref_ops.multiply_estimate(key, jx, jy, n, "deterministic")),
            (ops.scaled_add_pulses(None, x, y, n, "deterministic"),
             ref_ops.scaled_add_pulses(key, jx, jy, n, "deterministic")),
            (ops.control_sequence(None, (3,), n, "deterministic",
                                  device="cpu"),
             ref_ops.control_sequence(key, (3,), n, "deterministic"))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    xp, yp = ops.encode_pair_for_multiply(None, x, y, n, "deterministic")
    np.testing.assert_array_equal(ops.multiply_pulses(xp, yp).numpy(),
                                  (xp * yp).numpy())


@pytest.mark.parametrize("scheme", SCHEMES)
def test_multiply_converges(scheme):
    gen = torch.Generator().manual_seed(0)
    x, y = _xy(1)
    outs = [ops.multiply_estimate(gen, x, y, 128, scheme)
            for _ in range(1 if scheme == "deterministic" else 10)]
    emse = float(torch.mean((torch.stack(outs) - x * y) ** 2))
    assert emse < 5e-3, emse


@pytest.mark.parametrize("scheme", SCHEMES)
def test_scaled_add_converges(scheme):
    gen = torch.Generator().manual_seed(3)
    x, y = _xy(4)
    outs = [ops.scaled_add_pulses(gen, x, y, 128, scheme)
            for _ in range(1 if scheme == "deterministic" else 10)]
    emse = float(torch.mean((torch.stack(outs) - (x + y) / 2) ** 2))
    assert emse < 5e-3, emse


def test_orderings_match_table1():
    """dither EMSE ≪ stochastic EMSE; dither |bias| ≪ deterministic |bias|."""
    gen = torch.Generator().manual_seed(6)
    x, y = _xy(7, 800)
    res = {}
    for scheme in SCHEMES:
        e = torch.stack([ops.multiply_estimate(gen, x, y, 64, scheme)
                         for _ in range(1 if scheme == "deterministic"
                                        else 20)])
        res[scheme] = (float(torch.mean((e - x * y) ** 2)),
                       float(torch.abs(torch.mean(e - x * y))))
    assert res["dither"][0] < res["stochastic"][0] / 3
    assert res["dither"][1] < res["deterministic"][1] / 3


def test_control_sequence_properties():
    gen = torch.Generator().manual_seed(0)
    w = ops.control_sequence(gen, (2000,), 64, "dither", device="cpu")
    # each sequence is one of the two alternating phases
    assert float(torch.abs(torch.diff(w, dim=-1)).min()) == 1.0
    assert abs(float(w.mean()) - 0.5) < 0.05
    s = ops.control_sequence(gen, (4000, 8), 16, "stochastic", device="cpu")
    assert set(s.unique().tolist()) == {0.0, 1.0}
    assert abs(float(s.mean()) - 0.5) < 0.01
    with pytest.raises(ValueError, match="scheme"):
        ops.control_sequence(gen, (2,), 4, "exotic", device="cpu")
    with pytest.raises(ValueError, match="scheme"):
        ops.multiply_estimate(gen, *_xy(0, 4), 4, "exotic")
