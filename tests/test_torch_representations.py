"""The port's pulse representations and closed forms
(``repro_torch.core.representations``, ``core.theory``) against the
reference's ``repro.core``: the deterministic encoders bit for bit, the
random encoders bit for bit when fed the reference's own uniforms
(``u=``: ``jax.random.uniform(key, x.shape + (N,))``), and the
``torch.Generator`` draws by the statistics the reference's
``tests/test_representations.py`` and ``tests/test_paper_stats.py`` hold
(same bounds, same slack); the closed forms equal."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import representations as ref_rep
from repro.core import theory as ref_theory
from repro_torch.core import representations as rep
from repro_torch.core import theory

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

NS = [4, 16, 64, 257]


def _xs(seed, shape):
    """x in [0, 1] with the edges, the midpoint and grid points m/N."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[:6] = [0.0, 1.0, 0.5, 0.25, 1 / 3, 0.75]
    return x


def _np(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()


@pytest.mark.parametrize("n", NS)
def test_deterministic_encoders_bitwise(n):
    x = _xs(n, (7, 9))
    for fmt in ("unary", "spread"):
        np.testing.assert_array_equal(
            _np(rep.deterministic_encode(torch.from_numpy(x), n, fmt=fmt)),
            _np(ref_rep.deterministic_encode(jnp.asarray(x), n, fmt=fmt)))
    m = np.arange(n + 1, dtype=np.float32)
    phase = np.random.default_rng(1).uniform(0, 1, m.shape).astype(
        np.float32)
    np.testing.assert_array_equal(
        _np(rep.spread_ones(torch.from_numpy(m), n,
                            phase=torch.from_numpy(phase))),
        _np(ref_rep.spread_ones(jnp.asarray(m), n,
                                phase=jnp.asarray(phase))))
    np.testing.assert_array_equal(
        _np(rep.lcg_permutation(n, offset=3, device="cpu")),
        _np(ref_rep.lcg_permutation(n, offset=3)))
    assert sorted(_np(rep.lcg_permutation(n, device="cpu"))) == list(
        range(n))


@pytest.mark.parametrize("n", [16, 257])
def test_random_encoders_bitwise_on_the_references_uniforms(n):
    """The dither encoder (both formats, with a random phase) and the
    stochastic encoder, fed ``u`` = the reference's uniforms for its key:
    the reference's pulses bit for bit."""
    x = _xs(100 + n, (5, 11))
    key = jax.random.PRNGKey(n)
    u = torch.from_numpy(np.array(jax.random.uniform(key, x.shape + (n,))))
    phase = np.random.default_rng(n).uniform(0, 1, x.shape).astype(
        np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    for fmt, ph in (("unary", None), ("spread", None), ("spread", phase)):
        got = rep.dither_encode(None, tx, n, fmt=fmt, u=u,
                                phase=None if ph is None
                                else torch.from_numpy(ph))
        want = ref_rep.dither_encode(key, jx, n, fmt=fmt,
                                     phase=None if ph is None
                                     else jnp.asarray(ph))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(
        _np(rep.stochastic_encode(None, tx, n, u=u)),
        _np(ref_rep.stochastic_encode(key, jx, n)))
    with pytest.raises(ValueError, match="shape"):
        rep.dither_encode(None, tx, n, u=u[..., :-1])


def test_decode_and_probs():
    x = torch.tensor([0.0, 0.3, 0.5, 0.8, 1.0])
    p = rep.dither_probs(x, 16)
    # the probabilities sum to N·x: the encoder is unbiased by construction
    torch.testing.assert_close(p.sum(-1), 16 * x, rtol=0, atol=1e-5)
    assert torch.equal(rep.stochastic_probs(x, 4), x[:, None].expand(5, 4))
    assert torch.equal(rep.decode(torch.tensor([[1, 0, 1, 1]])),
                       torch.tensor([0.75]))
    with pytest.raises(ValueError, match="format"):
        rep.dither_probs(x, 16, fmt="zigzag")


# -- statistics of the generator's draws (the reference's bounds) ---------

@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("x", [0.0, 0.1, 0.37, 0.5, 0.61, 0.999, 1.0])
def test_dither_encode_unbiased_and_low_var(x, n):
    """§II-D: E[X_s] = x exactly; Var(X_s) ≤ 2/N²."""
    gen = torch.Generator().manual_seed(n)
    est = rep.decode(rep.dither_encode(gen, torch.full((256,), x), n))
    tol = 6.0 * np.sqrt(2.0 / n ** 2 / 256) + 1e-6
    assert abs(float(est.mean()) - x) < tol
    assert float(est.var(correction=0)) <= 2.0 / n ** 2 + 1e-6


@pytest.mark.parametrize("n", [4, 16, 64])
def test_deterministic_encode_bias_bound(n):
    x = torch.from_numpy(_xs(n, (200,)))
    est = rep.decode(rep.deterministic_encode(x, n))
    assert float((est - x).abs().max()) <= 0.5 / n + 1e-6


@pytest.mark.parametrize("n", [8, 32])
@pytest.mark.parametrize("x", [0.05, 0.5, 0.9])
def test_stochastic_encode_unbiased(x, n):
    gen = torch.Generator().manual_seed(1)
    est = rep.decode(rep.stochastic_encode(gen, torch.full((512,), x), n))
    sem = np.sqrt(x * (1 - x) / n / 512) + 1e-6
    assert abs(float(est.mean()) - x) < 6 * sem + 1e-3


def _errors(scheme, gen, n, trials=256):
    xt = torch.linspace(0.013, 0.987, 33).expand(trials, 33)
    if scheme == "dither":
        p = rep.dither_encode(gen, xt, n)
    elif scheme == "stochastic":
        p = rep.stochastic_encode(gen, xt, n)
    else:
        p = rep.deterministic_encode(xt, n)
    return rep.decode(p) - xt


@pytest.mark.parametrize("seed", [0, 1])
def test_paper_stats(seed):
    """tests/test_paper_stats.py's checks of the reference, on the port's
    generator draws: dither unbiased (8σ) with EMSE·N² ≤ 3, stochastic
    EMSE·N in [0.08, 0.30], and the log-log slopes of EMSE over N."""
    gen = torch.Generator().manual_seed(seed)
    ns = [8, 16, 32, 64]
    mses = {s: [] for s in ("dither", "stochastic", "deterministic")}
    for n in ns:
        for s in mses:
            err = _errors(s, gen, n)
            mses[s].append(float(torch.mean(err ** 2)))
            if s == "dither":
                tol = 8.0 * math.sqrt(2.0) / (n * math.sqrt(err.numel()))
                assert abs(float(err.mean())) <= tol
                assert mses[s][-1] * n * n <= 3.0
            if s == "stochastic":
                assert 0.08 <= mses[s][-1] * n <= 0.30

    def slope(ys):
        return float(np.polyfit(np.log(ns), np.log(ys), 1)[0])

    assert -2.7 <= slope(mses["dither"]) <= -1.6
    assert -1.35 <= slope(mses["stochastic"]) <= -0.7
    assert -2.6 <= slope(mses["deterministic"]) <= -1.5
    assert all(d < s for d, s in zip(mses["dither"], mses["stochastic"]))


def test_emse_orders_match_theory():
    """Sample EMSE within 2× of the closed forms (paper Figs 1–2)."""
    gen = torch.Generator().manual_seed(3)
    x = torch.rand(2000, generator=gen)
    n = 64
    L = float(torch.mean((rep.decode(rep.stochastic_encode(gen, x, n)) - x)
                         ** 2))
    assert 0.5 < L / theory.emse_repr_stochastic(n) < 2.0
    L = float(torch.mean((rep.decode(rep.deterministic_encode(x, n)) - x)
                         ** 2))
    assert 0.5 < L / theory.emse_repr_deterministic(n) < 2.0
    L = float(torch.mean((rep.decode(rep.dither_encode(gen, x, n)) - x) ** 2))
    assert theory.emse_lower_bound(n) * 0.5 < L <= \
        theory.emse_repr_dither_bound(n)


def test_theory_equals_reference():
    for n in (1, 7, 64, 1000):
        for name in ("emse_lower_bound", "emse_repr_stochastic",
                     "emse_repr_deterministic", "var_repr_dither_bound",
                     "emse_repr_dither_bound"):
            assert getattr(theory, name)(n) == getattr(ref_theory, name)(n)
    x = np.linspace(0, 1, 11)
    np.testing.assert_array_equal(theory.var_repr_stochastic(x, 16),
                                  ref_theory.var_repr_stochastic(x, 16))
    assert theory.emse_rounding_deterministic() == \
        ref_theory.emse_rounding_deterministic()
    assert theory.emse_rounding_stochastic() == \
        ref_theory.emse_rounding_stochastic()
    assert theory.TABLE_I == ref_theory.TABLE_I
