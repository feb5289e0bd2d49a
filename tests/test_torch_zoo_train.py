"""Training the MoE model (granite-moe-1b-a400m) and the VLM (internvl2-1b,
its stub frontend's ``embeds`` from the data pipeline) in the port, at
``.reduced()``, against the reference: the pipeline's batch bit for bit,
one whole ``make_train_step`` from the same train state, and an MoE train
state's checkpoint crossing between the packages both ways.

Tolerances are ``tests/test_torch_train.py``'s for one whole step with no
policy (its docstring gives the reasons): loss within 2⁻¹⁰, gradient
moments ``m`` with ``mean|Δ| ≤ 2⁻⁵·mean|m|`` and ``max|Δ| ≤ 2⁻⁴·max|m|``
(twice that for ``v``), new params within ``2·lr + 1 ulp`` and equal in
at least 97 % of entries.  The reference's step is compiled as written
(``tests/_torch_zoo.py``), so its MoE router routes as the port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from _torch_zoo import EXACT, model
from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import synthetic_batch as ref_batch
from repro.optim import adamw as ref_adamw
from repro.train import trainer as ref_trainer
from repro_torch import tree
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.interop import train_state_from_numpy
from repro_torch.optim import adamw
from repro_torch.train import trainer

TOL = dict(loss=2.0 ** -10, mean=2.0 ** -5, max=2.0 ** -4)
LR = 1e-2


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_close(got, want, tol, what):
    """Leaf by leaf: mean and max of |Δ| against the reference leaf's."""
    got, want = tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _f32(g), _f32(w)
        assert g.shape == w.shape, (what, i)
        d = np.abs(g - w)
        assert d.mean() <= tol["mean"] * np.abs(w).mean(), (
            what, i, d.mean() / np.abs(w).mean())
        assert d.max() <= tol["max"] * np.abs(w).max(), (
            what, i, d.max() / np.abs(w).max())


def _ref_state(params, counter=0):
    return {"params": params, "opt": ref_adamw.init_opt_state(params),
            "counter": jnp.int32(counter)}


def test_pipeline_embeds_bitwise():
    """The ``vit_stub`` batch: tokens and the (B, F, d) bf16 embeds equal
    the reference's ``synthetic_batch`` bit for bit, at full width too."""
    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import get_config

    for reduced in (True, False):
        cfg = ref_get_config("internvl2_1b")
        pcfg = get_config("internvl2_1b")
        if reduced:
            cfg, pcfg = cfg.reduced(), pcfg.reduced()
        want = ref_batch(cfg, RefDataConfig(batch=2, seq=8, seed=3), 5)
        got = synthetic_batch(pcfg, DataConfig(batch=2, seq=8, seed=3), 5,
                              device="cpu")
        assert sorted(got) == sorted(want) == ["embeds", "labels", "tokens"]
        assert np.array_equal(got["tokens"].numpy(),
                              np.asarray(want["tokens"]))
        e = np.asarray(want["embeds"])
        assert tuple(got["embeds"].shape) == e.shape == (
            2, pcfg.n_frontend_tokens, pcfg.d_model)
        assert np.array_equal(got["embeds"].view(torch.int16).numpy(),
                              e.view(np.int16))


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "internvl2_1b"])
def test_train_step_matches_reference(arch):
    """One whole train step (loss and grads through the MoE FFN or over
    the prepended embeds, AdamW with clipping and decay) from the same
    train state on the pipeline's batch: new params, moments, step,
    counter and the loss."""
    cfg, pcfg, params, tp = model(arch)
    batch = ref_batch(cfg, RefDataConfig(batch=2, seq=16, seed=3), 5)
    tbatch = synthetic_batch(pcfg, DataConfig(batch=2, seq=16, seed=3), 5,
                             device="cpu")
    state = _ref_state(params, counter=3)
    port_state = train_state_from_numpy(jax.tree.map(np.asarray, state),
                                        "cpu")
    ref_step = jax.jit(ref_trainer.make_train_step(
        cfg, ref_adamw.AdamW(lr=LR)), compiler_options=EXACT)
    want, want_m = ref_step(state, batch)
    got, got_m = trainer.make_train_step(pcfg, adamw.AdamW(lr=LR))(
        port_state, tbatch)

    assert abs(float(got_m["loss"]) - float(want_m["loss"])) <= TOL["loss"]
    assert int(got["counter"]) == 4 and int(got["opt"]["step"]) == 1
    _assert_close(got["opt"]["m"], want["opt"]["m"], TOL, arch + " m")
    _assert_close(got["opt"]["v"], want["opt"]["v"],
                  dict(TOL, mean=2 * TOL["mean"], max=2 * TOL["max"]),
                  arch + " v")
    same = total = 0
    for g, w, p in zip(tree.leaves(got["params"]),
                       jax.tree.leaves(want["params"]),
                       jax.tree.leaves(state["params"])):
        g, w, p = _f32(g), _f32(w), _f32(p)
        mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), 1e-30)
        ulp = np.exp2(np.floor(np.log2(mag)) - 7)
        assert np.all(np.abs(g - w) <= 2 * LR + ulp), arch
        same += int(np.sum(g == w))
        total += g.size
    assert same >= 0.97 * total, (arch, same / total)


def test_moe_checkpoint_crosses_both_ways(tmp_path):
    """An MoE train state (f32 router, stacked experts, moments, counter)
    written by either package's checkpointer restores in the other's,
    leaf for leaf, bit for bit."""
    cfg, pcfg, params, tp = model("qwen2_moe_a2_7b")
    state = _ref_state(params, counter=7)
    state["opt"]["m"] = jax.tree.map(lambda m: m + 0.25, state["opt"]["m"])
    RefCheckpointer(str(tmp_path / "ref")).save(7, state)
    like = trainer.init_train_state(pcfg, seed=1, device="cpu")
    got = Checkpointer(str(tmp_path / "ref")).restore(7, like)
    want = train_state_from_numpy(jax.tree.map(np.asarray, state), "cpu")
    for g, w in zip(tree.leaves(got), tree.leaves(want)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert got["params"]["blocks"][0]["moe"]["router"].dtype == torch.float32

    port = trainer.init_train_state(pcfg, seed=2, device="cpu")
    port["counter"] = torch.tensor(9, dtype=torch.int32)
    Checkpointer(str(tmp_path / "port")).save(9, port)
    back = RefCheckpointer(str(tmp_path / "port")).restore(9, state)
    assert jax.tree.structure(back) == jax.tree.structure(state)
    for w, g in zip(tree.leaves(port), jax.tree.leaves(back)):
        assert str(g.dtype) == str(w.dtype).replace("torch.", "")
        np.testing.assert_array_equal(np.asarray(jnp.asarray(g, jnp.float32)),
                                      w.float().numpy())
    assert int(back["counter"]) == 9
