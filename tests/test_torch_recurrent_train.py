"""Training the recurrent configs, mamba2-370m (SSD) and recurrentgemma-9b
(RG-LRU and local attention), in the port at ``.reduced()``, against the
reference on the same weights (the port's init carried over,
``tests/_torch_zoo.py``): the full-sequence forward (``apply_model``,
the chunked SSD and the log-depth RG-LRU scan), and one whole
``make_train_step`` from the same train state.

Tolerances: logits within 2⁻⁶ (``tests/test_torch_model.py``); one train
step with ``tests/test_torch_zoo_train.py``'s (loss within 2⁻¹⁰, moments
with ``mean|Δ| ≤ 2⁻⁵·mean|m|`` and ``max|Δ| ≤ 2⁻⁴·max|m|``, twice that
for ``v``, new params within ``2·lr + 1 ulp`` and equal in at least 97 %
of entries; the reasons are in ``tests/test_torch_train.py``).  Inside
the port, recomputing each layer in the backward pass changes no bit.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from _torch_zoo import EXACT, model, ref_jit
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import synthetic_batch as ref_batch
from repro.models import registry as ref_registry
from repro.optim import adamw as ref_adamw
from repro.train import trainer as ref_trainer
from repro_torch import tree
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.interop import train_state_from_numpy
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.train import trainer
from test_torch_zoo_train import LR, TOL, _assert_close, _f32, _ref_state

RECURRENT = ["mamba2_370m", "recurrentgemma_9b"]
REF_FORWARD = ref_jit(ref_registry.apply_model, static_argnames=("remat",))


@pytest.mark.parametrize("arch", RECURRENT)
def test_forward_logits_match_reference(arch):
    """Full-sequence f32 logits over a 40-token batch (mamba2: two chunks
    of 32, the second ragged), with and without recomputation."""
    cfg, pcfg, params, tp = model(arch)
    toks = np.random.default_rng(1).integers(
        1, pcfg.vocab_size, size=(2, 40)).astype(np.int32)
    want = np.asarray(REF_FORWARD(params, cfg, {"tokens": toks}))
    got = registry.apply_model(tp, pcfg, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= 2.0 ** -6
    plain = registry.apply_model(tp, pcfg, {"tokens": torch.from_numpy(toks)},
                                 remat=False)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("arch", RECURRENT)
def test_train_step_matches_reference(arch):
    """One whole train step (loss and grads through the SSD or RG-LRU
    layers, AdamW with clipping and decay) from the same train state on
    the pipeline's batch: new params, moments, step, counter and loss."""
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
