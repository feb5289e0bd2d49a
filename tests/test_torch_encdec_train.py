"""Training the encoder-decoder (whisper-small at ``.reduced()``) in the
port against the reference on the same weights (the port's init carried
over, ``tests/_torch_zoo.py``): the pipeline's audio-stub frames bit for
bit, ``apply_model`` over them, two whole ``make_train_step`` steps, a
checkpoint crossing between the packages, and the train launcher.

Tolerances: logits within 2⁻⁶ (``tests/test_torch_model.py``); the
train steps with ``tests/test_torch_zoo_train.py``'s (loss within 2⁻¹⁰,
moments with ``mean|Δ| ≤ 2⁻⁵·mean|m|`` and ``max|Δ| ≤ 2⁻⁴·max|m|``,
twice that for ``v``; the reasons are in ``tests/test_torch_train.py``);
after the second step the loss is held to 2⁻⁸, since the first step's
params differ by an lr step in a few entries.  Inside the port,
recomputing each decoder layer in the backward pass changes no bit.
"""

import jax
import numpy as np
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from _torch_zoo import EXACT, model, ref_jit
from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
from repro.configs import get_config as ref_get_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import synthetic_batch as ref_batch
from repro.models import registry as ref_registry
from repro.optim import adamw as ref_adamw
from repro.train import trainer as ref_trainer
from repro_torch import tree
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.dist.fault_tolerance import (FailureInjector,
                                              run_with_restarts)
from repro_torch.interop import train_state_from_numpy
from repro_torch.launch.train import run_training, train_main
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.train import trainer
from test_torch_zoo_train import LR, TOL, _assert_close, _ref_state

ARCH = "whisper_small"
REF_FORWARD = ref_jit(ref_registry.apply_model, static_argnames=("remat",))


def test_pipeline_frames_bitwise():
    """The ``audio_stub`` batch: tokens and the (B, T_enc, d) bf16 frames
    (hash seed ``seed ^ 0xFEED``, one block broadcast over the batch)
    equal the reference's ``synthetic_batch`` bit for bit, at full width
    too."""
    for reduced in (True, False):
        cfg, pcfg = ref_get_config(ARCH), get_config(ARCH)
        if reduced:
            cfg, pcfg = cfg.reduced(), pcfg.reduced()
        want = ref_batch(cfg, RefDataConfig(batch=2, seq=8, seed=3), 5)
        got = synthetic_batch(pcfg, DataConfig(batch=2, seq=8, seed=3), 5,
                              device="cpu")
        assert sorted(got) == sorted(want) == ["frames", "labels", "tokens"]
        assert np.array_equal(got["tokens"].numpy(),
                              np.asarray(want["tokens"]))
        f = np.asarray(want["frames"])
        assert tuple(got["frames"].shape) == f.shape == (
            2, pcfg.n_enc_tokens, pcfg.d_model)
        assert np.array_equal(got["frames"].view(torch.int16).numpy(),
                              f.view(np.int16))


def test_apply_model_on_pipeline_frames_matches_reference():
    """``registry.apply_model`` over the pipeline's batch (tokens and
    frames) against the reference's, with and without recomputation."""
    cfg, pcfg, params, tp = model(ARCH)
    batch = ref_batch(cfg, RefDataConfig(batch=2, seq=16, seed=1), 2)
    tbatch = synthetic_batch(pcfg, DataConfig(batch=2, seq=16, seed=1), 2,
                             device="cpu")
    want = np.asarray(REF_FORWARD(params, cfg, batch))
    got = registry.apply_model(tp, pcfg, tbatch)
    assert tuple(got.shape) == want.shape == (2, 16, cfg.vocab_padded())
    assert np.abs(got.numpy() - want).max() <= 2.0 ** -6
    assert torch.equal(registry.apply_model(tp, pcfg, tbatch, remat=False),
                       got)


def test_two_train_steps_match_reference():
    """Two whole train steps (loss and grads through the decoder, the
    cross-attention and the encoder, AdamW with clipping and decay) from
    the same train state on the pipeline's batches: each step's loss, and
    after the first the moments, step and counter."""
    cfg, pcfg, params, tp = model(ARCH)
    state = _ref_state(params, counter=3)
    port_state = train_state_from_numpy(jax.tree.map(np.asarray, state),
                                        "cpu")
    ref_step = jax.jit(ref_trainer.make_train_step(
        cfg, ref_adamw.AdamW(lr=LR)), compiler_options=EXACT)
    step = trainer.make_train_step(pcfg, adamw.AdamW(lr=LR))
    for s, tol in ((5, TOL["loss"]), (6, 2.0 ** -8)):
        batch = ref_batch(cfg, RefDataConfig(batch=2, seq=16, seed=3), s)
        tbatch = synthetic_batch(pcfg, DataConfig(batch=2, seq=16, seed=3),
                                 s, device="cpu")
        state, want_m = ref_step(state, batch)
        port_state, got_m = step(port_state, tbatch)
        assert abs(float(got_m["loss"]) - float(want_m["loss"])) <= tol, s
        if s == 5:
            _assert_close(port_state["opt"]["m"], state["opt"]["m"], TOL,
                          "m")
            _assert_close(port_state["opt"]["v"], state["opt"]["v"],
                          dict(TOL, mean=2 * TOL["mean"],
                               max=2 * TOL["max"]), "v")
    assert int(port_state["counter"]) == 5
    assert int(port_state["opt"]["step"]) == 2


def test_checkpoint_crosses_both_ways(tmp_path):
    """An encoder-decoder train state (stacked encoder and decoder blocks,
    ``{g, b}`` norms, moments, counter) written by either package's
    checkpointer restores in the other's, leaf for leaf, bit for bit, and
    the port's own save and restore round-trips."""
    cfg, pcfg, params, tp = model(ARCH)
    state = _ref_state(params, counter=7)
    RefCheckpointer(str(tmp_path / "ref")).save(7, state)
    like = trainer.init_train_state(pcfg, seed=1, device="cpu")
    got = Checkpointer(str(tmp_path / "ref")).restore(7, like)
    want = train_state_from_numpy(jax.tree.map(np.asarray, state), "cpu")
    for g, w in zip(tree.leaves(got), tree.leaves(want)):
        assert g.dtype == w.dtype and torch.equal(g, w)

    port = trainer.init_train_state(pcfg, seed=2, device="cpu")
    Checkpointer(str(tmp_path / "port")).save(9, port)
    back = RefCheckpointer(str(tmp_path / "port")).restore(9, state)
    assert jax.tree.structure(back) == jax.tree.structure(state)
    for w, g in zip(tree.leaves(port), jax.tree.leaves(back)):
        np.testing.assert_array_equal(
            np.asarray(g).astype(np.float32) if g.dtype.name == "bfloat16"
            else np.asarray(g), w.float().numpy() if w.dtype ==
            torch.bfloat16 else w.numpy())
    again = Checkpointer(str(tmp_path / "port")).restore(9, like)
    for g, w in zip(tree.leaves(again), tree.leaves(port)):
        assert torch.equal(g, w)


def test_train_launcher_runs_and_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch whisper_small
    --reduced --device cpu``: the pipeline's frames feed the model, the
    losses are finite; a run crashed before a step and resumed from its
    checkpoint gives the uninterrupted run's losses."""
    train_main(["--arch", "whisper_small", "--reduced", "--device", "cpu",
                "--steps", "3", "--batch", "2", "--seq", "16"])
    assert "done: 3 steps" in capsys.readouterr().out
    pcfg = get_config(ARCH).reduced()
    kw = dict(steps=4, batch=2, seq=16, ckpt_every=2, device="cpu",
              log=lambda *_: None)
    _, whole = run_training(pcfg, ckpt_dir=str(tmp_path / "whole"), **kw)
    assert all(np.isfinite(whole))
    injector = FailureInjector(crash_at={2: "before_save"})

    def loop(restart_idx):
        return run_training(pcfg, ckpt_dir=str(tmp_path / "crashed"),
                            injector=injector, **kw)[1]

    assert run_with_restarts(loop) == whole[2:]
