"""The port's training launcher (``repro_torch.launch.train``) on the CPU:
the command line, checkpoint and restart through ``run_with_restarts``
(a resumed run equals an uninterrupted one bit for bit: data is a hash of
the step, the state restores exactly and the CPU step is deterministic),
and the loss falling over 60 steps with and without the dither policy, as
the reference's ``tests/test_system.py`` and
``tests/test_fault_tolerance.py`` hold the reference (same thresholds)."""

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.dist.fault_tolerance import (FailureInjector,
                                              InjectedFailure,
                                              run_with_restarts)
from repro_torch.launch.train import run_training, train_main
from repro_torch.numerics.policy import QuantPolicy
from repro_torch.train import trainer

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = get_config("smollm_135m").reduced()
QUIET = dict(log=lambda *a: None, device="cpu")


def _final_state(directory, steps):
    like = trainer.init_train_state(CFG, seed=0, device="cpu")
    return Checkpointer(str(directory)).restore(steps, like)


def test_cli_trains_on_the_cpu(capsys, tmp_path):
    train_main(["--arch", "smollm_135m", "--reduced", "--device", "cpu",
                "--steps", "4", "--batch", "2", "--seq", "16",
                "--policy", "dither", "--kernel-backend", "torch-ref",
                "--grad-compress", "dither", "--schedule", "wsd",
                "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and out.strip().splitlines()[-1].startswith(
        "done: 4 steps; loss ")
    assert Checkpointer(str(tmp_path)).latest_step() == 4


@pytest.mark.parametrize("policy", [None, "dither"])
def test_resume_equals_uninterrupted_bitwise(tmp_path, policy):
    """Crashes before a step and right after a checkpoint is written, each
    once; the restarted run resumes from the latest checkpoint and ends
    with the uninterrupted run's final state (params, moments, step,
    counter) and losses, bit for bit."""
    pol = (QuantPolicy(scheme="dither", backend="torch-ref") if policy
           else None)
    kw = dict(steps=6, batch=2, seq=16, ckpt_every=2, policy=pol,
              peak_lr=3e-3, **QUIET)
    _, want = run_training(CFG, ckpt_dir=str(tmp_path / "plain"), **kw)
    injector = FailureInjector(crash_at={1: "after_save", 4: "before_save"})
    calls = []

    def loop(restart_idx):
        calls.append(restart_idx)
        _, losses = run_training(CFG, ckpt_dir=str(tmp_path / "crashed"),
                                 injector=injector, **kw)
        return losses

    resumed = run_with_restarts(loop)
    assert calls == [0, 1, 2]
    assert resumed == want[4:]         # the last attempt resumed at step 4
    a = _final_state(tmp_path / "plain", 6)
    b = _final_state(tmp_path / "crashed", 6)
    assert int(b["counter"]) == 6 and int(b["opt"]["step"]) == 6
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_injected_crash_restarts_and_completes(tmp_path):
    injector = FailureInjector(crash_at={7: "before_save"})
    calls = []

    def loop(restart_idx):
        calls.append(restart_idx)
        steps, _ = run_training(CFG, steps=12, batch=2, seq=16,
                                ckpt_dir=str(tmp_path), ckpt_every=5,
                                injector=injector, **QUIET)
        return steps

    assert run_with_restarts(loop) == 12
    assert len(calls) == 2          # crashed once, resumed once
    assert Checkpointer(str(tmp_path)).latest_step() == 12


def test_only_injected_crashes_restart(tmp_path):
    """A fault of the program propagates at once; an injected crash after
    the last restart is chained into a RuntimeError."""
    def broken(_):
        run_training(CFG, steps=2, batch=2, seq=16, ckpt_dir=str(tmp_path),
                     policy=QuantPolicy(scheme="dither", backend="bogus"),
                     **QUIET)

    with pytest.raises(ValueError, match="unknown kernel backend"):
        run_with_restarts(broken)
    injector = FailureInjector(crash_at={0: "before_save"})

    def loop(_):
        injector.fired.clear()
        injector.maybe_fail(0, "before_save")

    with pytest.raises(RuntimeError) as err:
        run_with_restarts(loop, max_restarts=2)
    assert isinstance(err.value.__cause__, InjectedFailure)


def test_training_reduces_loss():
    _, losses = run_training(CFG, steps=60, batch=8, seq=32, peak_lr=3e-3,
                             **QUIET)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.8, losses


def test_training_with_dither_policy_converges():
    """The paper's feature end to end: int8 dither-rounded matmuls (the
    unfused backend, the reference test's default) still learn."""
    _, losses = run_training(CFG, steps=60, batch=8, seq=32, peak_lr=3e-3,
                             policy=QuantPolicy(scheme="dither", bits=8),
                             **QUIET)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5, losses
