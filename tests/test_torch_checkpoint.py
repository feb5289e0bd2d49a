"""The port's checkpointer (``repro_torch.checkpoint``): the reference's
six cases of ``tests/test_checkpoint.py`` (roundtrip, async save and
latest, retention, no partial checkpoint visible, dtype on restore, a
mismatched structure refused), and checkpoints crossing between the two
packages both ways, leaf for leaf, bit for bit, bf16 leaves included."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
from repro.configs import get_config as ref_get_config
from repro.train import trainer as ref_trainer
from repro_torch import tree
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.interop import train_state_from_numpy
from repro_torch.train import trainer
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 16), generator=g),
            "nest": {"b": torch.arange(10, dtype=torch.int32),
                     "c": torch.tensor(3.5),
                     "d": torch.randn((3, 4), generator=g).bfloat16()},
            "layers": [torch.ones(2), torch.zeros((2, 2), dtype=torch.int8)]}


def _equal(a, b):
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)
    assert len(tree.leaves(a)) == len(tree.leaves(b))


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    ck.save(5, t)
    _equal(ck.restore(5, t), t)


def test_async_save_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save_async(1, _tree(1))
    ck.save_async(2, _tree(2))
    ck.wait()
    assert ck.latest_step() == 2
    step, out = ck.restore_latest(_tree())
    assert step == 2
    _equal(out, _tree(2))


def test_retention_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in range(5):
        ck.save(s, _tree(s))
    assert ck.all_steps() == [3, 4]


def test_no_partial_checkpoint_visible(tmp_path):
    """tmp dirs are never listed as valid steps."""
    ck = Checkpointer(str(tmp_path))
    os.makedirs(tmp_path / "step_00000009.tmp.123.456")
    assert ck.all_steps() == [] and ck.restore_latest(_tree()) == (None,
                                                                    None)
    ck.save(1, _tree())
    assert ck.all_steps() == [1]


def test_restore_takes_the_dtype_and_device_of_like(tmp_path):
    """Restore casts to the reference dtype and places on its device."""
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones((4, 4))})
    out = ck.restore(1, {"w": torch.zeros((4, 4), dtype=torch.bfloat16)})
    assert out["w"].dtype == torch.bfloat16 and out["w"].device.type == "cpu"
    assert float(out["w"].sum()) == 16.0


def test_mismatched_structure_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree())
    with pytest.raises(ValueError, match="mismatch"):
        ck.restore(1, {"only": torch.zeros(3)})


CFG = ref_get_config("smollm_135m").reduced()
PCFG = get_config("smollm_135m").reduced()


def _ref_state():
    state = ref_trainer.init_train_state(jax.random.PRNGKey(0), CFG)
    state["counter"] = jnp.int32(7)
    state["opt"]["step"] = jnp.int32(7)
    state["opt"]["m"] = jax.tree.map(lambda m: m + 0.25, state["opt"]["m"])
    return state


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """A reference train state saved by the reference's checkpointer
    restores into the port's train-state structure leaf for leaf."""
    state = _ref_state()
    RefCheckpointer(str(tmp_path)).save(7, state)
    like = trainer.init_train_state(PCFG, seed=1, device="cpu")
    got = Checkpointer(str(tmp_path)).restore(7, like)
    want = train_state_from_numpy(jax.tree.map(np.asarray, state), "cpu")
    _equal(got, want)
    assert got["params"]["embed"].dtype == torch.bfloat16
    assert int(got["counter"]) == 7 and int(got["opt"]["step"]) == 7


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The port's train state, saved by the port, restores through the
    reference's checkpointer into the reference's structure."""
    port = trainer.init_train_state(PCFG, seed=2, device="cpu")
    port["counter"] = torch.tensor(9, dtype=torch.int32)
    Checkpointer(str(tmp_path)).save(9, port)
    like = ref_trainer.init_train_state(jax.random.PRNGKey(1), CFG)
    got = RefCheckpointer(str(tmp_path)).restore(9, like)
    assert jax.tree.structure(got) == jax.tree.structure(like)
    for w, g in zip(tree.leaves(port), jax.tree.leaves(got)):
        assert str(g.dtype) == str(w.dtype).replace("torch.", "")
        a = np.asarray(jnp.asarray(g, jnp.float32))
        np.testing.assert_array_equal(a, w.float().numpy())
    assert int(got["counter"]) == 9
