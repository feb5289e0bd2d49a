"""Tensor-parallel training of the recurrent families against the
reference's sharded step (the setting and the tolerances of
``tests/test_torch_train_mesh.py``), with no policy and under the fused
dither policy, at (1, 2) and (2, 2):

* mamba2 ``.reduced()``: ``in_proj`` column-parallel (584 columns, the
  cut inside x gathered back before the split), the conv, the SSD scan
  and the gated norm replicated, ``out_proj`` row-parallel on each rank's
  K block of the replicated y (``ctx.scatter_to_model``);
* recurrentgemma ``.reduced()`` (rglru, rglru, attn): the RG-LRU block
  replicated, as the reference's layout leaves it, the MQA attention on
  local query heads over the replicated KV head with the window, the
  GELU MLP column/row-parallel.

``test_replicas_bitwise`` holds every replicated leaf (the SSD's
``conv_w``, ``a_log``, ``dt_bias``, ``d_skip`` and ``norm``, the
RG-LRU's weights) bit for bit equal across 'model' ranks after each
step."""

import pytest

import _torch_train_mesh as tm
from test_torch_train import TOL
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CASES = ["ssm", "ssm-fused", "hybrid", "hybrid-fused"]
_RUN = {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if not _RUN:
        tmp = str(tmp_path_factory.mktemp("train_mesh_recurrent"))
        _RUN["ref"] = tm.reference(tmp, CASES)
        _RUN["port"] = tm.port(tmp, CASES)
    return _RUN


@pytest.mark.parametrize("name,shape", tm.params(CASES),
                         ids=lambda v: v if isinstance(v, str)
                         else f"{v[0]}x{v[1]}")
def test_sharded_step_matches_reference(runs, name, shape):
    tol = TOL[tm.REF_CASES[name][1] != "none"]
    tm.check_against_reference(runs["port"][shape], runs["ref"][name], name,
                               shape, tol)


@pytest.mark.parametrize("name,shape", tm.params(CASES),
                         ids=lambda v: v if isinstance(v, str)
                         else f"{v[0]}x{v[1]}")
def test_replicas_bitwise(runs, name, shape):
    tm.check_replicas(runs["port"][shape], name, shape)
