"""The training mesh against the reference's sharded step on the MoE and
VLM configs (the setting and tolerances of
``tests/test_torch_train_mesh.py``):

* granite-moe ``.reduced()`` at (2, 1): capacity is counted per data
  shard, in both packages on purpose, so the sharded loss leaves the
  single-device one by far more than the tolerance [reference: 6.31397 vs
  6.30088], and the port's follows the reference's sharded step;
* granite-moe with 5 experts under the dither policy at (2, 1) and
  (2, 2): at (2, 2) the reference pads the experts to 6, which shifts the
  hash index of the dispatch buffer; the port hashes at the padded index
  (pinned bit for bit in ``tests/test_torch_train_mesh_port.py``);
* internvl2 ``.reduced()`` (its 16 stub embeds prepended) at (2, 2),
  fused policy.
"""

import pytest

import _torch_train_mesh as tm
from test_torch_train import TOL
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CASES = ["moe", "moe-epad", "vlm"]
_RUN = {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if not _RUN:
        tmp = str(tmp_path_factory.mktemp("train_mesh_zoo"))
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


def test_per_shard_capacity_moves_the_loss(runs):
    """At (2, 1) both packages count capacity per data shard: the loss
    leaves the (1, 1) one by more than four times the tolerance, and the
    port's sharded loss is the reference's sharded one within it."""
    ref = runs["ref"]["moe"]
    tol = TOL[False]["loss"]
    assert abs(ref["2x1/losses"][0] - ref["1x1/losses"][0]) > 4 * tol
    got = runs["port"][(2, 1)][0]["train-moe"]["losses"][0]
    assert abs(got - ref["2x1/losses"][0]) <= tol
