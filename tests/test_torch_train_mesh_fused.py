"""The training mesh against the reference's sharded step under the fused
dither policy: every dense product through kernel 6's sharded entry
(its plain version on the CPU, ``torch-ref`` against ``xla-ref``), row,
column and K blocks, at (1, 1), (2, 1), (1, 2) and (2, 2); the setting
and the tolerances of ``tests/test_torch_train_mesh.py``."""

import pytest

import _torch_train_mesh as tm
from test_torch_train import TOL
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CASES = ["fused"]
_RUN = {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if not _RUN:
        tmp = str(tmp_path_factory.mktemp("train_mesh_fused"))
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
