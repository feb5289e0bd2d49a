"""The training mesh (DESIGN.md §9) against the reference's sharded train
step: data- and tensor-parallel training of ``smollm_135m.reduced()`` on
the (1, 1), (2, 1), (1, 2) and (2, 2) meshes, one gloo process a rank,
with no policy and the unfused dither policy (``torch`` against ``jnp``);
the fused one through kernel 6's sharded entry is
``tests/test_torch_train_mesh_fused.py``.

The reference runs once a module in a subprocess with four virtual devices
(``tests/_torch_train_mesh_ref.py``); the port's ranks once a mesh shape
(``tests/_torch_mesh.run_mesh``).  Both start from the same weights (the
port's seed-0 init, carried over bit for bit) and batch (4 × 16).
Tolerances, each for its reason (measured port vs reference in brackets):

* **Step-1 loss and gradients** within ``tests/test_torch_train.py``'s
  ``TOL`` of the reference's step *at the same mesh*: no policy 2⁻¹⁰
  [3e-4] and 2⁻⁵ / 2⁻⁴ of the leaf's mean / max [1.5 % / 2.5 %]; under a
  policy 2⁻⁶ and 2⁻³ / 2⁻².  The reference's own sharded step moves its
  loss by 3e-4 at (1, 2) (GSPMD sums the row-parallel products' partials
  in another order), and the port's by as much.
* **Step-1 v** (the gradients' squares) at twice those bounds, as
  ``tests/test_torch_train.py`` holds v.
* **Params** (AdamW at lr 1e-2, so that the bf16 params move): after
  step 1 within ``2·lr`` + 1 ulp of the reference's and equal in at least
  97 % of entries, ``test_torch_train.py``'s one-step bound [≥ 99.37 %
  equal]; after step 2 within ``2·2·lr`` + 1 ulp, their mean gap at most
  lr/4 [0.133·lr; a port that skipped the step: ≥ 0.61·lr].
* **Step-2 loss** within 2⁻⁶ [6.0e-3]: it follows a step in which a
  gradient near 0 may take the other sign in one package, a 2·lr move;
  the reference's own sharded step-2 loss sits up to 1.5e-2 from its
  (1, 1) one.
* **Inside the port, bit for bit**: the data replicas' params, m and v,
  and the 'model' ranks' replicated leaves, after every step.
"""

import pytest

import _torch_train_mesh as tm
from test_torch_train import TOL
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CASES = ["none", "unfused"]
_RUN = {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if not _RUN:
        tmp = str(tmp_path_factory.mktemp("train_mesh"))
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
