"""Tensor-parallel training of the encoder-decoder against the
reference's sharded step (the setting and the tolerances of
``tests/test_torch_train_mesh.py``): whisper ``.reduced()`` (4 heads, 2 +
2 layers, 32 stub frames a row), with no policy and under the fused
dither policy, at (1, 2) and (2, 2), and with 3 heads (the sequence
split of every attention, the cross-attention's K/V projected from the
whole encoder output) at (1, 2) under the fused policy.  The encoder's
bidirectional attention without RoPE, the decoder's causal
self-attention and its
cross-attention over the encoder output run on local heads (the encoder
output entering through ``copy_to_model``), the GELU MLPs column/row
parallel, ``enc_pos`` and the LayerNorms replicated, the tied head
vocab-parallel into the sharded loss.  ``test_replicas_bitwise`` holds
the replicated leaves (``enc_pos``, every LayerNorm, ``bd``) bit for bit
equal across 'model' ranks after each step: without the all-reduce of
the gradient that flows back into the encoder output they drift."""

import pytest

import _torch_train_mesh as tm
from test_torch_train import TOL
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CASES = ["encdec", "encdec-fused", "encdec-seq"]
_RUN = {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if not _RUN:
        tmp = str(tmp_path_factory.mktemp("train_mesh_encdec"))
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
