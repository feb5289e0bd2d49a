"""The port's training path (``repro_torch.train.trainer``,
``registry.apply_model``, ``transformer.forward``) against the reference's,
on the same weights and batches (``interop``), at
``smollm_135m.reduced()``, batch 2 × seq 16; one jitted reference
function per configuration.

Tolerances, each for its reason (measured port vs reference in brackets):

* **Forward logits** (f32 casts of bf16 values) within 2⁻⁶, as
  ``tests/test_torch_model.py`` holds prefill: the reference's jit keeps
  excess precision through some bf16 intermediates.
* **No policy**: the loss within 2⁻¹⁰ [3.6e-4]; every gradient leaf with
  ``mean|Δ| ≤ 2⁻⁵·mean|g|`` [≤ 1.4 %] and ``max|Δ| ≤ 2⁻⁴·max|g|``
  [≤ 1.9 %].  Gradients flow through about twenty bf16 roundings; the
  reference itself lies 1.2–1.7 % (mean) from the same step computed in
  f32, and the port as far, so the two differ by bf16 noise.
* **Under a dither policy** (unfused ``torch`` against ``jnp``, fused
  ``torch-ref`` against ``xla-ref``): the loss within 2⁻⁶ [4.7e-3];
  gradients ``mean|Δ| ≤ 2⁻³·mean|g|`` [≤ 8.3 %], ``max|Δ| ≤
  2⁻²·max|g|`` [≤ 17 %].  The quantiser's range is the operand's absmax,
  so an ulp of difference upstream shifts the grid of a whole tensor: the
  reference itself, fed an embedding changed by one ulp in 1 % of its
  entries, moves its policy gradients by 3–5 % (mean) and up to 6 %
  (max), against 1.1–1.6 % without a policy.
* **One whole train step** (AdamW at lr 1e-2, so that the bf16 params
  move): the new params within ``2·lr + 1 ulp`` of the reference's
  everywhere (a step moves a param by lr·(m̂/(√v̂+ε) + wd·p), and at
  step 1 m̂/(√v̂+ε) = ±1: a gradient near 0 may take the other sign) and
  equal in at least 97 % of entries; moments ``m`` and ``v`` under the
  gradient tolerances (v squares the gradient: twice the mean); ``step``
  and ``counter`` exact.
* **The same function in the port** (remat against no remat) bit for
  bit, and the weight-absmax cache exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import synthetic_batch as ref_batch
from repro.models import registry as ref_registry
from repro.numerics.policy import QuantPolicy as RefPolicy
from repro.optim import adamw as ref_adamw
from repro.train import trainer as ref_trainer
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy, train_state_from_numpy
from repro_torch.kernels import dither_matmul as dm
from repro_torch.kernels import ref as kref
from repro_torch.models import registry, transformer
from repro_torch.numerics.policy import QuantPolicy
from repro_torch.optim import adamw
from repro_torch.train import trainer

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = ref_get_config("smollm_135m").reduced()
PCFG = get_config("smollm_135m").reduced()
PARAMS = ref_registry.init_model(jax.random.PRNGKey(0), CFG)
TORCH_PARAMS = params_from_numpy(jax.tree.map(np.asarray, PARAMS), "cpu")
BATCH = ref_batch(CFG, RefDataConfig(batch=2, seq=16, seed=3), 5)
TORCH_BATCH = {k: torch.from_numpy(np.array(v)) for k, v in BATCH.items()}
COUNTER = 3
LOGIT_TOL = 2.0 ** -6
TOL = {False: dict(loss=2.0 ** -10, mean=2.0 ** -5, max=2.0 ** -4),
       True: dict(loss=2.0 ** -6, mean=2.0 ** -3, max=2.0 ** -2)}
POLICIES = {"none": (None, None),
            "dither-unfused": (RefPolicy(scheme="dither", backend="jnp"),
                               QuantPolicy(scheme="dither",
                                           backend="torch")),
            "dither-fused": (RefPolicy(scheme="dither", backend="xla-ref"),
                             QuantPolicy(scheme="dither",
                                         backend="torch-ref"))}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_grads_close(got, want, tol, what):
    """Leaf by leaf, in flatten order: mean and max of |Δ| against the
    reference leaf's mean and max magnitude."""
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


def test_forward_logits_match_reference():
    """``registry.apply_model`` (remat or not) against the reference's:
    full-sequence f32 logits over the padded vocab."""
    want = ref_registry.apply_model(PARAMS, CFG, BATCH)
    for remat in (True, False):
        got = registry.apply_model(TORCH_PARAMS, PCFG, TORCH_BATCH,
                                   remat=remat)
        assert got.dtype == torch.float32
        assert tuple(got.shape) == (2, 16, PCFG.vocab_padded())
        assert np.abs(_f32(got) - _f32(want)).max() <= LOGIT_TOL
    assert torch.equal(transformer.prefill(TORCH_PARAMS, PCFG,
                                           TORCH_BATCH["tokens"]), got)


def test_apply_model_rejects_what_is_not_ported():
    """Every family is ported now (item 11b-ii brought the
    encoder-decoder, ``tests/test_torch_encdec*.py``); only a family the
    reference lacks raises.  As in the reference's ``apply_model``, a
    decoder-only config ignores ``frames`` and runs its decoder under the
    ``audio`` family name; an ``is_encdec`` config reads its ``frames``.
    ``embeds`` are prepended, as the reference prepends them for any
    config (``tests/test_torch_zoo.py`` holds the VLM); the recurrent
    families are ``tests/test_torch_recurrent_train.py``'s."""
    plain = registry.apply_model(TORCH_PARAMS, PCFG, TORCH_BATCH)
    framed = {**TORCH_BATCH, "frames": torch.zeros(2, 4, 128)}
    assert torch.equal(registry.apply_model(TORCH_PARAMS, PCFG, framed),
                       plain)
    assert torch.equal(registry.apply_model(
        TORCH_PARAMS, dataclasses.replace(PCFG, family="audio"), framed),
        plain)
    with pytest.raises(ValueError, match="unknown family"):
        registry.apply_model(TORCH_PARAMS,
                             dataclasses.replace(PCFG, family="speech"),
                             TORCH_BATCH)
    whisper = get_config("whisper_small").reduced()
    wp = registry.init_model(whisper, seed=0, device="cpu")
    with pytest.raises(KeyError, match="frames"):
        registry.apply_model(wp, whisper, TORCH_BATCH)
    out = registry.apply_model(wp, whisper, {
        **TORCH_BATCH, "frames": torch.zeros(2, whisper.n_enc_tokens, 128)})
    assert tuple(out.shape) == (2, 16, whisper.vocab_padded())
    out = registry.apply_model(
        TORCH_PARAMS, PCFG,
        {**TORCH_BATCH, "embeds": torch.zeros(2, 4, 128,
                                              dtype=torch.bfloat16)})
    assert tuple(out.shape) == (2, 4 + 16, PCFG.vocab_padded())


@pytest.mark.parametrize("name", list(POLICIES))
def test_loss_and_grads_match_reference(name):
    """``trainer.loss_and_grads`` against ``jax.value_and_grad`` of the
    reference's ``loss_fn`` (remat on both sides): the loss and every
    gradient leaf."""
    ref_pol, pol = POLICIES[name]
    fn = jax.jit(jax.value_and_grad(ref_trainer.loss_fn),
                 static_argnums=(1, 3, 5))
    want_loss, want_g = fn(PARAMS, CFG, BATCH,
                           ref_pol.resolved() if ref_pol else None,
                           jnp.int32(COUNTER), True)
    loss, grads = trainer.loss_and_grads(TORCH_PARAMS, PCFG, TORCH_BATCH,
                                         pol, COUNTER)
    tol = TOL[pol is not None]
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) - float(want_loss)) <= tol["loss"]
    assert all(g.dtype == p.dtype for g, p in zip(
        tree.leaves(grads), tree.leaves(TORCH_PARAMS)))
    _assert_grads_close(grads, want_g, tol, name)


def test_remat_changes_no_bit():
    """Recomputing each layer in the backward gives the loss and the
    gradients of the plain backward bit for bit, with no policy and under
    the dither policy."""
    for pol in (None, QuantPolicy(scheme="dither", backend="torch-ref")):
        a = trainer.loss_and_grads(TORCH_PARAMS, PCFG, TORCH_BATCH, pol,
                                   COUNTER, remat=True)
        b = trainer.loss_and_grads(TORCH_PARAMS, PCFG, TORCH_BATCH, pol,
                                   COUNTER, remat=False)
        assert torch.equal(a[0], b[0])
        assert all(torch.equal(x, y) for x, y in zip(tree.leaves(a[1]),
                                                     tree.leaves(b[1])))


def _ref_state():
    return ref_trainer.init_train_state(jax.random.PRNGKey(0), CFG)


STEP_CASES = {
    "plain": dict(policy=None, grad_policy=None, microbatch=0),
    "microbatch2-dither": dict(policy="dither-fused", grad_policy=None,
                               microbatch=2),
    "grad-compress": dict(policy=None, grad_policy="dither", microbatch=0),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_reference(case):
    """One whole ``make_train_step`` (loss, grads, optional microbatches
    and gradient compression, AdamW with clipping and decay) from the
    reference's own train state (``interop.train_state_from_numpy``):
    new params, moments, step and counter, and the metrics."""
    c = STEP_CASES[case]
    ref_pol, pol = POLICIES[c["policy"]] if c["policy"] else (None, None)
    ref_gp = gp = None
    if c["grad_policy"]:
        ref_gp = RefPolicy(scheme="dither", bits=8)
        gp = QuantPolicy(scheme="dither", bits=8)
    lr = 1e-2
    ref_step = jax.jit(ref_trainer.make_train_step(
        CFG, ref_adamw.AdamW(lr=lr), policy=ref_pol, grad_policy=ref_gp,
        microbatch=c["microbatch"]))
    state = _ref_state()
    state["counter"] = jnp.int32(COUNTER)
    port_state = train_state_from_numpy(jax.tree.map(np.asarray, state),
                                        "cpu")
    step = trainer.make_train_step(PCFG, adamw.AdamW(lr=lr), policy=pol,
                                   grad_policy=gp, microbatch=c["microbatch"])
    want, want_m = ref_step(state, BATCH)
    got, got_m = step(port_state, TORCH_BATCH)

    tol = TOL[pol is not None or gp is not None]
    assert abs(float(got_m["loss"]) - float(want_m["loss"])) <= tol["loss"]
    assert abs(float(got_m["grad_norm"]) / float(want_m["grad_norm"])
               - 1) <= tol["mean"]
    np.testing.assert_allclose(float(got_m["lr"]), float(want_m["lr"]),
                               rtol=1e-7)
    assert int(got["counter"]) == COUNTER + 1
    assert got["counter"].dtype == torch.int32
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 1
    _assert_grads_close(got["opt"]["m"], want["opt"]["m"], tol, case + " m")
    _assert_grads_close(got["opt"]["v"], want["opt"]["v"],
                        dict(tol, mean=2 * tol["mean"], max=2 * tol["max"]),
                        case + " v")
    same = total = 0
    for g, w, p in zip(tree.leaves(got["params"]),
                       jax.tree.leaves(want["params"]),
                       jax.tree.leaves(state["params"])):
        g, w, p = _f32(g), _f32(w), _f32(p)
        mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), 1e-30)
        ulp = np.exp2(np.floor(np.log2(mag)) - 7)
        assert np.all(np.abs(g - w) <= 2 * lr + ulp), (
            case, np.max(np.abs(g - w) - ulp))
        same += int(np.sum(g == w))
        total += g.size
        assert not np.array_equal(w, p)          # the step moved them
    assert same >= 0.97 * total, (case, same / total)


def test_apply_updates_keeps_the_weight_absmax_cache_true():
    """After ``apply_updates`` every updated weight, as the model reads
    it (a repeat of a stacked leaf, the transposed embedding), has
    ``weight_absmax`` equal to ``policy_absmax`` of its new values, also
    when the cache held the old weights' ranges; the old tensors are left
    as they were (no update in place)."""
    params = tree.tree_map(lambda t: t.clone(), TORCH_PARAMS)
    old = tree.tree_map(lambda t: t.clone(), params)

    def views(p):
        out = [p["embed"].T]
        for bp, _, _, _ in transformer._layers(p, PCFG):
            out += [bp["attn"][k] for k in ("wq", "wk", "wv", "wo")]
            out += [bp["mlp"][k] for k in ("wg", "wu", "wd")]
        return out

    before = [dm.weight_absmax(w) for w in views(params)]
    grads = tree.tree_map(lambda t: torch.ones_like(t), params)
    new, _, _ = adamw.apply_updates(adamw.AdamW(lr=0.05), params, grads,
                                    adamw.init_opt_state(params))
    moved = 0
    for w, b in zip(views(new), before):
        assert torch.equal(dm.weight_absmax(w), kref.policy_absmax(w))
        moved += int(not torch.equal(kref.policy_absmax(w), b))
    assert moved > 0
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(params),
                                                 tree.leaves(old)))


def test_train_state_carries_over_bitwise():
    """``interop.train_state_from_numpy``: params, f32 moments, 0-d int32
    ``step`` and ``counter``, bit for bit, in flatten order."""
    state = _ref_state()
    port = train_state_from_numpy(jax.tree.map(np.asarray, state), "cpu")
    assert port["counter"].shape == () and port["counter"].dtype == \
        torch.int32
    assert port["opt"]["step"].shape == ()
    for g, w in zip(tree.leaves(port), jax.tree.leaves(state)):
        np.testing.assert_array_equal(_f32(g).view(np.uint32),
                                      _f32(w).view(np.uint32))
    paths = [tree.path_str(p) for p, _ in tree.leaves_with_path(port)]
    assert paths == ["/".join(str(k) for k in p)
                     for p, _ in jax.tree_util.tree_leaves_with_path(state)]
