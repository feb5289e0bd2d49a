"""The training-mesh cases of ``tests/test_torch_train_mesh*.py``, run on
the CPU under gloo in one spawned process per rank
(``tests/_torch_mesh.run_mesh``, which imports this module in each rank).

Every case trains ``STEPS`` AdamW steps (lr ``LR``) on one global batch of
``BATCH`` × ``SEQ`` tokens, from weights drawn by the port's seed-0 init
(``model``) and carried to the reference bit for bit; each rank starts
from its blocks of that state (``interop.shard_train_state``) and its
data shard's rows.  A case returns plain data: rank 0 the losses, the
step-1 gradients as the step applied them (AdamW's first moment after
step 1, (1 − β1)·clip·g: the relative gradient checks hold for it as for
g), the second moment v after step 1 and the params after step 1 and
after the last step, all gathered to their global shapes; every rank digests of its local params, m and v
(for the bitwise replica checks).  The reference's sharded step on the
same weights and batch runs in a subprocess with four virtual devices
(``tests/_torch_train_mesh_ref.py``) and writes ``ref-<case>.npz``.

The bounds of :func:`check_against_reference` (measured port against
reference over every case and mesh in brackets): the step-1 loss,
gradients and v as ``tests/test_torch_train.py`` holds one step (v at
twice the gradient bounds) [v: mean 2.6 %, max 7.4 %]; the params after
step 1 within ``2·lr`` + 1 ulp [the gap beyond the ulp ≤ 0.01996] and
equal in ≥ 97 % of entries [≥ 99.37 %], as there; the step-2 loss within
2⁻⁶ [6.0e-3; the reference's own sharded step moves it by up to 1.5e-2
from its (1, 1) one]; the params after two steps within ``2·2·lr`` + 1
ulp [0.0396 beyond the ulp] with a mean gap of at most ``lr``/4 [0.133·lr;
a skipped second step: ≥ 0.61·lr].  Equality after two steps is not
required: it is 29–99.9 % here, and the reference's own sharded step
equals its (1, 1) one in 12–100 % of entries.
"""

import dataclasses
import hashlib
import os

import numpy as np
import torch

LR = 1e-2          # so that a step moves the bf16 params (as test_torch_train)
STEPS = 2
# the step-2 loss comes after a step that may move a param by 2·lr more
# in one package than in the other (a gradient near 0 taking the other
# sign): held within test_torch_train.TOL's policy loss bound, 2⁻⁶
STEP2_LOSS_TOL = 2.0 ** -6
# the mean |Δ| of the params after STEPS steps, in units of lr: a step
# moves a param by ≈ lr, so a port that skipped or misapplied the last
# step sits ≈ 0.6·lr from the reference
PARAMS_MEAN_TOL = 0.25
BATCH = 4
SEQ = 16
SHAPES = [(1, 1), (2, 1), (1, 2), (2, 2)]

# model name → (arch, config overrides)
MODELS = {
    "smollm": ("smollm_135m", {}),
    # 3 heads on a 2-way 'model' axis: the sequence split
    "smollm-h3": ("smollm_135m", dict(n_heads=3, n_kv_heads=1)),
    # 4 query heads over 1 KV head: wq/wo split, wk/wv replicated
    "smollm-kv1": ("smollm_135m", dict(n_kv_heads=1)),
    "granite-moe": ("granite_moe_1b_a400m", {}),
    # 5 experts on a 2-way 'model' axis: the reference pads them to 6
    "granite-moe-e5": ("granite_moe_1b_a400m", dict(n_experts=5)),
    "internvl2": ("internvl2_1b", {}),
    "mamba2": ("mamba2_370m", {}),
    # (rglru, rglru, attn): the RG-LRU replicated, MQA attention on
    # local query heads over the replicated KV head, GELU MLP split
    "rgemma": ("recurrentgemma_9b", {}),
    "whisper": ("whisper_small", {}),
    # 3 heads on a 2-way 'model' axis: the encoder's, the decoder's and
    # the cross-attention's sequence split (K/V of the whole encoder
    # output)
    "whisper-h3": ("whisper_small", dict(n_heads=3, n_kv_heads=3)),
}

# case → (model, policy, meshes, microbatch, gradient compression)
REF_CASES = {
    "none": ("smollm", "none", SHAPES, 0, False),
    "unfused": ("smollm", "unfused", SHAPES, 0, False),
    "fused": ("smollm", "fused", SHAPES, 0, False),
    "compress": ("smollm", "none", [(1, 1), (2, 2)], 0, True),
    "microbatch": ("smollm", "none", [(1, 1), (2, 1), (2, 2)], 2, False),
    "seq-split": ("smollm-h3", "fused", [(1, 1), (1, 2)], 0, False),
    "kv-replicated": ("smollm-kv1", "unfused", [(1, 1), (1, 2)], 0, False),
    "moe": ("granite-moe", "none", [(1, 1), (2, 1)], 0, False),
    "moe-epad": ("granite-moe-e5", "unfused", [(1, 1), (2, 1), (2, 2)], 0,
                 False),
    "vlm": ("internvl2", "fused", [(1, 1), (2, 2)], 0, False),
    "ssm": ("mamba2", "none", [(1, 2), (2, 2)], 0, False),
    "ssm-fused": ("mamba2", "fused", [(1, 2), (2, 2)], 0, False),
    "hybrid": ("rgemma", "none", [(1, 2), (2, 2)], 0, False),
    "hybrid-fused": ("rgemma", "fused", [(1, 2), (2, 2)], 0, False),
    "encdec": ("whisper", "none", [(1, 2), (2, 2)], 0, False),
    "encdec-fused": ("whisper", "fused", [(1, 2), (2, 2)], 0, False),
    "encdec-seq": ("whisper-h3", "fused", [(1, 2)], 0, False),
}

_MODELS = {}


def model(name):
    """(port config, port params on the CPU, reference config) of a
    ``MODELS`` entry; the reference config only where JAX is importable
    (the test process and the reference's subprocess), else None."""
    if name not in _MODELS:
        from repro_torch.configs import get_config
        from repro_torch.models import registry

        arch, over = MODELS[name]
        pcfg = dataclasses.replace(get_config(arch).reduced(), **over)
        params = registry.init_model(pcfg, seed=0, device="cpu")
        _MODELS[name] = (pcfg, params)
    pcfg, params = _MODELS[name]
    return pcfg, params


def ref_cfg(name):
    from repro.configs import get_config as ref_get_config

    arch, over = MODELS[name]
    return dataclasses.replace(ref_get_config(arch).reduced(), **over)


def batch(cfg):
    """One global batch as numpy: int32 tokens = labels (B, S), and
    bf16-representable f32 ``embeds`` (B, F, d) for a ``vit_stub`` config
    or ``frames`` (B, T_enc, d) for the encoder-decoder."""
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, size=(BATCH, SEQ)).astype(
        np.int32)
    out = {"tokens": tokens, "labels": tokens.copy()}
    for key, rows in (("embeds", cfg.n_frontend_tokens
                       if cfg.frontend == "vit_stub" else 0),
                      ("frames", cfg.n_enc_tokens if cfg.is_encdec else 0)):
        if rows:
            e = rng.normal(size=(BATCH, rows, cfg.d_model))
            out[key] = torch.from_numpy(e.astype(np.float32)).bfloat16() \
                .float().numpy()
    return out


BF16_INPUTS = ("embeds", "frames")


def port_batch(cfg):
    b = {k: torch.from_numpy(v) for k, v in batch(cfg).items()}
    for k in BF16_INPUTS:
        if k in b:
            b[k] = b[k].bfloat16()
    return b


def port_policy(kind):
    from repro_torch.numerics.policy import QuantPolicy

    return {"none": None,
            "unfused": QuantPolicy(scheme="dither", backend="torch"),
            "fused": QuantPolicy(scheme="dither",
                                 backend="torch-ref")}[kind]


def ref_policy(kind):
    from repro.numerics.policy import QuantPolicy

    return {"none": None,
            "unfused": QuantPolicy(scheme="dither", backend="jnp"),
            "fused": QuantPolicy(scheme="dither", backend="xla-ref")}[kind]


def f32(t):
    return t.detach().to(torch.float32).numpy()


def digest(t):
    return hashlib.sha1(t.detach().reshape(-1).contiguous().view(torch.uint8).numpy()
                        .tobytes()).hexdigest()


def train_case(mesh, shape, name):
    """One ``REF_CASES`` case on this rank of ``mesh``."""
    import torch.distributed as dist

    from repro_torch import interop, tree
    from repro_torch.dist import ctx
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import trainer

    mname, pol, _, mb, compress = REF_CASES[name]
    cfg, params = model(mname)
    policy = port_policy(pol)
    gpol = port_policy("unfused") if compress else None
    coord = ctx.mesh_coordinate(mesh)
    state = interop.shard_train_state(trainer.init_train_state(
        cfg, seed=0, device="cpu") | {"params": params}, cfg, coord, mesh)
    b = port_batch(cfg)
    dp = shape[0]
    rows = slice(coord["data"] * BATCH // dp,
                 (coord["data"] + 1) * BATCH // dp)
    local = {k: v[rows] for k, v in b.items()}
    step = trainer.make_train_step(cfg, AdamW(lr=LR), policy=policy,
                                   grad_policy=gpol, microbatch=mb,
                                   mesh=mesh)
    losses, first, digests = [], None, []
    for _ in range(STEPS):
        state, metrics = step(state, local)
        losses.append(float(metrics["loss"]))
        digests.append({k: [digest(t) for t in tree.leaves(v)]
                        for k, v in (("params", state["params"]),
                                     ("m", state["opt"]["m"]),
                                     ("v", state["opt"]["v"]))})
        if first is None:    # the step-1 gradients as the step applied them
            first = interop.gather_train_state(state, cfg, mesh)
    whole = interop.gather_train_state(state, cfg, mesh)
    out = {"coord": coord, "losses": losses, "digests": digests}
    if dist.get_rank() == 0:
        out["grads"] = [f32(g) for g in tree.leaves(first["opt"]["m"])]
        out["v"] = [f32(v) for v in tree.leaves(first["opt"]["v"])]
        out["params1"] = [f32(p) for p in tree.leaves(first["params"])]
        out["params"] = [f32(p) for p in tree.leaves(whole["params"])]
    return out


# ----------------------------------------------------- cases inside the port


ONE_RANK_CASES = {"none": ("smollm", "none"),
                  "unfused": ("smollm", "unfused"),
                  "fused": ("smollm", "fused"),
                  "moe-unfused": ("granite-moe", "unfused")}


def one_rank_case(mesh, shape, tmp):
    """The (1, 1) mesh's step against the single-device step, two steps
    of each ``ONE_RANK_CASES`` entry: losses, params, m and v bit for bit;
    and the gradient bucket and the loss reduced over the one-rank 'data'
    group every mesh step (the mesh path ran)."""
    from repro_torch import tree
    from repro_torch.dist import ctx
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import trainer

    out = {}
    for name, (mname, pol) in ONE_RANK_CASES.items():
        cfg, _ = model(mname)
        b = port_batch(cfg)
        runs = []
        for m in (None, mesh):
            state = trainer.init_train_state(cfg, seed=0, device="cpu")
            step = trainer.make_train_step(cfg, AdamW(lr=LR),
                                           policy=port_policy(pol), mesh=m)
            before = {k: ctx.COLLECTIVES[k]["calls"] for k in ("grads",
                                                                "loss")}
            losses = []
            for _ in range(STEPS):
                state, metrics = step(state, b)
                losses.append(float(metrics["loss"]))
            runs.append((losses, [digest(t) for t in tree.leaves(
                {"p": state["params"], "o": state["opt"]})]))
            reduces = {k: ctx.COLLECTIVES[k]["calls"] - before[k]
                       for k in before}
        out[name] = {"equal": runs[0] == runs[1], "reduces": reduces}
    return out


def elastic_save_case(mesh, shape, tmp):
    """Train one step on this mesh and checkpoint it (every rank saves;
    rank (0, 0) writes the gathered global state)."""
    from repro_torch import interop
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.dist import ctx
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import trainer

    cfg, _ = model("smollm")
    coord = ctx.mesh_coordinate(mesh)
    state = interop.shard_train_state(
        trainer.init_train_state(cfg, seed=0, device="cpu"), cfg, coord,
        mesh)
    b = port_batch(cfg)
    rows = slice(coord["data"] * BATCH // shape[0],
                 (coord["data"] + 1) * BATCH // shape[0])
    step = trainer.make_train_step(cfg, AdamW(lr=LR), mesh=mesh)
    state, _ = step(state, {k: v[rows] for k, v in b.items()})
    ck = Checkpointer(os.path.join(tmp, "elastic"), mesh=mesh, cfg=cfg)
    ck.save(1, state)
    return {"saved": True}


def elastic_restore_case(mesh, shape, tmp):
    """Restore the (2, 2) checkpoint onto this mesh: each rank's leaves
    byte for byte its blocks of the checkpoint's global arrays; then one
    more step runs."""
    from repro_torch import interop, tree
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.dist import ctx
    from repro_torch.dist import sharding
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import trainer

    cfg, _ = model("smollm")
    coord = ctx.mesh_coordinate(mesh)
    like = interop.shard_train_state(
        trainer.init_train_state(cfg, seed=0, device="cpu"), cfg, coord,
        mesh)
    path = os.path.join(tmp, "elastic")
    ck = Checkpointer(path, mesh=mesh, cfg=cfg)
    got = ck.restore(ck.latest_step(), like,
                     interop.train_state_shardings(like, cfg, mesh, coord))
    with np.load(os.path.join(path, "step_00000001", "arrays.npz")) as data:
        glob = [torch.from_numpy(np.array(data[f"leaf_{i}"]))
                for i in range(len(data.files))]
    places = tree.leaves(interop.train_state_shardings(like, cfg, mesh,
                                                       coord))
    equal = all(
        torch.equal(g.float(), p.local(w)) and g.dtype == l_.dtype
        for g, w, p, l_ in zip(tree.leaves(got), glob, places,
                               tree.leaves(like)))
    whole = shape == (1, 1) and all(
        torch.equal(g.float(), w) for g, w in zip(tree.leaves(got), glob))
    b = port_batch(cfg)
    rows = slice(coord["data"] * BATCH // shape[0],
                 (coord["data"] + 1) * BATCH // shape[0])
    step = trainer.make_train_step(cfg, AdamW(lr=LR), mesh=mesh)
    _, metrics = step(got, {k: v[rows] for k, v in b.items()})
    del sharding
    return {"blocks_equal": equal, "whole": whole,
            "loss": float(metrics["loss"]),
            "counter": int(got["counter"]), "step": int(got["opt"]["step"])}


def limits_case(mesh, shape, tmp):
    """What the training mesh refuses: query heads that straddle KV groups
    when the KV projections stay replicated (6 heads over 3 KV heads on a
    2-way 'model' axis), attention's per-call K/V (``return_kv``) at
    tp > 1, a batch the data axis does not divide, and microbatches that
    do not divide a data shard's rows."""
    from repro_torch import interop
    from repro_torch.dist import ctx
    from repro_torch.launch.train import run_training
    from repro_torch.models import layers
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import trainer

    out = {}
    cfg, _ = model("smollm")
    straddle = dataclasses.replace(cfg, n_heads=6, n_kv_heads=3)
    step = trainer.make_train_step(straddle, AdamW(lr=LR), mesh=mesh)
    state = interop.shard_train_state(
        trainer.init_train_state(straddle, device="cpu"), straddle,
        ctx.mesh_coordinate(mesh), mesh)
    try:
        step(state, {k: v[:BATCH // shape[0]]
                     for k, v in port_batch(cfg).items()})
        out["straddle"] = None
    except NotImplementedError as e:
        out["straddle"] = str(e)
    attn = {k: v[0] for k, v in model("smollm")[1]["blocks"][0]["attn"]
            .items()}
    x = torch.zeros((1, 4, cfg.d_model), dtype=torch.bfloat16)
    try:
        with ctx.train_shard_scope(mesh):
            layers.attention(attn, cfg, x, torch.zeros((1, 4),
                                                       dtype=torch.long),
                             return_kv=True)
        out["return_kv"] = None
    except NotImplementedError as e:
        out["return_kv"] = str(e)
    try:
        run_training(cfg, steps=1, batch=shape[0] + 1, seq=8, device="cpu",
                     mesh=mesh, log=lambda *a: None)
        out["batch"] = None
    except ValueError as e:
        out["batch"] = str(e)
    step = trainer.make_train_step(cfg, AdamW(lr=LR), microbatch=3,
                                   mesh=mesh)
    try:
        step(trainer.init_train_state(cfg, device="cpu"),
             {k: v[:2] for k, v in port_batch(cfg).items()})
        out["microbatch"] = None
    except ValueError as e:
        out["microbatch"] = str(e)
    return out


def kernel6_parity_case(mesh, shape, tmp):
    """One sharded step of ``smollm_135m.reduced()`` (head dim 64) under
    the fused dither policy on the card: through kernel 6's sharded entry
    (``auto``) and through its plain version (``torch-ref``), losses and
    this rank's params, m and v bit for bit; and the sharded entry's
    launches in the kernel run."""
    import _torch_mesh
    from repro_torch import tree
    from repro_torch import interop
    from repro_torch.dist import ctx
    from repro_torch.kernels import dither_matmul as dm
    from repro_torch.numerics.policy import QuantPolicy
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import trainer

    dev = _torch_mesh.DEVICE
    cfg, _ = model("smollm")
    cfg = dataclasses.replace(cfg, head_dim=64)
    coord = ctx.mesh_coordinate(mesh)
    b = {k: v.to(dev) for k, v in port_batch(cfg).items()}
    rows = slice(coord["data"] * BATCH // shape[0],
                 (coord["data"] + 1) * BATCH // shape[0])
    out, launches = {}, 0
    for backend in ("auto", "torch-ref"):
        state = interop.shard_train_state(
            trainer.init_train_state(cfg, seed=0, device=dev), cfg, coord,
            mesh)
        step = trainer.make_train_step(
            cfg, AdamW(lr=LR), policy=QuantPolicy(scheme="dither",
                                                  backend=backend),
            mesh=mesh)
        before = dm.dither_matmul_sharded.launches
        state, metrics = step(state, {k: v[rows] for k, v in b.items()})
        if backend == "auto":
            launches = dm.dither_matmul_sharded.launches - before
        out[backend] = (float(metrics["loss"]), tree.leaves(
            {"p": state["params"], "o": state["opt"]}))
    same = out["auto"][0] == out["torch-ref"][0] and all(
        torch.equal(a, c) for a, c in zip(out["auto"][1],
                                          out["torch-ref"][1]))
    return {"equal": same, "launches": launches}


def _register():
    from _torch_mesh import case

    for name in REF_CASES:
        case(f"train-{name}")(
            lambda mesh, shape, tmp, name=name: train_case(mesh, shape, name))
    case("train-one-rank")(one_rank_case)
    case("train-elastic-save")(elastic_save_case)
    case("train-elastic-restore")(elastic_restore_case)
    case("train-limits")(limits_case)
    case("train-kernel6-parity")(kernel6_parity_case)


_register()


# ----------------------------------------------------------- the test side


def reference(tmp, names):
    """Run ``tests/_torch_train_mesh_ref.py`` on ``names`` (four virtual
    devices, ``PYTHONHASHSEED=0``) → {case: npz}."""
    import subprocess
    import sys

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONHASHSEED"] = "0"
    here = os.path.dirname(os.path.abspath(__file__))
    subprocess.run([sys.executable, os.path.join(here,
                                                 "_torch_train_mesh_ref.py"),
                    tmp, *names], env=env, check=True, timeout=900)
    return {n: dict(np.load(os.path.join(tmp, f"ref-{n}.npz")))
            for n in names}


def port(tmp, names):
    """The port's cases ``names`` on every mesh they list, one spawn a
    mesh shape (``PYTHONHASHSEED=0`` in the ranks, as in the reference's
    subprocess) → {shape: [rank results]}."""
    import _torch_mesh

    shapes = sorted({s for n in names for s in REF_CASES[n][2]})
    old = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = "0"
    try:
        return {s: _torch_mesh.run_mesh(
            s, [f"train-{n}" for n in names if s in REF_CASES[n][2]], tmp,
            modules=("_torch_train_mesh",)) for s in shapes}
    finally:
        if old is None:
            del os.environ["PYTHONHASHSEED"]
        else:
            os.environ["PYTHONHASHSEED"] = old


def _ulp(a, b):
    """bf16's ulp at the larger magnitude of each pair of entries."""
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1e-30)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def params(case):
    """(case, shape) pairs of ``cases`` for ``pytest.mark.parametrize``."""
    return [(n, s) for n in case for s in REF_CASES[n][2]]


def check_against_reference(res, ref, name, shape, tol):
    """Rank 0's run against the reference's sharded step at the same mesh
    (``tol`` a ``test_torch_train.TOL`` entry; the bounds are the module
    docstring's): the step-1 loss, gradients (AdamW's m) and their
    squares (v, at twice the gradient bounds); the params after step 1
    within ``2·lr`` + 1 ulp and equal in ≥ 97 % of entries; the step-2
    loss within ``STEP2_LOSS_TOL``; the params after ``STEPS`` steps
    within ``STEPS·2·lr`` + 1 ulp, their mean gap at most
    ``PARAMS_MEAN_TOL``·lr."""
    r0 = res[0][f"train-{name}"]
    assert "error" not in r0, r0.get("error")
    key = f"{shape[0]}x{shape[1]}"
    want = ref[f"{key}/losses"]
    assert abs(r0["losses"][0] - want[0]) <= tol["loss"], (
        name, shape, r0["losses"], want)
    assert abs(r0["losses"][1] - want[1]) <= STEP2_LOSS_TOL, (
        name, shape, r0["losses"], want)
    n = len(r0["params"])
    for kind, got, scale in (("g", r0["grads"], 1), ("v", r0["v"], 2)):
        for i in range(n):
            g, w = got[i], ref[f"{key}/{kind}{i}"]
            assert g.shape == w.shape, (name, shape, kind, i)
            d = np.abs(g - w)
            assert d.mean() <= scale * tol["mean"] * np.abs(w).mean(), (
                name, shape, kind, i, d.mean() / np.abs(w).mean())
            assert d.max() <= scale * tol["max"] * np.abs(w).max(), (
                name, shape, kind, i, d.max() / np.abs(w).max())
    same = total = 0
    for i in range(n):
        g, w = r0["params1"][i], ref[f"{key}/p1-{i}"]
        assert np.all(np.abs(g - w) <= 2 * LR + _ulp(g, w)), (
            name, shape, i, np.max(np.abs(g - w) - _ulp(g, w)))
        same += int(np.sum(g == w))
        total += g.size
    assert same >= 0.97 * total, (name, shape, same / total)
    gap = 0.0
    for i in range(n):
        g, w = r0["params"][i], ref[f"{key}/p{i}"]
        assert np.all(np.abs(g - w) <= STEPS * 2 * LR + _ulp(g, w)), (
            name, shape, i, np.max(np.abs(g - w) - _ulp(g, w)))
        gap += float(np.abs(g - w).sum())
    assert gap / total <= PARAMS_MEAN_TOL * LR, (name, shape,
                                                 gap / total / LR)


def check_replicas(res, name, shape):
    """After every step: the data replicas' params, m and v bit for bit
    equal (ranks with one 'model' coordinate), and the 'model' ranks'
    replicated leaves too."""
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import MeshShape

    out = [r[f"train-{name}"] for r in res]
    for r in out:
        assert "error" not in r, r.get("error")
    cfg, p = model(REF_CASES[name][0])
    specs = sharding.spec_leaves(sharding.train_param_specs(
        p, cfg, MeshShape(("data", "model"), shape)))
    for step in range(STEPS):
        by_model = {}
        for r in out:
            by_model.setdefault(r["coord"]["model"], []).append(
                r["digests"][step])
        for group in by_model.values():
            assert all(g == group[0] for g in group), (name, shape, step,
                                                       "data")
        for kind in ("params", "m", "v"):
            for i, spec in enumerate(specs):
                if "model" not in spec:
                    assert len({r["digests"][step][kind][i]
                                for r in out}) == 1, (name, shape, step,
                                                      kind, i)
