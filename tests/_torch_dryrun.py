"""Helpers of ``tests/test_torch_dryrun.py``, each part in a process of its
own:

* ``python tests/_torch_dryrun.py ref OUT`` — the reference's
  ``model_flops`` and ``analytic_memory_bytes`` over every arch × shape ×
  mesh (importing the reference's ``launch/dryrun.py`` forces 512 host
  devices, so it never shares a process with other tests);
* ``python tests/_torch_dryrun.py port OUT`` — the port's dry-run counts
  on the fake process group (``launch.dryrun.fake_mesh``): state bytes,
  FLOPs and collectives of the cases below;
* the case ``dryrun-collectives``, run by ``_torch_mesh.run_mesh`` in
  gloo ranks: the collectives of one real step of the same cases.

Both sides run one training step of ``_torch_train_mesh``'s reduced
models at ``BATCH`` × ``SEQ`` tokens from the seed-0 state, and one
decode tick of ``_torch_decode_mesh``'s reduced recurrent and
encoder-decoder models on the training layout (``decode-collectives``,
the tick of ``tests/test_torch_decode_mesh.py``) at its ``BATCH`` slots
× ``MAX_LEN`` tokens.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import _torch_decode_mesh as dm  # noqa: E402
import _torch_train_mesh as tm  # noqa: E402

# (model, policy) of the collective checks
COLLECTIVE_CASES = [("smollm", "none"), ("smollm", "fused"),
                    ("smollm-h3", "none"), ("mamba2", "none"),
                    ("rgemma", "none"), ("whisper", "fused")]
COLLECTIVE_SHAPES = [(1, 2), (2, 2)]
# the state-bytes checks: reduced models at (2, 2), rank (0, 0)
STATE_MODELS = ["smollm", "granite-moe", "mamba2", "rgemma", "whisper"]
MESH_SIZES = {"single": {"data": 32, "model": 8},
              "multi": {"data": 64, "model": 8}}
CACHE_BYTES = 1.5e9        # a decode cell's global cache bytes, both sides
# the training-layout decode cells: collectives against gloo at (1, 2),
# state bytes at (2, 2), rank (0, 0)
DECODE_SHAPES = [(1, 2), (2, 2)]


def _key(model, policy, shape):
    return f"{model}/{policy}/{shape[0]}x{shape[1]}"


def _diff(before, after):
    out = {}
    for k, v in after.items():
        d = {f: v[f] - before[k][f] for f in ("calls", "bytes")}
        if d["calls"]:
            out[k] = d
    return out


def collectives_case(mesh, shape, tmp):
    """This rank's collectives in one real step of each
    ``COLLECTIVE_CASES`` entry on this mesh (gloo)."""
    from repro_torch import interop
    from repro_torch.dist import ctx
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import trainer

    coord = ctx.mesh_coordinate(mesh)
    out = {}
    for mname, pol in COLLECTIVE_CASES:
        cfg, params = tm.model(mname)
        state = interop.shard_train_state(trainer.init_train_state(
            cfg, seed=0, device="cpu") | {"params": params}, cfg, coord,
            mesh)
        rows = slice(coord["data"] * tm.BATCH // shape[0],
                     (coord["data"] + 1) * tm.BATCH // shape[0])
        batch = {k: v[rows] for k, v in tm.port_batch(cfg).items()}
        step = trainer.make_train_step(cfg, AdamW(lr=tm.LR),
                                       policy=tm.port_policy(pol), mesh=mesh)
        before = {k: dict(v) for k, v in ctx.COLLECTIVES.items()}
        step(state, batch)
        out[_key(mname, pol, shape)] = _diff(before, ctx.COLLECTIVES)
    return out


def _register():
    from _torch_mesh import case

    case("dryrun-collectives")(collectives_case)


_register()


def ref_main(out):
    from types import SimpleNamespace

    from repro.configs import ARCH_IDS, get_config
    from repro.launch import dryrun

    res = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape, meta in dryrun.SHAPES.items():
            kind, seq, batch = meta["kind"], meta["seq"], meta["batch"]
            res[f"{arch}/{shape}/flops"] = dryrun.model_flops(cfg, kind, seq,
                                                              batch)
            for mk, sizes in MESH_SIZES.items():
                mesh = SimpleNamespace(shape=sizes,
                                       size=sizes["data"] * sizes["model"])
                info = dict(cfg=cfg, kind=kind, seq=seq, batch=batch,
                            cache_bytes_global=CACHE_BYTES)
                res[f"{arch}/{shape}/{mk}/bytes"] = \
                    dryrun.analytic_memory_bytes(info, mesh)
    with open(out, "w") as f:
        json.dump(res, f)


def port_main(out):
    from repro_torch.launch import dryrun

    res = {"state_bytes": {}, "collectives": {}}
    for mname in STATE_MODELS:
        cfg, _ = tm.model(mname)
        m = dryrun.measure(cfg, "train", tm.SEQ, tm.BATCH,
                           dryrun.fake_mesh(2, 2))
        res["state_bytes"][mname] = m["state_bytes"]
    cfg, _ = tm.model("smollm")
    for remat in (False, True):
        m = dryrun.measure(cfg, "train", tm.SEQ, tm.BATCH,
                           dryrun.fake_mesh(1, 1), remat=remat)
        res[f"flops/remat={remat}"] = m["flops"]
    for shape in COLLECTIVE_SHAPES:
        mesh = dryrun.fake_mesh(*shape)
        for mname, pol in COLLECTIVE_CASES:
            cfg, _ = tm.model(mname)
            m = dryrun.measure(cfg, "train", tm.SEQ, tm.BATCH, mesh,
                               policy=tm.port_policy(pol))
            res["collectives"][_key(mname, pol, shape)] = m["collectives"]
    res["decode"] = {}
    for shape in DECODE_SHAPES:
        mesh = dryrun.fake_mesh(*shape)
        for mname in dm.MODELS:
            cfg, _ = tm.model(mname)
            for pol in dm.POLICIES:
                m = dryrun.measure(cfg, "decode", dm.MAX_LEN, dm.BATCH, mesh,
                                   policy=tm.port_policy(pol))
                res["decode"][_key(mname, pol, shape)] = {
                    k: m[k] for k in ("collectives", "state_bytes",
                                      "layout")}
    with open(out, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    {"ref": ref_main, "port": port_main}[sys.argv[1]](sys.argv[2])
