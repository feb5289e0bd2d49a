"""The sharded decode cases of ``tests/test_torch_decode_mesh.py``, run on
the CPU under gloo in one spawned process per rank
(``tests/_torch_mesh.run_mesh``, which imports this module in each rank).

Every case decodes ``TICKS`` teacher-forced ticks of ``BATCH`` slots of
the reduced mamba2, recurrentgemma and whisper (``_torch_train_mesh``'s
models, the port's seed-0 weights carried to the reference bit for bit)
from one start cache: the reference's single-device prefill of a
``PROMPT``-token prompt into a ``MAX_LEN`` ring, written by
``tests/_torch_decode_mesh_ref.py`` with the reference's sharded decode
of the same ticks.  Each rank decodes on the training layout: its blocks
of the params (``interop.shard_train_params``) and of the start cache
(``interop.shard_cache``), its data shard's rows of every tick's tokens,
under ``ctx.train_shard_scope``.  A case returns plain data: every rank
its rows' logits and digests of its logits and local cache leaves (for
the bitwise replica checks); rank 0 the whole cache, gathered
(``interop.gather_cache``); every rank the collectives of the first
tick.

``decode_collectives`` runs one such tick from an empty cache (the
port's own ``make_cache``) for ``tests/test_torch_dryrun.py``, whose dry
run counts the same tick on the fake process group.
"""

import os

import numpy as np
import torch

import _torch_train_mesh as tm

MODELS = ("mamba2", "rgemma", "whisper")
POLICIES = ("none", "fused")
SHAPES = [(1, 2), (2, 2)]
BATCH = 4
PROMPT = 6
TICKS = 4
MAX_LEN = 16


def inputs(cfg):
    """The prompt (B, PROMPT) and each tick's tokens (TICKS, B), int32,
    and for the encoder-decoder bf16-representable f32 ``frames``."""
    rng = np.random.default_rng(5)
    out = {"prompt": rng.integers(0, cfg.vocab_size, size=(BATCH, PROMPT))
           .astype(np.int32),
           "ticks": rng.integers(0, cfg.vocab_size, size=(TICKS, BATCH))
           .astype(np.int32)}
    if cfg.is_encdec:
        f = rng.normal(size=(BATCH, cfg.n_enc_tokens, cfg.d_model))
        out["frames"] = torch.from_numpy(f.astype(np.float32)).bfloat16() \
            .float().numpy()
    return out


def nest(flat):
    """``{"a/0/b": leaf, …}`` → the nested dicts and lists it names (an
    all-digit key is a list index)."""
    root = {}
    for path, leaf in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[k]) for k in sorted(node, key=int)]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def flat_paths(tree, prefix=""):
    """The inverse of :func:`nest` over a tree of dicts and lists (a
    tuple is a leaf: a spec)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def ref_file(tmp, model):
    return os.path.join(tmp, f"ref-decode-{model}.npz")


def load_tree(data, prefix):
    """The leaves of an npz written by the reference's script under
    ``prefix/`` as a nested numpy tree; bf16 leaves travel as int16
    words under ``name:bf16`` and come back as ``ml_dtypes`` bfloat16
    arrays, which ``interop`` carries bit for bit."""
    import ml_dtypes

    flat = {}
    for k in data.files:
        if not k.startswith(prefix + "/"):
            continue
        v, key = np.array(data[k]), k[len(prefix) + 1:]
        if key.endswith(":bf16"):
            v, key = v.view(ml_dtypes.bfloat16), key[:-len(":bf16")]
        flat[key] = v
    tree = nest(flat)
    if "self" not in tree:       # an empty list leaves no key in the npz
        for key in ("layers", "remainder"):
            tree.setdefault(key, [])
    return tree


def start_cache(tmp, model):
    """The reference's start cache of ``model``, carried to the port on
    the CPU bit for bit (``interop.cache_from_numpy``)."""
    from repro_torch import interop

    with np.load(ref_file(tmp, model)) as data:
        return interop.cache_from_numpy(load_tree(data, "start"), "cpu")


def _rows(coord, dp):
    n = BATCH // dp
    return slice(coord["data"] * n, (coord["data"] + 1) * n)


def _collectives():
    from repro_torch.dist import ctx

    return {k: dict(v) for k, v in ctx.COLLECTIVES.items()}


def _since(before):
    from repro_torch.dist import ctx

    out = {}
    for k, v in ctx.COLLECTIVES.items():
        d = {f: v[f] - before[k][f] for f in ("calls", "bytes")}
        if d["calls"]:
            out[k] = d
    return out


def decode(params, cfg, cache, ticks, policy, mesh=None, rows=slice(None)):
    """``ticks`` (T, B) teacher-forced decode ticks (counter = tick + 1)
    from ``cache``, updated in place: on one device (``mesh`` None) or
    under ``train_shard_scope(mesh)`` on the rows ``rows``.  Returns
    (each tick's f32 logits, the cache, the collectives of tick 1)."""
    import contextlib

    from repro_torch.dist import ctx
    from repro_torch.models import registry

    logits, first = [], None
    for t, tok in enumerate(ticks):
        before = _collectives()
        scope = (ctx.train_shard_scope(mesh) if mesh is not None
                 else contextlib.nullcontext())
        with torch.no_grad(), scope:
            out, cache = registry.apply_decode(
                params, cfg, torch.from_numpy(np.asarray(tok[rows])), cache,
                policy=policy, counter=t + 1)
        logits.append(out)
        first = first if first is not None else _since(before)
    return logits, cache, first


def decode_case(mesh, shape, tmp):
    """Every model × policy on this rank of ``mesh``, from the
    reference's start cache."""
    import torch.distributed as dist

    from repro_torch import interop
    from repro_torch.dist import ctx

    coord = ctx.mesh_coordinate(mesh)
    out = {"coord": coord}
    for model in MODELS:
        cfg, params = tm.model(model)
        start = start_cache(tmp, model)
        toks = inputs(cfg)["ticks"]
        local_p = interop.shard_train_params(params, cfg, coord, mesh)
        for pol in POLICIES:
            cache = interop.shard_cache(start, cfg, coord, mesh)
            logits, cache, coll = decode(local_p, cfg, cache, toks,
                                         tm.port_policy(pol), mesh,
                                         _rows(coord, shape[0]))
            whole = interop.gather_cache(cache, cfg, mesh, start)
            res = {"logits": [tm.f32(x) for x in logits],
                   "logit_digests": [tm.digest(x) for x in logits],
                   "digests": {k: tm.digest(v) for k, v in
                               flat_paths(cache).items()},
                   "collectives": coll}
            if dist.get_rank() == 0:
                res["cache"] = {k: (tm.f32(v), str(v.dtype)) for k, v in
                                flat_paths(whole).items()}
            out[f"{model}/{pol}"] = res
    return out


def empty_cache(cfg, params):
    """The port's own empty start cache at ``BATCH`` × ``MAX_LEN`` (the
    encoder-decoder's from :func:`inputs`' frames)."""
    from repro_torch.models import registry

    frames = None
    if cfg.is_encdec:
        frames = torch.from_numpy(inputs(cfg)["frames"]).bfloat16()
    with torch.no_grad():
        return registry.make_cache(params, cfg, BATCH, MAX_LEN, frames,
                                   device="cpu")


def decode_collectives(mesh, shape, tmp):
    """This rank's collectives in one decode tick of every model × policy
    from the port's empty cache, on the training layout of ``mesh``."""
    from repro_torch import interop
    from repro_torch.dist import ctx

    coord = ctx.mesh_coordinate(mesh)
    out = {}
    for model in MODELS:
        cfg, params = tm.model(model)
        cache = empty_cache(cfg, params)
        local_p = interop.shard_train_params(params, cfg, coord, mesh)
        toks = inputs(cfg)["ticks"][:1]
        for pol in POLICIES:
            _, _, coll = decode(local_p, cfg,
                                interop.shard_cache(cache, cfg, coord, mesh),
                                toks, tm.port_policy(pol), mesh,
                                _rows(coord, shape[0]))
            out[f"{model}/{pol}"] = coll
    return out


def _register():
    from _torch_mesh import case

    case("decode-mesh")(decode_case)
    case("decode-collectives")(decode_collectives)


_register()


# ----------------------------------------------------------- the test side


def reference(tmp):
    """Run ``tests/_torch_decode_mesh_ref.py`` (four virtual devices,
    ``PYTHONHASHSEED=0``) → {model: npz as a dict}."""
    import subprocess
    import sys

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONHASHSEED"] = "0"
    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(here, "_torch_decode_mesh_ref.py")
    # one process a model, side by side: each compiles its own steps
    procs = [subprocess.Popen([sys.executable, script, tmp, m], env=env)
             for m in MODELS]
    for p in procs:
        if p.wait(timeout=900):
            raise RuntimeError(f"{script} exited with {p.returncode}")
    out = {}
    for m in MODELS:
        with np.load(ref_file(tmp, m)) as data:
            out[m] = {k: np.array(data[k]) for k in data.files}
    return out
