"""The reference's sharded decode on ``tests/_torch_decode_mesh.py``'s
models: run as a script with four virtual CPU devices and a fixed hash
seed, as ``tests/_torch_train_mesh_ref.py`` runs its step::

    XLA_FLAGS=--xla_force_host_platform_device_count=4 PYTHONHASHSEED=0 \\
        python tests/_torch_decode_mesh_ref.py OUT_DIR MODEL [MODEL ...]

For each model the reference's ``registry.apply_prefill`` (one device,
no policy, compiled as written: ``_torch_zoo.EXACT``) fills a
``MAX_LEN`` ring from the prompt; then, for each policy and each mesh of
``SHAPES``, ``registry.apply_decode`` is jitted over the params placed by
``dist.sharding.param_specs``, the cache by ``cache_specs`` and the
tokens by the batch's data axes (as ``launch/dryrun.py`` lowers a decode
cell), under ``ctx.mesh_context``, and runs the ``TICKS`` ticks.
``OUT_DIR/ref-decode-<model>.npz`` holds ``start/<path>`` (the start
cache), ``<DxM>/<policy>/logits<t>`` and ``<DxM>/<policy>/cache/<path>``
(the cache after the last tick); a bf16 leaf is stored as its int16
words under ``<path>:bf16``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def _flat(tree, prefix):
    import jax
    import jax.numpy as jnp
    import numpy as np

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        name = "/".join([prefix] + keys)
        if leaf.dtype == jnp.bfloat16:
            out[name + ":bf16"] = np.asarray(
                jax.lax.bitcast_convert_type(leaf, jnp.int16))
        else:
            out[name] = np.asarray(leaf)
    return out


def run_model(name):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    import _torch_decode_mesh as dm
    import _torch_train_mesh as tm
    from _torch_zoo import EXACT, to_jax
    from repro.dist import ctx
    from repro.dist import sharding as shd
    from repro.models import registry
    from repro_torch import tree

    pcfg, pparams = tm.model(name)
    cfg = tm.ref_cfg(name)
    params = tree.unflatten(pparams, [to_jax(t) for t in
                                      tree.leaves(pparams)])
    inp = dm.inputs(pcfg)
    frames = (jnp.asarray(inp["frames"], jnp.bfloat16) if cfg.is_encdec
              else None)
    prefill = jax.jit(lambda p, t, f: registry.apply_prefill(
        p, cfg, t, jnp.full((dm.BATCH,), dm.PROMPT, jnp.int32), dm.MAX_LEN,
        frames=f), compiler_options=EXACT)
    _, start = prefill(params, jnp.asarray(inp["prompt"]), frames)
    out = _flat(start, "start")
    for pol in dm.POLICIES:
        policy = tm.ref_policy(pol)
        step = jax.jit(lambda p, t, c, n: registry.apply_decode(
            p, cfg, t, c, policy=policy, counter=n), donate_argnums=(2,),
            compiler_options=EXACT)
        for d, m in dm.SHAPES:
            devs = np.asarray(jax.devices()[: d * m]).reshape(d, m)
            mesh = jax.sharding.Mesh(devs, ("data", "model"))

            def place(tree_, specs):
                return jax.tree.map(
                    lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                    tree_, specs, is_leaf=lambda x: isinstance(x, P))

            tok_sh = NamedSharding(mesh, shd._validated(
                P(shd.data_axes(mesh)), (dm.BATCH,), mesh))
            cspecs = shd.cache_specs(start, cfg, mesh)
            with ctx.mesh_context(mesh):
                p_s = place(params, shd.param_specs(params, cfg, mesh))
                cache = place(jax.tree.map(jnp.copy, start), cspecs)
                key = f"{d}x{m}/{pol}"
                for t, tok in enumerate(inp["ticks"]):
                    logits, cache = step(
                        p_s, jax.device_put(jnp.asarray(tok), tok_sh), cache,
                        jnp.int32(t + 1))
                    out[f"{key}/logits{t}"] = np.asarray(logits)
                    # the cache back at its specs (the partitioner may
                    # return it otherwise placed), so no tick recompiles
                    cache = place(cache, cspecs)
            out.update(_flat(cache, f"{key}/cache"))
    return out


def main(out_dir, names):
    import numpy as np

    import _torch_decode_mesh as dm

    for name in names:
        np.savez(dm.ref_file(out_dir, name), **run_model(name))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
