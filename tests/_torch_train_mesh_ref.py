"""The reference's sharded train step on ``tests/_torch_train_mesh.py``'s
cases: run as a script with four virtual CPU devices and a fixed hash
seed, as ``tests/test_elastic.py`` runs its subprocess::

    XLA_FLAGS=--xla_force_host_platform_device_count=4 PYTHONHASHSEED=0 \\
        python tests/_torch_train_mesh_ref.py OUT_DIR CASE [CASE ...]

For each case and each of its meshes the reference's ``make_train_step``
is jitted (compiled as written, ``_torch_zoo.EXACT``) over a train state
placed by ``dist.sharding.param_specs`` and a batch placed by
``batch_specs``, under ``ctx.mesh_context`` (as ``launch/dryrun.py``
lowers it), and so is ``jax.value_and_grad(loss_fn)``; the weights are the
port's seed-0 init carried over bit for bit.  ``OUT_DIR/ref-<case>.npz``
holds, per mesh ``DxM``: ``DxM/losses`` (every step's), ``DxM/g<i>``
and ``DxM/v<i>`` (AdamW's moments after step 1: the step-1 gradients as
the step applied them, and their squares), ``DxM/p1-<i>`` (params after
step 1) and ``DxM/p<i>`` (params after the last step), leaves in flatten
order.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def run_case(name):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    import _torch_train_mesh as tm
    from _torch_zoo import EXACT, to_jax
    from repro.dist import ctx
    from repro.dist import sharding as shd
    from repro.optim import adamw
    from repro.train import trainer
    from repro_torch import tree

    mname, pol, shapes, mb, compress = tm.REF_CASES[name]
    pcfg, pparams = tm.model(mname)
    cfg = tm.ref_cfg(mname)
    params = tree.unflatten(pparams, [to_jax(t) for t in
                                      tree.leaves(pparams)])
    state0 = trainer.init_train_state(jax.random.PRNGKey(0), cfg)
    state0["params"] = params
    b = {k: jnp.asarray(v) for k, v in tm.batch(cfg).items()}
    for k in tm.BF16_INPUTS:
        if k in b:
            b[k] = b[k].astype(jnp.bfloat16)
    policy = tm.ref_policy(pol)
    gpol = tm.ref_policy("unfused") if compress else None
    out = {}
    for d, m in shapes:
        devs = np.asarray(jax.devices()[: d * m]).reshape(d, m)
        mesh = jax.sharding.Mesh(devs, ("data", "model"))
        pspecs = shd.param_specs(params, cfg, mesh)
        sspecs = {"params": pspecs,
                  "opt": {"m": pspecs, "v": pspecs, "step": P()},
                  "counter": P()}

        def place(tree_, specs):
            return jax.tree.map(
                lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                tree_, specs, is_leaf=lambda x: isinstance(x, P))

        bspecs = shd.batch_specs(cfg, mesh)
        bb = {k: jax.device_put(v, NamedSharding(
            mesh, shd._validated(bspecs[k], v.shape, mesh)))
            for k, v in b.items()}
        with ctx.mesh_context(mesh):
            step = jax.jit(trainer.make_train_step(
                cfg, adamw.AdamW(lr=tm.LR), policy=policy, grad_policy=gpol,
                microbatch=mb), compiler_options=EXACT)
            state = place(state0, sspecs)
            losses, first = [], None
            for _ in range(tm.STEPS):
                state, metrics = step(state, bb)
                losses.append(float(metrics["loss"]))
                first = first or {
                    "g": jax.tree.leaves(state["opt"]["m"]),
                    "v": jax.tree.leaves(state["opt"]["v"]),
                    "p1-": jax.tree.leaves(state["params"])}
        key = f"{d}x{m}"
        out[f"{key}/losses"] = np.asarray(losses)
        first["p"] = jax.tree.leaves(state["params"])
        for kind, leaves in first.items():
            for i, t in enumerate(leaves):
                out[f"{key}/{kind}{i}"] = np.asarray(
                    jnp.asarray(t, jnp.float32))
    return out


def main(out_dir, names):
    import numpy as np

    for name in names:
        np.savez(os.path.join(out_dir, f"ref-{name}.npz"), **run_case(name))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
