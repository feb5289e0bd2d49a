"""The reference's sharded engine on ``tests/_torch_mesh.REF_CASES``:
run as a script with four virtual CPU devices, as ``tests/test_elastic.py``
runs its subprocess, and write the streams to a JSON file::

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_torch_mesh_ref.py OUT.json

Each case serves its traffic on the reference's (2, 2) ``make_serve_mesh``
with the weights of ``tests/_torch_zoo.model`` (the port's seed-0 init,
carried over bit for bit), compiled as written (``exact_reference_jit``).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def main(path):
    import repro.serve.engine as ref_engine
    from _torch_mesh import REF_CASES, ref_requests
    from _torch_zoo import exact_reference_jit, model
    from repro.launch.mesh import make_serve_mesh
    from repro.numerics.policy import QuantPolicy

    out = {}
    for name, (arch, policy, batch, max_len, _, temp, seed, max_new) \
            in REF_CASES.items():
        cfg, _, params, _ = model(arch)
        with exact_reference_jit():
            eng = ref_engine.Engine(
                params, cfg, batch=batch, max_len=max_len,
                mesh=make_serve_mesh(2, 2),
                policy=(QuantPolicy(scheme=policy, backend="xla-ref")
                        if policy else None))
            for r in ref_requests(ref_engine, cfg, temp, seed, max_new):
                eng.submit(r)
            done = sorted(eng.run(200), key=lambda r: r.rid)
        out[name] = [(r.rid, r.finish_reason, [int(t) for t in r.out])
                     for r in done]
    with open(path, "w") as fh:
        json.dump(out, fh)


if __name__ == "__main__":
    main(sys.argv[1])
