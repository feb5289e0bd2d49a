"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` serves one cell of ``BENCHMARK.json`` and prints one JSON line.
Configurations, traffic mixes, cells, per-layer metrics and roofline
counts are files under this folder, found by the names the manifest
gives them (``spec.py``).  Nothing here imports ``jax`` or the JAX
package, and ``reference/`` imports nothing of the port either.
"""
