"""Kernels of the port: hand-written CUDA for Hopper, each beside its
plain-torch version (``ref.py``), built from ``csrc/`` at first use
(``_build.py``) and selected through ``dispatch.py``."""
