"""repro_torch — the PyTorch/CUDA port of the dither-computing serving and
training paths.

A package of its own beside the JAX reference package: it imports ``torch``
and ``numpy`` only, and mirrors the reference's layout (``configs/``,
``core/``, ``models/``, ``numerics/``, ``kernels/``, ``serve/``,
``launch/``, ``optim/``, ``data/``, ``checkpoint/``, ``train/``) so each
counterpart sits at the same path.  Entry points take
an explicit ``device=`` that defaults to ``"cuda"``; the CPU runs only when
a caller asks for it, and then every kernel wrapper takes its plain-torch
version.  See README.md ("PyTorch/CUDA port") and ROADMAP.md for what is
ported so far.
"""
