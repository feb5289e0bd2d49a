"""Build the port's CUDA kernels from the sources in this checkout.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface (it may
include the shared ``csrc/*.cuh`` headers), compiled by ``nvcc`` for
``sm_90a`` into a shared library and loaded with ``ctypes``.  Libraries go
to ``build/repro_torch_kernels/`` at the checkout's root (git ignores it),
named by a hash of the source, the headers and the flags, so an edited
source or header builds anew and an unchanged one is reused.  Nothing is built when a
module is imported: a wrapper builds its library at its first launch.  If
``nvcc`` is missing or a build fails, this raises with the compiler's
output; there is no fallback.

A build is a cold-start stall of serving: each library built is reported
to :mod:`repro_torch.coldstart` as a ``kernel_build`` event with its
seconds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

from repro_torch import coldstart

__all__ = ["KERNELS", "BUILD_DIR", "library_path", "build", "load"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

# kernel name → its source under csrc/
KERNELS = {"decode_attention": "decode_attention.cu",
           "paged_decode_attention": "paged_decode_attention.cu",
           "verify_attention": "verify_attention.cu",
           "paged_verify_attention": "paged_verify_attention.cu",
           "quantize": "quantize.cu",
           "dither_matmul": "dither_matmul.cu"}

_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (on PATH or at /usr/local/cuda/bin); "
                       "the port's CUDA kernels are built from source and "
                       "have no fallback")


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lives, keyed by source, headers and
    flags."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in [_CSRC / KERNELS[name], *sorted(_CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build every named kernel (default: all) whose library is missing,
    one ``nvcc`` per source, all started together.  Returns the seconds
    each build took (0.0 for a library already built); the compiler's
    output (``-Xptxas -v``: registers, shared memory, spills) is kept
    beside each library as ``.log``."""
    names = list(KERNELS if names is None else names)
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    secs = {n: 0.0 for n in names}
    if not todo:
        return secs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n, out in todo.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(_CSRC / KERNELS[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[n] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
            coldstart.notify("kernel_build", kernel=n, seconds=secs[n])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return secs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Kernel ``name``'s library, built first if it is missing."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
