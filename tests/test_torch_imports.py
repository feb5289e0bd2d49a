"""The port stands alone: it imports neither JAX, ``ml_dtypes`` nor
anything of the JAX package ``repro``, so it runs where JAX is not
installed.  Proved twice: in a subprocess with those modules blocked, and
by a scan of its sources and ``chip_smoke.py``."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "ml_dtypes", "repro")

_CHILD = r"""
import importlib.abc, sys

BLOCKED = {blocked!r}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {{name}}")
        return None

sys.meta_path.insert(0, Block())
import torch
from repro_torch.configs import get_config
from repro_torch.models import registry
cfg = get_config("smollm_135m").reduced()
params = registry.init_model(cfg, seed=0, device="cpu")
cache = registry.make_cache(params, cfg, 2, 16, kv_quant=True, device="cpu")
logits, cache = registry.apply_decode(params, cfg,
                                      torch.tensor([1, 2]), cache)
assert logits.shape == (2, cfg.vocab_size) and bool(logits.isfinite().all())
import repro_torch.launch.serve, repro_torch.interop, repro_torch.serve
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not bad, bad
print("ok")
"""


def test_port_runs_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(blocked=BLOCKED)],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


_IMPORT = re.compile(
    r"^\s*(import\s+(jax|jaxlib|ml_dtypes|repro)\b(?!_)"
    r"|from\s+(jax|jaxlib|ml_dtypes|repro)\b(?!_))", re.MULTILINE)


def test_sources_import_nothing_of_jax():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15 and all(f.exists() for f in files)
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in _IMPORT.finditer(f.read_text())]
    assert not bad, bad
    assert _IMPORT.search("from repro.models import x")
    assert _IMPORT.search("import jax.numpy as jnp")
    assert not _IMPORT.search("from repro_torch.models import x")
