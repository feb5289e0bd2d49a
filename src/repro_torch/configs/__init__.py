"""Architecture registry of the port: one module per arch, exact public
configs (counterpart of the reference's ``configs/__init__.py``).  Only the
architectures the port serves or sizes kernels for are listed."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "qwen2_1_5b",
    "smollm_135m",
]

# CLI ids (dashes) → module names
_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    arch = _ALIASES.get(arch, arch).replace("-", "_")
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; the port has {ARCH_IDS} "
                         "(the rest of the zoo is ROADMAP Queue 1 item 11)")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG
