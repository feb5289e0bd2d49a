"""Architecture registry of the port: one module per arch, exact public
configs (counterpart of the reference's ``configs/__init__.py``).  The
attention-only architectures are listed, in the reference's order; the
recurrent and encoder-decoder ones wait for the port's SSM, RG-LRU and
encoder modules (ROADMAP Queue 1 item 11, second half)."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "qwen2_1_5b",
    "smollm_135m",
    "granite_3_8b",
    "minicpm_2b",
    "internvl2_1b",
    "granite_moe_1b_a400m",
    "qwen2_moe_a2_7b",
]

# the reference's archs that the port does not build yet
_NOT_PORTED = ("recurrentgemma_9b", "mamba2_370m", "whisper_small")

# CLI ids (dashes) → module names
_ALIASES = {i.replace("_", "-"): i
            for i in ARCH_IDS + list(_NOT_PORTED)}


def get_config(arch: str) -> ModelConfig:
    arch = _ALIASES.get(arch, arch).replace("-", "_")
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: its SSM, RG-LRU or encoder "
            "layers are ROADMAP Queue 1 item 11's second half")
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; the port has {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG
