"""Architecture registry of the port: one module per arch, exact public
configs (counterpart of the reference's ``configs/__init__.py``), all ten
of the reference's in its order — attention-only, MoE, the VLM stub, the
recurrent SSM and RG-LRU hybrids and the encoder-decoder."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "qwen2_1_5b",
    "smollm_135m",
    "granite_3_8b",
    "minicpm_2b",
    "recurrentgemma_9b",
    "internvl2_1b",
    "granite_moe_1b_a400m",
    "qwen2_moe_a2_7b",
    "mamba2_370m",
    "whisper_small",
]

# CLI ids (dashes) → module names
_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    arch = _ALIASES.get(arch, arch).replace("-", "_")
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; the port has {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}
