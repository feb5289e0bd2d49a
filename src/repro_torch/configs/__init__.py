"""Architecture registry of the port: one module per arch, exact public
configs (counterpart of the reference's ``configs/__init__.py``).  The
decoder-only architectures are listed, in the reference's order —
attention-only, MoE, the VLM stub and the recurrent SSM and RG-LRU
hybrids; the encoder-decoder waits for the port's encoder (ROADMAP
Queue 1 item 11b-ii)."""

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
]

# the reference's archs that the port does not build yet
_NOT_PORTED = ("whisper_small",)

# CLI ids (dashes) → module names
_ALIASES = {i.replace("_", "-"): i
            for i in ARCH_IDS + list(_NOT_PORTED)}


def get_config(arch: str) -> ModelConfig:
    arch = _ALIASES.get(arch, arch).replace("-", "_")
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: its encoder is ROADMAP "
            "Queue 1 item 11's second half (11b-ii)")
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; the port has {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG
