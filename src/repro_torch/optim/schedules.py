"""LR schedules: cosine and WSD (warmup-stable-decay, MiniCPM
arXiv:2404.06395), the port's counterpart of the reference's
``optim/schedules.py``.  Each takes the step as an integer tensor and
returns the rate as a float32 tensor on its device, with the reference's
f32 ops in its order (divisions by tensors: a CUDA tensor divided by a
Python number is a multiplication by its reciprocal)."""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule", "wsd_schedule", "linear_warmup"]


def _div(a: torch.Tensor, d) -> torch.Tensor:
    return a / torch.full((), float(d), dtype=torch.float32, device=a.device)


def linear_warmup(step: torch.Tensor, warmup: int, peak: float):
    return peak * torch.clamp_max(_div(step.to(torch.float32),
                                       max(warmup, 1)), 1.0)


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.1):
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = _div(s, max(warmup, 1))
        prog = torch.clamp(_div(s - warmup, max(total - warmup, 1)), 0.0, 1.0)
        cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return peak * torch.where(s < warmup, warm, cos)
    return lr


def wsd_schedule(peak: float, warmup: int, stable: int, decay: int,
                 floor: float = 0.01):
    """Warmup-Stable-Decay: linear warmup → constant plateau → exp-ish decay.

    MiniCPM's schedule; the decay phase uses the paper's exponential form
    f(s) = floor^(s/decay)."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = _div(s, max(warmup, 1))
        in_decay = s > (warmup + stable)
        d = torch.clamp(_div(s - warmup - stable, max(decay, 1)), 0.0, 1.0)
        dec = torch.pow(torch.full((), floor, dtype=torch.float32,
                                   device=s.device), d)
        val = torch.where(s < warmup, warm, torch.where(in_decay, dec, 1.0))
        return peak * val
    return lr
