"""Arithmetic on pulse sequences (paper §III multiplication, §IV scaled
addition): the port's counterpart of the reference's ``core/ops.py``.

Multiplication of two pulse sequences is a bitwise AND (Z_i = X_i · Y_i);
scaled addition (averaging) multiplexes the two sequences with a control
sequence W_i: U_i = W_i X_i + (1−W_i) Y_i.  The three schemes differ only in
how the operand sequences / control sequence are generated:

* stochastic:   both operands iid Bernoulli; W_i iid Bernoulli(1/2).
* deterministic: x unary (Format 1), y spread (Format 2); W_i alternating.
* dither:       x dither/unary, y dither/spread with random phase T (§III-C);
                W is one of the two alternating phases chosen with prob 1/2
                (§IV-C) — W_i correlated across i, E(W_i)=1/2.

Where the reference splits a ``jax.random`` key, the port draws in turn
from one ``torch.Generator`` on the operands' device (the deterministic
scheme draws nothing and takes ``None``).  The reference's ``jax.jit``s
are plain functions here.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import representations as rep

__all__ = [
    "multiply_pulses",
    "scaled_add_pulses",
    "encode_pair_for_multiply",
    "encode_pair_for_add",
    "control_sequence",
    "multiply_estimate",
]

Gen = Optional[torch.Generator]


def multiply_pulses(x_pulses: torch.Tensor,
                    y_pulses: torch.Tensor) -> torch.Tensor:
    """Z_i = X_i · Y_i (bitwise AND for {0,1} pulses), §III."""
    return x_pulses * y_pulses


def control_sequence(gen: Gen, batch_shape: tuple, n_pulses: int,
                     scheme: str, device="cuda") -> torch.Tensor:
    """The §IV control sequence W for scaled addition, per scheme, on
    ``device``."""
    shape = tuple(batch_shape) + (n_pulses,)
    if scheme == "stochastic":
        return (torch.rand(shape, generator=gen, device=device) < 0.5).to(
            torch.float32)
    # s_i = 1 for i odd (0-based even)
    s = (torch.arange(n_pulses, device=device) % 2).to(torch.float32)
    if scheme == "deterministic":
        return torch.broadcast_to(s, shape)
    if scheme == "dither":
        # With prob 1/2 use {s_i}, else {1-s_i}: W_i correlated, E(W_i)=1/2
        # (§IV-C).
        flip = (torch.rand(tuple(batch_shape), generator=gen, device=device)
                < 0.5)[..., None].to(torch.float32)
        return flip * (1.0 - s) + (1.0 - flip) * s
    raise ValueError(f"unknown scheme {scheme!r}")


def encode_pair_for_multiply(gen: Gen, x: torch.Tensor, y: torch.Tensor,
                             n_pulses: int, scheme: str):
    """Encode operands with the §III/§VI operand-asymmetric formats."""
    if scheme == "stochastic":
        return (rep.stochastic_encode(gen, x, n_pulses),
                rep.stochastic_encode(gen, y, n_pulses))
    if scheme == "deterministic":
        return (rep.deterministic_encode(x, n_pulses, fmt="unary"),
                rep.deterministic_encode(y, n_pulses, fmt="spread"))
    if scheme == "dither":
        xp = rep.dither_encode(gen, x, n_pulses, fmt="unary")
        # the §III-C random offset T
        phase = torch.rand(tuple(y.shape), generator=gen, device=y.device)
        return xp, rep.dither_encode(gen, y, n_pulses, fmt="spread",
                                     phase=phase)
    raise ValueError(f"unknown scheme {scheme!r}")


def encode_pair_for_add(gen: Gen, x: torch.Tensor, y: torch.Tensor,
                        n_pulses: int, scheme: str):
    """Encode operands for §IV scaled addition (both Format 1)."""
    if scheme == "stochastic":
        return (rep.stochastic_encode(gen, x, n_pulses),
                rep.stochastic_encode(gen, y, n_pulses))
    if scheme == "deterministic":
        return (rep.deterministic_encode(x, n_pulses, fmt="unary"),
                rep.deterministic_encode(y, n_pulses, fmt="unary"))
    if scheme == "dither":
        return (rep.dither_encode(gen, x, n_pulses, fmt="unary"),
                rep.dither_encode(gen, y, n_pulses, fmt="unary"))
    raise ValueError(f"unknown scheme {scheme!r}")


def scaled_add_pulses(gen: Gen, x: torch.Tensor, y: torch.Tensor,
                      n_pulses: int, scheme: str) -> torch.Tensor:
    """Full §IV pipeline: encode, multiplex, decode → estimate of (x+y)/2."""
    xp, yp = encode_pair_for_add(gen, x, y, n_pulses, scheme)
    w = control_sequence(gen, tuple(x.shape), n_pulses, scheme,
                         device=x.device)
    u = w * xp + (1.0 - w) * yp
    return rep.decode(u)


def multiply_estimate(gen: Gen, x: torch.Tensor, y: torch.Tensor,
                      n_pulses: int, scheme: str) -> torch.Tensor:
    """Full §III pipeline: encode, AND, decode → estimate of x·y."""
    xp, yp = encode_pair_for_multiply(gen, x, y, n_pulses, scheme)
    return rep.decode(multiply_pulses(xp, yp))
