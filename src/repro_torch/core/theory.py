"""Closed-form bias/variance/EMSE expressions from the paper (§II–§IV,
Table I): the port's own copy of the reference's ``core/theory.py``.

These are the oracles the tests and ``chip_smoke.py``'s core phase hold
sample estimates against.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "emse_lower_bound",
    "emse_repr_stochastic",
    "emse_repr_deterministic",
    "var_repr_stochastic",
    "var_repr_dither_bound",
    "emse_repr_dither_bound",
    "emse_rounding_deterministic",
    "emse_rounding_stochastic",
    "TABLE_I",
]


def emse_lower_bound(n: int) -> float:
    """Thm 2.1 with uniform X: L ≥ 1/(12 N²)."""
    return 1.0 / (12.0 * n * n)


def emse_repr_stochastic(n: int) -> float:
    """§II-A, uniform X: L = ∫ x(1−x)/N dx = 1/(6N)."""
    return 1.0 / (6.0 * n)


def var_repr_stochastic(x: np.ndarray, n: int) -> np.ndarray:
    """§II-A: Var(X_s) = x(1−x)/N (pointwise)."""
    return x * (1.0 - x) / n


def emse_repr_deterministic(n: int) -> float:
    """§II-B, uniform X: L = 2N ∫_0^{1/2N} x² dx = 1/(12N²) (bias²-only)."""
    return 1.0 / (12.0 * n * n)


def var_repr_dither_bound(n: int) -> float:
    """§II-D: Var(X_s) ≤ 2/N² for either branch."""
    return 2.0 / (n * n)


def emse_repr_dither_bound(n: int) -> float:
    """§II-D: zero bias ⇒ L = E[Var] ≤ 2/N²."""
    return 2.0 / (n * n)


def emse_rounding_deterministic() -> float:
    """§II-C: 1-bit deterministic rounding of uniform x: L̃ = 1/12."""
    return 1.0 / 12.0


def emse_rounding_stochastic() -> float:
    """§II-C: 1-bit stochastic rounding of uniform x: L = ∫ x(1−x) = 1/6."""
    return 1.0 / 6.0


# Table I: (bias_order, var_order, emse_order) exponents of 1/N per scheme/op.
# exponent 0 ⇒ exactly zero (not O(1)).
TABLE_I = {
    ("stochastic", "repr"): dict(bias=None, var=1, emse=1),
    ("deterministic", "repr"): dict(bias=1, var=None, emse=2),
    ("dither", "repr"): dict(bias=None, var=2, emse=2),
    ("stochastic", "mult"): dict(bias=None, var=1, emse=1),
    ("deterministic", "mult"): dict(bias=1, var=None, emse=2),
    ("dither", "mult"): dict(bias=None, var=2, emse=2),
    ("stochastic", "avg"): dict(bias=None, var=1, emse=1),
    ("deterministic", "avg"): dict(bias=1, var=None, emse=2),
    ("dither", "avg"): dict(bias=None, var=2, emse=2),
}
