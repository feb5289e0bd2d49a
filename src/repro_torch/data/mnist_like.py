"""Synthetic MNIST / Fashion-MNIST stand-ins (paper §VII–§VIII experiments):
the port's own copy of the reference's ``data/mnist_like.py``, in numpy,
so both packages draw the same images from a seed.

The real datasets are not bundled, so this generates a deterministic
10-class image problem with the same tensor interface: 28×28 grayscale
in [0, 1].  Each class has a smooth random template;
samples are template + pixel noise, clipped to [0, 1].  This preserves
everything the paper's rounding experiments measure (relative accuracy of
deterministic vs stochastic vs dither rounding at k bits, variance across
trials) while being reproducible.  DESIGN.md §7 records the substitution.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_dataset", "IMG", "N_CLASSES"]

IMG = 28 * 28
N_CLASSES = 10


def _templates(rng: np.random.RandomState, sharp: float) -> np.ndarray:
    """Smooth per-class templates: low-frequency random fields in [0,1]."""
    t = []
    xs, ys = np.meshgrid(np.linspace(0, 1, 28), np.linspace(0, 1, 28))
    for _ in range(N_CLASSES):
        field = np.zeros((28, 28))
        for _ in range(6):
            fx, fy = rng.uniform(1, 4, 2)
            px, py = rng.uniform(0, 2 * np.pi, 2)
            field += rng.uniform(0.3, 1.0) * np.sin(2 * np.pi * fx * xs + px) * np.sin(
                2 * np.pi * fy * ys + py)
        field = (field - field.min()) / (np.ptp(field) + 1e-9)
        t.append(field.reshape(-1) * sharp)
    return np.stack(t)


def make_dataset(n_train: int = 6000, n_test: int = 1000, seed: int = 0,
                 noise: float = 0.15, sharp: float = 0.9, hard: bool = False):
    """→ (x_train, y_train, x_test, y_test); x in [0,1]^(N,784), y int in [0,10).

    ``hard=True`` lowers template separation (Fashion-MNIST-like difficulty).
    """
    rng = np.random.RandomState(seed)
    temps = _templates(rng, sharp * (0.6 if hard else 1.0))

    def sample(n, rs):
        y = rs.randint(0, N_CLASSES, n)
        x = temps[y] + rs.normal(0, noise * (1.5 if hard else 1.0), (n, IMG))
        return np.clip(x, 0.0, 1.0).astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = sample(n_train, np.random.RandomState(seed + 1))
    x_te, y_te = sample(n_test, np.random.RandomState(seed + 2))
    return x_tr, y_tr, x_te, y_te
