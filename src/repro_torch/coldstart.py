"""Observers of the port's cold-start stalls.

A kernel library built by ``nvcc`` (``kernels/_build.py``) and a decode
window's CUDA-graph capture (``serve/graphs.py``) stall the first requests
that need them.  Each calls :func:`notify` with its kind (``kernel_build``,
``graph_capture``) and its fields, seconds included; every registered
observer (held weakly, so a dropped one unregisters itself — an enabled
``Tracer``) gets ``coldstart_event(kind, **fields)``.
"""

from __future__ import annotations

import weakref

__all__ = ["register_observer", "notify"]

_OBSERVERS: "weakref.WeakSet" = weakref.WeakSet()


def register_observer(obs) -> None:
    """Register ``obs`` (held weakly) for the port's cold-start events."""
    _OBSERVERS.add(obs)


def notify(kind: str, **fields) -> None:
    """Hand one cold-start event to every registered observer."""
    for obs in list(_OBSERVERS):
        obs.coldstart_event(kind, **fields)
