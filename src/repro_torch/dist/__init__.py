"""repro_torch.dist — fault tolerance for long runs (DESIGN.md §12)."""

from repro_torch.dist.fault_tolerance import (SERVE_PHASES, FailureInjector,
                                              InjectedFailure,
                                              StragglerWatchdog,
                                              run_serve_with_restarts,
                                              run_with_restarts)

__all__ = ["InjectedFailure", "FailureInjector", "StragglerWatchdog",
           "run_with_restarts", "run_serve_with_restarts", "SERVE_PHASES"]
