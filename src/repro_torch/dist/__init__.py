"""repro_torch.dist — the mesh context and sharding rules of sharded
serving (DESIGN.md §9), and fault tolerance for long runs (DESIGN.md §12).

* ``ctx``             — the ambient mesh, the serve shard scope, and the
  port's two collectives: ``gather_heads`` over 'model' and the host-state
  ``gather_rows`` over 'data';
* ``sharding``        — partition rules for param / cache / batch trees;
* ``fault_tolerance`` — failure injection, straggler watchdog, restart
  loop.
"""

from repro_torch.dist import ctx, sharding
from repro_torch.dist.fault_tolerance import (SERVE_PHASES, FailureInjector,
                                              InjectedFailure,
                                              StragglerWatchdog,
                                              run_serve_with_restarts,
                                              run_with_restarts)
from repro_torch.dist.sharding import MeshShape

__all__ = ["InjectedFailure", "FailureInjector", "StragglerWatchdog",
           "run_with_restarts", "run_serve_with_restarts", "SERVE_PHASES",
           "ctx", "sharding", "MeshShape"]
