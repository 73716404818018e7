"""Sans-I/O chunk scheduling: MDTP's allocator as a pure state machine.

``repro_torch.transfer.sched`` holds the transfer stack's decision code with
no transport attached — no sockets, no event loop, no JAX (the layering
gate ``tools/layercheck.py`` enforces this transitively).  The real
socket client (``repro_torch.transfer.client``), the fleet manager, the
sharded-restore planner, simulators, and tests all drive the same
:class:`ChunkScheduler` through explicit events; :mod:`.defaults` is
the single source of truth for the tuning constants the layers used to
duplicate.
"""

from . import defaults
from .core import (
    Assignment,
    ChunkScheduler,
    CommitResult,
    CorruptResult,
    HedgeResult,
    ReclaimResult,
    cov_contains,
    cov_first_in,
    cov_first_out,
    cov_run_at,
    replay,
)

__all__ = [
    "Assignment", "ChunkScheduler", "CommitResult", "CorruptResult",
    "HedgeResult", "ReclaimResult", "cov_contains", "cov_first_in",
    "cov_first_out", "cov_run_at", "defaults", "replay",
]
