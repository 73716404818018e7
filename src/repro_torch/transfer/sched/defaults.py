"""Single source of truth for the transfer stack's tuning constants.

Before the sans-I/O extraction these thresholds were duplicated (and
drifting) between ``repro_torch.transfer.client`` and
the fleet manager (``repro.transfer.manager``): the endgame window showed up as a literal
``2`` in both the hedge trigger and the origin-offload pass, the
overdue bar's grace terms were copy-pasted, and the probation floor
family lived only in ``FleetModel``'s signature.  Every layer now reads
the one value defined here; ``tests/test_sched.py`` pins the wiring so
a future edit cannot re-fork them.

These are *defaults*, not policy: callers override per-instance via
``ClientOptions`` / ``FleetModel`` / ``ChunkScheduler`` arguments.
"""

from __future__ import annotations

# -- pipelining / data plane ---------------------------------------------

#: concurrent request lanes per replica connection (HTTP/1.1 pipelining).
PIPELINE_DEPTH = 2

#: CRC32 bodies at or below this size hash inline on the event loop;
#: larger bodies go to the thread-pool executor.
CRC_INLINE_MAX = 128 * 1024

#: RTT assumed for a replica with no sample yet (seconds).
DEFAULT_RTT = 0.03

#: per-replica observation-window flush threshold (seconds of streaming
#: time aggregated before one estimator reading).
OBS_WINDOW_S = 0.02

# -- endgame / hedging ---------------------------------------------------

#: the endgame window, in allocator rounds: the transfer is "in its
#: endgame" once the residual (fresh + pooled + in-flight) drops below
#: ``ENDGAME_ROUNDS * large_chunk * len(alive)``.  Shared by the hedge
#: trigger (no hedges before the endgame) and the origin-offload pass
#: (the origin rejoins peer-covered spans inside it).
ENDGAME_ROUNDS = 2

#: hedge poll period (seconds): parked lanes wake this often to look
#: for straggling ranges, and the stall clock heartbeats at this rate.
HEDGE_POLL_S = 0.05

#: the overdue bar starts at ``(pipeline_depth + OVERDUE_DEPTH_SLACK)``
#: expected service times — a pipelined range can wait ``depth`` service
#: times behind healthy siblings.
OVERDUE_DEPTH_SLACK = 1.0

#: absolute grace floor on the overdue bar and the wedge window, in
#: hedge-poll periods: at small-chunk scale expected times are
#: milliseconds and scheduler jitter alone would read as lateness.
OVERDUE_GRACE_POLLS = 4.0

#: per-byte latency quantile across the live fleet above which an owner
#: counts as slow (the manager's default; bare clients default to 0 =
#: hedging off).
HEDGE_QUANTILE = 0.95

#: speculative duplicate budget as a fraction of the transfer size.
HEDGE_WASTE_FRAC = 0.05

# -- fleet probation (FleetModel) ----------------------------------------

#: health at or below this trips probation review.
PROBATION_HEALTH = 0.3

#: connection-retry count that counts as a probation strike.
PROBATION_RETRY_LIMIT = 3

#: a replica observed below this fraction of its fair share is "slow".
PROBATION_SLOW_FRAC = 0.125

#: consecutive slow/faulty observations before probation trips.
PROBATION_STRIKES = 3

#: clean probes required before a probated replica is readmitted.
PROBATION_CLEAN_STREAK = 3

#: allocation share floor while on probation — probated replicas keep
#: receiving a trickle so recovery is observable (interplays with the
#: hedged endgame: the trickle is what a hedge can duplicate around).
PROBATION_FLOOR = 0.02

#: readmission slow-start: trust multiplier right after probation lifts.
READMIT_INIT = 0.1
