"""Fleet-level multi-transfer scheduling (``TransferManager``).

The rest of the transfer stack moves ONE blob at a time: an
``MDTPClient`` owns its replicas, sizes chunks from its own throughput
estimators, and tunes (C, L) as if it were alone on the fleet.  A
production transfer service (the regime Globus-style managed transfer
operates in — see PAPERS.md) is the opposite: many concurrent transfers
contend for the same mirrors, and a client that plans against the *full*
fleet bandwidth over-asks the shared paths, queues behind its peers, and
re-learns the same conditions its neighbors just measured.

``TransferManager`` closes that gap with three mechanisms:

1. **A shared fleet model** (:class:`FleetModel`): per-replica
   exponentially-decayed capacity and RTT, aggregated across every active
   transfer's per-chunk observations (each sample RTT-bias-corrected via
   :func:`repro_torch.core.throughput.rtt_corrected_bandwidth`).  One
   transfer's measurements warm every other transfer's planning.

2. **Residual-capacity bin packing**: the MDTP allocator (paper §IV) packs
   each round into per-server capacity bins.  Managed clients override
   :meth:`MDTPClient._allocation_throughputs` so the bin sizes are the
   *residual* capacity — fleet bandwidth minus what the OTHER active
   transfers are currently consuming, floored at a fair share so nobody
   is starved — plus **per-replica in-flight caps** (an asyncio semaphore
   per mirror) so K transfers cannot stack K deep request queues on the
   fastest path.

3. **Cross-transfer tuner persistence**: the manager owns one online
   tuner (``repro_torch.core.online`` contract) and one adopted ``ChunkParams``;
   every transfer feeds the same tuner (through a thread-safe,
   residual-aware proxy) and the geometry a transfer adopts warm-starts
   the next one — a ``BanditTuner``'s arms / reward statistics and an
   ``MCGradTuner``'s iterate survive across transfers instead of being
   re-learned from scratch (the ROADMAP PR-3 follow-on).

4. **Replica probation** (:class:`FleetModel`): a mirror that trips a
   corruption, retry, or gray-slowness threshold stops anchoring large
   chunks — its allocation weight is pinned at a probe floor so the
   packer keeps sending it single min-sized chunks, and a mirror that
   proves itself clean again re-enters through multiplicative slow-start
   instead of instantly reclaiming full share (no fast/dead oscillation,
   the paper's "bandwidth decrease to the fastest server" case).

5. **Admission control** (:class:`_AdmissionGate` + :class:`_ByteBudget`):
   a max-active-transfers gate with an SRPT (smallest-residual-first,
   starvation-aged) wait queue, a per-fleet in-flight byte budget, and a
   shed mode that serves flash-crowd overflow a bounded trickle instead
   of queueing it into timeout.

The manager imports no torch at import time (like the rest of
``repro_torch.transfer``); tuners and the contention planner import the
geometry engines lazily.

This is the port's own copy of ``repro.transfer.manager``.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import itertools
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

from repro_torch.core.chunking import ChunkParams
from repro_torch.core.throughput import rtt_corrected_bandwidth

from .client import DEFAULT_PIPELINE_DEPTH, MDTPClient, Replica, _Conn
from .sched import defaults as sched_defaults

__all__ = ["FleetModel", "TransferJob", "TransferManager"]


@dataclass
class _ReplicaState:
    """Fleet model entry for one mirror (keyed by ``host:port``)."""

    #: EWMA of the replica's TOTAL observed concurrent throughput
    #: (bytes/s, summed across active transfers) — the capacity bin.
    capacity: float = 0.0
    #: EWMA of measured request RTT (s); 0 = no sample yet.
    rtt: float = 0.0
    #: per-transfer EWMA delivery rate (bytes/s), RTT-bias corrected.
    rates: dict = field(default_factory=dict)
    #: completed chunks observed (diagnostics).
    chunks: int = 0
    #: checksum-mismatched ranges served by this mirror (all transfers).
    corruptions: int = 0
    #: multiplicative trust factor in (0, 1]: decays on every corruption,
    #: recovers slowly on clean chunks.  Scales the allocation view, so a
    #: chronically corrupt replica is deprioritized exactly like a slow
    #: one — it still gets probing-sized requests (re-fetch overhead is
    #: bounded) but stops anchoring large chunks.
    health: float = 1.0
    #: connection-level retries charged since the last probation reset.
    retries: int = 0
    #: probation: the mirror tripped a corruption/retry/slowness
    #: threshold; its allocation weight is pinned at the probe floor
    #: until it serves a clean streak at restored health.
    probation: bool = False
    #: times this mirror has been placed on probation (witness).
    probations: int = 0
    #: consecutive clean chunks since the last bad event.
    clean_streak: int = 0
    #: consecutive chunks served far below the best trusted peer — the
    #: fast path onto probation for a gray (silently degraded) mirror:
    #: per-chunk rates betray the degradation many EWMA steps before the
    #: capacity estimate converges down to it.
    slow_strikes: int = 0
    #: slow-start readmission factor in (0, 1]: starts small when a
    #: mirror leaves probation and doubles per clean chunk, so a
    #: recovered mirror ramps back instead of instantly reclaiming (and
    #: possibly re-losing) its full allocation share.
    readmit: float = 1.0


class FleetModel:
    """Shared per-replica capacity/telemetry model.

    Thread-safe: observations arrive on the event loop, while tuner
    proxies read from thread-pool executor workers.  All state is keyed
    by replica NAME (``host:port``) so the same mirror serving different
    blob paths (a manifest and its data.bin, two different checkpoints)
    aggregates into one capacity estimate.
    """

    def __init__(self, max_inflight_per_replica: int = 2,
                 alpha: float = 0.3, rtt_alpha: float = 0.3,
                 probation: bool = True,
                 probation_health: float = sched_defaults.PROBATION_HEALTH,
                 probation_retry_limit: int =
                 sched_defaults.PROBATION_RETRY_LIMIT,
                 probation_slow_frac: float =
                 sched_defaults.PROBATION_SLOW_FRAC,
                 probation_strikes: int = sched_defaults.PROBATION_STRIKES,
                 probation_clean_streak: int =
                 sched_defaults.PROBATION_CLEAN_STREAK,
                 probation_floor: float = sched_defaults.PROBATION_FLOOR,
                 readmit_init: float = sched_defaults.READMIT_INIT):
        if max_inflight_per_replica < 1:
            raise ValueError("max_inflight_per_replica must be >= 1")
        self.max_inflight_per_replica = max_inflight_per_replica
        self.alpha = alpha
        self.rtt_alpha = rtt_alpha
        #: probation knobs (see :class:`_ReplicaState`): trip when trust
        #: decays below ``probation_health``, when ``probation_retry_limit``
        #: connection retries accumulate, or when the mirror serves
        #: ``probation_slow_frac``x slower than the best trusted peer;
        #: readmit after ``probation_clean_streak`` clean chunks at
        #: restored health, ramping back via slow-start from
        #: ``readmit_init``.
        self.probation_enabled = probation
        self.probation_health = probation_health
        self.probation_retry_limit = probation_retry_limit
        self.probation_slow_frac = probation_slow_frac
        self.probation_strikes = probation_strikes
        self.probation_clean_streak = probation_clean_streak
        self.probation_floor = probation_floor
        self.readmit_init = readmit_init
        self._lock = threading.Lock()
        self._reps: dict[str, _ReplicaState] = {}
        self._active: set = set()
        # per-(event-loop, replica) request slots: semaphores bind to the
        # loop they first wait on, and a manager may serve several
        # sequential asyncio.run() loops (one per restore).  Keyed on the
        # LIVE loop object (weakly, so dead loops drop their slots) — an
        # id()-based key could hand a recycled loop a semaphore bound to
        # its dead predecessor.
        self._slots: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    # -- registration ------------------------------------------------------

    def register(self, tid) -> None:
        with self._lock:
            self._active.add(tid)

    def forget(self, tid) -> None:
        """Drop a finished transfer: its consumption leaves the residual
        immediately (capacity memory is kept — the EWMA remembers what
        the mirror could serve while it was contended)."""
        with self._lock:
            self._active.discard(tid)
            for st in self._reps.values():
                st.rates.pop(tid, None)

    @property
    def active_transfers(self) -> int:
        with self._lock:
            return len(self._active)

    # -- request slots (per-replica in-flight caps) ------------------------

    def slot(self, name: str) -> asyncio.Semaphore:
        """The request slot for one mirror on the CURRENT event loop.

        The cap is global across every transfer sharing a loop (the
        ``TransferManager.run`` batch path).  Workloads driven from
        separate threads each run their own loop and therefore their own
        semaphore — the capacity/residual model is still shared, but the
        in-flight cap is per loop, not per process.
        """
        loop = asyncio.get_running_loop()
        with self._lock:
            per_loop = self._slots.get(loop)
            if per_loop is None:
                per_loop = self._slots[loop] = {}
            sem = per_loop.get(name)
            if sem is None:
                sem = per_loop[name] = asyncio.Semaphore(
                    self.max_inflight_per_replica)
            return sem

    # -- observations ------------------------------------------------------

    def observe_chunk(self, tid, name: str, nbytes: int,
                      elapsed: float, rtt_included: bool = True) -> None:
        """Fold one completed range request into the model.  A serial
        (idle-pipe) reading spans the request round trip, so the fleet's
        RTT estimate inverts the bias; a pipelined reading already
        measures pure body-streaming time (``rtt_included=False``) and
        enters as-is — double-correcting it would overstate capacity."""
        if elapsed <= 0.0 or nbytes <= 0:
            return
        with self._lock:
            st = self._reps.setdefault(name, _ReplicaState())
            rate = nbytes / elapsed
            if rtt_included:
                rate = rtt_corrected_bandwidth(rate, st.rtt, float(nbytes))
            prev = st.rates.get(tid)
            st.rates[tid] = (rate if prev is None
                             else self.alpha * rate
                             + (1.0 - self.alpha) * prev)
            total = sum(st.rates.values())
            st.capacity = (total if st.capacity <= 0.0
                           else self.alpha * total
                           + (1.0 - self.alpha) * st.capacity)
            st.chunks += 1
            # clean evidence slowly rebuilds trust (asymmetric on purpose:
            # one corruption costs more than one clean chunk repays)
            st.health += 0.05 * (1.0 - st.health)
            if not self.probation_enabled:
                return
            # per-chunk slowness strike: this very chunk was served far
            # below the best trusted peer's capacity — the instantaneous
            # signal a gray mirror gives off while its capacity EWMA is
            # still coasting on its healthy past
            best = self._best_trusted(name)
            struck = (best > 0.0 and st.chunks >= 4
                      and rate < self.probation_slow_frac * best)
            st.slow_strikes = st.slow_strikes + 1 if struck else 0
            if st.probation:
                st.clean_streak += 1
                if (st.clean_streak >= self.probation_clean_streak
                        and st.health >= self.probation_health
                        and not struck
                        and not self._slow_vs_fleet(name, st)):
                    # readmit via multiplicative slow-start: the mirror
                    # re-enters at a fraction of its fair share and earns
                    # the rest back one clean chunk at a time.  A mirror
                    # whose probe chunks still crawl stays parked — clean
                    # is necessary but not sufficient.
                    st.probation = False
                    st.clean_streak = 0
                    st.retries = 0
                    st.readmit = self.readmit_init
            else:
                if st.readmit < 1.0:
                    st.readmit = min(1.0, st.readmit * 2.0)
                if (st.slow_strikes >= self.probation_strikes
                        or self._slow_vs_fleet(name, st)):
                    self._trip(st)

    def _trip(self, st: _ReplicaState) -> None:
        """Place one mirror on probation (caller holds the lock)."""
        st.probation = True
        st.probations += 1
        st.clean_streak = 0
        st.slow_strikes = 0
        st.retries = 0

    def _best_trusted(self, name: str) -> float:
        """Best capacity among the OTHER non-probation mirrors (caller
        holds the lock); 0 when there is no trusted peer — a
        single-replica fleet can never be slow relative to itself."""
        return max((o.capacity for nm, o in self._reps.items()
                    if nm != name and not o.probation), default=0.0)

    def _slow_vs_fleet(self, name: str, st: _ReplicaState) -> bool:
        """Gray-slowness trigger: the mirror has enough samples and is
        serving ``probation_slow_frac``x slower than the best trusted
        peer (caller holds the lock).  Single-replica fleets never trip
        — there is nothing faster to shift allocation toward."""
        if st.chunks < 4 or st.capacity <= 0.0:
            return False
        best = self._best_trusted(name)
        return best > 0.0 and st.capacity < self.probation_slow_frac * best

    def observe_corruption(self, name: str) -> None:
        """One checksum-mismatched range from this mirror: count it and
        decay the mirror's trust factor (floored so it can recover)."""
        with self._lock:
            st = self._reps.setdefault(name, _ReplicaState())
            st.corruptions += 1
            st.health = max(st.health * 0.7, 0.05)
            if self.probation_enabled:
                st.clean_streak = 0
                if not st.probation and st.health < self.probation_health:
                    self._trip(st)

    def observe_retry(self, name: str) -> None:
        """One connection-level retry (reconnect after failure) against
        this mirror: enough of them in a row trips probation even when no
        chunk ever completes (the silently-blackholed mirror case)."""
        with self._lock:
            st = self._reps.setdefault(name, _ReplicaState())
            st.retries += 1
            if self.probation_enabled:
                st.clean_streak = 0
                if (not st.probation
                        and st.retries >= self.probation_retry_limit):
                    self._trip(st)

    @property
    def probations(self) -> int:
        """Total probation trips across the fleet (witness)."""
        with self._lock:
            return sum(st.probations for st in self._reps.values())

    def observe_rtt(self, name: str, sample: float) -> None:
        if sample <= 0.0:
            return
        with self._lock:
            st = self._reps.setdefault(name, _ReplicaState())
            st.rtt = (sample if st.rtt <= 0.0
                      else self.rtt_alpha * sample
                      + (1.0 - self.rtt_alpha) * st.rtt)

    # -- views -------------------------------------------------------------

    def allocation_view(self, tid, replicas: Sequence[Replica],
                        est_values: Sequence[float]) -> list:
        """The throughput vector transfer ``tid``'s allocator should pack
        against: per replica, the residual capacity (fleet capacity minus
        other active transfers' consumption), floored at a fair-share
        fraction so a late arrival is never starved out of the bin.
        Falls back to the transfer's own estimate where the fleet has no
        capacity observation, and keeps unprobed replicas at ``<= 0`` so
        the client still issues its uniform probing chunk.

        A mirror on probation is pinned at the probe floor — a tiny
        positive weight, so the packer keeps sending it single min-sized
        chunks (periodic probes) without anchoring real work on it; a
        readmitted mirror's weight is additionally scaled by its
        slow-start ``readmit`` factor.
        """
        with self._lock:
            n_active = max(len(self._active), 1)
            out = []
            for i, r in enumerate(replicas):
                own = float(est_values[i])
                st = self._reps.get(r.name)
                if st is not None and st.probation:
                    ref = st.capacity if st.capacity > 0.0 else own
                    if ref > 0.0:
                        out.append(ref * self.probation_floor)
                    else:
                        out.append(own)
                    continue
                trust = 1.0 if st is None else st.health * st.readmit
                if own <= 0.0 or st is None or st.capacity <= 0.0:
                    out.append(own if st is None else own * trust)
                    continue
                foreign = sum(v for u, v in st.rates.items() if u != tid)
                floor = st.capacity / (2.0 * n_active)
                out.append(max(st.capacity - foreign, floor) * trust)
            return out

    def fleet_telemetry(self, tid, replicas: Sequence[Replica], telemetry):
        """Rewrite a client-local ``Telemetry`` snapshot into the fleet
        view a SHARED tuner should plan from: bandwidth = residual
        capacity for this transfer (what it can actually get), RTT = the
        fleet's aggregated estimate.  Slots the fleet knows nothing about
        keep the client's local reading.  Pure ``dataclasses.replace`` —
        no torch import on this path."""
        bw = self.allocation_view(tid, replicas, telemetry.bandwidth)
        with self._lock:
            rtt = []
            for i, r in enumerate(replicas):
                st = self._reps.get(r.name)
                rtt.append(st.rtt if st is not None and st.rtt > 0.0
                           else float(telemetry.rtt[i]))
        return dataclasses.replace(
            telemetry, bandwidth=tuple(bw), rtt=tuple(rtt))

    def snapshot(self) -> dict:
        """Diagnostic copy: ``{name: {capacity, rtt, rates, chunks}}``."""
        with self._lock:
            return {
                name: {
                    "capacity": st.capacity,
                    "rtt": st.rtt,
                    "rates": dict(st.rates),
                    "chunks": st.chunks,
                    "corruptions": st.corruptions,
                    "health": st.health,
                    "retries": st.retries,
                    "probation": st.probation,
                    "probations": st.probations,
                    "readmit": st.readmit,
                }
                for name, st in self._reps.items()
            }


class _AdmissionGate:
    """Per-event-loop admission state for one manager.

    A ``max_active`` gate with an SRPT wait queue: when a slot frees,
    the waiter with the smallest aged residual wins —
    ``size - aging_bytes_per_s * wait`` — smallest-remaining-first for
    mean response time, with wall-clock aging so a large transfer cannot
    starve behind an endless stream of small ones.  Arrivals past
    ``shed_queue_depth`` are shed into degraded (trickle) service
    instead of queueing toward timeout; shed transfers are promoted to
    full service (SRPT order again) when a slot frees with no queue
    left.
    """

    def __init__(self, max_active: Optional[int],
                 aging_bytes_per_s: float,
                 shed_queue_depth: Optional[int]):
        self.max_active = max_active
        self.aging = float(aging_bytes_per_s)
        self.shed_depth = shed_queue_depth
        self.active = 0
        #: SRPT wait queue entries: ``[size, enqueued_at, Event]``.
        self.waiting: list = []
        #: shed transfers currently in trickle service: tid -> (size, t).
        self.degraded: dict = {}
        #: tids currently holding a full-service slot.
        self.full: set = set()

    def _aged(self, size, since, now) -> float:
        return float(size) - self.aging * (now - since)

    async def acquire(self, size: int):
        """Admit one transfer.  Returns ``(mode, waited_seconds)`` where
        mode is ``"full"`` (slot held) or ``"shed"`` (trickle service,
        no slot)."""
        if self.max_active is None or self.active < self.max_active:
            self.active += 1
            return "full", 0.0
        if (self.shed_depth is not None
                and len(self.waiting) >= self.shed_depth):
            return "shed", 0.0
        entry = [int(size), time.monotonic(), asyncio.Event()]
        self.waiting.append(entry)
        try:
            await entry[2].wait()
        except asyncio.CancelledError:
            if entry in self.waiting:
                self.waiting.remove(entry)
            else:
                # the slot was handed to us between grant and resume —
                # pass it along instead of leaking it
                self._release_slot()
            raise
        return "full", time.monotonic() - entry[1]

    def bind(self, tid, mode: str, size: int) -> None:
        """Associate the admitted transfer's tid with its service mode
        (tids are assigned by the session after admission)."""
        if mode == "full":
            self.full.add(tid)
        else:
            self.degraded[tid] = (int(size), time.monotonic())

    def is_degraded(self, tid) -> bool:
        return tid in self.degraded

    def finish(self, tid):
        """Transfer done: free its slot (promoting the best waiter, else
        the best shed transfer) or drop its degraded registration.
        Returns the tid promoted from shed to full service, if any."""
        if tid in self.full:
            self.full.discard(tid)
            return self._release_slot()
        self.degraded.pop(tid, None)
        return None

    def _release_slot(self):
        now = time.monotonic()
        if self.waiting:
            best = min(self.waiting,
                       key=lambda e: self._aged(e[0], e[1], now))
            self.waiting.remove(best)
            best[2].set()  # slot hands off; active count unchanged
            return None
        if self.degraded:
            tid = min(self.degraded.items(),
                      key=lambda kv: self._aged(kv[1][0], kv[1][1], now))[0]
            del self.degraded[tid]
            self.full.add(tid)  # promoted in place; active unchanged
            return tid
        self.active -= 1
        return None


class _ByteBudget:
    """Per-event-loop cap on total in-flight request bytes across every
    managed transfer — the fleet's bandwidth-delay budget.  Each range
    request holds its length in credits for its wire lifetime; requests
    larger than the whole budget are clamped so they can still proceed
    (serially).  Grants are FIFO, so one huge request cannot be starved
    by a stream of small ones slipping past it."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self.available = int(capacity)
        self._waiters: collections.deque = collections.deque()

    async def acquire(self, n: int) -> int:
        n = min(int(n), self.capacity)
        if self.available >= n and not self._waiters:
            self.available -= n
            return n
        fut = asyncio.get_running_loop().create_future()
        self._waiters.append((n, fut))
        try:
            await fut
        except asyncio.CancelledError:
            if fut.done() and not fut.cancelled():
                # credit was granted but the task is bailing: hand it back
                self.available += n
                self._grant()
            else:
                with contextlib.suppress(ValueError):
                    self._waiters.remove((n, fut))
            raise
        return n

    def release(self, n: int) -> None:
        self.available += int(n)
        self._grant()

    def _grant(self) -> None:
        while self._waiters and self._waiters[0][0] <= self.available:
            need, fut = self._waiters.popleft()
            if fut.done():
                continue
            self.available -= need
            fut.set_result(None)


class _ManagedConn(_Conn):
    """A client connection that (a) respects the fleet's per-replica
    in-flight cap and the manager's in-flight byte budget, (b) paces
    shed (degraded-admission) transfers to the trickle rate, and
    (c) feeds every completed range request into the shared fleet
    model."""

    def __init__(self, replica: Replica, fleet: FleetModel, tid,
                 manager: Optional["TransferManager"] = None, **conn_kw):
        super().__init__(replica, **conn_kw)
        self._fleet = fleet
        self._tid = tid
        self._mgr = manager

    async def fetch_range(self, start: int, end: int, into=None,
                          progress=None):
        length = end - start + 1
        budget = None
        if self._mgr is not None:
            pace = self._mgr._shed_pace(self._tid, length)
            if pace > 0.0:
                await asyncio.sleep(pace)
            budget = self._mgr._byte_budget()
        held = 0
        if budget is not None:
            held = await budget.acquire(length)
        try:
            # the slot is held for the request's whole pipelined lifetime
            # (send → queued behind predecessors → body), so the cap bounds
            # wire-level outstanding requests per mirror across transfers
            async with self._fleet.slot(self.replica.name):
                reply = await super().fetch_range(start, end, into=into,
                                                  progress=progress)
                # wire bytes, not decoded: the fleet model's bandwidth
                # estimates must not credit the codec's savings as wire
                # capacity on compressed paths
                self._fleet.observe_chunk(self._tid, self.replica.name,
                                          reply.wire_bytes, reply.elapsed,
                                          rtt_included=reply.rtt_included)
                # peek (don't drain — the owning client min-aggregates
                # these into its own report) at the freshest RTT samples
                if self._rtt_samples:
                    self._fleet.observe_rtt(self.replica.name,
                                            min(self._rtt_samples))
                return reply
        finally:
            if budget is not None:
                budget.release(held)


class _SharedTuner:
    """Per-transfer proxy in front of the manager's single tuner.

    Serializes ``update`` calls across transfers (they run on executor
    threads) and substitutes the fleet's residual view for the client's
    local estimator snapshot, so a ``BanditTuner``'s drift detector and
    an ``MCGradTuner``'s descent both plan against what THIS transfer can
    actually get from the shared mirrors.
    """

    def __init__(self, manager: "TransferManager", tid,
                 replicas: Sequence[Replica]):
        self._manager = manager
        self._tid = tid
        self._replicas = list(replicas)

    def update(self, telemetry):
        fleet_tel = self._manager.fleet.fleet_telemetry(
            self._tid, self._replicas, telemetry)
        with self._manager._tuner_lock:
            return self._manager.tuner.update(fleet_tel)


class _ManagedClient(MDTPClient):
    """An ``MDTPClient`` wired into a manager's fleet model."""

    def __init__(self, replicas: Sequence[Replica],
                 manager: "TransferManager", tid, **kw):
        super().__init__(replicas, **kw)
        self._manager = manager
        self._tid = tid

    def _make_conn(self, replica: Replica) -> _Conn:
        return _ManagedConn(replica, self._manager.fleet, self._tid,
                            manager=self._manager,
                            request_latency=self.request_latency,
                            read_timeout=self.read_timeout)

    def _allocation_throughputs(self, est_values: list) -> list:
        return self._manager.fleet.allocation_view(
            self._tid, self.replicas, est_values)

    def _on_corruption(self, name: str) -> None:
        self._manager.fleet.observe_corruption(name)

    def _on_retry(self, name: str) -> None:
        self._manager.fleet.observe_retry(name)


@dataclass
class TransferJob:
    """One transfer in a :meth:`TransferManager.run` batch."""

    size: int
    #: blob path on every mirror (None = the fleet replicas' own paths).
    path: Optional[str] = None
    offset: int = 0
    #: seconds after batch start before this transfer begins (staggered
    #: arrivals).
    start_delay: float = 0.0
    #: destination (``repro_torch.transfer.Sink`` or legacy callable); None =
    #: assemble in memory.
    sink: Optional[Any] = None
    tune_interval_bytes: Optional[int] = None
    #: frontier rotation hint ``(k, n)`` — see ``MDTPClient.fetch``.
    stripe: Optional[tuple] = None


class TransferManager:
    """Run N concurrent MDTP transfers against one shared replica fleet.

    Args:
      replicas: the fleet — every transfer draws from these mirrors
        (per-transfer ``path``/``replicas`` overrides re-point the blob,
        not the fleet: the capacity model is keyed by ``host:port``).
      params: initial chunk geometry; whatever a transfer adopts (via its
        tuner or ``retune``) replaces it, warm-starting the next transfer.
      tuner: a shared online tuner (``repro_torch.core.online`` policy).  State
        persists across transfers — bandit arms keep their discounted
        rewards, the MC-gradient tuner keeps its iterate.
      max_inflight_per_replica: per-mirror cap on simultaneously
        outstanding range requests ACROSS all transfers.
      contention_ladder: optional ``{active_count: ChunkParams}`` map
        (see :meth:`plan_contention`) consulted at transfer start, so a
        transfer that arrives while k others run starts from geometry
        tuned for a (k+1)-way split instead of the solo optimum.
      max_active_transfers: admission gate — at most this many transfers
        run at full service per event loop; the rest wait in an SRPT
        (smallest-residual-first, starvation-aged) queue.  ``None``
        disables admission control.
      max_inflight_bytes: per-fleet budget on total in-flight request
        bytes across every transfer on a loop.  ``None`` = unbounded.
      shed_queue_depth: arrivals finding this many transfers already
        queued are shed into degraded (trickle) service instead of
        waiting — bounded progress instead of a timeout.  ``None``
        disables shedding (everyone queues).
      shed_trickle_bytes_per_s: pacing rate for shed transfers.
      aging_bytes_per_s: SRPT starvation aging — each second in the
        queue shrinks a waiter's effective residual by this much.
      probation: enable replica probation in the fleet model (default
        on; see :class:`FleetModel`).
      hedge_quantile: endgame hedging quantile handed to every managed
        client (default 0.95 = the paper-motivated p95 straggler cut;
        0 disables hedging).  An explicit ``hedge_quantile`` in
        ``client_kw`` wins.
    """

    def __init__(
        self,
        replicas: Sequence[Replica],
        params: Optional[ChunkParams] = None,
        tuner=None,
        max_inflight_per_replica: int = 2,
        estimator: str = "ewma",
        ewma_alpha: float = 0.5,
        fleet_alpha: float = 0.3,
        contention_ladder: Optional[dict] = None,
        max_active_transfers: Optional[int] = None,
        max_inflight_bytes: Optional[int] = None,
        shed_queue_depth: Optional[int] = None,
        shed_trickle_bytes_per_s: float = 4.0 * 1024 * 1024,
        aging_bytes_per_s: float = 16.0 * 1024 * 1024,
        probation: bool = True,
        hedge_quantile: float = sched_defaults.HEDGE_QUANTILE,
        **client_kw,
    ):
        self.replicas = list(replicas)
        self.params = params
        self.tuner = tuner
        self.contention_ladder = dict(contention_ladder or {})
        self.fleet = FleetModel(
            max_inflight_per_replica=max_inflight_per_replica,
            alpha=fleet_alpha, probation=probation)
        self._estimator = estimator
        self._ewma_alpha = ewma_alpha
        self._client_kw = dict(client_kw)
        self._client_kw.setdefault("hedge_quantile", hedge_quantile)
        self.max_active_transfers = max_active_transfers
        self.max_inflight_bytes = max_inflight_bytes
        self.shed_queue_depth = shed_queue_depth
        self.shed_trickle_bytes_per_s = float(shed_trickle_bytes_per_s)
        self.aging_bytes_per_s = float(aging_bytes_per_s)
        # per-event-loop admission/budget state (same weak-keying
        # rationale as FleetModel._slots)
        self._gates: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._budgets: "weakref.WeakKeyDictionary" = (
            weakref.WeakKeyDictionary())
        #: admission witnesses, cumulative across loops: transfers
        #: admitted / queued (with total queue seconds) / shed to
        #: trickle service / promoted from shed to full service.
        self.admission = {"admitted": 0, "queued": 0, "wait_seconds": 0.0,
                          "shed": 0, "promoted": 0}
        self._tuner_lock = threading.Lock()
        self._tids = itertools.count(1)
        #: reports of completed transfers, in completion order.
        self.reports: list = []

    # -- admission ---------------------------------------------------------

    def _gate(self) -> _AdmissionGate:
        loop = asyncio.get_running_loop()
        gate = self._gates.get(loop)
        if gate is None:
            gate = self._gates[loop] = _AdmissionGate(
                self.max_active_transfers, self.aging_bytes_per_s,
                self.shed_queue_depth)
        return gate

    def _byte_budget(self) -> Optional[_ByteBudget]:
        if self.max_inflight_bytes is None:
            return None
        loop = asyncio.get_running_loop()
        budget = self._budgets.get(loop)
        if budget is None:
            budget = self._budgets[loop] = _ByteBudget(
                self.max_inflight_bytes)
        return budget

    def _shed_pace(self, tid, length: int) -> float:
        """Trickle pacing delay for one range request of a shed
        (degraded-admission) transfer; 0 for full-service transfers."""
        try:
            gate = self._gates.get(asyncio.get_running_loop())
        except RuntimeError:
            return 0.0
        if gate is None or not gate.is_degraded(tid):
            return 0.0
        return float(length) / self.shed_trickle_bytes_per_s

    # -- client lifecycle --------------------------------------------------

    def _job_replicas(self, replicas: Optional[Sequence[Replica]],
                      path: Optional[str]) -> list:
        reps = list(replicas) if replicas is not None else list(self.replicas)
        if path is not None:
            reps = [Replica(r.host, r.port, path, mirror=r.mirror)
                    for r in reps]
        return reps

    def _warm_params(self, n_active: int) -> Optional[ChunkParams]:
        """Geometry a new transfer starts from: the contention ladder for
        the current active count if planned, else the last adopted
        params, else whatever the shared tuner has converged to."""
        ladder = self.contention_ladder.get(n_active)
        if ladder is not None:
            return ladder
        if self.params is not None:
            return self.params
        return getattr(self.tuner, "params", None)

    @contextlib.asynccontextmanager
    async def session(self, replicas: Optional[Sequence[Replica]] = None,
                      path: Optional[str] = None, **client_kw):
        """Register a managed client for a multi-fetch workflow (the
        checkpoint-restore wave loop).  On exit the transfer leaves the
        fleet's residual accounting and its adopted geometry persists on
        the manager."""
        tid = next(self._tids)
        reps = self._job_replicas(replicas, path)
        self.fleet.register(tid)
        kw = {**self._client_kw, **client_kw}
        if "tuner" not in kw:
            # the shared tuner rides along by default; callers running
            # their own wave-boundary updates pass tuner=None to keep the
            # in-fetch hook quiet (reward attribution stays single-source)
            kw["tuner"] = (_SharedTuner(self, tid, reps)
                           if self.tuner is not None else None)
        warm = self._warm_params(self.fleet.active_transfers)
        client = _ManagedClient(
            reps, self, tid, params=warm,
            estimator=self._estimator, ewma_alpha=self._ewma_alpha,
            **kw)
        try:
            yield client
        finally:
            self.fleet.forget(tid)
            # persist only geometry this transfer actually LEARNED (tuner
            # adoption / retune): a transfer that just rode its
            # construction-time warm params must not clobber what a
            # concurrent peer adopted in the meantime (last-writer-wins
            # on stale state)
            if (client._params_arg is not None
                    and client._params_arg != warm):
                self.params = client._params_arg

    # -- transfers ---------------------------------------------------------

    async def fetch(self, size: int, *, path: Optional[str] = None,
                    replicas: Optional[Sequence[Replica]] = None,
                    sink=None, offset: int = 0,
                    tune_interval_bytes: Optional[int] = None,
                    start_delay: float = 0.0,
                    stripe: Optional[tuple] = None):
        """One managed transfer (awaitable; gather several for a fleet).

        Same contract as ``MDTPClient.fetch`` plus ``path``/``replicas``
        re-pointing and ``start_delay`` for staggered arrivals (and
        ``stripe``/peer-mirror replicas pass straight through — a swarm
        is N managed transfers whose replica lists include each other's
        ``PeerMirror.replica``).  Passes through the admission gate
        first: may wait in the SRPT queue (or run at trickle service)
        when ``max_active_transfers`` is set.
        """
        if start_delay > 0.0:
            await asyncio.sleep(start_delay)
        gate = self._gate()
        mode, waited = await gate.acquire(size)
        self.admission["admitted"] += 1
        if waited > 0.0:
            self.admission["queued"] += 1
            self.admission["wait_seconds"] += waited
        if mode == "shed":
            self.admission["shed"] += 1
        tid = None
        try:
            async with self.session(replicas=replicas, path=path) as client:
                tid = client._tid
                gate.bind(tid, mode, size)
                buf, report = await client.fetch(
                    size, sink=sink, offset=offset,
                    tune_interval_bytes=tune_interval_bytes,
                    stripe=stripe)
                self.reports.append(report)
                return buf, report
        finally:
            if tid is not None:
                promoted = gate.finish(tid)
            elif mode == "full":
                # admission slot acquired but the session never bound a
                # transfer (construction failed): free the slot directly
                promoted = gate._release_slot()
            else:
                promoted = None
            if promoted is not None:
                self.admission["promoted"] += 1

    def run(self, jobs: Sequence[TransferJob]):
        """Synchronous batch entry: run every job concurrently on one
        event loop, respecting per-job start delays.  Returns the
        ``(buffer, report)`` pairs in JOB order."""

        async def go():
            return await asyncio.gather(*(
                self.fetch(j.size, path=j.path, sink=j.sink,
                           offset=j.offset,
                           tune_interval_bytes=j.tune_interval_bytes,
                           start_delay=j.start_delay, stripe=j.stripe)
                for j in jobs))

        return asyncio.run(go())

    # -- contention planning ----------------------------------------------

    def plan_contention(self, file_size: int, max_transfers: int = 4,
                        bandwidth: Optional[Sequence[float]] = None,
                        rtt: Optional[Sequence[float]] = None,
                        **sweep_kw) -> dict:
        """Precompute the contention ladder: per active-transfer count k,
        the (C, L) tuned for a fair k-way split of the fleet — one fused
        lane-batched sweep (``repro_torch.core.autotune.contention_sweep``) covering
        every (k, C, L) cell.  Uses the fleet model's capacities when no
        explicit bandwidth is given (requires at least one observed
        transfer in that case).  Stores and returns ``{k: ChunkParams}``.
        """
        from repro_torch.core.autotune import contention_sweep

        if bandwidth is None:
            snap = self.snapshot()
            bandwidth, rtt_model = [], []
            for r in self.replicas:
                st = snap.get(r.name)
                if st is not None and st["capacity"] > 0.0:
                    bandwidth.append(st["capacity"])
                    rtt_model.append(st["rtt"] if st["rtt"] > 0.0
                                     else MDTPClient.DEFAULT_RTT)
            if not bandwidth:
                raise ValueError(
                    "no fleet capacity observations to plan from — pass "
                    "bandwidth= explicitly or run a transfer first")
            if rtt is None:
                rtt = rtt_model
        if rtt is None:
            rtt = MDTPClient.DEFAULT_RTT
        # plan for the data plane the managed clients actually run: the
        # ladder must model the same request pipelining (client_kw may
        # override the depth; mirror that here)
        sweep_kw.setdefault(
            "pipeline_depth",
            self._client_kw.get("pipeline_depth", DEFAULT_PIPELINE_DEPTH))
        results = contention_sweep(bandwidth, rtt, int(file_size),
                                   max_transfers=max_transfers, **sweep_kw)
        self.contention_ladder = {
            k: res.params for k, res in results.items()}
        return self.contention_ladder

    def snapshot(self) -> dict:
        """Fleet model diagnostics (see :meth:`FleetModel.snapshot`)."""
        return self.fleet.snapshot()
