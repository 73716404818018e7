"""Asyncio multi-source transfer client (the real MDTP runtime).

No aiohttp in this environment — this is a raw-socket HTTP/1.1 client on
asyncio's ``loop.sock_*`` primitives with:

* one persistent connection per replica (paper §III-A: avoid TCP slow-start
  and session re-establishment),
* **depth-k request pipelining** per connection: the next Range request is
  issued while the previous body is still streaming, so steady-state
  chunks do not pay a request RTT each (the CDTP-style overlap of request
  issue with in-flight body streaming — see PAPERS.md),
* a **zero-copy receive path**: the destination ``bytearray`` is
  preallocated and bodies are ``sock_recv_into`` memoryview slices of it —
  no per-chunk ``bytes`` materialization and no assembly copy,
* byte-range requests sized by the SAME allocator the simulator uses
  (``repro_torch.core.chunking`` — single source of truth),
* per-chunk throughput observation feeding the next allocation (RTT bias
  removed at the observation point — see :func:`wire_elapsed`),
* **end-to-end integrity**: every range's CRC32 (the server's
  ``X-Range-Checksum`` header) is verified off the event loop as bodies
  land; a mismatching range is atomically re-pooled tagged "not this
  replica" so it re-fetches from an alternate mirror, and a chronically
  corrupt replica is retired like a dead one,
* **crash-resume**: ``fetch(resume=journal)`` replays an append-only
  :class:`~repro_torch.transfer.journal.ResumeJournal`, re-verifies journaled
  range checksums against the destination, and requests only the
  uncovered intervals,
* failure handling: a replica that errors mid-chunk — or stalls past the
  per-read inactivity timeout — is retired (or retried with capped
  exponential backoff after ``retry_after``) and every range it still
  owes, including all pipelined in-flight requests, is atomically
  re-pooled for surviving peers (the checkpoint-restore path's fault
  tolerance).

Sink contract
-------------
``fetch(size, sink=...)`` accepts either:

* a callable ``sink(start, view)`` — ``view`` is a ``memoryview`` that is
  only valid DURING the call (the backing buffer is per-chunk scratch);
  a sink that wants to keep the bytes must copy before returning, or
* an object with ``writable(start, length) -> memoryview`` and
  ``commit(start, nbytes)`` — the client reads the socket directly into
  the returned view and calls ``commit`` once the bytes landed, so the
  path from socket to the sink's buffer is copy-free
  (``repro_torch.checkpoint.manager._StreamingRestore`` implements this).

The client is transport-generic: anything exposing ``fetch_range`` works
(tests use the in-process ``RangeServer``; production would point at real
mirrors).

This is the port's own copy of ``repro.transfer.client``; ``retune`` and
the ``fetch(tuner=...)`` hook drive the port's tuners
(``repro_torch.core.autotune`` / ``repro_torch.core.online``).
"""

from __future__ import annotations

import asyncio
import contextlib
import random
import time
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Optional, Sequence

from repro_torch.core.chunking import ChunkParams, default_chunk_params
from repro_torch.core.throughput import make_estimator, rtt_corrected_bandwidth
from repro_torch.transfer.journal import merge_intervals
from repro_torch.transfer.sched import ChunkScheduler, defaults as sched_defaults
# _Conn/_RangeReply re-exported here: the data pipeline and the fleet
# manager import them from this module (their historical home)
from repro_torch.transfer.transport import _Conn, _RangeReply, _crc32_async

__all__ = ["Replica", "ClientOptions", "TransferReport", "MDTPClient",
           "NoTelemetryError", "TransferIncompleteError", "fetch_blob",
           "wire_elapsed", "DEFAULT_PIPELINE_DEPTH"]

#: default per-connection request pipeline depth.  2 keeps a request on
#: the wire while the previous body streams (the RTT-hiding that matters)
#: at minimal client-side concurrency — important because lane tasks
#: share one event loop and a loaded host inflates their scheduling
#: delays, which distorts throughput observations.  High-RTT paths gain
#: another ~10-20% from depth 4 (see benchmarks/dataplane_bench.py);
#: tune per deployment via ``MDTPClient(pipeline_depth=...)``.
DEFAULT_PIPELINE_DEPTH = sched_defaults.PIPELINE_DEPTH

#: endgame re-poll cadence (s) for lanes parked with hedging enabled: a
#: grayed-out mirror produces NO events to wake a parked lane (that is
#: the failure mode hedging exists for), so idle endgame lanes re-check
#: for straggling in-flight ranges on this period instead of waiting on
#: a notification that will never come.
_HEDGE_POLL_S = sched_defaults.HEDGE_POLL_S


class NoTelemetryError(RuntimeError):
    """``retune()`` had no usable observations to re-plan from (no
    completed fetch yet, or every replica failed/went unobserved).

    A dedicated type so callers that tolerate missing telemetry (the
    checkpoint-restore wave loop) don't have to catch blanket
    ``RuntimeError``, which would also swallow real failures of the sweep
    itself.
    """


class TransferIncompleteError(IOError):
    """``fetch()`` could not deliver every byte (all replicas failed or
    were retired for corruption before the pool drained).

    A dedicated type — previously this surfaced as a bare ``IOError``,
    and before that a short buffer could silently escape — so callers
    can distinguish "the transfer is incomplete, retry/resume it" from
    unrelated I/O failures.  Subclasses ``IOError`` for compatibility.
    """

    def __init__(self, message: str, *, done_bytes: int = 0,
                 expected_bytes: int = 0,
                 failed_replicas: Sequence[str] = ()):
        super().__init__(message)
        self.done_bytes = done_bytes
        self.expected_bytes = expected_bytes
        self.failed_replicas = list(failed_replicas)


@dataclass(frozen=True)
class Replica:
    host: str
    port: int
    path: str              # HTTP path of the blob on this mirror
    #: True = a PARTIAL peer mirror (a restoring node serving what it has
    #: so far): the client queries its ``X-Available-Ranges`` coverage,
    #: keeps refreshing it in the background, and only packs chunks the
    #: peer actually holds.  False (default) = an ordinary full mirror.
    mirror: bool = False

    @property
    def name(self) -> str:
        return f"{self.host}:{self.port}"


@dataclass(frozen=True)
class ClientOptions:
    """Consolidated :class:`MDTPClient` configuration.

    What used to be 15 bare constructor kwargs, grouped by concern.  The
    bare kwargs still work (``MDTPClient(reps, pipeline_depth=3)`` —
    they are folded into an options instance, overriding it field by
    field), so existing call sites don't change; new code should prefer
    ``MDTPClient(reps, options=ClientOptions(...))``.
    """

    # -- allocation & estimation ------------------------------------------
    #: chunk geometry; None = size-derived defaults per fetch.
    params: Optional[ChunkParams] = None
    #: throughput estimator kind (``repro_torch.core.throughput``).
    estimator: str = "ewma"
    ewma_alpha: float = 0.5
    #: default online tuner (``repro_torch.core.online`` contract: an object
    #: with ``update(telemetry) -> ChunkParams | None``) applied to every
    #: ``fetch`` unless overridden per call.
    tuner: object = None

    # -- pipeline / zero-copy data plane ----------------------------------
    #: concurrent pipelined requests per replica connection (>= 1;
    #: 1 = the serial request-response data plane).
    pipeline_depth: int = DEFAULT_PIPELINE_DEPTH
    #: False = legacy copy path (bodies materialize as ``bytes`` and are
    #: copied into place) — kept as the benchmark baseline and an escape
    #: hatch; the default receives into the destination buffer.
    zero_copy: bool = True
    #: emulated request-path delay per request (see ``_Conn``).
    request_latency: float = 0.0
    #: False = legacy half-duplex connections (request writes serialize
    #: inline behind the write lock instead of draining through the
    #: independent writer coroutine) — kept as the benchmark baseline
    #: the duplex win-guard measures against.
    duplex: bool = True

    # -- integrity / retry / timeout --------------------------------------
    #: verify each range's CRC32 against the server's
    #: ``X-Range-Checksum`` header and re-fetch mismatches from an
    #: alternate mirror.  Servers that don't send the header are simply
    #: not verified (no error).
    verify_integrity: bool = True
    #: seconds before retrying a failed replica (0 = retire immediately).
    retry_after: float = 0.0
    #: connection/corruption failures before a replica is retired.
    max_failures: int = 3
    #: per-read inactivity timeout (seconds; 0 disables) applied to every
    #: connection — see ``_Conn.read_timeout``.
    read_timeout: float = 30.0
    #: ceiling (seconds) on the exponential dead-replica retry backoff:
    #: attempt k waits ``min(retry_after * 2**(k-1), cap)`` scaled by
    #: ±50% jitter so reconnect storms decorrelate.
    retry_backoff_cap: float = 5.0

    # -- endgame hedging ---------------------------------------------------
    #: straggler quantile for speculative endgame duplicates (0 disables;
    #: see the ``MDTPClient`` docs for the full trigger conditions).
    hedge_quantile: float = 0.0
    #: hard cap on hedge waste as a fraction of the transfer size.
    hedge_waste_frac: float = sched_defaults.HEDGE_WASTE_FRAC

    # -- peer mirrors ------------------------------------------------------
    #: background coverage-refresh cadence (seconds) for partial peer
    #: replicas (``Replica.mirror``): how often each peer's
    #: ``X-Available-Ranges`` is re-queried during a fetch.
    coverage_refresh_s: float = 0.05

    # -- misc --------------------------------------------------------------
    #: randomness source for reconnect-backoff jitter — pass a seeded
    #: ``random.Random`` to make chaos-test retry timing reproducible;
    #: None = the module-global generator.
    rng: Optional[random.Random] = None


def _parse_ranges_header(raw: str) -> list:
    """``X-Available-Ranges`` value -> list of inclusive ``(lo, hi)``
    pairs (empty list for an empty advertisement)."""
    out = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        lo_s, _, hi_s = part.partition("-")
        out.append((int(lo_s), int(hi_s)))
    return out


@dataclass
class TransferReport:
    total_bytes: int
    elapsed: float
    bytes_per_replica: dict
    requests_per_replica: dict
    failed_replicas: list
    refetched_ranges: int
    #: number of mid-transfer tuner adoptions (``fetch(tuner=...)``) — 0
    #: for un-tuned transfers.
    retunes: int = 0
    #: final per-replica estimator values (bytes/s; 0 = never observed) —
    #: the live inputs the autotuner re-tunes chunk sizes from.  These are
    #: WIRE rates: the per-request RTT bias is already removed at the
    #: observation point (:func:`wire_elapsed`), so consumers must not
    #: apply ``rtt_corrected_bandwidth`` again.
    observed_throughputs: dict = field(default_factory=dict)
    #: measured per-replica request RTT in seconds (min over connect time
    #: and idle-pipe header turnarounds; 0 = never measured).  Feeds
    #: ``retune`` so the simulated sweep uses live latencies, not a
    #: guessed constant.
    observed_rtts: dict = field(default_factory=dict)
    #: per-replica count of connection-level retries (reconnect after a
    #: break/stall, with capped exponential backoff between attempts).
    retries_per_replica: dict = field(default_factory=dict)
    #: per-replica count of ranges that failed checksum verification and
    #: were re-fetched from an alternate mirror.
    corrupt_ranges: dict = field(default_factory=dict)
    #: bytes satisfied from the resume journal instead of the wire
    #: (``fetch(resume=...)``); 0 for fresh transfers.
    resumed_bytes: int = 0
    #: seconds spent re-verifying journaled range checksums during resume
    #: replay (large records hash in the executor); 0.0 for fresh fetches.
    resume_verify_seconds: float = 0.0
    #: endgame hedges (``hedge_quantile`` > 0): speculative duplicate
    #: fetches issued for straggling in-flight ranges, and how many beat
    #: their original copy to completion.
    hedges_issued: int = 0
    hedges_won: int = 0
    #: duplicated bytes the losing copies cost.  Cancellation is
    #: symmetric — whichever side lands first breaks the other's
    #: connection — so each losing copy is charged the bytes it actually
    #: received before the race resolved, not its whole range.
    hedge_wasted_bytes: int = 0

    @property
    def throughput(self) -> float:
        return self.total_bytes / self.elapsed if self.elapsed > 0 else 0.0


def wire_elapsed(nbytes: int, elapsed: float, rtt: float) -> float:
    """Strip the request RTT from a serial chunk observation.

    A request issued on an idle pipe spans ``rtt + nbytes / wire_rate``
    seconds, so feeding ``(nbytes, elapsed)`` straight into an estimator
    under-states the wire rate — badly for small chunks on high-RTT paths.
    A *pipelined* request's elapsed starts when its body starts streaming
    and needs no correction; this helper is applied only to observations
    flagged as RTT-inclusive.  Delegates the guard logic (no RTT sample,
    implied non-positive wire time) to
    :func:`repro_torch.core.throughput.rtt_corrected_bandwidth`, returning the
    elapsed unchanged when the correction is impossible.
    """
    if elapsed <= 0.0 or nbytes <= 0:
        return elapsed
    corrected = rtt_corrected_bandwidth(nbytes / elapsed, rtt, float(nbytes))
    return nbytes / corrected if corrected > 0.0 else elapsed


class MDTPClient:
    """Downloads one blob from N replicas with MDTP adaptive chunking."""

    def __init__(
        self,
        replicas: Sequence[Replica],
        params: Optional[ChunkParams] = None,
        options: Optional[ClientOptions] = None,
        **kw,
    ):
        """``options`` is the consolidated configuration
        (:class:`ClientOptions`, grouped and documented there); any bare
        keyword from the historical 15-kwarg constructor is still
        accepted and overrides the corresponding options field — the
        compatibility shim that keeps every existing call site (and the
        fleet manager's ``**client_kw`` forwarding) working unchanged.
        An unknown keyword raises ``TypeError`` exactly as before."""
        if options is None:
            try:
                options = ClientOptions(**kw)
            except TypeError as e:
                raise TypeError(f"MDTPClient: {e}") from None
        elif kw:
            options = _dc_replace(options, **kw)
        if params is not None:
            options = _dc_replace(options, params=params)
        #: the resolved configuration (read-only snapshot).
        self.options = options
        self.replicas = list(replicas)
        self._params_arg = options.params
        self._estimator = options.estimator
        self._alpha = options.ewma_alpha
        self.retry_after = options.retry_after
        self.max_failures = options.max_failures
        self.tuner = options.tuner
        self.pipeline_depth = max(int(options.pipeline_depth), 1)
        self.zero_copy = options.zero_copy
        self.request_latency = options.request_latency
        self.duplex = options.duplex
        self.verify_integrity = options.verify_integrity
        self.read_timeout = options.read_timeout
        self.retry_backoff_cap = options.retry_backoff_cap
        #: endgame hedging (0 disables): once the residual drops below
        #: ~2 allocator rounds, an idle lane speculatively duplicates an
        #: in-flight range whose owner's per-byte latency EWMA sits at or
        #: above this fleet quantile (or whose range has aged well past
        #: the owner's own expected service time — the grayed-out-mirror
        #: case, where the EWMA goes stale).  First completion wins; the
        #: loser is cancelled/discarded with byte accounting on the
        #: report (``hedges_issued`` / ``hedges_won`` /
        #: ``hedge_wasted_bytes``).  Applies only when assembling
        #: in-memory (``sink=None``): hedge bodies land in private
        #: scratch, never the destination, so a losing or corrupt copy
        #: cannot touch committed bytes.
        self.hedge_quantile = float(options.hedge_quantile)
        #: hard cap on hedge waste as a fraction of the transfer size: a
        #: hedge is only issued while committed waste plus every
        #: in-flight hedge's reserved length stays under this budget —
        #: each race can waste at most its own range, whichever side
        #: loses, so ``hedge_wasted_bytes <= hedge_waste_frac * size``
        #: holds by construction.
        self.hedge_waste_frac = float(options.hedge_waste_frac)
        self.coverage_refresh_s = float(options.coverage_refresh_s)
        self._rng = options.rng if options.rng is not None else random
        #: report of the most recent ``fetch`` (None before the first one).
        self.last_report: Optional[TransferReport] = None
        #: set to a list to record the next fetch's scheduler decision
        #: trace (``repro_torch.transfer.sched.replay`` re-drives it; the
        #: decision-parity test in tests/test_sched.py uses this hook).
        self._sched_trace: Optional[list] = None

    #: fallback request RTT (s) for replicas that never produced a sample —
    #: ~WAN RTT between FABRIC sites, matching the simulator scenarios.
    DEFAULT_RTT = sched_defaults.DEFAULT_RTT

    #: minimum contiguous streaming time (s) aggregated into one
    #: throughput observation — see the observation-window comment in
    #: ``fetch``.
    OBS_WINDOW_S = sched_defaults.OBS_WINDOW_S

    def retune(self, file_size: int, **autotune_kw):
        """Re-tune chunk sizes from the last transfer's live observations.

        Runs the on-device grid sweep (``repro_torch.core.autotune``, one
        lane batch for the whole (C, L) × seed lattice) against the
        per-replica throughputs AND measured request RTTs observed during
        the previous ``fetch`` and adopts the winning ``ChunkParams`` for
        subsequent transfers.  Typical use: between checkpoint-restore
        waves, where mirror conditions drift but the replica set is stable.

        The client's own ``pipeline_depth`` is passed to the sweep (unless
        overridden) so the simulated request-latency amortization matches
        what this runtime actually does on the wire; likewise an observed
        corruption rate (re-fetched ranges / requests) is folded in so the
        sweep's (C, L) pays the same re-fetch overhead the wire did.

        The sweep runs where the client's tuner runs (its ``device``
        field), else on the card; pass ``device="cpu"`` to run it on the
        host.

        Returns the ``AutotuneResult``; raises if no transfer has been
        observed yet or no replica produced a throughput sample.
        """
        from repro_torch.core.autotune import autotune_chunk_params

        if self.last_report is None:
            raise NoTelemetryError("retune() needs a completed fetch() first")
        # Replicas with no sample (failed / never dispatched) are excluded,
        # mirroring how fetch() retires them — a 0-throughput entry would
        # otherwise dominate every simulated grid point.  RTTs stay aligned
        # with the surviving bandwidth entries.  Estimates are already wire
        # rates (the RTT bias is stripped per observation, see
        # ``wire_elapsed``), so they feed the sweep directly.
        rep = self.last_report
        bw, rtts = [], []
        for r in self.replicas:
            b = rep.observed_throughputs.get(r.name, 0.0)
            if b <= 0.0:
                continue
            rtt = rep.observed_rtts.get(r.name, 0.0)
            bw.append(b)
            rtts.append(rtt if rtt > 0.0 else self.DEFAULT_RTT)
        if not bw:
            raise NoTelemetryError("no throughput observations to retune from")
        autotune_kw.setdefault("rtt", rtts)
        autotune_kw.setdefault("device", getattr(self.tuner, "device", None))
        autotune_kw.setdefault("pipeline_depth", self.pipeline_depth)
        total_reqs = sum(rep.requests_per_replica.values())
        total_corrupt = sum(rep.corrupt_ranges.values())
        if total_corrupt > 0 and total_reqs > 0:
            autotune_kw.setdefault(
                "corruption_rate", min(total_corrupt / total_reqs, 0.5))
            # a single seed sees one fault realization; average a few
            autotune_kw.setdefault("n_seeds", 4)
        res = autotune_chunk_params(bw, file_size=int(file_size),
                                    **autotune_kw)
        self._params_arg = res.params
        return res

    def adopt_params(self, params: ChunkParams) -> None:
        """Adopt chunk geometry for subsequent transfers.

        The public hook for external re-tuning loops (e.g. the
        checkpoint-restore wave loop feeding an online tuner between
        waves); ``fetch(tuner=...)`` and ``retune`` adopt internally.
        """
        self._params_arg = params

    def _make_conn(self, replica: Replica) -> "_Conn":
        """Connection factory — subclasses may translate offsets (the data
        pipeline's virtual-blob client) or wrap requests (the fleet
        manager's capped, telemetry-fed connections)."""
        return _Conn(replica, request_latency=self.request_latency,
                     read_timeout=self.read_timeout, duplex=self.duplex)

    def _allocation_throughputs(self, est_values: list) -> list:
        """Per-replica throughput vector the allocator sizes chunks from.

        Default: this transfer's own estimator values.  The fleet manager
        (``repro.transfer.manager``) overrides this to pack each round
        into *residual* replica capacity — fleet bandwidth minus what
        other concurrent transfers are consuming — so co-scheduled
        transfers don't all plan as if they owned the mirrors.
        """
        return est_values

    def _on_corruption(self, name: str) -> None:
        """Integrity-failure hook: called once per checksum-mismatched
        range, outside the transfer lock.  The fleet manager overrides
        this to feed per-replica corruption counters into the
        ``FleetModel`` so chronically corrupt replicas are deprioritized
        fleet-wide, not just within this transfer."""

    def _on_retry(self, name: str) -> None:
        """Connection-retry hook: called once per reconnect-with-backoff
        attempt (a break, stall, or reset that the worker survives).  The
        fleet manager overrides this to feed retry counts into the
        ``FleetModel``'s probation thresholds — a replica that keeps
        costing reconnects goes on probation fleet-wide."""

    async def fetch(self, size: int, sink=None, *, offset: int = 0,
                    tuner=None, tune_interval_bytes: Optional[int] = None,
                    resume=None, into: Optional[bytearray] = None,
                    stripe: Optional[tuple] = None,
                    ) -> tuple[Optional[bytearray], TransferReport]:
        """Fetch ``size`` bytes.  ``sink`` (if given) receives ranges as
        they land — see the module docstring for the two sink protocols
        (callable receiving transient memoryviews, or ``writable``/
        ``commit`` for the copy-free path); otherwise an in-memory buffer
        is assembled (and received into directly — zero-copy).  ``into``
        supplies that buffer (``len(into) >= size``) instead of a fresh
        allocation — resume needs the previous attempt's bytes in place.

        ``offset`` shifts every byte-range request (and the ``sink`` start
        offsets) by a constant — a wave of a larger blob fetches
        ``[offset, offset + size)`` while the internal frontier/pool stay
        0-based (the checkpoint-restore wave loop uses this).

        ``resume`` (a :class:`~repro_torch.transfer.journal.ResumeJournal`)
        replays previously committed intervals: each journaled record
        inside this fetch's window is re-verified against the destination
        (its CRC32 — data that never reached stable storage fails and is
        re-fetched), verified bytes are counted done without touching the
        wire, and every NEW committed range is appended to the journal
        (fsync'd at the journal's checkpoint interval).  The journal is
        left open; call ``complete()`` on it after the overall operation
        (which may span several waves) succeeds.

        Raises :class:`TransferIncompleteError` if the surviving replicas
        could not deliver every byte — a short buffer never escapes.

        ``tuner`` (default: the client's ``tuner``) re-tunes chunk
        geometry mid-transfer: every ``tune_interval_bytes`` delivered
        bytes the client snapshots live telemetry (per-replica estimator
        values + measured RTTs, achieved window throughput) into a
        ``repro_torch.core.online.Telemetry`` and adopts whatever ``ChunkParams``
        the tuner returns — workers pick up the new geometry on their next
        allocation.  The tuner runs in a thread-pool executor so its
        (card-bound) sweep never stalls the event loop; at
        most one update is in flight at a time.  Adopted params persist on
        the client for subsequent transfers, and ``report.retunes`` counts
        the adoptions.

        ``stripe=(k, n)`` rotates the fresh-byte frontier to start at
        ``size * k // n`` (wrapping) instead of 0.  In a swarm of ``n``
        restorers this de-correlates what each node fetches FIRST, so
        peers become useful sources for each other almost immediately —
        everyone starting at byte 0 would race the origin for the same
        prefix and have nothing to trade.  Purely an ordering hint:
        every byte is still fetched exactly once.

        Replicas flagged ``mirror=True`` are PARTIAL peer mirrors: their
        advertised coverage (``X-Available-Ranges``) is polled in the
        background every ``coverage_refresh_s`` and chunks are packed
        onto a peer only when its advertisement covers them; full
        replicas meanwhile prefer spans no live peer holds yet (origin
        offload).  A fetch whose only surviving sources are partial
        mirrors that cannot cover the remaining bytes gives up with
        :class:`TransferIncompleteError` once their joint coverage has
        been static for a patience window, instead of waiting forever.
        """
        n = len(self.replicas)
        depth = self.pipeline_depth
        est = [make_estimator(self._estimator, self._alpha) for _ in range(n)]
        # per-replica [bytes, seconds] observation windows: back-to-back
        # pipelined replies carry wildly noisy per-reply timings (a body
        # the kernel buffered ahead reads in microseconds, the next one
        # absorbs the wait), but their SUM over a contiguous streaming
        # window is exact — so samples are aggregated until the window
        # holds enough signal, then fed to the estimator as one reading
        obs_win = [[0, 0.0] for _ in range(n)]
        zero_copy = self.zero_copy
        if sink is not None and into is not None:
            raise TypeError("into= only applies when assembling in-memory "
                            "(sink is None)")
        if into is not None and len(into) < size:
            raise ValueError(f"into buffer ({len(into)} B) smaller than "
                             f"transfer size ({size} B)")
        buf = (into if into is not None else bytearray(size)) \
            if sink is None else None
        sink_writable = getattr(sink, "writable", None)
        sink_commit = getattr(sink, "commit", None)
        if (sink_writable is None) != (sink_commit is None):
            raise TypeError(
                "zero-copy sinks must provide BOTH writable() and commit()")

        verify = self.verify_integrity
        journal = resume
        need_crc = verify or journal is not None

        # the decision brain: every allocation, hedge, and repool choice
        # lives in the sans-I/O ``ChunkScheduler`` (repro_torch.transfer.sched)
        # — this method is transport glue that drives it under ``lock``
        # and performs the I/O its results prescribe.  Scratch-buffer
        # hedges need a readable destination to commit to, so hedging is
        # in-memory-assembly only (see __init__).
        sched = ChunkScheduler(
            size, [r.mirror for r in self.replicas],
            params=self._params_arg or default_chunk_params(size),
            depth=depth,
            hedge_quantile=self.hedge_quantile if sink is None else 0.0,
            hedge_waste_frac=self.hedge_waste_frac,
            default_rtt=self.DEFAULT_RTT,
            max_failures=self.max_failures,
            coverage_refresh_s=self.coverage_refresh_s,
            stripe=stripe, trace=self._sched_trace)
        hedge_q = sched.hedge_quantile
        refresh_s = sched.refresh_s

        lock = asyncio.Lock()
        #: signalled whenever reclaimed work appears or in-flight bytes
        #: drain to zero — a lane with nothing to draw parks here instead
        #: of polling (it must stay alive while peers owe ranges: if a
        #: peer's replica dies, its range returns to the pool and needs a
        #: surviving taker — the mirror-death fault-tolerance contract).
        cond = asyncio.Condition(lock)
        resumed_bytes = 0
        resume_verify = 0.0

        if journal is not None:
            # Replay: every journaled record inside this window whose
            # bytes still verify is covered; everything else re-fetches.
            # Verification needs a readable destination — the assembly
            # buffer or a writable() sink view; callable sinks can't be
            # read back, so their records are trusted as journaled.
            def _view_of(abs_start: int, nb: int):
                if buf is not None:
                    lo = abs_start - offset
                    return memoryview(buf)[lo:lo + nb]
                if sink_writable is not None:
                    return sink_writable(abs_start, nb)
                return None

            verified: list[tuple[int, int]] = []
            t_verify = time.monotonic()
            for s_abs, nb, rcrc in journal.records():
                if s_abs < offset or s_abs + nb > offset + size:
                    continue
                v = _view_of(s_abs, nb)
                if v is not None and rcrc is not None \
                        and await _crc32_async(v) != rcrc:
                    continue
                verified.append((s_abs - offset, nb))
            resume_verify = time.monotonic() - t_verify
            covered = merge_intervals(verified)
            resumed_bytes = sched.seed_resume(covered)
            if sink_commit is not None:
                # drive the sink's covered-interval accounting so resumed
                # regions materialize exactly like freshly landed ones
                for s_, n_ in covered:
                    sink_commit(offset + s_, n_)

        t0 = time.monotonic()

        tuner = tuner if tuner is not None else self.tuner
        retunes = 0
        # telemetry cadence: a handful of updates per transfer by default,
        # but never finer than a couple of large chunks' worth of signal
        tune_every = tune_interval_bytes or max(
            size // 8, 2 * sched.params.large_chunk)
        tune_state = {"bytes": sched.done_bytes, "t": t0, "busy": False,
                      "task": None}

        def _failed_names() -> list:
            """Retired replica names in retirement order, deduped — the
            report and the giving-up error are name-keyed while the
            scheduler tracks indices."""
            names: list = []
            for k in sched.failed:
                nm = self.replicas[k].name
                if nm not in names:
                    names.append(nm)
            return names

        def _telemetry_bandwidths() -> tuple:
            """Full-fleet positional wire-rate vector for ``Telemetry``:
            estimator values (already RTT-de-biased at observation time),
            dead replicas zeroed in place."""
            bad = set(_failed_names())
            return tuple(
                0.0 if r.name in bad else float(est[i].value)
                for i, r in enumerate(self.replicas))

        async def maybe_retune():
            """Snapshot telemetry and let the tuner re-plan (at most one
            update in flight — the trigger site claims the busy flag
            BEFORE scheduling, so a second trigger can't race in between;
            runs in an executor so the tuner's simulations don't
            stall the event loop)."""
            nonlocal retunes
            try:
                try:
                    from repro_torch.core.online import Telemetry

                    now = time.monotonic()
                    window_bytes = sched.done_bytes - tune_state["bytes"]
                    window_t = max(now - tune_state["t"], 1e-9)
                    telemetry = Telemetry(
                        bandwidth=_telemetry_bandwidths(),
                        rtt=tuple(float(x) for x in sched.rtt_min),
                        remaining_bytes=float(size - sched.done_bytes),
                        measured_throughput=window_bytes / window_t,
                        elapsed=now - t0,
                    )
                    loop = asyncio.get_running_loop()
                    new = await loop.run_in_executor(None, tuner.update,
                                                     telemetry)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    # a failing tuner path (a card that is not there, a
                    # tuner bug) must never fail a transfer whose bytes
                    # are flowing fine — keep the current geometry, carry on
                    new = None
                tune_state["bytes"] = sched.done_bytes
                tune_state["t"] = time.monotonic()
                if new is not None:
                    sched.adopt_params(new)
                    retunes += 1
            finally:
                tune_state["busy"] = False

        # -- endgame-hedging transport state ------------------------------
        #: start -> the connection streaming a duplicate of that range
        #: (what an owner that lands first breaks to cancel the race).
        hedge_conns: dict = {}
        #: owner indices whose connection was broken ON PURPOSE to cancel
        #: a lost race — the worker reconnects without charging its
        #: failure budget.
        hedge_broke: set = set()
        #: replica index -> the connection its worker currently runs
        #: lanes on (so a winning hedge can break the loser's connection
        #: and turn its pending read into a prompt error).
        conn_of: dict = {}

        async def _stall_clock() -> None:
            """Heartbeat feeding the scheduler's stall meter: each sleep
            should wake after ``_HEDGE_POLL_S``; waking well past twice
            that means the event loop (and so every lane) was starved,
            and the overshoot is time stolen from ALL owners at once,
            not evidence against any one of them."""
            prev = time.monotonic()
            while True:
                await asyncio.sleep(_HEDGE_POLL_S)
                t = time.monotonic()
                if t - prev > 2.0 * _HEDGE_POLL_S:
                    sched.add_stall((t - prev) - _HEDGE_POLL_S)
                prev = t

        def _abort_hedge(start: int, hedger) -> None:
            """Actively cancel a doomed duplicate the scheduler flagged:
            breaking its connection turns the pending read into a prompt
            ConnectionError charging only the bytes it really landed,
            and ``hedge_broke`` lets its worker reconnect without
            failure-budget cost."""
            if hedger is None:
                return
            c = hedge_conns.get(start)
            if c is not None and not c.broken:
                hedge_broke.add(hedger)
                c.abort()

        async def _reclaim(start: int, length: int, ban: frozenset, *,
                           count: bool, lost: int = 0) -> None:
            """Return an owed range to the scheduler atomically, waking
            parked lanes, then perform whatever healing/cancellation it
            prescribes (a settled range heals the winner's bytes back; a
            duplicate still racing the reclaimed range is aborted)."""
            async with lock:
                res = sched.on_reclaim(start, length, ban,
                                       count=count, lost=lost)
                if res.heal is not None and buf is not None:
                    buf[start:start + len(res.heal)] = res.heal
                cond.notify_all()
            _abort_hedge(start, res.cancel_hedger)

        async def hedge_fetch(j: int, conn: "_Conn", start: int,
                              length: int, owner: int,
                              ban: frozenset) -> Optional[str]:
            """Speculatively duplicate an in-flight range onto replica
            ``j``, into PRIVATE scratch — never the destination, so a
            corrupt or losing body cannot touch committed bytes.  First
            completion wins (``sched.on_hedge_result`` adjudicates), and
            cancellation is symmetric: a winning hedge breaks the
            loser's connection, while an owner that lands first breaks
            THIS one.  Returns a lane outcome to propagate, or None to
            carry on."""
            name = self.replicas[j].name
            scratch = bytearray(length)
            try:
                reply = await conn.fetch_range(
                    offset + start, offset + start + length - 1,
                    into=memoryview(scratch) if zero_copy else None)
            except (ConnectionError, OSError,
                    asyncio.IncompleteReadError) as e:
                # broken mid-copy — usually the owner landing first and
                # cancelling this race.  Whatever the duplicate DID land
                # is real duplicated traffic and charges the waste meter.
                async with lock:
                    sched.on_hedge_abandon(
                        start, wasted=getattr(e, "partial_bytes", 0))
                    hedge_conns.pop(start, None)
                return "broken"
            except BaseException:
                async with lock:
                    sched.on_hedge_abandon(start)
                    hedge_conns.pop(start, None)
                raise
            ndata = reply.nbytes
            for sample in conn.take_rtt_samples():
                sched.observe_rtt(j, sample)
            body = scratch[:ndata] if zero_copy else reply.data
            crc = await _crc32_async(body) if need_crc else None
            if verify and reply.crc32 is not None and crc != reply.crc32:
                async with lock:
                    dead = sched.on_hedge_corrupt(j, start)
                    hedge_conns.pop(start, None)
                self._on_corruption(name)
                if dead:
                    conn.broken = True
                    return "corrupt-dead"
                return None
            sched.observe_latency(j, ndata, reply.elapsed)
            o_conn = None
            async with lock:
                res = sched.on_hedge_result(j, start, length, ndata, body)
                hedge_conns.pop(start, None)
                if res.won:
                    # hedge wins: commit from scratch; the scheduler
                    # keeps the bytes so a late-landing loser body can
                    # be healed back over
                    if buf is not None:
                        buf[start:start + ndata] = body
                    o_conn = conn_of.get(res.cancel_owner)
                    if journal is not None:
                        journal.record(offset + start, ndata, crc)
                    cond.notify_all()
            if o_conn is not None and not o_conn.broken:
                # actively cancel the loser: breaking its connection
                # turns the pending read into a prompt ConnectionError
                # instead of waiting out the straggler
                hedge_broke.add(res.cancel_owner)
                o_conn.abort()
            return None

        async def pipe_lane(i: int, conn: "_Conn") -> str:
            """One pipelined request lane on replica ``i``'s shared
            connection.  Up to ``pipeline_depth`` lanes run per replica;
            their concurrent ``fetch_range`` calls are what keeps k
            requests on the wire.  Returns ``"done"`` when the transfer
            has no work left, ``"broken"`` on a connection failure (the
            owed range is already back in the pool), ``"corrupt-dead"``
            when this replica crossed the corruption cap and was
            retired."""
            name = self.replicas[i].name

            async def _park() -> None:
                """Wait for pool/in-flight changes; with hedging on (or
                partial mirrors in play) wake periodically anyway — a
                grayed-out straggler generates no events, and a peer
                whose coverage went static fires no notifications either,
                so only a poll can spot an aging range or conclude the
                remaining work is uncoverable."""
                if not hedge_q and not sched.partial_idx:
                    await cond.wait()
                    return
                with contextlib.suppress(asyncio.TimeoutError):
                    await asyncio.wait_for(
                        cond.wait(),
                        _HEDGE_POLL_S if hedge_q else refresh_s)

            while True:
                if conn.broken:
                    # a sibling lane hit the failure first; don't draw
                    # work a doomed request would just bounce back
                    return "broken"
                hedge = None
                async with lock:
                    while True:
                        if conn.broken:
                            # woke from cond.wait to a sibling's failure:
                            # don't draw a range a doomed send would just
                            # bounce back (and spuriously count as
                            # refetched)
                            return "broken"
                        if sched.remaining <= 0:
                            if sched.inflight <= 0:
                                return "done"
                            hedge = sched.pick_hedge(i)
                            if hedge is not None:
                                break
                            await _park()
                            continue
                        if not sched.can_draw(i):
                            # nothing this replica may serve right now —
                            # park until the pool or an advertisement
                            # changes (or hedge a straggler meanwhile)...
                            # unless no possible source remains.
                            if sched.hopeless():
                                cond.notify_all()
                                return "done"
                            hedge = sched.pick_hedge(i)
                            if hedge is not None:
                                break
                            await _park()
                            continue
                        break
                    if hedge is not None:
                        h_start, h_len, h_owner, h_ban = hedge
                        sched.on_hedge_issue(i, h_start, h_len)
                        hedge_conns[h_start] = conn
                if hedge is not None:
                    outcome = await hedge_fetch(i, conn, h_start, h_len,
                                                h_owner, h_ban)
                    if outcome is not None:
                        return outcome
                    continue
                async with lock:
                    if conn.broken:
                        return "broken"
                    if sched.remaining <= 0:
                        continue
                    if not sched.can_draw(i):
                        continue
                    want = sched.next_want(
                        i, self._allocation_throughputs(
                            [e.value for e in est]))
                    if want <= 0:
                        return "done"
                    asn = sched.on_assign(i, want)
                    if asn is None:
                        # the pool/advertisement shifted between the two
                        # lock sections — go around and re-evaluate
                        continue
                    start, length, ban, prog = asn
                # destination: straight into the assembly buffer / the
                # sink's own storage (zero-copy), or per-chunk scratch
                # for callable sinks / the legacy copy path.  A raising
                # ``writable()`` must reclaim like any other failure —
                # the range is already counted in flight.
                try:
                    if sink is None:
                        mv = (memoryview(buf)[start:start + length]
                              if zero_copy else None)
                    elif sink_writable is not None:
                        mv = sink_writable(offset + start, length)
                    else:
                        mv = (memoryview(bytearray(length))
                              if zero_copy else None)
                except BaseException:
                    await _reclaim(start, length, ban, count=False)
                    raise
                try:
                    reply = await conn.fetch_range(
                        offset + start, offset + start + length - 1,
                        into=mv, progress=prog)
                except (ConnectionError, OSError,
                        asyncio.IncompleteReadError) as e:
                    await _reclaim(start, length, ban, count=True,
                                   lost=getattr(e, "partial_bytes", 0))
                    return "broken"
                except BaseException:
                    # cancellation / unexpected error: release the range
                    # so peers waiting on in-flight work aren't stranded
                    await _reclaim(start, length, ban, count=False)
                    raise
                try:
                    ndata = reply.nbytes
                    for sample in conn.take_rtt_samples():
                        sched.observe_rtt(i, sample)
                    crc = None
                    if need_crc:
                        # off the event loop for big bodies; the range is
                        # exclusively ours until committed or re-pooled,
                        # so hashing it unlocked is safe
                        crc = await _crc32_async(reply.data)
                    if (verify and reply.crc32 is not None
                            and crc != reply.crc32):
                        # corrupt body: the bytes never count — the
                        # scheduler re-pools the WHOLE range tagged "not
                        # this replica" (or heals a settled one), and we
                        # abort any duplicate it says is doomed
                        async with lock:
                            res = sched.on_corrupt(i, start, length, ban,
                                                   ndata)
                            if res.heal is not None and buf is not None:
                                buf[start:start + len(res.heal)] = \
                                    res.heal
                            cond.notify_all()
                        _abort_hedge(start, res.cancel_hedger)
                        self._on_corruption(name)
                        if res.dead:
                            # chronically corrupt = retired, like a dead
                            # mirror; breaking the shared conn stops
                            # sibling lanes too
                            conn.broken = True
                            return "corrupt-dead"
                        continue
                    # estimators track the WIRE rate: serial observations
                    # have their request RTT stripped here, pipelined ones
                    # already measure pure body-streaming time.  Encoded
                    # bodies count WIRE bytes (the framed payload), not
                    # decoded bytes — coverage/commit below still moves in
                    # decoded bytes, which is exactly the split that keeps
                    # compression from double-counting as bandwidth.
                    nwire = reply.wire_bytes
                    elapsed = reply.elapsed
                    if reply.rtt_included:
                        elapsed = wire_elapsed(nwire, elapsed,
                                               sched.rtt_min[i])
                    win = obs_win[i]
                    win[0] += nwire
                    win[1] += elapsed
                    # flush on the first-ever sample (ends probe mode
                    # promptly — it is a serial, RTT-stripped reading) or
                    # once the window holds enough streaming time for a
                    # stable rate
                    if est[i].value <= 0.0 or win[1] >= self.OBS_WINDOW_S:
                        if win[1] > 0.0:
                            est[i].observe(win[0], win[1])
                        win[0], win[1] = 0, 0.0
                    if hedge_q:
                        sched.observe_latency(i, ndata, elapsed)
                    if sink is None:
                        if not zero_copy:
                            buf[start:start + ndata] = reply.data
                    elif sink_writable is not None:
                        sink_commit(offset + start, ndata)
                    else:
                        sink(offset + start, reply.data)
                except BaseException:
                    # e.g. the user-supplied sink raised (disk full): the
                    # bytes were NOT delivered — reclaim the whole range
                    # and settle the in-flight count before propagating
                    await _reclaim(start, length, ban, count=False)
                    raise
                async with lock:
                    res = sched.on_commit(i, start, length, ban, ndata)
                    if res.heal is not None and buf is not None:
                        # a hedge beat this body to completion: heal the
                        # winner's bytes over this landing (the duplicate
                        # is pure hedge waste)
                        buf[start:start + len(res.heal)] = res.heal
                    if res.wake:
                        cond.notify_all()
                _abort_hedge(start, res.cancel_hedger)
                if res.settled_won:
                    continue
                if journal is not None:
                    # committed: journal the interval (buffered append;
                    # fsync at the journal's checkpoint interval)
                    journal.record(offset + start, ndata, crc)
                if (tuner is not None and sched.done_bytes < size
                        and not tune_state["busy"]
                        and sched.done_bytes - tune_state["bytes"]
                        >= tune_every):
                    # fire-and-forget: the triggering lane keeps fetching
                    # while the tuner (simulating on its device) runs in
                    # the executor.  The busy flag is claimed HERE,
                    # synchronously, so no second lane can schedule a
                    # competing task (and overwrite the task ref the
                    # end-of-fetch drain awaits) before this one starts.
                    tune_state["busy"] = True
                    tune_state["task"] = asyncio.ensure_future(
                        maybe_retune())

        async def worker(i: int):
            """Per-replica supervisor: owns the connection, runs
            ``pipeline_depth`` lanes over it, and on failure re-pools are
            already done lane-side — it just counts the failure, backs
            off (capped exponential + jitter), reconnects, and respawns
            the lanes."""
            name = self.replicas[i].name
            failures = 0
            try:
                while True:
                    async with lock:
                        if sched.finished:
                            return
                    conn = self._make_conn(self.replicas[i])
                    conn_of[i] = conn
                    lanes = [asyncio.ensure_future(pipe_lane(i, conn))
                             for _ in range(self.pipeline_depth)]
                    try:
                        outcomes = await asyncio.gather(
                            *lanes, return_exceptions=True)
                    finally:
                        for t in lanes:
                            t.cancel()
                        await asyncio.gather(*lanes, return_exceptions=True)
                        await conn.close()
                        for sample in conn.take_rtt_samples():
                            sched.observe_rtt(i, sample)
                    fatal = [o for o in outcomes
                             if isinstance(o, BaseException)]
                    if fatal:
                        raise fatal[0]
                    if "corrupt-dead" in outcomes:
                        # retired for integrity (already marked failed)
                        return
                    if "broken" not in outcomes:
                        return
                    if i in hedge_broke:
                        # the break was a deliberate hedge cancellation,
                        # not a replica failure: reconnect straight away
                        # without charging the failure budget
                        hedge_broke.discard(i)
                        continue
                    failures += 1
                    if failures >= self.max_failures:
                        sched.mark_failed(i)
                        return
                    sched.on_retry(i)
                    self._on_retry(name)
                    if self.retry_after > 0:
                        # capped exponential backoff with ±50% jitter:
                        # repeated failures probe ever less often, and
                        # decorrelated delays keep N clients' reconnect
                        # storms from synchronizing on a recovering mirror
                        delay = min(self.retry_after * (2 ** (failures - 1)),
                                    self.retry_backoff_cap)
                        delay *= 0.5 + self._rng.random()
                        await asyncio.sleep(delay)
            finally:
                # parked peers key takeability off the live-replica set —
                # they must recheck when it shrinks, and a dead peer's
                # advertisement no longer counts toward the union
                async with lock:
                    sched.on_replica_death(i)
                    cond.notify_all()

        async def _refresh_coverage(j: int) -> None:
            """Background poller for partial mirror ``j``: HEAD its
            advertisement every ``coverage_refresh_s`` on a throwaway
            connection (never the worker's data connection — a poll must
            not serialize behind a streaming body) and publish changes
            under the lock.  A missing header on a 200 means the peer now
            serves the whole window; 404/410 (the peer unbound its
            buffer) clears its coverage so nothing new is packed onto
            it."""
            rep = self.replicas[j]
            while True:
                async with lock:
                    if not sched.is_alive(j) or sched.finished:
                        return
                runs = None
                conn = self._make_conn(rep)
                try:
                    code, headers = await conn.head()
                    if code == 200:
                        raw = headers.get("x-available-ranges")
                        if raw is None:
                            runs = [(0, size)]
                        else:
                            runs = []
                            for lo, hi in _parse_ranges_header(raw):
                                s_ = max(lo - offset, 0)
                                e_ = min(hi + 1 - offset, size)
                                if e_ > s_:
                                    runs.append((s_, e_))
                    elif code in (404, 410):
                        runs = []
                except (OSError, ValueError, asyncio.IncompleteReadError):
                    pass
                finally:
                    await conn.close()
                if runs is not None and runs != sched.coverage_of(j):
                    async with lock:
                        if sched.is_alive(j) \
                                and sched.on_coverage_update(j, runs):
                            cond.notify_all()
                await asyncio.sleep(refresh_s)

        workers = [asyncio.ensure_future(worker(i))
                   for i in range(len(self.replicas))]
        refreshers = [asyncio.ensure_future(_refresh_coverage(j))
                      for j in sched.partial_idx]
        clock = asyncio.ensure_future(_stall_clock()) if hedge_q else None
        try:
            await asyncio.gather(*workers)
        except BaseException:
            # a fatal error (sink raise, cancellation) must not leave
            # sibling workers streaming into the buffer after fetch()
            # has already raised — cancel and drain them first
            for t in workers:
                t.cancel()
            await asyncio.gather(*workers, return_exceptions=True)
            task = tune_state["task"]
            if task is not None and not task.done():
                task.cancel()
            if journal is not None:
                journal.sync()
            raise
        finally:
            for t in refreshers:
                t.cancel()
            if refreshers:
                await asyncio.gather(*refreshers, return_exceptions=True)
            if clock is not None:
                clock.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await clock
        t_end = time.monotonic()
        # settle an in-flight tuner update BEFORE any raise, so no task
        # outlives the event loop: drain it on success (its adoption
        # isn't lost; transfer time excludes it), cancel it on failure
        task = tune_state["task"]
        if task is not None and not task.done():
            if sched.done_bytes == size:
                await task
            else:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
        if journal is not None:
            # everything committed so far is durable before we either
            # report success or raise (an incomplete transfer's journal
            # is exactly what the resume path replays)
            journal.sync()
        failed = _failed_names()
        if sched.done_bytes != size:
            raise TransferIncompleteError(
                f"transfer incomplete: {sched.done_bytes}/{size} bytes "
                f"(failed replicas: {failed})",
                done_bytes=sched.done_bytes, expected_bytes=size,
                failed_replicas=failed)
        if retunes > 0:
            # adaptation persists: the next fetch starts from the tuned
            # geometry instead of re-learning from the defaults.  Guarded
            # on actual adoptions — a tuner that never fired must not pin
            # this transfer's size-derived defaults onto future ones.
            self._params_arg = sched.params
        # per-index scheduler counters fold into the report's name-keyed
        # dicts (duplicate names aggregate, as they always did)
        bytes_per = {r.name: 0 for r in self.replicas}
        reqs_per = {r.name: 0 for r in self.replicas}
        retries_per = {r.name: 0 for r in self.replicas}
        corrupt_per = {r.name: 0 for r in self.replicas}
        for i, r in enumerate(self.replicas):
            bytes_per[r.name] += sched.bytes_per[i]
            reqs_per[r.name] += sched.reqs_per[i]
            retries_per[r.name] += sched.retries_per[i]
            corrupt_per[r.name] += sched.corrupt_per[i]
        report = TransferReport(
            total_bytes=size, elapsed=t_end - t0,
            bytes_per_replica=bytes_per, requests_per_replica=reqs_per,
            failed_replicas=failed, refetched_ranges=sched.refetched,
            retunes=retunes,
            observed_throughputs={
                r.name: float(est[i].value)
                for i, r in enumerate(self.replicas)
            },
            observed_rtts={
                r.name: float(sched.rtt_min[i])
                for i, r in enumerate(self.replicas)
            },
            retries_per_replica=retries_per,
            corrupt_ranges=corrupt_per,
            resumed_bytes=resumed_bytes,
            resume_verify_seconds=resume_verify,
            hedges_issued=sched.hedges_issued,
            hedges_won=sched.hedges_won,
            hedge_wasted_bytes=sched.hedge_wasted,
        )
        self.last_report = report
        return buf, report

    async def blob_size(self) -> int:
        """HEAD the first healthy replica for the blob size."""
        for r in self.replicas:
            conn = _Conn(r, read_timeout=self.read_timeout)
            try:
                code, headers = await conn.head()
                if code == 200:
                    return int(headers["content-length"])
            except (OSError, ValueError, KeyError):
                continue
            finally:
                await conn.close()
        raise IOError("no replica answered HEAD")


def fetch_blob(replicas: Sequence[Replica], size: Optional[int] = None,
               **kw) -> tuple[bytes, TransferReport]:
    """Synchronous convenience wrapper."""
    client = MDTPClient(replicas, **kw)

    async def run():
        nonlocal size
        if size is None:
            size = await client.blob_size()
        return await client.fetch(size)

    buf, report = asyncio.run(run())
    return bytes(buf), report
