"""Discrete-event network simulator for multi-source transfers.

The paper evaluates MDTP on the FABRIC testbed (6 replicas, 1 client).  This
container has no WAN, so protocol experiments run on this simulator instead:
servers are modeled with per-request latency, piecewise-constant bandwidth
profiles (for the Fig. 4 throttling experiment), lognormal per-chunk jitter,
permanent failures, and on/off availability (for BitTorrent seeder flapping,
Fig. 2c).  The event loop is policy-agnostic: MDTP, static chunking, the
Aria2 model and the BitTorrent model all plug in through the same
``Policy`` interface, so comparisons are apples-to-apples.

Design notes
------------
* A *connection* is the schedulable agent (MDTP/static: one per server;
  Aria2: ``max_connections`` roaming connections; BitTorrent: one per
  seeder).  When a connection becomes free the policy is asked for its next
  action: request a byte range from some server, sleep, or finish.
* Byte ranges are handed out by ``TransferState`` from a global cursor plus
  a reclaim pool.  If a server dies or flaps mid-chunk, the undelivered tail
  of its range goes back to the pool and is re-issued later — each byte is
  *delivered* exactly once, and (for MDTP/static) *requested* exactly once
  unless a failure forces a re-issue.  This is the fault-tolerance behavior
  the framework's checkpoint-restore path relies on.
* Time is float seconds.  Determinism: all randomness flows from one
  ``numpy.random.Generator`` seeded by the caller.
* This simulator is the byte-exact REFERENCE the on-device engines
  are cross-checked against (``repro_torch.core.torch_sim``: event core to
  float tolerance, round-synchronous core within 2% on the Fig. 2/3 suite).

This is the port's own copy of ``repro.core.simulator``: the port imports nothing
of the reference package.
"""

from __future__ import annotations

import bisect
import heapq
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np

__all__ = [
    "ServerSpec",
    "Request",
    "Wait",
    "Policy",
    "ChunkRecord",
    "TransferState",
    "SimResult",
    "simulate",
]

_INF = float("inf")
#: MTU-sized payload used to convert bytes to a packet count (Fig. 5b).
_PACKET_PAYLOAD = 1448


@dataclass(frozen=True)
class ServerSpec:
    """Static description of one replica server.

    Attributes:
      name: label used in results.
      bandwidth: steady-state bytes/second at t=0.
      rtt: request round-trip overhead in seconds (one idle RTT between a
        request being issued on a persistent session and first byte).
      connect_latency: one-time session-establishment latency.
      profile: piecewise bandwidth changes, ``((t, new_bw), ...)`` sorted by
        time — models the Fig. 4 throttling experiment.
      jitter: sigma of a mean-1 lognormal factor applied per chunk.
      fail_at: server dies permanently at this time (fault-tolerance tests).
      avail_up / avail_down: mean up/down durations of an on/off Markov
        availability process (BitTorrent seeders, Fig. 2c).  ``avail_up <=
        0`` means always up.
      loss_rate: per-chunk probability the connection is cut mid-body: a
        uniform fraction of the chunk arrives (taking the time those bytes
        take), the tail is reclaimed and re-issued.  Models flaky paths /
        resets without taking the whole server down.
      corruption_rate: per-chunk probability the body arrives complete but
        fails integrity verification — full transfer time is paid, zero
        bytes are credited, and the whole range is re-issued.  Mirrors the
        real client's CRC verify-and-re-pool path.  Both fault draws
        consume RNG only when their rate is nonzero, so fault-free
        scenarios replay the exact seeded event streams of earlier builds.
      degrade_at / degrade_factor: gray failure — at ``degrade_at`` the
        server silently degrades to ``degrade_factor`` of its (possibly
        profiled) bandwidth and stays there.  Unlike ``fail_at`` the
        connection never breaks: the client sees a healthy but slow
        mirror, the case hedged endgame + probation exist for (the
        paper's "bandwidth decrease to the fastest server" experiment).
    """

    name: str
    bandwidth: float
    rtt: float = 0.03
    connect_latency: float = 0.0
    profile: tuple[tuple[float, float], ...] = ()
    jitter: float = 0.0
    fail_at: float = _INF
    avail_up: float = 0.0
    avail_down: float = 0.0
    loss_rate: float = 0.0
    corruption_rate: float = 0.0
    degrade_at: float = _INF
    degrade_factor: float = 1.0

    def bandwidth_at(self, t: float) -> float:
        bw = self.bandwidth
        for start, new_bw in self.profile:
            if t >= start:
                bw = new_bw
            else:
                break
        if t >= self.degrade_at:
            bw *= self.degrade_factor
        return bw

    def rate_boundaries(self) -> list[float]:
        bounds = [start for start, _ in self.profile]
        if self.degrade_at < _INF and self.degrade_factor != 1.0:
            bisect.insort(bounds, self.degrade_at)
        return bounds


@dataclass(frozen=True)
class Request:
    """Policy action: fetch ``size`` bytes from ``server``."""

    server: int
    size: int


@dataclass(frozen=True)
class Wait:
    """Policy action: go idle and ask again at time ``until``."""

    until: float


Action = Union[Request, Wait, None]


class Policy:
    """Scheduling policy driving one multi-source transfer."""

    #: human-readable protocol name for results tables.
    name: str = "policy"

    def n_connections(self, n_servers: int) -> int:
        return n_servers

    def reset(self, n_servers: int, file_size: int) -> None:
        raise NotImplementedError

    def next_action(self, state: "TransferState", conn: int, now: float) -> Action:
        """Called when connection ``conn`` is free.  Must not allocate ranges
        itself — return a ``Request`` and the event loop allocates."""
        raise NotImplementedError

    def on_complete(
        self, state: "TransferState", conn: int, server: int,
        nbytes: int, elapsed: float, now: float, truncated: bool = False,
    ) -> None:
        """Observation hook after a chunk finishes.

        ``truncated=True`` (or ``nbytes == 0``) signals the server went down
        mid-chunk — the client sees a broken connection.  The undelivered
        tail has already been reclaimed into the range pool.
        """


@dataclass
class ChunkRecord:
    conn: int
    server: int
    start: int
    length: int          # bytes actually delivered
    requested: int       # bytes requested (== length unless truncated)
    t_request: float
    t_complete: float
    truncated: bool = False

    @property
    def elapsed(self) -> float:
        return self.t_complete - self.t_request


class TransferState:
    """Client-side byte-range bookkeeping shared with the policies."""

    def __init__(self, file_size: int, n_servers: int):
        self.file_size = int(file_size)
        self.n_servers = n_servers
        self._cursor = 0
        self._pool: list[tuple[int, int]] = []  # reclaimed (start, length)
        self.bytes_per_server = [0] * n_servers
        self.requests_per_server = [0] * n_servers
        self.chunks: list[ChunkRecord] = []

    # -- range allocation ---------------------------------------------------
    def unassigned_bytes(self) -> int:
        return (self.file_size - self._cursor) + sum(l for _, l in self._pool)

    def delivered_bytes(self) -> int:
        return sum(self.bytes_per_server)

    def allocate(self, nbytes: int) -> tuple[int, int]:
        """Hand out one contiguous range of at most ``nbytes``.

        Reclaimed ranges are drained before fresh cursor bytes so failed
        chunks are retried promptly.  Returns ``(start, length)``;
        ``length == 0`` when nothing is left.

        The pool is a min-heap keyed on range start (ranges never overlap),
        so drain/return are O(log P) instead of the O(P log P) of a sorted
        list rebuilt on every reclaim.
        """
        if nbytes <= 0:
            return (self._cursor, 0)
        if self._pool:
            start, length = self._pool[0]
            take = min(length, nbytes)
            if take == length:
                heapq.heappop(self._pool)
            else:
                # shrunk head keeps its heap position (start only grows)
                heapq.heapreplace(self._pool, (start + take, length - take))
            return (start, take)
        take = min(nbytes, self.file_size - self._cursor)
        start = self._cursor
        self._cursor += take
        return (start, take)

    def reclaim(self, start: int, length: int) -> None:
        """Return an undelivered sub-range to the pool (failure path)."""
        if length > 0:
            heapq.heappush(self._pool, (start, length))

    # -- results ------------------------------------------------------------
    def record(self, rec: ChunkRecord) -> None:
        self.chunks.append(rec)
        if rec.length > 0:
            self.bytes_per_server[rec.server] += rec.length
        self.requests_per_server[rec.server] += 1


@dataclass
class SimResult:
    policy: str
    total_time: float
    file_size: int
    chunks: list[ChunkRecord]
    bytes_per_server: list[int]
    requests_per_server: list[int]
    server_names: list[str]

    @property
    def n_servers(self) -> int:
        return len(self.bytes_per_server)

    @property
    def throughput(self) -> float:
        return self.file_size / self.total_time if self.total_time > 0 else 0.0

    def utilization(self, min_frac: float = 0.0) -> float:
        """Fraction of replicas that delivered data (paper Fig. 5a).

        ``min_frac`` is a de-minimis cut: a replica counts as *used* only if
        it delivered more than ``min_frac * file_size``.  The paper's Aria2
        measurement (83%: 5 of 6) reflects steady-state participation; our
        Aria2 model probes every mirror once before parking the slowest, so
        benchmarks apply ``min_frac=0.01`` and report it.
        """
        cut = min_frac * self.file_size
        used = sum(1 for b in self.bytes_per_server if b > cut)
        return used / self.n_servers

    @property
    def packets_per_server(self) -> list[int]:
        """MTU-payload packet counts per replica (paper Fig. 5b proxy)."""
        return [int(math.ceil(b / _PACKET_PAYLOAD)) for b in self.bytes_per_server]

    def request_sizes(self, server: int) -> list[int]:
        return [c.requested for c in self.chunks if c.server == server and c.length > 0]

    def completion_spread(self) -> float:
        """Gap between the first and last server to finish its final chunk.

        The paper's bin-packing goal is that every round (and in particular
        the last one) completes "around the same time" — this is the
        straggler metric for that claim.
        """
        last = {}
        for c in self.chunks:
            if c.length > 0:
                last[c.server] = max(last.get(c.server, 0.0), c.t_complete)
        if not last:
            return 0.0
        return max(last.values()) - min(last.values())

    def check_integrity(self) -> None:
        """Every byte delivered exactly once, covering [0, file_size)."""
        ivals = sorted(
            (c.start, c.start + c.length) for c in self.chunks if c.length > 0
        )
        pos = 0
        for s, e in ivals:
            if s != pos:
                raise AssertionError(f"gap/overlap at byte {pos}: next range starts {s}")
            pos = e
        if pos != self.file_size:
            raise AssertionError(f"covered {pos} of {self.file_size} bytes")


class _ServerRuntime:
    """Per-server dynamic state: availability intervals and failure.

    Downtime intervals are merged into a disjoint sorted list and the
    bandwidth profile flattened into parallel arrays at construction, so
    the per-segment lookups inside ``transfer`` are ``bisect`` O(log K)
    instead of linear scans — these run once per rate/availability segment
    of every chunk, the hottest loop of the Python simulator.
    """

    def __init__(self, spec: ServerSpec, rng: np.random.Generator, horizon: float):
        self.spec = spec
        down: list[tuple[float, float]] = []
        if spec.fail_at < _INF:
            down.append((spec.fail_at, _INF))
        if spec.avail_up > 0.0 and spec.avail_down > 0.0:
            t = float(rng.exponential(spec.avail_up))
            while t < horizon:
                d = float(rng.exponential(spec.avail_down))
                down.append((t, t + d))
                t += d + float(rng.exponential(spec.avail_up))
        down.sort()
        # Merge overlaps (fail_at can overlap a flap) — disjoint intervals
        # make the bisect lookups exact.
        merged: list[tuple[float, float]] = []
        for s, e in down:
            if merged and s <= merged[-1][1]:
                prev_s, prev_e = merged[-1]
                merged[-1] = (prev_s, max(prev_e, e))
            else:
                merged.append((s, e))
        self.down = merged
        self._down_starts = [s for s, _ in merged]
        self._down_ends = [e for _, e in merged]
        #: rate at t = _rates[bisect_right(_rate_times, t)]
        times = [start for start, _ in spec.profile]
        rates = [spec.bandwidth] + [bw for _, bw in spec.profile]
        if spec.degrade_at < _INF and spec.degrade_factor != 1.0:
            # fold gray degradation into the flattened rate function:
            # every segment at or after degrade_at is scaled down
            i = bisect.bisect_right(times, spec.degrade_at)
            times = times[:i] + [spec.degrade_at] + times[i:]
            rates = (rates[:i + 1]
                     + [r * spec.degrade_factor for r in rates[i:]])
        self._rate_times = times
        self._rates = rates

    def is_up(self, t: float) -> bool:
        return self.next_downtime_covering(t) is None

    def next_downtime_covering(self, t: float) -> Optional[tuple[float, float]]:
        i = bisect.bisect_right(self._down_starts, t) - 1
        if i >= 0 and self._down_ends[i] > t:
            return self.down[i]
        return None

    def next_down_after(self, t: float) -> float:
        i = bisect.bisect_right(self._down_ends, t)
        if i < len(self.down):
            return max(self._down_starts[i], t)
        return _INF

    def next_up_time(self, t: float) -> float:
        cov = self.next_downtime_covering(t)
        return cov[1] if cov else t

    def bandwidth_at(self, t: float) -> float:
        return self._rates[bisect.bisect_right(self._rate_times, t)]

    def next_rate_boundary(self, t: float) -> float:
        j = bisect.bisect_right(self._rate_times, t)
        return self._rate_times[j] if j < len(self._rate_times) else _INF

    def transfer(
        self, t0: float, nbytes: int, rng: np.random.Generator, first_use: bool
    ) -> tuple[float, int]:
        """Simulate fetching ``nbytes`` starting with a request at ``t0``.

        Returns ``(t_finish, delivered)``.  ``delivered < nbytes`` iff the
        server went down mid-transfer, the connection was cut by an
        injected loss, or the body failed verification (``delivered == 0``
        with full time paid); the caller reclaims the undelivered tail.
        """
        spec = self.spec
        # Fault predraws — each guarded by its own rate so fault-free
        # specs consume no extra RNG and replay historical streams.
        lost_after = None
        if spec.loss_rate > 0.0 and rng.random() < spec.loss_rate:
            lost_after = int(rng.random() * nbytes)  # bytes that make it
        corrupt = False
        if spec.corruption_rate > 0.0:
            corrupt = lost_after is None and rng.random() < spec.corruption_rate
        scale = 1.0
        if spec.jitter > 0.0:
            # mean-1 lognormal so calibration is unbiased.
            scale = float(
                rng.lognormal(mean=-0.5 * spec.jitter**2, sigma=spec.jitter)
            )
        t = t0 + spec.rtt + (spec.connect_latency if first_use else 0.0)
        if lost_after is not None:
            # Walk the rate/availability segments only up to the cut point:
            # the client sees a clean partial body then a dead socket.
            t_cut, got = self._walk(t, lost_after, scale)
            return (t_cut, got)
        t_fin, delivered = self._walk(t, nbytes, scale)
        if corrupt and delivered == nbytes:
            # Full time burned, nothing trustworthy landed: the client's
            # checksum rejects the body and re-pools the whole range.
            return (t_fin, 0)
        return (t_fin, delivered)

    def _walk(
        self, t: float, nbytes: int, scale: float
    ) -> tuple[float, int]:
        """Advance through rate/availability segments delivering up to
        ``nbytes`` from time ``t`` (first-byte time, post-RTT)."""
        remaining = float(nbytes)
        while remaining > 0.0:
            down = self.next_downtime_covering(t)
            if down is not None:
                return (t, nbytes - int(round(remaining)))
            rate = self.bandwidth_at(t) * scale
            if rate <= 0.0:
                return (t, nbytes - int(round(remaining)))
            # Next moment the rate function or availability changes.
            horizon = min(self.next_rate_boundary(t), self.next_down_after(t))
            dt_need = remaining / rate
            if t + dt_need <= horizon:
                return (t + dt_need, nbytes)
            delivered_now = rate * (horizon - t)
            remaining -= delivered_now
            t = horizon
        return (t, nbytes)


def simulate(
    policy: Policy,
    servers: Sequence[ServerSpec],
    file_size: int,
    seed: int = 0,
    horizon: float = 36_000.0,
) -> SimResult:
    """Run one transfer to completion under ``policy``.

    Raises ``RuntimeError`` if the transfer cannot complete (e.g. every
    server permanently failed with bytes still owed).
    """
    rng = np.random.default_rng(seed)
    n = len(servers)
    runtimes = [_ServerRuntime(s, rng, horizon) for s in servers]
    state = TransferState(file_size, n)
    policy.reset(n, file_size)
    n_conns = policy.n_connections(n)

    # Event heap: (time, tiebreak, kind, conn, payload)
    events: list[tuple] = []
    seq = 0
    first_use = [True] * n
    outstanding = 0
    idle_conns: set[int] = set()

    def dispatch(conn: int, now: float) -> None:
        nonlocal seq, outstanding
        action = policy.next_action(state, conn, now)
        if action is None:
            idle_conns.add(conn)
            return
        if isinstance(action, Wait):
            until = max(action.until, now + 1e-9)
            heapq.heappush(events, (until, seq, "wake", conn, None))
            seq += 1
            outstanding += 1
            return
        assert isinstance(action, Request)
        start, length = state.allocate(action.size)
        if length == 0:
            idle_conns.add(conn)
            return
        srv = runtimes[action.server]
        fin, delivered = srv.transfer(now, length, rng, first_use[action.server])
        first_use[action.server] = False
        heapq.heappush(
            events,
            (fin, seq, "complete", conn,
             (action.server, start, length, delivered, now)),
        )
        seq += 1
        outstanding += 1

    t_now = 0.0
    for conn in range(n_conns):
        dispatch(conn, 0.0)

    t_last_byte = 0.0
    while events:
        t_now, _, kind, conn, payload = heapq.heappop(events)
        outstanding -= 1
        if t_now > horizon:
            raise RuntimeError(
                f"{policy.name}: exceeded horizon {horizon}s "
                f"({state.delivered_bytes()}/{file_size} bytes)"
            )
        if kind == "wake":
            dispatch(conn, t_now)
            continue
        server, start, length, delivered, t_req = payload
        truncated = delivered < length
        if truncated:
            state.reclaim(start + delivered, length - delivered)
        rec = ChunkRecord(
            conn=conn, server=server, start=start, length=delivered,
            requested=length, t_request=t_req, t_complete=t_now,
            truncated=truncated,
        )
        state.record(rec)
        if delivered > 0:
            t_last_byte = max(t_last_byte, t_now)
        policy.on_complete(
            state, conn, server, delivered, t_now - t_req, t_now,
            truncated=truncated,
        )
        # A completion may unblock idle connections (e.g. a reclaimed range
        # appeared, or endgame work-stealing) — re-poll them.
        woken = list(idle_conns)
        idle_conns.clear()
        dispatch(conn, t_now)
        for c in woken:
            if c != conn:
                dispatch(c, t_now)

    if state.delivered_bytes() != file_size:
        raise RuntimeError(
            f"{policy.name}: transfer stalled at "
            f"{state.delivered_bytes()}/{file_size} bytes (all connections idle)"
        )

    return SimResult(
        policy=policy.name,
        total_time=t_last_byte,
        file_size=file_size,
        chunks=state.chunks,
        bytes_per_server=state.bytes_per_server,
        requests_per_server=state.requests_per_server,
        server_names=[s.name for s in servers],
    )
