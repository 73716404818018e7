"""The sans-I/O chunk-scheduling core of MDTP.

:class:`ChunkScheduler` is the allocator brain extracted whole from
``MDTPClient.fetch``: the fresh-byte frontier with stripe rotation, the
reclaimed-range min-heap with per-replica ban sets, coverage-constrained
packing onto partial mirrors with the origin-offload pass, the hedged
endgame (eligibility, waste budget, settled-range healing), and the
give-up rule for uncoverable tails.  It is a plain synchronous state
machine: no sockets, no event loop, no JAX — ``tools/layercheck.py``
enforces that transitively.  Transports drive it through explicit
events:

* ``next_want`` / ``on_assign`` — size and claim the next sub-range for
  a replica (the allocator's bin-packing step),
* ``on_commit`` / ``on_corrupt`` / ``on_reclaim`` — resolve an owed
  range (landed clean, landed corrupt, or returned by a failure),
* ``pick_hedge`` / ``on_hedge_issue`` / ``on_hedge_result`` /
  ``on_hedge_abandon`` / ``on_hedge_corrupt`` — the endgame race,
* ``on_coverage_update`` / ``on_replica_death`` — mirror advertisement
  and liveness changes,
* ``observe_rtt`` / ``observe_latency`` / ``add_stall`` — telemetry.

Time is injected (``clock=``), so simulators and tests replay recorded
timelines exactly.  The event-loop client calls every method under its
own lock; the scheduler itself does no synchronization.

Decision methods return small result tuples describing the I/O the
transport must perform (heal these winner bytes back over a losing
landing, abort that replica's duplicate connection, wake parked lanes)
— the scheduler decides, the transport acts.

Pass ``trace=[]`` to record every event (name, clock, args, normalized
result); :func:`replay` re-drives a recorded trace through a fresh
scheduler and reports any decision divergence — the parity harness in
``tests/test_sched.py`` uses it to prove the socket client and the bare
state machine share one brain.
"""

from __future__ import annotations

import bisect
import heapq
import time
from typing import NamedTuple, Optional, Sequence

from repro_torch.core.chunking import ChunkParams, next_chunk_size
from repro_torch.transfer.journal import uncovered_intervals

from . import defaults

__all__ = [
    "Assignment", "ChunkScheduler", "CommitResult", "CorruptResult",
    "HedgeResult", "ReclaimResult", "cov_contains", "cov_first_in",
    "cov_first_out", "cov_run_at", "replay",
]


# -- coverage-run helpers -------------------------------------------------
# ``runs`` is sorted disjoint (start, end) pairs.  These are the packing
# primitives shared by the draw path, the hedge eligibility check, and
# the give-up rule.

def cov_run_at(runs: list, pos: int) -> Optional[tuple]:
    """The (start, end) run containing ``pos``, or None."""
    k = bisect.bisect_right(runs, (pos, 1 << 62)) - 1
    if k >= 0 and runs[k][0] <= pos < runs[k][1]:
        return runs[k]
    return None


def cov_contains(runs: list, s: int, e: int) -> bool:
    """Does one run cover ``[s, e)`` entirely?"""
    got = cov_run_at(runs, s)
    return got is not None and got[1] >= e


def cov_first_in(runs: list, s: int, e: int) -> Optional[tuple]:
    """First sub-span of ``[s, e)`` INSIDE the runs, or None."""
    got = cov_run_at(runs, s)
    if got is not None:
        return s, min(e, got[1])
    k = bisect.bisect_left(runs, (s, s))
    if k < len(runs) and runs[k][0] < e:
        return runs[k][0], min(e, runs[k][1])
    return None


def cov_first_out(runs: list, s: int, e: int) -> Optional[tuple]:
    """First sub-span of ``[s, e)`` OUTSIDE the runs, or None."""
    at = s
    while at < e:
        got = cov_run_at(runs, at)
        if got is None:
            k = bisect.bisect_left(runs, (at, at))
            nxt = runs[k][0] if k < len(runs) else e
            return at, min(e, nxt)
        at = got[1]
    return None


# -- event results --------------------------------------------------------

class Assignment(NamedTuple):
    """A claimed sub-range: fetch ``[start, start + length)``.

    ``progress`` is a live ``[bytes_landed, wire_send_time]`` list the
    transport updates as the body streams — the hedge trigger reads it.
    """
    start: int
    length: int
    ban: frozenset
    progress: list


class CommitResult(NamedTuple):
    """Outcome of a clean owner landing.  ``settled_won``: a hedge beat
    this body — count nothing, write ``heal`` back over the landing.
    ``cancel_hedger``: replica index whose in-flight duplicate of this
    range should be aborted.  ``wake``: wake parked lanes."""
    settled_won: bool
    heal: Optional[bytes]
    cancel_hedger: Optional[int]
    wake: bool


class CorruptResult(NamedTuple):
    """Outcome of a corrupt owner landing (range re-pooled, banned for
    the offender).  ``dead``: the offender crossed the corruption cap
    and was retired."""
    dead: bool
    heal: Optional[bytes]
    cancel_hedger: Optional[int]


class ReclaimResult(NamedTuple):
    """Outcome of returning an owed range after a failure.  ``settled``:
    a winning hedge already delivered it — nothing re-pooled."""
    settled: bool
    heal: Optional[bytes]
    cancel_hedger: Optional[int]


class HedgeResult(NamedTuple):
    """Outcome of a completed hedge body: ``won`` means the duplicate
    settled the range and ``cancel_owner`` (the losing owner's index)
    should have its connection aborted."""
    won: bool
    cancel_owner: Optional[int]


class ChunkScheduler:
    """Pure decision state for one window of ``size`` bytes.

    ``mirrors[i]`` flags replica ``i`` as a partial peer mirror (packed
    only where its advertised coverage allows); full replicas pass
    False.  ``hedge_quantile`` of 0 disables the endgame race entirely
    (the in-flight ``outstanding`` map is then not maintained).

    All byte positions are window-relative; the transport applies its
    own absolute offset on the wire.
    """

    def __init__(self, size: int, mirrors: Sequence[bool], *,
                 params: Optional[ChunkParams] = None,
                 depth: int = defaults.PIPELINE_DEPTH,
                 hedge_quantile: float = 0.0,
                 hedge_waste_frac: float = defaults.HEDGE_WASTE_FRAC,
                 default_rtt: float = defaults.DEFAULT_RTT,
                 max_failures: int = 3,
                 coverage_refresh_s: float = 0.05,
                 stripe: Optional[tuple] = None,
                 clock=None, trace: Optional[list] = None):
        self.size = int(size)
        self.n = len(mirrors)
        self.params = params
        self.depth = int(depth)
        self.hedge_quantile = float(hedge_quantile)
        self.hedge_waste_frac = float(hedge_waste_frac)
        self.default_rtt = float(default_rtt)
        self.max_failures = int(max_failures)
        self.refresh_s = max(float(coverage_refresh_s), 0.005)
        self.cov_patience = max(1.0, 10.0 * self.refresh_s)
        self._clock = clock if clock is not None else time.monotonic
        self.trace = trace

        size = self.size
        # fresh-byte frontier: never-assigned (start, end) segments;
        # ``stripe=(k, n)`` rotates the walk to start at size*k//n.
        self.segs: list = [(0, size)] if size > 0 else []
        if stripe is not None and size > 0:
            k_, n_ = stripe
            p = (size * (k_ % max(int(n_), 1))) // max(int(n_), 1)
            if 0 < p < size:
                self.segs = [(p, size), (0, p)]
        self.fresh = sum(e_ - s_ for s_, e_ in self.segs)
        # reclaimed (start, len, banned) min-heap; ranges never overlap
        # so comparisons never reach the non-orderable ban frozenset.
        self.pool: list = []
        self.pooled = 0
        self.inflight = 0
        self.done_bytes = 0
        self.resumed_bytes = 0
        self.refetched = 0
        self.alive: set = set(range(self.n))
        self.failed: list = []          # replica indices, append order
        self._failed_set: set = set()
        self.bytes_per = [0] * self.n
        self.reqs_per = [0] * self.n
        self.retries_per = [0] * self.n
        self.corrupt_per = [0] * self.n
        self.rtt_min = [0.0] * self.n   # 0 = no sample yet
        # -- partial-mirror coverage --------------------------------------
        #: index -> window-relative sorted disjoint (start, end) runs;
        #: None = full replica.  Mirrors start EMPTY until advertised.
        self.avail: list = [([] if m else None) for m in mirrors]
        self.partial_idx = [j for j, m in enumerate(mirrors) if m]
        self.cov_union: list = []
        self.cov_stamp = self._clock()
        # -- hedged endgame ----------------------------------------------
        self.lat_ewma = [0.0] * self.n  # per-byte receive latency EWMA
        self.last_done = [0.0] * self.n
        self.last_done_stall = [0.0] * self.n
        self.stall = 0.0                # accumulated scheduler-stall time
        #: start -> (length, owner, ban, progress, stall_at); maintained
        #: only while hedging is enabled.
        self.outstanding: dict = {}
        self.hedged: dict = {}          # start -> (length, hedger)
        self.settled: set = set()
        self.settled_data: dict = {}
        self.hedges_issued = 0
        self.hedges_won = 0
        self.hedge_wasted = 0
        self._rec("init", self._clock(), (), None)

    # -- recording --------------------------------------------------------

    def _rec(self, name, now, args, result):
        if self.trace is not None:
            self.trace.append((name, now, args, result))
        return result

    # -- plain state views ------------------------------------------------

    @property
    def remaining(self) -> int:
        """Unassigned bytes (fresh frontier + reclaimed pool)."""
        return self.fresh + self.pooled

    @property
    def finished(self) -> bool:
        """No unassigned work and nothing on the wire."""
        return self.remaining <= 0 and self.inflight <= 0

    def is_alive(self, i: int) -> bool:
        return i in self.alive

    def is_failed(self, i: int) -> bool:
        return i in self._failed_set

    def coverage_of(self, j: int):
        return self.avail[j]

    # -- configuration events --------------------------------------------

    def adopt_params(self, params: ChunkParams) -> None:
        """Switch chunk geometry mid-transfer (a retune landing)."""
        self.params = params
        self._rec("adopt_params", self._clock(), (params,), None)

    def seed_resume(self, covered: list) -> int:
        """Credit already-verified coverage (sorted disjoint
        ``(start, nbytes)`` pairs): uncovered gaps go to the pool, the
        fresh frontier is dropped, and the covered bytes count done.
        Returns the resumed byte count."""
        for s_, n_ in uncovered_intervals(covered, self.size):
            heapq.heappush(self.pool, (s_, n_, frozenset()))
            self.pooled += n_
        self.segs.clear()
        self.fresh = 0
        self.resumed_bytes = self.size - self.pooled
        self.done_bytes = self.resumed_bytes
        return self._rec("seed_resume", self._clock(), (tuple(covered),),
                         self.resumed_bytes)

    # -- telemetry events -------------------------------------------------

    def observe_rtt(self, i: int, sample: float) -> None:
        if sample > 0.0:
            self.rtt_min[i] = (sample if self.rtt_min[i] <= 0.0
                               else min(self.rtt_min[i], sample))
        self._rec("observe_rtt", self._clock(), (i, sample), None)

    def observe_latency(self, i: int, ndata: int, elapsed: float) -> None:
        """Feed the straggler signal: per-byte latency EWMA plus the
        last-completion stamp (the wedge signal)."""
        now = self._clock()
        if ndata > 0 and elapsed > 0.0:
            self.last_done[i] = now
            self.last_done_stall[i] = self.stall
            pb = elapsed / ndata
            self.lat_ewma[i] = pb if self.lat_ewma[i] <= 0.0 \
                else 0.5 * self.lat_ewma[i] + 0.5 * pb
        self._rec("observe_latency", now, (i, ndata, elapsed), None)

    def add_stall(self, seconds: float) -> None:
        """Charge scheduler-stall time: the host starved every lane at
        once, so in-flight ages discount it rather than hedge healthy
        owners."""
        self.stall += seconds
        self._rec("add_stall", self._clock(), (seconds,), None)

    def on_retry(self, i: int) -> None:
        self.retries_per[i] += 1
        self._rec("on_retry", self._clock(), (i,), None)

    def mark_failed(self, i: int) -> None:
        """Retire replica ``i`` permanently (failure cap crossed)."""
        if i not in self._failed_set:
            self._failed_set.add(i)
            self.failed.append(i)
        self._rec("mark_failed", self._clock(), (i,), None)

    # -- liveness / coverage events --------------------------------------

    def on_replica_death(self, i: int) -> None:
        """Worker exit: parked peers key takeability off the live set,
        and a dead mirror's advertisement no longer counts."""
        now = self._clock()
        self.alive.discard(i)
        if self.avail[i] is not None:
            self.avail[i] = []
            self._recompute_union()
            self.cov_stamp = now
        self._rec("on_replica_death", now, (i,), None)

    def on_coverage_update(self, j: int, runs: list) -> bool:
        """Publish mirror ``j``'s advertised coverage (window-relative
        sorted disjoint (start, end) runs).  Returns True when it
        changed — the transport wakes parked lanes."""
        now = self._clock()
        runs = list(runs)
        changed = runs != self.avail[j]
        if changed:
            self.avail[j] = runs
            self._recompute_union()
            self.cov_stamp = now
        return self._rec("on_coverage_update", now, (j, tuple(runs)),
                         changed)

    def _recompute_union(self) -> None:
        runs = []
        for j in self.partial_idx:
            if j in self.alive:
                runs.extend(self.avail[j])
        runs.sort()
        merged: list = []
        for s_, e_ in runs:
            if merged and s_ <= merged[-1][1]:
                if e_ > merged[-1][1]:
                    merged[-1] = (merged[-1][0], e_)
            else:
                merged.append((s_, e_))
        self.cov_union[:] = merged

    # -- packing internals ------------------------------------------------

    def _capable(self, j: int, s_: int, ln_: int) -> bool:
        """Could replica ``j`` serve any part of ``[s_, s_+ln_)``?"""
        cov_j = self.avail[j]
        return cov_j is None or \
            cov_first_in(cov_j, s_, s_ + ln_) is not None

    def _ban_ok(self, i: int, s_: int, ln_: int, ban_: frozenset) -> bool:
        """May replica ``i`` take an entry tagged ``ban_``?  A banned
        replica stands aside while any OTHER live capable replica
        remains unbanned; once none does, anyone may retry (the
        re-verify catches a repeat corruption; refusing would deadlock
        the tail)."""
        if i not in ban_:
            return True
        return not any(j not in ban_ and self._capable(j, s_, ln_)
                       for j in self.alive)

    def _pick_pool_entry(self, i: int) -> Optional[int]:
        """Index of the lowest-start pool entry replica ``i`` may take.
        Linear scan: the pool holds reclaimed ranges only."""
        best = None
        for k, (s_, ln_, ban_) in enumerate(self.pool):
            if not self._ban_ok(i, s_, ln_, ban_):
                continue
            if best is None or s_ < self.pool[best][0]:
                best = k
        return best

    def _take_pool(self, k: int, at: int, take: int) -> None:
        """Claim ``[at, at+take)`` out of pool entry ``k``: un-taken
        prefix/suffix pieces keep the ban tag and return to the heap."""
        s_, ln_, ban_ = self.pool.pop(k)
        if at > s_:
            self.pool.append((s_, at - s_, ban_))
        tail = (s_ + ln_) - (at + take)
        if tail > 0:
            self.pool.append((at + take, tail, ban_))
        heapq.heapify(self.pool)
        self.pooled -= take

    def _take_seg(self, si: int, at: int, take: int) -> None:
        """Claim ``[at, at+take)`` out of frontier segment ``si``."""
        s_, e_ = self.segs[si]
        if at == s_ and at + take == e_:
            del self.segs[si]
        elif at == s_:
            self.segs[si] = (at + take, e_)
        elif at + take == e_:
            self.segs[si] = (s_, at)
        else:
            self.segs[si:si + 1] = [(s_, at), (at + take, e_)]
        self.fresh -= take

    def _past_endgame(self) -> bool:
        """Residual still ABOVE the endgame window (~ENDGAME_ROUNDS
        allocator rounds: large_chunk per live replica is one round's
        share)."""
        return self.fresh + self.pooled + self.inflight > \
            defaults.ENDGAME_ROUNDS * self.params.large_chunk \
            * max(len(self.alive), 1)

    def origin_restricted(self) -> bool:
        """Should full replicas keep off peer-covered spans right now?
        True while live peers advertise coverage AND the transfer is
        not in its endgame: every peer-covered byte the origin
        re-serves is egress the whole swarm pays for.  In the endgame
        the origin rejoins freely — an idle origin must not stretch
        the tail."""
        if not self.cov_union:
            return False
        return self._past_endgame()

    def can_draw(self, i: int) -> bool:
        """Is there ANY remaining span replica ``i`` may serve right
        now?  The park/draw gate: full replicas can take fresh bytes or
        any un-banned pool entry (uncovered-only while
        ``origin_restricted``); a partial mirror needs its advertisement
        to intersect something."""
        cov = self.avail[i]
        if cov is None:
            if self.origin_restricted():
                for s_, ln_, ban_ in self.pool:
                    if self._ban_ok(i, s_, ln_, ban_) and cov_first_out(
                            self.cov_union, s_, s_ + ln_) is not None:
                        return self._rec("can_draw", self._clock(), (i,),
                                         True)
                got = any(
                    cov_first_out(self.cov_union, s_, e_) is not None
                    for s_, e_ in self.segs)
                return self._rec("can_draw", self._clock(), (i,), got)
            got = self.fresh > 0 or (bool(self.pool)
                                     and self._pick_pool_entry(i)
                                     is not None)
            return self._rec("can_draw", self._clock(), (i,), got)
        if not cov:
            return self._rec("can_draw", self._clock(), (i,), False)
        got = False
        for s_, ln_, ban_ in self.pool:
            if self._ban_ok(i, s_, ln_, ban_) \
                    and cov_first_in(cov, s_, s_ + ln_) is not None:
                got = True
                break
        got = got or any(cov_first_in(cov, s_, e_) is not None
                         for s_, e_ in self.segs)
        return self._rec("can_draw", self._clock(), (i,), got)

    def hopeless(self) -> bool:
        """Give-up rule: every surviving source is a partial mirror,
        their joint coverage has been static for a patience window, and
        some remaining span lies outside it — those bytes can never
        arrive, so the transport should stop waiting and raise."""
        now = self._clock()
        if self.inflight > 0 or not self.partial_idx:
            return self._rec("hopeless", now, (), False)
        if any(self.avail[j] is None for j in self.alive):
            return self._rec("hopeless", now, (), False)
        if now - self.cov_stamp < self.cov_patience:
            return self._rec("hopeless", now, (), False)
        got = False
        for s_, ln_, _b in self.pool:
            if not cov_contains(self.cov_union, s_, s_ + ln_):
                got = True
                break
        got = got or any(not cov_contains(self.cov_union, s_, e_)
                         for s_, e_ in self.segs)
        return self._rec("hopeless", now, (), got)

    # -- the allocation step ----------------------------------------------

    def next_want(self, i: int, throughputs: Sequence[float]) -> int:
        """Size replica ``i``'s next draw: MDTP's adaptive chunk size
        for one round, then (depth > 1) split across lanes so the
        pipeline in aggregate holds ~two rounds' worth while the
        endgame keeps rebalancing shrinking pieces onto whoever is
        actually fast."""
        remaining = self.fresh + self.pooled
        params = self.params
        want = next_chunk_size(i, throughputs, params, remaining)
        if want > 0 and self.depth > 1:
            want = min(max(want // ((self.depth + 1) // 2),
                           params.min_chunk),
                       want, remaining)
            want = min(want, max(remaining // (2 * self.depth),
                                 params.min_chunk))
        return self._rec("next_want", self._clock(),
                         (i, tuple(float(t) for t in throughputs)), want)

    def _draw(self, i: int, want: int):
        """Pick and claim the next sub-range for replica ``i``:
        ``(start, length, ban)`` or None when nothing it may serve is
        available right now.

        Full replicas: while live peers advertise coverage, prefer
        spans NO peer holds yet (origin offload); with no peer coverage
        this reduces to the classic packing — reclaimed pool work first
        (lowest start), then the fresh frontier's head.  Partial
        mirrors: only spans their advertisement covers."""
        cov = self.avail[i]
        if cov is None:
            if self.cov_union:
                best = None
                for k, (s_, ln_, ban_) in enumerate(self.pool):
                    if not self._ban_ok(i, s_, ln_, ban_):
                        continue
                    got = cov_first_out(self.cov_union, s_, s_ + ln_)
                    if got is not None and (best is None
                                            or got[0] < best[0]):
                        best = (got[0], got[1], k, ban_)
                if best is not None:
                    at, end_, k, ban_ = best
                    take = min(end_ - at, want)
                    self._take_pool(k, at, take)
                    return at, take, ban_
                for si, (s_, e_) in enumerate(self.segs):
                    got = cov_first_out(self.cov_union, s_, e_)
                    if got is not None:
                        at, end_ = got
                        take = min(end_ - at, want)
                        self._take_seg(si, at, take)
                        return at, take, frozenset()
                if self.origin_restricted():
                    # everything left is peer-covered and the transfer
                    # isn't in its endgame: leave it to the peers
                    return None
            pick = self._pick_pool_entry(i) if self.pool else None
            if pick is not None:
                s_, ln_, ban_ = self.pool[pick]
                take = min(ln_, want)
                self._take_pool(pick, s_, take)
                return s_, take, ban_
            if self.segs:
                s_, e_ = self.segs[0]
                take = min(want, e_ - s_)
                self._take_seg(0, s_, take)
                return s_, take, frozenset()
            return None
        best = None
        for k, (s_, ln_, ban_) in enumerate(self.pool):
            if not self._ban_ok(i, s_, ln_, ban_):
                continue
            got = cov_first_in(cov, s_, s_ + ln_)
            if got is not None and (best is None or got[0] < best[0]):
                best = (got[0], got[1], k, ban_)
        if best is not None:
            at, end_, k, ban_ = best
            take = min(end_ - at, want)
            self._take_pool(k, at, take)
            return at, take, ban_
        for si, (s_, e_) in enumerate(self.segs):
            got = cov_first_in(cov, s_, e_)
            if got is not None:
                at, end_ = got
                take = min(end_ - at, want)
                self._take_seg(si, at, take)
                return at, take, frozenset()
        return None

    def on_assign(self, i: int, want: int) -> Optional[Assignment]:
        """Claim the next sub-range for replica ``i`` and count it in
        flight.  While hedging is enabled the range is tracked in
        ``outstanding`` so ``pick_hedge`` can age it."""
        drawn = self._draw(i, want)
        if drawn is None:
            self._rec("on_assign", self._clock(), (i, want), None)
            return None
        start, length, ban = drawn
        self.inflight += length
        prog = [0, 0.0]
        if self.hedge_quantile:
            self.outstanding[start] = (length, i, ban, prog, self.stall)
        self._rec("on_assign", self._clock(), (i, want),
                  (start, length, ban))
        return Assignment(start, length, ban, prog)

    # -- range resolution --------------------------------------------------

    def _heal_settled(self, start: int) -> Optional[bytes]:
        """Hand back a winning hedge's bytes so the transport can
        restore them over whatever a losing copy wrote."""
        self.settled.discard(start)
        return self.settled_data.pop(start, None)

    def on_commit(self, i: int, start: int, length: int, ban: frozenset,
                  ndata: int) -> CommitResult:
        """Replica ``i``'s body for ``[start, start+length)`` landed
        clean (``ndata`` bytes — short means truncated, the tail
        re-pools).  If a hedge already settled the range the landing is
        pure waste and the winner's bytes heal back."""
        now = self._clock()
        self.outstanding.pop(start, None)
        if start in self.settled:
            heal = self._heal_settled(start)
            self.reqs_per[i] += 1
            self.hedge_wasted += ndata
            res = CommitResult(True, heal, None, True)
            self._rec("on_commit", now, (i, start, length, ban, ndata),
                      (True, heal, None, True))
            return res
        self.bytes_per[i] += ndata
        self.reqs_per[i] += 1
        self.done_bytes += ndata
        self.inflight -= length
        # the owner landed first: a still-running duplicate can no
        # longer win the race — cancel it now rather than let a whole
        # losing body stream to completion
        h = self.hedged.get(start)
        cancel = h[1] if h is not None else None
        wake = False
        if ndata < length:
            heapq.heappush(self.pool,
                           (start + ndata, length - ndata, ban))
            self.pooled += length - ndata
            wake = True
        elif self.inflight <= 0:
            wake = True
        res = CommitResult(False, None, cancel, wake)
        self._rec("on_commit", now, (i, start, length, ban, ndata),
                  tuple(res))
        return res

    def on_corrupt(self, i: int, start: int, length: int, ban: frozenset,
                   ndata: int) -> CorruptResult:
        """Replica ``i``'s body failed verification: the bytes never
        count — the WHOLE range re-pools tagged "not this replica" so
        the packer re-fetches from an alternate mirror."""
        now = self._clock()
        self.corrupt_per[i] += 1
        dead = self.corrupt_per[i] >= self.max_failures
        self.outstanding.pop(start, None)
        heal = None
        cancel = None
        if start in self.settled:
            heal = self._heal_settled(start)
            self.hedge_wasted += ndata
        else:
            h = self.hedged.get(start)
            cancel = h[1] if h is not None else None
            heapq.heappush(self.pool, (start, length, ban | {i}))
            self.pooled += length
            self.inflight -= length
            self.refetched += 1
        if dead:
            self.mark_failed(i)
        res = CorruptResult(dead, heal, cancel)
        self._rec("on_corrupt", now, (i, start, length, ban, ndata),
                  tuple(res))
        return res

    def on_reclaim(self, start: int, length: int, ban: frozenset, *,
                   count: bool, lost: int = 0) -> ReclaimResult:
        """Return an owed range after a connection failure.  A range a
        winning hedge already settled is NOT re-pooled (its bytes are
        done); the loser's ``lost`` partial bytes charge the hedge
        waste and its zero-copy writes heal back.  A hedge still racing
        the reclaimed range is cancelled: the endgame's shrinking draws
        mean the re-pooled range usually re-enters SPLIT — a shape the
        duplicate can no longer settle."""
        now = self._clock()
        self.outstanding.pop(start, None)
        if start in self.settled:
            heal = self._heal_settled(start)
            self.hedge_wasted += min(lost, length)
            res = ReclaimResult(True, heal, None)
        else:
            h = self.hedged.get(start)
            cancel = h[1] if h is not None else None
            heapq.heappush(self.pool, (start, length, ban))
            self.pooled += length
            self.inflight -= length
            if count:
                self.refetched += 1
            res = ReclaimResult(False, None, cancel)
        self._rec("on_reclaim", now, (start, length, ban, count, lost),
                  tuple(res))
        return res

    # -- the endgame race --------------------------------------------------

    def pick_hedge(self, j: int):
        """A straggling in-flight range worth duplicating onto idle
        replica ``j``, as ``(start, length, owner, ban)``, or None.

        A candidate must be OVERDUE: aged past what its owner should
        plausibly have needed, where "should" spans the lane queue — a
        pipelined range can wait ``depth`` service times behind healthy
        siblings.  An owner whose per-byte latency EWMA sits at or
        above the ``hedge_quantile`` of the live fleet gets the lower
        bar; a healthy-looking owner must overshoot twice that AND look
        wedged (no range completed within an expected service time —
        the gray-failure shape).  Either way replica ``j`` must
        plausibly beat continuing to wait.  All ages discount measured
        scheduler stall: on a starved host every range ages at once,
        and that is evidence against the HOST, not any owner."""
        now = self._clock()
        progs = None
        if self.trace is not None:
            progs = {s_: (p_[0], p_[1]) for s_, (_l, _o, _b, p_, _s)
                     in self.outstanding.items()}

        def done(result):
            self._rec("pick_hedge", now, (j, progs), result)
            return result

        if not self.hedge_quantile or not self.outstanding:
            return done(None)
        if self._past_endgame():
            return done(None)
        if self.lat_ewma[j] <= 0.0:
            return done(None)       # no evidence j is any faster
        # waste budget: committed waste + reserved in-flight lengths.
        # The first hedge is always affordable — on a small transfer a
        # single range can exceed the fractional budget outright, and a
        # cap that can never admit ANY hedge is no cap at all.
        budget = self.hedge_waste_frac * self.size - self.hedge_wasted \
            - sum(h[0] for h in self.hedged.values())
        first_free = not self.hedged and self.hedge_wasted <= 0.0
        samples = sorted(self.lat_ewma[k] for k in self.alive
                         if self.lat_ewma[k] > 0.0)
        slow_cut = None
        if len(samples) >= 2:
            pos = self.hedge_quantile * (len(samples) - 1)
            lo = int(pos)
            hi = min(lo + 1, len(samples) - 1)
            slow_cut = samples[lo] \
                + (samples[hi] - samples[lo]) * (pos - lo)
        my_rtt = self.rtt_min[j] if self.rtt_min[j] > 0.0 \
            else self.default_rtt
        grace = defaults.OVERDUE_GRACE_POLLS * defaults.HEDGE_POLL_S
        best = None
        for s_, (ln_, owner, ban_, prog_, st_) in \
                self.outstanding.items():
            if owner == j or s_ in self.hedged or s_ in self.settled \
                    or j in ban_ or (ln_ > budget and not first_free):
                continue
            if self.avail[j] is not None and \
                    not cov_contains(self.avail[j], s_, s_ + ln_):
                # a partial mirror may only duplicate ranges its
                # advertisement covers in full
                continue
            if 2 * prog_[0] > ln_:
                # the owner already landed most of the body: cancelling
                # it would waste more bytes than the duplicate could
                # save — let the remainder trickle in
                continue
            if prog_[1] <= 0.0:
                # the request never hit the wire (still queued on a
                # slot semaphore or the byte budget): whatever delays
                # it sits upstream of the owner
                continue
            # age from the wire-send stamp, discounting scheduler stall
            # accrued since issue
            age = (now - prog_[1]) - (self.stall - st_)
            if age <= my_rtt + ln_ * self.lat_ewma[j]:
                continue            # j would not have finished it yet
            if prog_[0] > 0:
                # the owner is visibly streaming: from its observed
                # rate ON THIS RANGE, project the remainder's landing
                # time, and duplicate only when j would finish the
                # WHOLE range well before that
                rem = (ln_ - prog_[0]) * age / prog_[0]
                if rem <= 2.0 * (my_rtt + ln_ * self.lat_ewma[j]):
                    continue
            slow = slow_cut is not None \
                and self.lat_ewma[owner] >= slow_cut
            o_rtt = self.rtt_min[owner] if self.rtt_min[owner] > 0.0 \
                else self.default_rtt
            expect_owner = o_rtt + ln_ * self.lat_ewma[owner]
            # absolute grace floor: at small-chunk scale the expected
            # times are milliseconds and scheduler jitter alone would
            # look like lateness
            overdue = (self.depth + defaults.OVERDUE_DEPTH_SLACK) \
                * expect_owner + grace
            # wedge signal for healthy-LOOKING owners: a gray mirror
            # stops completing anything, while an honestly-congested
            # one keeps finishing sibling ranges
            wedged = self.last_done[owner] <= 0.0 or \
                (now - self.last_done[owner]) \
                - (self.stall - self.last_done_stall[owner]) > \
                expect_owner + grace
            if self.lat_ewma[owner] <= 0.0 \
                    or (slow and age > overdue) \
                    or (wedged and age > 2.0 * overdue):
                # cheapest insurance first: among overdue candidates
                # duplicate the SHORTEST range — a losing copy can
                # waste at most its own length
                if best is None or ln_ < best[1]:
                    best = (s_, ln_, owner, ban_)
        return done(best)

    def on_hedge_issue(self, j: int, start: int, length: int) -> None:
        """Replica ``j``'s duplicate of ``[start, start+length)`` is
        going on the wire; its length reserves waste budget."""
        self.hedged[start] = (length, j)
        self.hedges_issued += 1
        self._rec("on_hedge_issue", self._clock(), (j, start, length),
                  None)

    def on_hedge_abandon(self, start: int, wasted: int = 0) -> None:
        """The duplicate broke mid-copy (usually the owner landing
        first and cancelling the race): whatever it DID land is real
        duplicated traffic and charges the waste meter."""
        h = self.hedged.pop(start, None)
        if h is not None and wasted > 0:
            self.hedge_wasted += min(wasted, h[0])
        self._rec("on_hedge_abandon", self._clock(), (start, wasted),
                  None)

    def on_hedge_corrupt(self, j: int, start: int) -> bool:
        """The duplicate body failed verification: the range is not
        ours to re-pool — discard the copy, but the corruption still
        counts against ``j``.  Returns True when ``j`` crossed the
        corruption cap."""
        now = self._clock()
        self.hedged.pop(start, None)
        self.corrupt_per[j] += 1
        dead = self.corrupt_per[j] >= self.max_failures
        if dead:
            self.mark_failed(j)
        return self._rec("on_hedge_corrupt", now, (j, start), dead)

    def on_hedge_result(self, j: int, start: int, length: int,
                        ndata: int, body=None) -> HedgeResult:
        """The duplicate body landed clean.  It wins only if the live
        claim is still the EXACT range it duplicated: after a reclaim
        the range can re-enter the pool and be re-drawn SPLIT, and
        crediting the full hedge body against that narrower claim would
        double-count the remainder.  A win settles the range (keeping
        ``body`` so a late losing landing heals back) and cancels the
        current owner."""
        now = self._clock()
        self.hedged.pop(start, None)
        entry = self.outstanding.get(start)
        if ndata < length or start in self.settled \
                or entry is None or entry[0] != length:
            # truncated, re-split, or the owner resolved it first: the
            # duplicated body is pure waste
            self.hedge_wasted += ndata
            res = HedgeResult(False, None)
        else:
            loser = entry[1]
            self.settled.add(start)
            self.settled_data[start] = bytes(body) \
                if body is not None else b""
            self.bytes_per[j] += ndata
            self.reqs_per[j] += 1
            self.done_bytes += ndata
            self.inflight -= length
            self.hedges_won += 1
            res = HedgeResult(True, loser)
        self._rec("on_hedge_result", now,
                  (j, start, length, ndata,
                   bytes(body) if body is not None else None),
                  tuple(res))
        return res


def replay(events: list, factory) -> list:
    """Re-drive a recorded decision trace through a fresh scheduler.

    ``events`` is the ``trace`` list a recording scheduler filled;
    ``factory(clock)`` must build a scheduler configured like the
    recording one (same size/params/mirrors/…), with ``trace=None`` and
    the given clock.  Every recorded event is replayed at its recorded
    timestamp and its result compared; the return value lists the
    mismatches (empty = decision parity).
    """
    box = [0.0]
    sched = None
    mismatches: list = []
    for name, now, args, expected in events:
        box[0] = now
        if name == "init":
            sched = (factory(lambda: box[0])
                     if sched is None else sched)
            continue
        if sched is None:
            sched = factory(lambda: box[0])
        if name == "pick_hedge":
            j, progs = args
            # progress lists mutate outside the event stream (the
            # transport's body reads update them in place); the trace
            # carries a snapshot to re-apply
            for s_, (p0, p1) in (progs or {}).items():
                ent = sched.outstanding.get(s_)
                if ent is not None:
                    ent[3][0] = p0
                    ent[3][1] = p1
            got = sched.pick_hedge(j)
        elif name == "on_reclaim":
            start, length, ban, count, lost = args
            got = sched.on_reclaim(start, length, ban,
                                   count=count, lost=lost)
        else:
            got = getattr(sched, name)(*args)
        if isinstance(got, Assignment):
            got = (got.start, got.length, got.ban)
        elif isinstance(got, tuple) and type(got) is not tuple:
            got = tuple(got)
        if got != expected:
            mismatches.append(
                f"{name}{tuple(args)!r}: got {got!r}, "
                f"want {expected!r}")
    return mismatches
