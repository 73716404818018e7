"""Sharded, work-stealing restore across a K-host mesh.

Planning + theft bookkeeping are pure (stdlib only, built on the
extracted :mod:`repro_torch.transfer.sched` philosophy: decisions separate
from I/O); :func:`fetch_sharded` is the asyncio orchestration that
drives K per-host :class:`~repro_torch.transfer.client.MDTPClient` fetches
over real sockets.

The shape of the thing
----------------------
A checkpoint blob restored onto K hosts does not need every host to pull
every byte from the origin: :func:`plan_shards` splits ``[0, total)``
into K contiguous spans — snapped to manifest leaf boundaries so each
tensor lives wholly on one host — and each host fetches only its span
(``plan_for_mesh`` derives K from a mesh's axis).

Hosts serve each other while they fetch: every host mounts its filling
:class:`~repro_torch.transfer.sink.BufferSink` on a
:class:`~repro_torch.transfer.mirror.PeerMirror` and lists every other host's
mirror among its replicas, so the existing coverage-gated packing
(``X-Available-Ranges``) routes any byte a peer already holds over the
peer link instead of the origin.

**Work stealing** (the pcircle idea, translated to byte ranges): a host
that finishes its own span early asks the :class:`StealLedger` for a
sub-span of the *most backlogged* peer — the victim's uncovered tail —
and fetches those bytes through its own (fast) origin path into its own
buffer.  Its mirror then advertises them, and the victim's normal
coverage-gated fetch drains the stolen span from the fast thief instead
of the straggling origin.  The victim needs no new protocol and never
learns it was robbed; the only shared state is the in-process ledger
that keeps two thieves from claiming the same range.  Stolen bytes are
duplicated traffic by construction (thief and victim both hold them) —
the ledger accounts them as the price paid for the makespan win, and
``benchmarks/shard_bench.py`` guards that trade.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

from repro_torch.transfer.journal import uncovered_intervals

__all__ = [
    "ShardPlan", "StealLedger", "ShardFetchResult", "manifest_boundaries",
    "plan_shards", "plan_for_mesh", "plan_for_ctx", "fetch_sharded",
]


# --------------------------------------------------------------------------
# Planning (pure)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardPlan:
    """K contiguous per-host byte spans covering ``[0, total)``.

    ``spans[h]`` is host ``h``'s half-open ``(start, end)``; spans are
    ascending, disjoint, and jointly exhaustive (a host may own an empty
    span when K exceeds the snappable cut count).
    """

    total: int
    spans: tuple[tuple[int, int], ...]

    @property
    def n_hosts(self) -> int:
        return len(self.spans)

    def span_of(self, host: int) -> tuple[int, int]:
        return self.spans[host]

    def nbytes_of(self, host: int) -> int:
        s, e = self.spans[host]
        return e - s

    def host_of(self, offset: int) -> int:
        """Which host's span holds byte ``offset``."""
        for h, (s, e) in enumerate(self.spans):
            if s <= offset < e:
                return h
        raise ValueError(f"offset {offset} outside [0, {self.total})")


def manifest_boundaries(manifest: dict) -> tuple[int, ...]:
    """Interior leaf-start offsets of a checkpoint manifest (the legal
    shard cut points: cutting only here keeps every tensor whole on one
    host).  The manifest is the ``save_checkpoint`` JSON dict —
    ``{"leaves": [{"offset": ..., "nbytes": ...}, ...]}``."""
    starts = sorted(int(e["offset"]) for e in manifest["leaves"])
    return tuple(s for s in starts if s > 0)


def plan_shards(total: int, hosts: int,
                boundaries: Optional[Sequence[int]] = None) -> ShardPlan:
    """Split ``[0, total)`` into ``hosts`` contiguous ~equal spans.

    With ``boundaries`` (sorted legal cut offsets, e.g.
    :func:`manifest_boundaries`), each ideal cut ``total * h / hosts``
    snaps to the nearest boundary — monotonically, so spans never
    invert; without them cuts land on the ideal byte offsets.
    """
    if hosts < 1:
        raise ValueError(f"hosts must be >= 1, got {hosts}")
    if total < 0:
        raise ValueError(f"total must be >= 0, got {total}")
    cuts = [0]
    bnd = sorted(b for b in boundaries or () if 0 < b < total)
    for h in range(1, hosts):
        ideal = (total * h) // hosts
        if bnd:
            snapped = min(bnd, key=lambda b: (abs(b - ideal), b))
        else:
            snapped = ideal
        cuts.append(max(snapped, cuts[-1]))    # monotone: no inverted span
    cuts.append(total)
    return ShardPlan(total=total, spans=tuple(
        (cuts[h], cuts[h + 1]) for h in range(hosts)))


def plan_for_mesh(total: int, mesh: Any, axis: str = "data",
                  boundaries: Optional[Sequence[int]] = None) -> ShardPlan:
    """A :class:`ShardPlan` with one shard per slice of ``mesh`` along
    ``axis`` (duck-typed: any object whose ``shape`` maps axis names to
    sizes, such as ``repro_torch.distributed.Mesh``, so planning stays
    usable on I/O-only hosts)."""
    try:
        k = int(mesh.shape[axis])
    except (KeyError, TypeError) as e:
        raise ValueError(
            f"mesh has no {axis!r} axis to shard the restore over") from e
    return plan_shards(total, k, boundaries)


def plan_for_ctx(total: int, axis: str = "data",
                 boundaries: Optional[Sequence[int]] = None,
                 ctx: Any = None) -> tuple[int, ShardPlan]:
    """(this host's shard index, the plan) from a sharding context.

    ``ctx`` defaults to ``repro_torch.distributed.context.active_ctx()``.
    The host index is this process's rank modulo the number of shards (as
    the reference computes it from ``jax.process_index()``), not its
    coordinate along ``axis``: every process computes the same plan and
    picks a slot from its rank."""
    if ctx is None:
        from repro_torch.distributed.context import active_ctx

        ctx = active_ctx()
        if ctx is None:
            raise RuntimeError("no active sharding context: pass ctx= or "
                               "activate() a mesh first")
    mesh = ctx.mesh
    plan = plan_for_mesh(total, mesh, axis, boundaries)
    from repro_torch.distributed.context import process_index

    host = process_index() % max(plan.n_hosts, 1)
    return host, plan


# --------------------------------------------------------------------------
# Work-stealing ledger (pure)
# --------------------------------------------------------------------------

@dataclass
class _Steal:
    thief: int
    victim: int
    start: int
    end: int


class StealLedger:
    """In-process claim coordination for cross-host range theft.

    Pure bookkeeping: the ledger never looks at sockets or sinks — the
    caller supplies each victim's *uncovered* intervals (what its sink
    has not landed yet) and the ledger layers its own claims on top so
    no two thieves grab the same range.  All hosts of one
    :func:`fetch_sharded` share one ledger on one event loop, so no
    locking is needed; a cross-process port would put this same logic
    behind an RPC.
    """

    def __init__(self, plan: ShardPlan, *,
                 min_steal: int = 256 * 1024, steal_frac: float = 0.5,
                 claim_horizon_s: float = 2.0):
        self.plan = plan
        #: floor on a claim's size: sub-chunk thefts cost a connection +
        #: coverage round-trip and save almost nothing.
        self.min_steal = int(min_steal)
        #: fraction of the victim's largest unclaimed gap taken per
        #: claim — half, by default, pcircle-style: leaves the victim's
        #: own frontier room while the thief works the tail.  Used only
        #: when the thief's bandwidth is unknown (``thief_bw == 0``).
        self.steal_frac = float(steal_frac)
        #: seconds of thief throughput a bandwidth-sized claim covers:
        #: with ``thief_bw`` the claim is ``thief_bw * claim_horizon_s``
        #: bytes, so a fast thief grabs big tails while a slow one takes
        #: bites it can actually finish before the victim's own frontier
        #: would have reached them.
        self.claim_horizon_s = float(claim_horizon_s)
        #: per-victim claimed spans (half-open, unordered).
        self._claimed: list[list[tuple[int, int]]] = [
            [] for _ in plan.spans]
        self.steals: list[_Steal] = []

    @property
    def stolen_bytes(self) -> int:
        return sum(s.end - s.start for s in self.steals)

    def _unclaimed(self, victim: int,
                   uncovered: list[tuple[int, int]]) -> list[tuple[int, int]]:
        """``uncovered`` (s, n pairs within the victim's span) minus this
        ledger's outstanding claims, as half-open pairs."""
        gaps = [(s, s + n) for s, n in uncovered]
        for cs, ce in self._claimed[victim]:
            nxt = []
            for gs, ge in gaps:
                if ce <= gs or cs >= ge:
                    nxt.append((gs, ge))
                    continue
                if gs < cs:
                    nxt.append((gs, cs))
                if ce < ge:
                    nxt.append((ce, ge))
            gaps = nxt
        return gaps

    def steal(self, thief: int,
              uncovered_of: Callable[[int], list[tuple[int, int]]],
              thief_bw: float = 0.0,
              ) -> Optional[tuple[int, int, int]]:
        """Claim a sub-span of the most backlogged victim for ``thief``.

        ``uncovered_of(host)`` returns the host's not-yet-landed
        ``(start, nbytes)`` intervals *within its own span*.  Returns
        ``(victim, start, end)`` — a tail of the victim's largest
        unclaimed gap — or None when no peer has enough backlog to be
        worth robbing.

        With ``thief_bw`` (the thief's observed bytes/s, e.g. the sum of
        its EWMA per-replica throughputs), the claim is sized to what
        the thief can move in ``claim_horizon_s`` seconds, clamped to
        ``[min_steal, gap]``; without it the static ``steal_frac``
        fraction of the gap is taken.  Either way the claim never drops
        below ``min_steal``, and a gap smaller than ``2 * min_steal`` is
        taken whole (too small to split).
        """
        best: Optional[tuple[int, list[tuple[int, int]]]] = None
        best_bytes = 0
        for v in range(self.plan.n_hosts):
            if v == thief:
                continue
            gaps = self._unclaimed(v, uncovered_of(v))
            backlog = sum(e - s for s, e in gaps)
            if backlog > best_bytes:
                best, best_bytes = (v, gaps), backlog
        if best is None or best_bytes < self.min_steal:
            return None
        victim, gaps = best
        gs, ge = max(gaps, key=lambda g: g[1] - g[0])
        if thief_bw > 0.0:
            take = min(int(thief_bw * self.claim_horizon_s), ge - gs)
            take = max(take, self.min_steal)
        else:
            take = max(int((ge - gs) * self.steal_frac), self.min_steal)
        if (ge - gs) < 2 * self.min_steal:
            take = ge - gs                      # too small to split: all of it
        start = max(gs, ge - take)              # the TAIL: the victim's own
        self._claimed[victim].append((start, ge))   # frontier eats the head
        self.steals.append(_Steal(thief, victim, start, ge))
        return victim, start, ge

    def release(self, victim: int, start: int, end: int) -> None:
        """Un-claim a span whose theft failed (the thief's fetch raised)
        so another host — or the victim's own refetch — can take it."""
        with_span = (start, end)
        claims = self._claimed[victim]
        if with_span in claims:
            claims.remove(with_span)
        self.steals = [s for s in self.steals
                       if not (s.victim == victim and s.start == start
                               and s.end == end)]


# --------------------------------------------------------------------------
# Orchestration (asyncio, real sockets)
# --------------------------------------------------------------------------

@dataclass
class ShardFetchResult:
    """What :func:`fetch_sharded` hands back, per host and in aggregate."""

    plan: ShardPlan
    #: each host's full-size :class:`BufferSink` — its own span (plus any
    #: spans it stole) is landed; everything else is zero-fill.
    sinks: list
    #: per-host transfer reports, own-span fetch first, one per steal after.
    reports: list
    #: per-host seconds until the host's OWN span was fully landed.
    elapsed: list
    #: per-host bytes fetched OUTSIDE the host's own span (the theft
    #: witness: > 0 means work stealing actually moved bytes).
    stolen_bytes_per_host: list
    steals: list

    @property
    def makespan(self) -> float:
        return max(self.elapsed) if self.elapsed else 0.0

    @property
    def stolen_bytes(self) -> int:
        return sum(self.stolen_bytes_per_host)


async def fetch_sharded(total: int, plan: ShardPlan, origins: Sequence,
                        *, steal: bool = True,
                        mirrors: Optional[Sequence] = None,
                        client_factory: Optional[Callable] = None,
                        min_steal: int = 256 * 1024,
                        steal_frac: float = 0.5,
                        claim_horizon_s: float = 2.0,
                        client_kw: Optional[dict] = None,
                        ) -> ShardFetchResult:
    """Restore one blob across ``plan.n_hosts`` cooperating hosts.

    ``origins`` is either one replica list shared by every host or a
    per-host sequence of replica lists (``origins[h]`` = the full
    mirrors host ``h`` fetches from — its "own" origin path).  Each host
    lands bytes in a full-size :class:`BufferSink`, serves them through
    a :class:`PeerMirror` (pass prebuilt ``mirrors`` to throttle peer
    uplinks; unbound ones are bound here, and mirrors created here are
    stopped on exit), and lists every other host's mirror as a
    coverage-gated replica.

    With ``steal`` (default), a host that finishes its own span claims
    uncovered tails of backlogged peers from a shared
    :class:`StealLedger` and fetches them through its own origin path —
    see the module docstring for why that drains a straggler.  Claims
    are sized from the thief's just-measured throughput (the sum of its
    own-span fetch's EWMA per-replica rates, covering
    ``claim_horizon_s`` seconds of its bandwidth) so fast finishers take
    proportionally bigger tails; when a host has no throughput sample
    (empty own span) the static ``steal_frac`` rule applies.  Hosts
    always fetch their own span regardless, so the result is correct
    (every host holds its own shard) even with stealing off.
    """
    from repro_torch.transfer.client import MDTPClient
    from repro_torch.transfer.mirror import PeerMirror
    from repro_torch.transfer.sink import BufferSink

    k = plan.n_hosts
    if origins and isinstance(origins[0], (list, tuple)):
        per_host = [list(o) for o in origins]
        if len(per_host) != k:
            raise ValueError(f"origins: {len(per_host)} lists for {k} hosts")
    else:
        per_host = [list(origins) for _ in range(k)]

    sinks = [BufferSink(total) for _ in range(k)]
    own_mirrors = mirrors is None
    if own_mirrors:
        mirrors = [PeerMirror(sinks[h], path=f"/shard{h}") for h in range(k)]
    else:
        mirrors = list(mirrors)
        for h, m in enumerate(mirrors):
            if not m.bound:
                m.bind(sinks[h], total)
    ledger = StealLedger(plan, min_steal=min_steal, steal_frac=steal_frac,
                         claim_horizon_s=claim_horizon_s)

    def uncovered_of(h: int) -> list[tuple[int, int]]:
        s, e = plan.spans[h]
        out = []
        for us, un in uncovered_intervals(sinks[h].covered_intervals(),
                                          total):
            lo, hi = max(us, s), min(us + un, e)
            if hi > lo:
                out.append((lo, hi - lo))
        return out

    reports: list[list] = [[] for _ in range(k)]
    elapsed = [0.0] * k
    stolen = [0] * k
    t0 = time.monotonic()

    async def run_host(h: int):
        reps = per_host[h] + [mirrors[g].replica for g in range(k) if g != h]
        if client_factory is not None:
            client = client_factory(h, reps)
        else:
            client = MDTPClient(reps, **(client_kw or {}))
        s, e = plan.spans[h]
        if e > s:
            _, rep = await client.fetch(e - s, sink=sinks[h], offset=s)
            reports[h].append(rep)
        elapsed[h] = time.monotonic() - t0

        def my_bw() -> float:
            if not reports[h]:
                return 0.0
            return sum(reports[h][-1].observed_throughputs.values())

        while steal:
            grab = ledger.steal(h, uncovered_of, thief_bw=my_bw())
            if grab is None:
                return
            victim, gs, ge = grab
            try:
                _, rep = await client.fetch(ge - gs, sink=sinks[h],
                                            offset=gs)
            except BaseException:
                ledger.release(victim, gs, ge)
                raise
            reports[h].append(rep)
            stolen[h] += ge - gs

    try:
        import asyncio

        await asyncio.gather(*(run_host(h) for h in range(k)))
    finally:
        if own_mirrors:
            for m in mirrors:
                m.stop()

    return ShardFetchResult(plan=plan, sinks=sinks, reports=reports,
                            elapsed=elapsed, stolen_bytes_per_host=stolen,
                            steals=list(ledger.steals))
