"""The port's sharded, work-stealing restore, on the CPU.

The case list of the reference's ``tests/test_shard.py``: planning, the
steal ledger, ``fetch_sharded`` over loopback sockets, and
``restore_checkpoint(shard_plan=)`` at ``device="cpu"`` (a stand-in with
a ``shape`` mapping takes the JAX mesh's place).  The port's plans are
the reference's, cut for cut.

The straggler is certain, not a matter of speed: host 0's origin stalls
every response, so the other hosts finish first and rob its tail.  The
case asserts structure (steals recorded, the victim, the bytes exact),
not a ratio of times.  Every socket case is bounded, stops its servers
and peer mirrors in the ``loopback`` fixture's teardown, and leaves no
thread behind (``no_thread_left``).
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch
from torch_loopback import arun, loopback, no_thread_left  # noqa: F401

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.core.chunking import ChunkParams
from repro_torch.models.common import tree_leaves
from repro_torch.transfer import (FaultPolicy, Replica, plan_for_mesh,
                                  plan_shards)
from repro_torch.transfer.shard import (ShardPlan, StealLedger, fetch_sharded,
                                        manifest_boundaries)

KB = 1024
MB = 1024 * 1024


def _blob(n: int, seed: int = 3) -> bytes:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


# -- planning ---------------------------------------------------------------

def test_plan_shards_even_split():
    plan = plan_shards(100, 4)
    assert plan.spans == ((0, 25), (25, 50), (50, 75), (75, 100))
    assert plan.n_hosts == 4
    assert plan.nbytes_of(2) == 25
    assert plan.host_of(0) == 0 and plan.host_of(99) == 3


def test_plan_shards_covers_exactly_once():
    for k in (1, 2, 3, 5, 8):
        plan = plan_shards(1000, k)
        assert plan.spans[0][0] == 0 and plan.spans[-1][1] == 1000
        for (s0, e0), (s1, e1) in zip(plan.spans, plan.spans[1:]):
            assert e0 == s1 and s0 <= e0 and s1 <= e1


def test_plan_shards_snaps_to_boundaries():
    plan = plan_shards(100, 4, boundaries=[10, 30, 48, 52, 90])
    assert plan.spans == ((0, 30), (30, 48), (48, 90), (90, 100))
    for s, _ in plan.spans[1:]:
        assert s in (10, 30, 48, 52, 90)


def test_plan_shards_more_hosts_than_boundaries():
    plan = plan_shards(100, 4, boundaries=[60])
    assert plan.spans[0][0] == 0 and plan.spans[-1][1] == 100
    assert sum(e - s for s, e in plan.spans) == 100
    assert any(s == e for s, e in plan.spans)


def test_manifest_boundaries_and_mesh_plan(tmp_path):
    state = {"a": torch.zeros(17), "b": torch.ones(31),
             "c": torch.arange(11, dtype=torch.int32)}
    d = save_checkpoint(str(tmp_path), 1, state)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    bnd = manifest_boundaries(manifest)
    starts = sorted(int(e["offset"]) for e in manifest["leaves"])
    assert list(bnd) == [s for s in starts if s > 0]

    class FakeMesh:
        shape = {"data": 2, "model": 1}

    plan = plan_for_mesh(int(manifest["total_bytes"]), FakeMesh(),
                         axis="data", boundaries=bnd)
    assert plan.n_hosts == 2
    assert plan.spans[0][1] in bnd
    with pytest.raises(ValueError, match="no 'pipe' axis"):
        plan_for_mesh(100, FakeMesh(), axis="pipe")


@pytest.mark.parametrize("total", [0, 1, 1000, 3 * MB + 7])
@pytest.mark.parametrize("hosts", [1, 2, 3, 8])
@pytest.mark.parametrize("boundaries", [None, (), (10, 30, 48, 52, 90),
                                        (600, 1 * MB, 2 * MB + 5)])
def test_plans_are_the_references(total, hosts, boundaries):
    from repro.transfer.shard import plan_shards as ref_plan_shards

    port = plan_shards(total, hosts, boundaries)
    ref = ref_plan_shards(total, hosts, boundaries)
    assert (port.total, port.spans) == (ref.total, ref.spans)


# -- the steal ledger -------------------------------------------------------

def test_ledger_steals_tail_of_most_backlogged():
    ledger = StealLedger(plan_shards(4 * MB, 4), min_steal=64 * KB)
    backlog = {0: [(0, 32 * KB)], 1: [], 2: [(1 * MB + MB // 2, MB // 2)],
               3: [(3 * MB, 16 * KB)]}
    victim, s, e = ledger.steal(0, lambda h: backlog[h])
    assert victim == 2
    assert e == 2 * MB and s == 2 * MB - MB // 4
    assert ledger.stolen_bytes == MB // 4


def test_ledger_claims_do_not_overlap_and_release_reopens():
    ledger = StealLedger(plan_shards(2 * MB, 2), min_steal=64 * KB)
    uncovered = {0: [], 1: [(1 * MB, 1 * MB)]}
    g1 = ledger.steal(0, lambda h: uncovered[h])
    g2 = ledger.steal(0, lambda h: uncovered[h])
    assert g1 and g2
    (_, s1, e1), (_, s2, e2) = g1, g2
    assert min(e1, e2) <= max(s1, s2)
    ledger.release(1, s1, e1)
    g3 = ledger.steal(0, lambda h: uncovered[h])
    assert g3 is not None and s1 <= g3[1] < g3[2] == e1


def test_ledger_sizes_claim_from_thief_bandwidth():
    plan = plan_shards(8 * MB, 2)
    ledger = StealLedger(plan, min_steal=64 * KB, claim_horizon_s=2.0)
    uncovered = {0: [], 1: [(4 * MB, 4 * MB)]}
    assert ledger.steal(0, lambda h: uncovered[h], thief_bw=1.0 * MB) == \
        (1, 6 * MB, 8 * MB)
    assert ledger.steal(0, lambda h: uncovered[h], thief_bw=1.0 * KB) == \
        (1, 6 * MB - 64 * KB, 6 * MB)
    assert StealLedger(plan, min_steal=64 * KB).steal(
        0, lambda h: uncovered[h], thief_bw=1e12) == (1, 4 * MB, 8 * MB)
    assert StealLedger(plan, min_steal=64 * KB).steal(
        0, lambda h: uncovered[h]) == (1, 6 * MB, 8 * MB)


def test_ledger_respects_min_steal_floor():
    ledger = StealLedger(plan_shards(1 * MB, 2), min_steal=256 * KB)
    assert ledger.steal(0, lambda h: [] if h == 0
                        else [(512 * KB, 128 * KB)]) is None
    grab = ledger.steal(0, lambda h: [] if h == 0
                        else [(512 * KB, 384 * KB)])
    assert grab is not None and grab[1:] == (512 * KB, 512 * KB + 384 * KB)


# -- fetch_sharded on real sockets -------------------------------------------

def _run_sharded(loopback, blob, servers, steal):
    """K = len(servers) hosts, host h fetching from ``servers[h]``, each
    serving its sink through a peer mirror of the test's own."""
    k = len(servers)
    plan = plan_shards(len(blob), k)
    origins = [[Replica("127.0.0.1", s.port, "/data")] for s in servers]
    mirrors = [loopback.mirror(path=f"/shard{h}") for h in range(k)]
    res = arun(fetch_sharded(
        len(blob), plan, origins, steal=steal, mirrors=mirrors,
        client_kw=dict(params=ChunkParams(32 * KB, 64 * KB,
                                          min_chunk=8 * KB),
                       coverage_refresh_s=0.01)))
    for h in range(k):
        s, e = plan.span_of(h)
        assert hashlib.sha256(bytes(res.sinks[h])[s:e]).hexdigest() == \
            hashlib.sha256(blob[s:e]).hexdigest(), f"host {h} span"
    return res


def test_fetch_sharded_lands_every_span(loopback):
    blob = _blob(1 * MB)
    servers = [loopback.server({"/data": blob}, rate=64 * MB)
               for _ in range(3)]
    res = _run_sharded(loopback, blob, servers, steal=True)
    assert len(res.reports) == 3 and all(r for r in res.reports)
    assert res.makespan > 0


def test_fetch_sharded_steals_from_straggler(loopback):
    """Host 0's origin stalls every response for half a second; hosts 1
    and 2 finish their spans first and rob host 0's tail, which host 0
    then drains from their peer mirrors."""
    blob = _blob(MB + 3 * KB)
    stall = FaultPolicy(stall_rate=1.0, stall_s=0.5)
    servers = [loopback.server({"/data": blob}, faults=stall),
               loopback.server({"/data": blob}),
               loopback.server({"/data": blob})]
    res = _run_sharded(loopback, blob, servers, steal=True)
    assert res.stolen_bytes > 0
    assert res.steals and all(s.victim == 0 for s in res.steals)
    assert {s.thief for s in res.steals} <= {1, 2}
    for st in res.steals:
        assert bytes(res.sinks[st.thief])[st.start:st.end] == \
            blob[st.start:st.end]
    assert res.stolen_bytes_per_host[0] == 0
    assert res.stolen_bytes == sum(st.end - st.start for st in res.steals)


def test_fetch_sharded_steal_off_is_independent(loopback):
    blob = _blob(512 * KB)
    servers = [loopback.server({"/data": blob}, rate=16 * MB)
               for _ in range(2)]
    res = _run_sharded(loopback, blob, servers, steal=False)
    assert res.stolen_bytes == 0 and res.steals == []


# -- restore_checkpoint(shard_plan=) ------------------------------------------

def _state():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn((128, 128), generator=g),
                       "b": torch.arange(128, dtype=torch.float32)},
            "step": torch.tensor(9, dtype=torch.int32)}


def test_restore_shard_plan_restores_only_own_span(tmp_path, loopback):
    state = _state()
    d = save_checkpoint(str(tmp_path), 9, state)
    srv = loopback.checkpoint(d, 9, rate=64 * MB)
    reps = [Replica("127.0.0.1", srv.port, "/ckpt")]
    halves = [loopback.bounded(lambda h=h: restore_checkpoint(
        str(tmp_path), state, step=9, replicas=reps, shard_plan=(h, 2),
        device="cpu"))[0] for h in (0, 1)]
    held = [dict(tree_leaves(h)) for h in halves]     # None leaves skipped
    for key, want in tree_leaves(state):
        pieces = [h[key] for h in held if key in h]
        assert len(pieces) == 1, f"{key} held by {len(pieces)} hosts"
        assert torch.equal(pieces[0], want)
    # the leaves a host does not hold stay in its tree as None
    assert sum(v is None for v in halves[0]["params"].values()) + \
        (halves[0]["step"] is None) == len(tree_leaves(state)) - len(held[0])


def test_restore_shard_plan_int_k_matches_explicit_plan(tmp_path, loopback):
    state = {"w": torch.ones((64, 64)), "v": torch.zeros(32)}
    d = save_checkpoint(str(tmp_path), 2, state)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    plan = plan_shards(int(manifest["total_bytes"]), 2,
                       manifest_boundaries(manifest))
    assert isinstance(plan, ShardPlan)
    srv = loopback.checkpoint(d, 2, rate=64 * MB)
    reps = [Replica("127.0.0.1", srv.port, "/ckpt")]
    via_k, _ = loopback.bounded(lambda: restore_checkpoint(
        str(tmp_path), state, step=2, replicas=reps, shard_plan=(0, 2),
        device="cpu"))
    via_plan, _ = loopback.bounded(lambda: restore_checkpoint(
        str(tmp_path), state, step=2, replicas=reps, shard_plan=(0, plan),
        device="cpu"))
    assert via_k.keys() == via_plan.keys()
    for k in via_k:
        assert (via_k[k] is None) == (via_plan[k] is None)
        if via_k[k] is not None:
            assert torch.equal(via_k[k], via_plan[k])


def test_shard_traces_scenarios():
    from repro_torch.core.scenarios import shard_traces

    traces = shard_traces()
    names = [t.name for t in traces]
    assert "balanced" in names and "straggler" in names
    for t in traces:
        assert t.k >= 2 and len(t.servers) == t.k and t.size > 0
