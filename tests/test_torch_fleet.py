"""The port's fleet layer over loopback sockets, on the CPU.

The case lists of the reference's ``tests/test_manager.py``, the
probation and admission cases of ``tests/test_overload.py``,
``tests/test_broadcast.py`` and ``tests/test_data_pipeline.py``, run
against ``repro_torch.transfer`` (``TransferManager``, ``FleetModel``,
``PeerMirror``, the sinks) and ``repro_torch.data``; the sweeps run at
``device="cpu"``.

Every socket case is bounded by a time limit of its own, stops its
servers in the ``loopback`` fixture's teardown, and leaves no thread
behind (``no_thread_left``).  Mirrors pace deterministically, so a rate
is an upper bound that host load cannot raise; where a reference case
asserts a ratio of speeds, its counterpart here asserts what the rates
make certain: bytes exact, who served, and what was counted.
"""

import asyncio
import dataclasses
import hashlib
import http.client

import numpy as np
import pytest
from torch_loopback import LIMIT, arun, loopback, no_thread_left  # noqa: F401

from repro_torch.core.chunking import ChunkParams
from repro_torch.transfer import (BufferSink, CallableSink, FaultPolicy,
                                  FleetModel, MDTPClient, PeerMirror, Replica,
                                  Sink, TransferJob, TransferManager)

KB = 1024
MB = 1024 * 1024


def _sha(b) -> str:
    return hashlib.sha256(bytes(b)).hexdigest()


def _blob(size, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()


def _blobs(k, size, seed=0):
    rng = np.random.default_rng(seed)
    return {f"/b{j}": rng.integers(0, 256, size=size, dtype=np.uint8)
            .tobytes() for j in range(k)}


def _reps(servers, path):
    return [Replica("127.0.0.1", s.port, path) for s in servers]


# -- fleet model units (test_manager.py) -----------------------------------

def test_allocation_view_residual_and_floor():
    fleet = FleetModel()
    reps = [Replica("h0", 1, "/b"), Replica("h1", 2, "/b")]
    fleet.register("t1")
    fleet.register("t2")
    for _ in range(60):
        fleet.observe_chunk("t1", "h0:1", 40 * MB, 1.0)
        fleet.observe_chunk("t2", "h0:1", 60 * MB, 1.0)
    view = fleet.allocation_view("t1", reps, [40.0 * MB, 25.0 * MB])
    assert view[0] == pytest.approx(40 * MB, rel=0.05)
    assert view[1] == 25.0 * MB
    assert fleet.allocation_view("t1", reps, [0.0, 0.0]) == [0.0, 0.0]
    fleet.forget("t2")
    view = fleet.allocation_view("t1", reps, [40.0 * MB, 25.0 * MB])
    assert view[0] == pytest.approx(100 * MB, rel=0.05)


def test_allocation_view_floor_prevents_starvation():
    fleet = FleetModel()
    reps = [Replica("h0", 1, "/b")]
    fleet.register("t1")
    fleet.register("t2")
    for _ in range(60):
        fleet.observe_chunk("t2", "h0:1", 100 * MB, 1.0)
        fleet.observe_chunk("t1", "h0:1", 1 * MB, 1.0)
    view = fleet.allocation_view("t1", reps, [1.0 * MB])
    assert view[0] >= 100 * MB / (2 * 2) * 0.8


def test_fleet_telemetry_substitutes_residual_and_rtt():
    from repro_torch.core.online import Telemetry

    fleet = FleetModel()
    reps = [Replica("h0", 1, "/b"), Replica("h1", 2, "/b")]
    fleet.register("t1")
    fleet.observe_rtt("h0:1", 0.25)
    for _ in range(30):
        fleet.observe_chunk("t1", "h0:1", 50 * MB, 1.0)
    out = fleet.fleet_telemetry(
        "t1", reps, Telemetry(bandwidth=(10.0 * MB, 20.0 * MB),
                              rtt=(0.03, 0.04), remaining_bytes=5.0))
    assert out.bandwidth[0] > 10.0 * MB
    assert out.bandwidth[1] == 20.0 * MB
    assert out.rtt[0] == pytest.approx(0.25, rel=0.2)
    assert out.rtt[1] == 0.04
    assert out.remaining_bytes == 5.0


def test_fleet_model_rejects_bad_cap():
    with pytest.raises(ValueError):
        FleetModel(max_inflight_per_replica=0)


# -- K concurrent managed transfers ----------------------------------------

def test_concurrent_transfers_bytes_conservation(loopback):
    k = 3
    blobs = _blobs(k, MB)
    servers = [loopback.server(blobs, rate=r) for r in (30 * MB, 90 * MB)]
    reps = _reps(servers, "/b0")
    mgr = TransferManager(reps, params=ChunkParams(128 * KB, 256 * KB))
    out = loopback.bounded(lambda: mgr.run([
        TransferJob(MB, path=f"/b{j}") for j in range(k)]))
    assert len(out) == k
    for j, (buf, report) in enumerate(out):
        assert _sha(buf) == _sha(blobs[f"/b{j}"])
        assert sum(report.bytes_per_replica.values()) == MB
        assert report.failed_replicas == []
    assert len(mgr.reports) == k
    snap = mgr.snapshot()
    assert set(snap) == {r.name for r in reps}
    assert all(v["capacity"] > 0 for v in snap.values())


def test_per_replica_inflight_cap_enforced(loopback):
    k = 3
    blobs = _blobs(k, MB, seed=1)
    servers = [loopback.server(blobs, rate=r) for r in (25 * MB, 50 * MB)]
    mgr = TransferManager(_reps(servers, "/b0"),
                          params=ChunkParams(128 * KB, 256 * KB),
                          max_inflight_per_replica=1)
    out = loopback.bounded(lambda: mgr.run([
        TransferJob(MB, path=f"/b{j}") for j in range(k)]))
    for j, (buf, _) in enumerate(out):
        assert bytes(buf) == blobs[f"/b{j}"]
    for s in servers:
        assert s.peak_concurrent_requests <= 1


def test_uncapped_control_overlaps_requests(loopback):
    """Three transfers start together on one mirror paced at 8 MB/s
    (16 ms a chunk): without a cap their requests overlap."""
    k = 3
    blobs = _blobs(k, 512 * KB, seed=2)
    server = loopback.server(blobs, rate=8 * MB)
    mgr = TransferManager(_reps([server], "/b0"),
                          params=ChunkParams(128 * KB, 256 * KB),
                          max_inflight_per_replica=8)
    out = loopback.bounded(lambda: mgr.run([
        TransferJob(512 * KB, path=f"/b{j}") for j in range(k)]))
    for j, (buf, _) in enumerate(out):
        assert bytes(buf) == blobs[f"/b{j}"]
    assert server.peak_concurrent_requests >= 2


def test_staggered_arrival_not_starved(loopback):
    blobs = _blobs(2, 2 * MB, seed=3)
    servers = [loopback.server(blobs, rate=r) for r in (20 * MB, 40 * MB)]
    mgr = TransferManager(_reps(servers, "/b0"),
                          params=ChunkParams(128 * KB, 256 * KB))
    out = loopback.bounded(lambda: mgr.run([
        TransferJob(2 * MB, path="/b0"),
        TransferJob(2 * MB, path="/b1", start_delay=0.02)]))
    for j, (buf, report) in enumerate(out):
        assert bytes(buf) == blobs[f"/b{j}"]
        assert all(v > 0 for v in report.bytes_per_replica.values())
        assert report.failed_replicas == []


# -- warm start and tuner persistence --------------------------------------

class _AdoptOnce:
    """Adopts a fixed geometry on every update (not exposed as
    ``params``, so the warm start must come through the manager)."""

    def __init__(self, target):
        self.target = target
        self.updates = 0

    def update(self, telemetry):
        self.updates += 1
        return self.target


def test_adopted_params_warm_start_next_transfer(loopback):
    blobs = _blobs(2, 2 * MB, seed=4)
    servers = [loopback.server(blobs, rate=60 * MB) for _ in range(2)]
    learned = ChunkParams(initial_chunk=192 * KB, large_chunk=384 * KB)
    mgr = TransferManager(_reps(servers, "/b0"),
                          params=ChunkParams(128 * KB, 256 * KB),
                          tuner=_AdoptOnce(learned))
    (buf, report), = loopback.bounded(lambda: mgr.run([TransferJob(
        2 * MB, path="/b0", tune_interval_bytes=256 * KB)]))
    assert bytes(buf) == blobs["/b0"]
    assert report.retunes >= 1
    assert mgr.params == learned

    async def second():
        async with mgr.session(path="/b1") as client:
            assert client._params_arg == learned
            buf2, _ = await client.fetch(2 * MB)
            return buf2

    assert bytes(arun(second())) == blobs["/b1"]


def test_non_adopting_transfer_does_not_clobber_learned_params():
    p0 = ChunkParams(initial_chunk=128 * KB, large_chunk=512 * KB)
    p1 = ChunkParams(initial_chunk=256 * KB, large_chunk=MB)
    mgr = TransferManager([Replica("h0", 1, "/b")], params=p0)

    async def scenario():
        async with mgr.session() as slow:
            async with mgr.session() as fast:
                fast.adopt_params(p1)
            assert mgr.params == p1
            assert slow._params_arg == p0
        assert mgr.params == p1

    arun(scenario())


def test_bandit_state_persists_across_transfers(loopback):
    from repro_torch.core.online import BanditTuner

    blobs = _blobs(2, 2 * MB, seed=5)
    servers = [loopback.server(blobs, rate=r) for r in (40 * MB, 80 * MB)]
    grid = [(128 * KB, 512 * KB), (256 * KB, MB), (512 * KB, 2 * MB)]
    tuner = BanditTuner(n_arms=2, grid=grid, device="cpu")
    mgr = TransferManager(_reps(servers, "/b0"), tuner=tuner,
                          params=ChunkParams(128 * KB, 256 * KB))
    loopback.bounded(lambda: mgr.run([TransferJob(
        2 * MB, path="/b0", tune_interval_bytes=256 * KB)]))
    assert tuner.updates >= 1
    assert tuner.arms
    first = tuner.updates
    loopback.bounded(lambda: mgr.run([TransferJob(
        2 * MB, path="/b1", tune_interval_bytes=256 * KB)]))
    assert tuner.arms
    assert tuner.updates >= first + 1


# -- contention planning ----------------------------------------------------

def test_contention_sweep_ladder():
    from repro_torch.core.autotune import (autotune_chunk_params,
                                           contention_sweep)

    bw = [12.0 * MB, 70.0 * MB]
    ladder = contention_sweep(bw, 0.2, 512 * MB, max_transfers=3,
                              device="cpu")
    assert sorted(ladder) == [1, 2, 3]
    solo = autotune_chunk_params(bw, 0.2, 512 * MB, device="cpu")
    assert ladder[1].params == solo.params
    assert ladder[1].predicted_time == pytest.approx(solo.predicted_time)
    assert ladder[2].predicted_time > ladder[1].predicted_time
    assert ladder[3].predicted_time > ladder[2].predicted_time
    with pytest.raises(ValueError):
        contention_sweep(bw, 0.2, 512 * MB, ks=[0, 1], device="cpu")


def test_plan_contention_ladder_on_manager():
    mgr = TransferManager([Replica("h0", 1, "/b"), Replica("h1", 2, "/b")])
    with pytest.raises(ValueError):
        mgr.plan_contention(256 * MB, max_transfers=2, device="cpu")
    ladder = mgr.plan_contention(
        256 * MB, max_transfers=2, bandwidth=[12.0 * MB, 70.0 * MB],
        rtt=[0.2, 0.2], device="cpu")
    assert set(ladder) == {1, 2}
    assert mgr.contention_ladder == ladder
    assert all(isinstance(p, ChunkParams) for p in ladder.values())
    assert mgr._warm_params(n_active=2) == ladder[2]
    assert mgr._warm_params(n_active=1) == ladder[1]


def test_plan_contention_matches_the_reference():
    """The manager's ladder is the reference manager's, cell for cell."""
    from repro.transfer import Replica as RefReplica
    from repro.transfer import TransferManager as RefManager

    bw, rtt = [12.0 * MB, 70.0 * MB], [0.2, 0.2]
    port = TransferManager([Replica("h0", 1, "/b")]).plan_contention(
        256 * MB, max_transfers=3, bandwidth=bw, rtt=rtt, device="cpu")
    ref = RefManager([RefReplica("h0", 1, "/b")]).plan_contention(
        256 * MB, max_transfers=3, bandwidth=bw, rtt=rtt)
    assert {k: dataclasses.astuple(p) for k, p in port.items()} == \
        {k: dataclasses.astuple(p) for k, p in ref.items()}


def test_contention_scenarios_helpers():
    from repro_torch.core.scenarios import (ContentionTrace,
                                            contention_matrix,
                                            contention_traces,
                                            paper_baseline, with_fair_share)

    servers = paper_baseline()
    halved = with_fair_share(servers, 2)
    assert [s.bandwidth for s in halved] == \
        [s.bandwidth / 2 for s in servers]
    assert [s.rtt for s in halved] == [s.rtt for s in servers]
    mat = contention_matrix(servers, [1, 2, 4])
    assert len(mat) == 3 and len(mat[0]) == len(servers)
    assert mat[2][0] == servers[0].bandwidth / 4
    traces = contention_traces()
    assert {t.name for t in traces} == \
        {"simultaneous", "staggered", "bottleneck"}
    for t in traces:
        assert len(t.sizes) == len(t.arrivals)
    with pytest.raises(ValueError):
        ContentionTrace("bad", tuple(servers), sizes=(1, 2), arrivals=(0.0,))


# -- replica probation (test_overload.py) ----------------------------------

def _feed(fm, name, rate, n=1, tid="t"):
    for _ in range(n):
        fm.observe_chunk(tid, name, int(rate), 1.0, rtt_included=False)


def _tripped(fm):
    _feed(fm, "a", 50 * MB, n=6)
    _feed(fm, "b", 45 * MB, n=4)
    _feed(fm, "b", 1 * MB, n=fm.probation_strikes)


def test_slow_strikes_trip_probation():
    fm = FleetModel()
    _feed(fm, "a", 50 * MB, n=6)
    _feed(fm, "b", 45 * MB, n=4)
    assert fm.probations == 0
    _feed(fm, "b", 1 * MB, n=fm.probation_strikes)
    assert fm.probations == 1
    assert fm.snapshot()["b"]["probation"] is True


def test_slow_strike_streak_resets_on_healthy_chunk():
    fm = FleetModel()
    _feed(fm, "a", 50 * MB, n=6)
    _feed(fm, "b", 45 * MB, n=4)
    _feed(fm, "b", 1 * MB, n=fm.probation_strikes - 1)
    _feed(fm, "b", 45 * MB)
    _feed(fm, "b", 1 * MB, n=fm.probation_strikes - 1)
    assert fm.probations == 0


def test_probation_readmission_is_slow_start():
    fm = FleetModel()
    _tripped(fm)
    assert fm.snapshot()["b"]["probation"] is True
    _feed(fm, "b", 45 * MB, n=fm.probation_clean_streak)
    snap = fm.snapshot()["b"]
    assert snap["probation"] is False
    assert snap["readmit"] == pytest.approx(fm.readmit_init)
    _feed(fm, "b", 45 * MB)
    assert fm.snapshot()["b"]["readmit"] == pytest.approx(
        min(1.0, fm.readmit_init * 2.0))


def test_probation_slow_probes_do_not_readmit():
    fm = FleetModel()
    _tripped(fm)
    _feed(fm, "b", 1 * MB, n=3 * fm.probation_clean_streak)
    assert fm.snapshot()["b"]["probation"] is True


def test_single_replica_fleet_never_trips():
    fm = FleetModel()
    _feed(fm, "solo", 1 * MB, n=20)
    assert fm.probations == 0


def test_corruption_decay_trips_probation():
    fm = FleetModel()
    for _ in range(5):
        fm.observe_corruption("bad")
    assert fm.snapshot()["bad"]["probation"] is True


def test_retry_storm_trips_probation_without_chunks():
    fm = FleetModel()
    for _ in range(fm.probation_retry_limit):
        fm.observe_retry("hole")
    assert fm.snapshot()["hole"]["probation"] is True


def test_probation_pins_allocation_at_probe_floor():
    fm = FleetModel()
    reps = [Replica("h1", 1, "/x"), Replica("h2", 2, "/x")]
    _feed(fm, reps[0].name, 50 * MB, n=6)
    _feed(fm, reps[1].name, 45 * MB, n=4)
    _feed(fm, reps[1].name, 1 * MB, n=fm.probation_strikes)
    view = fm.allocation_view("t2", reps, [40.0 * MB, 40.0 * MB])
    cap = fm.snapshot()[reps[1].name]["capacity"]
    assert view[1] == pytest.approx(cap * fm.probation_floor)
    assert view[0] > view[1]


def test_probation_disabled_never_trips():
    fm = FleetModel(probation=False)
    _feed(fm, "a", 50 * MB, n=6)
    _feed(fm, "b", 45 * MB, n=4)
    _feed(fm, "b", 1 * MB, n=20)
    assert fm.probations == 0


# -- admission control ------------------------------------------------------

def test_admission_gate_queues_excess_arrivals(loopback):
    blob = _blob(MB)
    servers = [loopback.server({"/data": blob}) for _ in range(2)]
    mgr = TransferManager(_reps(servers, "/data"),
                          params=ChunkParams(128 * KB, 256 * KB),
                          max_active_transfers=1)
    results = loopback.bounded(lambda: mgr.run(
        [TransferJob(size=len(blob)) for _ in range(3)]))
    for buf, report in results:
        assert _sha(buf) == _sha(blob)
        assert report.total_bytes == len(blob)
    assert mgr.admission["admitted"] == 3
    assert mgr.admission["queued"] >= 2
    assert mgr.admission["wait_seconds"] > 0.0


def test_admission_shed_gives_degraded_service(loopback):
    blob = _blob(512 * KB)
    servers = [loopback.server({"/data": blob}) for _ in range(2)]
    mgr = TransferManager(_reps(servers, "/data"),
                          params=ChunkParams(128 * KB, 256 * KB),
                          max_active_transfers=1, shed_queue_depth=0,
                          shed_trickle_bytes_per_s=64.0 * MB)
    results = loopback.bounded(lambda: mgr.run(
        [TransferJob(size=len(blob)) for _ in range(3)]))
    for buf, _ in results:
        assert _sha(buf) == _sha(blob)
    assert mgr.admission["shed"] >= 1


def test_srpt_queue_prefers_smallest_residual(loopback):
    """The first transfer holds the one slot for at least 0.25 s (1 MB
    from two mirrors paced at 2 MB/s); both others queue at 0.02 s, and
    the small one is admitted first."""
    blob = _blob(MB)
    servers = [loopback.server({"/data": blob}, rate=2 * MB)
               for _ in range(2)]
    mgr = TransferManager(_reps(servers, "/data"),
                          params=ChunkParams(128 * KB, 256 * KB),
                          max_active_transfers=1)
    small = 128 * KB
    loopback.bounded(lambda: mgr.run([
        TransferJob(size=len(blob)),
        TransferJob(size=len(blob), start_delay=0.02),
        TransferJob(size=small, start_delay=0.02)]))
    sizes = [r.total_bytes for r in mgr.reports]
    assert sizes == [len(blob), small, len(blob)]


# -- peer mirrors and the sink protocol (test_broadcast.py) ----------------

#: chunks small enough that no origin grab outlives the peers' ramp-up
PARAMS = ChunkParams(initial_chunk=64 * KB, large_chunk=128 * KB,
                     min_chunk=32 * KB)


def _swarm(loopback, blob, n, origin_rate):
    """n restorers, one origin paced at ``origin_rate`` (shared by all),
    a full mesh of unthrottled peer mirrors.  Returns (sinks,
    origin_served, peer_served)."""
    origin = loopback.server({"/data": blob}, rate=origin_rate, shared=True)
    sinks = [BufferSink(len(blob)) for _ in range(n)]
    mirrors = [loopback.mirror(s) for s in sinks]
    rep = Replica("127.0.0.1", origin.port, "/data")

    async def one(j):
        replicas = [rep] + [m.replica for k, m in enumerate(mirrors)
                            if k != j]
        await MDTPClient(replicas, params=PARAMS,
                         coverage_refresh_s=0.01).fetch(
            len(blob), sink=sinks[j], stripe=(j, n))

    async def go():
        await asyncio.gather(*(one(j) for j in range(n)))

    arun(go())
    return sinks, origin.served_bytes, [m.served_bytes for m in mirrors]


def test_mirror_advertises_coverage_and_refuses_uncovered(loopback):
    blob = _blob(MB, seed=7)
    sink = BufferSink(len(blob))
    half = len(blob) // 2
    sink.writable(0, half)[:] = blob[:half]
    sink.commit(0, half)
    m = loopback.mirror(sink)
    c = http.client.HTTPConnection("127.0.0.1", m.port, timeout=LIMIT)
    try:
        c.request("HEAD", "/data")
        r = c.getresponse()
        r.read()
        assert r.status == 200
        assert r.getheader("X-Available-Ranges") == f"0-{half - 1}"
        c.request("GET", "/data", headers={"Range": "bytes=0-65535"})
        r = c.getresponse()
        assert r.status == 206
        assert r.read() == blob[:65536]
        c.request("GET", "/data",
                  headers={"Range": f"bytes={half}-{half + 100}"})
        r = c.getresponse()
        r.read()
        assert r.status == 416
    finally:
        c.close()


def test_sink_protocol_runtime_checks():
    import torch

    from repro_torch.checkpoint.manager import _StreamingRestore

    assert isinstance(BufferSink(16), Sink)
    assert isinstance(CallableSink(lambda s, mv: None), Sink)
    assert not isinstance(object(), Sink)
    stream = _StreamingRestore({"leaves": [], "total_bytes": 0}, {},
                               torch.device("cpu"))
    assert isinstance(stream, Sink)
    with pytest.raises(ValueError):
        PeerMirror(CallableSink(lambda s, mv: None), total=16)


def test_swarm_conservation_byte_exact(loopback):
    blob = _blob(MB, seed=7)
    sinks, origin_served, peer_served = _swarm(loopback, blob, 3, 8 * MB)
    for s in sinks:
        assert _sha(s) == _sha(blob)
        assert s.duplicate_bytes == 0
    assert sum(peer_served) > 0, "no peer ever served a byte"
    assert origin_served + sum(peer_served) >= 3 * len(blob)


def test_origin_egress_sublinear(loopback):
    """Four restorers share one origin paced at 2 MB/s; the peers are
    unpaced.  The origin sends less than one blob per restorer: every
    byte a restorer took from a peer is a byte the origin did not send."""
    blob = _blob(MB, seed=7)
    n = 4
    sinks, origin_served, peer_served = _swarm(loopback, blob, n, 2 * MB)
    for s in sinks:
        assert _sha(s) == _sha(blob)
    assert sum(peer_served) > 0
    assert origin_served < n * len(blob)
    assert origin_served + sum(peer_served) >= n * len(blob)


def test_peer_death_mid_serve_falls_back_to_origin(loopback):
    """The peer holds the first half and severs every response mid-body
    (a peer dying while it serves); the restorer gives the peer up and
    takes the whole blob from the origin, byte-exact."""
    blob = _blob(MB, seed=7)
    origin = loopback.server({"/data": blob}, rate=4 * MB)
    donor = BufferSink(len(blob))
    half = len(blob) // 2
    donor.writable(0, half)[:] = blob[:half]
    donor.commit(0, half)
    m = loopback.mirror(donor, faults=FaultPolicy(truncate_rate=1.0))
    client = MDTPClient([Replica("127.0.0.1", origin.port, "/data"),
                         m.replica], params=PARAMS, coverage_refresh_s=0.01,
                        max_failures=2)
    data, _ = arun(client.fetch(len(blob)))
    assert _sha(data) == _sha(blob)
    assert m.server.fault_counts.get("truncate", 0) >= 1
    assert origin.served_bytes >= len(blob)


# -- the data pipeline (test_data_pipeline.py) -----------------------------

@pytest.fixture(scope="module")
def dataset():
    from repro_torch.data import synthetic_tokens, write_token_dataset

    tokens = synthetic_tokens(200_000, vocab=50_000, seed=3)
    return tokens, write_token_dataset(None, tokens)


def _ds_mirrors(loopback, blobs, rates):
    return [loopback.server({"/ds/" + k: v for k, v in blobs.items()},
                            rate=r) for r in rates]


def test_ranges_deterministic(dataset):
    from repro_torch.data import TokenDatasetSpec

    tokens, _ = dataset
    spec = TokenDatasetSpec(n_tokens=tokens.size, seq_len=128, global_batch=8)
    a = spec.ranges_for_step(5)
    assert a == spec.ranges_for_step(5)
    assert len(a) == 8
    assert all(n == (128 + 1) * 4 for _, n in a)
    assert spec.ranges_for_step(6) != a


def test_host_slicing_partitions_batch(dataset):
    from repro_torch.data import TokenDatasetSpec

    tokens, _ = dataset
    spec = TokenDatasetSpec(n_tokens=tokens.size, seq_len=64, global_batch=8)
    got = []
    for host in range(4):
        got.extend(spec.ranges_for_step(2, host=host, n_hosts=4))
    assert got == spec.ranges_for_step(2)


def test_pipeline_matches_direct_slicing(dataset, loopback):
    from repro_torch.data import MultiSourcePipeline, TokenDatasetSpec

    tokens, blobs = dataset
    spec = TokenDatasetSpec(n_tokens=tokens.size, seq_len=128, global_batch=4)
    servers = _ds_mirrors(loopback, blobs, [20 * MB, 40 * MB, 80 * MB])
    pipe = MultiSourcePipeline(_reps(servers, "/ds"), spec, depth=2)
    try:
        for step in range(3):
            batch = pipe.get_batch(step, timeout=LIMIT)
            assert batch.shape == (4, 129)
            for i in range(4):
                start = ((step * 4 + i) * 128) % (tokens.size - 129)
                np.testing.assert_array_equal(
                    batch[i], tokens[start:start + 129])
    finally:
        pipe.close()


def test_pipeline_prefetch_out_of_order_consume(dataset, loopback):
    from repro_torch.data import MultiSourcePipeline, TokenDatasetSpec

    tokens, blobs = dataset
    spec = TokenDatasetSpec(n_tokens=tokens.size, seq_len=64, global_batch=2)
    servers = _ds_mirrors(loopback, blobs, [50 * MB])
    pipe = MultiSourcePipeline(_reps(servers, "/ds"), spec, depth=3)
    try:
        b2 = pipe.get_batch(2, timeout=LIMIT)
        b0 = pipe.get_batch(0, timeout=LIMIT)
        assert b2.shape == b0.shape == (2, 65)
        np.testing.assert_array_equal(b0[0], tokens[0:65])
    finally:
        pipe.close()


def test_pipeline_data_matches_the_reference():
    """The port's dataset bytes and step ranges are the reference's."""
    from repro.data import TokenDatasetSpec as RefSpec
    from repro.data import synthetic_tokens as ref_tokens
    from repro.data import write_token_dataset as ref_write
    from repro_torch.data import (TokenDatasetSpec, synthetic_tokens,
                                  write_token_dataset)

    a, b = synthetic_tokens(5_000, vocab=1_000, seed=9), \
        ref_tokens(5_000, vocab=1_000, seed=9)
    np.testing.assert_array_equal(a, b)
    assert write_token_dataset(None, a) == ref_write(None, b)
    spec, ref = (S(n_tokens=5_000, seq_len=32, global_batch=4)
                 for S in (TokenDatasetSpec, RefSpec))
    for step in range(3):
        assert spec.ranges_for_step(step, host=1, n_hosts=2) == \
            ref.ranges_for_step(step, host=1, n_hosts=2)
