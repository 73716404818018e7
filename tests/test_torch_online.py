"""The port's online tuning: tuners, client retune, fetch and restore hooks.

The cases of ``tests/test_online.py`` on ``repro_torch.core.online``, on
the CPU (``device="cpu"``), with the reference's winners as the oracle
where a tuner's choice is a sweep's argmin, plus ``restore_checkpoint``
with a tuner over loopback mirrors.  Every client check that a tuner ran
asserts an adoption (``report.retunes >= 1`` or ``tuner.updates > 0``),
since a tuner that fails is silently skipped by design.
"""

import asyncio
import hashlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core import autotune as JT  # noqa: E402
from repro_torch.core import torch_sim as TS  # noqa: E402
from repro_torch.core.autotune import autotune_chunk_params  # noqa: E402
from repro_torch.core.chunking import ChunkParams  # noqa: E402
from repro_torch.core.online import (  # noqa: E402
    BanditTuner,
    GridTuner,
    MCGradTuner,
    Telemetry,
    _mc_loss,
    rtt_corrected_bandwidth,
    tune_chunk_params_mcgrad,
)
from repro_torch.transfer import RangeServer, Replica, Throttle  # noqa: E402
from repro_torch.transfer.client import MDTPClient  # noqa: E402

MB = 1024 * 1024
GB = 1024 * MB
CPU = torch.device("cpu")
BW = [50.0 * MB, 30.0 * MB, 10.0 * MB, 80.0 * MB]


def _tel(bw, rtt=0.03, remaining=512 * MB, throughput=0.0, elapsed=0.0):
    n = len(bw)
    rtt = (rtt,) * n if isinstance(rtt, float) else tuple(rtt)
    return Telemetry(bandwidth=tuple(bw), rtt=rtt,
                     remaining_bytes=float(remaining),
                     measured_throughput=float(throughput), elapsed=elapsed)


def _params(res):
    return (res.params.initial_chunk, res.params.large_chunk)


# -- Telemetry --------------------------------------------------------------

def test_telemetry_live_filters_dead_and_fills_rtt():
    t = _tel([50.0 * MB, 0.0, 10.0 * MB], rtt=(0.25, 0.0, 0.0))
    bw, rtts = t.live(default_rtt=0.07)
    assert bw == [50.0 * MB, 10.0 * MB]
    assert rtts == [0.25, 0.07]


def test_rtt_corrected_bandwidth_inverts_estimator_bias():
    for bw, rtt, s in [(70 * MB, 0.5, 40 * MB), (12 * MB, 0.03, 2 * MB)]:
        est = s / (rtt + s / bw)
        assert rtt_corrected_bandwidth(est, rtt, s) == pytest.approx(
            bw, rel=1e-6)
    assert rtt_corrected_bandwidth(5.0, 0.0, 1 * MB) == 5.0
    assert rtt_corrected_bandwidth(0.0, 0.5, 1 * MB) == 0.0


def test_telemetry_from_report_passes_wire_rates_through():
    from repro_torch.transfer.client import TransferReport

    replicas = [Replica("h0", 1, "/b"), Replica("h1", 2, "/b"),
                Replica("h2", 3, "/b")]
    report = TransferReport(
        total_bytes=1, elapsed=2.0,
        bytes_per_replica={"h0:1": 160 * MB, "h1:2": 8 * MB, "h2:3": MB},
        requests_per_replica={"h0:1": 4, "h1:2": 2, "h2:3": 1},
        failed_replicas=["h2:3"], refetched_ranges=0,
        observed_throughputs={"h0:1": 70.0 * MB, "h1:2": 20.0 * MB,
                              "h2:3": 5.0 * MB},
        observed_rtts={"h0:1": 0.5, "h1:2": 0.0, "h2:3": 0.02})
    tel = Telemetry.from_report(report, replicas, remaining_bytes=64 * MB)
    assert tel.bandwidth == (70.0 * MB, 20.0 * MB, 0.0)
    assert tel.rtt == (0.5, 0.0, 0.02)
    assert tel.remaining_bytes == 64 * MB


# -- MC-gradient tuner ------------------------------------------------------

def test_mc_loss_is_the_seed_average_of_scan_lanes():
    """The Monte-Carlo loss is the mean over ``n_seeds`` lanes of the scan
    core, each lane the same as a single-seed call (rel 1e-6)."""
    cfg = TS.SimConfig(max_rounds=128, exact_sizes=False, jitter=0.08,
                       rtt_jitter=0.25)
    args = TS._prep(BW, 0.03, None, None, CPU)
    f32 = lambda x: torch.tensor(float(x))  # noqa: E731
    z = torch.tensor([np.log(4.0 * MB), np.log(38.0 * MB)],
                     dtype=torch.float32)
    got = _mc_loss("proportional", cfg, 3)(z, *args, f32(256 * MB),
                                           f32(65536), f32(2 * MB))
    c, l = 65536 + torch.exp(z[0]), 2 * MB + torch.exp(z[1])
    want = [float(TS.simulate_transfer(
        BW, 0.03, 256 * MB, (c, l, f32(65536)), seed=s, config=cfg,
        engine="scan", device="cpu").total_time) for s in range(3)]
    assert float(got) == pytest.approx(float(np.mean(want)), rel=1e-6)
    assert len(set(want)) == 3          # the seeds draw differently


def test_mcgrad_never_worse_than_grid_init():
    grid = [(2 * MB, 20 * MB), (4 * MB, 40 * MB), (8 * MB, 80 * MB)]
    seed = autotune_chunk_params(BW, 0.03, 512 * MB, grid=grid, device="cpu")
    res = tune_chunk_params_mcgrad(
        BW, 0.03, 512 * MB, init=_params(seed), steps=6, n_seeds=2,
        max_rounds=256, device="cpu")
    assert res.steps == 6
    assert all(np.isfinite(t) for t in res.loss_history)
    assert np.all(np.isfinite(res.final_grad))
    t_init = float(TS.simulate_transfer(BW, 0.03, 512 * MB, seed.params,
                                        engine="round",
                                        device="cpu").total_time)
    assert res.predicted_time <= t_init + 1e-6


def test_mcgrad_tuner_update_adopts_and_warm_starts():
    tun = MCGradTuner(steps=4, n_seeds=2, max_rounds=128, device="cpu")
    assert tun.update(_tel([0.0, 0.0])) is None           # nothing live
    p = tun.update(_tel(BW, remaining=256 * MB))
    assert isinstance(p, ChunkParams)
    assert tun.params == p and tun.updates == 1
    p2 = tun.update(_tel(BW, remaining=200 * MB))
    assert isinstance(p2, ChunkParams) and tun.updates == 2


# -- bandit -----------------------------------------------------------------

def test_bandit_seeds_arms_from_grid_winner():
    grid = [(2 * MB, 20 * MB), (4 * MB, 40 * MB), (8 * MB, 80 * MB),
            (16 * MB, 160 * MB)]
    tun = BanditTuner(n_arms=3, grid=grid, device="cpu")
    p = tun.update(_tel(BW))
    expect = JT.autotune_chunk_params(BW, [0.03] * 4, 512 * MB, grid=grid)
    assert (p.initial_chunk, p.large_chunk) == _params(expect)
    assert len(tun.arms) == 3
    assert len({(a.params.initial_chunk, a.params.large_chunk)
                for a in tun.arms}) == 3


def test_bandit_explores_then_exploits_measured_best():
    grid = [(2 * MB, 20 * MB), (4 * MB, 40 * MB), (8 * MB, 80 * MB)]
    tun = BanditTuner(n_arms=3, grid=grid, gamma=1.0, explore=0.05,
                      device="cpu")
    tun.update(_tel(BW))
    rewards = {0: 0.5, 1: 0.95, 2: 0.1}
    played = []
    for _ in range(8):
        idx = tun._current
        played.append(idx)
        tun.update(_tel(BW, throughput=rewards[idx] * sum(BW)))
    assert set(played[:3]) == {0, 1, 2}
    assert played[-1] == 1
    assert tun.params == tun.arms[1].params


@pytest.mark.parametrize("drift", ["throttle", "death", "latency"])
def test_bandit_drift_resets(drift):
    mutate = {
        "throttle": lambda bw, rtt: (tuple(b * 0.2 if i == 3 else b
                                           for i, b in enumerate(bw)), rtt),
        "death": lambda bw, rtt: (tuple(0.0 if i == 3 else b
                                        for i, b in enumerate(bw)), rtt),
        "latency": lambda bw, rtt: (bw, tuple(r + 0.5 for r in rtt)),
    }[drift]
    grid = JT.default_grid()[::4]
    tun = BanditTuner(n_arms=2, grid=grid, device="cpu")
    tun.update(_tel(BW))
    assert tun.drift_resets == 0
    bw2, rtt2 = mutate(tuple(BW), (0.03,) * 4)
    p = tun.update(Telemetry(bw2, rtt2, 256 * MB,
                             measured_throughput=50 * MB))
    assert tun.drift_resets == 1
    assert p is not None
    assert all(a.n == 0.0 for a in tun.arms)


def test_bandit_steady_fleet_does_not_reset():
    tun = BanditTuner(n_arms=2, drift_threshold=0.6,
                      grid=JT.default_grid()[::4], device="cpu")
    tun.update(_tel(BW))
    tun.update(_tel(tuple(b * 1.2 for b in BW), throughput=60 * MB))
    assert tun.drift_resets == 0


def test_grid_tuner_tracks_the_reference_sweep():
    tun = GridTuner(device="cpu")
    p = tun.update(_tel(BW, remaining=256 * MB))
    expect = JT.autotune_chunk_params(BW, [0.03] * 4, 256 * MB)
    assert (p.initial_chunk, p.large_chunk) == _params(expect)
    assert tun.update(_tel([0.0] * 4)) is None


def test_tuner_without_a_card_raises_rather_than_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GridTuner().update(_tel(BW))


# -- client wiring ----------------------------------------------------------

class _ScriptedTuner:
    """Deterministic stand-in: records telemetry, returns a fixed param."""

    def __init__(self, params):
        self.params = params
        self.seen = []

    def update(self, t):
        self.seen.append(t)
        return self.params


def _mirrors(blob, rates):
    servers = []
    for r in rates:
        s = RangeServer(throttle=Throttle(bytes_per_s=r)).start()
        s.add_blob("/data", blob)
        servers.append(s)
    return servers


def _blob(seed, nbytes):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=nbytes, dtype=np.uint8).tobytes()


def test_fetch_tuner_hook_adopts_params_and_reports_retunes():
    blob = _blob(1, 6 * MB)
    servers = _mirrors(blob, [40 * MB, 80 * MB])
    try:
        replicas = [Replica("127.0.0.1", s.port, "/data") for s in servers]
        adopted = ChunkParams(initial_chunk=128 * 1024,
                              large_chunk=512 * 1024)
        tuner = _ScriptedTuner(adopted)
        client = MDTPClient(replicas, params=ChunkParams(256 * 1024, MB))
        buf, report = asyncio.run(client.fetch(
            len(blob), tuner=tuner, tune_interval_bytes=MB))
        assert hashlib.sha256(bytes(buf)).digest() == \
            hashlib.sha256(blob).digest()
        assert report.retunes >= 1
        tel = tuner.seen[0]
        assert len(tel.bandwidth) == 2 and len(tel.rtt) == 2
        assert any(b > 0 for b in tel.bandwidth)
        assert tel.measured_throughput > 0
        assert 0 <= tel.remaining_bytes < len(blob)
        assert client._params_arg == adopted
    finally:
        for s in servers:
            s.stop()


def test_fetch_with_the_port_grid_tuner_adopts():
    """The real tuner through the hook: a GridTuner on the CPU re-plans
    mid-transfer and its geometry is adopted."""
    blob = _blob(6, 8 * MB)
    servers = _mirrors(blob, [40 * MB, 80 * MB])
    try:
        replicas = [Replica("127.0.0.1", s.port, "/data") for s in servers]
        tuner = GridTuner(grid=[(256 * 1024, MB), (512 * 1024, 2 * MB)],
                          device="cpu")
        client = MDTPClient(replicas, params=ChunkParams(256 * 1024, MB),
                            tuner=tuner)
        buf, report = asyncio.run(client.fetch(len(blob),
                                               tune_interval_bytes=MB))
        assert bytes(buf) == blob
        assert report.retunes >= 1 and tuner.updates >= 1
        assert client._params_arg == tuner.params
    finally:
        for s in servers:
            s.stop()


def test_fetch_tuner_without_adoption_leaves_params_unpinned():
    blob = _blob(4, 4 * MB)
    servers = _mirrors(blob, [80 * MB])
    try:
        replicas = [Replica("127.0.0.1", s.port, "/data") for s in servers]

        class DeclineTuner:
            calls = 0

            def update(self, t):
                DeclineTuner.calls += 1
                return None

        client = MDTPClient(replicas, tuner=DeclineTuner())
        buf, report = asyncio.run(client.fetch(len(blob),
                                               tune_interval_bytes=MB))
        assert bytes(buf) == blob
        assert report.retunes == 0 and DeclineTuner.calls >= 1
        assert client._params_arg is None
    finally:
        for s in servers:
            s.stop()


def test_fetch_tuner_exception_does_not_fail_transfer():
    blob = _blob(5, 4 * MB)
    servers = _mirrors(blob, [80 * MB])
    try:
        replicas = [Replica("127.0.0.1", s.port, "/data") for s in servers]

        class ExplodingTuner:
            calls = 0

            def update(self, t):
                ExplodingTuner.calls += 1
                raise RuntimeError("tuner boom")

        client = MDTPClient(replicas, tuner=ExplodingTuner())
        buf, report = asyncio.run(client.fetch(len(blob),
                                               tune_interval_bytes=MB))
        assert bytes(buf) == blob
        assert report.retunes == 0 and ExplodingTuner.calls >= 1
    finally:
        for s in servers:
            s.stop()


def test_fetch_without_tuner_unchanged():
    blob = _blob(3, 2 * MB)
    servers = _mirrors(blob, [80 * MB])
    try:
        replicas = [Replica("127.0.0.1", s.port, "/data") for s in servers]
        client = MDTPClient(replicas, params=ChunkParams(256 * 1024, MB))
        buf, report = asyncio.run(client.fetch(len(blob)))
        assert bytes(buf) == blob
        assert report.retunes == 0
    finally:
        for s in servers:
            s.stop()


# -- restore ----------------------------------------------------------------

def test_restore_checkpoint_with_a_tuner_is_bit_exact_and_adopts(tmp_path):
    """restore_checkpoint(tuner=...) over three loopback mirrors: every
    leaf bit for bit, and the tuner ran and produced geometry.  The blob
    (184 MiB) is sized so the client's default telemetry cadence (every
    max(size / 8, 2 L) = 80 MiB at L = 40 MiB) fires mid-transfer."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint

    g = torch.Generator().manual_seed(0)
    state = {"w": torch.randn(44 << 20, generator=g),      # 176 MiB
             "e": torch.randn(4096, 1024, generator=g).to(torch.bfloat16),
             "s": torch.arange(7, dtype=torch.int32)}
    d = save_checkpoint(str(tmp_path), 2, state)
    servers = []
    for rate in (0, 0, 0):
        s = RangeServer(throttle=Throttle(bytes_per_s=rate)).start()
        for name in ("manifest.json", "data.bin"):
            s.add_file(f"/ckpt/step_0000000002/{name}", f"{d}/{name}")
        servers.append(s)
    tuner = GridTuner(grid=JT.default_grid()[::4], device="cpu")
    try:
        replicas = [Replica("127.0.0.1", s.port, "/ckpt") for s in servers]
        out, step = restore_checkpoint(str(tmp_path), state, step=2,
                                       replicas=replicas, tuner=tuner,
                                       device="cpu")
    finally:
        for s in servers:
            s.stop()
    assert step == 2
    for k, t in state.items():
        assert out[k].dtype == t.dtype and torch.equal(out[k], t), k
    assert tuner.updates > 0 and tuner.params is not None


@pytest.mark.parametrize("kw", ["wave_bytes", "manager", "resume", "mirror",
                                "shard_plan", "shardings"])
def test_restore_options_of_later_slices_are_refused(tmp_path, kw):
    """The reference's tail options are keywords of the port now, and so
    is ``shardings`` since the port has a sharding context: none is
    refused (the call gets as far as the missing checkpoint)."""
    from repro_torch.checkpoint import restore_checkpoint

    with pytest.raises(FileNotFoundError, match="manifest.json"):
        restore_checkpoint(str(tmp_path), {}, step=1, device="cpu",
                           **{kw: 1})


def test_client_accepts_a_tuner():
    reps = [Replica("127.0.0.1", 1, "/x")]
    t = _ScriptedTuner(None)
    assert MDTPClient(reps, tuner=t).tuner is t
