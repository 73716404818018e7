"""The port's tuners against ``repro.core.autotune``, on the CPU.

Same inputs through both packages.  Tolerances, stated per test:

* deterministic sweeps (no jitter): the same winner, times at rtol 1e-5;
* the scan core's loss and gradient at fixed z points against
  ``jax.value_and_grad``: value rtol 1e-4, gradient rtol 1e-3 with equal
  signs;
* the gradient polish: never worse than its grid init, within 1% of
  JAX's predicted time;
* jittered sweeps draw from other streams than ``jax.random``: their
  seed-averaged times (64 seeds) within 2% of JAX's.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import autotune as JT  # noqa: E402
from repro.core import jax_sim as JS  # noqa: E402
from repro.core.jax_alloc import ChunkArrays as JArrays  # noqa: E402
from repro.core.scenarios import (  # noqa: E402
    paper_baseline,
    with_added_latency,
    with_throttled_fastest,
)
from repro_torch.core import autotune as TT  # noqa: E402
from repro_torch.core import torch_sim as TS  # noqa: E402
from repro_torch.core.chunking import ChunkParams  # noqa: E402
from repro_torch.core.torch_alloc import ChunkArrays  # noqa: E402

MB = 1024 * 1024
GB = 1024 * MB
CPU = torch.device("cpu")
BW = [50.0 * MB, 30.0 * MB, 10.0 * MB, 80.0 * MB]


def _same(port, ref):
    """Same (C, L, mode) winner and times at rtol 1e-5."""
    assert (port.params.initial_chunk, port.params.large_chunk,
            port.params.mode) == (ref.params.initial_chunk,
                                  ref.params.large_chunk, ref.params.mode)
    assert port.grid == ref.grid
    np.testing.assert_allclose(port.predicted_times, ref.predicted_times,
                               rtol=1e-5)
    assert port.predicted_time == pytest.approx(ref.predicted_time, rel=1e-5)


def test_default_grid_is_table_ii():
    assert TT.default_grid() == JT.default_grid()
    assert len(TT.default_grid()) == 16


@pytest.mark.parametrize("engine", [None, "event", "scan"])
def test_autotune_chunk_params_picks_jax_winner(engine):
    port = TT.autotune_chunk_params(BW, 0.03, 2 * GB, engine=engine,
                                    device="cpu")
    ref = JT.autotune_chunk_params(BW, 0.03, 2 * GB, engine=engine)
    _same(port, ref)


@pytest.mark.parametrize("kw", [{"pipeline_depth": 2},
                                {"hedge_quantile": 0.9},
                                {"decode_bytes_per_s": 300.0 * MB},
                                {"mode": "static"}],
                         ids=lambda kw: next(iter(kw)))
def test_autotune_options_pick_jax_winner(kw):
    grid = JT.default_grid()[::2]
    port = TT.autotune_chunk_params(BW, [0.03, 0.05, 0.2, 0.03], 1 * GB,
                                    grid=grid, device="cpu", **kw)
    ref = JT.autotune_chunk_params(BW, [0.03, 0.05, 0.2, 0.03], 1 * GB,
                                   grid=grid, **kw)
    _same(port, ref)


def _paper_matrix():
    fleets = [paper_baseline(jitter=0.0)]
    fleets.append(with_added_latency(fleets[0]))
    fleets.append(with_throttled_fastest(fleets[0]))
    bw = [[s.bandwidth for s in f] for f in fleets]
    rtt = [[s.rtt for s in f] for f in fleets]
    tt = [[s.profile[0][0] if s.profile else np.inf for s in f]
          for f in fleets]
    tb = [[s.profile[0][1] if s.profile else s.bandwidth for s in f]
          for f in fleets]
    return (np.asarray(bw), np.asarray(rtt), np.asarray(tt),
            np.asarray(tb))


def test_sweep_scenarios_and_autotune_batch_match_jax():
    """The paper's three fleets (baseline, Fig. 3 latency, Fig. 4
    throttle) at per-scenario file sizes, the whole Table II grid."""
    bw, rtt, tt, tb = _paper_matrix()
    sizes = np.asarray([1 * GB, 2 * GB, 1 * GB])
    port = TT.sweep_scenarios(bw, rtt, sizes, throttle_t=tt, throttle_bw=tb,
                              device="cpu")
    ref = JT.sweep_scenarios(bw, rtt, sizes, throttle_t=tt, throttle_bw=tb)
    assert tuple(port.shape) == (3, 16)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5)
    for p, r in zip(TT.autotune_batch(bw, rtt, sizes, throttle_t=tt,
                                      throttle_bw=tb, device="cpu"),
                    JT.autotune_batch(bw, rtt, sizes, throttle_t=tt,
                                      throttle_bw=tb)):
        _same(p, r)


def test_contention_sweep_matches_jax():
    grid = JT.default_grid()[::3]
    port = TT.contention_sweep(BW, 0.03, 1 * GB, max_transfers=3, grid=grid,
                               device="cpu")
    ref = JT.contention_sweep(BW, 0.03, 1 * GB, max_transfers=3, grid=grid)
    assert sorted(port) == sorted(ref) == [1, 2, 3]
    for k in ref:
        _same(port[k], ref[k])


def test_swarm_sweep_matches_jax():
    grid = JT.default_grid()[::3]
    port = TT.swarm_sweep(512 * MB, origin_bw=96 * MB, ns=(2, 4), grid=grid,
                          device="cpu")
    ref = JT.swarm_sweep(512 * MB, origin_bw=96 * MB, ns=(2, 4), grid=grid)
    assert sorted(port) == sorted(ref) == [2, 4]
    for n in ref:
        _same(port[n], ref[n])


def test_jittered_sweep_seed_average_within_2pct_of_jax():
    """The scenarios' own jitter (0.02) over 64 seeds: seed-averaged times
    within 2% of JAX's, grid point by grid point."""
    grid = JT.default_grid()[::4]
    bw, rtt, tt, tb = _paper_matrix()
    port = TT.sweep_scenarios(bw, rtt, 1 * GB, grid=grid, throttle_t=tt,
                              throttle_bw=tb, jitter=0.02, n_seeds=64,
                              device="cpu")
    ref = JT.sweep_scenarios(bw, rtt, 1 * GB, grid=grid, throttle_t=tt,
                             throttle_bw=tb, jitter=0.02, n_seeds=64)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0.02)
    # the draws move the times: jittered and plain sweeps differ
    plain = TT.sweep_scenarios(bw, rtt, 1 * GB, grid=grid, throttle_t=tt,
                               throttle_bw=tb, device="cpu")
    assert not torch.equal(port, plain)


def test_fused_matches_per_point_monte_carlo():
    """Seed-averaged (jitter) sweep == per-point seed means (rel 1e-5)."""
    cfg = TS.SimConfig(jitter=0.2)
    grid = TT.default_grid()[:6]
    res = TT.autotune_chunk_params(BW, 0.03, 1 * GB, grid=grid, jitter=0.2,
                                   n_seeds=4, engine="event", device="cpu")
    for (c, l), t_fused in zip(grid, res.predicted_times):
        ts = [float(TS.simulate_transfer(BW, 0.03, 1 * GB, ChunkParams(c, l),
                                         seed=s, config=cfg,
                                         device="cpu").total_time)
              for s in range(4)]
        assert t_fused == pytest.approx(float(np.mean(ts)), rel=1e-5)


# -- the differentiable scan core and the gradient polish -------------------

@pytest.mark.parametrize("init", [(4 * MB, 40 * MB), (2 * MB, 20 * MB),
                                  (8 * MB, 27 * MB)])
def test_scan_loss_and_grad_match_jax_value_and_grad(init):
    """Value at rtol 1e-4; gradient at rtol 1e-3 with the same signs."""
    size, min_chunk, rounds = 512 * MB, 65536, 256
    l_floor = JT._l_floor_for(min_chunk, size, rounds)
    jcfg = JS.SimConfig(max_rounds=rounds, exact_sizes=False)
    tcfg = TS.SimConfig(max_rounds=rounds, exact_sizes=False)
    jargs = JS._prep(BW, 0.03, None, None)
    targs = [x[None] for x in TS._prep(BW, 0.03, None, None, CPU)]

    def jloss(z):
        c, l = JT._z_decode(z, min_chunk, l_floor)
        return JS.simulate_scan_core(
            *jargs, 0, JArrays(c, l, jnp.float32(min_chunk)),
            jnp.float32(size), mode="proportional", config=jcfg).total_time

    def tloss(z):
        c, l = TT._z_decode(z, min_chunk, l_floor)
        return TS.simulate_scan_core(
            *targs, 0, ChunkArrays(c, l, torch.tensor(float(min_chunk))),
            torch.tensor(float(size)), mode="proportional",
            config=tcfg).total_time[0]

    jv, jg = jax.value_and_grad(jloss)(JT._z_init(init, min_chunk, l_floor))
    tv, tg = TT._value_and_grad(tloss, CPU)(
        TT._z_init(init, min_chunk, l_floor))
    jg = np.asarray(jg)
    assert tv == pytest.approx(float(jv), rel=1e-4)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-3)
    assert (np.sign(tg.numpy()) == np.sign(jg)).all()
    assert np.any(jg != 0.0)


def test_grad_tuner_never_worse_than_grid_and_within_1pct_of_jax():
    grid = TT.default_grid()[:8]
    seed = TT.autotune_chunk_params(BW, 0.03, 512 * MB, grid=grid,
                                    device="cpu")
    res = TT.tune_chunk_params_grad(BW, 0.03, 512 * MB, steps=10,
                                    max_rounds=256, grid=grid, device="cpu")
    ref = JT.tune_chunk_params_grad(BW, 0.03, 512 * MB, steps=10,
                                    max_rounds=256, grid=grid)
    assert res.steps == 10
    assert all(np.isfinite(t) for t in res.loss_history)
    assert np.all(np.isfinite(res.final_grad))
    assert any(g != 0.0 for g in res.final_grad)
    assert res.predicted_time <= seed.predicted_time + 1e-6
    assert res.predicted_time == pytest.approx(ref.predicted_time, rel=0.01)
    assert min(res.loss_history) <= res.loss_history[0] + 1e-6
    assert res.params.large_chunk >= res.params.min_chunk


def test_client_retune_adopts_winner():
    """retune feeds the last report's throughputs to the sweep (on the
    device it is given) and adopts the winner for the next transfer."""
    from repro_torch.transfer.client import (MDTPClient, NoTelemetryError,
                                             Replica, TransferReport)

    replicas = [Replica("h0", 1, "/b"), Replica("h1", 2, "/b")]
    client = MDTPClient(replicas)
    with pytest.raises(NoTelemetryError):
        client.retune(2 * GB, device="cpu")
    client.last_report = TransferReport(
        total_bytes=1, elapsed=1.0, bytes_per_replica={},
        requests_per_replica={}, failed_replicas=[], refetched_ranges=0,
        observed_throughputs={"h0:1": 50.0 * MB, "h1:2": 10.0 * MB})
    res = client.retune(2 * GB, device="cpu")
    assert client._params_arg == res.params
    expect = JT.autotune_chunk_params([50.0 * MB, 10.0 * MB], 0.03, 2 * GB,
                                      pipeline_depth=client.pipeline_depth)
    _same(res, expect)
