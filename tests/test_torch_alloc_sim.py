"""The port's allocator and simulator cores against the JAX reference.

``repro_torch.core.torch_alloc`` / ``torch_sim`` run a batch of lanes on
one device; here on the CPU.  The same inputs, built with numpy from a
seed, go through ``repro.core.jax_alloc`` / ``jax_sim`` (one call per
lane) and through the port (one lane batch).  Tolerances, stated per test:

* allocator sizes and durations are elementwise float32 arithmetic in the
  same order: equal to 1e-6 relative;
* the three cores without randomness: ``total_time`` and
  ``bytes_per_server`` at rtol 1e-5, ``requests_per_server`` and ``iters``
  equal;
* draws cannot match ``jax.random`` streams, so jittered runs are held to
  the port's own per-point calls (a lane draws the same numbers whatever
  its batch holds).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import jax_alloc as JA  # noqa: E402
from repro.core import jax_sim as JS  # noqa: E402
from repro.core.chunking import ChunkParams as JParams  # noqa: E402
from repro.core.scenarios import (  # noqa: E402
    paper_baseline,
    with_added_latency,
    with_throttled_fastest,
)
from repro_torch.core import torch_alloc as TA  # noqa: E402
from repro_torch.core import torch_sim as TS  # noqa: E402
from repro_torch.core.chunking import ChunkParams  # noqa: E402

MB = 1024 * 1024
GB = 1024 * MB
CPU = torch.device("cpu")
BW = [50.0 * MB, 30.0 * MB, 10.0 * MB, 80.0 * MB]
MODES = ["proportional", "fast_get_large", "static"]


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _alloc_inputs(seed, lanes=12, n=6):
    rng = np.random.default_rng(seed)
    th = np.where(rng.random((lanes, n)) < 0.3, 0.0,
                  rng.uniform(1.0, 90.0, (lanes, n))) * MB
    remaining = rng.choice([0.0, 1.0 * MB, 37.0 * MB, 2.0 * GB], lanes)
    c = rng.choice([2.0, 4.0, 8.0], lanes) * MB
    l = c * rng.choice([2.5, 5.0, 10.0], lanes)
    m = np.full(lanes, 64 * 1024.0)
    return (th.astype(np.float32), remaining.astype(np.float32),
            c.astype(np.float32), l.astype(np.float32), m.astype(np.float32))


# -- allocator -------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("exact", [True, False])
def test_chunk_sizes_match_jax_per_lane(mode, exact):
    """Tolerance: rtol 1e-6 (same float32 operations in the same order)."""
    th, rem, c, l, m = _alloc_inputs(1)
    got = TA.chunk_sizes(_t(th), _t(rem),
                         TA.ChunkArrays(_t(c), _t(l), _t(m)), mode=mode,
                         exact=exact).numpy()
    for k in range(th.shape[0]):
        want = np.asarray(JA.chunk_sizes(
            jnp.asarray(th[k]), jnp.float32(rem[k]),
            (c[k], l[k], m[k]), mode=mode, exact=exact))
        np.testing.assert_allclose(got[k], want, rtol=1e-6, atol=0)


def test_chunk_sizes_accepts_params_arrays_and_triples():
    th = torch.tensor([10 * MB, 0.0, 45 * MB, 3 * MB])
    params = ChunkParams(4 * MB, 40 * MB)
    for remaining in (0.0, 1 * MB, 10 * GB):
        a = TA.chunk_sizes(th, remaining, params)
        b = TA.chunk_sizes(th, remaining, TA.ChunkArrays.from_params(params),
                           mode=params.mode)
        c = TA.chunk_sizes(th, remaining, params.as_triple())
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("exact", [True, False])
def test_round_allocate_matches_jax_with_eligible_and_draw_counts(mode,
                                                                  exact):
    """Tolerance: rtol 1e-6, atol 64 bytes (float32 sums of up to six
    sizes at the 2 GB budget scale, where one ulp is 256 bytes at most on
    the clamped element)."""
    th, rem, c, l, m = _alloc_inputs(2)
    rng = np.random.default_rng(3)
    lanes, n = th.shape
    key = rng.choice([0.0, 1.5, 2.5], (lanes, n)).astype(np.float32)
    eligible = rng.random((lanes, n)) < 0.8
    counts = rng.integers(0, 3, (lanes, n, n)).astype(np.float32)
    chunk = TA.ChunkArrays(_t(c), _t(l), _t(m))
    for use_counts in (False, True):
        g, tot = TA.round_allocate(
            _t(th), _t(rem), _t(key), chunk, mode=mode, exact=exact,
            eligible=torch.as_tensor(eligible),
            draw_counts=_t(counts) if use_counts else None)
        for k in range(lanes):
            gj, tj = JA.round_allocate(
                jnp.asarray(th[k]), jnp.float32(rem[k]), jnp.asarray(key[k]),
                (c[k], l[k], m[k]), mode=mode, exact=exact,
                eligible=jnp.asarray(eligible[k]),
                draw_counts=jnp.asarray(counts[k]) if use_counts else None)
            np.testing.assert_allclose(g[k].numpy(), np.asarray(gj),
                                       rtol=1e-6, atol=64.0)
            assert float(tot[k]) == pytest.approx(float(tj), rel=1e-6,
                                                  abs=64.0)


def test_round_allocate_replays_sequential_draws():
    """round_allocate == the event core's per-draw loop: the same grants in
    ask order, the endgame clamp and stable ties included (atol 64 bytes:
    float32 prefix sums at the 200 MB budget scale)."""
    params = ChunkParams(4 * MB, 40 * MB)
    rng = np.random.default_rng(3)
    for _ in range(20):
        n = int(rng.integers(2, 9))
        th = np.where(rng.random(n) < 0.3, 0.0,
                      rng.uniform(1.0, 90.0, size=n)) * MB
        remaining = float(rng.integers(0, 200 * MB))
        order_key = rng.choice([0.0, 1.5, 2.5], size=n)
        granted, total = TA.round_allocate(_t(th), remaining, _t(order_key),
                                           params)
        expect = np.zeros(n)
        rem = remaining
        for i in sorted(range(n), key=lambda i: (order_key[i], i)):
            s = float(TA.chunk_sizes(_t(th), rem, params)[i])
            expect[i] = s
            rem -= s
        np.testing.assert_allclose(granted.numpy(), expect, atol=64.0)
        assert float(total) == pytest.approx(expect.sum(), abs=64.0)


def test_chunk_duration_matches_jax():
    """Throttle before/inside/after a chunk, pipeline depth 2 (warm and
    cold), the decode term.  Tolerance: rtol 1e-6."""
    rng = np.random.default_rng(4)
    n = 64
    size = rng.uniform(0.0, 80.0, n).astype(np.float32) * MB
    t0 = rng.uniform(0.0, 10.0, n).astype(np.float32)
    rtt = rng.uniform(0.0, 0.2, n).astype(np.float32)
    bw0 = rng.uniform(1.0, 100.0, n).astype(np.float32) * MB
    tt = np.where(rng.random(n) < 0.3, np.inf,
                  rng.uniform(0.0, 12.0, n)).astype(np.float32)
    bw1 = (bw0 * rng.uniform(0.1, 2.0, n)).astype(np.float32)
    warm = rng.random(n) < 0.5
    lanes = TS._Lanes(*([None] * 9), zero=torch.tensor(0.0),
                      eps9=torch.tensor(1e-9), eps12=torch.tensor(1e-12),
                      decode_bw=torch.tensor(300.0 * MB))
    for depth, decode in ((1, False), (2, False), (1, True), (2, True)):
        got = TS._chunk_duration(
            _t(size), _t(t0), _t(rtt), _t(bw0), _t(tt), _t(bw1), lanes,
            depth=depth, warm=torch.as_tensor(warm), decode=decode)
        want = JS._chunk_duration(
            jnp.asarray(size), jnp.asarray(t0), jnp.asarray(rtt),
            jnp.asarray(bw0), jnp.asarray(tt), jnp.asarray(bw1),
            depth=depth, warm=jnp.asarray(warm),
            decode_bw=300.0 * MB if decode else 0.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# -- the three cores -------------------------------------------------------

def _axes(servers):
    bw = [s.bandwidth for s in servers]
    rtt = [s.rtt for s in servers]
    tt = [s.profile[0][0] if s.profile else np.inf for s in servers]
    tb = [s.profile[0][1] if s.profile else s.bandwidth for s in servers]
    return bw, rtt, tt, tb


def _fleet(name):
    servers = paper_baseline(jitter=0.0)
    if name == "latency":
        servers = with_added_latency(servers)
    elif name == "throttle":
        servers = with_throttled_fastest(servers)
    return _axes(servers)


#: the Fig. 2/3/4 suite of tests/test_round_sim.py plus the model's
#: switches: (fleet, GB, SimConfig kwargs, mode)
CASES = [
    ("baseline", 1, {}, "proportional"),
    ("baseline", 4, {}, "proportional"),
    ("latency", 4, {}, "proportional"),
    ("throttle", 1, {}, "proportional"),
    ("throttle", 4, {}, "proportional"),
    ("latency", 1, {"pipeline_depth": 2}, "proportional"),
    ("throttle", 1, {"hedge_quantile": 0.9}, "proportional"),
    ("baseline", 1, {"decode_bytes_per_s": 400.0 * MB}, "proportional"),
    ("throttle", 1, {"pipeline_depth": 2, "hedge_quantile": 0.9,
                     "decode_bytes_per_s": 400.0 * MB}, "fast_get_large"),
    ("baseline", 1, {}, "static"),
]


@pytest.mark.parametrize("engine", ["event", "round", "scan"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}GB-"
                         f"{'-'.join(sorted(c[2])) or 'plain'}-{c[3]}")
def test_core_matches_jax_core(engine, case):
    """Tolerance: total_time and bytes_per_server rtol 1e-5; requests and
    iterations equal."""
    fleet, gb, kw, mode = case
    bw, rtt, tt, tb = _fleet(fleet)
    jcfg, tcfg = JS.SimConfig(**kw), TS.SimConfig(**kw)
    c, l = (8 * MB, 8 * MB) if mode == "static" else (4 * MB, 40 * MB)
    j = JS.simulate_transfer(bw, rtt, gb * GB, JParams(c, l, mode=mode),
                             throttle_t=tt, throttle_bw=tb, config=jcfg,
                             engine=engine)
    t = TS.simulate_transfer(bw, rtt, gb * GB, ChunkParams(c, l, mode=mode),
                             throttle_t=tt, throttle_bw=tb, config=tcfg,
                             engine=engine, device="cpu")
    assert np.isfinite(float(t.total_time))
    assert float(t.total_time) == pytest.approx(float(j.total_time),
                                                rel=1e-5)
    np.testing.assert_allclose(t.bytes_per_server.numpy(),
                               np.asarray(j.bytes_per_server), rtol=1e-5)
    np.testing.assert_array_equal(t.requests_per_server.numpy(),
                                  np.asarray(j.requests_per_server))
    assert int(t.iters) == int(j.iters)


def test_truncated_run_reports_inf():
    params = ChunkParams(4 * MB, 40 * MB)
    sc = TS.simulate_transfer(BW, 0.03, 1 * GB, params, device="cpu",
                              config=TS.SimConfig(max_rounds=4),
                              engine="scan")
    assert np.isinf(float(sc.total_time))
    assert float(sc.bytes_per_server.sum()) < 1 * GB
    for engine in ("event", "round"):
        r = TS.simulate_transfer(BW, 0.03, 1 * GB, params, device="cpu",
                                 config=TS.SimConfig(max_iters=3),
                                 engine=engine)
        assert np.isinf(float(r.total_time))
        assert int(r.iters) == 3           # the bound holds per lane
    ok = TS.simulate_transfer(BW, 0.03, 1 * GB, params, device="cpu",
                              config=TS.SimConfig(max_rounds=64),
                              engine="scan")
    assert np.isfinite(float(ok.total_time))


def test_max_iters_applies_per_lane():
    """A short lane finishes; a long lane in the same batch stops at
    max_iters and reports inf, with its iteration count frozen there."""
    n = len(BW)
    bw = torch.tensor([BW, BW])
    rtt = torch.full((2, n), 0.03)
    tt = torch.full((2, n), float("inf"))
    chunk = TA.ChunkArrays(torch.tensor(4.0 * MB), torch.tensor(40.0 * MB),
                           torch.tensor(65536.0))
    sizes = torch.tensor([64.0 * MB, 4.0 * GB])
    cfg = TS.SimConfig(max_iters=40)
    for core in (TS.simulate_core, TS.simulate_round_core):
        r = core(bw, rtt, tt, bw, 0, chunk, sizes, mode="proportional",
                 config=cfg)
        assert np.isfinite(float(r.total_time[0]))
        assert np.isinf(float(r.total_time[1]))
        assert int(r.iters[1]) == 40 and int(r.iters[0]) < 40


@pytest.mark.parametrize("engine", ["event", "round", "scan"])
@pytest.mark.parametrize("jitter", [0.0, 0.2])
def test_lane_batch_equals_per_point_calls(engine, jitter):
    """(C, L) × seed lanes in one batch == one call per point; with jitter
    too, since every lane's draws are keyed by its own seed.  Tolerance:
    rtol 1e-6 (reductions over the server axis may vectorize differently
    with the batch size)."""
    grid = [(2 * MB, 20 * MB), (4 * MB, 10 * MB), (8 * MB, 80 * MB)]
    seeds = [0, 5]
    cfg = TS.SimConfig(jitter=jitter, rtt_jitter=jitter / 2,
                       loss_rate=0.05 if jitter else 0.0)
    n = len(BW)
    lanes = [(c, l, s) for c, l in grid for s in seeds]
    b = len(lanes)
    core = TS._CORES[engine]
    res = core(torch.tensor([BW] * b), torch.full((b, n), 0.03),
               torch.full((b, n), float("inf")), torch.tensor([BW] * b),
               torch.tensor([s for _, _, s in lanes]),
               TA.ChunkArrays(torch.tensor([float(c) for c, _, _ in lanes]),
                              torch.tensor([float(l) for _, l, _ in lanes]),
                              torch.full((b,), 65536.0)),
               torch.tensor(512.0 * MB), mode="proportional", config=cfg)
    for k, (c, l, s) in enumerate(lanes):
        one = TS.simulate_transfer(BW, 0.03, 512 * MB, ChunkParams(c, l),
                                   seed=s, config=cfg, engine=engine,
                                   device="cpu")
        assert float(res.total_time[k]) == pytest.approx(
            float(one.total_time), rel=1e-6)
        assert torch.equal(res.requests_per_server[k],
                           one.requests_per_server)
        assert int(res.iters[k]) == int(one.iters)
    if jitter:      # the draws do move the result, seed by seed
        t = res.total_time.reshape(len(grid), len(seeds))
        assert bool((t[:, 0] != t[:, 1]).all())


def test_scan_matches_round_when_bound_covers():
    """The scan engine is the round step under a fixed trip count: equal
    totals when max_rounds covers the transfer, jitter included."""
    for seed in (0, 3):
        cfg = TS.SimConfig(jitter=0.1, max_rounds=128)
        rd = TS.simulate_transfer(BW, 0.03, 1 * GB, ChunkParams(4 * MB,
                                                               40 * MB),
                                  seed=seed, config=cfg, engine="round",
                                  device="cpu")
        sc = TS.simulate_transfer(BW, 0.03, 1 * GB, ChunkParams(4 * MB,
                                                               40 * MB),
                                  seed=seed, config=cfg, engine="scan",
                                  device="cpu")
        assert float(sc.total_time) == float(rd.total_time)
        assert torch.equal(sc.bytes_per_server, rd.bytes_per_server)
        assert int(sc.iters) == int(rd.iters)


def test_draws_are_standard_and_independent():
    """The counter-based draws: uniforms in (0, 1) with mean 1/2, normals
    with mean 0 and variance 1, lognormal scales of mean 1 (tolerances
    are five standard errors at 2**16 draws), no two streams alike."""
    k = 1 << 16
    sh = TS._seed_hash(torch.arange(4))
    counter = torch.arange(k // 4)
    h = TS._hash(sh[:, None], counter[None, :], torch.tensor(0), 1)
    u = TS._uniform(h).flatten()
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 5 * (1 / 12) ** 0.5 / k ** 0.5
    z = TS._normal(h).flatten()
    assert abs(float(z.mean())) < 5 / k ** 0.5
    assert abs(float(z.var()) - 1.0) < 5 * 2 ** 0.5 / k ** 0.5
    s = TS._lognormal_scale(h, 0.2).double().flatten()
    assert abs(float(s.mean()) - 1.0) < 5 * 0.21 / k ** 0.5
    other = TS._hash(sh[:, None], counter[None, :], torch.tensor(0), 2)
    assert float((other == h).double().mean()) < 1e-3
    assert bool((h >= 0).all() and (h < 2 ** 32).all())


def test_resolve_engine_routing():
    assert TS.resolve_engine(None, "proportional") == "round"
    assert TS.resolve_engine("auto", "fast_get_large") == "round"
    assert TS.resolve_engine(None, "static") == "event"
    assert TS.resolve_engine("scan", "static") == "scan"
    with pytest.raises(ValueError):
        TS.resolve_engine("warp", "proportional")


def test_scan_grad_finite_nonzero_and_matches_finite_difference():
    """autograd of the scan core's total time in (C, L) is finite, nonzero,
    and its L entry agrees with a finite difference (rel 0.3, as the
    reference's test holds ``jax.grad``)."""
    bw, rtt, tt, tb = (x[None] for x in TS._prep(BW, 0.03, None, None, CPU))
    cfg = TS.SimConfig(max_rounds=256, exact_sizes=False)

    def total_time(cl):
        chunk = TA.ChunkArrays(cl[0], cl[1], torch.tensor(65536.0))
        return TS.simulate_scan_core(bw, rtt, tt, tb, 0, chunk,
                                     torch.tensor(1.0 * GB),
                                     mode="proportional",
                                     config=cfg).total_time[0]

    cl0 = torch.tensor([4.0 * MB, 40.0 * MB], requires_grad=True)
    t0 = total_time(cl0)
    (g,) = torch.autograd.grad(t0, cl0)
    t0 = t0.detach()
    assert np.isfinite(float(t0)) and float(t0) > 0.0
    assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
    h = 256.0
    with torch.no_grad():
        fd = (float(total_time(cl0 + torch.tensor([0.0, h]))) - float(t0)) / h
    assert float(g[1]) == pytest.approx(fd, rel=0.3, abs=1e-10)


def test_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.simulate_transfer(BW, 0.03, 64 * MB, ChunkParams(4 * MB, 40 * MB))
