"""Checkpoints cross between the JAX package and the port, bit for bit.

JAX saves and the port restores through three loopback MDTP mirrors, one
of which dies mid-restore (the shape of
``tests/test_checkpoint.py::test_multi_source_restore_survives_mirror_death``);
the port saves and JAX restores.  bf16 leaves included.  A further test
runs the slice end to end on the CPU: a JAX-saved qwen3 (reduced)
checkpoint restored over MDTP into the port's decoder decodes like JAX.

The rest is the restore stack's tail options, at ``device="cpu"`` over
loopback mirrors (the case lists of the reference's
``tests/test_checkpoint.py`` and the resume cases of
``tests/test_faults.py``): waves with a grid re-tune or an online tuner,
a ``TransferManager`` fleet, crash-resume from a spool and a journal, a
peer-mirror broadcast, ``RestoreOptions`` and ``CheckpointManager``; and
a JAX-saved checkpoint restored through the port's wave, resume and
shard paths equal, bit for bit, to the JAX package's own restore.

A crash is made certain, not timed: the restore's sink raises on the
commit that brings its coverage to 40% of the blob, as a process that
dies there would stop.  Every socket case is bounded, stops its servers
in the ``loopback`` fixture's teardown, and leaves no thread behind
(``no_thread_left``).
"""

import json
import os
import threading

import numpy as np
import pytest
from torch_loopback import arun, loopback, no_thread_left  # noqa: F401

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro_torch.checkpoint import (latest_step, restore_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.transfer import Replica  # noqa: E402
from repro_torch.weights import flatten, tensor_to_numpy  # noqa: E402

KB = 1024
MB = 1024 * 1024


def _jax_state():
    rng = np.random.default_rng(0)
    return {
        "params": {
            "w": jnp.asarray(rng.standard_normal((1024, 1024)), jnp.float32),
            "e": jnp.asarray(rng.standard_normal((1001, 513)), jnp.bfloat16),
            "s": jnp.asarray(rng.standard_normal((7,)), jnp.bfloat16),
        },
        "step": jnp.int32(1234),
        "mask": jnp.asarray(rng.random(5) > 0.5),
    }


def _assert_bits_equal(np_tree, torch_tree):
    a, b = flatten(np_tree), flatten(torch_tree)
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), tensor_to_numpy(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def _mirrors(loopback, d, step, rates):
    return [loopback.checkpoint(d, step, rate=bw) for bw in rates]


def _reps(servers):
    return [Replica("127.0.0.1", s.port, "/ckpt") for s in servers]


def _kill(server):
    server.stop()
    server.kill_connections()


def test_jax_save_port_restore_three_mirrors_one_dies(tmp_path, loopback):
    state = _jax_state()
    d = jax_save(str(tmp_path), 7, state)
    servers = _mirrors(loopback, d, 7, (2 * MB, 25 * MB, 50 * MB))
    victim = servers[0]
    timer = threading.Timer(0.05, _kill, args=(victim,))
    timer.start()
    try:
        restored, step = loopback.bounded(lambda: restore_checkpoint(
            str(tmp_path), state, step=7, replicas=_reps(servers),
            device="cpu"))
    finally:
        timer.join()
    assert step == 7
    _assert_bits_equal(jax.device_get(state), restored)
    total = os.path.getsize(os.path.join(d, "data.bin"))
    assert victim.served_bytes < total       # it died owing bytes


def test_port_save_jax_restore(tmp_path):
    state = {
        "params": {
            "w": torch.randn(64, 33, generator=torch.Generator().manual_seed(0)),
            "e": torch.randn(17, 5).to(torch.bfloat16),
        },
        "step": torch.tensor(5, dtype=torch.int32),
    }
    save_checkpoint(str(tmp_path), 3, state)
    assert latest_step(str(tmp_path)) == 3
    like = {"params": {"w": 0, "e": 0}, "step": 0}
    restored, step = jax_restore(str(tmp_path), like)
    assert step == 3
    _assert_bits_equal(jax.device_get(restored), state)
    # and the port reads its own checkpoint back from local files
    again, _ = restore_checkpoint(str(tmp_path), like, device="cpu")
    _assert_bits_equal(jax.device_get(restored), again)


def test_port_save_is_byte_identical_to_jax_save(tmp_path):
    state = _jax_state()
    dj = jax_save(str(tmp_path / "jax"), 1, state)
    from repro_torch.weights import to_torch

    dt = save_checkpoint(str(tmp_path / "torch"), 1,
                         to_torch(jax.device_get(state), "cpu"))
    for name in ("data.bin", "manifest.json"):
        with open(os.path.join(dj, name), "rb") as a, \
                open(os.path.join(dt, name), "rb") as b:
            assert a.read() == b.read(), name


def test_jax_checkpoint_restores_into_port_decoder_over_mdtp(tmp_path,
                                                            loopback):
    """The slice on the CPU: save (JAX) -> three mirrors -> restore (port)
    -> decode; logits match JAX's at float32."""
    from repro.configs import reduced_config as jax_reduced
    from repro.models import transformer as JT
    from repro.models.common import init_params
    from repro_torch.configs import reduced_config
    from repro_torch.models import transformer as TT

    jcfg = jax_reduced("qwen3-1.7b").replace(dtype="float32")
    tcfg = reduced_config("qwen3-1.7b").replace(dtype="float32")
    jp = init_params(jax.random.PRNGKey(0), JT.model_specs(jcfg), jnp.float32)
    d = jax_save(str(tmp_path), 11, jp)
    servers = _mirrors(loopback, d, 11, (0, 0, 0))
    tree, _ = loopback.bounded(lambda: restore_checkpoint(
        str(tmp_path), TT.model_specs(tcfg), replicas=_reps(servers),
        device="cpu"))
    model = TT.Decoder(tcfg, tree, device="cpu")
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 4))
    jcache = JT.init_cache(jcfg, 2, 4)
    tcache = TT.init_cache(tcfg, 2, 4, "cpu")
    step = jax.jit(lambda p, c, t, s: JT.decode_step(p, jcfg, c, t, s))
    for t in range(4):
        lj, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                          jnp.int32(t))
        lt, tcache = model(tcache, torch.from_numpy(toks[:, t:t + 1]),
                           torch.tensor(t, dtype=torch.int32))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   atol=1e-4, rtol=1e-4)


def test_streaming_restore_handles_split_overlapping_deliveries(tmp_path):
    """Leaves land on the device as soon as their bytes are complete,
    whatever order and overlap the ranges arrive in."""
    from repro_torch.checkpoint.manager import _StreamingRestore

    state = {"a": torch.arange(1000, dtype=torch.float32),
             "b": torch.ones((3, 7), dtype=torch.int32),
             "c": torch.tensor(2.5).to(torch.bfloat16)}
    d = save_checkpoint(str(tmp_path), 1, state)
    manifest, blob = _read(d)
    stream = _StreamingRestore(manifest, state, torch.device("cpu"))
    with pytest.raises(IOError):
        stream.finish()

    def deliver(lo, hi):
        stream.writable(lo, hi - lo)[:] = blob[lo:hi]
        stream.commit(lo, hi - lo)

    total = len(blob)
    deliver(total - 50, total)           # tail first
    deliver(10, 3000)
    deliver(0, 20)                       # overlaps the range before
    deliver(2500, total - 10)            # overlaps both neighbours
    out = stream.finish()
    for k, t in state.items():
        assert out[k].dtype == t.dtype and torch.equal(out[k], t), k


# -- the tail options ---------------------------------------------------------

def _torch_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((512, 512), generator=g),
                       "e": torch.randn((301, 129), generator=g
                                        ).to(torch.bfloat16),
                       "b": torch.arange(128, dtype=torch.float32)},
            "step": torch.tensor(9, dtype=torch.int32)}


def _same(a, b):
    la, lb = dict(tree_leaves(a)), dict(tree_leaves(b))
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]), k


def _total(d):
    return os.path.getsize(os.path.join(d, "data.bin"))


def _read(d):
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(d, "data.bin"), "rb") as f:
        return manifest, f.read()


class _Scripted:
    """An online tuner that adopts one fixed geometry per update."""

    def __init__(self, fail=False):
        self.calls = 0
        self.fail = fail

    def update(self, telemetry):
        from repro_torch.core.chunking import ChunkParams

        self.calls += 1
        if self.fail:
            raise RuntimeError("tuner bug")
        return ChunkParams(initial_chunk=64 * KB, large_chunk=256 * KB)


def _count_retunes(monkeypatch):
    """Record the device of every ``MDTPClient.retune`` call."""
    from repro_torch.transfer import MDTPClient

    calls = []
    retune = MDTPClient.retune

    def counted(self, size, **kw):
        calls.append(kw.get("device"))
        return retune(self, size, **kw)

    monkeypatch.setattr(MDTPClient, "retune", counted)
    return calls


class _Crash(RuntimeError):
    """The restoring process dies here."""


def _crash_at(monkeypatch, fraction):
    """The streaming restore's commit raises once the sink's coverage
    reaches ``fraction`` of the blob (the bytes of that range are in the
    spool, but the journal never records them)."""
    from repro_torch.checkpoint.manager import _StreamingRestore

    commit = _StreamingRestore.commit

    def crashing(self, start, nbytes):
        commit(self, start, nbytes)
        covered = sum(n for _, n in self.covered_intervals())
        if covered >= fraction * self.total_bytes:
            raise _Crash(f"stopped at {covered} of {self.total_bytes} bytes")

    monkeypatch.setattr(_StreamingRestore, "commit", crashing)


def test_restore_waves_retune_on_the_grid(tmp_path, monkeypatch, loopback):
    """Three waves with the client's grid ``retune`` between them (on the
    CPU here): every byte lands once, and the re-tune ran."""
    calls = _count_retunes(monkeypatch)
    state = _torch_state(4)
    d = save_checkpoint(str(tmp_path), 400, state)
    servers = _mirrors(loopback, d, 400, (30 * MB, 60 * MB))
    out, step = loopback.bounded(lambda: restore_checkpoint(
        str(tmp_path), state, step=400, replicas=_reps(servers),
        wave_bytes=_total(d) // 3 + 1, device="cpu"))
    assert step == 400
    _same(state, out)
    assert len(calls) == 2 and all(str(dev) == "cpu" for dev in calls)


@pytest.mark.parametrize("fail", [False, True])
def test_restore_waves_with_online_tuner(tmp_path, fail, loopback):
    """The tuner is fed once per wave boundary; a tuner that raises never
    fails the restore."""
    state = {"w": torch.randn((700, 700),
                              generator=torch.Generator().manual_seed(5))}
    d = save_checkpoint(str(tmp_path), 500, state)
    servers = _mirrors(loopback, d, 500, (50 * MB,))
    tuner = _Scripted(fail=fail)
    out, _ = loopback.bounded(lambda: restore_checkpoint(
        str(tmp_path), state, step=500, replicas=_reps(servers), tuner=tuner,
        wave_bytes=_total(d) // 2 + 1, device="cpu"))
    _same(state, out)
    assert tuner.calls == 1             # two waves, one boundary


def test_restore_options_dataclass_and_kwarg_override(tmp_path, loopback):
    """``options=RestoreOptions(...)`` carries the tail options; a bare
    keyword overrides its field."""
    from repro_torch.checkpoint import RestoreOptions

    state = {"w": torch.randn((600, 600),
                              generator=torch.Generator().manual_seed(8))}
    d = save_checkpoint(str(tmp_path), 5, state)
    reps = _reps(_mirrors(loopback, d, 5, (50 * MB,)))
    in_options, in_kwarg = _Scripted(), _Scripted()
    opts = RestoreOptions(tuner=in_options, wave_bytes=_total(d) // 3 + 1)
    out, _ = loopback.bounded(lambda: restore_checkpoint(
        str(tmp_path), state, 5, reps, opts, device="cpu"))
    _same(state, out)
    assert in_options.calls == 2
    out, _ = loopback.bounded(lambda: restore_checkpoint(
        str(tmp_path), state, 5, reps, opts, tuner=in_kwarg, device="cpu"))
    _same(state, out)
    assert in_options.calls == 2 and in_kwarg.calls == 2


def test_restore_via_manager(tmp_path, monkeypatch, loopback):
    """Through a ``TransferManager``: per-replica caps hold across the
    manifest and wave fetches, the fleet model sees both mirrors, and the
    between-wave re-tune's geometry persists on the manager."""
    from repro_torch.core.chunking import ChunkParams
    from repro_torch.transfer import TransferManager

    calls = _count_retunes(monkeypatch)
    state = {"w": torch.randn((600, 600),
                              generator=torch.Generator().manual_seed(6))}
    d = save_checkpoint(str(tmp_path), 600, state)
    servers = _mirrors(loopback, d, 600, (30 * MB, 60 * MB))
    reps = _reps(servers)
    start = ChunkParams(initial_chunk=128 * KB, large_chunk=512 * KB)
    mgr = TransferManager(reps, params=start, max_inflight_per_replica=1)
    out, step = loopback.bounded(lambda: restore_checkpoint(
        str(tmp_path), state, step=600, replicas=reps, manager=mgr,
        wave_bytes=_total(d) // 2 + 1, device="cpu"))
    assert step == 600
    _same(state, out)
    snap = mgr.snapshot()
    assert {r.name for r in reps} <= set(snap)
    assert all(v["chunks"] > 0 for v in snap.values())
    for s in servers:
        assert s.peak_concurrent_requests <= 1
    assert len(calls) == 1
    assert mgr.params is not None and mgr.params != start


def test_restore_via_manager_with_a_tuner_owns_adaptation(tmp_path,
                                                          monkeypatch,
                                                          loopback):
    """A manager that owns a tuner adapts through its shared hook: the
    between-wave grid re-tune is skipped.  An explicit ``tuner=`` wins:
    it gets one update per wave boundary and the manager's tuner none."""
    from repro_torch.core.chunking import ChunkParams
    from repro_torch.transfer import TransferManager

    calls = _count_retunes(monkeypatch)
    state = _torch_state(9)
    d = save_checkpoint(str(tmp_path), 3, state)
    reps = _reps(_mirrors(loopback, d, 3, (50 * MB, 50 * MB)))
    shared = _Scripted()
    mgr = TransferManager(reps, tuner=shared,
                          params=ChunkParams(128 * KB, 256 * KB))
    wave = _total(d) // 3 + 1
    out, _ = loopback.bounded(lambda: restore_checkpoint(
        str(tmp_path), state, step=3, replicas=reps, manager=mgr,
        wave_bytes=wave, device="cpu"))
    _same(state, out)
    assert calls == []
    own, before = _Scripted(), shared.calls
    out, _ = loopback.bounded(lambda: restore_checkpoint(
        str(tmp_path), state, step=3, replicas=reps, manager=mgr,
        tuner=own, wave_bytes=wave, device="cpu"))
    _same(state, out)
    assert calls == [] and own.calls == 2 and shared.calls == before


def test_restore_resume_fetches_only_missing(tmp_path, loopback):
    """A scratch dir seeded with the first half of the blob (spool and
    journal) makes the mirror serve only the tail; a completed restore
    deletes both files."""
    import zlib

    from repro_torch.transfer import ResumeJournal

    state = {"w": torch.randn((512, 512),
                              generator=torch.Generator().manual_seed(0)),
             "step": torch.tensor(3, dtype=torch.int32)}
    d = save_checkpoint(str(tmp_path / "ckpt"), 300, state)
    total = _total(d)
    _, payload = _read(d)
    scratch = tmp_path / "scratch"
    scratch.mkdir()
    half = total // 2
    with open(scratch / "data.spool", "wb") as f:
        f.write(payload[:half])
        f.truncate(total)
    jr = ResumeJournal.open(str(scratch / "journal.log"), total,
                            meta={"step": 300})
    jr.record(0, half, zlib.crc32(payload[:half]))
    jr.close()
    srv = loopback.checkpoint(d, 300)
    out, step = loopback.bounded(lambda: restore_checkpoint(
        str(tmp_path / "ckpt"), state, step=300, replicas=_reps([srv]),
        resume=str(scratch), device="cpu"))
    assert step == 300
    _same(state, out)
    assert srv.served_bytes < total - half // 2
    assert not os.path.exists(scratch / "journal.log")
    assert not os.path.exists(scratch / "data.spool")


def test_restore_resume_after_a_crash_mid_restore(tmp_path, monkeypatch,
                                                  loopback):
    """The first run dies at 40% of the blob and raises; a second run over
    fresh mirrors fetches the blob less what the journal holds (plus the
    manifest, and the ranges the first run had landed but not yet
    journaled), lands every leaf exactly, and retires the scratch
    state."""
    from repro_torch.transfer import ResumeJournal

    state = _torch_state(2)
    state["params"]["v"] = torch.randn(
        (768, 768), generator=torch.Generator().manual_seed(1))
    root = str(tmp_path / "ckpt")
    d = save_checkpoint(root, 1, state)
    total = _total(d)
    scratch = str(tmp_path / "scratch")
    first = _mirrors(loopback, d, 1, (0, 0))
    _crash_at(monkeypatch, 0.4)
    with pytest.raises(_Crash):
        loopback.bounded(lambda: restore_checkpoint(
            root, state, step=1, replicas=_reps(first), resume=scratch,
            device="cpu"))
    monkeypatch.undo()
    jr = ResumeJournal.open(os.path.join(scratch, "journal.log"), total,
                            meta={"step": 1})
    journaled = sum(n for _, n in jr.covered())
    jr.close()
    assert 0 < journaled < 0.4 * total
    assert os.path.getsize(os.path.join(scratch, "data.spool")) == total
    fresh = _mirrors(loopback, d, 1, (0, 0))
    out, _ = loopback.bounded(lambda: restore_checkpoint(
        root, state, step=1, replicas=_reps(fresh), resume=scratch,
        device="cpu"))
    _same(state, out)
    manifest_bytes = os.path.getsize(os.path.join(d, "manifest.json"))
    served = sum(s.served_bytes for s in fresh)
    assert manifest_bytes + (total - journaled) <= served
    assert served <= manifest_bytes + total - journaled + 0.4 * total
    assert not os.path.exists(os.path.join(scratch, "journal.log"))
    assert not os.path.exists(os.path.join(scratch, "data.spool"))


def test_fetch_resume_after_a_failed_sink_is_byte_exact(tmp_path, loopback):
    """The client-level resume: a journaled fetch whose sink fails at a
    third of the blob raises; the second fetch into the same sink replays
    the journal and asks the mirrors only for what it lacks."""
    from repro_torch.core.chunking import ChunkParams
    from repro_torch.transfer import BufferSink, MDTPClient, ResumeJournal

    blob = np.random.default_rng(11).integers(
        0, 256, size=MB, dtype=np.uint8).tobytes()
    servers = [loopback.server({"/data": blob}) for _ in range(2)]
    replicas = [Replica("127.0.0.1", s.port, "/data") for s in servers]
    params = ChunkParams(initial_chunk=64 * KB, large_chunk=128 * KB)
    jpath = str(tmp_path / "resume.log")

    class FailingSink(BufferSink):
        armed = True

        def commit(self, start, nbytes):
            super().commit(start, nbytes)
            covered = sum(n for _, n in self.covered_intervals())
            if self.armed and covered >= len(self) // 3:
                raise _Crash("sink failed")

    sink = FailingSink(len(blob))

    async def leg():
        jr = ResumeJournal.open(jpath, len(blob))
        try:
            return await MDTPClient(replicas, params=params).fetch(
                len(blob), sink=sink, resume=jr)
        finally:
            jr.close()

    with pytest.raises(_Crash):
        arun(leg())
    served_first = sum(s.served_bytes for s in servers)
    jr = ResumeJournal.open(jpath, len(blob))
    resumed = sum(n for _, n in jr.covered())
    jr.close()
    assert 0 < resumed < len(blob) // 3
    sink.armed = False
    _, report = arun(leg())
    assert bytes(sink) == blob
    assert report.resumed_bytes == resumed
    served_second = sum(s.served_bytes for s in servers) - served_first
    assert len(blob) - resumed <= served_second
    assert served_second <= len(blob) - resumed + len(blob) // 3


def test_spool_is_unmapped_with_no_view_left(tmp_path, monkeypatch):
    """A spool-backed restore copies each leaf off the map, so ``close``
    unmaps it at the first try: no ``torch.frombuffer`` view survives."""
    import gc

    from repro_torch.checkpoint.manager import _StreamingRestore

    state = _torch_state(3)
    d = save_checkpoint(str(tmp_path), 1, state)
    manifest, blob = _read(d)
    stream = _StreamingRestore(manifest, state, torch.device("cpu"),
                               spool_path=str(tmp_path / "spool"))
    stream.sink(0, blob)
    out = stream.finish()
    _same(state, out)
    mm = stream._mmap

    def no_collect(*a):
        raise AssertionError("close() needed a collection: a view of the "
                             "spool was still alive")

    monkeypatch.setattr(gc, "collect", no_collect)
    stream.close()
    assert mm.closed
    _same(state, out)               # the leaves never aliased the map


def test_spool_keeps_an_existing_spools_bytes(tmp_path):
    """A spool that is already there, at the blob's size, is mapped as it
    is: the resume path re-verifies the journal against those bytes."""
    from repro_torch.checkpoint.manager import _StreamingRestore

    state = {"a": torch.arange(1000, dtype=torch.float32)}
    d = save_checkpoint(str(tmp_path), 1, state)
    manifest, blob = _read(d)
    spool = tmp_path / "spool"
    spool.write_bytes(blob)
    stream = _StreamingRestore(manifest, state, torch.device("cpu"),
                               spool_path=str(spool))
    try:
        assert bytes(stream.writable(0, len(blob))) == blob
        stream.commit(0, len(blob))
        _same(state, stream.finish())
    finally:
        stream.close()
    assert stream._mmap is None


def test_streaming_restore_sink_protocol_and_shard_leaves(tmp_path):
    """The legacy ``sink`` path, duplicate accounting, the coverage a
    peer mirror advertises, and ``finish(require_all=False)`` keeping the
    leaves no byte reached as ``None``."""
    from repro_torch.checkpoint.manager import _StreamingRestore
    from repro_torch.transfer import Sink

    state = {"a": torch.arange(1000, dtype=torch.float32),
             "b": torch.ones((3, 7), dtype=torch.int32)}
    d = save_checkpoint(str(tmp_path), 1, state)
    manifest, blob = _read(d)
    stream = _StreamingRestore(manifest, state, torch.device("cpu"))
    assert isinstance(stream, Sink)
    a_bytes = 4000
    stream.sink(0, blob[:a_bytes])
    stream.sink(0, blob[:64])                   # a repeat
    stream.sink(10, b"")
    assert stream.duplicate_bytes == 64
    assert stream.covered_intervals() == [(0, a_bytes)]
    part = stream.finish(require_all=False)
    assert torch.equal(part["a"], state["a"]) and part["b"] is None
    with pytest.raises(IOError):
        stream.finish()
    stream.sink(a_bytes, blob[a_bytes:])
    _same(state, stream.finish())


def test_broadcast_restore_draws_from_a_peer(tmp_path, loopback):
    """Restore A serves its landed ranges through a PeerMirror; restore B
    lists that mirror's replica beside an origin of its own paced at
    2 MB/s, and takes part of the blob from A.  Both are exact."""
    state = _torch_state(6)
    d = save_checkpoint(str(tmp_path), 1, state)
    total = _total(d)
    origin_a = loopback.checkpoint(d, 1)
    origin_b = loopback.checkpoint(d, 1, rate=2 * MB)
    mirror = loopback.mirror()
    out_a, _ = loopback.bounded(lambda: restore_checkpoint(
        str(tmp_path), state, step=1, mirror=mirror, device="cpu",
        replicas=_reps([origin_a])))
    assert mirror.bound                 # in-memory: it keeps serving
    out_b, _ = loopback.bounded(lambda: restore_checkpoint(
        str(tmp_path), state, step=1, device="cpu",
        replicas=_reps([origin_b]) + [mirror.replica]))
    _same(state, out_a)
    _same(state, out_b)
    assert mirror.served_bytes > 0
    assert origin_b.served_bytes < total
    assert mirror.served_bytes + origin_b.served_bytes >= total


def test_resume_restore_unbinds_its_mirror(tmp_path, loopback):
    """A spool-backed restore stops serving from the spool map before it
    is unmapped."""
    state = _torch_state(7)
    d = save_checkpoint(str(tmp_path), 1, state)
    srv = loopback.checkpoint(d, 1)
    mirror = loopback.mirror()
    out, _ = loopback.bounded(lambda: restore_checkpoint(
        str(tmp_path), state, step=1, mirror=mirror, device="cpu",
        resume=str(tmp_path / "scratch"), replicas=_reps([srv])))
    assert not mirror.bound
    _same(state, out)


@pytest.mark.parametrize("path", ["waves", "resume", "shard"])
def test_jax_checkpoint_through_the_port_options_equals_jax_restore(
        tmp_path, path, monkeypatch, loopback):
    """A checkpoint saved by ``repro.checkpoint.save_checkpoint`` restores
    through the port's wave, resume and shard paths equal, leaf for leaf
    and bit for bit, to ``repro.checkpoint.restore_checkpoint``.  The
    resume path restores after a first run that died at 40%."""
    state = _jax_state()
    d = jax_save(str(tmp_path), 7, state)
    reps = _reps(_mirrors(loopback, d, 7, (25 * MB, 50 * MB)))
    want, _ = jax_restore(str(tmp_path), state, step=7)
    want = jax.device_get(want)
    if path == "shard":
        merged = {}
        for h in (0, 1):
            half, _ = loopback.bounded(lambda: restore_checkpoint(
                str(tmp_path), state, step=7, replicas=reps,
                shard_plan=(h, 2), device="cpu"))
            held = dict(tree_leaves(half))
            assert held and not set(held) & set(merged)
            merged.update(held)
        assert sorted(merged) == sorted(flatten(want))
        _assert_bits_equal(want, merged)
        return
    kw = ({"wave_bytes": _total(d) // 3 + 1} if path == "waves"
          else {"resume": str(tmp_path / "scratch")})
    if path == "resume":
        _crash_at(monkeypatch, 0.4)
        with pytest.raises(_Crash):
            loopback.bounded(lambda: restore_checkpoint(
                str(tmp_path), state, step=7, replicas=reps, device="cpu",
                **kw))
        monkeypatch.undo()
        assert os.path.exists(tmp_path / "scratch" / "journal.log")
    got, _ = loopback.bounded(lambda: restore_checkpoint(
        str(tmp_path), state, step=7, replicas=reps, device="cpu", **kw))
    _assert_bits_equal(want, got)


def test_checkpoint_manager_gc_keeps_latest(tmp_path):
    from repro_torch.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path), every_steps=10, keep=2,
                            async_save=False)
    state = _torch_state()
    for step in (10, 20, 30, 40):
        assert mgr.maybe_save(step, state)
    assert not mgr.maybe_save(41, state)
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    assert steps == [30, 40]


def test_checkpoint_manager_async_save_snapshots_first(tmp_path):
    """The async save writes the state as it was when ``maybe_save``
    returned: an in-place update right after cannot reach the bytes.
    ``wait()`` joins the commit thread."""
    from repro_torch.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path), every_steps=1, keep=1,
                            async_save=True)
    state = _torch_state()
    before = {k: v.clone() for k, v in state["params"].items()}
    assert mgr.maybe_save(1, state)
    for v in state["params"].values():
        v.add_(1)                       # the next training step, in place
    mgr.wait()
    assert not mgr._thread.is_alive()
    assert latest_step(str(tmp_path)) == 1
    out, step = restore_checkpoint(str(tmp_path), state, device="cpu")
    assert step == 1
    for k, v in before.items():
        assert torch.equal(out["params"][k], v), k
