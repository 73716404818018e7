"""Checkpoints cross between the JAX package and the port, bit for bit.

JAX saves and the port restores through three loopback MDTP mirrors, one
of which dies mid-restore (the shape of
``tests/test_checkpoint.py::test_multi_source_restore_survives_mirror_death``);
the port saves and JAX restores.  bf16 leaves included.  The last test
runs the slice end to end on the CPU: a JAX-saved qwen3 (reduced)
checkpoint restored over MDTP into the port's decoder decodes like JAX.
"""

import os
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro_torch.checkpoint import (latest_step, restore_checkpoint,  # noqa: E402
                                    save_checkpoint)
from repro_torch.transfer import RangeServer, Replica, Throttle  # noqa: E402
from repro_torch.weights import flatten, tensor_to_numpy  # noqa: E402

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


def _mirrors(d, step, rates):
    servers = []
    base = f"/ckpt/step_{step:010d}"
    for bw in rates:
        s = RangeServer(throttle=Throttle(bytes_per_s=bw)).start()
        s.add_file(base + "/manifest.json", os.path.join(d, "manifest.json"))
        s.add_file(base + "/data.bin", os.path.join(d, "data.bin"))
        servers.append(s)
    return servers


def _kill(server):
    server.stop()
    server.kill_connections()


def test_jax_save_port_restore_three_mirrors_one_dies(tmp_path):
    state = _jax_state()
    d = jax_save(str(tmp_path), 7, state)
    victim, *healthy = servers = _mirrors(d, 7, (2 * MB, 25 * MB, 50 * MB))
    try:
        timer = threading.Timer(0.05, _kill, args=(victim,))
        timer.start()
        replicas = [Replica("127.0.0.1", s.port, "/ckpt") for s in servers]
        restored, step = restore_checkpoint(str(tmp_path), state, step=7,
                                            replicas=replicas, device="cpu")
        timer.join()
        assert step == 7
        _assert_bits_equal(jax.device_get(state), restored)
        total = os.path.getsize(os.path.join(d, "data.bin"))
        assert victim.served_bytes < total       # it died owing bytes
    finally:
        for s in healthy:
            s.stop()


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
                         to_torch(jax.device_get(state)))
    for name in ("data.bin", "manifest.json"):
        with open(os.path.join(dj, name), "rb") as a, \
                open(os.path.join(dt, name), "rb") as b:
            assert a.read() == b.read(), name


def test_jax_checkpoint_restores_into_port_decoder_over_mdtp(tmp_path):
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
    servers = _mirrors(d, 11, (0, 0, 0))
    try:
        replicas = [Replica("127.0.0.1", s.port, "/ckpt") for s in servers]
        tree, _ = restore_checkpoint(str(tmp_path), TT.model_specs(tcfg),
                                     replicas=replicas, device="cpu")
    finally:
        for s in servers:
            s.stop()
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


def test_client_refuses_a_tuner():
    """The port's client has no tuner hook yet: a tuner is refused, never
    silently ignored."""
    import asyncio

    from repro_torch.transfer import MDTPClient

    reps = [Replica("127.0.0.1", 1, "/x")]
    with pytest.raises(TypeError, match="tuner"):
        MDTPClient(reps, tuner=object())
    with pytest.raises(TypeError, match="tuner"):
        asyncio.run(MDTPClient(reps).fetch(10, tuner=object()))
    assert not hasattr(MDTPClient, "retune")


def test_streaming_restore_handles_split_overlapping_deliveries(tmp_path):
    """Leaves land on the device as soon as their bytes are complete,
    whatever order and overlap the ranges arrive in."""
    import json

    from repro_torch.checkpoint.manager import _StreamingRestore

    state = {"a": torch.arange(1000, dtype=torch.float32),
             "b": torch.ones((3, 7), dtype=torch.int32),
             "c": torch.tensor(2.5).to(torch.bfloat16)}
    d = save_checkpoint(str(tmp_path), 1, state)
    manifest = json.load(open(os.path.join(d, "manifest.json")))
    blob = open(os.path.join(d, "data.bin"), "rb").read()
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
