"""The examples' entry points of the port (``repro_torch.examples``)
against the reference's examples, on the CPU.

Each ``main`` runs as ``python -m repro_torch.examples.<name>`` would,
at its defaults (train_100m at its miniature config), with ``--device
cpu`` where it takes a device and the test's
loopback mirrors (``tests/torch_loopback.py``: every mirror halted at
teardown, every socket case bounded, no thread left behind).  The socket
cases assert structure, never a ratio of speeds.

- quickstart: the simulated total times equal the reference's
  ``simulate`` (the same numpy code); the real transfer returns every
  byte, split over three mirrors.
- autotune_chunks: the grid and batch winners (C, L) equal the
  reference's, their predicted times within rtol 1e-5 (f32 sums in other
  orders); the gradient polish never worse than its start.
- multisource_restore: the 64 MiB state bit-exact, with the slowest
  mirror stopped.
- train_100m: ``config_100m()`` field by field and ``num_params`` equal
  the reference's; two steps of the miniature config, then a resume.
"""

import dataclasses
import importlib.util
import math
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core import Aria2Policy, BitTorrentPolicy  # noqa: E402
from repro.core import MDTPPolicy, StaticChunkingPolicy, simulate  # noqa: E402
from repro.core import autotune as JA  # noqa: E402
from repro.core.scenarios import GB, bittorrent_seeders  # noqa: E402
from repro.core.scenarios import paper_baseline  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.examples import autotune_chunks  # noqa: E402
from repro_torch.examples import multisource_restore  # noqa: E402
from repro_torch.examples import quickstart, train_100m  # noqa: E402
from repro_torch.models.transformer import num_params  # noqa: E402
from torch_loopback import loopback, no_thread_left  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MB = 1024 * 1024


def _reference_example(name: str):
    """The reference's ``examples/<name>.py`` as a module (its ``main`` is
    not run)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", os.path.join(ROOT, "examples",
                                                  f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------- quickstart

def _mirror(loopback):
    """The examples' mirror factory over the test's loopback servers."""
    return lambda blobs, rate: loopback.server(blobs, rate=rate)


def test_quickstart_matches_the_reference(loopback):
    out = loopback.bounded(lambda: quickstart.main(mirror=_mirror(loopback)))
    want = {}
    for policy in (MDTPPolicy(), StaticChunkingPolicy(), Aria2Policy()):
        r = simulate(policy, paper_baseline(), 4 * GB, seed=0)
        want[r.policy] = r.total_time
    r = simulate(BitTorrentPolicy(), bittorrent_seeders(), 4 * GB, seed=0)
    want[r.policy] = r.total_time
    assert out["simulated"] == want
    t = out["transfer"]
    assert t["bytes"] == 16 * MB
    assert sum(t["bytes_per_replica"].values()) == 16 * MB
    assert len(t["requests_per_replica"]) == 3
    assert all(n >= 0 for n in t["bytes_per_replica"].values())


# -------------------------------------------------------- autotune_chunks

def test_autotune_chunks_picks_the_reference_winners():
    out = autotune_chunks.main(["--device", "cpu"])
    bw = [s.bandwidth for s in paper_baseline()]
    for size_gb, (c, l, t) in out["grid"].items():
        ref = JA.autotune_chunk_params(bw, rtt=0.03, file_size=size_gb * GB)
        assert (c, l) == (ref.params.initial_chunk, ref.params.large_chunk)
        np.testing.assert_allclose(t, ref.predicted_time, rtol=1e-5)
    drift = np.random.default_rng(0).uniform(0.3, 1.7, size=(8, len(bw)))
    refs = JA.autotune_batch(np.asarray(bw)[None, :] * drift, rtt=0.03,
                             file_size=2 * GB)
    assert [(c, l) for c, l, _ in out["batch"]] == [
        (r.params.initial_chunk, r.params.large_chunk) for r in refs]
    np.testing.assert_allclose([t for *_, t in out["batch"]],
                               [r.predicted_time for r in refs], rtol=1e-5)
    c, l, t = out["polished"]
    assert c > 0 and l > 0 and math.isfinite(t)
    assert t <= out["polish_init_s"] * (1 + 1e-6)


# ---------------------------------------------------- multisource_restore

def test_multisource_restore_is_bit_exact(loopback):
    out = loopback.bounded(lambda: multisource_restore.main(
        ["--device", "cpu"], mirror=_mirror(loopback)), timeout=60)
    assert out["bit_exact"] and out["step"] == multisource_restore.STEP
    assert out["leaves"] == 9 and out["device"] == "cpu"
    assert out["bytes"] >= 8 * 1024 * 2048 * 4


# ------------------------------------------------------------- train_100m

def test_config_100m_matches_the_reference():
    ref = _reference_example("train_100m")
    assert dataclasses.asdict(train_100m.config_100m()) == \
        dataclasses.asdict(ref.config_100m())
    assert num_params(train_100m.config_100m()) == \
        JT.num_params(ref.config_100m())
    small = train_100m.reduced_100m()
    assert (small.family, small.qk_norm, small.mlp_act, small.remat) == \
        ("dense", True, "swiglu", "none")


def test_train_100m_trains_and_resumes(tmp_path, loopback):
    ck = str(tmp_path / "ck")
    args = ["--device", "cpu", "--reduced", "--batch", "2", "--seq", "16",
            "--ckpt-dir", ck]
    out = loopback.bounded(lambda: train_100m.main(
        ["--steps", "2", *args], mirror=_mirror(loopback)), timeout=60)
    assert len(out["losses"]) == 2 and all(map(math.isfinite, out["losses"]))
    assert latest_step(ck) == 2
    again = loopback.bounded(lambda: train_100m.main(
        ["--steps", "3", "--resume", *args], mirror=_mirror(loopback)),
        timeout=60)
    assert len(again["losses"]) == 1 and latest_step(ck) == 3


@pytest.mark.parametrize("name", ["autotune_chunks", "multisource_restore",
                                  "train_100m"])
def test_examples_default_to_the_card(name):
    """``--device`` defaults to ``cuda``: without a card the entry point
    raises; it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    mod = {"autotune_chunks": autotune_chunks,
           "multisource_restore": multisource_restore,
           "train_100m": train_100m}[name]
    argv = ["--reduced", "--steps", "1"] if name == "train_100m" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
