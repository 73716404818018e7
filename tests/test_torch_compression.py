"""The port's int8 gradient compression against the JAX reference's.

In process: ``quantize_int8`` against the reference's, bit for bit (q and
scale; ``torch.round`` rounds half to even as ``jnp.round`` does, ties
included), the round-trip bound and error feedback on one rank.  On four
spawned gloo ranks (``tests/torch_ranks.py``) against the reference on
four forced host devices (``tests/jax_dist_ref.py``), started together:
each rank's q and scale bit-equal to the reference device's;
``compressed_reduce_scatter`` and ``compressed_mean`` within
``max|want| / 100`` of the exact mean, as ``tests/test_compression.py``
holds the reference; 20 error-feedback steps of
``make_compressed_allreduce`` against the reference's (grads alike on
every rank, and each rank's own through the reference's
``compressed_mean`` composed as its ``make_compressed_allreduce``
composes it), within the same bound; and the only full-size collective of
the reduce-scatter is an int8 ``all_to_all_single``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.compression import quantize_int8 as jax_quantize
from repro_torch.optim.compression import dequantize_int8, quantize_int8
from torch_ranks import (collect, collect_reference, spawn_ranks,
                         spawn_reference)

N, STEPS = 1024, 20


def _ties():
    """max 127 -> scale 1.0 exactly, so x / scale hits every k + 0.5."""
    return np.concatenate([np.arange(-126.5, 127.0, 1.0), [127.0]])


@pytest.mark.parametrize("case", ["normal", "ties", "tiny", "zeros", "bf16"])
def test_quantize_int8_is_bit_equal_to_the_reference(case):
    rng = np.random.default_rng(3)
    x = {"normal": rng.standard_normal(4096) * 3.0, "ties": _ties(),
         "tiny": rng.standard_normal(64) * 1e-30, "zeros": np.zeros(16),
         "bf16": rng.standard_normal(512)}[case].astype(np.float32)
    jx = jnp.asarray(x)
    tx = torch.from_numpy(x)
    if case == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    jq, js = jax_quantize(jx)
    tq, ts = quantize_int8(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js)


def test_quantize_roundtrip_bound():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    q, s = quantize_int8(x)
    err = (dequantize_int8(q, s) - x).abs().max().item()
    assert err <= x.abs().max().item() / 254 + 1e-7


def test_error_feedback_tracks_the_exact_sum_on_one_rank():
    rng = np.random.default_rng(1)
    exact = np.zeros(512, np.float32)
    sent_sum = np.zeros(512, np.float32)
    err = torch.zeros(512)
    for _ in range(50):
        g = torch.from_numpy(rng.standard_normal(512).astype(np.float32))
        exact += g.numpy()
        q, s = quantize_int8(g + err)
        sent = dequantize_int8(q, s)
        err = (g + err) - sent
        sent_sum += sent.numpy()
    assert np.abs(exact - sent_sum).max() < max(
        np.abs(exact).max() / 254 * 5, 0.2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compression")
    rng = np.random.default_rng(0)
    data = {"g": rng.standard_normal((4, N)).astype(np.float32),
            "same": rng.standard_normal((STEPS, N)).astype(np.float32),
            "own": rng.standard_normal((STEPS, 4, N)).astype(np.float32)}
    inputs = os.path.join(str(tmp), "inputs.npz")
    np.savez(inputs, **data)
    ref = spawn_reference("compression", 4, tmp, inputs, steps=STEPS)
    ranks = collect(spawn_ranks("compression", 4, tmp, inputs=inputs,
                                steps=STEPS))
    return data, collect_reference(ref), ranks


def _bound(want):
    """``tests/test_compression.py``'s bound on a compressed mean."""
    return max(np.abs(want).max() / 100, 0.05)


@pytest.mark.parametrize("rank", range(4))
def test_each_ranks_q_and_scale_are_bit_equal(runs, rank):
    _, ref, ranks = runs
    np.testing.assert_array_equal(ranks[rank]["q"].numpy(), ref[f"q{rank}"])
    assert ranks[rank]["scale"].item() == float(ref[f"scale{rank}"])


def test_compressed_reduce_scatter_matches(runs):
    data, ref, ranks = runs
    want = data["g"].mean(axis=0)
    got = np.concatenate([r["rs"].numpy() for r in ranks])
    assert got.shape == want.shape and ref["rs"].shape == want.shape
    assert np.abs(got - want).max() < _bound(want)
    assert np.abs(got - ref["rs"]).max() < _bound(want)


def test_compressed_mean_matches(runs):
    data, ref, ranks = runs
    want = data["g"].mean(axis=0)
    for r in ranks:
        assert r["mean"].dtype == torch.float32
        assert np.abs(r["mean"].numpy() - want).max() < _bound(want)
        assert np.abs(r["mean"].numpy() - ref["mean"]).max() < _bound(want)


def _ef_tracks(sent, exact):
    """Error feedback: what was sent tracks the exact sum to within a few
    quantization steps, however many steps ran."""
    return np.abs(sent - exact).max() < max(np.abs(exact).max() / 254 * 5,
                                            0.2)


def test_error_feedback_matches_the_reference_over_steps_same_grads(runs):
    """Grads alike on every rank: the bf16 sum of four equal terms is
    exact on both sides, so all 20 steps hold."""
    data, ref, ranks = runs
    sent = np.zeros(N)
    for t in range(STEPS):
        want = ref[f"same/mean{t}"]
        for i, r in enumerate(ranks):
            assert np.abs(r[f"same/mean{t}"].numpy() - want).max() < \
                _bound(want), (t, i)
            # the carried error re-quantizes the mean: a mean within the
            # bound can land one quantization step (max|mean| / 127) away
            assert np.abs(r[f"same/err{t}"].numpy() - ref[f"same/err{t}"]
                          ).max() < _bound(want) + np.abs(want).max() / 127
        sent += ranks[0][f"same/mean{t}"].numpy()
    assert _ef_tracks(sent, data["same"].sum(axis=0))


def test_error_feedback_matches_the_reference_over_steps_own_grads(runs):
    """Each rank's own grads: the bf16 all-reduce rounds in another order
    than XLA's (gloo after every addition), so the two trajectories part
    after the first step by re-quantized ulps.  Held: the first step
    against the reference; every step of both against the exact mean of
    their own inputs, within the scheme's worst case (gloo rounds the bf16
    sum after every addition, so the reference test's max|want| / 100,
    made for XLA's once-rounded sum, is not it); and the error-feedback
    property on both."""
    data, ref, ranks = runs
    want = ref["own/mean0"]
    for i, r in enumerate(ranks):
        assert np.abs(r["own/mean0"].numpy() - want).max() < _bound(want)
        assert np.abs(r["own/err0"].numpy() - ref["own/err0"][i]).max() < \
            _bound(want) + np.abs(want).max() / 127
    exact = data["own"].mean(axis=1).sum(axis=0)
    for side, mean_of, err_of in (
            ("port", lambda t: ranks[0][f"own/mean{t}"].numpy(),
             lambda t: np.stack([r[f"own/err{t}"].numpy() for r in ranks])),
            ("reference", lambda t: ref[f"own/mean{t}"],
             lambda t: ref[f"own/err{t}"])):
        sent, err = np.zeros(N), np.zeros((4, N))
        for t in range(STEPS):
            inputs = data["own"][t] + err
            # the scheme's worst case over 4 ranks: half a quantization
            # step per rank, and a bf16 rounding of each product and of
            # each partial sum of the all-reduce (4 x 2^-9 relative)
            bound = np.abs(inputs).max() * (1 / 254 + 4 / 512)
            assert np.abs(mean_of(t) - inputs.mean(axis=0)).max() <= \
                bound, (side, t)
            sent += mean_of(t)
            err = err_of(t)
        assert _ef_tracks(sent, exact), side


def test_the_full_size_collective_is_int8(runs):
    _, _, ranks = runs
    for r in ranks:
        assert r["wire"] == ["torch.int8"]
