"""The MoE family (olmoe-1b-7b, kimi-k2-1t-a32b) against the JAX package,
on the CPU.

Configs field for field, parameter and cache trees key for key and shape
for shape (also at full size, on specs alone), the reference's total and
active parameter counts.  ``moe_block`` alone against the reference's
one-hot path (no mesh): the same top-k experts, the same kept and dropped
(token, slot) pairs (the reference's running count, ``moe.py:93-97``,
rebuilt here from its own indices), the same output and load-balance
loss, at the config's capacity factor and at 0.5, where pairs must drop.
At ``reduced_config``: ``forward`` logits and ``aux``, prefill on both
paths, ``decode_step`` at B 2 (capacity 1: pairs that share an expert
drop) and B 4 (capacity 2) with every KV cache, greedy ``generate``.  f32
atol = rtol = 1e-4 and identical greedy tokens; bf16 atol 0.08 / rtol
0.05.

The whole-model comparisons at bf16 pin the expert choice in both
packages to the same fixed table (``pinned_routing``): the two packages
round their bf16 activations in different orders, a one-ulp difference
in the router's input reorders near-tied experts, and one reordered
expert moves a token's output by O(1) (37% of a decode step's logits off
by up to 1.05 in the unpinned case).  The gate values, the load-balance
loss and everything else stay live.  The router's own choice is held at
f32 end to end, and at bf16 by ``moe_block`` on identical inputs.
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.serve.step import make_prefill_step  # noqa: E402
from torch_parity import (TOL, cache_leaf, check_config, check_specs,  # noqa: E402
                          check_weights, close, pair, setup)

ARCHS = ["olmoe-1b-7b", "kimi-k2-1t-a32b"]
#: the JAX package's (total, active) parameter counts of the full configs
N_PARAMS = {"olmoe-1b-7b": (6_919_100_416, 1_281_955_840)}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference_field_for_field(arch):
    check_config(arch)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_program_and_specs_match_reference(arch, reduced):
    check_specs(arch, reduced)


def test_full_size_counts_and_capacities():
    """olmoe's parameter counts; the capacity of a 4096-token prefill and
    of a 4-token decode step (olmoe and kimi)."""
    cfg = get_config("olmoe-1b-7b")
    assert (TT.num_params(cfg), TT.active_params(cfg)) == N_PARAMS[cfg.name]
    assert TT.program_for(cfg) == (("moe",), 16, ())
    assert TM.capacity(cfg, 4096) == 640 and TM.capacity(cfg, 4) == 1
    kimi = get_config("kimi-k2-1t-a32b")
    assert TM.capacity(kimi, 2048) == 54 and TM.capacity(kimi, 4) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_carried_across_by_to_torch(arch):
    check_weights(arch)


@pytest.fixture
def pinned_routing(monkeypatch):
    """Both packages' routers choose experts ``(3 t + j) mod E`` for token
    t's slot j, weighted by their own renormalised probabilities there."""

    def table(T, cfg, xp):
        return (xp.arange(T)[:, None] * 3 + xp.arange(cfg.top_k)[None]) \
            % cfg.n_experts

    jax_gates, torch_gates = JM._gates, TM._gates

    def jax_pinned(cfg, xt, router):
        _, _, lb = jax_gates(cfg, xt, router)
        probs = jax.nn.softmax(xt.astype(jnp.float32)
                               @ router.astype(jnp.float32), axis=-1)
        idx = table(xt.shape[0], cfg, jnp)
        vals = jnp.take_along_axis(probs, idx, axis=1)
        return vals / jnp.maximum(vals.sum(-1, keepdims=True), 1e-9), idx, lb

    def torch_pinned(cfg, xt, router):
        _, _, lb = torch_gates(cfg, xt, router)
        probs = torch.softmax(xt.float() @ router.float(), dim=-1)
        idx = table(xt.shape[0], cfg, torch)
        vals = probs.gather(1, idx)
        return vals / vals.sum(-1, keepdim=True).clamp_min(1e-9), idx, lb

    monkeypatch.setattr(JM, "_gates", jax_pinned)
    monkeypatch.setattr(TM, "_gates", torch_pinned)


def _pin_at_bf16(request, dtype):
    if dtype == "bfloat16":
        request.getfixturevalue("pinned_routing")


def _reference_keep(gate_idx: np.ndarray, E: int, cap: int) -> np.ndarray:
    """The reference's kept pairs (``_moe_onehot``, ``moe.py:93-97``), in
    its own arithmetic on its own indices."""
    flat_e = jnp.asarray(gate_idx).reshape(-1)
    onehot_e = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot_e, axis=0) - 1
    pos = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
    return np.asarray(pos < cap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_onehot_path(arch, capacity_factor, dtype):
    jcfg, tcfg, jp, tp = setup(arch, dtype)
    jcfg = jcfg.replace(capacity_factor=capacity_factor)
    tcfg = tcfg.replace(capacity_factor=capacity_factor)
    pj = jax.tree.map(lambda a: a[0], jp["blocks"]["b0_moe"]["moe"])
    pt = {k: t[0] for k, t in tp["blocks"]["b0_moe"]["moe"].items()}
    B, S = 2, 24
    xj, xt = pair(np.random.default_rng(6).standard_normal(
        (B, S, tcfg.d_model)), dtype)
    vj, ij, lbj = JM._gates(jcfg, xj.reshape(B * S, -1), pj["router"])
    vt, it, lbt = TM._gates(tcfg, xt.reshape(B * S, -1), pt["router"])
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    close(vt, vj, TOL["float32"])
    cap = TM.capacity(tcfg, B * S)
    assert cap == max(int(math.ceil(B * S * tcfg.top_k / tcfg.n_experts
                                    * capacity_factor)), 1)
    _, keep = TM._slots(it, tcfg.n_experts, cap)
    want = _reference_keep(np.asarray(ij), tcfg.n_experts, cap)
    np.testing.assert_array_equal(keep.numpy(), want)
    if capacity_factor < 1:
        assert not want.all()                   # some pairs are dropped
    yj, lj = JM.moe_block(pj, jcfg, xj)
    yt, lt = TM.moe_block(pt, tcfg, xt)
    assert yt.dtype == tcfg.torch_dtype and lt.dtype == torch.float32
    close(yt, yj, TOL[dtype])
    close(lt, lj, TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_jax(arch, dtype, request):
    """Logits and the summed load-balance loss, on both paths."""
    _pin_at_bf16(request, dtype)
    jcfg, tcfg, jp, tp = setup(arch, dtype)
    toks = np.random.default_rng(11).integers(0, tcfg.vocab_size, (2, 32))
    lj, auxj = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)})
    tol = TOL[dtype]
    for plain in (True, False):
        lt, aux = TT.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                             plain=plain)
        assert lt.shape == (2, 32, tcfg.vocab_size)
        assert lt.dtype == tcfg.torch_dtype and aux.dtype == torch.float32
        assert float(aux) > 0
        close(lt, lj, tol)
        close(aux, auxj, tol)
        pt = make_prefill_step(tcfg, plain=plain)(
            tp, {"tokens": torch.from_numpy(toks)})
        close(pt, lj[:, -1], tol)


@pytest.mark.parametrize("batch", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch, dtype, batch, request):
    """12 steps at B 2 (capacity 1) or B 4 (capacity 2): pairs of the
    batch that share an expert past its capacity are dropped, as in the
    reference."""
    _pin_at_bf16(request, dtype)
    jcfg, tcfg, jp, tp = setup(arch, dtype)
    S = 12
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (batch, S))
    assert TM.capacity(tcfg, batch) == batch // 2
    jcache = JT.init_cache(jcfg, batch, S)
    tcache = TT.init_cache(tcfg, batch, S, "cpu")
    step = jax.jit(lambda p, c, t, s: JT.decode_step(p, jcfg, c, t, s))
    tol = TOL[dtype]
    for t in range(S):
        lj, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1],
                                                   jnp.int32), jnp.int32(t))
        lt, tcache = TT.decode_step(
            tp, tcfg, tcache, torch.from_numpy(toks[:, t:t + 1]),
            torch.tensor(t, dtype=torch.int32))
        close(lt, lj, tol)
    for k, leaf in tree_leaves(tcache):          # every layer's K and V
        close(leaf, cache_leaf(jcache, k), tol)


def test_decode_drops_pairs_at_capacity_one():
    """At B 2 a step's 4 (token, slot) pairs share 8 experts with one row
    each: over 12 steps and 2 layers some pairs drop."""
    _, tcfg, _, tp = setup("olmoe-1b-7b", "float32")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (2, 12)))
    dropped = 0
    for t in range(12):
        x = TT._positions_embed(tcfg, tp, toks[:, t:t + 1])
        p = {k: v[0] for k, v in tp["blocks"]["b0_moe"]["moe"].items()}
        _, idx, _ = TM._gates(tcfg, x.reshape(2, -1), p["router"])
        dropped += int((~TM._slots(idx, tcfg.n_experts, 1)[1]).sum())
    assert dropped > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_tokens_identical_at_f32(arch):
    jcfg, tcfg, jp, tp = setup(arch, "float32")
    prompt = np.random.default_rng(5).integers(0, tcfg.vocab_size, (4, 10))
    tj = jax_generate(jcfg, jp, jnp.asarray(prompt, jnp.int32), 10)
    tt = generate(tcfg, TT.Decoder(tcfg, tp, device="cpu"),
                  torch.from_numpy(prompt), 10, device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
