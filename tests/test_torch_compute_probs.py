"""The ``attn_probs_dtype="compute"`` attention path against the JAX
package, on the CPU.

The reference's lever (``repro.models.layers._sdpa(...,
probs_dtype="compute")``) keeps the scores and probabilities in the
compute dtype, with f32 row sums and the normalisation after PV.  The
port's plain path takes the same branch of its ``_sdpa``; its kernel path
calls ``flash_attention(probs="compute")``, which on CPU tensors takes
``flash_attention_plain(probs="compute")``, so both are held here.  Inputs
are made with numpy from a seed; bf16 values carry their bits across.

Tolerances, each with its reason:
- f32: 1e-5 (the two packages sum in other orders); gradients 1e-5 of
  each leaf's largest entry, with rtol 1e-4 (the backward chains more
  sums).
- bf16: 2e-2 element-wise and 1e-2 row-relative (one bf16 ulp of the
  inputs' scale; the packages round their bf16 products at other points).

The whole model's loss and gradients under the option are in
``tests/test_torch_compute_probs_loss.py``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.common import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.kernels import flash_attention_plain  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.weights import tensor_from_numpy, to_torch  # noqa: E402
from torch_parity import fresh  # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
TOL = {"float32": F32, "bfloat16": BF16}
ROW_REL = 1e-2


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor (identical bits)."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, tensor_from_numpy(np.asarray(j))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _row_rel(got, want) -> float:
    """max over rows (the last axis) of |got - want| / |want|."""
    g, w = _np(got), _np(want)
    norm = np.linalg.norm(w, axis=-1)
    keep = norm > 0
    return float((np.linalg.norm(g - w, axis=-1)[keep] / norm[keep]).max())


def _close(got, want, dtype: str) -> None:
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    if dtype == "bfloat16":
        assert _row_rel(got, want) <= ROW_REL


# ----------------------------------------------------------------- _sdpa

#: (B, Sq, Sk, KV, G, hd, mask): mask "causal", "window" (causal, 5
#: keys) or "none" (Sq != Sk, as a cross-attention)
SDPA_CASES = [(2, 24, 24, 2, 2, 16, "causal"),
              (1, 32, 32, 1, 4, 16, "window"),
              (2, 7, 19, 2, 1, 32, "none")]


def _bias_pair(Sq, Sk, mask):
    qp = np.arange(Sq, dtype=np.int32)
    kp = np.arange(Sk, dtype=np.int32)
    causal, window = mask != "none", 5 if mask == "window" else None
    jb = JL._mask_bias(jnp.asarray(qp), jnp.asarray(kp), causal, window)
    tb = TL._mask_bias(torch.from_numpy(qp), torch.from_numpy(kp), causal,
                       window)
    return jb, tb, causal, window


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SDPA_CASES, ids=str)
def test_sdpa_compute_matches_reference(case, dtype):
    B, Sq, Sk, KV, G, hd, mask = case
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng.standard_normal((B, Sq, KV, G, hd)), dtype)
    jk, tk = _pair(rng.standard_normal((B, Sk, KV, hd)), dtype)
    jv, tv = _pair(rng.standard_normal((B, Sk, KV, hd)), dtype)
    jb, tb, _, _ = _bias_pair(Sq, Sk, mask)
    scale = hd ** -0.5
    want = JL._sdpa(jq, jk, jv, jb, scale, "compute")
    got = TL._sdpa(tq, tk, tv, tb, scale, "compute")
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, dtype)
    # the compute branch is another function from the float32 one at bf16
    if dtype == "bfloat16":
        f32 = TL._sdpa(tq, tk, tv, tb, scale)
        assert not torch.equal(got, f32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SDPA_CASES, ids=str)
def test_flash_plain_compute_matches_the_model_plain_path(case, dtype):
    """``flash_attention_plain(probs="compute")`` is the model's plain
    compute branch over the kernel's layout: the same operations in the
    same order, so the two agree to the last bit where a row sees a
    key."""
    B, Sq, Sk, KV, G, hd, mask = case
    rng = np.random.default_rng(1)
    _, q = _pair(rng.standard_normal((B, Sq, KV * G, hd)), dtype)
    _, k = _pair(rng.standard_normal((B, Sk, KV, hd)), dtype)
    _, v = _pair(rng.standard_normal((B, Sk, KV, hd)), dtype)
    _, tb, causal, window = _bias_pair(Sq, Sk, mask)
    got = flash_attention_plain(q, k, v, causal=causal, window=window,
                                probs="compute")
    want = TL._sdpa(q.reshape(B, Sq, KV, G, hd), k, v, tb, hd ** -0.5,
                    "compute").reshape(B, Sq, KV * G, hd)
    assert got.dtype == q.dtype
    _close(got, want, dtype)


def test_flash_plain_compute_masks_rows_with_no_key_to_zero():
    """Queries 3..5 against 3 keys with a window of 1 see no key: they give
    0 and pass no gradient, not NaN, as in the float32 mode.  (Queries
    0..2 see one key each: their gradient is 0 in exact arithmetic, and a
    few bf16 ulps here, where the normalisation after PV rounds.)"""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 6, 2, 8))).to(
        torch.bfloat16).requires_grad_(True)
    k = torch.from_numpy(rng.standard_normal((1, 3, 2, 8))).to(
        torch.bfloat16).requires_grad_(True)
    v = torch.from_numpy(rng.standard_normal((1, 3, 2, 8))).to(torch.bfloat16)
    out = flash_attention_plain(q, k, v, causal=True, window=1,
                                probs="compute")
    assert torch.equal(out[:, 3:], torch.zeros_like(out[:, 3:]))
    assert torch.equal(out[:, :3], v)
    gq, gk = torch.autograd.grad(out.float().square().sum(), (q, k))
    assert torch.equal(gq[:, 3:], torch.zeros_like(gq[:, 3:]))
    assert bool(torch.isfinite(gq.float()).all())
    assert bool(torch.isfinite(gk.float()).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_compute_gradients_equal_the_plain_path(monkeypatch,
                                                               dtype):
    """Under autograd the kernel's backward is the plain compute version's
    VJP: with the launch replaced by the plain forward,
    ``FlashAttentionFn`` gives its gradients."""
    calls = []

    def launch(q, k, v, c, w, s, probs="float32"):
        calls.append(probs)
        return fops.flash_attention_plain(q, k, v, causal=c, window=w,
                                          scale=s, probs=probs)

    monkeypatch.setattr(fops, "_launch", launch)
    rng = np.random.default_rng(3)

    def randn(shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dtype)

    q, k, v = randn((2, 16, 4, 8)), randn((2, 16, 2, 8)), randn((2, 16, 2, 8))
    cot = randn((2, 16, 4, 8))

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*ins)
        return out, torch.autograd.grad(out, ins, cot)

    out, got = grads(lambda *t: fops.FlashAttentionFn.apply(
        *t, True, 6, None, "compute"))
    ref, want = grads(lambda *t: fops.flash_attention_plain(
        *t, window=6, probs="compute"))
    assert calls == ["compute"]
    assert torch.equal(out, ref)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        tol = F32 if dtype == torch.float32 else BF16
        np.testing.assert_allclose(_np(g), _np(w), **tol)


@pytest.mark.parametrize("q_block", [1, 5, 16])
def test_flash_vjp_compute_in_query_blocks_equals_one_block(q_block):
    """The compute mode's recompute in query blocks changes nothing but the
    order of the f32 sums of dk and dv (f32 1e-5)."""
    rng = np.random.default_rng(6)
    q, k, v, cot = (torch.from_numpy(rng.standard_normal(s)).float()
                    for s in ((2, 16, 4, 8), (2, 16, 2, 8), (2, 16, 2, 8),
                              (2, 16, 4, 8)))
    got = fops.flash_attention_vjp(q, k, v, cot, window=6, q_block=q_block,
                                   probs="compute")
    want = fops.flash_attention_vjp(q, k, v, cot, window=6, q_block=16,
                                    probs="compute")
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32)


def test_flash_refuses_an_unknown_probs_mode():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="probs"):
        flash_attention_plain(q, q, q, probs="bfloat16")


# ------------------------------------------------------------- attention

#: (name, Sq, Sk, causal, window, use_rope, q_block): the whole block;
#: the query-blocked loop with sliding-window slices (Sq > q_block and
#: window + q_block < Sk); the blocked loop without a window;
#: cross-attention (Sq != Sk); one query against a memory (a decode
#: step's cross-attention)
ATTN_CASES = [("causal", 32, 32, True, None, True, 1024),
              ("windowed", 64, 64, True, 8, True, 16),
              ("blocked", 48, 48, True, None, True, 16),
              ("cross", 12, 20, False, None, False, 1024),
              ("one_query_cross", 1, 20, False, None, False, 1024)]


def _attn_setup(dtype: str, cross: bool):
    jcfg = jax_reduced("qwen3-1.7b").replace(dtype=dtype,
                                            attn_probs_dtype="compute")
    tcfg = reduced_config("qwen3-1.7b").replace(dtype=dtype,
                                               attn_probs_dtype="compute")
    jp = jax_init_params(jax.random.PRNGKey(1),
                         JL.attention_specs(jcfg, cross=cross), jcfg.jdtype)
    return jcfg, tcfg, jp, to_torch(jax.device_get(jp), "cpu")


def _attn_inputs(jcfg, case, dtype, seed=4):
    _, Sq, Sk, _, _, _, _ = case
    rng = np.random.default_rng(seed)
    jx, tx = _pair(rng.standard_normal((2, Sq, jcfg.d_model)), dtype)
    if case[0].endswith("cross"):
        jm, tm = _pair(rng.standard_normal((2, Sk, jcfg.d_model)), dtype)
    else:
        jm = tm = None
    return jx, tx, jm, tm


@pytest.mark.parametrize("plain", [True, False], ids=["plain", "kernel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: c[0])
def test_attention_compute_matches_reference(case, dtype, plain):
    name, Sq, Sk, causal, window, use_rope, q_block = case
    jcfg, tcfg, jp, tp = _attn_setup(dtype, name.endswith("cross"))
    jx, tx, jm, tm = _attn_inputs(jcfg, case, dtype)
    want = JL.attention(jp, jcfg, jx, kv_x=jm, causal=causal, window=window,
                        use_rope=use_rope, q_block=q_block)
    got = TL.attention(tp, tcfg, tx, kv_x=tm, causal=causal, window=window,
                       use_rope=use_rope, q_block=q_block, plain=plain)
    assert got.shape == (2, Sq, tcfg.d_model) and got.dtype == tx.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", [0, 1], ids=["whole", "block_remat"])
def test_attention_compute_gradients_match_reference(remat, dtype):
    """The query-blocked sliding-window path under grad, with and without
    ``attn_block_remat`` (each block's scores recomputed in the backward):
    the gradients of every parameter and of x against ``jax.grad``."""
    case = ATTN_CASES[1]
    _, Sq, Sk, causal, window, use_rope, q_block = case
    jcfg, tcfg, jp, tp = _attn_setup(dtype, False)
    jcfg = jcfg.replace(attn_block_remat=remat)
    tcfg = tcfg.replace(attn_block_remat=remat)
    jx, tx, _, _ = _attn_inputs(jcfg, case, dtype)
    rng = np.random.default_rng(5)
    jc, tc = _pair(rng.standard_normal((2, Sq, jcfg.d_model)), dtype)

    def jloss(p, x):
        y = JL.attention(p, jcfg, x, causal=causal, window=window,
                         q_block=q_block)
        return jnp.sum(y.astype(jnp.float32) * jc.astype(jnp.float32))

    jg = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    params = fresh(tp)
    x = tx.clone().requires_grad_(True)
    y = TL.attention(params, tcfg, x, causal=causal, window=window,
                     q_block=q_block, plain=True)
    loss = (y.float() * tc.float()).sum()
    keys, leaves = zip(*tree_leaves(params))
    grads = torch.autograd.grad(loss, (*leaves, x))
    want = {**{k: np.asarray(v, np.float32) for k, v in jg[0].items()},
            "x": np.asarray(jg[1], np.float32)}
    for k, g in zip((*keys, "x"), grads):
        peak = float(np.abs(want[k]).max())
        tol = (dict(atol=1e-5 * peak, rtol=1e-4) if dtype == "float32"
               else dict(atol=2e-2 * peak, rtol=2e-2))
        np.testing.assert_allclose(_np(g), want[k], err_msg=k, **tol)
