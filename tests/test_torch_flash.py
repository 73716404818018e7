"""The port's flash-attention plain version, full-sequence attention and
qwen3 forward / prefill against the JAX package, on the CPU.

Same inputs (numpy, seeded; bf16 bits shared exactly) go through the JAX
Pallas kernel in interpret mode (``interpret=True`` passed explicitly: its
default is the compiled TPU path), its oracle ``attention_ref`` and the
port.  On CPU tensors the port's ``flash_attention`` wrapper takes its
plain version, so both port functions are checked.  Kernel tolerances are
the JAX kernel tests' own (``tests/test_kernels.py``): f32 2e-5, bf16
2e-2.  Model tolerances: f32 1e-4; bf16 atol 0.08 / rtol 0.05, the JAX
package's own decode-vs-forward tolerance, because the port's kernel path
keeps the softmax probabilities in f32 through the PV product (as the TPU
kernel does) where the reference's ``_sdpa`` rounds them to bf16 first.
The CUDA kernel is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import functools
import math
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.kernels import attention_ref  # noqa: E402
from repro.kernels import flash_attention as jax_flash  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import init_params as jax_init_params  # noqa: E402
from repro.serve.step import make_prefill_step as jax_prefill_step  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.kernels import flash_attention, flash_attention_plain  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve.step import make_prefill_step  # noqa: E402
from repro_torch.weights import tensor_from_numpy, to_torch  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=0.08, rtol=0.05)
MODEL_TOL = {"float32": F32, "bfloat16": BF16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor (identical bits)."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, tensor_from_numpy(np.asarray(j))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **tol)


# ------------------------------------------------------------ flash kernel

#: (B, Sq, Sk, H, KV, hd, dtype, causal, window, scale, blk) — the case list
#: of tests/test_kernels.py (head dims x dtypes, GQA ratios, windows,
#: non-causal, ragged, block shapes, custom scale)
FLASH_CASES = (
    [(2, 256, 256, 4, 2, hd, dt, True, None, None, (128, 128))
     for hd in (64, 112, 128) for dt in ("float32", "bfloat16")]
    + [(2, 128, 128, 8, 8 // g, 64, "float32", True, None, None, (128, 128))
       for g in (1, 2, 8)]
    + [(1, 512, 512, 4, 1, 64, "float32", True, w, None, (128, 128))
       for w in (32, 128, 511)]
    + [(2, 128, 256, 4, 4, 64, "float32", False, None, None, (128, 128)),
       (1, 200, 200, 2, 2, 64, "float32", True, None, None, (128, 128))]
    + [(1, 512, 512, 2, 1, 64, "float32", True, None, None, blk)
       for blk in ((64, 64), (128, 256), (256, 128))]
    + [(1, 128, 128, 4, 1, 128, "float32", True, None,
        1.0 / math.sqrt(256.0), (128, 128))]
)


@functools.cache
def _flash_case(case):
    B, Sq, Sk, H, KV, hd, dt, causal, window, scale, (bq, bk) = case
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    qj, qt = _pair(rng.standard_normal((B, Sq, H, hd)), dt)
    kj, kt = _pair(rng.standard_normal((B, Sk, KV, hd)), dt)
    vj, vt = _pair(rng.standard_normal((B, Sk, KV, hd)), dt)
    kw = dict(causal=causal, window=window, scale=scale)
    kern = jax_flash(qj, kj, vj, blk_q=bq, blk_k=bk, interpret=True, **kw)
    ref = attention_ref(qj, kj, vj, **kw)
    return (qt, kt, vt), kw, np.asarray(kern, np.float32), \
        np.asarray(ref, np.float32)


@pytest.mark.parametrize("port_fn", [flash_attention_plain, flash_attention],
                         ids=["plain", "wrapper-on-cpu"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_matches_jax_kernel_and_oracle(case, port_fn):
    (qt, kt, vt), kw, kern, ref = _flash_case(case)
    out = port_fn(qt, kt, vt, **kw)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    tol = TOL[case[6]]
    _close(out, kern, atol=tol, rtol=tol)
    _close(out, ref, atol=tol, rtol=tol)


def test_flash_rows_with_no_visible_key_are_zero():
    """Non-causal window 8 over 64 keys: queries from 71 on see no key."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 96, 2, 64), (1, 64, 1, 64), (1, 64, 1, 64)))
    out = flash_attention_plain(q, k, v, causal=False, window=8)
    ref = attention_ref(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                        causal=False, window=8)
    assert torch.isfinite(out).all()
    assert out[:, 71:].abs().max() == 0
    _close(out, ref, atol=2e-5, rtol=2e-5)


# ------------------------------------------------------------ model level

@functools.cache
def _qwen3(dtype):
    jcfg = jax_reduced("qwen3-1.7b").replace(dtype=dtype)
    tcfg = reduced_config("qwen3-1.7b").replace(dtype=dtype)
    jp = jax_init_params(jax.random.PRNGKey(0), JT.model_specs(jcfg),
                         jcfg.jdtype)
    return jcfg, tcfg, jp, to_torch(jax.device_get(jp), "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", [
    dict(S=24), dict(S=32, q_block=8), dict(S=48, q_block=8, window=5),
    dict(S=32, q_block=16, window=40), dict(S=20, causal=False)],
    ids=["one-block", "q-blocked", "windowed-sliced", "window-over-block",
         "bidirectional"])
def test_attention_matches_jax(dtype, variant):
    """Full-sequence attention, plain (the reference's query-blocked _sdpa,
    incl. the windowed key slice) and kernel path, against JAX."""
    jcfg, tcfg, jp, tp = _qwen3(dtype)
    v = dict(variant)
    S = v.pop("S")
    rng = np.random.default_rng(S)
    xj, xt = _pair(rng.standard_normal((2, S, tcfg.d_model)), dtype)
    pj = jax.tree.map(lambda a: a[0], jp["blocks"]["b0_attn"]["attn"])
    pt = {k: t[0] for k, t in tp["blocks"]["b0_attn"]["attn"].items()}
    yj = JL.attention(pj, jcfg, xj, **v)
    tol = MODEL_TOL[dtype]
    _close(TL.attention(pt, tcfg, xt, plain=True, **v), yj, **tol)
    v.pop("q_block", None)
    _close(TL.attention(pt, tcfg, xt, **v), yj, **tol)


def test_attention_kernel_path_takes_default_positions_only():
    """No ``positions`` argument: queries sit at 0..Sq-1 and keys at
    0..Sk-1, also for cross-attention (``kv_x``), where both paths agree
    with the JAX package's default positions."""
    jcfg, tcfg, jp, tp = _qwen3("float32")
    pt = {k: t[0] for k, t in tp["blocks"]["b0_attn"]["attn"].items()}
    x = torch.zeros((1, 4, tcfg.d_model))
    with pytest.raises(TypeError, match="positions"):
        TL.attention(pt, tcfg, x, positions=torch.arange(4) + 3)
    pj = jax.tree.map(lambda a: a[0], jp["blocks"]["b0_attn"]["attn"])
    rng = np.random.default_rng(4)
    xj, xt = _pair(rng.standard_normal((1, 4, tcfg.d_model)), "float32")
    mj, mt = _pair(rng.standard_normal((1, 7, tcfg.d_model)), "float32")
    yj = JL.attention(pj, jcfg, xj, kv_x=mj, causal=False, use_rope=False)
    for plain in (True, False):
        _close(TL.attention(pt, tcfg, xt, kv_x=mt, causal=False,
                            use_rope=False, plain=plain), yj,
               **MODEL_TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plain", [True, False], ids=["plain", "kernel-path"])
def test_qwen3_forward_and_prefill_match_jax(dtype, plain):
    jcfg, tcfg, jp, tp = _qwen3(dtype)
    toks = np.random.default_rng(11).integers(0, tcfg.vocab_size, (2, 24))
    lj, auxj = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)})
    lt, auxt = TT.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                          plain=plain)
    assert lt.shape == (2, 24, tcfg.vocab_size) and lt.dtype == tcfg.torch_dtype
    assert float(auxt) == float(auxj) == 0.0
    tol = MODEL_TOL[dtype]
    _close(lt, lj, **tol)
    pj = jax_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    pt = make_prefill_step(tcfg, plain=plain)(
        tp, {"tokens": torch.from_numpy(toks)})
    assert pt.dtype == torch.float32 and pt.shape == (2, tcfg.vocab_size)
    _close(pt, pj, **tol)
    _close(TT.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                      plain=plain), pj, **tol)


def test_decoder_prefill_method():
    jcfg, tcfg, jp, tp = _qwen3("float32")
    toks = np.random.default_rng(12).integers(0, tcfg.vocab_size, (3, 9))
    pj = jax_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    model = TT.Decoder(tcfg, tp, device="cpu")
    pt = model.prefill({"tokens": torch.from_numpy(toks)})
    assert pt.dtype == torch.float32
    _close(pt, pj, **F32)
