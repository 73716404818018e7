"""The port's plain decode-attention version against the JAX reference
kernel (rmsnorm: ``tests/test_torch_kernels_rmsnorm.py``).

Same inputs (numpy, seeded; bf16 bits shared exactly) go through the
Pallas kernel in interpret mode, its pure-jnp oracle (``ref.py``) and the
port's plain PyTorch version on the CPU.  Case lists and tolerances are
the JAX kernel tests' (``tests/test_kernels.py``,
``tests/test_kernels_decode_ssm.py``): f32 2e-5, bf16 2e-2.  The CUDA
kernels themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import functools
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import decode_attention, decode_attention_ref  # noqa: E402
from repro_torch.kernels import decode_attention as t_decode_attention  # noqa: E402
from repro_torch.kernels import decode_attention_plain  # noqa: E402
from repro_torch.weights import tensor_from_numpy  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor (identical bits)."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, tensor_from_numpy(np.asarray(j))


def _close(torch_out, jax_out, tol):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32),
                               atol=tol, rtol=tol)


# ------------------------------------------------------------ decode attention

#: (B, KV, G, hd, S, pos, window, blk_k, dtype) — the JAX sweep.  The
#: head-dim and group sweeps run the interpret-mode kernel as one cache
#: block (interpret mode compiles per grid; block skipping is what the
#: position, window and ragged cases cover, at the JAX tests' blocks).
DECODE_CASES = (
    [(2, 2, 4, hd, 512, 300, None, 512, dt)
     for hd in (64, 112, 128) for dt in ("float32", "bfloat16")]
    + [(2, 2, g, 64, 512, 511, None, 512, "bfloat16") for g in (1, 2, 8)]
    + [(2, 2, 4, 64, 512, p, None, 256, "bfloat16")
       for p in (0, 1, 255, 256, 500)]
    + [(2, 2, 4, 64, 1024, 900, w, 256, "bfloat16")
       for w in (32, 256, 1 << 20)]
    + [(2, 2, 4, 64, 700, 600, None, 256, "bfloat16")]
)


@functools.partial(jax.jit, static_argnums=(4, 5))    # one compile per case
def _decode_ref(q, kc, vc, pos, window, scale):
    B, _, H, hd = q.shape
    S, KV = kc.shape[1], kc.shape[2]
    G = H // KV
    qg = q[:, 0].reshape(B * KV, G, hd)
    kk = kc.transpose(0, 2, 1, 3).reshape(B * KV, S, hd)
    vv = vc.transpose(0, 2, 1, 3).reshape(B * KV, S, hd)
    out = decode_attention_ref(qg, kk, vv, pos, scale=scale, window=window)
    return out.reshape(B, 1, H, hd)


@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_decode_attention_plain_matches_jax(case):
    B, KV, G, hd, S, pos, window, blk_k, dtype = case
    rng = np.random.default_rng(42)
    qj, qt = _pair(rng.standard_normal((B, 1, KV * G, hd)), dtype)
    kj, kt = _pair(rng.standard_normal((B, S, KV, hd)), dtype)
    vj, vt = _pair(rng.standard_normal((B, S, KV, hd)), dtype)
    scale = 1.0 / math.sqrt(hd)
    pj = jnp.int32(pos)
    pt = torch.tensor(pos, dtype=torch.int32)

    out = decode_attention_plain(qt, kt, vt, pt, scale=scale, window=window)
    assert out.shape == qt.shape and out.dtype == qt.dtype
    kern = decode_attention(qj, kj, vj, pj, scale=scale, window=window,
                            blk_k=blk_k)
    _close(out, kern, TOL[dtype])
    _close(out, _decode_ref(qj, kj, vj, pj, window, scale), TOL[dtype])


def test_decode_attention_wrapper_takes_plain_path_on_cpu():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 64)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 33, 2, 64)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 33, 2, 64)).astype(np.float32))
    pos = torch.tensor(20, dtype=torch.int32)
    before = t_decode_attention.launches
    out = t_decode_attention(q, k, v, pos, window=8)
    assert t_decode_attention.launches == before     # no kernel on the CPU
    assert torch.equal(out, decode_attention_plain(q, k, v, pos, window=8))
