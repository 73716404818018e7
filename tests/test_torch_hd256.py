"""The kernels' plain versions at the dense family's new instances, on the
CPU: flash and decode attention at hd 256 (gemma3-1b), decode attention at
GQA groups 5 and 6 (qwen2.5-14b, nemotron-4-15b), and the launch plans
behind them (``plan_splits``' blocks per SM for each instance, ``plan_rows``
at d 1152, 5120 and 6144).

Same inputs (numpy, seeded; bf16 bits shared exactly) go through the JAX
package's Pallas kernels in interpret mode, its oracles (``attention_ref``,
``decode_attention_ref``) and the port, whose wrappers take their plain
versions on CPU tensors.  Tolerances are the JAX kernel tests' own: f32
2e-5, bf16 2e-2.  The CUDA kernels are held against the plain versions on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import functools
import math
import os
import re
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import attention_ref  # noqa: E402
from repro.kernels import decode_attention as jax_decode  # noqa: E402
from repro.kernels import decode_attention_ref  # noqa: E402
from repro.kernels import flash_attention as jax_flash  # noqa: E402
from repro.kernels import rmsnorm_ref  # noqa: E402
from repro_torch.kernels import (decode_attention,  # noqa: E402
                                 decode_attention_plain,
                                 decode_attention_splitk_plain,
                                 flash_attention, flash_attention_plain,
                                 plan_rows, plan_splits, rmsnorm_lanes_plain,
                                 rmsnorm_plain)
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.weights import tensor_from_numpy  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
H100_SMS = 132
_CSRC = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch",
                     "csrc")


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor (identical bits)."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, tensor_from_numpy(np.asarray(j))


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


# ------------------------------------------------------------ flash, hd 256

#: (B, Sq, Sk, H, KV, dtype, causal, window): tests/test_kernels.py's
#: head-dim case at hd 256, gemma3's KV 1 with a window, and ragged Sk
FLASH_CASES = [
    (2, 256, 256, 4, 2, "float32", True, None),
    (2, 256, 256, 4, 2, "bfloat16", True, None),
    (1, 512, 512, 4, 1, "float32", True, 128),
    (1, 512, 512, 4, 1, "bfloat16", True, 128),
    (1, 200, 200, 4, 1, "float32", True, None),
    (1, 128, 333, 4, 1, "float32", False, None),
]


@functools.cache
def _flash(case):
    B, Sq, Sk, H, KV, dt, causal, window = case
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    qj, qt = _pair(rng.standard_normal((B, Sq, H, 256)), dt)
    kj, kt = _pair(rng.standard_normal((B, Sk, KV, 256)), dt)
    vj, vt = _pair(rng.standard_normal((B, Sk, KV, 256)), dt)
    kw = dict(causal=causal, window=window)
    kern = jax_flash(qj, kj, vj, blk_q=128, blk_k=128, interpret=True, **kw)
    return (qt, kt, vt), kw, np.asarray(kern, np.float32), np.asarray(
        attention_ref(qj, kj, vj, **kw), np.float32)


@pytest.mark.parametrize("port_fn", [flash_attention_plain, flash_attention],
                         ids=["plain", "wrapper-on-cpu"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_hd256_matches_jax_kernel_and_oracle(case, port_fn):
    (qt, kt, vt), kw, kern, ref = _flash(case)
    out = port_fn(qt, kt, vt, **kw)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    tol = TOL[case[5]]
    _close(out, kern, tol)
    _close(out, ref, tol)


# ------------------------------------------------------------ decode

#: (B, KV, G, hd, S, pos, window, dtype): gemma3's KV 1, G 4, hd 256 with
#: and without its window (the window inside the cache and reaching its
#: start), and qwen2.5's G 5 and nemotron's G 6 at hd 128
DECODE_CASES = [
    (2, 1, 4, 256, 512, 300, None, "float32"),
    (2, 1, 4, 256, 512, 300, None, "bfloat16"),
    (2, 1, 4, 256, 512, 500, 128, "float32"),
    (2, 1, 4, 256, 512, 100, 128, "float32"),
    (2, 2, 5, 128, 512, 511, None, "float32"),
    (2, 2, 6, 128, 512, 300, 64, "float32"),
    (2, 2, 6, 128, 512, 300, None, "bfloat16"),
]


@functools.cache
def _decode(case):
    B, KV, G, hd, S, pos, window, dt = case
    rng = np.random.default_rng(zlib.crc32(repr(case).encode()))
    qj, qt = _pair(rng.standard_normal((B, 1, KV * G, hd)), dt)
    kj, kt = _pair(rng.standard_normal((B, S, KV, hd)), dt)
    vj, vt = _pair(rng.standard_normal((B, S, KV, hd)), dt)
    kern = jax_decode(qj, kj, vj, jnp.int32(pos), window=window, blk_k=128)
    qg = qj[:, 0].reshape(B * KV, G, hd)
    kk = kj.transpose(0, 2, 1, 3).reshape(B * KV, S, hd)
    vv = vj.transpose(0, 2, 1, 3).reshape(B * KV, S, hd)
    ref = decode_attention_ref(qg, kk, vv, jnp.int32(pos),
                               scale=1.0 / math.sqrt(hd), window=window)
    return (qt, kt, vt), np.asarray(kern, np.float32), np.asarray(
        ref.reshape(B, 1, KV * G, hd), np.float32)


@pytest.mark.parametrize("port_fn", [decode_attention_plain, decode_attention],
                         ids=["plain", "wrapper-on-cpu"])
@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_decode_new_instances_match_jax_kernel_and_oracle(case, port_fn):
    (qt, kt, vt), kern, ref = _decode(case)
    pos, window, dt = case[5], case[6], case[7]
    out = port_fn(qt, kt, vt, torch.tensor(pos, dtype=torch.int32),
                  window=window)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    _close(out, kern, TOL[dt])
    _close(out, ref, TOL[dt])


@pytest.mark.parametrize("case", [c for c in DECODE_CASES
                                  if c[7] == "float32"], ids=str)
def test_decode_split_and_merge_at_the_new_instances(case):
    """The kernel's split-and-merge arithmetic, sliced as the card's plan
    slices gemma3's long cache (many slices, most of them empty under the
    window), equals the oracle."""
    (qt, kt, vt), _, ref = _decode(case)
    B, KV, G, hd, S, pos, window, _ = case
    n_split = plan_splits(S, B * KV, H100_SMS, hd=hd, itemsize=4)
    out = decode_attention_splitk_plain(
        qt, kt, vt, torch.tensor(pos, dtype=torch.int32), n_split=n_split,
        window=window)
    _close(out, ref, 1e-5)


# ------------------------------------------------------------ plans

def test_blocks_per_sm_follows_each_instance_ring():
    """The ring of 32-key tiles: 3 stages at bf16, 2 at f32.  At hd 128 a
    bf16 block takes 48 KB (four share an SM), at hd 256 96 KB (two); f32
    at hd 256 takes 128 KB (one)."""
    assert dops.ring_bytes(128, 2) == 48 * 1024
    assert dops.ring_bytes(256, 2) == 96 * 1024
    assert dops.ring_bytes(256, 4) == 128 * 1024
    assert dops.blocks_per_sm(128, 2) == 4
    assert dops.blocks_per_sm(112, 2) == 4
    assert dops.blocks_per_sm(128, 4) == 3
    assert dops.blocks_per_sm(256, 2) == 2
    assert dops.blocks_per_sm(256, 4) == 1


@pytest.mark.parametrize("hd,itemsize", [(128, 2), (256, 2), (256, 4),
                                         (128, 4)])
def test_plan_splits_fills_one_wave_of_the_instance(hd, itemsize):
    """gemma3's long step (B 8 x KV 1 at 32768 keys) and the hd-128 timing
    shape: the split never asks for more blocks than one wave of the
    instance holds, and fills at least half of it."""
    for s_max, bkv in ((32768, 8), (4096, 32)):
        n = plan_splits(s_max, bkv, H100_SMS, hd=hd, itemsize=itemsize)
        wave = dops.blocks_per_sm(hd, itemsize) * H100_SMS
        assert bkv * n <= wave < 2 * bkv * n + bkv
    assert plan_splits(32768, 8, H100_SMS, hd=256) == 33
    assert plan_splits(4096, 32, H100_SMS) == plan_splits(
        4096, 32, H100_SMS, hd=128, itemsize=2) == 16


def test_plan_constants_match_the_decode_source():
    """``ring_bytes`` mirrors ``stages`` / ``smem_bytes`` of
    ``csrc/decode_attention.cu``, and the kernel is instantiated for every
    head dim and group the wrapper lets through."""
    src = open(os.path.join(_CSRC, "decode_attention.cu")).read()
    assert "constexpr int kTileKeys = 32;" in src and dops.TILE_KEYS == 32
    assert "return sizeof(T) == 2 ? 3 : 2;" in src
    assert ("return stages<T>() * 2 * kTileKeys * HD * (int)sizeof(T);"
            in src)
    cases = {int(h) for h in re.findall(r"case (\d+): return launch_hd", src)}
    assert cases == set(dops.HEAD_DIMS)
    assert max(dops.MAX_GROUP.values()) == 16 and dops.MAX_GROUP[256] == 4


@pytest.mark.parametrize("d,dtype,want", [
    (1152, torch.bfloat16, ("rows", 16, 9)),
    (1152, torch.float32, ("rows", 32, 9)),
    (5120, torch.bfloat16, ("loop", 32, 20)),
    (6144, torch.bfloat16, ("loop", 32, 24)),
    (256, torch.bfloat16, ("rows", 32, 1)),
])
def test_plan_rows_at_the_dense_family_widths(d, dtype, want):
    """gemma3's d 1152 takes the new (16, 9) rows instance at bf16 and
    (32, 9) at f32; qwen2.5's 5120 and nemotron's 6144 hold more than
    REG_WORDS a lane and take the loop path; gemma3's q/k-norm rows of 256
    take (32, 1)."""
    plan = plan_rows(8192, d, dtype, H100_SMS, True, scale_dtype=dtype)
    assert (plan.path, plan.lpr, plan.vpl) == want


@pytest.mark.parametrize("d,dtype", [(1152, "bfloat16"), (1152, "float32"),
                                     (5120, "bfloat16"), (6144, "float32")])
def test_rmsnorm_lanes_at_the_dense_family_widths(d, dtype):
    """The kernel's order of summation at these plans equals the plain
    version and the JAX oracle (f32 within 1e-6; bf16 within the
    tolerance of the JAX tests)."""
    rng = np.random.default_rng(d)
    xj, xt = _pair(rng.standard_normal((37, d)), dtype)
    sj, st = _pair(rng.standard_normal((d,)) * 0.1 + 1.0, "float32")
    plan = plan_rows(37, d, xt.dtype, H100_SMS, True, scale_dtype=st.dtype)
    out = rmsnorm_lanes_plain(xt, st, None, plan)
    if dtype == "float32":
        torch.testing.assert_close(out, rmsnorm_plain(xt, st), rtol=1e-6,
                                   atol=1e-6)
    _close(out, rmsnorm_ref(xj, sj), TOL[dtype])
