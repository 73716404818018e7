"""The split-K decode plan and the bf16 tensor-core flash kernel's numeric
change, on the CPU.

* ``plan_splits`` picks the decode kernel's number of key-range slices
  from the cache length, the (batch x kv head) count and the SM count.
* ``decode_attention_splitk_plain`` is the kernel's split-and-merge
  arithmetic in plain PyTorch; it must equal ``decode_attention_plain`` and
  the JAX oracle ``decode_attention_ref`` at f32 within 1e-5, with empty
  slices, windows across slice boundaries, GQA groups 1 / 2 / 8 and hd 112.
* The bf16 flash kernel rounds the probabilities to bf16 before P V
  (the TPU kernel keeps them f32).  Its error budget: at f32 inputs, the
  plain path with P so rounded stays within a row-relative 5e-3 of
  ``flash_attention_plain``.

The CUDA kernels are held against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import functools
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import decode_attention_ref  # noqa: E402
from repro_torch.kernels import (decode_attention_plain,  # noqa: E402
                                 decode_attention_splitk_plain,
                                 flash_attention_plain, plan_splits)
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    TILE_KEYS, split_bounds)
from repro_torch.kernels.flash_attention.ops import _valid  # noqa: E402

H100_SMS = 132

# ------------------------------------------------------------ plan_splits


@pytest.mark.parametrize("s_max,bkv", [(48, 32), (32, 64)],
                         ids=["qwen3-serve", "zamba2-generate"])
def test_plan_splits_is_one_at_the_serve_shapes(s_max, bkv):
    """qwen3-1.7b serves at B 4 x KV 8 with a 48-key cache, zamba2-7b at
    B 2 x KV 32 with 32 keys: one slice, so the kernel writes the output
    itself and a step launches no merge kernel."""
    assert plan_splits(s_max, bkv, H100_SMS) == 1


def test_plan_splits_fills_the_card_at_the_timing_shape():
    """B 4 x KV 8 at S 4096: at least two blocks for every SM."""
    n = plan_splits(4096, 32, H100_SMS)
    assert 32 * n >= 2 * H100_SMS


@pytest.mark.parametrize("s_max", [1, 31, 32, 33, 256, 257, 1000, 4096,
                                   65536])
def test_plan_splits_never_exceeds_the_key_tiles(s_max):
    for bkv in (1, 8, 32, 512, 10_000):
        for sms in (1, 132):
            n = plan_splits(s_max, bkv, sms)
            assert 1 <= n <= -(-s_max // TILE_KEYS)
            # every slice is whole tiles, and together they cover the cache
            slices = split_bounds(s_max - 1, s_max, n)
            assert slices[0][0] == 0 and slices[-1][1] == s_max - 1
            assert all((lo % TILE_KEYS == 0) for lo, hi in slices if lo <= hi)


# ------------------------------------------------------------ split and merge

#: (B, KV, G, hd, S, pos, window, n_split): empty slices (pos 0, 1, 255
#: with 16 slices of 32 keys), windows crossing a slice boundary (at 896
#: for S 1024 in 16 slices), GQA groups 1 / 2 / 8, hd 112, a ragged last
#: slice, and the timing shape's plan
SPLIT_CASES = [
    (2, 2, 1, 64, 512, 0, None, 16),
    (2, 2, 2, 64, 512, 1, None, 16),
    (2, 2, 8, 64, 512, 255, None, 16),
    (2, 2, 2, 112, 512, 300, None, 4),
    (2, 2, 2, 64, 1024, 900, 32, 16),
    (2, 2, 8, 64, 1024, 900, 256, 16),
    (2, 2, 1, 112, 700, 600, None, 3),
    (1, 2, 2, 128, 4096, 4095, None, plan_splits(4096, 32, H100_SMS)),
]


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


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_split_and_merge_matches_plain_and_jax(case):
    B, KV, G, hd, S, pos, window, n_split = case
    rng = np.random.default_rng(13)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, 1, KV * G, hd), (B, S, KV, hd), (B, S, KV, hd)))
    scale = 1.0 / math.sqrt(hd)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tpos = torch.tensor(pos, dtype=torch.int32)
    out = decode_attention_splitk_plain(tq, tk, tv, tpos, n_split=n_split,
                                        scale=scale, window=window)
    assert out.shape == tq.shape and out.dtype == tq.dtype
    if pos < 256:       # the case exercises slices with no key at all
        assert any(lo > hi for lo, hi in split_bounds(pos, S, n_split,
                                                      window))
    plain = decode_attention_plain(tq, tk, tv, tpos, scale=scale,
                                   window=window)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=1e-5,
                               rtol=1e-5)
    ref = _decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      jnp.int32(pos), window, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------------------ bf16 P budget

#: (B, Sq, Sk, H, KV, hd, causal, window, scale): the card's flash sweep
#: (chip_smoke.FLASH_CASES) at S <= 512
BUDGET_CASES = (
    [(2, 256, 256, 4, 2, hd, True, None, None) for hd in (64, 112, 128)]
    + [(2, 128, 128, 8, 8 // g, 64, True, None, None) for g in (1, 2, 8)]
    + [(1, 512, 512, 4, 1, 64, True, w, None) for w in (32, 128, 511)]
    + [(2, 128, 256, 4, 4, 64, False, None, None),
       (1, 200, 200, 2, 2, 64, True, None, None),
       (1, 128, 128, 4, 1, 128, True, None, 1.0 / 16.0),
       (1, 256, 64, 2, 1, 64, False, 8, None),
       (2, 77, 77, 4, 2, 112, True, 1, None),
       (1, 1, 300, 4, 4, 128, False, None, None),
       (2, 300, 300, 4, 2, 128, True, None, None),
       (1, 300, 300, 4, 2, 112, True, None, None)])


def _flash_bf16_p(q, k, v, *, causal, window, scale):
    """The tensor-core kernel's arithmetic at f32 inputs: f32 scores and
    statistics, unnormalised probabilities e^(s - max) rounded to bf16
    before P V, the row sum l taken from the f32 probabilities."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", q.reshape(B, Sq, KV, G, hd),
                     k) * scale
    s = s.masked_fill(~_valid(Sq, Sk, causal, window, q.device), -math.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m.clamp_min(-1e30)).nan_to_num_(0.0)
    row_sum = p.sum(-1, keepdim=True)
    o = torch.einsum("bkgqs,bskh->bkgqh", p.bfloat16().float(), v)
    o = torch.where(row_sum > 0, o / row_sum, torch.zeros_like(o))
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


@pytest.mark.parametrize("case", BUDGET_CASES, ids=str)
def test_bf16_probabilities_stay_within_the_row_budget(case):
    B, Sq, Sk, H, KV, hd, causal, window, scale = case
    rng = np.random.default_rng(21)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    kw = dict(causal=causal, window=window, scale=scale)
    ref = flash_attention_plain(q, k, v, **kw)
    out = _flash_bf16_p(q, k, v, **kw)
    assert torch.isfinite(out).all()
    norm = ref.norm(dim=-1)
    keep = norm > 0
    if (~keep).any():       # rows with no visible key are 0 in both
        assert out.norm(dim=-1)[~keep].max().item() == 0
    rel = ((out - ref).norm(dim=-1)[keep] / norm[keep]).max().item()
    assert rel <= 5e-3
