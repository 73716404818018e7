"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks the ``card`` fixture for the device, which
skips where there is none (this decision is made inside the fixture, never
at import time, so every pytest worker collects the same tests).  Run on a
machine with an H100 and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import math
from contextlib import nullcontext

import pytest
import torch

from repro_torch.kernels import (decode_attention, decode_attention_plain,
                                 flash_attention, flash_attention_plain,
                                 rmsnorm, rmsnorm_plain, ssm_scan,
                                 ssm_scan_plain)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: the partials mode merged at bf16, against the whole-cache kernel and the
#: plain version: within one bf16 ulp (2^-7 of the value) of the largest
#: entry, since each output is an f32 value rounded once
PARTIALS_BF16_REL = 2.0 ** -7
#: flash_attention at bf16: largest |out - ref| / |ref| over query rows
FLASH_BF16_ROW_REL_TOL = 1e-2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(shape, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 256), (3, 7, 512), (1000, 128),
                                   (4, 2048), (5, 130),
                                   # ragged row counts on the persistent
                                   # path: no whole warp step, short last
                                   # steps, one row
                                   (131071, 128), (4097, 3584), (1, 2048)])
@pytest.mark.parametrize("with_res", [False, True])
def test_rmsnorm_kernel_matches_plain(card, shape, dtype, with_res):
    x = _randn(shape, dtype, card, 0)
    scale = _randn(shape[-1:], torch.float32, card, 1) * 0.1 + 1.0
    res = _randn(shape, dtype, card, 2) if with_res else None
    before = rmsnorm.launches
    y = rmsnorm(x, scale, res)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), rmsnorm_plain(x, scale, res).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (4, 1, 2048), (4, 1, 16, 128), (4, 1, 8, 128),          # qwen3 decode
    (4, 2048, 2048), (4, 2048, 16, 128), (4, 2048, 8, 128),  # qwen3 prefill
    (1, 4096, 3584), (2, 1, 3584),                 # zamba2 prefill, decode
    # gemma3-1b prefill (S 8192) and decode: d 1152 on the (16, 9) rows
    # instance at bf16, (32, 9) at f32; its q/k-norm rows of 256
    (1, 8192, 1152), (4, 1, 1152), (1, 8192, 4, 256), (4, 1, 1, 256),
    # qwen2.5-14b and nemotron-4-15b: d 5120 and 6144 on the loop path
    (1, 4096, 5120), (4, 1, 5120), (1, 4096, 6144), (4, 1, 6144),
    # xlstm-125m (d 768), olmoe-1b-7b (d 2048; q/k-norm rows of 128 at B 1
    # x S 4096), kimi-k2 (d 7168), llama-3.2-vision (d 4096)
    (1, 2048, 768), (4, 1, 768), (1, 4096, 16, 128), (4, 1, 16, 128),
    (1, 2048, 7168), (4, 1, 7168), (1, 2048, 4096), (4, 1, 4096),
], ids=str)
def test_rmsnorm_kernel_matches_plain_at_path_shapes(card, shape, dtype):
    """The models' shapes, scale in x's dtype as the models hold it; d 3584
    is 14 16-byte vectors a lane at bf16, 28 at f32 (the loop path)."""
    x = _randn(shape, dtype, card, 0)
    scale = _randn(shape[-1:], dtype, card, 1)
    y = rmsnorm(x, scale)
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), rmsnorm_plain(x, scale).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_res", [False, True])
def test_rmsnorm_kernel_matches_plain_off_16_byte_alignment(card, dtype,
                                                            with_res):
    """x one element past a 16-byte boundary: a width the vector paths
    take, sent down the scalar path."""
    rows, d = 33, 2048
    x = _randn((rows * d + 1,), dtype, card, 0)[1:].view(rows, d)
    res = (_randn((rows * d + 1,), dtype, card, 2)[1:].view(rows, d)
           if with_res else None)
    scale = _randn((d,), dtype, card, 1)
    y = rmsnorm(x, scale, res)
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), rmsnorm_plain(x, scale, res).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (B, KV, G, hd, S, pos, window)
    (2, 2, 4, 64, 512, 300, None), (2, 2, 4, 112, 512, 300, None),
    (4, 8, 2, 128, 48, 47, None), (2, 2, 1, 64, 512, 0, None),
    (2, 2, 8, 64, 700, 600, None), (2, 2, 4, 128, 1024, 900, 32),
    (2, 2, 4, 64, 1024, 900, 1 << 20), (1, 1, 16, 128, 300, 299, 256),
    # gemma3-1b: KV 1, G 4, hd 256, window 512 on its local layers; a
    # serving cache (600 + 32 keys) and the 32768-key cache of one long
    # step (split across blocks, the window inside the last slices)
    (4, 1, 4, 256, 632, 631, None), (4, 1, 4, 256, 632, 631, 512),
    (4, 1, 4, 256, 632, 100, 512), (2, 2, 2, 256, 512, 300, None),
    (8, 1, 4, 256, 32768, 32760, None), (8, 1, 4, 256, 32768, 32760, 512),
    # qwen2.5-14b (G 5) and nemotron-4-15b (G 6) on the G <= 16 instance
    (4, 8, 5, 128, 32, 31, None), (4, 8, 6, 128, 32, 31, None),
    (4, 8, 5, 128, 4096, 4095, None), (4, 8, 6, 128, 4096, 2047, 256),
    # zamba2-7b generate: B 2, KV 32, G 1, hd 112, S_max 32
    (2, 32, 1, 112, 32, 0, None), (2, 32, 1, 112, 32, 15, None),
    (2, 32, 1, 112, 32, 31, None),
    # generate at B 4: olmoe-1b-7b (KV 16, G 1, hd 128), kimi-k2 (KV 8,
    # G 8, hd 112), whisper-large-v3's decoder (KV 20, G 1, hd 64); the
    # one-query cross-attention over whisper's 1500 encoder rows and
    # llama-3.2-vision's 1024 patches (pos = M - 1)
    (4, 16, 1, 128, 32, 31, None), (4, 8, 8, 112, 32, 31, None),
    (4, 20, 1, 64, 48, 47, None), (4, 20, 1, 64, 1500, 1499, None),
    (4, 8, 4, 128, 1024, 1023, None),
] + [
    # the timing shape's cache, split across blocks: empty, partial and
    # full slices, windows inside one slice and across slices
    (4, 8, 2, 128, 4096, p, None) for p in (0, 1, 300, 2047, 4095)
] + [(4, 8, 2, 128, 4096, p, w) for p in (2047, 4095) for w in (32, 256)],
    ids=str)
def test_decode_attention_kernel_matches_plain(card, case, dtype):
    B, KV, G, hd, S, pos, window = case
    q = _randn((B, 1, KV * G, hd), dtype, card, 0)
    k = _randn((B, S, KV, hd), dtype, card, 1)
    v = _randn((B, S, KV, hd), dtype, card, 2)
    p = torch.tensor(pos, dtype=torch.int32, device=card)
    scale = 1.0 / math.sqrt(hd)
    before = decode_attention.launches
    out = decode_attention(q, k, v, p, scale=scale, window=window)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    ref = decode_attention_plain(q, k, v, p, scale=scale, window=window)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [
    # qwen3-1.7b's B 1 x 32768 keys cut into 2 and 4 blocks (pos inside a
    # block, on a boundary, blocks wholly past it); gemma3-1b's hd 256 with
    # its window of 512 across a boundary
    (1, 8, 2, 128, 32768, n, p, None) for n in (2, 4)
    for p in (100, 16383, 16384, 20000)
] + [(4, 1, 4, 256, 1024, n, 600, 512) for n in (2, 4)], ids=str)
def test_decode_attention_partials_match_plain(card, case, dtype):
    """The partials mode on each block of keys at its offset, merged by
    the merge kernel: the whole-cache kernel's output and the plain
    version's; each block's partials against the plain partials."""
    from repro_torch.kernels import (decode_attention_merge,
                                     decode_attention_merge_plain,
                                     decode_attention_partials,
                                     decode_attention_partials_plain)

    B, KV, G, hd, S, n, pos, window = case
    q = _randn((B, 1, KV * G, hd), dtype, card, 0)
    k = _randn((B, S, KV, hd), dtype, card, 1)
    v = _randn((B, S, KV, hd), dtype, card, 2)
    p = torch.tensor(pos, dtype=torch.int32, device=card)
    per = S // n
    before = (decode_attention_partials.launches,
              decode_attention_merge.launches)
    blocks = [(k[:, i * per:(i + 1) * per].contiguous(),
               v[:, i * per:(i + 1) * per].contiguous(), i * per)
              for i in range(n)]
    parts = torch.stack([decode_attention_partials(q, kb, vb, p, k_off=off,
                                                   window=window)
                         for kb, vb, off in blocks])
    out = decode_attention_merge(parts, q, KV)
    torch.cuda.synchronize()
    assert (decode_attention_partials.launches,
            decode_attention_merge.launches) == (before[0] + n, before[1] + 1)
    whole = decode_attention(q, k, v, p, window=window)
    ref = decode_attention_plain(q, k, v, p, window=window)

    def close(got, want):
        if dtype == torch.float32:
            tol = dict(atol=TOL[dtype], rtol=TOL[dtype])
        else:   # one bf16 ulp at the largest entry: rounding, not a fault
            tol = dict(atol=PARTIALS_BF16_REL * want.float().abs().max()
                       .item(), rtol=0)
        torch.testing.assert_close(got.float(), want.float(), **tol)

    close(out, whole)
    close(out, ref)
    bkvg = B * KV * G
    for (kb, vb, off), got in zip(blocks, parts):
        want = decode_attention_partials_plain(q, kb, vb, p, k_off=off,
                                               window=window)
        # the kernel's slices of the block against one plain slice: merged
        if torch.isinf(want[:bkvg]).all():      # an empty block stays empty
            n_split = got.numel() // (bkvg * (hd + 2))
            assert torch.isinf(got[:bkvg * n_split]).all()
        else:
            close(decode_attention_merge_plain(got[None], q, KV),
                  decode_attention_merge_plain(want[None], q, KV))


#: (B, Sq, Sk, H, KV, hd, causal, window, scale) — the JAX sweep
#: (tests/test_kernels.py: head dims, GQA ratios, windows, non-causal,
#: ragged, block-shape case, custom scale), rows with every key masked, and
#: the two model paths' shapes (qwen3-1.7b, zamba2-7b)
FLASH_CASES = (
    [(2, 256, 256, 4, 2, hd, True, None, None) for hd in (64, 112, 128)]
    + [(2, 128, 128, 8, 8 // g, 64, True, None, None) for g in (1, 2, 8)]
    + [(1, 512, 512, 4, 1, 64, True, w, None) for w in (32, 128, 511)]
    + [(2, 128, 256, 4, 4, 64, False, None, None),
       (1, 200, 200, 2, 2, 64, True, None, None),
       (1, 512, 512, 2, 1, 64, True, None, None),
       (1, 128, 128, 4, 1, 128, True, None, 1.0 / 16.0),
       (1, 256, 64, 2, 1, 64, False, 8, None),     # rows past Sk+7: no key
       (2, 77, 77, 4, 2, 112, True, 1, None),      # window 1: the diagonal
       (1, 1, 300, 4, 4, 128, False, None, None),
       # Sq not a multiple of the bf16 kernel's 128-query tile; hd 112
       (2, 300, 300, 4, 2, 128, True, None, None),
       (1, 300, 300, 4, 2, 112, True, None, None),
       (1, 190, 333, 4, 1, 64, False, 100, None),
       (4, 2048, 2048, 16, 8, 128, True, None, None),
       (1, 4096, 4096, 32, 32, 112, True, None, None)]
    # hd 256 (gemma3-1b: H 4, KV 1): causal with and without its window
    # of 512, a window edge on a 128-query tile edge, ragged Sq and Sk,
    # non-causal, GQA 2, and the prefill's own shape
    + [(1, 1024, 1024, 4, 1, 256, True, w, None) for w in (None, 512)]
    + [(1, 700, 700, 4, 1, 256, True, 128, None),
       (2, 300, 333, 4, 2, 256, False, None, None),
       (1, 190, 190, 4, 1, 256, True, None, None),
       (1, 8192, 8192, 4, 1, 256, True, 512, None),
       (1, 8192, 8192, 4, 1, 256, True, None, None)]
    # whisper-large-v3: the bidirectional encoder over 1500 frames and the
    # decoder's cross-attention (448 queries, 1500 keys); llama-3.2-vision's
    # cross-attention (2048 queries, 1024 patches, GQA 4); kimi-k2's causal
    # prefill (H 64, KV 8, hd 112)
    + [(1, 1500, 1500, 20, 20, 64, False, None, None),
       (1, 448, 1500, 20, 20, 64, False, None, None),
       (1, 2048, 1024, 32, 8, 128, False, None, None),
       (1, 2048, 2048, 64, 8, 112, True, None, None)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_kernel_matches_plain(card, case, dtype):
    B, Sq, Sk, H, KV, hd, causal, window, scale = case
    q = _randn((B, Sq, H, hd), dtype, card, 0)
    k = _randn((B, Sk, KV, hd), dtype, card, 1)
    v = _randn((B, Sk, KV, hd), dtype, card, 2)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window, scale=scale)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_plain(q, k, v, causal=causal, window=window,
                                scale=scale)
    assert torch.isfinite(out.float()).all()
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        # row by row: the element-wise 2e-2 is loose where |o| is small, as
        # at the model paths' lengths (|o| ~ 0.03 at S 2048)
        diff = (out.float() - ref.float()).norm(dim=-1)
        norm = ref.float().norm(dim=-1)
        keep = norm > 0
        assert (diff[keep] / norm[keep]).max().item() <= FLASH_BF16_ROW_REL_TOL


#: the compute-probability mode: hd 64 / 112 / 128 / 256, GQA, windows,
#: rows with no visible key, non-causal Sq != Sk, one query (a decode
#: step's cross-attention under the option), qwen3's prefill
FLASH_COMPUTE_CASES = [
    (2, 256, 256, 4, 2, 64, True, None, None),
    (2, 77, 77, 4, 2, 112, True, 1, None),
    (1, 128, 128, 4, 1, 128, True, None, 1.0 / 16.0),
    (1, 256, 64, 2, 1, 64, False, 8, None),
    (1, 700, 700, 4, 1, 256, True, 128, None),
    (2, 300, 333, 4, 2, 256, False, None, None),
    (1, 1, 1500, 20, 20, 64, False, None, None),
    (4, 2048, 2048, 16, 8, 128, True, None, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_COMPUTE_CASES, ids=str)
def test_flash_attention_compute_kernel_matches_plain(card, case, dtype):
    """``probs="compute"``: at bf16 the kernel's compute instances (counted
    in ``compute_launches``), at f32 the float32 mode's launch; against
    ``flash_attention_plain(probs="compute")`` at the float32 mode's
    tolerances."""
    B, Sq, Sk, H, KV, hd, causal, window, scale = case
    q = _randn((B, Sq, H, hd), dtype, card, 0)
    k = _randn((B, Sk, KV, hd), dtype, card, 1)
    v = _randn((B, Sk, KV, hd), dtype, card, 2)
    kw = dict(causal=causal, window=window, scale=scale, probs="compute")
    before = (flash_attention.launches, flash_attention.compute_launches)
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert (flash_attention.launches, flash_attention.compute_launches) == \
        (before[0] + (not bf16), before[1] + bf16)
    ref = flash_attention_plain(q, k, v, **kw)
    assert torch.isfinite(out.float()).all()
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    if bf16:
        diff = (out.float() - ref.float()).norm(dim=-1)
        norm = ref.float().norm(dim=-1)
        keep = norm > 0
        assert (diff[keep] / norm[keep]).max().item() <= FLASH_BF16_ROW_REL_TOL


def _ssm_inputs(B, S, H, P, N, dtype, dev, seed, dt_scale=1.0):
    """The JAX sweep's distributions (tests/test_kernels_decode_ssm.py),
    dt scaled by ``dt_scale``."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device=dev)

    return ((n(B, S, H, P) * 0.5).to(dtype),
            n(B, S, H).abs() * (0.1 * dt_scale),
            -n(H).abs() - 0.1, (n(B, S, N) * 0.3).to(dtype),
            (n(B, S, N) * 0.3).to(dtype))


#: (B, S, H, P, N, chunk[, dt scale]) — the JAX sweep (chunks, head shapes,
#: ragged S, state continuity) and the zamba2-7b path's shape; then the
#: chunk-parallel kernel's edges: B > 1 at full width (groups of 8 chunks),
#: one step past a chunk with H odd, a single ragged chunk (one group, no
#: state launch), and dt x 10 so that exp(cum) underflows inside a chunk;
#: last, a rank's block of zamba2-7b's 112 heads under tensor parallelism
#: (56 on two ranks at the TP train step's S 2048, 28 on four)
SSM_CASES = ([(2, 256, 8, 32, 16, c) for c in (32, 64, 128)]
             + [(2, 256, h, p, 16, 64) for h, p in ((4, 16), (8, 64),
                                                    (16, 32))]
             + [(2, 200, 8, 32, 16, 64), (2, 512, 8, 32, 16, 128),
                (1, 300, 4, 64, 64, 128), (1, 4096, 112, 64, 64, 128)]
             + [(2, 4096, 112, 64, 64, 128), (1, 129, 3, 64, 64, 128),
                (1, 64, 112, 64, 64, 128), (1, 2048, 16, 64, 64, 128, 10.0)]
             + [(1, 2048, 56, 64, 64, 128), (2, 1024, 28, 64, 64, 128)])
SSM_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtypes", [(torch.float32, None),
                                    (torch.bfloat16, None),
                                    (torch.bfloat16, torch.float32)],
                         ids=["f32", "bf16", "bf16-out-f32"])
@pytest.mark.parametrize("case", SSM_CASES, ids=str)
def test_ssm_scan_kernel_matches_plain(card, case, dtypes):
    B, S, H, P, N, chunk, *dt_scale = case
    dtype, out_dtype = dtypes
    args = _ssm_inputs(B, S, H, P, N, dtype, card, 0, *dt_scale)
    before = ssm_scan.launches
    y = ssm_scan(*args, chunk=chunk, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    ref = ssm_scan_plain(*args, chunk=chunk, out_dtype=out_dtype)
    assert y.dtype == ref.dtype == (out_dtype or dtype)
    assert torch.isfinite(y.float()).all()
    tol = SSM_TOL[y.dtype]
    torch.testing.assert_close(y.float(), ref.float(), atol=tol, rtol=tol)


def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    q = torch.zeros((1, 1, 4, 96), device=card)      # hd 96: no instance
    k = torch.zeros((1, 8, 2, 96), device=card)
    p = torch.zeros((), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="hd=96"):
        decode_attention(q, k, k, p)
    with pytest.raises(TypeError, match="dtype"):
        rmsnorm(torch.zeros((2, 8), dtype=torch.float16, device=card),
                torch.ones(8, device=card))
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm(torch.zeros((8, 4), device=card).t(),
                torch.ones(8, device=card))
    q = torch.zeros((1, 8, 4, 96), device=card)
    with pytest.raises(ValueError, match="hd=96"):
        flash_attention(q, q, q)
    q = torch.zeros((1, 8, 4, 64), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                        q.transpose(1, 2))
    with pytest.raises(ValueError, match="several devices"):
        flash_attention(q, q.cpu(), q)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q.half(), q.half(), q.half())
    x, dt, A, Bm, Cm = _ssm_inputs(1, 64, 2, 64, 16, torch.float32, card, 0)
    with pytest.raises(ValueError, match="chunk=48"):
        ssm_scan(x, dt, A, Bm, Cm, chunk=48)
    with pytest.raises(ValueError, match="P=24"):
        ssm_scan(x[..., :24].contiguous(), dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan(x, dt, A, Bm.transpose(1, 2).contiguous().transpose(1, 2),
                 Cm)
    with pytest.raises(ValueError, match="several devices"):
        ssm_scan(x, dt, A.cpu(), Bm, Cm)
    with pytest.raises(TypeError, match="float32"):
        ssm_scan(x, dt.bfloat16(), A, Bm, Cm)
    with pytest.raises(TypeError, match="ssm_scan out"):
        ssm_scan(x, dt, A, Bm, Cm, out_dtype=torch.float16)
    with pytest.raises(TypeError, match="ssm_scan out"):
        ssm_scan(x, dt, A, Bm, Cm, out_dtype=torch.bfloat16)


def test_decoder_kernels_match_plain_path(card):
    """A two-layer decoder at hd 128: kernel path vs plain path on the card,
    and the launch counts of one step."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.transformer import Decoder, decode_step, init_cache

    cfg = reduced_config("qwen3-1.7b").replace(
        d_model=256, n_heads=4, n_kv_heads=2, head_dim=128, d_ff=512)
    params = Decoder(cfg, device=card).tree()
    toks = torch.randint(0, cfg.vocab_size, (2, 6), device=card,
                         generator=torch.Generator(card).manual_seed(3))
    ck, cp = init_cache(cfg, 2, 6, card), init_cache(cfg, 2, 6, card)
    with torch.inference_mode():
        for t in range(6):
            pos = torch.tensor(t, dtype=torch.int32, device=card)
            a0, r0 = decode_attention.launches, rmsnorm.launches
            lk, ck = decode_step(params, cfg, ck, toks[:, t:t + 1], pos)
            assert decode_attention.launches - a0 == cfg.n_layers
            assert rmsnorm.launches - r0 == 4 * cfg.n_layers + 1
            lp, cp = decode_step(params, cfg, cp, toks[:, t:t + 1], pos,
                                 plain=True)
            torch.testing.assert_close(lk.float(), lp.float(), atol=0.08,
                                       rtol=0.05)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,S", [("qwen3-1.7b", 96), ("zamba2-7b", 256)])
def test_reduced_forward_kernels_match_plain_path(card, arch, S, dtype):
    """Reduced qwen3 (hd 128) and zamba2 (hd 64, P 64) full-sequence
    forwards, kernel path vs plain path on the card, and the launches of
    one forward.  f32: within 1e-3.  bf16: the plain path rounds attention
    probabilities to bf16 where the kernel keeps f32, and a random hybrid
    amplifies bf16 rounding (its bf16 logits sit ~0.6 from its f32 logits at
    this width), so the two must lie within twice the plain path's own
    distance from the f32 forward (the triangle bound) and at cosine
    > 0.999."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import Decoder, forward, program_for

    cfg = reduced_config(arch).replace(
        d_model=256, n_heads=4, n_kv_heads=2 if arch.startswith("qwen") else 4,
        d_ff=512, dtype=dtype)
    if arch.startswith("qwen"):
        cfg = cfg.replace(head_dim=128)
    params = Decoder(cfg, device=card).tree()
    toks = torch.randint(0, cfg.vocab_size, (2, S), device=card,
                         generator=torch.Generator(card).manual_seed(5))
    grp, n_groups, rem = program_for(cfg)
    n_attn = n_groups * (grp.count("attn") + grp.count("shared_attn"))
    n_mamba = n_groups * grp.count("mamba") + rem.count("mamba")
    batch = {"tokens": toks}
    with torch.inference_mode():
        a0, s0 = flash_attention.launches, ssm_scan.launches
        lk, _ = forward(params, cfg, batch)
        torch.cuda.synchronize()
        assert flash_attention.launches - a0 == n_attn
        assert ssm_scan.launches - s0 == n_mamba
        lp, _ = forward(params, cfg, batch, plain=True)
        lk, lp = lk.float(), lp.float()
        assert torch.isfinite(lk).all()
        if dtype == "float32":
            torch.testing.assert_close(lk, lp, atol=1e-3, rtol=1e-3)
            return
        l32, _ = forward(tree_map(lambda t: t.float(), params),
                         cfg.replace(dtype="float32"), batch, plain=True)
    floor = (lp - l32).abs().max().item()
    assert (lk - lp).abs().max().item() <= 2 * floor
    assert torch.nn.functional.cosine_similarity(
        lk.flatten(), lp.flatten(), dim=0).item() > 0.999


def test_sweep_on_the_card_matches_the_cpu(card):
    """The paper's three fleets under the scenarios' jitter, swept on the
    card and on the CPU: the draws are counter-based, so the two agree
    lane for lane (same winners, times at rtol 1e-5)."""
    import numpy as np

    from repro_torch.core.autotune import autotune_batch, default_grid
    from repro_torch.core.scenarios import (GB, paper_baseline,
                                            with_added_latency,
                                            with_throttled_fastest)

    base = paper_baseline()
    fleets = [base, with_added_latency(base), with_throttled_fastest(base)]
    bw = np.asarray([[s.bandwidth for s in f] for f in fleets])
    rtt = np.asarray([[s.rtt for s in f] for f in fleets])
    tt = np.asarray([[s.profile[0][0] if s.profile else np.inf for s in f]
                     for f in fleets])
    tb = np.asarray([[s.profile[0][1] if s.profile else s.bandwidth
                      for s in f] for f in fleets])
    kw = dict(throttle_t=tt, throttle_bw=tb, jitter=0.02, n_seeds=4,
              grid=default_grid())
    on_card = autotune_batch(bw, rtt, 1 * GB, device=card, **kw)
    on_cpu = autotune_batch(bw, rtt, 1 * GB, device="cpu", **kw)
    for a, b in zip(on_card, on_cpu):
        assert a.params == b.params
        np.testing.assert_allclose(a.predicted_times, b.predicted_times,
                                   rtol=1e-5)


@pytest.mark.parametrize("spool", [False, True])
def test_streaming_restore_pins_and_copies_off_the_loop(card, tmp_path,
                                                        spool):
    """In memory, the restore lands in page-locked memory; with a spool,
    each leaf is copied off the map first.  Either way each leaf's copy is
    queued on the restore's own stream, ``finish`` returns only landed
    tensors, bit-exact on the card, and ``close`` unmaps the spool."""
    import json
    import os

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.checkpoint.manager import _StreamingRestore

    g = torch.Generator().manual_seed(0)
    state = {"w": torch.randn((1024, 1024), generator=g),
             "e": torch.randn((301, 129), generator=g).to(torch.bfloat16),
             "s": torch.tensor(3, dtype=torch.int32)}
    d = save_checkpoint(str(tmp_path), 1, state)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(d, "data.bin"), "rb") as f:
        blob = f.read()
    stream = _StreamingRestore(
        manifest, state, card,
        spool_path=str(tmp_path / "spool") if spool else None)
    assert stream._stream is not None
    assert stream._stream != torch.cuda.current_stream(card)
    assert (stream._host is None) == spool
    if not spool:
        assert stream._host.is_pinned()
    mm = stream._mmap
    stream.sink(0, blob)
    out = stream.finish()
    assert stream._stream.query()           # nothing handed back in flight
    stream.close()
    assert stream._mmap is None
    if spool:
        assert mm.closed
    for k, t in state.items():
        assert out[k].device.type == "cuda"
        assert out[k].dtype == t.dtype and torch.equal(out[k].cpu(), t), k
    local, _ = restore_checkpoint(str(tmp_path), state, device=card)
    for k, t in state.items():
        assert torch.equal(local[k].cpu(), t), k


def _card_config(arch, dtype="float32"):
    """A reduced config at widths the kernels are built for: qwen3 at hd
    128, gemma3 at hd 256 (KV 1, G 4, window 16), the others at hd 64
    (zamba2, olmoe, whisper, llama-3.2-vision; xlstm's cells at 128)."""
    from repro_torch.configs import reduced_config

    cfg = reduced_config(arch).replace(dtype=dtype, d_model=256, d_ff=512)
    if arch == "qwen3-1.7b":
        return cfg.replace(n_heads=4, n_kv_heads=2, head_dim=128)
    if arch == "gemma3-1b":
        return cfg.replace(head_dim=256)
    return cfg.replace(n_heads=4, n_kv_heads=4)


def _counts():
    from repro_torch.kernels import (decode_attention_merge,
                                     decode_attention_partials)

    return {f.__name__: f.launches for f in (
        decode_attention, decode_attention_partials, decode_attention_merge,
        rmsnorm, flash_attention, ssm_scan)}


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-1b", "zamba2-7b",
                                  "olmoe-1b-7b", "xlstm-125m",
                                  "whisper-large-v3", "llama-3.2-vision-11b"])
def test_captured_generate_matches_the_eager_step(card, arch):
    """Greedy tokens identical, captured against eager, at f32 (gemma3's
    20 positions pass its window of 16); the graph holds exactly one eager
    step's kernel launches and replays once per position; teacher-forced
    logits of the captured step equal the eager step's within 1e-3."""
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import Decoder, decode_step, init_cache
    from repro_torch.serve.step import CapturedServeStep

    cfg = _card_config(arch)
    model = Decoder(cfg, device=card)
    prompt = torch.randint(0, cfg.vocab_size, (2, 8), device=card,
                           generator=torch.Generator(card).manual_seed(3))
    log = []
    captured = generate(cfg, model, prompt, 12, device=card, step_log=log)
    eager = generate(cfg, model, prompt, 12, device=card, capture=False)
    assert torch.equal(captured, eager)
    step = log[0]
    assert step.replays == 20
    params = model.tree()
    # encdec and vlm decode against generate's stub memory: 8 zero rows
    mem_len = 8 if cfg.family in ("encdec", "vlm") else 0
    cache = init_cache(cfg, 2, 20, card, mem_len=mem_len)
    fresh = CapturedServeStep(cfg, params, 2, 20, device=card,
                              mem_len=mem_len)
    with torch.inference_mode():
        for t in range(20):
            pos = torch.tensor(t, dtype=torch.int32, device=card)
            before = _counts()
            lk, cache = decode_step(params, cfg, cache, eager[:, t:t + 1], pos)
            after = _counts()
            assert step.launches == {k: after[k] - before[k] for k in after}
            _, lg = fresh(eager[:, t:t + 1], pos)
            torch.testing.assert_close(lg, lk.float(), atol=1e-3, rtol=0)


def test_captured_sampling_draws_from_the_registered_generator(card):
    """temperature > 0: the generator is registered with the graph, so
    every replay draws afresh; the same seed gives the same tokens, and the
    draws differ from greedy decoding."""
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import Decoder

    cfg = _card_config("qwen3-1.7b")
    model = Decoder(cfg, device=card)
    prompt = torch.randint(0, cfg.vocab_size, (2, 4), device=card,
                           generator=torch.Generator(card).manual_seed(4))
    a, b = (generate(cfg, model, prompt, 16, temperature=2.0, seed=7,
                     device=card) for _ in range(2))
    greedy = generate(cfg, model, prompt, 16, device=card)
    assert torch.equal(a, b)
    assert ((a >= 0) & (a < cfg.vocab_size)).all()
    assert not torch.equal(a, greedy)


def test_a_capture_that_fails_raises(card, monkeypatch):
    """A host sync inside the step cannot be captured: generate raises and
    never falls back to the eager step."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import layers
    from repro_torch.models.transformer import Decoder

    cfg = _card_config("qwen3-1.7b")
    model = Decoder(cfg, device=card)
    norm = layers.rmsnorm

    def syncing_norm(x, scale, *a, **kw):
        if torch.cuda.is_current_stream_capturing():
            float(x.float().sum())          # a host read: not capturable
        return norm(x, scale, *a, **kw)

    monkeypatch.setattr(layers, "rmsnorm", syncing_norm)
    prompt = torch.zeros((2, 4), dtype=torch.long, device=card)
    with pytest.raises(RuntimeError):
        generate(cfg, model, prompt, 4, device=card)
    torch.cuda.synchronize()


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llama-3.2-vision-11b"])
def test_captured_step_reads_the_memory_written_after_capture(card, arch):
    """The memory is part of the captured step's static cache: written
    after the capture, and rewritten mid-sequence, the replays' logits
    follow it (equal to eager steps on the same memories within 1e-3, and
    away from eager steps that kept the first memory).  The VLM's gates
    are set to 0.5 (zero would add no cross-attention)."""
    from repro_torch.models.transformer import Decoder, decode_step, init_cache
    from repro_torch.serve.step import CapturedServeStep

    cfg = _card_config(arch)
    params = Decoder(cfg, device=card).tree()
    for key, blk in params["blocks"].items():
        if "gate" in blk:
            blk["gate"].fill_(0.5)
    B, S, M = 2, 8, 24
    g = torch.Generator(card).manual_seed(6)
    mems = [torch.randn((B, M, cfg.d_model), device=card, generator=g)
            for _ in range(2)]
    toks = torch.randint(0, cfg.vocab_size, (B, S), device=card, generator=g)
    step = CapturedServeStep(cfg, params, B, S, device=card, mem_len=M)
    follow = init_cache(cfg, B, S, card, mem_len=M)
    stay = init_cache(cfg, B, S, card, mem_len=M)
    step.cache["memory"].copy_(mems[0])
    follow["memory"].copy_(mems[0])
    stay["memory"].copy_(mems[0])
    with torch.inference_mode():
        for t in range(S):
            if t == S // 2:
                step.cache["memory"].copy_(mems[1])
                follow["memory"].copy_(mems[1])
            pos = torch.tensor(t, dtype=torch.int32, device=card)
            _, lg = step(toks[:, t:t + 1], pos)
            lf, _ = decode_step(params, cfg, follow, toks[:, t:t + 1], pos)
            ls, _ = decode_step(params, cfg, stay, toks[:, t:t + 1], pos)
            torch.testing.assert_close(lg, lf.float(), atol=1e-3, rtol=0)
            if t >= S // 2:
                assert (lg - ls.float()).abs().max().item() > 1e-2


def test_captured_moe_step_matches_the_eager_step_at_capacity_one(card):
    """olmoe's step at B 2 (capacity 1 per expert: pairs that share an
    expert drop) captured: teacher-forced logits equal the eager step's
    within 1e-3, and the graph holds the eager step's launches."""
    from repro_torch.models import moe
    from repro_torch.models.transformer import Decoder, decode_step, init_cache
    from repro_torch.serve.step import CapturedServeStep

    cfg = _card_config("olmoe-1b-7b")
    assert moe.capacity(cfg, 2) == 1
    params = Decoder(cfg, device=card).tree()
    toks = torch.randint(0, cfg.vocab_size, (2, 12), device=card,
                         generator=torch.Generator(card).manual_seed(8))
    step = CapturedServeStep(cfg, params, 2, 12, device=card)
    cache = init_cache(cfg, 2, 12, card)
    with torch.inference_mode():
        for t in range(12):
            pos = torch.tensor(t, dtype=torch.int32, device=card)
            before = _counts()
            le, cache = decode_step(params, cfg, cache, toks[:, t:t + 1], pos)
            after = _counts()
            assert step.launches == {k: after[k] - before[k] for k in after}
            _, lg = step(toks[:, t:t + 1], pos)
            torch.testing.assert_close(lg, le.float(), atol=1e-3, rtol=0)


# ------------------------------------------------------------- gradients

def _grad(fn, inputs, cot):
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*ins)
    return out.detach(), torch.autograd.grad(out, ins, cot)


#: the backward is the plain version's VJP at the same inputs, so the
#: gradients differ only by the order of f32 sums (flash: dk, dv summed
#: over query blocks): f32 within 1e-4, bf16 within one bf16 ulp (2e-2)
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [  # B, Sq, Sk, H, KV, hd, causal, window
    (2, 1100, 1100, 4, 2, 128, True, None),
    (1, 700, 700, 4, 1, 256, True, 128),
    (2, 96, 300, 4, 4, 64, False, None),
    # the cross-attention of a tensor-parallel rank: whisper-large-v3's 10
    # of 20 heads over its 1500 frames, llama-3.2-vision's 16 of 32 heads
    # (4 of 8 KV heads) over 1024 patches
    (1, 448, 1500, 10, 10, 64, False, None),
    (1, 2048, 1024, 16, 4, 128, False, None),
], ids=str)
def test_flash_attention_gradients_match_plain(card, case, dtype):
    B, Sq, Sk, H, KV, hd, causal, window = case
    q = _randn((B, Sq, H, hd), dtype, card, 0)
    k = _randn((B, Sk, KV, hd), dtype, card, 1)
    v = _randn((B, Sk, KV, hd), dtype, card, 2)
    cot = _randn((B, Sq, H, hd), dtype, card, 3)
    kw = dict(causal=causal, window=window)
    before = flash_attention.launches
    out, got = _grad(lambda *t: flash_attention(*t, **kw), (q, k, v), cot)
    assert flash_attention.launches == before + 1   # none in the backward
    with torch.no_grad():
        assert torch.equal(out, flash_attention(q, k, v, **kw))
    _, want = _grad(lambda *t: flash_attention_plain(*t, **kw), (q, k, v),
                    cot)
    for g, w in zip(got, want):
        assert g.abs().max() > 0
        torch.testing.assert_close(g.float(), w.float(), atol=GRAD_TOL[dtype],
                                   rtol=GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4096, 2048), (8192, 128), (5, 130)])
@pytest.mark.parametrize("with_res", [False, True])
def test_rmsnorm_gradients_match_plain(card, shape, dtype, with_res):
    x = _randn(shape, dtype, card, 0)
    scale = (_randn(shape[-1:], torch.float32, card, 1) * 0.1 + 1.0).to(dtype)
    ins = [x, scale] + ([_randn(shape, dtype, card, 2)] if with_res else [])
    cot = _randn(shape, dtype, card, 3)
    out, got = _grad(lambda x, s, *r: rmsnorm(x, s, *r), ins, cot)
    _, want = _grad(lambda x, s, *r: rmsnorm_plain(x, s, *r), ins, cot)
    for g, w in zip(got, want):
        assert g.abs().max() > 0
        torch.testing.assert_close(g.float(), w.float(), atol=GRAD_TOL[dtype],
                                   rtol=GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(1, 512, 8, 64, 64, 128),
                                  (2, 300, 4, 32, 16, 64),
                                  (1, 2048, 56, 64, 64, 128)], ids=str)
def test_ssm_scan_gradients_match_plain(card, case, dtype):
    B, S, H, P, N, chunk = case
    x, dt, A, Bm, Cm = _ssm_inputs(B, S, H, P, N, dtype, card, 4)
    cot = _randn((B, S, H, P), torch.float32, card, 5)
    kw = dict(chunk=chunk, out_dtype=torch.float32)
    _, got = _grad(lambda *t: ssm_scan(*t, **kw), (x, dt, A, Bm, Cm), cot)
    _, want = _grad(lambda *t: ssm_scan_plain(*t, **kw), (x, dt, A, Bm, Cm),
                    cot)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and g.abs().max() > 0
        torch.testing.assert_close(g.float(), w.float(), atol=1e-4, rtol=1e-4)


def test_decode_attention_raises_under_grad(card):
    q = _randn((2, 1, 4, 128), torch.bfloat16, card, 0).requires_grad_(True)
    k = _randn((2, 64, 2, 128), torch.bfloat16, card, 1)
    v = _randn((2, 64, 2, 128), torch.bfloat16, card, 2)
    pos = torch.tensor(10, dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="forward-only"):
        decode_attention(q, k, v, pos)
    with torch.no_grad():
        decode_attention(q, k, v, pos)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-7b"])
def test_train_step_on_the_card_reaches_every_norm_and_projection(card,
                                                                  arch):
    """One ``make_train_step`` step of a reduced model on the card with
    ``remat="full"``: every norm scale and every ``wq`` / ``wk`` / ``wv``
    gets a nonzero gradient through the kernels (a kernel that cut the
    autograd graph would leave them none), the kernel path's f32
    gradients equal the plain path's within 1e-3 of each leaf's largest
    entry, each kernel of the stack launches twice (forward and
    recompute), and the step's loss is finite."""
    from repro_torch.models.common import init_params, tree_leaves
    from repro_torch.models.transformer import (lm_loss, model_specs,
                                                program_for)
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.weights import unflatten

    cfg = _card_config(arch).replace(remat="full")
    params = init_params(model_specs(cfg),
                         torch.Generator(card).manual_seed(0),
                         cfg.torch_dtype, card)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (2, 256), device=card,
        generator=torch.Generator(card).manual_seed(1))}

    def grads(plain):
        keys, leaves = zip(*tree_leaves(params))
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        loss = lm_loss(unflatten(dict(zip(keys, leaves))), cfg, batch,
                       plain=plain)
        return dict(zip(keys, torch.autograd.grad(loss, leaves)))

    c0 = _counts()
    gk = grads(False)
    c1 = _counts()
    gp = grads(True)
    assert _counts() == c1
    grp, n_groups, rem = program_for(cfg)
    n_attn = n_groups * sum(k in ("attn", "shared_attn") for k in grp)
    n_ssm = n_groups * grp.count("mamba") + rem.count("mamba")
    # rem's mamba blocks sit outside the checkpointed groups: once each
    assert c1["flash_attention"] - c0["flash_attention"] == 2 * n_attn
    assert c1["ssm_scan"] - c0["ssm_scan"] == \
        2 * n_groups * grp.count("mamba") + rem.count("mamba")
    reached = [k for k in gk if k.endswith(("scale", "/wq", "/wk", "/wv"))]
    assert any(k.endswith("/wq") for k in reached)
    for k in reached:
        assert gk[k].abs().max() > 0, k
    for k in gk:
        peak = gp[k].abs().max().item()
        torch.testing.assert_close(gk[k], gp[k], atol=1e-3 * peak + 1e-6,
                                   rtol=1e-3, msg=k)
    assert n_attn + n_ssm > 0
    opt = AdamWConfig(warmup_steps=1)
    state = init_train_state(params, opt)
    state, m = make_train_step(cfg, opt)(state, batch)
    assert torch.isfinite(m["loss"]) and m["grad_norm"] > 0
    assert int(state["step"]) == 1


@pytest.fixture
def nccl_mesh(card, tmp_path):
    """A 1-rank NCCL process group in the test's process and a (1, 1)
    (data, model) mesh over it; destroyed after the test."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path}/rendezvous", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield make_local_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def test_sharded_restore_on_the_card_is_bit_exact(card, nccl_mesh, tmp_path):
    """A reduced olmoe checkpoint restored with ``shardings=`` under the
    1-rank mesh: every leaf a DTensor on the card whose local shard is the
    saved leaf, bit for bit."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.distributed import activate
    from repro_torch.models.common import (init_params, sharding_tree,
                                           tree_leaves)
    from repro_torch.models.transformer import model_specs

    cfg = _card_config("olmoe-1b-7b", "bfloat16")
    specs = model_specs(cfg)
    tree = init_params(specs, torch.Generator(card).manual_seed(0),
                       cfg.torch_dtype, card)
    save_checkpoint(str(tmp_path / "ckpt"), 1, tree)
    with activate(nccl_mesh):
        out, _ = restore_checkpoint(str(tmp_path / "ckpt"), specs,
                                    device=card,
                                    shardings=sharding_tree(specs))
    got = dict(tree_leaves(out))
    for k, t in tree_leaves(tree):
        assert isinstance(got[k], DTensor), k
        local = got[k].to_local()
        assert local.is_cuda and torch.equal(local, t), k


def test_dp_step_on_one_rank_is_bit_equal_to_the_plain_step(card, nccl_mesh):
    """Two AdamW steps of a reduced qwen3 under the 1-rank mesh equal the
    unmeshed steps bit for bit (an average over one rank is the identity),
    deterministic algorithms on."""
    from repro_torch.distributed import activate
    from repro_torch.models.common import init_params, tree_leaves
    from repro_torch.models.transformer import model_specs
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = _card_config("qwen3-1.7b", "bfloat16").replace(remat="full")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    batches = [{"tokens": torch.randint(
        0, cfg.vocab_size, (2, 128), device=card,
        generator=torch.Generator(card).manual_seed(i))} for i in (1, 2)]

    def run(mesh):
        state = init_train_state(init_params(
            model_specs(cfg), torch.Generator(card).manual_seed(0),
            cfg.torch_dtype, card), opt)
        step = make_train_step(cfg, opt)
        losses = []
        with activate(mesh) if mesh is not None else nullcontext():
            for b in batches:
                state, m = step(state, b)
                losses.append(m["loss"].item())
        return losses, dict(tree_leaves(state["params"]))

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        lm, pm = run(nccl_mesh)
        lp, pp = run(None)
    finally:
        torch.use_deterministic_algorithms(was)
    assert lm == lp
    for k in pp:
        assert torch.equal(pm[k], pp[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a2a_at_one_rank_matches_the_one_hot_path(card, nccl_mesh, dtype):
    """Reduced olmoe's ``lm_loss`` and gradients through the a2a path at
    M = 1 (under the mesh) and through the one-hot path, at capacity
    factor 64 where neither drops a pair: f32 within 1e-5 of each leaf's
    largest entry, bf16 at cosine > 0.999 per leaf and the loss within
    1e-2; the kernels launch on both paths."""
    from repro_torch.distributed import activate
    from repro_torch.models.common import init_params, tree_leaves
    from repro_torch.models.transformer import lm_loss, model_specs
    from repro_torch.weights import unflatten

    cfg = _card_config("olmoe-1b-7b", dtype).replace(capacity_factor=64.0,
                                                     remat="full")
    params = init_params(model_specs(cfg), torch.Generator(card).manual_seed(3),
                         cfg.torch_dtype, card)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (2, 64), device=card,
        generator=torch.Generator(card).manual_seed(4))}

    def grads(mesh):
        keys, leaves = zip(*tree_leaves(params))
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        with activate(mesh) if mesh is not None else nullcontext():
            loss = lm_loss(unflatten(dict(zip(keys, leaves))), cfg, batch)
            g = torch.autograd.grad(loss, leaves)
        return loss.item(), dict(zip(keys, g))

    c0 = _counts()
    la, ga = grads(nccl_mesh)
    c1 = _counts()
    lo, go = grads(None)
    assert c1["flash_attention"] > c0["flash_attention"]
    assert _counts()["rmsnorm"] - c1["rmsnorm"] == \
        c1["rmsnorm"] - c0["rmsnorm"] > 0
    if dtype == "float32":
        assert la == pytest.approx(lo, rel=1e-6)
        for k in go:
            peak = go[k].abs().max().item()
            torch.testing.assert_close(ga[k], go[k], atol=1e-5 * peak + 1e-7,
                                       rtol=1e-5, msg=k)
    else:
        assert abs(la - lo) <= 1e-2
        for k in go:
            a, o = ga[k].float().flatten(), go[k].float().flatten()
            if o.abs().max() > 0:
                cos = torch.nn.functional.cosine_similarity(a, o, dim=0)
                assert cos > 0.999, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tp_collectives_on_one_rank_on_the_card(card, nccl_mesh, dtype):
    """The tensor-parallel collectives over the 1-rank model group on CUDA
    tensors (NCCL): each forward and its stated backward is the identity
    on one rank, and every result stays on the card."""
    from repro_torch.distributed import activate
    from repro_torch.distributed import collectives as C

    x = _randn((2, 6, 4), dtype, card, 31)
    cot = _randn((2, 6, 4), dtype, card, 32)
    with activate(nccl_mesh) as ctx:
        group = ctx.model_group()
        ops = {"copy_to_model": lambda t: C.copy_to_model(t, group),
               "reduce_from_model": lambda t: C.reduce_from_model(t, group)}
        ops["split"] = lambda t: C.split(t, group)
        for dim in (0, 1, 2):
            ops[f"gather_{dim}"] = lambda t, d=dim: C.gather(t, group, d)
            ops[f"gather_dim_{dim}"] = lambda t, d=dim: C.gather_dim(
                t, group, d)
        for name, op in ops.items():
            t = x.clone().requires_grad_(True)
            y = op(t)
            (g,) = torch.autograd.grad(y, t, cot)
            assert y.is_cuda and g.is_cuda, name
            assert torch.equal(y, x) and torch.equal(g, cot), name
        stacked = C.all_gather_stacked(x, group)
        assert stacked.shape == (1, *x.shape) and torch.equal(stacked[0], x)


@pytest.mark.parametrize("loss_dtype", ["float32", "compute"])
def test_vocab_parallel_loss_on_one_rank_matches_the_plain_loss(
        card, nccl_mesh, loss_dtype):
    """``_VocabParallelNLL`` over the 1-rank model group on the card (one
    block holding the whole vocabulary) against the plain log-sum-exp
    minus the gathered label logit: values and gradients within f32
    rounding (bf16 logits: their gradient within one bf16 ulp)."""
    from repro_torch.distributed import activate
    from repro_torch.models.transformer import _VocabParallelNLL

    logits = _randn((2, 16, 96), torch.bfloat16, card, 33) * 4
    targets = torch.randint(0, 96, (2, 16), device=card,
                            generator=torch.Generator(card).manual_seed(34))
    with activate(nccl_mesh) as ctx:
        a = logits.clone().requires_grad_(True)
        nll = _VocabParallelNLL.apply(a, targets, 0, ctx.model_group(),
                                      loss_dtype == "compute")
        (ga,) = torch.autograd.grad(nll.mean(), a)
    b = logits.clone().requires_grad_(True)
    lf = b.float()
    want = torch.logsumexp(lf, -1) - torch.gather(
        lf, -1, targets[..., None])[..., 0]
    (gb,) = torch.autograd.grad(want.mean(), b)
    torch.testing.assert_close(nll, want, atol=1e-5, rtol=1e-6)
    torch.testing.assert_close(ga.float(), gb.float(), atol=2e-5, rtol=1e-2)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llama-3.2-vision-11b"])
def test_captured_cross_step_under_a_one_rank_mesh(card, nccl_mesh, arch):
    """``generate`` of an encdec or vlm model under ``serve_rules`` on the
    1-rank NCCL mesh, every step a replay of the captured step, against
    its own memory (``encode`` of random frames or patches, written by
    ``generate`` into the captured cache's rows): the tokens of the eager
    step without the mesh.  The VLM's gates are set to 0.5."""
    from repro_torch.distributed import activate
    from repro_torch.launch.dryrun import serve_rules
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import Decoder, encode

    cfg = _card_config(arch)
    params = Decoder(cfg, device=card).tree()
    for blk in params["blocks"].values():
        if "gate" in blk:
            blk["gate"].fill_(0.5)
    B, M = 2, 24
    g = torch.Generator(card).manual_seed(8)
    stub = "frames" if cfg.family == "encdec" else "patches"
    with torch.inference_mode():
        memory = encode(params, cfg, {stub: torch.randn(
            (B, M, cfg.frontend_dim), device=card, generator=g)})
    prompt = torch.randint(0, cfg.vocab_size, (B, 3), device=card,
                           generator=g)
    want = generate(cfg, params, prompt, 5, device=card, capture=False,
                    memory=memory)
    log = []
    with activate(nccl_mesh, serve_rules(cfg, nccl_mesh, B)):
        got = generate(cfg, params, prompt, 5, device=card, memory=memory,
                       step_log=log)
    assert log and log[0].replays == 8
    assert log[0].cache["memory"].shape == (B, M, cfg.d_model)
    assert torch.equal(got, want)


def test_sharded_save_on_one_rank_is_the_whole_save(card, nccl_mesh,
                                                    tmp_path):
    """A reduced qwen3 train state on the card saved with ``shardings=``
    under the 1-rank NCCL mesh (every leaf gathered over its one-rank
    group, moved to the host) has the bytes of the whole-state save."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.distributed import activate
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.models.common import init_params
    from repro_torch.models.transformer import model_specs
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import (init_sharded_train_state,
                                        train_state_shardings)

    cfg = _card_config("qwen3-1.7b", "bfloat16")
    params = init_params(model_specs(cfg), torch.Generator(card).manual_seed(5),
                         cfg.torch_dtype, card)
    with activate(nccl_mesh, rules_for(cfg, False)[1]):
        state = init_sharded_train_state(params, cfg, AdamWConfig())
        a = save_checkpoint(str(tmp_path / "sharded"), 1, state,
                            shardings=train_state_shardings(cfg, state))
    b = save_checkpoint(str(tmp_path / "whole"), 1, state)
    for f in ("data.bin", "manifest.json"):
        with open(f"{a}/{f}", "rb") as fa, open(f"{b}/{f}", "rb") as fb:
            assert fa.read() == fb.read(), f


@pytest.fixture
def nccl_pod_mesh(card, tmp_path):
    """A 1-rank NCCL process group and a (1, 1, 1) (pod, data, model)
    mesh over it, built by the code ``make_production_mesh`` uses."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import _mesh

    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path}/rendezvous", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield _mesh((1, 1, 1), ("pod", "data", "model"), card)
    finally:
        dist.destroy_process_group()


def test_data_major_placements_on_one_rank_on_the_card(card, nccl_pod_mesh,
                                                       tmp_path):
    """Reduced olmoe under the multi-pod storage rules: the expert leaves'
    ``("data", "pod")`` entry puts their placements on a ``DeviceMesh``
    whose dims are permuted to (data, pod, model), built from the NCCL
    mesh's own groups; ``distribute_tree`` / ``full_tree`` round-trip bit
    for bit, the sharded save is the whole save's bytes, and
    ``restore_checkpoint(shardings=)`` lands each leaf on the card as the
    saved one."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.distributed import activate
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.models.common import (distribute_tree, full_tree,
                                           init_params, local_tree,
                                           sharding_tree, tree_leaves)
    from repro_torch.models.transformer import model_specs

    cfg = _card_config("olmoe-1b-7b", "bfloat16")
    specs = model_specs(cfg)
    tree = init_params(specs, torch.Generator(card).manual_seed(5),
                       cfg.torch_dtype, card)
    with activate(nccl_pod_mesh, rules_for(cfg, True)[1]):
        shardings = sharding_tree(specs)
        pl = dict(tree_leaves(shardings))["blocks/b0_moe/moe/wi"]
        assert pl.axes == ("data", "pod", "model")
        assert pl.device_mesh is not nccl_pod_mesh
        assert pl.device_mesh.mesh_dim_names == pl.axes
        dt = distribute_tree(tree, shardings)
        back = dict(tree_leaves(full_tree(dt)))
        local = dict(tree_leaves(local_tree(dt)))
        save_checkpoint(str(tmp_path / "sharded"), 1, local_tree(dt),
                        shardings=shardings)
        out, _ = restore_checkpoint(str(tmp_path / "sharded"), specs,
                                    device=card, shardings=shardings)
    whole = save_checkpoint(str(tmp_path / "whole"), 1, tree)
    for f in ("data.bin", "manifest.json"):
        with open(f"{whole}/{f}", "rb") as a, open(
                f"{tmp_path}/sharded/step_{1:010d}/{f}", "rb") as b:
            assert a.read() == b.read(), f
    got = dict(tree_leaves(out))
    for k, t in tree_leaves(tree):
        assert torch.equal(back[k], t) and torch.equal(local[k], t), k
        assert isinstance(got[k], DTensor), k
        assert got[k].to_local().is_cuda and torch.equal(
            got[k].to_local(), t), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_hot_row_gather_backward_on_one_rank(card, nccl_pod_mesh, dtype):
    """The one-hot MoE path across ranks under grad, on the 1-rank NCCL
    (pod, data, model) mesh under the multi-pod rules: its row gather
    (``gather_dim`` over the batch axes: its backward a reduce-scatter),
    the gradient shares and the partial sums are identities on one rank,
    so y, lb and every gradient equal the one-hot path's bit for bit, on
    the card."""
    from repro_torch.distributed import activate
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.models import moe

    cfg = _card_config("olmoe-1b-7b", dtype)
    specs = moe.moe_specs(cfg)
    gen = torch.Generator(card).manual_seed(9)
    p = {k: (torch.randn(s.shape, generator=gen, device=card) * s.scale).to(
        cfg.torch_dtype) for k, s in specs.items()}
    x = torch.randn((2, 7, cfg.d_model), generator=gen, device=card).to(
        cfg.torch_dtype)
    cot = torch.randn(x.shape, generator=gen, device=card).to(x.dtype)

    def grads(fn):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xi = x.clone().requires_grad_(True)
        y, lb = fn(leaves, xi)
        keys = sorted(leaves)
        g = torch.autograd.grad((y.float() * cot.float()).sum() + lb,
                                [xi] + [leaves[k] for k in keys])
        return y, lb, dict(zip(["x"] + keys, g))

    with activate(nccl_pod_mesh, rules_for(cfg, True)[1]) as ctx:
        group = ctx.mesh.group(ctx.batch_axes())
        t = x.clone().requires_grad_(True)
        y = C.gather_dim(t, group, 0)
        (g,) = torch.autograd.grad(y, t, cot)
        assert y.is_cuda and torch.equal(y, x) and torch.equal(g, cot)
        got = grads(lambda q, xi: moe._moe_one_hot_ranks(
            q, cfg, xi, ctx, ctx.batch_axes()))
    want = grads(lambda q, xi: moe.moe_block(q, cfg, xi))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for k, g in want[2].items():
        assert got[2][k].is_cuda and torch.equal(got[2][k], g), k
