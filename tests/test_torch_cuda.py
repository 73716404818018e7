"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks the ``card`` fixture for the device, which
skips where there is none (this decision is made inside the fixture, never
at import time, so every pytest worker collects the same tests).  Run on a
machine with an H100 and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from repro_torch.kernels import (decode_attention, decode_attention_plain,
                                 rmsnorm, rmsnorm_plain)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


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
                                   (4, 2048), (5, 130)])
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
@pytest.mark.parametrize("case", [
    # (B, KV, G, hd, S, pos, window)
    (2, 2, 4, 64, 512, 300, None), (2, 2, 4, 112, 512, 300, None),
    (4, 8, 2, 128, 48, 47, None), (2, 2, 1, 64, 512, 0, None),
    (2, 2, 8, 64, 700, 600, None), (2, 2, 4, 128, 1024, 900, 32),
    (2, 2, 4, 64, 1024, 900, 1 << 20), (1, 1, 16, 128, 300, 299, 256),
], ids=str)
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
