"""Gradients through the kernel wrappers, on the CPU.

On the card ``rmsnorm``, ``flash_attention`` and ``ssm_scan`` launch
inside an ``autograd.Function`` when grad is enabled and an input requires
it; each Function's backward is the plain version's VJP.  Here the launch
(``ops._launch``) is replaced by the plain forward, so the Function runs
end to end on the CPU and its gradients must equal autograd's through the
plain version itself.  Tolerances: f32 atol = rtol = 1e-5 (the flash
recompute sums dk and dv block by block, in another order); bf16 atol =
rtol = 1e-2, about one bf16 ulp (an f32 sum in another order may round to
the neighbouring bf16 value).

The wrappers' dispatch is checked on ``meta`` tensors, which take the
CUDA branch (any device but the CPU) without a card: the Function only
under grad, the bare launch otherwise, ``decode_attention`` raising under
grad, and no wrapper giving way to the plain forward when its launch
fails.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.rmsnorm import ops as rops
from repro_torch.kernels.ssm_scan import ops as sops

TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


def _randn(rng, shape, dtype, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)


def _grads(fn, inputs, cot):
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*ins)
    return out.detach(), torch.autograd.grad(out, ins, cot)


def _close(got, want, dtype):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), **TOL[dtype])


FLASH_CASES = [  # B, Sq, Sk, H, KV, hd, causal, window
    (2, 24, 24, 4, 2, 16, True, None),
    (1, 40, 40, 4, 1, 8, True, 7),
    (2, 12, 20, 4, 4, 16, False, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_function_gradients_equal_the_plain_path(monkeypatch, case,
                                                       dtype):
    B, Sq, Sk, H, KV, hd, causal, window = case
    monkeypatch.setattr(fops, "_launch", lambda q, k, v, c, w, s, p:
                        fops.flash_attention_plain(q, k, v, causal=c,
                                                   window=w, scale=s,
                                                   probs=p))
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, Sq, H, hd), dtype)
    k = _randn(rng, (B, Sk, KV, hd), dtype)
    v = _randn(rng, (B, Sk, KV, hd), dtype)
    cot = _randn(rng, (B, Sq, H, hd), dtype)
    out, got = _grads(lambda *t: fops.FlashAttentionFn.apply(
        *t, causal, window, None), (q, k, v), cot)
    ref, want = _grads(lambda *t: fops.flash_attention_plain(
        *t, causal=causal, window=window), (q, k, v), cot)
    assert torch.equal(out, ref)
    _close(got, want, dtype)


@pytest.mark.parametrize("q_block", [1, 5, 16])
def test_flash_vjp_in_query_blocks_equals_one_block(q_block):
    """The recompute's query blocks change nothing but the order of the
    f32 sums of dk and dv (f32 atol = rtol = 1e-5)."""
    rng = np.random.default_rng(1)
    q = _randn(rng, (2, 16, 4, 8), torch.float32)
    k = _randn(rng, (2, 16, 2, 8), torch.float32)
    v = _randn(rng, (2, 16, 2, 8), torch.float32)
    cot = _randn(rng, (2, 16, 4, 8), torch.float32)
    got = fops.flash_attention_vjp(q, k, v, cot, window=6, q_block=q_block)
    want = fops.flash_attention_vjp(q, k, v, cot, window=6, q_block=16)
    _close(got, want, torch.float32)


def test_flash_plain_masks_rows_with_no_key_to_zero():
    """Queries 3..5 against 3 keys with a window of 1 see no key: they give
    0 and pass no gradient, not NaN."""
    rng = np.random.default_rng(2)
    q = _randn(rng, (1, 6, 2, 8), torch.float32).requires_grad_(True)
    k = _randn(rng, (1, 3, 2, 8), torch.float32).requires_grad_(True)
    v = _randn(rng, (1, 3, 2, 8), torch.float32)
    out = fops.flash_attention_plain(q, k, v, causal=True, window=1)
    assert torch.equal(out[:, 3:], torch.zeros_like(out[:, 3:]))
    assert torch.equal(out[:, :3], v)
    gq, gk = torch.autograd.grad(out.square().sum(), (q, k))
    assert torch.equal(gq, torch.zeros_like(gq))    # one key: p = 1 fixed
    assert bool(torch.isfinite(gk).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_res", [False, True])
def test_rmsnorm_function_gradients_equal_the_plain_path(monkeypatch, dtype,
                                                         with_res):
    monkeypatch.setattr(rops, "_launch", lambda x, s, r, eps:
                        rops.rmsnorm_plain(x, s, r, eps=eps))
    rng = np.random.default_rng(3)
    x = _randn(rng, (3, 5, 64), dtype)
    scale = _randn(rng, (64,), dtype, 0.3) + 1.0
    cot = _randn(rng, (3, 5, 64), dtype)
    ins = (x, scale) + ((_randn(rng, (3, 5, 64), dtype),) if with_res
                        else ())

    def fn(x, scale, res=None):
        return rops.RMSNormFn.apply(x, scale, res, 1e-6)

    def plain(x, scale, res=None):
        return rops.rmsnorm_plain(x, scale, res, eps=1e-6)

    out, got = _grads(fn, ins, cot)
    ref, want = _grads(plain, ins, cot)
    assert torch.equal(out, ref)
    _close(got, want, dtype)
    if with_res:
        assert got[2].abs().sum() > 0      # the residual gets its gradient


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [64, 100])
def test_ssm_scan_function_gradients_equal_the_plain_path(monkeypatch,
                                                          x_dtype, S):
    monkeypatch.setattr(sops, "_launch", lambda *a: sops.ssm_scan_plain(
        *a[:5], chunk=a[5], out_dtype=a[6]))
    rng = np.random.default_rng(4)
    B, H, P, N = 2, 3, 16, 16
    x = _randn(rng, (B, S, H, P), x_dtype)
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (B, S, H))
                          .astype(np.float32))
    A = -torch.from_numpy(rng.uniform(0.5, 2.0, (H,)).astype(np.float32))
    Bm = _randn(rng, (B, S, N), x_dtype, 0.5)
    Cm = _randn(rng, (B, S, N), x_dtype, 0.5)
    cot = _randn(rng, (B, S, H, P), torch.float32)
    ins = (x, dt, A, Bm, Cm)
    out, got = _grads(lambda *t: sops.SSMScanFn.apply(
        *t, 32, torch.float32), ins, cot)
    ref, want = _grads(lambda *t: sops.ssm_scan_plain(
        *t, chunk=32, out_dtype=torch.float32), ins, cot)
    assert torch.equal(out, ref)
    _close(got, want, torch.float32)


# ----------------------------------------------------------- dispatch

def _meta(*shapes, grad=False):
    return [torch.zeros(s, device="meta", requires_grad=grad)
            for s in shapes]


def _counting(monkeypatch, ops, plain):
    calls = []

    def launch(*a):
        calls.append(a)
        return plain(*a)

    monkeypatch.setattr(ops, "_launch", launch)
    return calls


WRAPPERS = {
    "flash_attention": (fops, lambda q, k, v, c, w, s, p: torch.empty_like(q),
                        ((1, 8, 2, 16), (1, 8, 2, 16), (1, 8, 2, 16)),
                        lambda q, k, v: fops.flash_attention(q, k, v),
                        "FlashAttentionFn"),
    "rmsnorm": (rops, lambda x, s, r, eps: torch.empty_like(x),
                ((4, 32), (32,)), lambda x, s: rops.rmsnorm(x, s),
                "RMSNormFn"),
    "ssm_scan": (sops, lambda x, *a: torch.empty(x.shape, device=x.device),
                 ((1, 32, 2, 16), (1, 32, 2), (2,), (1, 32, 16),
                  (1, 32, 16)),
                 lambda *t: sops.ssm_scan(*t, chunk=32,
                                          out_dtype=torch.float32),
                 "SSMScanFn"),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_takes_the_function_only_under_grad(monkeypatch, name):
    ops, fake, shapes, call, fn_name = WRAPPERS[name]
    calls = _counting(monkeypatch, ops, fake)
    out = call(*_meta(*shapes, grad=True))
    assert type(out.grad_fn).__name__ == f"{fn_name}Backward"
    with torch.no_grad():
        assert call(*_meta(*shapes, grad=True)).grad_fn is None
    assert call(*_meta(*shapes)).grad_fn is None
    assert len(calls) == 3


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_never_gives_way_to_the_plain_forward(monkeypatch, name,
                                                      grad):
    ops, _, shapes, call, _ = WRAPPERS[name]

    def broken(*a):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(ops, "_launch", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        call(*_meta(*shapes, grad=grad))


def test_decode_attention_raises_under_grad_on_the_cuda_branch():
    q, k, v = _meta((2, 1, 4, 16), (2, 8, 2, 16), (2, 8, 2, 16), grad=True)
    pos = torch.zeros((), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="forward-only"):
        decode_attention(q, k, v, pos)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        decode_attention(q, k, v, pos)        # past the guard: no card


def test_ssd_chunked_gradient_is_finite_past_exp_overflow():
    """A chunk whose decay passes ~88 nats overflows exp above the
    diagonal; the chunked SSD masks the exponent first, so its dt
    gradient stays finite (the reference's is NaN there)."""
    rng = np.random.default_rng(6)
    B, S, H, P, N = 1, 128, 2, 4, 4
    x = _randn(rng, (B, S, H, P), torch.float32)
    dt = torch.full((B, S, H), 0.8, requires_grad=True)
    A = -torch.ones(H)
    Bm = _randn(rng, (B, S, N), torch.float32)
    Cm = _randn(rng, (B, S, N), torch.float32)
    y, _ = sops.ssd_chunked(x.requires_grad_(True), dt, A, Bm, Cm, 128)
    gx, gdt = torch.autograd.grad(y.sum(), (x, dt))
    assert bool(torch.isfinite(gx).all()) and bool(torch.isfinite(gdt).all())
