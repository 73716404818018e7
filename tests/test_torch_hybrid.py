"""The port's SSD-scan plain version, Mamba2 blocks and the zamba2 hybrid
(forward, prefill, decode, generate) against the JAX package, on the CPU.

Same inputs (numpy, seeded; bf16 bits shared exactly) and the same
parameters (drawn once by the JAX package, carried across bit for bit by
``repro_torch.weights``) go through each JAX function and its port.  The
JAX ``ssm_scan`` runs as its own tests run it (interpret mode, its
default).  On CPU tensors the port's ``ssm_scan`` and ``flash_attention``
wrappers take their plain versions, so ``plain=False`` checks the kernel
path's model code.  Tolerances: the SSD scan, those of
``tests/test_kernels_decode_ssm.py`` (f32 2e-4, bf16 2e-2); single
blocks at f32 1e-4; whole hybrid models at f32 2e-4, the SSD scan's own f32
tolerance, since the chunked scan's exp/cumsum rounding compounds over the
layers (a handful of logits differ by up to 1.4e-4 at 1e-4); identical
greedy tokens; decode against forward atol 0.08 /
rtol 0.05, the tolerance of the JAX package's
``test_decode_matches_forward_hybrid``.
"""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.kernels import ssm_scan as jax_ssm_scan  # noqa: E402
from repro.kernels import ssm_scan_ref  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import init_params as jax_init_params  # noqa: E402
from repro.serve.step import make_prefill_step as jax_prefill_step  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels import ssm_scan, ssm_scan_plain  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve.step import make_prefill_step  # noqa: E402
from repro_torch.weights import tensor_from_numpy, to_numpy, to_torch  # noqa: E402

F32 = dict(atol=1e-4, rtol=1e-4)
F32_MODEL = dict(atol=2e-4, rtol=2e-4)
DEC_VS_FWD = dict(atol=0.08, rtol=0.05)


def _pair(a: np.ndarray, dtype):
    """The same values as a JAX array and a torch tensor (identical bits)."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, tensor_from_numpy(np.asarray(j))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **tol)


# ------------------------------------------------------------ SSD scan

def _ssm_case(seed, B=2, S=256, H=8, P=32, N=16, dtype="bfloat16"):
    """The JAX sweep's distributions (``_ssm_case``)."""
    rng = np.random.default_rng(seed)
    x = _pair(rng.standard_normal((B, S, H, P)) * 0.5, dtype)
    dt = _pair(np.abs(rng.standard_normal((B, S, H))) * 0.1, "float32")
    A = _pair(-np.abs(rng.standard_normal(H)) - 0.1, "float32")
    Bm = _pair(rng.standard_normal((B, S, N)) * 0.3, dtype)
    Cm = _pair(rng.standard_normal((B, S, N)) * 0.3, dtype)
    return tuple(a for a, _ in (x, dt, A, Bm, Cm)), \
        tuple(t for _, t in (x, dt, A, Bm, Cm))


#: (case kwargs, chunk, head_block, tol) — tests/test_kernels_decode_ssm.py
SSM_CASES = {
    **{f"chunk{c}": (dict(), c, 4, 2e-2) for c in (32, 64, 128)},
    "f32": (dict(dtype="float32"), 64, 8, 2e-4),
    "bf16": (dict(dtype="bfloat16"), 64, 8, 2e-2),
    **{f"H{h}P{p}": (dict(H=h, P=p), 64, min(4, h), 2e-2)
       for h, p in ((4, 16), (8, 64), (16, 32))},
    "ragged200": (dict(S=200), 64, 8, 2e-2),
    "continuity512": (dict(S=512), 128, 8, 2e-2),
}


@pytest.mark.parametrize("name", list(SSM_CASES))
def test_ssm_scan_matches_jax_kernel_and_oracle(name):
    kw, chunk, hb, tol = SSM_CASES[name]
    (xj, dtj, Aj, Bj, Cj), args = _ssm_case(len(name), **kw)
    kern = jax_ssm_scan(xj, dtj, Aj, Bj, Cj, chunk=chunk, head_block=hb)
    ref = ssm_scan_ref(xj, dtj, jnp.broadcast_to(Aj, (xj.shape[0],
                                                      Aj.shape[0])), Bj, Cj)
    for fn in (ssm_scan_plain, ssm_scan):
        y = fn(*args, chunk=chunk)
        assert y.dtype == args[0].dtype and y.shape == args[0].shape
        _close(y, kern, atol=tol, rtol=tol)
        _close(y, ref, atol=tol, rtol=tol)


def test_ssm_scan_f32_output_and_model_ssd():
    """``out_dtype=f32`` (what ``mamba2_forward`` asks for) against the
    model's own chunked SSD, and the final state against the reference's."""
    (xj, dtj, Aj, Bj, Cj), args = _ssm_case(3, S=256)
    y_model, h_model = JS._ssd_chunked(xj, dtj, Aj, Bj, Cj, chunk=64)
    y = ssm_scan(*args, chunk=64, out_dtype=torch.float32)
    assert y.dtype == torch.float32
    _close(y, y_model, atol=2e-4, rtol=2e-4)
    y2, h2 = TS._ssd_chunked(*args, chunk=64)
    _close(y2, y_model, atol=2e-4, rtol=2e-4)
    _close(h2, h_model, atol=2e-4, rtol=2e-4)


# ------------------------------------------------------------ hybrid model

@functools.cache
def _zamba2(dtype="float32"):
    jcfg = jax_reduced("zamba2-7b").replace(dtype=dtype)
    tcfg = reduced_config("zamba2-7b").replace(dtype=dtype)
    jp = jax_init_params(jax.random.PRNGKey(0), JT.model_specs(jcfg),
                         jcfg.jdtype)
    return jcfg, tcfg, jp, to_torch(jax.device_get(jp), "cpu")


def test_config_matches_reference_field_for_field():
    for jc, tc in ((jax_get_config("zamba2-7b"), get_config("zamba2-7b")),
                   (jax_reduced("zamba2-7b"), reduced_config("zamba2-7b"))):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    full = get_config("zamba2-7b")
    assert TT.num_params(full) == JT.num_params(jax_get_config("zamba2-7b"))
    assert TT.num_params(full) == 6_584_430_160
    assert TT.program_for(full) == (("mamba",) * 6 + ("shared_attn",), 13,
                                    ("mamba",) * 3)
    assert TS._mamba_dims(full) == (7168, 112, 64) and full.hd == 112


def test_param_and_cache_trees_match_reference():
    jcfg, tcfg, jp, tp = _zamba2()

    def shapes(tree):
        return {"/".join(str(k.key) for k in path): (tuple(v.shape),
                                                     str(v.dtype))
                for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    sd = TT.Decoder(tcfg, tp, device="cpu").state_dict()
    tflat = {k.removeprefix("params.").replace(".", "/"): tuple(v.shape)
             for k, v in sd.items()}
    assert tflat == {k: s for k, (s, _) in shapes(jp).items()}
    assert "shared_attn/attn/wq" in tflat
    jcache = shapes(JT.init_cache(jcfg, 2, 8))
    tcache = TT.init_cache(tcfg, 2, 8, "cpu")
    assert shapes(jax.tree.map(np.asarray, to_numpy(tcache))) == jcache
    assert tcache["blocks"]["b0_mamba"]["h"].dtype == torch.float32
    assert tcache["shared"]["attn"]["k"].shape[0] == 2      # per group


def test_weights_roundtrip_carries_the_hybrid_tree():
    """to_numpy(to_torch(tree)) is bit-exact for bf16 params and a mixed
    f32 / bf16 cache."""
    jcfg, _, _, _ = _zamba2()
    cfg = jcfg.replace(dtype="bfloat16")
    jp = jax.device_get(jax_init_params(jax.random.PRNGKey(1),
                                        JT.model_specs(cfg), cfg.jdtype))
    back = to_numpy(to_torch(jp, "cpu"))
    for (path, a) in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = back
        for k in path:
            node = node[k.key]
        assert node.dtype == a.dtype and np.array_equal(
            node.view(np.uint16), np.asarray(a).view(np.uint16))
    jc = jax.device_get(JT.init_cache(cfg, 1, 4))
    tc = to_torch(jc, "cpu")
    assert tc["blocks"]["b0_mamba"]["h"].dtype == torch.float32
    assert tc["blocks"]["b0_mamba"]["conv"].dtype == torch.bfloat16


def _block_params(jp, tp, key="b0_mamba"):
    pj = jax.tree.map(lambda a: a[0], jp["blocks"][key]["mamba"])
    pt = {k: t[0] for k, t in tp["blocks"][key]["mamba"].items()}
    return pj, pt


@pytest.mark.parametrize("plain", [True, False], ids=["plain", "kernel-path"])
def test_mamba2_forward_matches_jax(plain):
    jcfg, tcfg, jp, tp = _zamba2()
    pj, pt = _block_params(jp, tp)
    xj, xt = _pair(np.random.default_rng(5).standard_normal(
        (2, 64, tcfg.d_model)), "float32")
    yj = JS.mamba2_forward(pj, jcfg, xj, chunk=32)
    _close(TS.mamba2_forward(pt, tcfg, xt, chunk=32, plain=plain), yj, **F32)


def test_mamba2_decode_matches_jax():
    jcfg, tcfg, jp, tp = _zamba2()
    pj, pt = _block_params(jp, tp)
    rng = np.random.default_rng(6)
    sj = JS.mamba2_init_state(jcfg, 2, jnp.float32)
    st = TS.mamba2_init_state(tcfg, 2, torch.float32, "cpu")
    for _ in range(5):
        xj, xt = _pair(rng.standard_normal((2, 1, tcfg.d_model)), "float32")
        yj, sj = JS.mamba2_decode(pj, jcfg, xj, sj)
        yt, st2 = TS.mamba2_decode(pt, tcfg, xt, st)
        assert st2.h is st.h and st2.conv is st.conv      # in place
        _close(yt, yj, **F32)
        _close(st.h, sj.h, **F32)
        _close(st.conv, sj.conv, **F32)


@pytest.mark.parametrize("plain", [True, False], ids=["plain", "kernel-path"])
def test_zamba2_forward_and_prefill_match_jax(plain):
    jcfg, tcfg, jp, tp = _zamba2()
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size, (2, 32))
    batch_j = {"tokens": jnp.asarray(toks, jnp.int32)}
    batch_t = {"tokens": torch.from_numpy(toks)}
    lj, _ = JT.forward(jp, jcfg, batch_j)
    lt, aux = TT.forward(tp, tcfg, batch_t, plain=plain)
    assert lt.shape == (2, 32, tcfg.vocab_size) and float(aux) == 0.0
    _close(lt, lj, **F32_MODEL)
    pj = jax_prefill_step(jcfg)(jp, batch_j)
    pt = make_prefill_step(tcfg, plain=plain)(tp, batch_t)
    assert pt.dtype == torch.float32
    _close(pt, pj, **F32_MODEL)


def test_zamba2_decode_steps_match_jax():
    jcfg, tcfg, jp, tp = _zamba2()
    B, S = 2, 8
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size, (B, S))
    jcache = JT.init_cache(jcfg, B, S)
    tcache = TT.init_cache(tcfg, B, S, "cpu")
    step = jax.jit(lambda p, c, t, s: JT.decode_step(p, jcfg, c, t, s))
    for t in range(S):
        lj, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1],
                                                   jnp.int32), jnp.int32(t))
        lt, tcache = TT.decode_step(
            tp, tcfg, tcache, torch.from_numpy(toks[:, t:t + 1]),
            torch.tensor(t, dtype=torch.int32))
        _close(lt, lj, **F32_MODEL)
    for leaf in ("h", "conv"):
        _close(tcache["blocks"]["b1_mamba"][leaf],
               jcache["blocks"]["b1_mamba"][leaf], **F32_MODEL)
    _close(tcache["shared"]["attn"]["k"], jcache["shared"]["attn"]["k"],
           **F32_MODEL)
    _close(tcache["tail"]["t0_mamba"]["h"], jcache["tail"]["t0_mamba"]["h"],
           **F32_MODEL)


def test_zamba2_decode_matches_forward():
    """The JAX package's ``test_decode_matches_forward_hybrid``, on the
    port (bf16, the reduced config's dtype)."""
    _, tcfg, _, _ = _zamba2()
    cfg = tcfg.replace(dtype="bfloat16")
    params = TT.Decoder(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0)).tree()
    toks = torch.randint(0, cfg.vocab_size, (1, 8),
                         generator=torch.Generator().manual_seed(1))
    full, _ = TT.forward(params, cfg, {"tokens": toks})
    cache = TT.init_cache(cfg, 1, 8, "cpu")
    outs = []
    for t in range(8):
        lg, cache = TT.decode_step(params, cfg, cache, toks[:, t:t + 1],
                                   torch.tensor(t, dtype=torch.int32))
        outs.append(lg)
    torch.testing.assert_close(torch.stack(outs, 1).float(), full.float(),
                               **DEC_VS_FWD)


def test_generate_greedy_tokens_identical_at_f32():
    jcfg, tcfg, jp, tp = _zamba2()
    prompt = np.random.default_rng(9).integers(0, tcfg.vocab_size, (2, 8))
    tj = jax_generate(jcfg, jp, jnp.asarray(prompt, jnp.int32), 8)
    tt = generate(tcfg, TT.Decoder(tcfg, tp, device="cpu"),
                  torch.from_numpy(prompt), 8, device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


def test_serve_main_runs_zamba2_on_the_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "zamba2-7b", "--reduced", "--device", "cpu", "--batch",
          "2", "--prompt-len", "4", "--gen", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 7)" in out
