"""The encoder-decoder (whisper-large-v3: LayerNorm, GELU, no RoPE, a
bidirectional encoder) and the cross-attention VLM (llama-3.2-vision-11b:
one ``tanh(gate)``-scaled cross-attention layer in five) against the JAX
package, on the CPU.

Configs field for field, parameter and cache trees (with the ``memory``
leaf) key for key and shape for shape (also at full size, on specs
alone), the reference's parameter counts.  LayerNorm and cross-attention
alone, on both paths (the one-query cross-attention of a decode step
included).  At ``reduced_config``, with the gates at 0.5 and the LayerNorm
biases nonzero in both packages (``torch_parity.set_nonzero``), and
checked to move the logits: ``forward`` with frames / patches, prefill,
``decode_step`` over several positions against a nonzero memory (which
must move the logits too), and greedy ``generate`` with the reference's
stub memory.  f32 atol = rtol = 1e-4 and identical greedy tokens; bf16
atol 0.08 / rtol 0.05.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.serve.step import make_prefill_step  # noqa: E402
from torch_parity import (TOL, cache_leaf, check_config, check_specs,  # noqa: E402
                          check_weights, close, pair, setup)

ARCHS = ["whisper-large-v3", "llama-3.2-vision-11b"]
#: the JAX package's parameter counts of the full configs
N_PARAMS = {"whisper-large-v3": 1_536_448_000,
            "llama-3.2-vision-11b": 9_780_400_136}
#: frames / patches of the reduced tests
MEM = 10


def _stream(cfg, B, seed=8):
    """``(key, array)`` of the stub frames or patches ``[B, MEM, F]``."""
    key = "frames" if cfg.family == "encdec" else "patches"
    return key, np.random.default_rng(seed).standard_normal(
        (B, MEM, cfg.frontend_dim)).astype(np.float32)


def _batches(cfg, toks, seed=8):
    key, a = _stream(cfg, toks.shape[0], seed)
    return ({"tokens": jnp.asarray(toks, jnp.int32), key: jnp.asarray(a)},
            {"tokens": torch.from_numpy(toks), key: torch.from_numpy(a)})


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference_field_for_field(arch):
    check_config(arch)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_program_and_specs_match_reference(arch, reduced):
    check_specs(arch, reduced, mem_len=7)
    if not reduced:
        assert TT.num_params(get_config(arch)) == N_PARAMS[arch]


def test_programs():
    assert TT.program_for(get_config("whisper-large-v3")) == \
        (("dec_attn",), 32, ())
    assert TT.program_for(get_config("llama-3.2-vision-11b")) == \
        (("attn",) * 4 + ("xattn",), 8, ())


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_carried_across_by_to_torch(arch):
    check_weights(arch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    jcfg, tcfg, jp, tp = setup("whisper-large-v3", dtype)
    pj = jax.tree.map(lambda a: a[0], jp["blocks"]["b0_dec_attn"]["ln_x"])
    pt = {k: t[0] for k, t in tp["blocks"]["b0_dec_attn"]["ln_x"].items()}
    assert float(pt["bias"].abs().max()) > 0
    xj, xt = pair(np.random.default_rng(3).standard_normal(
        (2, 5, tcfg.d_model)) * 2 + 1, dtype)
    yj = JL.apply_norm(pj, xj, jcfg.norm_eps, "layernorm")
    for plain in (True, False):
        yt = TL.apply_norm(pt, xt, tcfg.norm_eps, "layernorm", plain=plain)
        assert yt.dtype == xt.dtype
        close(yt, yj, TOL[dtype])


@pytest.mark.parametrize("sq", [1, 6], ids=["one-query", "six-queries"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attention_matches_jax(arch, dtype, sq):
    """Sq 1 (a decode step: the kernel path takes decode_attention) and
    Sq 6 (flash_attention at Sq != Sk), against 10 memory rows."""
    jcfg, tcfg, jp, tp = setup(arch, dtype)
    key = "b0_dec_attn" if tcfg.family == "encdec" else "b4_xattn"
    pj = jax.tree.map(lambda a: a[0], jp["blocks"][key]["xattn"])
    pt = {k: t[0] for k, t in tp["blocks"][key]["xattn"].items()}
    assert not any(k.startswith("b") for k in pt)      # no QKV bias
    rng = np.random.default_rng(9)
    xj, xt = pair(rng.standard_normal((2, sq, tcfg.d_model)), dtype)
    mj, mt = pair(rng.standard_normal((2, MEM, tcfg.d_model)), dtype)
    yj = JL.attention(pj, jcfg, xj, kv_x=mj, causal=False, use_rope=False)
    for plain in (True, False):
        yt = TL.attention(pt, tcfg, xt, kv_x=mt, causal=False,
                          use_rope=False, plain=plain)
        assert yt.shape == (2, sq, tcfg.d_model)
        close(yt, yj, TOL[dtype])


def test_plain_path_keeps_the_reference_query_block():
    """Above ``q_block`` queries the plain path needs a multiple of it (the
    reference asserts it); the kernel path takes any length, and the plain
    path with the whole sequence as one block agrees with it."""
    jcfg, tcfg, jp, tp = setup("whisper-large-v3", "float32")
    pt = {k: t[0] for k, t in
          tp["encoder"]["blocks"]["b0_attn_bidir"]["attn"].items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 12, tcfg.d_model)).astype(np.float32))
    with pytest.raises(ValueError, match="q_block"):
        TL.attention(pt, tcfg, x, causal=False, use_rope=False, q_block=8,
                     plain=True)
    kernel = TL.attention(pt, tcfg, x, causal=False, use_rope=False,
                          q_block=8)
    whole = TL.attention(pt, tcfg, x, causal=False, use_rope=False,
                         q_block=12, plain=True)
    close(kernel, whole.numpy(), TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_gate_bias_and_stream_move_the_logits(arch):
    """A cross-attention that contributes nothing must not pass: the
    nonzero gate / biases and the frames / patches each move the
    logits."""
    _, tcfg, _, tp = setup(arch, "float32")
    _, _, _, tp0 = setup(arch, "float32", nonzero=False)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 8))
    _, b = _batches(tcfg, toks)
    _, b2 = _batches(tcfg, toks, seed=9)
    l1, _ = TT.forward(tp, tcfg, b)
    assert (l1 - TT.forward(tp0, tcfg, b)[0]).abs().max().item() > 1e-2
    assert (l1 - TT.forward(tp, tcfg, b2)[0]).abs().max().item() > 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_jax(arch, dtype):
    jcfg, tcfg, jp, tp = setup(arch, dtype)
    toks = np.random.default_rng(11).integers(0, tcfg.vocab_size, (2, 24))
    bj, bt = _batches(tcfg, toks)
    lj, auxj = JT.forward(jp, jcfg, bj)
    tol = TOL[dtype]
    for plain in (True, False):
        lt, aux = TT.forward(tp, tcfg, bt, plain=plain)
        assert lt.shape == (2, 24, tcfg.vocab_size)
        assert lt.dtype == tcfg.torch_dtype
        assert float(aux) == float(auxj) == 0.0
        close(lt, lj, tol)
        close(make_prefill_step(tcfg, plain=plain)(tp, bt), lj[:, -1], tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax_with_memory(arch, dtype):
    """12 steps against a nonzero memory of 10 rows in both caches; every
    KV cache after them; a zero memory gives other logits."""
    jcfg, tcfg, jp, tp = setup(arch, dtype)
    B, S = 2, 12
    rng = np.random.default_rng(4)
    toks = rng.integers(0, tcfg.vocab_size, (B, S))
    mj, mt = pair(rng.standard_normal((B, MEM, tcfg.d_model)), dtype)
    jcache = JT.init_cache(jcfg, B, S, MEM)
    jcache["memory"] = mj
    tcache = TT.init_cache(tcfg, B, S, "cpu", mem_len=MEM)
    tcache["memory"].copy_(mt)
    zcache = TT.init_cache(tcfg, B, S, "cpu", mem_len=MEM)
    step = jax.jit(lambda p, c, t, s: JT.decode_step(p, jcfg, c, t, s))
    tol = TOL[dtype]
    for t in range(S):
        tok = torch.from_numpy(toks[:, t:t + 1])
        pos = torch.tensor(t, dtype=torch.int32)
        lj, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1],
                                                   jnp.int32), jnp.int32(t))
        lt, tcache = TT.decode_step(tp, tcfg, tcache, tok, pos)
        close(lt, lj, tol)
        lz, _ = TT.decode_step(tp, tcfg, zcache, tok, pos)
        assert (lz - lt).float().abs().max().item() > 1e-2
    for k, leaf in tree_leaves(tcache):
        close(leaf, cache_leaf(jcache, k), tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_tokens_identical_at_f32(arch):
    """The reference's stub memory (8 zero rows) on both sides."""
    jcfg, tcfg, jp, tp = setup(arch, "float32")
    prompt = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 10))
    tj = jax_generate(jcfg, jp, jnp.asarray(prompt, jnp.int32), 10)
    tt = generate(tcfg, TT.Decoder(tcfg, tp, device="cpu"),
                  torch.from_numpy(prompt), 10, device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


def test_generate_reads_the_memory_it_is_given():
    """``generate(memory=...)`` decodes against it: other tokens than the
    stub's, and the eager decode steps' own greedy tokens."""
    _, tcfg, _, tp = setup("llama-3.2-vision-11b", "float32")
    prompt = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, 6)))
    mem = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, MEM, tcfg.d_model)).astype(np.float32)) * 4
    model = TT.Decoder(tcfg, tp, device="cpu")
    toks = generate(tcfg, model, prompt, 8, device="cpu", memory=mem)
    stub = generate(tcfg, model, prompt, 8, device="cpu")
    assert not torch.equal(toks, stub)
    cache = TT.init_cache(tcfg, 2, 14, "cpu", mem_len=MEM)
    cache["memory"].copy_(mem)
    for t in range(13):
        lt, _ = TT.decode_step(tp, tcfg, cache, toks[:, t:t + 1],
                               torch.tensor(t, dtype=torch.int32))
        if t >= 5:
            assert torch.equal(lt.argmax(-1), toks[:, t + 1])
