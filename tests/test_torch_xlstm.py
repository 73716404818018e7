"""xlstm-125m (alternating mLSTM / sLSTM blocks) against the JAX package,
on the CPU.

Configs field for field, parameter and cache trees key for key and shape
for shape (also at full size, on specs alone), the reference's parameter
counts.  At ``reduced_config`` (4 layers = 2 x (mLSTM, sLSTM), d 64), with
the mLSTM's ``b_if`` and the sLSTM's ``b`` set nonzero in both packages
(``torch_parity.set_nonzero``): each cell alone, ``forward`` / prefill on
both paths, ``decode_step`` position by position with every recurrent
state, greedy ``generate``, and the port's own decode run token by token
against its forward (the reference's ``test_decode_matches_forward_ssm``).
f32 atol = rtol = 1e-4 and identical greedy tokens; bf16 atol 0.08 / rtol
0.05.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.serve.step import make_prefill_step  # noqa: E402
from torch_parity import (TOL, cache_leaf, check_config, check_specs,  # noqa: E402
                          check_weights, close, pair, setup)

ARCH = "xlstm-125m"


def test_config_matches_reference_field_for_field():
    check_config(ARCH)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_program_and_specs_match_reference(reduced):
    check_specs(ARCH, reduced)


def test_full_program_and_long_cache_has_no_sequence_axis():
    """6 x (mLSTM, sLSTM) at d 768; the cache of a 524,288-token context
    (the reference's ``long_500k``) holds only the recurrent states."""
    cfg = get_config(ARCH)
    assert TT.program_for(cfg) == (("mlstm", "slstm"), 6, ())
    assert TT.num_params(cfg) == 123_679_536
    shapes = [tuple(s.shape) for _, s in tree_leaves(
        TT.cache_specs(cfg, 1, 524_288))]
    assert shapes and all(524_288 not in sh for sh in shapes)


def test_weights_carried_across_by_to_torch():
    check_weights(ARCH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_cell_forward_and_decode_match_jax(cell, dtype):
    """One block's cell over S 12, then three decode steps from its
    state."""
    jcfg, tcfg, jp, tp = setup(ARCH, dtype)
    key = "b0_mlstm" if cell == "mlstm" else "b1_slstm"
    pj = jax.tree.map(lambda a: a[0], jp["blocks"][key][cell])
    pt = {k: t[0] for k, t in tp["blocks"][key][cell].items()}
    rng = np.random.default_rng(2)
    xj, xt = pair(rng.standard_normal((2, 12, tcfg.d_model)), dtype)
    fwd_j = getattr(JS, f"{cell}_forward")
    fwd_t = getattr(TS, f"{cell}_forward")
    tol = TOL[dtype]
    close(fwd_t(pt, tcfg, xt), fwd_j(pj, jcfg, xj), tol)
    sj = getattr(JS, f"{cell}_init_state")(jcfg, 2)
    st = getattr(TS, f"{cell}_init_state")(tcfg, 2, "cpu")
    for t in range(3):
        yj, sj = getattr(JS, f"{cell}_decode")(pj, jcfg, xj[:, t:t + 1], sj)
        yt, st2 = getattr(TS, f"{cell}_decode")(pt, tcfg, xt[:, t:t + 1], st)
        assert st2 is st                        # written in place
        close(yt, yj, tol)
        for a, b in zip(st, sj):
            close(a, b, TOL["float32"] if dtype == "float32" else tol)


def test_nonzero_biases_move_the_output():
    """The gate biases the tests set nonzero take part: the logits move."""
    _, tcfg, _, tp = setup(ARCH, "float32")
    _, _, _, tp0 = setup(ARCH, "float32", nonzero=False)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 16)))
    l1, _ = TT.forward(tp, tcfg, {"tokens": toks})
    l0, _ = TT.forward(tp0, tcfg, {"tokens": toks})
    assert (l1 - l0).abs().max().item() > 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_prefill_match_jax(dtype):
    jcfg, tcfg, jp, tp = setup(ARCH, dtype)
    toks = np.random.default_rng(11).integers(0, tcfg.vocab_size, (2, 48))
    lj, auxj = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)})
    tol = TOL[dtype]
    for plain in (True, False):
        lt, aux = TT.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                             plain=plain)
        assert lt.shape == (2, 48, tcfg.vocab_size)
        assert lt.dtype == tcfg.torch_dtype
        assert float(aux) == float(auxj) == 0.0
        close(lt, lj, tol)
        pt = make_prefill_step(tcfg, plain=plain)(
            tp, {"tokens": torch.from_numpy(toks)})
        close(pt, lj[:, -1], tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax(dtype):
    """16 steps; every recurrent state (C, n, m; c, n, h, m) after them."""
    jcfg, tcfg, jp, tp = setup(ARCH, dtype)
    B, S = 2, 16
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (B, S))
    jcache = JT.init_cache(jcfg, B, S)
    tcache = TT.init_cache(tcfg, B, S, "cpu")
    step = jax.jit(lambda p, c, t, s: JT.decode_step(p, jcfg, c, t, s))
    tol = TOL[dtype]
    for t in range(S):
        lj, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1],
                                                   jnp.int32), jnp.int32(t))
        lt, tcache = TT.decode_step(
            tp, tcfg, tcache, torch.from_numpy(toks[:, t:t + 1]),
            torch.tensor(t, dtype=torch.int32))
        close(lt, lj, tol)
    leaves = tree_leaves(tcache)
    assert {k.split("/")[-1] for k, _ in leaves} == {"C", "n", "m", "c", "h"}
    for k, leaf in leaves:
        assert leaf.dtype == torch.float32, k
        close(leaf, cache_leaf(jcache, k), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_token_by_token_equals_forward(dtype):
    """The reference's own check (``test_decode_matches_forward_ssm``), on
    the port: f32 at 1e-4, bf16 at its 0.08 / 0.05."""
    _, tcfg, _, tp = setup(ARCH, dtype)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (1, 8)))
    full, _ = TT.forward(tp, tcfg, {"tokens": toks})
    cache = TT.init_cache(tcfg, 1, 8, "cpu")
    outs = [TT.decode_step(tp, tcfg, cache, toks[:, t:t + 1],
                           torch.tensor(t, dtype=torch.int32))[0]
            for t in range(8)]
    close(torch.stack(outs, dim=1), full.float().numpy(), TOL[dtype])


def test_generate_greedy_tokens_identical_at_f32():
    jcfg, tcfg, jp, tp = setup(ARCH, "float32")
    prompt = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 12))
    tj = jax_generate(jcfg, jp, jnp.asarray(prompt, jnp.int32), 12)
    tt = generate(tcfg, TT.Decoder(tcfg, tp, device="cpu"),
                  torch.from_numpy(prompt), 12, device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
