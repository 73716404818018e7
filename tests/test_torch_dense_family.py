"""The rest of the dense family against the JAX package, on the CPU:
gemma3-1b (the 5:1 local/global program, sliding window 512 on its local
layers, hd 256, KV 1, ``embed_scale``, tanh-GELU, tied embeddings),
qwen2.5-14b (QKV bias, GQA 40/8) and nemotron-4-15b (squared-ReLU MLP,
untied embeddings).

Configs field for field; parameter trees key for key and shape for shape
(also at full size, on specs alone, with no allocation) and the
reference's parameter counts.  At ``reduced_config`` the same parameters
(drawn by the JAX package, carried across by ``repro_torch.weights``) and
the same numpy tokens go through the JAX model and the port, whose kernel
wrappers take their plain versions on the CPU: ``forward`` / prefill at S
64 (past gemma3-reduced's window of 16), ``decode_step`` through positions
past the window, and greedy ``generate``.  Tolerances are
``tests/test_torch_model.py``'s: f32 atol/rtol 1e-4 and identical greedy
tokens; bf16 atol 0.08 / rtol 0.05.
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
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import ParamSpec as JaxSpec  # noqa: E402
from repro.models.common import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.serve.step import make_prefill_step  # noqa: E402
from repro_torch.weights import to_torch  # noqa: E402

ARCHS = ["gemma3-1b", "qwen2.5-14b", "nemotron-4-15b"]
#: the JAX package's parameter counts of the full configs
N_PARAMS = {"gemma3-1b": 792_797_824, "qwen2.5-14b": 14_770_033_664,
            "nemotron-4-15b": 15_628_376_064}
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=0.08, rtol=0.05)}


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **tol)


@functools.cache
def _setup(arch, dtype):
    """Both reduced configs and the same parameters in both packages."""
    jcfg = jax_reduced(arch).replace(dtype=dtype)
    tcfg = reduced_config(arch).replace(dtype=dtype)
    jp = jax_init_params(jax.random.PRNGKey(0), JT.model_specs(jcfg),
                         jcfg.jdtype)
    return jcfg, tcfg, jp, to_torch(jax.device_get(jp), "cpu")


def _jax_spec_shapes(specs) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JaxSpec))[0]
    return {"/".join(str(k.key) for k in path): tuple(s.shape)
            for path, s in leaves}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference_field_for_field(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        jax_get_config(arch))
    assert dataclasses.asdict(reduced_config(arch)) == dataclasses.asdict(
        jax_reduced(arch))


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_program_and_specs_match_reference(arch, reduced):
    """The program and every parameter and cache spec's key and shape, on
    specs alone (the full configs are never allocated)."""
    jcfg = jax_reduced(arch) if reduced else jax_get_config(arch)
    tcfg = reduced_config(arch) if reduced else get_config(arch)
    assert TT.program_for(tcfg) == JT.program_for(jcfg)
    tshapes = {k: tuple(s.shape) for k, s in tree_leaves(
        TT.model_specs(tcfg))}
    assert tshapes == _jax_spec_shapes(JT.model_specs(jcfg))
    tcache = {k: tuple(s.shape) for k, s in tree_leaves(
        TT.cache_specs(tcfg, 2, 40))}
    assert tcache == _jax_spec_shapes(JT.cache_specs(jcfg, 2, 40))
    if not reduced:
        assert TT.num_params(tcfg) == N_PARAMS[arch]


def test_gemma3_program_is_five_local_one_global():
    grp, n_groups, rem = TT.program_for(get_config("gemma3-1b"))
    assert grp == ("attn_local",) * 5 + ("attn_global",)
    assert (n_groups, rem) == (4, ("attn_local",) * 2)
    keys = {k.split("/")[1] for k, _ in tree_leaves(
        TT.model_specs(get_config("gemma3-1b"))) if "/" in k}
    assert {"b0_attn_local", "b5_attn_global", "t0_attn_local",
            "t1_attn_local"} <= keys


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_carried_across_by_to_torch(arch):
    jcfg, tcfg, jp, tp = _setup(arch, "float32")
    jflat = {"/".join(str(k.key) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = dict(tree_leaves(tp))
    assert tflat.keys() == jflat.keys()
    for k, v in jflat.items():
        np.testing.assert_array_equal(tflat[k].numpy(), v, err_msg=k)
    sd = TT.Decoder(tcfg, tp, device="cpu").state_dict()
    assert {k.removeprefix("params.").replace(".", "/") for k in sd} == \
        set(jflat)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_jax(arch, dtype):
    """S 64: gemma3-reduced's local layers (window 16) see a quarter of
    the keys; both the plain path and the kernel wrappers (plain on the
    CPU)."""
    jcfg, tcfg, jp, tp = _setup(arch, dtype)
    toks = np.random.default_rng(11).integers(0, tcfg.vocab_size, (2, 64))
    lj, _ = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)})
    tol = TOL[dtype]
    for plain in (True, False):
        lt, aux = TT.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                             plain=plain)
        assert lt.shape == (2, 64, tcfg.vocab_size)
        assert lt.dtype == tcfg.torch_dtype and float(aux) == 0.0
        _close(lt, lj, tol)
        pt = make_prefill_step(tcfg, plain=plain)(
            tp, {"tokens": torch.from_numpy(toks)})
        _close(pt, lj[:, -1], tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax_past_the_window(arch, dtype):
    """24 steps: gemma3-reduced's window of 16 cuts its local layers' keys
    from step 16 on."""
    jcfg, tcfg, jp, tp = _setup(arch, dtype)
    B, S = 2, 24
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
        _close(lt, lj, tol)
    for k, leaf in tree_leaves(tcache):          # every layer's K and V
        _close(leaf, functools.reduce(lambda n, key: n[key], k.split("/"),
                                      jcache), tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_tokens_identical_at_f32(arch):
    jcfg, tcfg, jp, tp = _setup(arch, "float32")
    prompt = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 12))
    tj = jax_generate(jcfg, jp, jnp.asarray(prompt, jnp.int32), 12)
    tt = generate(tcfg, TT.Decoder(tcfg, tp, device="cpu"),
                  torch.from_numpy(prompt), 12, device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
