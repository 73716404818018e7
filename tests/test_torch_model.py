"""The port's decode path against the JAX model at ``reduced_config("qwen3-1.7b")``.

The same parameters (drawn once by the JAX package, carried across bit for
bit by ``repro_torch.weights``) and the same numpy inputs go through each
JAX function and its port on the CPU, where the port's kernel wrappers
take their plain PyTorch versions.  Tolerances: float32 atol/rtol 1e-4
and identical greedy tokens; bf16 atol 0.08 / rtol 0.05, the tolerance
the JAX package allows between its own decode and forward paths
(``tests/test_models_smoke.py``) — the port keeps softmax probabilities in
f32 through the PV product where the JAX decode path rounds them to bf16.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import init_params as jax_init_params  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.weights import tensor_from_numpy, to_torch  # noqa: E402

F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=0.08, rtol=0.05)
DTYPES = [("float32", F32), ("bfloat16", BF16)]


def _cfgs(dtype):
    return (jax_reduced("qwen3-1.7b").replace(dtype=dtype),
            reduced_config("qwen3-1.7b").replace(dtype=dtype))


@functools.cache
def _setup(dtype):
    """Both configs and the same parameters in both packages."""
    jcfg, tcfg = _cfgs(dtype)
    jp = jax_init_params(jax.random.PRNGKey(0), JT.model_specs(jcfg),
                         jcfg.jdtype)
    return jcfg, tcfg, jp, to_torch(jax.device_get(jp), "cpu")


def _pair(a, dtype):
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, tensor_from_numpy(np.asarray(j))


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **tol)


@pytest.fixture(scope="module", params=DTYPES, ids=[d for d, _ in DTYPES])
def model(request):
    dtype, tol = request.param
    return (*_setup(dtype), tol)


def test_config_matches_reference_field_for_field():
    import dataclasses

    from repro.configs import get_config
    from repro_torch.configs import get_config as t_get_config

    for jc, tc in ((get_config("qwen3-1.7b"), t_get_config("qwen3-1.7b")),
                   _cfgs("bfloat16")):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert TT.num_params(t_get_config("qwen3-1.7b")) == 1_720_574_976


def test_param_tree_matches_reference(model):
    jcfg, tcfg, jp, tp, _ = model
    jflat = {"/".join(str(k.key) for k in path): tuple(v.shape)
             for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    sd = TT.Decoder(tcfg, tp, device="cpu").state_dict()
    tflat = {k.removeprefix("params.").replace(".", "/"): tuple(v.shape)
             for k, v in sd.items()}
    assert tflat == jflat
    assert jflat["blocks/b0_attn/attn/wq"] == (2, 64, 4, 16)


def test_apply_norm_and_qk_norm(model):
    jcfg, tcfg, jp, tp, tol = model
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.standard_normal((2, 1, tcfg.d_model)), tcfg.dtype)
    p = {"scale": jp["final_norm"]["scale"]}
    _close(TL.apply_norm(tp["final_norm"], xt, tcfg.norm_eps),
           JL.apply_norm(p, xj, jcfg.norm_eps, "rmsnorm"), tol)
    hj, ht = _pair(rng.standard_normal((2, 1, tcfg.n_heads, tcfg.hd)),
                   tcfg.dtype)
    sj = jp["blocks"]["b0_attn"]["attn"]["q_norm"][0]
    st = tp["blocks"]["b0_attn"]["attn"]["q_norm"][0]
    _close(TL._rms_head(ht, st, tcfg.norm_eps),
           JL._rms_head(hj, sj, jcfg.norm_eps), tol)


def test_rope(model):
    jcfg, tcfg, _, _, tol = model
    pos = np.array([0, 3, 17, 1000], np.int32)
    sj, cj = JL.rope_sin_cos(jnp.asarray(pos), tcfg.hd, jcfg.rope_theta)
    st, ct = TL.rope_sin_cos(torch.from_numpy(pos), tcfg.hd, tcfg.rope_theta)
    _close(st, sj, F32)
    _close(ct, cj, F32)
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng.standard_normal((2, 4, tcfg.n_heads, tcfg.hd)),
                   tcfg.dtype)
    _close(TL.apply_rope(xt, st, ct), JL.apply_rope(xj, sj, cj), tol)


def test_attention_from_cache(model):
    jcfg, tcfg, jp, tp, tol = model
    rng = np.random.default_rng(3)
    B, S = 2, 24
    shape = (B, S, tcfg.n_kv_heads, tcfg.hd)
    xj, xt = _pair(rng.standard_normal((B, 1, tcfg.d_model)), tcfg.dtype)
    kj, kt = _pair(rng.standard_normal(shape), tcfg.dtype)
    vj, vt = _pair(rng.standard_normal(shape), tcfg.dtype)
    pj = jax.tree.map(lambda a: a[0], jp["blocks"]["b0_attn"]["attn"])
    pt = {k: v[0] for k, v in tp["blocks"]["b0_attn"]["attn"].items()}
    yj, k2, v2 = JL.attention_from_cache(pj, jcfg, xj, kj, vj, jnp.int32(9))
    yt, k3, v3 = TL.attention_from_cache(
        pt, tcfg, xt, kt, vt, torch.tensor(9, dtype=torch.int32))
    assert k3 is kt and v3 is vt                 # updated in place
    _close(yt, yj, tol)
    _close(kt, k2, tol)
    _close(vt, v2, tol)


def test_decode_step_matches_jax(model):
    jcfg, tcfg, jp, tp, tol = model
    B, S = 2, 8
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (B, S))
    jcache = JT.init_cache(jcfg, B, S)
    tcache = TT.init_cache(tcfg, B, S, "cpu")
    step = jax.jit(lambda p, c, t, s: JT.decode_step(p, jcfg, c, t, s))
    for t in range(S):
        lj, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1],
                                                   jnp.int32), jnp.int32(t))
        lt, tcache = TT.decode_step(
            tp, tcfg, tcache, torch.from_numpy(toks[:, t:t + 1]),
            torch.tensor(t, dtype=torch.int32))
        assert lt.shape == (B, tcfg.vocab_size)
        _close(lt, lj, tol)
    _close(tcache["blocks"]["b0_attn"]["k"], jcache["blocks"]["b0_attn"]["k"],
           tol)


def test_generate_greedy_tokens_identical_at_f32():
    jcfg, tcfg, jp, tp = _setup("float32")
    prompt = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 8))
    tj = jax_generate(jcfg, jp, jnp.asarray(prompt, jnp.int32), 8)
    tt = generate(tcfg, TT.Decoder(tcfg, tp, device="cpu"),
                  torch.from_numpy(prompt), 8, device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """No device given means the card; without one they raise rather than
    carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs("float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.Decoder(tcfg)
    params = TT.Decoder(tcfg, device="cpu").tree()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(tcfg, params, torch.zeros((1, 2), dtype=torch.long), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore_checkpoint(str(tmp_path), params)
