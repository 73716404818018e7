"""Shared set-up of the port's model parity tests against the JAX package
(``test_torch_xlstm.py``, ``test_torch_moe.py``,
``test_torch_encdec_vlm.py``).

The JAX package draws the parameters; leaves whose init is ``zeros`` and
would hide a path (the VLM's cross-attention ``gate``: ``tanh(0) = 0``
adds nothing; LayerNorm ``bias``; the mLSTM's ``b_if``; the sLSTM's
``b``) are given fixed nonzero values from a seeded numpy generator, the
gate 0.5; ``repro_torch.weights.to_torch`` carries the tree across bit
for bit.  Tolerances are ``tests/test_torch_model.py``'s: f32 atol = rtol
= 1e-4, bf16 atol 0.08 / rtol 0.05.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced
from repro.models import transformer as JT
from repro.models.common import ParamSpec as JaxSpec
from repro.models.common import init_params as jax_init_params
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import transformer as TT
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.weights import tensor_from_numpy, to_torch

TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=0.08, rtol=0.05)}
#: the value every cross-attention gate is set to (tanh 0.46)
GATE = 0.5


def close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **tol)


def pair(a: np.ndarray, dtype):
    """The same values as a JAX array and a torch tensor (identical bits)."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, tensor_from_numpy(np.asarray(j))


def spec_shapes(specs) -> dict:
    """``{"/"-key: shape}`` of a JAX spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JaxSpec))[0]
    return {"/".join(str(k.key) for k in path): tuple(s.shape)
            for path, s in leaves}


def zero_init_keys(cfg) -> list:
    """Keys of the parameter leaves whose init is ``zeros``."""
    leaves = jax.tree_util.tree_flatten_with_path(
        JT.model_specs(cfg), is_leaf=lambda x: isinstance(x, JaxSpec))[0]
    return ["/".join(str(k.key) for k in path) for path, s in leaves
            if s.init == "zeros"]


def set_nonzero(jp, cfg, seed: int = 3):
    """``jp`` with every zero-init leaf set to a fixed nonzero value: the
    gates to ``GATE``, the biases to 0.2 x a standard normal draw."""
    rng = np.random.default_rng(seed)
    flat = {"/".join(str(k.key) for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    for key in zero_init_keys(cfg):
        leaf = flat[key]
        value = (np.full(leaf.shape, GATE) if key.endswith("/gate")
                 else rng.standard_normal(leaf.shape) * 0.2)
        flat[key] = jnp.asarray(value, jnp.float32).astype(leaf.dtype)
    tree = jax.tree_util.tree_structure(jp)
    keys = ["/".join(str(k.key) for k in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(jp)[0]]
    return jax.tree_util.tree_unflatten(tree, [flat[k] for k in keys])


@functools.cache
def setup(arch: str, dtype: str, nonzero: bool = True):
    """Both reduced configs and the same parameters in both packages."""
    jcfg = jax_reduced(arch).replace(dtype=dtype)
    tcfg = reduced_config(arch).replace(dtype=dtype)
    jp = jax_init_params(jax.random.PRNGKey(0), JT.model_specs(jcfg),
                         jcfg.jdtype)
    if nonzero:
        jp = set_nonzero(jp, jcfg)
    return jcfg, tcfg, jp, to_torch(jax.device_get(jp), "cpu")


def check_config(arch: str) -> None:
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        jax_get_config(arch))
    assert dataclasses.asdict(reduced_config(arch)) == dataclasses.asdict(
        jax_reduced(arch))


def check_specs(arch: str, reduced: bool, mem_len: int = 0) -> None:
    """Program, parameter and cache specs key for key and shape for shape
    (specs alone: the full configs are never allocated), and the
    reference's parameter counts."""
    jcfg = jax_reduced(arch) if reduced else jax_get_config(arch)
    tcfg = reduced_config(arch) if reduced else get_config(arch)
    assert TT.program_for(tcfg) == JT.program_for(jcfg)
    tshapes = {k: tuple(s.shape) for k, s in tree_leaves(
        TT.model_specs(tcfg))}
    assert tshapes == spec_shapes(JT.model_specs(jcfg))
    tcache = {k: tuple(s.shape) for k, s in tree_leaves(
        TT.cache_specs(tcfg, 2, 40, mem_len))}
    assert tcache == spec_shapes(JT.cache_specs(jcfg, 2, 40, mem_len))
    assert TT.num_params(tcfg) == JT.num_params(jcfg)
    assert TT.active_params(tcfg) == JT.active_params(jcfg)


def check_weights(arch: str) -> None:
    """``to_torch`` carries every leaf across, and the ``Decoder``'s
    ``state_dict`` keys are the reference's key paths."""
    jcfg, tcfg, jp, tp = setup(arch, "float32")
    jflat = {"/".join(str(k.key) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = dict(tree_leaves(tp))
    assert tflat.keys() == jflat.keys()
    for k, v in jflat.items():
        np.testing.assert_array_equal(tflat[k].numpy(), v, err_msg=k)
    sd = TT.Decoder(tcfg, tp, device="cpu").state_dict()
    assert {k.removeprefix("params.").replace(".", "/") for k in sd} == \
        set(jflat)


def cache_leaf(tree, key: str):
    return functools.reduce(lambda n, k: n[k], key.split("/"), tree)


def batch_pair(cfg, seed: int = 1, B: int = 2, S: int = 16):
    """The same training batch for both packages: tokens (and frames /
    patches for encdec / vlm) from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size,
                                     (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        arrays["frames"] = rng.standard_normal(
            (B, S, cfg.frontend_dim)).astype(np.float32)
    elif cfg.family == "vlm":
        arrays["patches"] = rng.standard_normal(
            (B, 8, cfg.frontend_dim)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def fresh(tree):
    """A copy of a (cached) parameter tree whose leaves require grad."""
    return tree_map(lambda t: t.detach().clone().requires_grad_(True), tree)
