"""``lm_loss`` and its gradients under ``attn_probs_dtype="compute"``
against ``jax.value_and_grad`` of the reference's, on the CPU, for
reduced qwen3-1.7b and gemma3-1b (its local layers' window of 16 masks
keys at S 24).  The JAX package draws the parameters; the batch is made
with numpy from a seed (``tests/torch_parity.py``).

Tolerances, each with its reason:
- f32: the loss within rtol 1e-5; each leaf's gradient within 1e-5 of
  its largest entry, rtol 1e-4 (the two packages sum in other orders and
  the backward chains more sums).
- bf16: the losses within 2e-3; each leaf's bf16 gradient as far from
  the reference's f32 gradient as the reference's own bf16 gradient is,
  within 1.5x (bf16 rounding, not the port, sets that floor).
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.weights import to_torch  # noqa: E402
from torch_parity import batch_pair, fresh  # noqa: E402

LOSS_BF16 = 2e-3
GRAD_BF16_FACTOR = 1.5


def _loss_setup(arch: str, dtype: str):
    jcfg = jax_reduced(arch).replace(dtype=dtype, attn_probs_dtype="compute")
    tcfg = reduced_config(arch).replace(dtype=dtype,
                                        attn_probs_dtype="compute")
    jp = jax_init_params(jax.random.PRNGKey(0), JT.model_specs(jcfg),
                         jcfg.jdtype)
    return jcfg, tcfg, jp, to_torch(jax.device_get(jp), "cpu")


def _jflat(tree) -> dict:
    return {"/".join(str(k.key) for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(
                jax.device_get(tree))[0]}


@functools.cache
def _value_and_grads(arch: str, dtype: str, S: int):
    """(reference loss, reference grads, port loss, port grads) of
    ``lm_loss`` under compute on one batch of 2 x S tokens (numpy; kept
    for the bf16 test's f32 floor)."""
    jcfg, tcfg, jp, tp = _loss_setup(arch, dtype)
    jb, tb = batch_pair(tcfg, seed=9, S=S)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(p, jcfg, b)))(jp, jb)
    params = fresh(tp)
    keys, leaves = zip(*tree_leaves(params))
    tl = TT.lm_loss(params, tcfg, tb)
    grads = torch.autograd.grad(tl, leaves)
    return (float(jl), _jflat(jg), tl.item(),
            {k: g.detach().float().numpy() for k, g in zip(keys, grads)})


#: gemma3's reduced window is 16: at S 24 its local layers mask keys
@pytest.mark.parametrize("arch,S", [("qwen3-1.7b", 16), ("gemma3-1b", 24)])
def test_lm_loss_compute_matches_reference_at_f32(arch, S):
    jl, jg, tl, tg = _value_and_grads(arch, "float32", S)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tg.keys() == jg.keys()
    for k, g in tg.items():
        peak = float(np.abs(jg[k]).max())
        np.testing.assert_allclose(g, jg[k], rtol=1e-4, atol=1e-5 * peak,
                                   err_msg=k)


@pytest.mark.parametrize("arch,S", [("qwen3-1.7b", 16), ("gemma3-1b", 24)])
def test_lm_loss_compute_matches_reference_at_bf16(arch, S):
    """The losses within 2e-3; each leaf's bf16 gradient as far from the
    reference's f32 gradient as the reference's own bf16 gradient is,
    within GRAD_BF16_FACTOR."""
    jl, jg, tl, tg = _value_and_grads(arch, "bfloat16", S)
    _, jg32, _, _ = _value_and_grads(arch, "float32", S)
    assert abs(tl - jl) <= LOSS_BF16, (tl, jl)
    for k, g in tg.items():
        floor = np.linalg.norm(jg[k] - jg32[k])
        dist = np.linalg.norm(g - jg32[k])
        assert dist <= GRAD_BF16_FACTOR * floor + 1e-6 * np.linalg.norm(
            jg32[k]), (k, dist, floor)
