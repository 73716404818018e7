"""Per-leaf gradients of the port's ``lm_loss`` against ``jax.grad`` of the
reference's, for every architecture of
``tests/test_models_smoke.py::test_train_grad_step``'s case list (the
reduced configs), at f32.

The parameters are drawn once by the JAX package (zero-init leaves that
would hide a path set nonzero, ``tests/torch_parity.py``) and carried
across bit for bit; the batch is made from a seed with numpy.  The port
runs its default path, whose kernel wrappers take their plain versions on
CPU tensors.  Tolerance: every leaf within atol = 1e-5 + rtol = 1e-4 of
the reference's gradient, scaled by that leaf's largest entry (f32 sums in
another order; the xLSTM cells loop over time where the reference scans).
One step of the port's ``make_train_step`` on that batch lowers the loss,
as the reference's smoke test asks of its SGD step.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import list_archs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.step import (init_train_state,  # noqa: E402
                                    make_train_step)
from torch_parity import batch_pair, fresh, setup  # noqa: E402


@pytest.mark.parametrize("arch", list_archs())
def test_lm_loss_gradients_match_jax_grad(arch):
    jcfg, tcfg, jp, tp = setup(arch, "float32")
    jb, tb = batch_pair(tcfg)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(p, jcfg, b)))(jp, jb)
    params = fresh(tp)
    keys, leaves = zip(*tree_leaves(params))
    tl = TT.lm_loss(params, tcfg, tb)
    grads = torch.autograd.grad(tl, leaves, allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jflat = {"/".join(str(k.key) for k in path): np.asarray(g) for path, g
             in jax.tree_util.tree_flatten_with_path(jg)[0]}
    assert set(jflat) == set(keys)
    for key, g in zip(keys, grads):
        want = jflat[key]
        peak = float(np.abs(want).max())
        np.testing.assert_allclose(g.numpy(), want,
                                   atol=1e-5 + 1e-4 * peak, rtol=1e-4,
                                   err_msg=f"{arch}: {key}")
    assert any(float(np.abs(g).max()) > 0 for g in jflat.values())


@pytest.mark.parametrize("arch", list_archs())
def test_one_train_step_lowers_the_loss_on_its_batch(arch):
    _, tcfg, _, tp = setup(arch, "float32")
    _, tb = batch_pair(tcfg)
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, decay_steps=10)
    state = init_train_state(fresh(tp), opt)
    step = make_train_step(tcfg, opt)
    state, m0 = step(state, tb)
    _, m1 = step(state, tb)
    assert torch.isfinite(m0["grad_norm"]) and m0["grad_norm"] > 0
    assert m1["loss"] < m0["loss"], (m0["loss"], m1["loss"])
