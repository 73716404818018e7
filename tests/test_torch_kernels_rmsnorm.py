"""The port's plain rmsnorm version against the JAX reference kernel.

Same inputs (numpy, seeded; bf16 bits shared exactly) go through the
Pallas kernel in interpret mode, its pure-jnp oracle (``ref.py``) and the
port's ``rmsnorm_plain`` on the CPU.  Case list and tolerances are the JAX
kernel tests' (``tests/test_kernels.py``): f32 2e-5, bf16 2e-2.  The CUDA
kernel is held against ``rmsnorm_plain`` on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import rmsnorm, rmsnorm_ref  # noqa: E402
from repro_torch.kernels import rmsnorm as t_rmsnorm  # noqa: E402
from repro_torch.kernels import rmsnorm_plain  # noqa: E402
from repro_torch.weights import tensor_from_numpy  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor (identical bits)."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    return j, tensor_from_numpy(np.asarray(j))


def _close(torch_out, jax_out, tol):
    np.testing.assert_allclose(torch_out.float().numpy(),
                               np.asarray(jax_out, np.float32),
                               atol=tol, rtol=tol)


# ------------------------------------------------------------------- rmsnorm

RMS_CASES = ([(shape, dt, False)
              for shape in ((64, 256), (3, 7, 512), (1000, 128), (4, 2048))
              for dt in ("float32", "bfloat16")]
             + [((128, 256), dt, True) for dt in ("float32", "bfloat16")])


@pytest.mark.parametrize("case", RMS_CASES, ids=str)
def test_rmsnorm_plain_matches_jax(case):
    shape, dtype, with_res = case
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal(shape), dtype)
    sj, st = _pair(rng.standard_normal(shape[-1:]) * 0.1 + 1.0, "float32")
    rj = rt = None
    if with_res:
        rj, rt = _pair(rng.standard_normal(shape), dtype)

    out = rmsnorm_plain(xt, st, rt, eps=1e-6)
    assert out.shape == xt.shape and out.dtype == xt.dtype
    kern = rmsnorm(xj, sj, residual=rj, interpret=True)
    ref = rmsnorm_ref(xj.reshape(-1, shape[-1]), sj,
                      None if rj is None else rj.reshape(-1, shape[-1]))
    _close(out, kern, TOL[dtype])
    _close(out, ref.reshape(shape), TOL[dtype])


def test_rmsnorm_wrapper_takes_plain_path_on_cpu():
    x = torch.randn(3, 5, 64, generator=torch.Generator().manual_seed(0))
    s = torch.rand(64, generator=torch.Generator().manual_seed(1)) + 0.5
    before = t_rmsnorm.launches
    out = t_rmsnorm(x, s, x, eps=1e-5)
    assert t_rmsnorm.launches == before              # no kernel on the CPU
    assert torch.equal(out, rmsnorm_plain(x, s, x, eps=1e-5))
