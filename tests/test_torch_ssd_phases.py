"""The chunk-parallel SSD scan's plan and arithmetic, on the CPU.

* ``plan_groups`` picks how many consecutive chunks the kernel groups
  together (one state per group crosses device memory) from the sequence,
  the (batch x head) count and the SM count.
* ``ssm_scan_phases_plain`` is the kernel's three-phase arithmetic in plain
  PyTorch (group end states from zero, the pass over the groups, the
  outputs from each group's entering state).  At f32 it must equal
  ``ssm_scan_plain`` (the chunked SSD, ``ssd_chunked``) and the JAX oracle
  ``ssm_scan_ref`` within 1e-5, whatever the grouping.
* The bf16 kernel splits three f32 operands (W, the state read by
  ``C h^T``, and ``x dt exp(total - cum)``) into bf16 hi + lo pairs.  Error
  budget of those rounding points: with them applied, y stays within
  2e-5 (atol = rtol) of ``ssm_scan_plain`` at an f32 output, a tenth of
  the f32-output tolerance (2e-4) the card checks hold the kernel to, and
  within the JAX package's bf16 tolerance (2e-2) of the interpret-mode
  Pallas kernel over the JAX sweep (``tests/test_torch_hybrid.py``).

The CUDA kernel is held against ``ssm_scan_plain`` on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ssm_scan as jax_ssm_scan  # noqa: E402
from repro.kernels import ssm_scan_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import (plan_groups,  # noqa: E402
                                          round_hi_lo,
                                          ssm_scan_phases_plain,
                                          ssm_scan_plain)
from repro_torch.kernels.ssm_scan.ops import MIN_WAVES  # noqa: E402
from repro_torch.weights import tensor_from_numpy  # noqa: E402

H100_SMS = 132
F32 = dict(atol=1e-5, rtol=1e-5)
#: the error budget of the bf16 path's hi + lo rounding points (above)
BF16_SPLIT_BUDGET = dict(atol=2e-5, rtol=2e-5)

# ------------------------------------------------------------ plan_groups


@pytest.mark.parametrize("H", [1, 3, 112])
@pytest.mark.parametrize("S", [1, 127, 128, 129, 4096])
def test_plan_groups_keeps_the_card_full(S, H):
    for B in (1, 4):
        for chunk in (32, 64, 128):
            n_chunks = -(-S // chunk)
            g = plan_groups(S, chunk, B * H, H100_SMS)
            assert 1 <= g <= n_chunks and g & (g - 1) == 0
            blocks = B * H * -(-n_chunks // g)
            if g > 1:   # grouping never drops below the waves asked for
                assert blocks >= MIN_WAVES * H100_SMS
            # and it groups as far as it may
            assert 2 * g > n_chunks or \
                B * H * -(-n_chunks // (2 * g)) < MIN_WAVES * H100_SMS


def test_plan_groups_at_zamba2_shapes():
    """zamba2-7b's prefill, S 4096 in chunks of 128 over 112 SSD heads:
    groups of 4 chunks (896 output blocks, ~7 waves) at B 1, of 8 at B 2;
    one chunk of a short prompt is one group, with no state launch."""
    assert plan_groups(4096, 128, 112, H100_SMS) == 4
    assert plan_groups(4096, 128, 2 * 112, H100_SMS) == 8
    assert plan_groups(64, 128, 112, H100_SMS) == 1
    assert plan_groups(129, 128, 3, H100_SMS) == 1


def test_round_hi_lo_keeps_sixteen_bits():
    t = torch.from_numpy(np.random.default_rng(0).standard_normal(4096)
                         .astype(np.float32))
    rel = ((round_hi_lo(t) - t).abs() / t.abs()).max().item()
    assert rel <= 2.0 ** -16
    assert (t.to(torch.bfloat16).float() - t).abs().max() > 1e-4


# ------------------------------------------------------------ phases


def _inputs(seed, B, S, H, P, N, dt_scale=1.0):
    """The JAX sweep's distributions (``tests/test_kernels_decode_ssm.py``)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, P)) * 0.5,
            np.abs(rng.standard_normal((B, S, H))) * 0.1 * dt_scale,
            -np.abs(rng.standard_normal(H)) - 0.1,
            rng.standard_normal((B, S, N)) * 0.3,
            rng.standard_normal((B, S, N)) * 0.3)


def _pairs(arrays, dtype):
    """JAX arrays and torch tensors with identical bits; x, B, C in dtype."""
    out_j, out_t = [], []
    for i, a in enumerate(arrays):
        j = jnp.asarray(a, jnp.float32)
        if i in (0, 3, 4):
            j = j.astype(dtype)
        out_j.append(j)
        out_t.append(tensor_from_numpy(np.asarray(j)))
    return out_j, out_t


#: (B, S, H, P, N, chunk, groups, dt_scale): one group per chunk, groups of
#: two and three with a short last group, one group for the whole
#: sequence, ragged S inside the last chunk, P and N at 16 and 64, and a
#: dt ten times the sweep's, so exp(cum) underflows inside a chunk
PHASE_CASES = [
    (2, 256, 8, 32, 16, 64, 1, 1.0),
    (2, 256, 8, 32, 16, 64, 3, 1.0),
    (2, 200, 8, 32, 16, 64, 2, 1.0),
    (1, 300, 4, 64, 64, 128, 1, 1.0),
    (1, 300, 4, 64, 64, 128, 3, 1.0),
    (2, 512, 4, 16, 64, 32, 4, 1.0),
    (1, 129, 3, 64, 64, 128, 1, 1.0),
    (1, 1024, 4, 64, 64, 128, 2, 10.0),
]


@pytest.mark.parametrize("case", PHASE_CASES, ids=str)
def test_phases_match_chunked_ssd_and_jax_oracle_at_f32(case):
    B, S, H, P, N, chunk, groups, dt_scale = case
    arrays = _inputs(sum(case[:6]), B, S, H, P, N, dt_scale)
    (xj, dtj, Aj, Bj, Cj), args = _pairs(arrays, jnp.float32)
    y = ssm_scan_phases_plain(*args, chunk=chunk, groups=groups)
    assert y.dtype == torch.float32 and tuple(y.shape) == (B, S, H, P)
    assert torch.isfinite(y).all()
    plain = ssm_scan_plain(*args, chunk=chunk)
    torch.testing.assert_close(y, plain, **F32)
    ref = ssm_scan_ref(xj, dtj, jnp.broadcast_to(Aj, (B, H)), Bj, Cj)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("case", PHASE_CASES, ids=str)
def test_bf16_rounding_points_stay_within_budget(case):
    """bf16 x, B, C and an f32 y, as ``mamba2_forward`` asks the kernel."""
    B, S, H, P, N, chunk, groups, dt_scale = case
    arrays = _inputs(sum(case[:6]), B, S, H, P, N, dt_scale)
    _, args = _pairs(arrays, jnp.bfloat16)
    y = ssm_scan_phases_plain(*args, chunk=chunk, groups=groups)
    plain = ssm_scan_plain(*args, chunk=chunk, out_dtype=torch.float32)
    torch.testing.assert_close(y, plain, **BF16_SPLIT_BUDGET)


#: (B, S, H, P, N, chunk) of the JAX sweep (``tests/test_torch_hybrid.py``
#: ``SSM_CASES``: chunks, head shapes, ragged S, state continuity)
JAX_SWEEP = ([(2, 256, 8, 32, 16, c) for c in (32, 64, 128)]
             + [(2, 256, h, p, 16, 64) for h, p in ((4, 16), (8, 64),
                                                    (16, 32))]
             + [(2, 200, 8, 32, 16, 64), (2, 512, 8, 32, 16, 128)])


@pytest.mark.parametrize("case", JAX_SWEEP, ids=str)
def test_bf16_phases_match_jax_interpret_kernel(case):
    B, S, H, P, N, chunk = case
    arrays = _inputs(sum(case), B, S, H, P, N)
    (xj, dtj, Aj, Bj, Cj), args = _pairs(arrays, jnp.bfloat16)
    kern = jax_ssm_scan(xj, dtj, Aj, Bj, Cj, chunk=chunk,
                        head_block=min(4, H))
    n_chunks = -(-S // chunk)
    for groups in sorted({1, 2, n_chunks}):
        y = ssm_scan_phases_plain(*args, chunk=chunk, groups=groups)
        np.testing.assert_allclose(y.numpy(), np.asarray(kern, np.float32),
                                   atol=2e-2, rtol=2e-2)
