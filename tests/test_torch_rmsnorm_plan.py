"""The rmsnorm kernel's launch plan and lane arithmetic, on the CPU.

``plan_rows`` decides, on the host, which path of ``csrc/rmsnorm.cu`` a
call takes, how the lanes of a warp tile a row, and the persistent grid.
These tests hold it over the main paths' shapes (``chip_smoke.py``'s
``RMSNORM_PATH_SHAPES``), the JAX kernel tests' sweep, a width that allows
no 16-byte access and ragged row counts: the vector path exactly when the
row allows it, lanes that tile the row, and a walk of the kernel's
persistent loop that visits each row once.  ``rmsnorm_lanes_plain``
repeats the kernel's order of summation (per-lane partials, then the xor
tree) and is held against ``rmsnorm_plain`` and the JAX package's
``rmsnorm_ref``: at f32 within rtol 1e-6 (both sum the same f32 squares,
in another order), at bf16 within one bf16 ulp (the f32 results round to
neighbouring bf16 values at most).  The kernel itself is held against
``rmsnorm_plain`` on the card (``tests/test_torch_cuda.py``).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch.kernels import plan_rows, rmsnorm_lanes_plain, rmsnorm_plain
from repro_torch.weights import tensor_from_numpy

_SMOKE = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
_spec = importlib.util.spec_from_file_location("chip_smoke", _SMOKE)
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

#: an H100's SMs
SMS = 132
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: the JAX kernel tests' sweep (tests/test_kernels.py)
JAX_SWEEP = [(64, 256), (3, 7, 512), (1000, 128), (4, 2048)]
#: ragged row counts at the paths' widths
RAGGED = [(rows, d) for rows in (1, 1000, 65537, 131071)
          for d in (128, 2048, 3584)]
SHAPES = ([tuple(s) for s in chip_smoke.RMSNORM_PATH_SHAPES] + JAX_SWEEP
          + [(5, 130)] + RAGGED)


def _rows_d(shape):
    return int(np.prod(shape[:-1])), shape[-1]


def walk(plan, rows: int) -> np.ndarray:
    """How often the kernel's persistent loop visits each row: warp ``w``
    of ``grid * warps_per_block`` takes the row groups ``w, w + W, ..``
    while ``g * rows_per_warp < rows``, and group ``g`` is rows
    ``g * rows_per_warp ..`` up to ``rows_per_warp`` of them, the ragged
    tail masked."""
    seen = np.zeros(rows, np.int64)
    n_warps = plan.grid * plan.warps_per_block
    for w in range(n_warps):
        g = np.arange(w, -(-rows // plan.rows_per_warp), n_warps)
        r = (g[:, None] * plan.rows_per_warp
             + np.arange(plan.rows_per_warp)[None, :]).ravel()
        np.add.at(seen, r[r < rows], 1)
    return seen


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plan_takes_vector_path_exactly_when_the_row_allows(shape, dtype):
    rows, d = _rows_d(shape)
    dt = DTYPES[dtype]
    n = 16 // torch.empty((), dtype=dt).element_size()
    for aligned in (True, False):
        for residual in (False, True):
            plan = plan_rows(rows, d, dt, SMS, aligned, residual=residual)
            assert (plan.path != "scalar") == (aligned and d % n == 0), plan
            if plan.path == "scalar":
                continue
            assert plan.lpr * plan.vpl * n == d, plan
            assert plan.lpr & (plan.lpr - 1) == 0 and plan.lpr <= 32
            # lanes per row: the largest power of two <= 32 that divides
            # the row's vector count
            assert plan.lpr == 32 or plan.vpl % 2 == 1, plan
            assert 1 <= plan.grid <= SMS * 8


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_persistent_walk_visits_each_row_once(shape, dtype):
    rows, d = _rows_d(shape)
    for residual in (False, True):
        plan = plan_rows(rows, d, DTYPES[dtype], SMS, True,
                         residual=residual)
        assert np.all(walk(plan, rows) == 1), plan


def test_plan_at_the_main_paths_widths():
    """The rows path at the models' widths, with the lanes the design
    gives them, and the q/k-norm's 128-wide bf16 rows two to a warp."""
    bf16, f32 = torch.bfloat16, torch.float32
    want = {(128, bf16): (16, 1), (2048, bf16): (32, 8),
            (3584, bf16): (32, 14), (128, f32): (32, 1),
            (2048, f32): (32, 16), (256, bf16): (32, 1),
            (512, bf16): (32, 2)}
    for (d, dt), lanes in want.items():
        plan = plan_rows(8192, d, dt, SMS, True)
        assert plan.path == "rows" and (plan.lpr, plan.vpl) == lanes, plan
    q = plan_rows(131072, 128, bf16, SMS, True)
    assert q.rows_per_warp == 8          # 2 rows side by side, 4 at once
    # a full grid: every SM busy, one wave of persistent blocks
    assert q.grid % SMS == 0


def _bf16_within_one_ulp(a: torch.Tensor, b: torch.Tensor) -> None:
    a, b = a.float(), b.float()
    big = torch.maximum(a.abs(), b.abs())
    ulp = torch.where(big > 0, torch.exp2(torch.floor(torch.log2(big)) - 7),
                      torch.zeros_like(big))
    worst = ((a - b).abs() - ulp).max().item()
    assert worst <= 0, f"differ by more than one bf16 ulp ({worst})"


MIRROR_CASES = ([(s, False) for s in JAX_SWEEP + [(5, 130), (4, 1, 16, 128),
                                                  (2, 1, 3584), (33, 2048)]]
                + [(s, True) for s in ((128, 256), (5, 130), (33, 2048))])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", MIRROR_CASES, ids=str)
def test_lane_mirror_matches_plain_and_jax(case, dtype):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import rmsnorm_ref

    shape, with_res = case
    rng = np.random.default_rng(7)

    def pair(a, dt):
        j = jnp.asarray(a, jnp.float32).astype(dt)
        return j, tensor_from_numpy(np.asarray(j))

    xj, xt = pair(rng.standard_normal(shape), dtype)
    sj, st = pair(rng.standard_normal(shape[-1:]) * 0.1 + 1.0, "float32")
    rj = rt = None
    if with_res:
        rj, rt = pair(rng.standard_normal(shape), dtype)
    rows, d = _rows_d(shape)
    for aligned in (True, False):      # the vector paths' order, the scalar's
        plan = plan_rows(rows, d, DTYPES[dtype], SMS, aligned,
                         residual=with_res)
        out = rmsnorm_lanes_plain(xt, st, rt, plan)
        assert out.shape == xt.shape and out.dtype == xt.dtype
        ref = jax.device_get(rmsnorm_ref(
            xj.reshape(-1, d), sj,
            None if rj is None else rj.reshape(-1, d)).reshape(shape))
        for other in (rmsnorm_plain(xt, st, rt), tensor_from_numpy(
                np.asarray(ref))):
            if dtype == "float32":
                torch.testing.assert_close(out, other, rtol=1e-6, atol=0)
            else:
                _bf16_within_one_ulp(out, other)


def test_plan_constants_match_the_kernel_source():
    """``plan_rows`` mirrors ``RowsShape`` and the instances of
    ``csrc/rmsnorm.cu``; a change on one side only fails here."""
    import re

    from repro_torch.kernels.rmsnorm import ops

    src = open(os.path.join(os.path.dirname(__file__), "..", "src",
                            "repro_torch", "csrc", "rmsnorm.cu")).read()

    def const(name):
        m = re.search(rf"constexpr int {name} = ([0-9 *]+);", src)
        return eval(m.group(1))          # digits and '*' only

    assert const("BLOCK") == 32 * ops.WARPS_PER_BLOCK
    for name in ("REG_WORDS", "REG_OTHER", "STAGES", "SMEM_PER_SM",
                 "SMEM_RESERVED"):
        assert const(name) == getattr(ops, name), name
    inst = {(int(a), int(b)) for a, b in re.findall(
        r"try_rows<T, S, (\d+), (\d+), RES>", src)}
    assert inst == ops.ROW_INSTANCES
    assert re.search(r"__launch_bounds__\(BLOCK, "
                     rf"{ops.LIGHT_BLOCKS_PER_SM}\)\s*rmsnorm_loop_kernel",
                     src)
