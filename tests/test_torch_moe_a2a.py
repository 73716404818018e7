"""The port's expert-parallel MoE path (``moe_block`` under a mesh) against
the JAX reference's ``_moe_a2a_local`` on the same mesh.

The port runs on spawned gloo ranks (``tests/torch_ranks.py``: one rank for
(1, 1), four for (1, 4) and (2, 2)); the reference in one process with four
forced host devices (``tests/jax_dist_ref.py``); all three start together
from the same numpy inputs (reduced olmoe, f32, B 4 x S 16).  Each rank
feeds its batch rows, holds its expert shards, and reduces its gradients
to the global objective's, mean_t(y_t . cot_t) + lb.  Cases: with and
without ``expert_mlp="data"`` (FSDP), at the config's capacity factor 1.25
(pairs dropped; the two paths drop different ones) and at 64 (nothing
dropped; the a2a path then equals the one-hot path).  Tolerances (f32):
outputs atol = rtol = 1e-5, per-leaf gradients atol 1e-5 / rtol 1e-4, the
load-balance loss within 1e-6.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.distributed import Mesh, activate
from repro_torch.models.common import tree_leaves
from repro_torch.models.moe import moe_block, moe_specs
from torch_ranks import (BELOW_RULE, ONE_HOT_SHAPES, collect,
                         collect_reference, spawn_ranks, spawn_reference)

B, S = 4, 16
MESHES = [(1, 1), (1, 4), (2, 2)]
CASES = [(D, M, fsdp, cf) for D, M in MESHES for fsdp in (False, True)
         for cf in (1.25, 64.0)]
IDS = [f"{D}x{M}_fsdp{int(f)}_cf{cf}" for D, M, f, cf in CASES]
OUT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _cfg(cf):
    return reduced_config("olmoe-1b-7b").replace(dtype="float32",
                                                 capacity_factor=cf)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_a2a")
    rng = np.random.default_rng(0)
    cfg = _cfg(1.25)
    data = {k: (rng.standard_normal(s.shape) * s.scale).astype(np.float32)
            for k, s in tree_leaves(moe_specs(cfg))}
    data["x"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    data["cot"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    inputs = os.path.join(str(tmp), "inputs.npz")
    np.savez(inputs, **data)
    cases = [list(c) for c in CASES]
    ref = spawn_reference("moe", 4, tmp, inputs, cases=cases)
    one = spawn_ranks("moe", 1, tmp, inputs=inputs, cases=cases)
    four = spawn_ranks("moe", 4, tmp, inputs=inputs, cases=cases)
    ranks = {}
    for res in collect(one) + collect(four):
        for name, r in res.items():
            ranks.setdefault(name, []).append(r)
    return data, collect_reference(ref), ranks


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.numpy(), want, err_msg=what, **tol)


@pytest.mark.parametrize("case", IDS)
def test_a2a_output_matches_reference(runs, case):
    _, ref, ranks = runs
    D, M = (int(v) for v in case.split("_")[0].split("x"))
    assert len(ranks[case]) == D * M
    for r in ranks[case]:
        rows = slice(*r["rows"])
        _close(r["y"], ref[f"{case}/y"][rows], OUT_TOL, f"{case} y")


@pytest.mark.parametrize("case", IDS)
def test_a2a_load_balance_loss_matches_reference(runs, case):
    _, ref, ranks = runs
    for r in ranks[case]:
        assert abs(r["lb"].item() - float(ref[f"{case}/lb"])) <= 1e-6


@pytest.mark.parametrize("case", IDS)
def test_a2a_gradients_match_reference(runs, case):
    """Every leaf's gradient on every rank (its block of the reference's),
    and the input's (its batch rows)."""
    _, ref, ranks = runs
    for r in ranks[case]:
        _close(r["gx"], ref[f"{case}/gx"][slice(*r["rows"])], GRAD_TOL,
               f"{case} x")
        for k, g in r["grads"].items():
            block = tuple(slice(a, b) for a, b in r["slices"][k])
            _close(g, ref[f"{case}/grads/{k}"][block], GRAD_TOL,
                   f"{case} {k}")


def _one_hot(data, cf):
    cfg = _cfg(cf)
    p = {k: torch.from_numpy(data[k]).requires_grad_(True)
         for k in ("router", "wi", "wg", "wo")}
    x = torch.from_numpy(data["x"]).requires_grad_(True)
    y, lb = moe_block(p, cfg, x)
    obj = (y * torch.from_numpy(data["cot"])).sum(-1).mean() + lb
    keys = sorted(p)
    g = torch.autograd.grad(obj, [x] + [p[k] for k in keys])
    return y.detach(), lb.detach(), g[0], dict(zip(keys, g[1:]))


@pytest.mark.parametrize("case", [i for i in IDS if i.endswith("cf64.0")])
def test_a2a_equals_the_one_hot_path_when_nothing_drops(runs, case):
    data, _, ranks = runs
    y, lb, gx, gp = _one_hot(data, 64.0)
    tol = dict(atol=1e-6, rtol=1e-5)
    for r in ranks[case]:
        rows = slice(*r["rows"])
        _close(r["y"], y[rows].numpy(), tol, "y")
        _close(r["gx"], gx[rows].numpy(), tol, "x")
        assert r["lb"].item() == pytest.approx(lb.item(), abs=1e-7)
        for k, g in r["grads"].items():
            block = tuple(slice(a, b) for a, b in r["slices"][k])
            _close(g, gp[k][block].numpy(), tol, k)


@pytest.mark.parametrize("case", ["1x4_fsdp0_cf1.25", "2x2_fsdp0_cf1.25"])
def test_at_the_configs_capacity_the_paths_drop_different_pairs(runs, case):
    """At 1.25 the a2a path's capacities differ from the one-hot path's by
    design, so its output differs (it is not the one-hot path renamed),
    while the load-balance loss, taken over every token, is the same."""
    data, _, ranks = runs
    y, lb, _, _ = _one_hot(data, 1.25)
    diff = max((r["y"] - y[slice(*r["rows"])]).abs().max().item()
               for r in ranks[case])
    assert diff > 1e-3
    for r in ranks[case]:
        assert r["lb"].item() == pytest.approx(lb.item(), abs=1e-6)


def _one_hot_rows(data, b, s, rows):
    """The one-hot path on one rank under grad on ``x[:b, :s]``: y, lb,
    and the gradients of mean_t(y_t . cot_t) + lb over the whole batch,
    the input's cut to ``rows``."""
    cfg = _cfg(1.25)
    p = {k: torch.tensor(data[k], requires_grad=True)
         for k in ("router", "wi", "wg", "wo")}
    x = torch.tensor(data["x"][:b, :s], requires_grad=True)
    y, lb = moe_block(p, cfg, x)
    obj = (y * torch.from_numpy(np.ascontiguousarray(
        data["cot"][:b, :s]))).sum(-1).mean() + lb
    keys = sorted(p)
    g = torch.autograd.grad(obj, [x] + [p[k] for k in keys])
    return y.detach(), lb.detach(), g[0], dict(zip(keys, g[1:]))


def _hold_grads(res, gx, gp, rows, what):
    _close(res["gx"], gx[rows].numpy(), GRAD_TOL, f"{what} x")
    for k, g in res["grads"].items():
        block = tuple(slice(a, b) for a, b in res["slices"][k])
        _close(g, gp[k][block].numpy(), GRAD_TOL, f"{what} {k}")


@pytest.mark.parametrize("shape", ONE_HOT_SHAPES, ids=["S%M", "B*S<4M"])
def test_the_one_hot_path_below_the_a2a_rule(runs, shape):
    """Under a mesh the reference's rule still picks the one-hot path when
    M does not divide S or the batch holds fewer than 4 M tokens.  On four
    gloo ranks of a (1, 4) mesh, each holding 2 of the 8 experts, every
    rank gives the one-hot path's output and load-balance loss over the
    whole batch (decode under a mesh), and under grad the one-rank path's
    gradients: the input's, the router's and each rank's block of every
    expert leaf's (the collectives' stated backwards); on one rank it is
    the one-hot path, exactly."""
    data, _, ranks = runs
    cfg = _cfg(1.25)
    p = {k: torch.from_numpy(data[k]) for k in ("router", "wi", "wg", "wo")}
    x = torch.from_numpy(np.ascontiguousarray(data["x"][:shape[0],
                                                        :shape[1]]))
    with torch.no_grad():
        want = moe_block(p, cfg, x)
    _, _, gx, gp = _one_hot_rows(data, *shape, slice(None))
    key = f"{shape[0]}x{shape[1]}"
    got = [r[key] for r in ranks["one_hot_1x4"]]
    assert len(got) == 4
    for y, lb in got:
        _close(y, want[0].numpy(), OUT_TOL, "one-hot y")
        assert abs(lb.item() - want[1].item()) <= 1e-6
    for r in ranks["one_hot_1x4"]:
        res = r[f"{key}/grad"]
        _close(res["y_grad_run"], want[0].numpy(), OUT_TOL, "one-hot y")
        _hold_grads(res, gx, gp, slice(None), "one-hot")
    x = x[:1, :3]                       # B * S = 3 < 4 on a (1, 1) mesh
    want = moe_block(p, cfg, x)
    with activate(Mesh((1, 1), ("data", "model"))):
        got = moe_block(p, cfg, x)
    torch.testing.assert_close(got[0], want[0], atol=0, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=0, rtol=0)


@pytest.mark.parametrize("mesh", [f"{D}x{M}_fsdp{int(f)}"
                                  for D, M, f in BELOW_RULE])
def test_sharded_experts_below_the_a2a_rule_raise(runs, mesh):
    """Four gloo ranks holding their expert shards (over model, and over
    model and data with ``expert_mlp="data"``) and their batch rows at S
    3, where M does not divide S: without grad every rank's output is the
    one-hot path's on its rows (the tokens gathered over the batch axes,
    the FSDP partials reduced), with its load-balance loss; under grad
    (where this path raised before it carried gradients) every rank's
    gradients, reduced as the train step reduces them, are the one-rank
    path's: its rows of the input's, and its block of every leaf's."""
    data, _, ranks = runs
    cfg = _cfg(1.25)
    p = {k: torch.from_numpy(data[k]) for k in ("router", "wi", "wg", "wo")}
    with torch.no_grad():
        y, lb = moe_block(p, cfg, torch.from_numpy(
            np.ascontiguousarray(data["x"][:, :3])))
    _, _, gx, gp = _one_hot_rows(data, data["x"].shape[0], 3, slice(None))
    got = [r[mesh] for r in ranks["below_rule"]]
    assert len(got) == 4
    for res in got:
        rows = slice(*res["rows"])
        _close(res["y"], y[rows].numpy(), OUT_TOL, f"{mesh} y")
        _close(res["y_grad_run"], y[rows].numpy(), OUT_TOL, f"{mesh} y")
        assert abs(res["lb"].item() - lb.item()) <= 1e-6
        _hold_grads(res, gx, gp, rows, mesh)
