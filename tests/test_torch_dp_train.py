"""The port's data-parallel train step against the JAX reference's jitted
step under ``activate`` on the same mesh, and against the port's own
single-process step.

Two AdamW steps (lr 1e-2, f32 models) of reduced qwen3 on a (2, 1) mesh
and reduced olmoe on (2, 2) with ``remat="full"`` (its recompute re-issues
the a2a collectives), at the config's capacity factor 1.25 and at 64, and
with its expert leaves FSDP-split over ``data`` too (``expert_mlp``: the
gather's reduce-scatter carries their data sum, and the clip norm
all-reduces their squares over the whole mesh).
The port runs on spawned gloo ranks (``tests/torch_ranks.py``), each
feeding its batch rows and holding its parameter shards; the reference in
one process with four forced host devices (``tests/jax_dist_ref.py``).
Rules keep the dense leaves whole (``qheads/kv_heads/mlp/vocab=None``, as
the reference's ``tests/test_pipeline.py`` has them; the tensor-parallel
step is ``tests/test_torch_tp.py``'s); the default rules, which split
xlstm's mLSTM heads over ``model`` (its own rules keep them whole), make
the port's step raise.  Tolerances (f32,
``tests/test_torch_train.py``'s for loss curves): losses rtol 1e-4, clip
norms rtol 1e-3, parameters after two steps atol = rtol = 1e-4.  Against
the single-process step the same, and for olmoe only at capacity factor
64, where no pair drops on either path.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.models.common import tree_leaves
from repro_torch.models.transformer import model_specs
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.weights import unflatten
from torch_ranks import (collect, collect_reference, spawn_ranks,
                         spawn_reference)

B, S, STEPS = 4, 16, 2
#: name, arch, D, M, remat, capacity factor, steps, rules ("whole": dense
#: leaves whole; "whole_fsdp": and expert_mlp="data"; "default")
CASES = [("qwen3_2x1", "qwen3-1.7b", 2, 1, "none", 1.25, STEPS, "whole"),
         ("olmoe_2x2", "olmoe-1b-7b", 2, 2, "full", 1.25, STEPS, "whole"),
         ("olmoe_2x2_fsdp", "olmoe-1b-7b", 2, 2, "none", 1.25, STEPS,
          "whole_fsdp"),
         ("olmoe_2x2_cf64", "olmoe-1b-7b", 2, 2, "full", 64.0, STEPS,
          "whole"),
         ("xlstm_1x2_tp", "xlstm-125m", 1, 2, "none", 1.25, 1,
          "default")]
HELD = [c[0] for c in CASES if c[-1] != "default"]
TOL = dict(atol=1e-4, rtol=1e-4)


def numpy_params(specs, rng) -> dict:
    """Flat ``{key: f32 array}`` drawn as each spec's init says."""
    out = {}
    for k, s in tree_leaves(specs):
        if s.init in ("zeros", "ones"):
            out[k] = np.full(s.shape, float(s.init == "ones"), np.float32)
            continue
        std = s.scale
        if s.init == "scaled":
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            std = s.scale / np.sqrt(max(fan_in, 1))
        out[k] = (rng.standard_normal(s.shape) * std).astype(np.float32)
    return out


def _cfg(arch, remat="none", cf=1.25):
    return reduced_config(arch).replace(dtype="float32", remat=remat,
                                        capacity_factor=cf)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_train")
    rng = np.random.default_rng(0)
    data = {}
    for arch in ("qwen3-1.7b", "olmoe-1b-7b", "xlstm-125m"):
        cfg = _cfg(arch)
        for k, v in numpy_params(model_specs(cfg), rng).items():
            data[f"{arch}/{k}"] = v
        data[f"tokens/{arch}"] = rng.integers(
            0, cfg.vocab_size, (STEPS, B, S)).astype(np.int32)
    inputs = os.path.join(str(tmp), "inputs.npz")
    np.savez(inputs, **data)
    cases = [list(c) for c in CASES]
    ref = spawn_reference("dp_train", 4, tmp, inputs,
                          cases=[c for c in cases if c[0] in HELD])
    two = spawn_ranks("dp_train", 2, tmp, inputs=inputs, cases=cases)
    four = spawn_ranks("dp_train", 4, tmp, inputs=inputs, cases=cases)
    ranks = {}
    for res in collect(two) + collect(four):
        for name, r in res.items():
            ranks.setdefault(name, []).append(r)
    return data, collect_reference(ref), ranks


def _params_close(r, want_of, what):
    for k, got in r["params"].items():
        block = tuple(slice(a, b) for a, b in r["slices"][k])
        np.testing.assert_allclose(got.numpy(), want_of(k)[block],
                                   err_msg=f"{what} {k}", **TOL)


@pytest.mark.parametrize("name", HELD)
def test_dp_step_matches_the_reference(runs, name):
    _, ref, ranks = runs
    for r in ranks[name]:
        assert "raised" not in r, r.get("raised")
        for i in range(STEPS):
            np.testing.assert_allclose(r["losses"][i],
                                       float(ref[f"{name}/loss{i}"]),
                                       rtol=1e-4)
            np.testing.assert_allclose(r["grad_norms"][i],
                                       float(ref[f"{name}/grad_norm{i}"]),
                                       rtol=1e-3)
        _params_close(r, lambda k: ref[f"{name}/params/{k}"], name)


@pytest.mark.parametrize("name", ["qwen3_2x1", "olmoe_2x2_cf64"])
def test_dp_step_matches_the_single_process_step(runs, name):
    data, _, ranks = runs
    _, arch, _, _, remat, cf, steps, _ = next(c for c in CASES
                                              if c[0] == name)
    cfg = _cfg(arch, remat, cf)
    opt = AdamWConfig(lr=1e-2, eps=1e-3, warmup_steps=1,
                          decay_steps=steps)
    params = unflatten({k[len(arch) + 1:]: torch.from_numpy(v.copy())
                        for k, v in data.items() if k.startswith(arch + "/")})
    state = init_train_state(params, opt)
    step = make_train_step(cfg, opt)
    losses = []
    for i in range(steps):
        state, m = step(state, {"tokens": torch.from_numpy(
            data[f"tokens/{arch}"][i])})
        losses.append(m["loss"].item())
    final = dict(tree_leaves(state["params"]))
    for r in ranks[name]:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-4)
        _params_close(r, lambda k: final[k].detach().numpy(), name)


def test_rules_that_split_a_dense_leaf_over_model_raise(runs):
    _, _, ranks = runs
    for r in ranks["xlstm_1x2_tp"]:
        assert "mlstm block" in r["raised"] and "heads" in r["raised"]
        assert "ROADMAP Queue 1 item 2" in r["raised"]


@pytest.mark.parametrize("pdtype", [torch.float32, torch.bfloat16])
def test_adamw_in_blocks_is_bit_equal(monkeypatch, pdtype):
    """A leaf larger than ``UPDATE_BLOCK`` is updated block by block (the
    stacked expert leaves of a full-width MoE); the update is elementwise,
    so the values are the same bit for bit."""
    from repro_torch.optim import adamw

    rng = np.random.default_rng(5)
    shapes = {"w": (3, 5, 7), "b": (11,)}

    def state():
        params = {k: torch.from_numpy(rng_p[k]).to(pdtype) for k in shapes}
        return params, adamw.adamw_init(params, cfg)

    cfg = AdamWConfig(lr=1e-2, warmup_steps=1)
    rng_p = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    grads = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for k, s in shapes.items()}
    whole, opt_w = state()
    adamw.adamw_apply(grads, opt_w, whole, cfg)
    monkeypatch.setattr(adamw, "UPDATE_BLOCK", 4)
    blocked, opt_b = state()
    adamw.adamw_apply(grads, opt_b, blocked, cfg)
    for k in shapes:
        assert torch.equal(whole[k], blocked[k])
        assert torch.equal(opt_w["m"][k], opt_b["m"][k])
        assert torch.equal(opt_w["v"][k], opt_b["v"][k])
