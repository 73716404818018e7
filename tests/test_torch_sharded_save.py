"""ZeRO-1 moments and the sharded save of a train state.

Four spawned gloo ranks (``tests/torch_ranks.py``) train reduced qwen3
(``remat="full"``) and reduced qwen2.5 (dense FSDP storage) for three
AdamW steps on a (2, 2) mesh under ``launch.dryrun.rules_for``'s storage
rules, once with ZeRO-1 moments (``AdamWConfig(zero1=True)``: each
moment this rank's block under ``opt_rules_for``, split over ``data`` on
its ``d`` dims) and once with the moments beside the parameter blocks:

- the two runs are bit-equal (losses, clip norms, every parameter block):
  the gradient is reduced alike and the update is elementwise; qwen3's
  moments take half the bytes (its ``q_norm`` / ``k_norm`` have no ``d``
  dim), qwen2.5's no fewer (its FSDP storage already splits the ``d``
  dims over ``data``);
- the ZeRO-1 state saved through an async ``CheckpointManager`` with
  ``shardings=train.step.train_state_shardings(...)`` -- every leaf
  gathered over the group holding its blocks, process 0 writing -- is
  byte-identical, data file and manifest, to the port's whole-state
  ``save_checkpoint`` of the state assembled here from the ranks' blocks;
  ``latest_step`` sees it on every rank after ``wait``;
- it restores through the reference's ``restore_checkpoint`` to that
  state, and through the port's ``restore_checkpoint(shardings=)`` to
  each rank's blocks, bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import reduced_config
from repro_torch.distributed import Mesh, activate
from repro_torch.launch import dryrun
from repro_torch.models.common import tree_leaves
from repro_torch.models.transformer import model_specs
from repro_torch.weights import unflatten
from test_torch_dp_train import numpy_params
from torch_ranks import collect, spawn_ranks

B, S, STEPS = 4, 16, 3
ARCHS = {"qwen3": "qwen3-1.7b", "qwen25": "qwen2.5-14b"}
#: name, arch, D, M, steps, loss_dtype, remat, zero1, save
CASES = [(f"{short}_{tag}", arch, 2, 2, STEPS, "float32",
          "full" if short == "qwen3" else "none", zero1, zero1)
         for short, arch in ARCHS.items()
         for tag, zero1 in (("plain", False), ("zero1", True))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_save")
    rng = np.random.default_rng(24)
    data = {}
    for arch in ARCHS.values():
        cfg = reduced_config(arch).replace(dtype="float32")
        for k, v in numpy_params(model_specs(cfg), rng).items():
            data[f"{arch}/{k}"] = v
        data[f"tokens/{arch}"] = rng.integers(
            0, cfg.vocab_size, (STEPS, B, S)).astype(np.int32)
    inputs = os.path.join(str(tmp), "inputs.npz")
    np.savez(inputs, **data)
    ranks = {}
    for res in collect(spawn_ranks("tp_train", 4, tmp, inputs=inputs,
                                   cases=[list(c) for c in CASES],
                                   root=str(tmp))):
        for name, r in res.items():
            ranks.setdefault(name, []).append(r)
    return tmp, data, ranks


def _whole_state(ranks: list, arch: str, data: dict) -> dict:
    """The train state assembled from every rank's blocks."""
    full = {}
    for r in ranks:
        for k, t in r["params"].items():
            shape = data[f"{arch}/{k}"].shape
            full.setdefault(f"params/{k}", torch.empty(shape, dtype=t.dtype))
            full[f"params/{k}"][tuple(slice(a, b) for a, b in
                                      r["slices"][k])] = t
        for k, t in r["opt"].items():
            shape = data[f"{arch}/{k.split('/', 1)[1]}"].shape
            full.setdefault(f"opt/{k}", torch.empty(shape, dtype=t.dtype))
            full[f"opt/{k}"][tuple(slice(a, b) for a, b in
                                   r["opt_slices"][k])] = t
    opt_step, step = ranks[0]["steps"]
    full["opt/step"], full["step"] = opt_step, step
    return unflatten(full)


@pytest.mark.parametrize("short", list(ARCHS))
def test_zero1_step_is_bit_equal_to_the_plain_step(runs, short):
    _, _, ranks = runs
    for plain, z1 in zip(ranks[f"{short}_plain"], ranks[f"{short}_zero1"]):
        assert plain["losses"] == z1["losses"]
        assert plain["grad_norms"] == z1["grad_norms"]
        assert plain["params"].keys() == z1["params"].keys()
        for k in plain["params"]:
            assert torch.equal(plain["params"][k], z1["params"][k]), k


@pytest.mark.parametrize("short", list(ARCHS))
def test_zero1_moments_are_the_opt_rules_blocks(runs, short):
    """Each rank's moment bytes are the sum of its blocks under
    ``opt_rules_for`` (computed here on a shape-only mesh)."""
    _, _, ranks = runs
    arch = ARCHS[short]
    cfg = reduced_config(arch).replace(name=arch, dtype="float32")
    _, storage = dryrun.rules_for(cfg, False)
    opt_rules = dryrun.opt_rules_for(storage, False)
    with activate(Mesh((2, 2), ("data", "model")), opt_rules) as ctx:
        want = 2 * 4 * sum(
            int(np.prod([sl.stop - sl.start for sl in ctx.mesh.local_slices(
                ctx.spec(s.logical, s.shape), s.shape,
                {"data": 0, "model": 0})]))
            for _, s in tree_leaves(model_specs(cfg)))
    plain = ranks[f"{short}_plain"][0]["moment_bytes"]
    for r in ranks[f"{short}_zero1"]:
        assert r["moment_bytes"] == want
    if short == "qwen3":
        assert 0.5 <= want / plain < 0.51
    else:
        assert want == plain


@pytest.mark.parametrize("short", list(ARCHS))
def test_sharded_save_is_byte_identical_to_the_whole_save(runs, short,
                                                          tmp_path):
    tmp, data, ranks = runs
    name = f"{short}_zero1"
    for r in ranks[name]:
        assert r["latest_step"] == STEPS
    state = _whole_state(ranks[name], ARCHS[short], data)
    d = save_checkpoint(str(tmp_path), STEPS, state)
    sharded = os.path.join(str(tmp), name, f"step_{STEPS:010d}")
    for f in ("data.bin", "manifest.json"):
        with open(os.path.join(d, f), "rb") as a, \
                open(os.path.join(sharded, f), "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("short", list(ARCHS))
def test_sharded_save_restores_in_both_packages(runs, short):
    from repro.checkpoint.manager import restore_checkpoint as jax_restore

    tmp, data, ranks = runs
    name = f"{short}_zero1"
    for r in ranks[name]:
        assert r["restored_step"] == STEPS and r["restored_bit_exact"]
    want = dict(tree_leaves(_whole_state(ranks[name], ARCHS[short], data)))
    got, step = jax_restore(os.path.join(str(tmp), name),
                            unflatten(dict.fromkeys(want, 0)))
    assert step == STEPS
    got = dict(tree_leaves(got))
    assert sorted(got) == sorted(want)
    for k, t in want.items():
        assert np.array_equal(np.asarray(got[k]), t.numpy()), k


def test_a_dropped_train_state_is_freed_without_the_cycle_collector():
    """A train state and everything one step made are freed as soon as
    their holder lets go, with the cycle collector off: the tree walks
    that every layout, step and save runs (``tree_leaves``) leave no
    reference cycle behind.  (Such a cycle kept a whole state on the card
    alive into the next run of a phase.)"""
    import gc
    import weakref

    from repro_torch.models.common import init_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = reduced_config("qwen3-1.7b").replace(dtype="float32")
    opt = AdamWConfig(lr=1e-2, warmup_steps=1)
    gc.collect()
    gc.disable()
    try:
        state = init_train_state(init_params(
            model_specs(cfg), torch.Generator().manual_seed(0),
            torch.float32, "cpu"), opt)
        state, _ = make_train_step(cfg, opt)(state, {
            "tokens": torch.zeros((2, 8), dtype=torch.int32)})
        refs = [weakref.ref(t) for _, t in tree_leaves(state)]
        del state
        assert [r for r in refs if r() is not None] == []
    finally:
        gc.enable()


def test_a_dropped_restored_tree_is_freed_without_the_cycle_collector(
        tmp_path):
    """The same for a tree ``restore_checkpoint`` hands back: its rebuild
    from the manifest's keys leaves no cycle holding the leaves."""
    import gc
    import weakref

    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.models.common import init_params

    specs = model_specs(reduced_config("qwen3-1.7b"))
    save_checkpoint(str(tmp_path), 1, init_params(
        specs, torch.Generator().manual_seed(0), torch.float32, "cpu"))
    gc.collect()
    gc.disable()
    try:
        tree, _ = restore_checkpoint(str(tmp_path), specs, device="cpu")
        refs = [weakref.ref(t) for _, t in tree_leaves(tree)]
        del tree
        assert refs and [r for r in refs if r() is not None] == []
    finally:
        gc.enable()
