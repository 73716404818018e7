"""The multi-pod production layout: the port under the reference's
``rules_for(cfg, multi_pod=True)`` / ``opt_rules_for(..., True)`` on a
``(pod, data, model)`` mesh against the JAX reference's GSPMD programs on
the same mesh.

These rules name the data axes ``("data", "pod")``, out of the mesh's
order: JAX takes ``data`` as major, so every FSDP leaf (the expert leaves'
``expert_mlp`` dim, qwen2.5's, whisper's and kimi's ``d`` dims) and every
ZeRO-1 moment is stored data-major, and every gather over those axes must
follow.  Four gloo ranks (one spawn, ``tests/torch_ranks.py``, program
``multipod``, meshes built by the code ``make_production_mesh`` uses) and
one reference process with four forced host devices
(``tests/jax_dist_ref.py``, its meshes ``Mesh(devs.reshape(...), ("pod",
"data", "model"))``) run every case; inputs are numpy draws from a seed,
reduced configs at f32, tolerance 1e-5 of a tensor's largest entry:

- (a) one train step with ZeRO-1 moments: olmoe on (2, 2, 1) (the a2a
  path at M 1, experts gathered over ``("data", "pod")``) and on (2, 1, 2)
  at S 15, where M does not divide S and the MoE block trains through
  the one-hot path across ranks; qwen2.5, whisper (over 12 frames) and
  kimi on (2, 2, 1) with their dense FSDP storage.  The loss, the clip
  norm, the gradients AdamW received, the updated parameters and both
  moments, block by block;
- (b) ``moe_block`` under grad below the a2a rule (S % M != 0, and B * S
  < 4 M) on (1, 4) and (2, 1, 2): y, lb and the gradients of x, the
  router and every expert leaf;
- (c) the olmoe (2, 2, 1) state saved with ``shardings=``: the same bytes
  as a save of the whole state on one rank, restored onto one rank and
  onto the mesh (each rank's local blocks bit-exact, ``full_tensor()``
  of the permuted placements the whole leaf);
- (d) decode of olmoe and qwen2.5 under ``serve_rules(multi_pod=True)``
  on (2, 2, 1): greedy tokens equal, logits within 1e-4;
- (e) a gather, its reduce-scatter backward, ``split`` and a stacked
  gather over ``("data", "pod")`` give the data-major blocks, and the same
  gather with the group's member order dropped (global-rank order,
  pod-major) does not: the check tells the two apart.
"""

import itertools
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import reduced_config
from repro_torch.distributed.context import Mesh
from repro_torch.models.common import tree_leaves
from repro_torch.models.moe import moe_specs
from repro_torch.models.transformer import model_specs
from repro_torch.weights import unflatten
from test_torch_dp_train import numpy_params
from torch_ranks import (POD_AXES, collect, collect_reference, spawn_ranks,
                         spawn_reference)

TOL = 1e-5
DECODE_TOL = 1e-4
WORLD = 4
B, S = 4, 16
#: name, arch, mesh shape, save; S per case (olmoe_212: odd, so M = 2
#: does not divide it)
TRAIN = [("olmoe_221", "olmoe-1b-7b", (2, 2, 1), True),
         ("olmoe_212", "olmoe-1b-7b", (2, 1, 2), False),
         ("qwen25_221", "qwen2.5-14b", (2, 2, 1), False),
         ("whisper_221", "whisper-large-v3", (2, 2, 1), False),
         ("kimi_221", "kimi-k2-1t-a32b", (2, 2, 1), False)]
SEQ = {"olmoe_212": 15}
#: tag, mesh shape, axis names, multi-pod rules, B, S -- every case below
#: the a2a rule
MOE = [("moe_1x4_s3", (1, 4), ("data", "model"), False, 4, 3),
       ("moe_1x4_bs4", (1, 4), ("data", "model"), False, 1, 4),
       ("moe_212_s3", (2, 1, 2), POD_AXES, True, 4, 3),
       ("moe_212_bs4", (2, 1, 2), POD_AXES, True, 2, 2)]
#: name, arch, mesh shape, B, S_max, prompt_len
DECODE = [("olmoe_dec", "olmoe-1b-7b", (2, 2, 1), 4, 8, 3),
          ("qwen25_dec", "qwen2.5-14b", (2, 2, 1), 4, 8, 3)]
ORDER_MESH = (2, 2, 1)
MEMORY_LEN = 12


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multipod")
    rng = np.random.default_rng(281)
    data = {}
    for arch in dict.fromkeys(c[1] for c in TRAIN + DECODE):
        cfg = reduced_config(arch).replace(dtype="float32")
        for k, v in numpy_params(model_specs(cfg), rng).items():
            data[f"{arch}/{k}"] = v
    for name, arch, _, _ in TRAIN:
        cfg = reduced_config(arch)
        data[f"tokens/{name}"] = rng.integers(
            0, cfg.vocab_size, (1, B, SEQ.get(name, S))).astype(np.int32)
        if cfg.family == "encdec":
            data[f"frames/{name}"] = rng.standard_normal(
                (1, B, MEMORY_LEN, cfg.frontend_dim)).astype(np.float32)
    cfg = reduced_config("olmoe-1b-7b").replace(dtype="float32")
    for k, v in numpy_params(moe_specs(cfg), rng).items():
        data[f"moe/{k}"] = v
    for k in ("x", "cot"):
        data[f"moe/{k}"] = rng.standard_normal(
            (4, 4, cfg.d_model)).astype(np.float32)
    for name, arch, _, b, _, p0 in DECODE:
        data[f"prompt/{name}"] = rng.integers(
            0, reduced_config(arch).vocab_size, (b, p0)).astype(np.int32)
    inputs = os.path.join(str(tmp), "inputs.npz")
    np.savez(inputs, **data)
    train = [list(c) for c in TRAIN]
    moe = [list(c) for c in MOE]
    decode = [list(c) for c in DECODE]
    ref = spawn_reference("multipod", WORLD, tmp, inputs, train=train,
                          moe=moe, decode=decode)
    ranks = spawn_ranks("multipod", WORLD, tmp, inputs=inputs, train=train,
                        moe=moe, decode=decode, order=list(ORDER_MESH),
                        root=str(tmp))
    ranks = collect(ranks, 240.0)
    return data, collect_reference(ref), ranks, str(tmp)


def _close(got: torch.Tensor, want: np.ndarray, what: str,
           tol: float = TOL) -> None:
    peak = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got.numpy() - want).max()) if want.size else 0.0
    assert tuple(got.shape) == want.shape and err <= tol * max(
        peak, 1e-30), f"{what}: off by {err}, largest entry {peak}"


def _blk(slices):
    return tuple(slice(a, b) for a, b in slices)


def _coord(shape, rank: int) -> dict:
    """Rank ``rank``'s coordinate on a row-major (pod, data, model)
    mesh."""
    return dict(zip(POD_AXES, np.unravel_index(rank, shape)))


@pytest.mark.parametrize("name", [c[0] for c in TRAIN])
def test_train_step_with_zero1_matches_the_reference(runs, name):
    """(a): every rank's loss and clip norm, its block of the gradients
    AdamW received, of the updated parameters and of both moments."""
    _, ref, ranks, _ = runs
    for r in ranks:
        res = r[name]
        np.testing.assert_allclose(res["loss"], float(ref[f"{name}/loss"]),
                                   rtol=TOL)
        np.testing.assert_allclose(res["grad_norm"],
                                   float(ref[f"{name}/grad_norm"]), rtol=TOL)
        for k, g in res["grads0"].items():
            _close(g, ref[f"{name}/grads/{k}"][_blk(res["slices"][k])],
                   f"{name} gradient {k}")
        for k, p in res["params"].items():
            _close(p, ref[f"{name}/params/{k}"][_blk(res["slices"][k])],
                   f"{name} parameter {k}")
        assert res["opt"], name
        for k, m in res["opt"].items():
            _close(m, ref[f"{name}/opt/{k}"][_blk(res["opt_slices"][k])],
                   f"{name} moment {k}")


#: per case, leaves whose blocks the multi-pod rules store over
#: ``("data", "pod")``, and the dim
DATA_MAJOR = {
    "olmoe_221": {"blocks/b0_moe/moe/wi": 2, "blocks/b0_moe/moe/wo": 2},
    "olmoe_212": {"blocks/b0_moe/moe/wg": 2},
    "qwen25_221": {"blocks/b0_attn/attn/wq": 1, "embed": 1},
    "whisper_221": {"frontend_proj": 1, "encoder/final_norm/scale": 0},
    "kimi_221": {"blocks/b0_moe/moe/wi": 2, "embed": 1}}


@pytest.mark.parametrize("name", sorted(DATA_MAJOR))
def test_each_rank_holds_the_data_major_blocks(runs, name):
    """Each rank's blocks of the leaves stored over ``("data", "pod")``
    are block ``data * 2 + pod`` of the dim, as JAX lays them out (a
    leaf's stacked layers dim is whole), and so are its ZeRO-1 moments of
    ``embed`` (``opt_rules_for``: its ``d`` dim over the same axes); the
    values in them are the reference's (the train test)."""
    data, _, ranks, _ = runs
    arch, shape = next((c[1], c[2]) for c in TRAIN if c[0] == name)
    parts = shape[0] * shape[1]
    for rank, r in enumerate(ranks):
        c = _coord(shape, rank)
        idx = c["data"] * shape[0] + c["pod"]
        res = r[name]
        for key, dim in [*DATA_MAJOR[name].items(), ("m/embed", 1)]:
            sl = (res["opt_slices"] if key.startswith("m/")
                  else res["slices"])[key]
            leaf = key[len("m/"):] if key.startswith("m/") else key
            n = data[f"{arch}/{leaf}"].shape[dim]
            assert sl[dim] == (idx * n // parts, (idx + 1) * n // parts), \
                (name, key, rank)
            got = res["opt"][key] if key.startswith("m/") else \
                res["params"][key]
            assert tuple(got.shape) == tuple(b - a for a, b in sl), key


@pytest.mark.parametrize("tag", [c[0] for c in MOE])
def test_moe_block_under_grad_below_the_a2a_rule(runs, tag):
    """The one-hot path across ranks under grad: every rank's output rows
    and lb as the reference's, the gradient of its rows of x, and each
    leaf's block of the gradients as the train step reduces them (summed
    over the batch axes the leaf is not stored over, over their size)."""
    _, ref, ranks, _ = runs
    shape = next(c[1] for c in MOE if c[0] == tag)
    got = [r[tag] for r in ranks[:int(np.prod(shape))]]
    for res in got:
        rows = slice(*res["rows"])
        _close(res["y_grad_run"], ref[f"{tag}/y"][rows], f"{tag} y")
        assert abs(res["lb"].item() - float(ref[f"{tag}/lb"])) <= 1e-6
        _close(res["gx"], ref[f"{tag}/gx"][rows], f"{tag} x gradient")
        for k, g in res["grads"].items():
            _close(g, ref[f"{tag}/grads/{k}"][_blk(res["slices"][k])],
                   f"{tag} gradient {k}")


def _whole_state(res: dict, data: dict, arch: str) -> dict:
    """The whole train state assembled from every rank's blocks."""
    flat = {}
    for r in res:
        for k, t in r["state"].items():
            if k.startswith("params/"):
                leaf, sl = k[len("params/"):], r["slices"][k[len("params/"):]]
            elif k.startswith("opt/") and k != "opt/step":
                leaf = k.split("/", 2)[2]
                sl = r["opt_slices"][k[len("opt/"):]]
            else:
                flat[k] = t
                continue
            shape = data[f"{arch}/{leaf}"].shape
            flat.setdefault(k, torch.empty(shape, dtype=t.dtype))
            flat[k][_blk(sl)] = t
    return flat


def test_multi_pod_save_is_the_whole_save_and_restores(runs, tmp_path):
    """(c): the sharded save of olmoe's ZeRO-1 state on (2, 2, 1) has the
    bytes of ``save_checkpoint`` of the whole state (assembled from the
    ranks' blocks) on one rank; it restores whole onto one rank, and
    with ``shardings=`` onto the mesh each rank's local blocks are its
    blocks bit for bit and ``full_tensor()`` of each (over the permuted
    ``DeviceMesh`` where the expert leaves' ``("data", "pod")`` asks for
    one) is the whole leaf."""
    data, _, ranks, root = runs
    res = [r["olmoe_221"] for r in ranks]
    flat = _whole_state(res, data, "olmoe-1b-7b")
    whole = save_checkpoint(str(tmp_path / "whole"), 1, unflatten(flat))
    sharded = os.path.join(root, "olmoe_221", f"step_{1:010d}")
    for f in ("data.bin", "manifest.json"):
        with open(os.path.join(whole, f), "rb") as a, \
                open(os.path.join(sharded, f), "rb") as b:
            assert a.read() == b.read(), f
    back, step = restore_checkpoint(os.path.join(root, "olmoe_221"),
                                    unflatten(flat), device="cpu")
    assert step == 1
    for k, t in tree_leaves(back):
        assert torch.equal(t, flat[k]), k
    for r in res:
        for k, t in r["state"].items():
            assert torch.equal(r["restored_local"][k], t), k
            assert torch.equal(r["restored_full"][k], flat[k]), k
    pl = res[0]["placements"]["params/blocks/b0_moe/moe/wi"]
    assert pl == (("Shard(dim=2)", "Shard(dim=2)", "Shard(dim=1)"),
                  ("data", "pod", "model"))


@pytest.mark.parametrize("name", [c[0] for c in DECODE])
def test_decode_under_the_multi_pod_rules(runs, name):
    """(d): every rank's greedy tokens and each step's logits as the
    reference's, its cache rows split over ``("pod", "data")``, and
    ``generate`` on the mesh gives the same tokens."""
    _, ref, ranks, _ = runs
    s_max = next(c[4] for c in DECODE if c[0] == name)
    for r in ranks:
        res = r[name]
        np.testing.assert_array_equal(res["tokens"].numpy(),
                                      ref[f"{name}/tokens"])
        for t in range(s_max):
            _close(res["logits"][t], ref[f"{name}/logits{t}"],
                   f"{name} logits {t}", DECODE_TOL)
        assert res["batch_axes"] == ("pod", "data")
        assert torch.equal(res["generate"], res["tokens"])


def test_captured_step_raises_on_the_gloo_mesh(runs):
    """A captured serve step on the gloo mesh raises (gloo's collectives
    run on the host)."""
    _, _, ranks, _ = runs
    for r in ranks:
        for name, *_ in DECODE:
            assert "gloo" in (r[name]["captured_raised"] or "")


def test_gather_over_data_pod_is_data_major(runs):
    """(e): block ``i`` of the gathered tensor is the block of the rank at
    named position ``i`` of ``("data", "pod")``; the reduce-scatter gives
    each rank the four ranks' summed gradient of its block, ``split`` its
    block, the stacked gather every block in that order.  The same
    gather in global-rank order (pod-major) differs from the whole."""
    _, _, ranks, _ = runs
    whole = torch.arange(8 * 3, dtype=torch.float32).view(8, 3)
    w = whole * 0.5 + 1
    members = [dict(data=d, pod=p, model=0)
               for d, p in itertools.product(range(2), range(2))]
    for rank, r in enumerate(ranks):
        res = r["order"]
        c = _coord(ORDER_MESH, rank)
        assert res["coordinate"] == c
        i = c["data"] * 2 + c["pod"]
        assert res["group_rank"] == i
        assert torch.equal(res["block"], whole[2 * i:2 * i + 2])
        assert torch.equal(res["gathered"], whole)
        assert torch.equal(res["grad"], 4 * w[2 * i:2 * i + 2])
        assert torch.equal(res["split"], whole[2 * i:2 * i + 2])
        assert torch.equal(res["stacked"], whole.view(4, 2, 3))
        assert res["members"] == members
        assert not torch.equal(res["mutated"], whole)


def test_moments_are_a_block_of_the_parameter_block(runs):
    """ZeRO-1 under the multi-pod rules: olmoe's moments of ``embed`` and
    of the attention's ``d`` dims are split four ways over ``("data",
    "pod")``, so each rank's moments are a quarter of its parameter
    block's bytes there."""
    data, _, ranks, _ = runs
    for r in ranks:
        res = r["olmoe_221"]
        for k in ("embed", "blocks/b0_moe/attn/wq"):
            p, m = res["params"][k], res["opt"][f"m/{k}"]
            assert 4 * m.numel() == p.numel(), k
    assert Mesh((2, 2, 1), POD_AXES).shape == {"pod": 2, "data": 2,
                                               "model": 1}
