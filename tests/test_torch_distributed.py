"""The port's sharding context and device meshes against the JAX
reference's, and the sharded restore on spawned ranks.

- Spec parity (in process): ``ShardingCtx.spec`` (with and without
  divisibility masking) and ``ShardingRules.resolve`` equal the
  reference's for every leaf of every arch's full-size ``model_specs``,
  under the default rules, ``expert_mlp="data"``, gemma3 / xlstm's
  ``qheads/kv_heads=None`` and ``dryrun.rules_for``'s FSDP storage
  overrides, on meshes (1, 1), (2, 2), (1, 4), (4, 1), 16 x 16 and
  2 x 16 x 16.  JAX's side uses ``AbstractMesh``, the port's a shape-only
  ``Mesh``: no devices.
- Per-rank slices: ``Mesh.local_slices`` at every coordinate equals
  ``NamedSharding(...).devices_indices_map`` for the device there (the
  reference in one process with 512 forced host devices,
  ``tests/jax_dist_ref.py``); DTensor placements express every spec, over
  a permuted dim order where a tuple entry is out of mesh order.
- ``plan_for_ctx`` equals the reference's with ``jax.process_index`` (and
  the port's ``process_index``) patched per rank.
- Sharded restore (spawned gloo ranks, ``tests/torch_ranks.py``): a
  reduced olmoe checkpoint over two loopback mirrors with
  ``shardings=sharding_tree(...)`` on (2, 2) and (1, 4): every local shard
  is its block of the saved leaf, bit for bit, and so is ``full_tensor()``;
  each rank copies out only its blocks' bytes, never a whole split leaf.
"""

import itertools
import os

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JaxP

import repro.configs as jax_configs
import repro.distributed.context as J
import repro.transfer.shard as jax_shard
import repro_torch.distributed.context as T
import repro_torch.transfer.shard as port_shard
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.models.common import ParamSpec, tree_leaves
from repro_torch.models.transformer import model_specs
from repro_torch.weights import unflatten
from torch_loopback import loopback, no_thread_left  # noqa: F401
from torch_ranks import collect_reference, run_ranks, spawn_reference

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RULES = ("default", "expert_mlp_data", "heads_none", "fsdp_storage")
_FSDP_ARCHS = ("qwen2.5-14b", "whisper-large-v3", "kimi-k2-1t-a32b")


def _overrides(rules: str, arch: str, names) -> dict:
    """The rule sets as data; ``fsdp_storage`` is ``dryrun.rules_for``'s
    storage rules for ``arch`` (that module forces host devices when it is
    imported, so its overrides are written out here)."""
    if rules == "default":
        return {}
    if rules == "expert_mlp_data":
        return {"expert_mlp": "data"}
    if rules == "heads_none":
        return {"qheads": None, "kv_heads": None}
    data_axes = ("data", "pod") if "pod" in names else ("data",)
    kw = {}
    if get_config(arch).family == "moe":
        kw["expert_mlp"] = data_axes
    if arch.startswith(("gemma3", "xlstm")):
        kw.update(qheads=None, kv_heads=None)
    if get_config(arch).name in _FSDP_ARCHS:
        kw.update(attn_in=data_axes, attn_out_d=data_axes, embed=data_axes)
    return kw


def _ctxs(mesh: str, rules: str, arch: str):
    sizes, names = MESHES[mesh]
    kw = _overrides(rules, arch, names)
    port = T.ShardingCtx(T.Mesh(sizes, names),
                         T.ShardingRules().override(**kw))
    ref = J.ShardingCtx(AbstractMesh(sizes, names),
                        J.ShardingRules().override(**kw))
    return port, ref


def _leaves(arch):
    return tree_leaves(model_specs(get_config(arch)))


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_and_resolve_match_the_reference(mesh, rules):
    n = 0
    for arch in list_archs():
        port, ref = _ctxs(mesh, rules, arch)
        for key, s in _leaves(arch):
            for shape in (s.shape, None):
                want = tuple(ref.spec(s.logical, shape))
                got = port.spec(s.logical, shape)
                assert isinstance(got, T.PartitionSpec)
                assert tuple(got) == want, (arch, key, shape)
            assert tuple(port.rules.resolve(s.logical, port.axes)) == tuple(
                ref.rules.resolve(s.logical, ref.axes)), (arch, key)
            n += 1
    assert n > 300


def test_the_port_reads_the_reference_rules():
    assert T.DEFAULT_RULES == J.DEFAULT_RULES
    assert set(list_archs()) == set(jax_configs.list_archs())


def _spec_cases():
    """Every distinct (mesh, spec, shape) of the parity sweep."""
    seen = {}
    for mesh, rules in itertools.product(MESHES, RULES):
        for arch in list_archs():
            port, _ = _ctxs(mesh, rules, arch)
            for _, s in _leaves(arch):
                spec = port.spec(s.logical, s.shape)
                seen.setdefault((mesh, spec, tuple(s.shape)), None)
    return list(seen)


@pytest.fixture(scope="module")
def jax_slices(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slices")
    cases = _spec_cases()
    args = [[list(MESHES[m][0]), list(MESHES[m][1]),
             [list(e) if isinstance(e, tuple) else e for e in spec],
             list(shape)] for m, spec, shape in cases]
    ref = collect_reference(spawn_reference(
        "slices", 512, tmp, os.path.join(str(tmp), "none.npz"), cases=args))
    return cases, ref


@pytest.mark.parametrize("mesh", list(MESHES))
def test_each_ranks_slice_matches_the_reference_device(jax_slices, mesh):
    cases, ref = jax_slices
    sizes, names = MESHES[mesh]
    m = T.Mesh(sizes, names)
    coords = list(itertools.product(*(range(n) for n in sizes)))
    n = 0
    for i, (which, spec, shape) in enumerate(cases):
        if which != mesh:
            continue
        want = ref[f"case{i}"]
        for dev, coord in enumerate(coords):
            got = m.local_slices(spec, shape, dict(zip(names, coord)))
            assert [(sl.start, sl.stop) for sl in got] == \
                [tuple(r) for r in want[dev]], (spec, shape, coord)
        n += 1
    assert n > 0


def _dtensor_block(pl, shape, coord) -> tuple:
    """The block DTensor gives the rank at ``coord`` for placements
    ``pl`` over dims ``pl.axes``: a tensor dim sharded over several mesh
    dims is cut by the earlier dim first (major)."""
    from torch.distributed.tensor import Shard

    out = []
    for dim, n in enumerate(shape):
        idx, parts = 0, 1
        for a, p in zip(pl.axes, pl):
            if isinstance(p, Shard) and p.dim == dim:
                idx = idx * pl.mesh.shape[a] + coord[a]
                parts *= pl.mesh.shape[a]
        out.append(slice(idx * n // parts, (idx + 1) * n // parts))
    return tuple(out)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_placements_express_the_spec_or_raise(mesh):
    """Every leaf's placements express its spec: a ``Shard`` of a dim on
    each mesh axis its entry names, over a dim order (``Placements.axes``)
    in which every tuple entry's axes come as it names them -- the mesh's
    own order, or a permutation of it where an entry is out of mesh order
    (the multi-pod rules' ``("data", "pod")``).  The block DTensor then
    cuts for a rank is ``Mesh.local_slices``' (the corners of the mesh and
    a few coordinates between them)."""
    from torch.distributed.tensor import Replicate, Shard

    sizes, names = MESHES[mesh]
    coords = list(itertools.product(*(range(n) for n in sizes)))
    coords = [dict(zip(names, c)) for c in coords[::max(len(coords) // 7,
                                                        1)] + coords[-1:]]
    permuted = 0
    for rules, arch in itertools.product(RULES, list_archs()):
        port, _ = _ctxs(mesh, rules, arch)
        for key, s in _leaves(arch):
            spec = port.spec(s.logical, s.shape)
            entries = [e if isinstance(e, tuple) else (e,) for e in spec]
            pl = port.sharding(s.logical, s.shape)
            assert pl.spec == spec and pl.mesh is port.mesh
            assert len(pl) == len(names) and sorted(pl.axes) == sorted(names)
            for e in entries:
                if e != (None,):
                    assert [a for a in pl.axes if a in e] == list(e)
            permuted += pl.axes != names
            for i, a in enumerate(pl.axes):
                dims = [d for d, e in enumerate(entries) if a in e]
                assert pl[i] == (Shard(dims[0]) if dims else Replicate())
            for c in coords:
                assert _dtensor_block(pl, s.shape, c) == \
                    port.mesh.local_slices(spec, s.shape, c), (key, c)
    assert (permuted > 0) == (mesh == "2x16x16")


def test_an_out_of_order_tuple_raises_for_placements_only():
    """``("data", "pod")`` on a (pod, data, model) mesh: JAX takes data as
    major, and so do the slices and the placements, whose dims put data
    before pod; on a shape-only mesh they have no ``DeviceMesh``."""
    from torch.distributed.tensor import Shard

    port, ref = _ctxs("2x16x16", "fsdp_storage", "olmoe-1b-7b")
    s = dict(_leaves("olmoe-1b-7b"))["blocks/b0_moe/moe/wi"]
    spec = port.spec(s.logical, s.shape)
    assert spec[2] == ("data", "pod")
    pl = port.sharding(s.logical, s.shape)
    assert pl.axes == ("data", "pod", "model")
    assert tuple(pl) == (Shard(2), Shard(2), Shard(1))
    assert pl.device_mesh is None
    coord = {"pod": 1, "data": 2, "model": 0}
    got = port.mesh.local_slices(spec, s.shape, coord)
    step = s.shape[2] // 32
    assert got[2] == slice((2 * 2 + 1) * step, (2 * 2 + 2) * step)
    assert _dtensor_block(pl, s.shape, coord) == got


@pytest.mark.parametrize("mesh", ["2x2", "1x4", "16x16", "2x16x16"])
@pytest.mark.parametrize("rank", [0, 1, 3, 255])
def test_plan_for_ctx_matches_the_reference(mesh, rank, monkeypatch):
    import jax

    sizes, names = MESHES[mesh]
    port, ref = _ctxs(mesh, "default", "qwen3-1.7b")
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(T, "process_index", lambda: rank)
    def flat(host_plan):
        host, plan = host_plan
        return host, plan.total, plan.spans

    for total, bounds in ((1 << 20, None), (12345, (100, 5000, 9000))):
        want = flat(jax_shard.plan_for_ctx(total, boundaries=bounds, ctx=ref))
        assert flat(port_shard.plan_for_ctx(total, boundaries=bounds,
                                            ctx=port)) == want
        with T.activate(port.mesh):
            assert flat(port_shard.plan_for_ctx(total,
                                                boundaries=bounds)) == want


def test_without_a_context_everything_is_a_no_op():
    x = torch.ones(3)
    assert T.active_ctx() is None
    assert T.constrain(x, "batch") is x
    assert T.logical_to_spec(("batch",)) == T.PartitionSpec() == ()
    assert T.named_sharding(("batch",)) is None
    assert T.process_index() == 0
    with pytest.raises(RuntimeError, match="no active sharding context"):
        port_shard.plan_for_ctx(100)
    with T.activate(T.Mesh((2, 2), ("data", "model"))) as ctx:
        assert T.active_ctx() is ctx
        assert T.logical_to_spec(("batch", "mlp")) == JaxP("data", "model")
        assert T.constrain(x, "batch") is x
    assert T.active_ctx() is None


def test_local_meshes_need_a_process_group():
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_local_mesh(2, 2, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_production_mesh(device="cpu")


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=str)
def test_sharded_restore_lands_each_ranks_block(tmp_path, loopback, shape):
    arch = "olmoe-1b-7b"
    specs = model_specs(reduced_config(arch))
    rng = np.random.default_rng(7)
    saved = {k: torch.from_numpy(rng.standard_normal(s.shape).astype(
        np.float32)).to(torch.bfloat16) for k, s in tree_leaves(specs)}
    d = save_checkpoint(str(tmp_path / "ckpt"), 3, unflatten(saved))
    ports = [loopback.checkpoint(d, 3).port for _ in range(2)]
    ranks = run_ranks("restore", 4, tmp_path, root=str(tmp_path / "ckpt"),
                      step=3, ports=ports, arch=arch, shape=list(shape),
                      fsdp=True)
    port = T.ShardingCtx(T.Mesh(shape, ("data", "model")),
                         T.ShardingRules().override(expert_mlp="data"))
    for r in ranks:
        assert r["step"] == 3
        coord = dict(zip(("data", "model"), r["coordinate"]))
        assert r["coordinate"] == (r["rank"] // shape[1], r["rank"] % shape[1])
        assert r["host"] == r["rank"] % r["n_hosts"]
        assert r["n_hosts"] == shape[0]
        assert "needs 256 ranks" in r["production_error"]
        for k, s in tree_leaves(specs):
            spec = port.spec(s.logical, s.shape)
            block = port.mesh.local_slices(spec, s.shape, coord)
            want = saved[k][block]
            for got in (r["local"][k], r["redistributed"][k]):
                assert got.dtype == torch.bfloat16
                assert torch.equal(got, want), k
            assert torch.equal(r["full"][k], saved[k]), k
        assert torch.equal(r["constrained"], saved["embed"])
        # the restore copied out this rank's blocks and nothing more: a
        # split leaf's other blocks never leave the landing buffer
        assert r["landed_bytes"] == sum(
            t.numel() * t.element_size() for t in r["local"].values())
    total = sum(t.numel() * t.element_size() for t in saved.values())
    assert all(r["landed_bytes"] < total for r in ranks)
    # the expert stacks really split: (2, 2) over model and data, (1, 4)
    # over model
    wi = ranks[-1]["local"]["blocks/b0_moe/moe/wi"]
    full = saved["blocks/b0_moe/moe/wi"].shape
    assert wi.shape[1] == full[1] // shape[1]
    assert wi.shape[2] == full[2] // shape[0]


def test_restore_without_shardings_is_unchanged(tmp_path):
    from repro_torch.checkpoint import restore_checkpoint

    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)}}
    save_checkpoint(str(tmp_path), 1, tree)
    like = {"a": ParamSpec((2, 3), (None, None)),
            "b": {"c": ParamSpec((4,), (None,))}}
    out, _ = restore_checkpoint(str(tmp_path), like, device="cpu",
                                shardings={"a": None, "b": {"c": None}})
    assert torch.equal(out["a"], tree["a"]) and type(out["a"]) is torch.Tensor
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
