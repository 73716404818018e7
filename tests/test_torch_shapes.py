"""The port's ``configs/shapes.py`` against the reference's, on the CPU.

The shape cells and ``applicable`` over every arch and cell; the global
shapes and dtypes of ``train_inputs`` / ``serve_inputs`` against the
reference's ``ShapeDtypeStruct``s; and under a (2, 2) (data, model)
context with each arch's storage rules (``launch.dryrun.rules_for``),
every stand-in's spec and each rank's block against the reference's
``NamedSharding`` and its ``shard_shape`` (over an ``AbstractMesh``, so
no device is needed).  Exact: these are shapes and names.
"""

import dataclasses
import itertools
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import shapes as JS  # noqa: E402
from repro.distributed.context import activate as jax_activate  # noqa: E402
from repro.launch.dryrun import rules_for as jax_rules_for  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs import shapes as TS  # noqa: E402
from repro_torch.distributed.context import Mesh, activate  # noqa: E402
from repro_torch.distributed.context import active_ctx  # noqa: E402
from repro_torch.launch.dryrun import rules_for  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402

ARCHS = list_archs()
MESH = ((2, 2), ("data", "model"))


def _jleaves(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in leaves}


def _inputs(pkg, cfg, cell) -> dict:
    """Every stand-in of one cell by key: the batch's, then the cache's,
    the token and the position (decode cells)."""
    if cell.kind == "decode":
        cache, token, pos = pkg.serve_inputs(cfg, cell)
        tree = {"cache": cache, "token": token, "pos": pos}
    else:
        tree = {"batch": pkg.train_inputs(cfg, cell)}
    return (dict(tree_leaves(tree)) if pkg is TS else _jleaves(tree))


def test_shape_cells_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in TS.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JS.SHAPES.items()}
    assert (TS.WHISPER_MEMORY_LEN, TS.VLM_PATCHES) == \
        (JS.WHISPER_MEMORY_LEN, JS.VLM_PATCHES)


@pytest.mark.parametrize("arch", ARCHS)
def test_applicable_matches_reference(arch):
    for name in TS.SHAPES:
        assert TS.applicable(get_config(arch), TS.SHAPES[name]) == \
            JS.applicable(jax_get_config(arch), JS.SHAPES[name]), name
    # the reference's own case list (tests/test_models_smoke.py)
    ok = TS.applicable(get_config(arch), TS.SHAPES["long_500k"])[0]
    assert ok == (arch in ("zamba2-7b", "xlstm-125m", "gemma3-1b"))


@pytest.mark.parametrize("arch", ARCHS)
def test_inputs_match_reference_shapes_and_dtypes(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in TS.SHAPES:
        got = _inputs(TS, cfg, TS.SHAPES[name])
        want = _inputs(JS, jcfg, JS.SHAPES[name])
        assert got.keys() == want.keys(), name
        for k, t in got.items():
            assert t.device.type == "meta", k
            assert t.sharding is None, k
            assert tuple(t.shape) == tuple(want[k].shape), (name, k)
            assert str(t.dtype).removeprefix("torch.") == \
                np.dtype(want[k].dtype).name, (name, k)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "whisper-large-v3",
                                  "llama-3.2-vision-11b", "zamba2-7b",
                                  "olmoe-1b-7b"])
def test_blocks_under_a_2x2_context_match_the_shard_shape(arch, monkeypatch):
    """Each stand-in's spec is the reference's sharding's, and every rank's
    block (``ShardingCtx.block``, at each coordinate of the mesh) has the
    reference's ``shard_shape``; the distinct blocks tile the leaf."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    jmesh = AbstractMesh(*MESH)
    for name in ("train_4k", "decode_32k"):
        with jax_activate(jmesh, jax_rules_for(jcfg, False)[1]):
            want = _inputs(JS, jcfg, JS.SHAPES[name])
        with activate(Mesh(*MESH), rules_for(cfg, False)[1]):
            got = _inputs(TS, cfg, TS.SHAPES[name])
            for k, t in got.items():
                j = want[k]
                if j.sharding is None:      # the position
                    assert t.sharding is None, k
                    continue
                assert tuple(t.sharding.spec) == tuple(j.sharding.spec), k
                blocks = set()
                for coord in itertools.product(range(2), range(2)):
                    monkeypatch.setattr(
                        Mesh, "coordinate",
                        lambda self, c=coord: dict(zip(MESH[1], c)))
                    ctx = active_ctx()
                    ctx.memo.clear()
                    block = ctx.block(t.logical, tuple(t.shape))
                    size = tuple(s.stop - s.start for s in block)
                    assert size == tuple(j.sharding.shard_shape(j.shape)), \
                        (name, k, coord)
                    blocks.add(tuple((s.start, s.stop) for s in block))
                # the distinct blocks are disjoint and cover the leaf
                assert sum(math.prod(b - a for a, b in blk)
                           for blk in blocks) == math.prod(t.shape), k
                for x, y in itertools.combinations(blocks, 2):
                    assert any(b1 <= a2 or b2 <= a1 for (a1, b1), (a2, b2)
                               in zip(x, y)), k
