"""Decode under a mesh for every family: the port's serving step on gloo
ranks under ``launch.dryrun.serve_rules`` against the JAX reference's
GSPMD decode on the same mesh.

The rules are the reference's for a ``decode`` cell (``run_cell``):
``rules_for`` of the registry arch, then ``decode_rules`` at the cell's
batch and model size.  The port's ranks hold their blocks of the
parameters and, from ``init_cache`` under the context, only their block
of the cache; the reference jits ``repro.models.transformer.
decode_step`` under ``activate`` on forced host devices.  Each case
teacher-forces a prompt and decodes greedily to S_max tokens (reduced
configs at f32, weights and prompts drawn with numpy, zero- and one-init
leaves set off their init so that no path hides).  Held, on every rank:
each step's logits within 1e-5 of their largest entry, the greedy tokens
equal (through ``make_serve_step`` and ``generate(capture=False)``), and
the rank's cache block equal to the reference's whole cache cut to that
block after every step.

The cases cover the four cache layouts of ``decode_rules`` (KV the KV
heads, M the model axis): (a) B <= 8 with KV % M == 0, the cache split by
sequence over ``data`` where the batch does not split (B 1) and by batch
where it does; (b) B <= 8 with KV % M != 0, split by sequence over
``model`` with every KV head on each rank (query heads gathered for the
attention); (c) B > 8 with KV % M != 0; (d) B > 8 with KV % M == 0.
gemma3 crosses its window of 16 over every block boundary; qwen2.5 and
kimi store their dense leaves FSDP; olmoe and kimi route through the
one-hot MoE path across ranks at capacities that drop pairs.  Five cases
(qwen3, kimi, zamba2, xlstm, whisper) save their blocks as a sharded
checkpoint and serve it again from ``restore_checkpoint(shardings=)``,
against the unsharded restore.

zamba2 and xlstm decode with their recurrent states cut to a rank's
block, held after every step like the KV leaves: zamba2 on (1, 2) (Mamba2
``h`` over its SSM heads, ``conv`` over ``d_inner``, the shared block's KV
heads over ``model``), on (2, 2) at B 1 (the shared block's keys over
``data``: the partials path), on (1, 4) (its 2 SSM heads do not tile:
``h`` whole, ``conv`` cut over ``d_inner`` and gathered for the step) and
on (2, 1) (every state cut over ``data`` by batch rows); xlstm, whose
cache has no KV leaf (the step finds its rows from the global batch), on
(1, 2) (the mLSTM's ``d_in`` over ``model``, its states whole), (2, 2)
and (2, 1) (states cut by batch rows).

whisper and llama-vision decode against the memory ``encode`` makes of 12
frames or patches (the reference's encoder or patch projection on its
side), each rank's cache holding its batch rows of it: whisper on (2, 2)
at B 1 (FSDP storage, the keys over ``data``: the partials path) and on
(1, 2); llama-vision on (2, 2) (batch rows over ``data``) and on (1, 4)
(its 2 KV heads whole, the keys over ``model``); their cross-attention on
a rank's heads.

In process: the partials mode's plain versions, cut into blocks at random
offsets and merged, against the whole-cache plain version (and at one
block, bit for bit against the split-K arithmetic); the layouts pinned
from the specs; rules that split the mLSTM's or sLSTM's heads, and the
one-hot path under grad on a mesh of more than one rank, raise naming
ROADMAP.
"""

import math
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.distributed import Mesh, activate
from repro_torch.distributed.context import KV_CACHE_LOGICAL, ShardingCtx
from repro_torch.kernels.decode_attention.ops import (
    decode_attention_merge_plain, decode_attention_partials_plain,
    decode_attention_plain, decode_attention_splitk_plain)
from repro_torch.launch import dryrun
from repro_torch.models import moe
from repro_torch.models.common import init_params, tree_leaves
from repro_torch.models.transformer import (decode_step, init_cache,
                                            model_specs)
from repro_torch.weights import unflatten
from test_torch_dp_train import numpy_params
from torch_ranks import (collect, collect_reference, spawn_ranks,
                         spawn_reference)

TOL = 1e-5
#: reduced zamba2 amplifies f32 rounding: its weights moved by 1e-7 of
#: themselves move the unsharded step's logits by 4.3e-5 of their largest
#: entry from the reference's, so its cases hold logits and states here
ZAMBA2_TOL = 1e-4
#: name, arch, D, M, B, S_max, prompt_len, capacity factor, sharded save
CASES = [
    ("qwen3_1x2_b16", "qwen3-1.7b", 1, 2, 16, 16, 4, 1.25, False),
    ("qwen3_2x2_b1", "qwen3-1.7b", 2, 2, 1, 16, 4, 1.25, True),
    ("qwen3_2x2_b4", "qwen3-1.7b", 2, 2, 4, 16, 4, 1.25, False),
    ("qwen3_1x4_b4", "qwen3-1.7b", 1, 4, 4, 16, 4, 1.25, False),
    ("qwen3_1x4_b16", "qwen3-1.7b", 1, 4, 16, 16, 4, 1.25, False),
    ("gemma3_1x2_b4", "gemma3-1b", 1, 2, 4, 40, 8, 1.25, False),
    ("gemma3_1x4_b4", "gemma3-1b", 1, 4, 4, 40, 8, 1.25, False),
    ("qwen25_2x2_b1", "qwen2.5-14b", 2, 2, 1, 16, 4, 1.25, False),
    ("nemotron_1x4_b2", "nemotron-4-15b", 1, 4, 2, 16, 4, 1.25, False),
    ("olmoe_2x2_b4", "olmoe-1b-7b", 2, 2, 4, 16, 4, 1.0, False),
    ("olmoe_1x4_b16", "olmoe-1b-7b", 1, 4, 16, 16, 4, 1.0, False),
    ("kimi_2x2_b1", "kimi-k2-1t-a32b", 2, 2, 1, 16, 4, 1.0, True),
    ("kimi_2x2_b4", "kimi-k2-1t-a32b", 2, 2, 4, 16, 4, 1.0, False),
    ("zamba2_1x2_b4", "zamba2-7b", 1, 2, 4, 8, 3, 1.25, True),
    ("zamba2_2x2_b1", "zamba2-7b", 2, 2, 1, 8, 3, 1.25, False),
    ("zamba2_1x4_b4", "zamba2-7b", 1, 4, 4, 8, 3, 1.25, False),
    ("zamba2_2x1_b4", "zamba2-7b", 2, 1, 4, 8, 3, 1.25, False),
    ("xlstm_1x2_b4", "xlstm-125m", 1, 2, 4, 8, 3, 1.25, False),
    ("xlstm_2x2_b4", "xlstm-125m", 2, 2, 4, 8, 3, 1.25, True),
    ("xlstm_2x1_b4", "xlstm-125m", 2, 1, 4, 8, 3, 1.25, False),
    ("whisper_2x2_b1", "whisper-large-v3", 2, 2, 1, 8, 3, 1.25, True),
    ("whisper_1x2_b4", "whisper-large-v3", 1, 2, 4, 8, 3, 1.25, False),
    ("vision_2x2_b4", "llama-3.2-vision-11b", 2, 2, 4, 8, 3, 1.25, False),
    ("vision_1x4_b4", "llama-3.2-vision-11b", 1, 4, 4, 8, 3, 1.25, False),
]
NAMES = [c[0] for c in CASES]
BY_NAME = {c[0]: c for c in CASES}
ARCHS = sorted({c[1] for c in CASES})
REF_PROCS = 3
#: the layout each case is meant to exercise: (decode_rules case, the
#: axes the cache's batch, keys and KV heads split over)
LAYOUTS = {
    "qwen3_1x2_b16": ("d", (), (), ("model",)),
    "qwen3_2x2_b1": ("a", (), ("data",), ("model",)),
    "qwen3_2x2_b4": ("a", ("data",), (), ("model",)),
    "qwen3_1x4_b4": ("b", (), ("model",), ()),
    "qwen3_1x4_b16": ("c", (), ("model",), ()),
    "gemma3_1x2_b4": ("b", (), ("model",), ()),
    "gemma3_1x4_b4": ("b", (), ("model",), ()),
    "qwen25_2x2_b1": ("a", (), ("data",), ("model",)),
    "nemotron_1x4_b2": ("b", (), ("model",), ()),
    "olmoe_2x2_b4": ("a", ("data",), (), ("model",)),
    "olmoe_1x4_b16": ("d", (), (), ("model",)),
    "kimi_2x2_b1": ("a", (), ("data",), ("model",)),
    "kimi_2x2_b4": ("a", ("data",), (), ("model",)),
    "zamba2_1x2_b4": ("a", (), (), ("model",)),
    "zamba2_2x2_b1": ("a", (), ("data",), ("model",)),
    "zamba2_1x4_b4": ("a", (), (), ("model",)),
    "zamba2_2x1_b4": ("a", ("data",), (), ()),
    "whisper_2x2_b1": ("a", (), ("data",), ("model",)),
    "whisper_1x2_b4": ("a", (), (), ("model",)),
    "vision_2x2_b4": ("a", ("data",), (), ("model",)),
    "vision_1x4_b4": ("b", (), ("model",), ()),
}
#: the memory rows of the encdec and vlm cases (frames / patches), and
#: the stub input each family's memory comes from
MEMORY_LEN = 12
STUB = {"encdec": "frames", "vlm": "patches"}
#: the cases with KV leaves
KV_NAMES = [n for n in NAMES if n in LAYOUTS]
#: the recurrent states each case is meant to cut: per leaf, the parts
#: each dim is cut into (batch first; a stacked leaf's layers left out)
STATE_PARTS = {
    "zamba2_1x2_b4": {"mamba/h": (1, 2, 1, 1), "mamba/conv": (1, 1, 2)},
    "zamba2_2x2_b1": {"mamba/h": (1, 2, 1, 1), "mamba/conv": (1, 1, 2)},
    "zamba2_1x4_b4": {"mamba/h": (1, 1, 1, 1), "mamba/conv": (1, 1, 4)},
    "zamba2_2x1_b4": {"mamba/h": (2, 1, 1, 1), "mamba/conv": (2, 1, 1)},
}
for _name, _b in (("xlstm_1x2_b4", 1), ("xlstm_2x2_b4", 2),
                  ("xlstm_2x1_b4", 2)):
    STATE_PARTS[_name] = {"mlstm/C": (_b, 1, 1, 1), "mlstm/n": (_b, 1, 1),
                          "mlstm/m": (_b, 1), **{f"slstm/{k}": (_b, 1, 1)
                                                 for k in "cnhm"}}


def _cfg(name):
    _, arch, _, _, _, _, _, cf, _ = BY_NAME[name]
    return reduced_config(arch).replace(dtype="float32", capacity_factor=cf)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("decode_mesh")
    rng = np.random.default_rng(25)
    # the encdec and vlm cases draw from their own generator: the other
    # cases keep their inputs
    cross = np.random.default_rng(29)
    data = {}
    for arch in ARCHS:
        g = cross if reduced_config(arch).family in STUB else rng
        cfg = reduced_config(arch).replace(dtype="float32")
        for k, s in tree_leaves(model_specs(cfg)):
            v = numpy_params({k: s}, g)[k]
            if s.init in ("zeros", "ones"):     # off the init: no path hides
                v = v + 0.1 * g.standard_normal(v.shape).astype(np.float32)
            data[f"{arch}/{k}"] = v
    for name, arch, B, prompt_len in [(c[0], c[1], c[4], c[6])
                                      for c in CASES]:
        cfg = reduced_config(arch)
        g = cross if cfg.family in STUB else rng
        data[f"prompt/{name}"] = g.integers(
            0, cfg.vocab_size, (B, prompt_len)).astype(np.int64)
        if cfg.family in STUB:
            data[f"{STUB[cfg.family]}/{name}"] = g.standard_normal(
                (B, MEMORY_LEN, cfg.frontend_dim)).astype(np.float32)
    inputs = os.path.join(str(tmp), "inputs.npz")
    np.savez(inputs, **data)
    cases = [list(c) for c in CASES]
    refs = [spawn_reference("decode", 4, tmp, inputs,
                            cases=[c[:8] for c in cases[i::REF_PROCS]])
            for i in range(REF_PROCS)]
    two = spawn_ranks("decode", 2, tmp, inputs=inputs, cases=cases,
                      root=str(tmp))
    four = spawn_ranks("decode", 4, tmp, inputs=inputs, cases=cases,
                       root=str(tmp))
    ranks = {}
    for res in collect(two, 240.0) + collect(four, 240.0):
        for name, r in res.items():
            ranks.setdefault(name, []).append(r)
    ref = {}
    for r in refs:
        ref.update(collect_reference(r))
    return data, ref, ranks, str(tmp)


def _close(got: torch.Tensor, want: np.ndarray, what: str,
           tol: float = TOL) -> None:
    peak = float(np.abs(want).max())
    err = float(np.abs(got.numpy() - want).max())
    assert got.shape == want.shape and err <= tol * max(peak, 1e-30), (
        f"{what}: off by {err}, largest entry {peak}")


def _tol(name: str) -> float:
    return ZAMBA2_TOL if BY_NAME[name][1] == "zamba2-7b" else TOL


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_the_reference(runs, name):
    _, ref, ranks, _ = runs
    _, _, D, M, _, s_max, _, _, _ = BY_NAME[name]
    assert len(ranks[name]) == D * M
    want_toks = ref[f"{name}/tokens"]
    for r in ranks[name]:
        for t in range(s_max):
            _close(r["logits"][t], ref[f"{name}/logits{t}"],
                   f"{name} step {t} logits", _tol(name))
        np.testing.assert_array_equal(r["tokens"].numpy(), want_toks)
        assert torch.equal(r["generate"], r["tokens"])


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_holds_its_cache_block(runs, name):
    """Every rank's cache leaves are its block only (the whole cache cut
    as the layout says), equal to the reference's whole cache cut to that
    block after every step; the layout is the one the case is for: the KV
    leaves' (``LAYOUTS``), the recurrent states' (``STATE_PARTS``), and
    the ranks' blocks of each leaf tile it."""
    _, ref, ranks, _ = runs
    _, _, D, M, B, s_max, _, _, _ = BY_NAME[name]
    cfg = _cfg(name)
    covered = {}
    for r in ranks[name]:
        if name in LAYOUTS:
            _, rows_axes, seq_axes, head_axes = LAYOUTS[name]
            parts = {(): 1, ("data",): D, ("model",): M}
            assert (r["batch_axes"], r["seq_axes"]) == (rows_axes, seq_axes)
            (b0, b1), (k0, k1), (h0, h1) = r["block"]
            assert (b1 - b0, k1 - k0, h1 - h0) == (
                B // parts[rows_axes], s_max // parts[seq_axes],
                cfg.n_kv_heads // parts[head_axes])
        for key, sl in r["slices"].items():
            full = ref[f"{name}/cache0/{key}"].shape
            *_, kind, leaf = ("", *key.split("/"))
            if key == "memory":     # the KV block's batch rows
                assert [tuple(x) for x in sl] == [tuple(r["block"][0])] + [
                    (0, n) for n in full[1:]], key
            elif leaf in ("k", "v"):
                assert [tuple(x) for x in sl[-4:-1]] == [
                    tuple(x) for x in r["block"]], key
            else:
                want = STATE_PARTS[name][f"{kind.split('_', 1)[1]}/{leaf}"]
                assert tuple(f // (b - a) for f, (a, b) in zip(
                    full[-len(want):], sl[-len(want):])) == want, key
            covered.setdefault(key, set()).add(tuple(a for a, _ in sl))
            blk = tuple(slice(a, b) for a, b in sl)
            for t in range(s_max):
                got = r["caches"][t][key]
                assert tuple(got.shape) == tuple(b - a for a, b in sl), key
                _close(got, ref[f"{name}/cache{t}/{key}"][blk],
                       f"{name} step {t} cache {key}", _tol(name))
    for key, starts in covered.items():
        full = ref[f"{name}/cache0/{key}"].shape
        sl = ranks[name][0]["slices"][key]
        assert len(starts) == math.prod(f // (b - a) for f, (a, b) in zip(
            full, sl)), key


def _layout_case(cfg, B, M) -> str:
    if B <= 8:
        return "a" if cfg.n_kv_heads % M == 0 else "b"
    return "c" if cfg.n_kv_heads % M else "d"


@pytest.mark.parametrize("name", KV_NAMES)
def test_serve_rules_give_the_layout_of_the_case(name):
    """The cache spec under ``serve_rules`` on a shape-only mesh (no ranks
    needed): which ``decode_rules`` case applies and how the batch, the
    keys and the KV heads split (``_dedupe`` gives ``data`` to the batch
    where it divides, to the keys where it does not)."""
    _, arch, D, M, B, s_max, _, _, _ = BY_NAME[name]
    cfg = _cfg(name)
    case, rows_axes, seq_axes, head_axes = LAYOUTS[name]
    assert _layout_case(cfg, B, M) == case
    mesh = Mesh((D, M), ("data", "model"))
    ctx = ShardingCtx(mesh, dryrun.serve_rules(cfg.replace(name=arch),
                                               mesh, B))
    shape = (B, s_max, cfg.n_kv_heads, cfg.hd)
    assert ctx.layout(KV_CACHE_LOGICAL, shape)[:3] == [
        rows_axes, seq_axes, head_axes]


def test_kv_blocks_are_found_by_batch_and_local_shape(monkeypatch):
    """On (2, 2) under qwen3's rules at B 1, the rank at (data 1, model 0):
    a B 1 x 32768 cache (split by sequence) and a B 2 x 16384 cache (split
    by batch) both have blocks of [1, 16384, 4, 128]; each is found by its
    batch.  A cache whose block another layout of the same batch already
    claims raises when it is allocated: B 1 x 1025 keys do not split over
    ``data`` and would look like B 1 x 2050 keys split."""
    cfg = reduced_config("qwen3-1.7b").replace(
        name="qwen3-1.7b", n_kv_heads=8, head_dim=128)
    mesh = Mesh((2, 2), ("data", "model"))
    monkeypatch.setattr(Mesh, "coordinate",
                        lambda self: {"data": 1, "model": 0})
    ctx = ShardingCtx(mesh, dryrun.serve_rules(cfg, mesh, 1))
    seq = ctx.kv_block((1, 32768, 8, 128))
    rows = ctx.kv_block((2, 16384, 8, 128))
    assert seq.local_shape == rows.local_shape == (1, 16384, 4, 128)
    assert (seq.k_off, seq.seq_axes, seq.batch_axes) == (16384, ("data",), ())
    assert (rows.k_off, rows.seq_axes, rows.batch_axes) == (0, (), ("data",))
    assert ctx.kv_block_of(1, (1, 16384, 4, 128)) is seq
    assert ctx.kv_block_of(2, (1, 16384, 4, 128)) is rows
    ctx.kv_block((1, 2050, 8, 128))
    with pytest.raises(ValueError, match="another layout"):
        ctx.kv_block((1, 1025, 8, 128))
    with pytest.raises(ValueError, match="init_cache"):
        ctx.kv_block_of(4, (1, 16384, 4, 128))


def test_every_layout_case_is_exercised():
    assert {v[0] for v in LAYOUTS.values()} == {"a", "b", "c", "d"}
    assert any(v[2] == ("data",) for v in LAYOUTS.values())
    assert any(v[2] == ("model",) for v in LAYOUTS.values())


def test_gemma3_windows_cross_every_block_boundary():
    """At the gemma3 cases' positions the window of 16 keys reaches over
    each boundary between blocks (past the window, within S_max)."""
    for name in ("gemma3_1x2_b4", "gemma3_1x4_b4"):
        _, _, _, M, _, s_max, _, _, _ = BY_NAME[name]
        cfg = _cfg(name)
        assert cfg.attn_window == 16 and s_max > cfg.attn_window
        per = s_max // M
        for edge in range(per, s_max, per):
            pos = edge + cfg.attn_window // 2
            assert pos < s_max and pos - cfg.attn_window + 1 < edge


@pytest.mark.parametrize("name", ["olmoe_2x2_b4", "olmoe_1x4_b16",
                                  "kimi_2x2_b4"])
def test_moe_cases_drop_pairs(runs, name, monkeypatch):
    """The unsharded one-hot path over the reference's tokens drops
    (token, slot) pairs at the case's capacity: the ranks' routing is
    held where the capacity binds."""
    data, ref, _, _ = runs
    _, arch, _, _, B, s_max, _, _, _ = BY_NAME[name]
    cfg = _cfg(name)
    dropped = []
    real = moe._slots

    def counting(gate_idx, n, cap):
        row, keep = real(gate_idx, n, cap)
        dropped.append(int((~keep).sum()))
        return row, keep

    monkeypatch.setattr(moe, "_slots", counting)
    params = unflatten({k[len(arch) + 1:]: torch.tensor(v)
                        for k, v in data.items() if k.startswith(arch + "/")})
    toks = torch.from_numpy(ref[f"{name}/tokens"]).long()
    cache = init_cache(cfg, B, s_max, "cpu")
    with torch.no_grad():
        for t in range(s_max):
            decode_step(params, cfg, cache, toks[:, t:t + 1],
                        torch.tensor(t, dtype=torch.int32))
    assert sum(dropped) > 0


@pytest.mark.parametrize("name", [c[0] for c in CASES if c[8]])
def test_restore_then_serve(runs, name):
    """The ranks' blocks saved as one sharded checkpoint, restored with
    ``shardings=`` under ``serve_rules`` (every block as it was) and
    served again: each step's logits as the unsharded restore's in this
    process serves them (against the memory it encodes), within 1e-5 of
    their largest entry."""
    from repro_torch.checkpoint import restore_checkpoint

    _, ref, ranks, root = runs
    _, arch, _, _, B, s_max, _, _, _ = BY_NAME[name]
    cfg = _cfg(name)
    whole, step = restore_checkpoint(os.path.join(root, name),
                                     model_specs(cfg), device="cpu")
    assert step == 1
    toks = torch.from_numpy(ref[f"{name}/tokens"]).long()
    cache = _cache_with_memory(runs[0], name, whole, cfg)
    with torch.no_grad():
        want = [decode_step(whole, cfg, cache, toks[:, t:t + 1],
                            torch.tensor(t, dtype=torch.int32))[0].numpy()
                for t in range(s_max)]
    for r in ranks[name]:
        assert r["restored_equal"]
        for t in range(s_max):
            _close(r["restored_logits"][t], want[t],
                   f"{name} restored step {t}", _tol(name))


def _cache_with_memory(data: dict, name: str, params: dict, cfg) -> dict:
    """The unsharded cache of case ``name``, for encdec and vlm with the
    memory of its frames or patches (``encode`` of the whole batch)
    written in."""
    from repro_torch.models.transformer import encode

    _, _, _, _, B, s_max, _, _, _ = BY_NAME[name]
    if cfg.family not in STUB:
        return init_cache(cfg, B, s_max, "cpu")
    stub = STUB[cfg.family]
    with torch.no_grad():
        memory = encode(params, cfg, {stub: torch.from_numpy(
            data[f"{stub}/{name}"])})
    cache = init_cache(cfg, B, s_max, "cpu", mem_len=memory.shape[1])
    cache["memory"].copy_(memory)
    return cache


@pytest.mark.parametrize("name", [c[0] for c in CASES
                                  if _cfg(c[0]).family in STUB])
def test_each_rank_holds_its_memory_rows(runs, name):
    """The encdec and vlm caches hold only the rank's batch rows of the
    memory (every frame or patch, the whole ``d``), and those rows are
    ``encode``'s: the reference's memory, which its own encoder or patch
    projection wrote, cut to the rows, within 1e-5 of its largest entry,
    and nonzero."""
    data, ref, ranks, _ = runs
    _, _, D, M, B, _, _, _, _ = BY_NAME[name]
    cfg = _cfg(name)
    want = ref[f"{name}/cache0/memory"]
    assert want.shape == (B, MEMORY_LEN, cfg.d_model)
    assert np.abs(want).max(axis=(1, 2)).min() > 0
    rows = set()
    for r in ranks[name]:
        (b0, b1), *rest = r["slices"]["memory"]
        assert rest == [(0, MEMORY_LEN), (0, cfg.d_model)]
        assert (b0, b1) == tuple(r["block"][0])
        assert b1 - b0 == (B // D if B % D == 0 else B)
        rows.add((b0, b1))
        for t in (0, BY_NAME[name][5] - 1):
            _close(r["caches"][t]["memory"], want[b0:b1],
                   f"{name} step {t} memory rows")
    assert len(rows) == (D if B % D == 0 else 1)


def test_capture_on_a_gloo_mesh_raises(runs):
    for name in NAMES:
        for r in runs[2][name]:
            for what in ("generate_raised", "captured_raised"):
                assert r[what] is not None and "gloo" in r[what], (name, what)


# -------------------------------------------------------- partials mode

def _blocks(S, n, rng):
    cuts = sorted(rng.choice(np.arange(1, S), n - 1, replace=False).tolist())
    return list(zip([0] + cuts, cuts + [S]))


def _qkv(B, H, KV, hd, S, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, 1, H, hd, generator=g),
            torch.randn(B, S, KV, hd, generator=g),
            torch.randn(B, S, KV, hd, generator=g))


@pytest.mark.parametrize("n_blocks", [2, 4])
@pytest.mark.parametrize("window", [None, 16])
def test_partials_merged_over_blocks_equal_the_whole_cache(n_blocks,
                                                           window):
    """The cache cut into blocks at random offsets, each block's partials
    at its offset, merged: the whole-cache plain version within 1e-6, at
    a position inside each block, on each boundary (the block's first
    and last key), with blocks wholly past the position, and with the
    window straddling two blocks."""
    rng = np.random.default_rng(n_blocks)
    B, H, KV, hd, S = 2, 4, 2, 16, 64
    q, k, v = _qkv(B, H, KV, hd, S, n_blocks)
    blocks = _blocks(S, n_blocks, rng)
    positions = {0, S - 1}
    for lo, hi in blocks:
        positions |= {lo, hi - 1, (lo + hi) // 2}
    for pos in sorted(positions):
        p = torch.tensor(pos, dtype=torch.int32)
        parts = torch.stack([decode_attention_partials_plain(
            q, k[:, lo:hi], v[:, lo:hi], p, k_off=lo, window=window)
            for lo, hi in blocks])
        got = decode_attention_merge_plain(parts, q, KV)
        want = decode_attention_plain(q, k, v, p, window=window)
        assert (got - want).abs().max().item() <= 1e-6, pos
    # some block lies wholly past an early position: its m is -inf
    p = torch.tensor(blocks[0][1] - 1, dtype=torch.int32)
    last = decode_attention_partials_plain(
        q, k[:, blocks[-1][0]:], v[:, blocks[-1][0]:], p,
        k_off=blocks[-1][0], window=window)
    mg = B * KV * (H // KV)
    assert torch.isinf(last[:mg]).all() and (last[mg:] == 0).all()


@pytest.mark.parametrize("n_split", [1, 2, 3])
def test_partials_at_offset_zero_are_the_split_k_arithmetic(n_split):
    """One block at offset 0: the partials merged equal
    ``decode_attention_splitk_plain`` bit for bit."""
    q, k, v = _qkv(2, 8, 2, 16, 48, 7)
    for pos in (0, 17, 47):
        for window in (None, 5):
            p = torch.tensor(pos, dtype=torch.int32)
            parts = decode_attention_partials_plain(
                q, k, v, p, n_split=n_split, window=window)
            got = decode_attention_merge_plain(parts[None], q, 2)
            want = decode_attention_splitk_plain(q, k, v, p, n_split=n_split,
                                                 window=window)
            assert torch.equal(got, want)


# ------------------------------------------------------------- raises

@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_rules_that_split_xlstm_heads_raise_under_a_mesh(kind,
                                                         monkeypatch):
    """Decode under rules that split an mLSTM's or sLSTM's heads over
    ``model`` raises before any collective (a shape-only mesh has none; the
    cache is the block of the rank at (data 0, model 0)): ``decode_step``
    and the eager ``generate``, naming the block and ROADMAP."""
    from repro_torch.launch.serve import generate
    from test_torch_tp import _xlstm_heads_split

    cfg, rules = _xlstm_heads_split(kind)
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    tok = torch.zeros((4, 1), dtype=torch.long)
    monkeypatch.setattr(Mesh, "coordinate",
                        lambda self: {"data": 0, "model": 0})
    with activate(Mesh((1, 2), ("data", "model")), rules), torch.no_grad():
        cache = init_cache(cfg, 4, 8, "cpu")
        for fn in (lambda: decode_step(params, cfg, cache, tok, torch.zeros(
                       (), dtype=torch.int32)),
                   lambda: generate(cfg, params, tok, 2, device="cpu",
                                    capture=False)):
            with pytest.raises(NotImplementedError) as e:
                fn()
            assert kind in str(e.value)
            assert "ROADMAP Queue 1 item 2" in str(e.value)


def test_decode_under_a_mesh_raises_under_grad():
    cfg = reduced_config("qwen3-1.7b").replace(dtype="float32")
    mesh = Mesh((1, 1), ("data", "model"))
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    params["embed"].requires_grad_(True)
    with activate(mesh, dryrun.serve_rules(cfg, mesh, 1)):
        cache = init_cache(cfg, 1, 8, "cpu")
        with pytest.raises(NotImplementedError, match="forward-only"):
            decode_step(params, cfg, cache, torch.zeros((1, 1),
                        dtype=torch.long), torch.zeros((), dtype=torch.int32))
