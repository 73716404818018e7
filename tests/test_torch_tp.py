"""Tensor parallelism of every family: the port's train step under the
reference's production rules against the JAX reference's GSPMD step on
the same mesh.

The rules are ``launch.dryrun.rules_for``'s, the port's copy of the
reference's: the port activates the storage rules (each rank holds its
blocks: heads, MLP columns and vocabulary rows over ``model``, the ``d``
dims of qwen2.5's, kimi's and whisper's leaves over ``data``, expert
leaves over ``model`` and ``data``), the reference its compute rules
(``constrain`` hints for GSPMD).  Cases, all reduced configs at f32, three
AdamW steps (lr 1e-2, eps 1e-3, so that near-zero gradients do not turn
into sign noise) of B 4 x S 16:

- qwen3 (tied embedding, q/k norm): (1, 2) with both head dims split,
  under both ``loss_dtype``s; (1, 4), where its 2 KV heads are masked to
  replicated and each rank reads the KV head of its one query head;
  (2, 2) with ``remat="full"`` (the recompute re-issues the collectives)
  and ZeRO-1 moments;
- gemma3 (attention replicated over ``model`` by its override, MLP and
  vocabulary split, sliding window): (1, 2);
- nemotron (untied, relu2): (1, 2);
- qwen2.5 (q/k/v biases, dense FSDP storage, ``remat="full"``): (2, 2);
- olmoe and kimi (the MoE a2a with tensor-parallel attention, expert
  FSDP; kimi's dense FSDP too): (2, 2);
- zamba2 (Mamba2 on a rank's SSM heads with ``w_in`` gathered per layer,
  the shared attention block's heads and MLP, tied vocabulary): (1, 2),
  (2, 2) with ``remat="full"``, and (1, 4), where masking keeps ``w_in``
  whole (290 columns) and the 2 SSM heads do not tile, so the Mamba2
  blocks run replicated with their ``d_inner`` leaves gathered;
- xlstm (the mLSTM's ``d_in`` over ``model``, its heads and the sLSTM
  replicated): (1, 2) and (2, 2) with ``remat="full"``;
- whisper (the encoder and the decoder's self- and cross-attention on a
  rank's heads over the memory of 12 frames, LayerNorm, tied vocabulary):
  (1, 2), and (2, 2) with ``remat="full"``, where its FSDP storage puts
  every ``d`` dim over ``data``, ``frontend_proj`` and the encoder's final
  norm among them, gathered again in the recompute;
- llama-vision (4 self-attention layers and a gated cross-attention layer
  over 12 projected patches, the gates off their zero init): (1, 2), and
  (1, 4), where its 2 KV heads are masked whole and each rank's query
  head reads one.

Each case compares the losses and clip norms of its steps, the gradients
AdamW received at step 0 (each rank's block against the reference's full
gradient) and the final parameters (per block); the tolerance is 1e-5
relative to each tensor's largest entry (losses and norms: 1e-5
relative).  zamba2's reduced model amplifies f32 rounding: weights moved
by 1e-7 of themselves move its step-0 gradients by 2.8e-4 of a leaf's
largest entry, and the reference's own (1, 2) and (2, 2) programs give
gradients 8.7e-5 apart and clip norms 1e-3 apart by the third step.  Its
cases take one step and hold the gradients and parameters within
``ZAMBA2_TOL`` (losses and norms at 1e-5); the Mamba2 block alone, which
is well conditioned, is held within 1e-5 below, with its gradients.  The
ranks are spawned gloo processes (``tests/torch_ranks.py``), the
reference four processes with four forced host devices each
(``tests/jax_dist_ref.py``).

The Mamba2 gated norm over ``d_inner`` cut over ``model`` (two gloo ranks
of the same spawn): its sum of squares is all-reduced forward and
backward; the block's output and every gradient match the unsharded
block's within 1e-5, and with a stand-in whose backward is the identity
the gradients miss by far more.  Likewise the cross-attention's memory:
through ``copy_to_model`` the gradients of ``frontend_proj`` and the
encoder match the unsharded model's; with a stand-in that passes the
memory by they miss.

In process, with a shape-only mesh (no process group, so a collective
would fail): the step and ``forward`` raise ``NotImplementedError``
before any collective for rules that split the mLSTM's or sLSTM's heads,
for a ``seq_sp`` rule and for ``layers="pod"``.  Decode under rules that
split a dense leaf (two gloo ranks, qwen3, zamba2 and whisper) gives the
unsharded step's logits and tokens, its captured step raises on the gloo
mesh, and decode under rules that split the mLSTM's heads raises
(``tests/test_torch_decode_mesh.py`` holds decode under a mesh against
the reference).  The port's ``rules_for`` / ``opt_rules_for`` /
``decode_rules`` equal the reference's for every registry arch.
"""

import itertools
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.distributed import Mesh, ShardingRules, activate
from repro_torch.launch import dryrun
from repro_torch.models.common import init_params, tree_leaves
from repro_torch.models.transformer import (decode_step, init_cache,
                                            model_specs)
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.weights import unflatten
from test_torch_dp_train import numpy_params
from torch_ranks import (MAMBA_CFG, MAMBA_W_IN_WHOLE_CFG, collect,
                         collect_reference, spawn_ranks, spawn_reference)

B, S, STEPS = 4, 16, 3
TOL = 1e-5
#: name, arch, D, M, steps, loss_dtype, remat, zero1, save
CASES = [
    ("qwen3_1x2", "qwen3-1.7b", 1, 2, STEPS, "float32", "none", True, False),
    ("qwen3_1x2_compute", "qwen3-1.7b", 1, 2, STEPS, "compute", "none",
     True, False),
    ("gemma3_1x2", "gemma3-1b", 1, 2, STEPS, "float32", "none", True, False),
    ("nemotron_1x2", "nemotron-4-15b", 1, 2, STEPS, "float32", "none", True,
     False),
    ("qwen3_1x4", "qwen3-1.7b", 1, 4, STEPS, "float32", "none", True, False),
    ("qwen3_2x2", "qwen3-1.7b", 2, 2, STEPS, "float32", "full", True, False),
    ("qwen25_2x2", "qwen2.5-14b", 2, 2, STEPS, "float32", "full", True,
     False),
    ("olmoe_2x2", "olmoe-1b-7b", 2, 2, STEPS, "float32", "none", True,
     False),
    ("kimi_2x2", "kimi-k2-1t-a32b", 2, 2, STEPS, "float32", "none", True,
     False),
    ("zamba2_1x2", "zamba2-7b", 1, 2, 1, "float32", "none", True, False),
    ("zamba2_2x2", "zamba2-7b", 2, 2, 1, "float32", "full", True, False),
    ("zamba2_1x4", "zamba2-7b", 1, 4, 1, "float32", "none", True, False),
    ("xlstm_1x2", "xlstm-125m", 1, 2, STEPS, "float32", "none", True,
     False),
    ("xlstm_2x2", "xlstm-125m", 2, 2, STEPS, "float32", "full", True,
     False),
    ("whisper_1x2", "whisper-large-v3", 1, 2, STEPS, "float32", "none",
     True, False),
    ("whisper_2x2", "whisper-large-v3", 2, 2, STEPS, "float32", "full",
     True, False),
    ("vision_1x2", "llama-3.2-vision-11b", 1, 2, STEPS, "float32", "none",
     True, False),
    ("vision_1x4", "llama-3.2-vision-11b", 1, 4, STEPS, "float32", "none",
     True, False),
]
NAMES = [c[0] for c in CASES]
REF_PROCS = 4
ARCHS = sorted({c[1] for c in CASES})
#: zamba2's gradients and parameters (module docstring: the reference's
#: own layouts differ by 8.7e-5, rounding-sized weight moves by 2.8e-4)
ZAMBA2_TOL = 3e-4
#: the memory rows of the encdec and vlm batches (frames / patches: fewer
#: than S, so no tensor of the decoder has the memory's shape), and the
#: stub input each family's memory comes from
MEMORY_LEN = 12
STUB = {"encdec": "frames", "vlm": "patches"}
CROSS_ARCHS = ("llama-3.2-vision-11b", "whisper-large-v3")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train")
    rng = np.random.default_rng(23)
    data = {}
    for arch in ARCHS:
        if arch in CROSS_ARCHS:
            continue
        cfg = reduced_config(arch).replace(dtype="float32")
        for k, v in numpy_params(model_specs(cfg), rng).items():
            data[f"{arch}/{k}"] = v
        data[f"tokens/{arch}"] = rng.integers(
            0, cfg.vocab_size, (STEPS, B, S)).astype(np.int32)
    data.update(_mamba_inputs(rng))
    data.update(_cross_inputs(np.random.default_rng(27)))
    inputs = os.path.join(str(tmp), "inputs.npz")
    np.savez(inputs, **data)
    cases = [list(c) for c in CASES]
    # the reference compiles two programs a case: three processes share
    # the cases, so its wall time is about the port's ranks'
    refs = [spawn_reference("tp_train", 4, tmp, inputs,
                            cases=[c[:7] for c in cases[i::REF_PROCS]])
            for i in range(REF_PROCS)]
    two = spawn_ranks("tp_train", 2, tmp, inputs=inputs, cases=cases,
                      root=str(tmp))
    four = spawn_ranks("tp_train", 4, tmp, inputs=inputs, cases=cases,
                       root=str(tmp))
    ranks = {}
    for res in collect(two, 240.0) + collect(four, 240.0):
        for name, r in res.items():
            ranks.setdefault(name, []).append(r)
    ref = {}
    for r in refs:
        ref.update(collect_reference(r))
    return data, ref, ranks


def _cross_inputs(rng) -> dict:
    """The encdec and vlm archs' leaves (the vlm gates moved off their
    zero init, so that the cross-attention adds something), tokens and
    frames or patches ``[STEPS, B, MEMORY_LEN, frontend_dim]``."""
    out = {}
    for arch in CROSS_ARCHS:
        cfg = reduced_config(arch).replace(dtype="float32")
        for k, v in numpy_params(model_specs(cfg), rng).items():
            out[f"{arch}/{k}"] = v + 0.5 * k.endswith("/gate")
        out[f"tokens/{arch}"] = rng.integers(
            0, cfg.vocab_size, (STEPS, B, S)).astype(np.int32)
        out[f"{STUB[cfg.family]}/{arch}"] = rng.standard_normal(
            (STEPS, B, MEMORY_LEN, cfg.frontend_dim)).astype(np.float32)
    return out


def _mamba_inputs(rng) -> dict:
    """One Mamba2 block of reduced zamba2 (every leaf off its init), an
    input ``[2, 16, d]`` and a cotangent of the output; the same for the
    variant whose ``w_in`` the rules keep whole on four ranks."""
    from repro_torch.models.ssm import mamba2_specs

    out = {}
    for prefix, cfg in (("mamba", MAMBA_CFG()),
                        ("mamba_w_in_whole", MAMBA_W_IN_WHOLE_CFG())):
        for k, v in numpy_params(mamba2_specs(cfg), rng).items():
            out[f"{prefix}/{k}"] = v + 0.1 * rng.standard_normal(
                v.shape).astype(np.float32)
        for k in ("x", "cot"):
            out[f"{prefix}/{k}"] = rng.standard_normal(
                (2, 16, cfg.d_model)).astype(np.float32)
    return out


def _close(got: torch.Tensor, want: np.ndarray, what: str,
           tol: float = TOL) -> None:
    peak = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got.numpy() - want).max()) if want.size else 0.0
    assert got.shape == want.shape and err <= tol * max(peak, 1e-30), (
        f"{what}: off by {err}, largest entry {peak}")


def _block(r, k):
    return tuple(slice(a, b) for a, b in r["slices"][k])


@pytest.mark.parametrize("name", NAMES)
def test_tp_step_matches_the_reference(runs, name):
    _, ref, ranks = runs
    arch, D, M, steps = next(c[1:5] for c in CASES if c[0] == name)
    tol = ZAMBA2_TOL if arch == "zamba2-7b" else TOL
    assert len(ranks[name]) == D * M
    for r in ranks[name]:
        assert len(r["losses"]) == steps
        for i in range(steps):
            np.testing.assert_allclose(r["losses"][i],
                                       float(ref[f"{name}/loss{i}"]),
                                       rtol=TOL)
            np.testing.assert_allclose(r["grad_norms"][i],
                                       float(ref[f"{name}/grad_norm{i}"]),
                                       rtol=TOL)
        for k, g in r["grads0"].items():
            _close(g, ref[f"{name}/grads/{k}"][_block(r, k)],
                   f"{name} step-0 gradient {k}", tol)
        for k, p in r["params"].items():
            _close(p, ref[f"{name}/params/{k}"][_block(r, k)],
                   f"{name} parameter {k}", tol)


@pytest.mark.parametrize("name", ["qwen3_1x2", "qwen3_1x4", "qwen3_2x2",
                                  "gemma3_1x2", "qwen25_2x2", "kimi_2x2"])
def test_each_rank_holds_its_blocks(runs, name):
    """The layouts the cases are meant to exercise: heads, MLP columns
    and vocabulary rows over ``model`` (KV heads whole at (1, 4); gemma3's
    attention whole), and qwen2.5's / kimi's ``d`` dims over ``data``."""
    data, _, ranks = runs
    arch = next(c[1] for c in CASES if c[0] == name)
    cfg = reduced_config(arch)
    D, M = next((c[2], c[3]) for c in CASES if c[0] == name)
    r = ranks[name][0]
    shape = {k: r["params"][k].shape for k in r["params"]}
    full = {k[len(arch) + 1:]: v.shape for k, v in data.items()
            if k.startswith(arch + "/")}
    attn = "blocks/b0_moe/attn" if cfg.family == "moe" else (
        "blocks/b0_attn_local/attn" if arch.startswith("gemma3")
        else "blocks/b0_attn/attn")
    heads_split = not arch.startswith("gemma3")
    assert shape[f"{attn}/wq"][2] == cfg.n_heads // (M if heads_split
                                                      else 1)
    kv_split = heads_split and cfg.n_kv_heads % M == 0
    assert shape[f"{attn}/wk"][2] == cfg.n_kv_heads // (M if kv_split
                                                         else 1)
    assert shape["embed"][0] == cfg.vocab_size // M
    if cfg.family != "moe":
        mlp = attn.rsplit("/", 1)[0] + "/mlp/wi"
        assert shape[mlp][2] == cfg.d_ff // M
    fsdp = arch in dryrun._FSDP_ARCHS
    assert shape[f"{attn}/wq"][1] == full[f"{attn}/wq"][1] // (D if fsdp
                                                              else 1)
    assert shape["embed"][1] == cfg.d_model // (D if fsdp else 1)


#: the blocks the hybrid and ssm cases are meant to exercise: per leaf,
#: how many parts each dim is cut into (a stacked leaf's layers dim left
#: out)
RECURRENT_BLOCKS = {
    "zamba2_1x2": {"blocks/b0_mamba/mamba/w_in": (1, 2),
                   "blocks/b0_mamba/mamba/conv_w": (1, 2),
                   "blocks/b0_mamba/mamba/norm_scale": (2,),
                   "blocks/b0_mamba/mamba/w_out": (2, 1),
                   "blocks/b0_mamba/mamba/A_log": (1,),
                   "tail/t0_mamba/mamba/w_in": (1, 2),
                   "shared_attn/attn/wq": (1, 2, 1),
                   "shared_attn/attn/wk": (1, 2, 1),
                   "shared_attn/mlp/wi": (1, 2), "embed": (2, 1)},
    "zamba2_1x4": {"blocks/b0_mamba/mamba/w_in": (1, 1),
                   "blocks/b0_mamba/mamba/conv_w": (1, 4),
                   "blocks/b0_mamba/mamba/w_out": (4, 1),
                   "shared_attn/attn/wq": (1, 4, 1), "embed": (4, 1)},
    "xlstm_1x2": {"blocks/b0_mlstm/mlstm/w_up": (1, 2),
                  "blocks/b0_mlstm/mlstm/w_gate": (1, 2),
                  "blocks/b0_mlstm/mlstm/wq": (2, 1, 1),
                  "blocks/b0_mlstm/mlstm/w_if": (2, 1),
                  "blocks/b0_mlstm/mlstm/wo": (1, 1, 1),
                  "blocks/b0_mlstm/mlstm/o_norm": (1, 1),
                  "blocks/b0_mlstm/mlstm/b_if": (1,),
                  "blocks/b1_slstm/slstm/w_x": (1, 1, 1, 1),
                  "blocks/b1_slstm/slstm/w_r": (1, 1, 1, 1),
                  "embed": (2, 1)},
}


@pytest.mark.parametrize("name", sorted(RECURRENT_BLOCKS))
def test_each_rank_holds_its_recurrent_blocks(runs, name):
    """Each rank's parameters are its blocks as the case is meant to cut
    them: zamba2's ``w_in`` contiguously over ``model`` (whole at (1, 4),
    290 columns), its ``d_inner`` leaves and the shared block's heads and
    MLP; xlstm's mLSTM ``d_in`` with its heads and the sLSTM whole."""
    data, _, ranks = runs
    arch = next(c[1] for c in CASES if c[0] == name)
    full = {k[len(arch) + 1:]: v.shape for k, v in data.items()
            if k.startswith(arch + "/")}
    for r in ranks[name]:
        for key, parts in RECURRENT_BLOCKS[name].items():
            shape = tuple(r["params"][key].shape)
            lead = len(shape) - len(parts)
            assert shape[lead:] == tuple(
                n // k for n, k in zip(full[key][lead:], parts)), key


#: the blocks the encdec and vlm cases are meant to exercise, as
#: RECURRENT_BLOCKS: cross-attention heads over ``model`` (llama-vision's
#: 2 KV heads whole at (1, 4)), whisper's ``d`` dims over ``data`` at (2,
#: 2) -- ``frontend_proj`` and the encoder's final norm among them
CROSS_BLOCKS = {
    "whisper_1x2": {"blocks/b0_dec_attn/xattn/wq": (1, 2, 1),
                    "blocks/b0_dec_attn/xattn/wk": (1, 2, 1),
                    "blocks/b0_dec_attn/xattn/wo": (2, 1, 1),
                    "encoder/blocks/b0_attn_bidir/attn/wq": (1, 2, 1),
                    "encoder/blocks/b0_attn_bidir/mlp/wi": (1, 2),
                    "encoder/final_norm/scale": (1,),
                    "frontend_proj": (1, 1), "embed": (2, 1)},
    "whisper_2x2": {"blocks/b0_dec_attn/xattn/wq": (2, 2, 1),
                    "blocks/b0_dec_attn/xattn/wv": (2, 2, 1),
                    "blocks/b0_dec_attn/xattn/wo": (2, 1, 2),
                    "blocks/b0_dec_attn/ln_x/bias": (2,),
                    "encoder/blocks/b0_attn_bidir/attn/wq": (2, 2, 1),
                    "encoder/blocks/b0_attn_bidir/mlp/wi": (2, 2),
                    "encoder/final_norm/scale": (2,),
                    "frontend_proj": (1, 2), "embed": (2, 2)},
    "vision_1x2": {"blocks/b4_xattn/xattn/wq": (1, 2, 1),
                   "blocks/b4_xattn/xattn/wk": (1, 2, 1),
                   "blocks/b4_xattn/xattn/wo": (2, 1, 1),
                   "blocks/b4_xattn/gate": (1,),
                   "blocks/b4_xattn/mlp/wg": (1, 2),
                   "frontend_proj": (1, 1), "unembed": (1, 2)},
    "vision_1x4": {"blocks/b4_xattn/xattn/wq": (1, 4, 1),
                   "blocks/b4_xattn/xattn/wk": (1, 1, 1),
                   "blocks/b4_xattn/xattn/wo": (4, 1, 1),
                   "blocks/b4_xattn/gate": (1,),
                   "frontend_proj": (1, 1), "unembed": (1, 4)},
}


@pytest.mark.parametrize("name", sorted(CROSS_BLOCKS))
def test_each_rank_holds_its_cross_blocks(runs, name):
    """Each rank's parameters are its blocks as the case is meant to cut
    them: the cross-attention's heads and the MLP's columns over
    ``model``, whisper's encoder likewise, and at (2, 2) whisper's ``d``
    dims over ``data`` (FSDP), ``frontend_proj`` and the encoder's final
    norm with them; the vlm ``gate`` whole."""
    data, _, ranks = runs
    arch = next(c[1] for c in CASES if c[0] == name)
    full = {k[len(arch) + 1:]: v.shape for k, v in data.items()
            if k.startswith(arch + "/")}
    for r in ranks[name]:
        for key, parts in CROSS_BLOCKS[name].items():
            shape = tuple(r["params"][key].shape)
            lead = len(shape) - len(parts)
            assert shape[lead:] == tuple(
                n // k for n, k in zip(full[key][lead:], parts)), key


@pytest.mark.parametrize("arch", ["whisper-large-v3",
                                  "llama-3.2-vision-11b"])
def test_memory_gradient_needs_copy_to_model(runs, arch):
    """The cross-attention's memory enters the tensor-parallel region
    through ``copy_to_model``, as its input does.  On a (1, 2) mesh every
    rank's gradient of ``frontend_proj``, and of each encoder leaf's block,
    is the unsharded model's within 1e-5; with a stand-in that passes the
    memory by (a rank keeps its heads' part of the memory's gradient) they
    miss by more than 1e-2."""
    from repro_torch.models.transformer import lm_loss

    data, _, ranks = runs
    cfg = reduced_config(arch).replace(dtype="float32")
    stub = STUB[cfg.family]
    p = {k[len(arch) + 1:]: torch.tensor(v, requires_grad=True)
         for k, v in data.items() if k.startswith(arch + "/")}
    loss = lm_loss(unflatten(p), cfg, {
        "tokens": torch.from_numpy(data[f"tokens/{arch}"][0]),
        stub: torch.from_numpy(data[f"{stub}/{arch}"][0])})
    res = ranks[f"memory_grads/{arch}"]
    assert len(res) == 2
    keys = sorted(res[0]["sound"])
    assert "frontend_proj" in keys and (cfg.family == "vlm") == (
        len(keys) == 1)
    want = dict(zip(keys, torch.autograd.grad(loss, [p[k] for k in keys])))
    missed = []
    for r in res:
        for k in keys:
            blk = tuple(slice(a, b) for a, b in r["slices"][k])
            w = want[k][blk].numpy()
            _close(r["sound"][k], w, f"{arch} gradient {k}")
            if k == "frontend_proj":
                missed.append(_rel(r["memory_skips_copy"][k], w))
    assert min(missed) > 1e-2, missed


def test_mamba_gated_norm_gradient_needs_its_all_reduce(runs):
    """Trap 2: the gated RMSNorm averages over the whole ``d_inner``, cut
    over ``model`` on the (1, 2) mesh.  With ``collectives.shared_sum``
    (all-reduced forward and backward) each rank's output equals the
    unsharded block's and so does every gradient, within 1e-5: the
    input's, each leaf's block, the per-head leaves summed over
    ``model``.  A stand-in all-reduce whose backward is the identity gives
    the same output and gradients that miss by more than 1e-2."""
    data, _, ranks = runs
    y, gx, want = _mamba_unsharded(data, "mamba", MAMBA_CFG())
    assert len(ranks["mamba_block"]) == 2
    missed = []
    for r in ranks["mamba_block"]:
        sound, ident = r["shared_sum"], r["identity"]
        assert sound["heads"] == ident["heads"]
        assert sound["heads"] in (slice(0, 1), slice(1, 2))
        assert sound["partial"] == ("A_log", "D", "dt_bias")
        for run in (sound, ident):
            _close(run["y"], y, "mamba block output")
        _close(sound["gx"], gx, "mamba block input gradient")
        worst = _rel(ident["gx"], gx)
        for k in want:
            blk = tuple(slice(a, b) for a, b in sound["slices"][k])
            _close(sound["grads"][k], want[k][blk], f"mamba gradient {k}")
            worst = max(worst, _rel(ident["grads"][k], want[k][blk]))
        missed.append(worst)
    assert min(missed) > 1e-2, missed


def test_mamba_block_on_its_heads_with_w_in_whole(runs):
    """Masking keeps ``w_in`` whole while the heads split: 4 SSM heads and
    a state of 17 on (1, 4), where ``w_in``'s 294 columns do not tile.
    Each rank takes the columns of its heads from the whole leaf, whose
    gradient on a rank is then a part, summed over ``model`` as the train
    step sums it; output and gradients as the unsharded block's within
    1e-5."""
    data, _, ranks = runs
    y, gx, want = _mamba_unsharded(data, "mamba_w_in_whole",
                                   MAMBA_W_IN_WHOLE_CFG())
    assert len(ranks["mamba_block_w_in_whole"]) == 4
    for m, r in enumerate(ranks["mamba_block_w_in_whole"]):
        run = r["shared_sum"]
        assert run["heads"] == slice(m, m + 1)
        assert run["slices"]["w_in"] == [(0, 64), (0, 294)]
        assert "w_in" in run["partial"]
        _close(run["y"], y, "mamba block output")
        _close(run["gx"], gx, "mamba block input gradient")
        for k in want:
            blk = tuple(slice(a, b) for a, b in run["slices"][k])
            _close(run["grads"][k], want[k][blk], f"mamba gradient {k}")


def _mamba_unsharded(data: dict, prefix: str, cfg) -> tuple:
    """The unsharded block's output, input gradient and leaf gradients."""
    from repro_torch.models.ssm import mamba2_forward, mamba2_specs

    p = {k: torch.tensor(data[f"{prefix}/{k}"], requires_grad=True)
         for k in mamba2_specs(cfg)}
    x = torch.tensor(data[f"{prefix}/x"], requires_grad=True)
    y = mamba2_forward(p, cfg, x)
    keys = sorted(p)
    g = torch.autograd.grad((y * torch.from_numpy(
        data[f"{prefix}/cot"])).sum(), [x] + [p[k] for k in keys])
    return (y.detach().numpy(), g[0].numpy(),
            {k: t.numpy() for k, t in zip(keys, g[1:])})


def _rel(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


def test_labels_fall_in_every_rank_vocabulary_block(runs):
    """The vocab-parallel loss cases take the label logit from every
    rank's block."""
    data, _, _ = runs
    toks = data["tokens/qwen3-1.7b"][:, :, 1:]
    V = reduced_config("qwen3-1.7b").vocab_size
    for M in (2, 4):
        blocks = set((toks // (V // M)).reshape(-1).tolist())
        assert blocks == set(range(M))


# ----------------------------------------------------------- raises

def _shape_only(D, M):
    return Mesh((D, M), ("data", "model"))


def _step_raises(cfg, rules, D=1, M=2):
    specs = model_specs(cfg)
    params = dict(tree_leaves(init_params(
        specs, torch.Generator().manual_seed(0), torch.float32, "cpu")))
    with activate(_shape_only(D, M), rules) as ctx:
        local = {k: params[k][ctx.mesh.local_slices(
            ctx.spec(s.logical, s.shape), s.shape,
            {"data": 0, "model": 0})].clone() for k, s in tree_leaves(specs)}
        state = init_train_state(unflatten(local), AdamWConfig())
        step = make_train_step(cfg, AdamWConfig())
        batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32)}
        with pytest.raises(NotImplementedError) as e:
            step(state, batch)
    return str(e.value)


def _xlstm_heads_split(kind: str):
    """Reduced xlstm (only sLSTM blocks for ``kind="slstm"``) and rules
    that split its cells' heads over ``model`` (``qheads``; the
    vocabulary whole, so no collective runs before the blocks)."""
    cfg = reduced_config("xlstm-125m").replace(dtype="float32")
    if kind == "slstm":
        cfg = cfg.replace(slstm_every=1)
    _, storage = dryrun.rules_for(cfg, False)
    return cfg, storage.override(qheads="model", vocab=None)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_rules_that_split_xlstm_heads_raise_before_any_collective(kind):
    """Rules that split an mLSTM's or sLSTM's heads over ``model`` (no
    registry rules do): the train step raises before any collective (a
    shape-only mesh has none), and so does ``forward`` under the same
    rules, naming the block and ROADMAP."""
    from repro_torch.models.transformer import forward

    cfg, rules = _xlstm_heads_split(kind)
    msg = _step_raises(cfg, rules)
    assert kind in msg and "ROADMAP Queue 1 item 2" in msg
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    with activate(_shape_only(1, 2), rules):
        with pytest.raises(NotImplementedError, match=kind):
            forward(params, cfg, {"tokens": torch.zeros((1, 4),
                                                        dtype=torch.long)})


@pytest.mark.parametrize("what", ["seq_sp", "pod_layers"])
def test_seq_sp_and_pipeline_rules_raise(what):
    cfg = reduced_config("qwen3-1.7b").replace(dtype="float32")
    if what == "seq_sp":
        _, rules = dryrun.rules_for(cfg.replace(seq_shard_norms=1), False)
        assert rules.rules["seq_sp"] == "model"
    else:
        _, rules = dryrun.rules_for(cfg, False, pp=True)
        assert rules.rules["layers"] == "pod"
    msg = _step_raises(cfg, rules)
    assert ("seq_sp" if what == "seq_sp" else "pipeline") in msg
    assert "ROADMAP Queue 1 item 2" in msg


def test_decode_under_rules_that_split_a_dense_leaf_raises(tmp_path):
    """Decode under rules that split dense leaves: qwen3, zamba2 and
    whisper decode (two gloo ranks on a (1, 2) mesh, heads, MLP, SSM heads,
    cross-attention heads and vocabulary split, each rank's block of the
    cache and its rows of whisper's memory; every rank's logits and greedy
    tokens are the unsharded step's), and ``CapturedServeStep`` raises on
    that gloo mesh and on a shape-only one.  Rules that split the mLSTM's
    heads still raise, naming ROADMAP, before any collective.  On a (1, 1)
    mesh nothing is split: the step decodes."""
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import encode
    from repro_torch.serve.step import CapturedServeStep

    rng = np.random.default_rng(11)
    cfgs, data = {}, {}
    for arch in ("qwen3-1.7b", "zamba2-7b", "whisper-large-v3"):
        cfgs[arch] = reduced_config(arch).replace(dtype="float32")
        for k, v in numpy_params(model_specs(cfgs[arch]), rng).items():
            data[f"{arch}/{k}"] = v
        data[f"prompt/{arch}"] = rng.integers(
            0, cfgs[arch].vocab_size, (2, 3)).astype(np.int64)
    frames = rng.standard_normal((2, MEMORY_LEN, cfgs[
        "whisper-large-v3"].frontend_dim)).astype(np.float32)
    data["frames/whisper-large-v3"] = frames
    inputs = os.path.join(str(tmp_path), "inputs.npz")
    np.savez(inputs, **data)
    ranks = collect(spawn_ranks(
        "decode", 2, tmp_path, inputs=inputs, root=str(tmp_path),
        cases=[[arch, arch, 1, 2, 2, 8, 3, 1.25, False] for arch in cfgs]))
    for arch, cfg in cfgs.items():
        params = unflatten({k.split("/", 1)[1]: torch.tensor(v)
                            for k, v in data.items()
                            if k.startswith(arch + "/")})
        toks = ranks[0][arch]["tokens"]
        with torch.no_grad():
            memory = encode(params, cfg, {"frames": torch.from_numpy(frames)})
            cache = init_cache(cfg, 2, 8, "cpu", mem_len=0 if memory is None
                               else MEMORY_LEN)
            if memory is not None:
                cache["memory"].copy_(memory)
            want = [decode_step(params, cfg, cache, toks[:, t:t + 1],
                                torch.tensor(t, dtype=torch.int32))[0]
                    for t in range(8)]
        for r in ranks:
            r = r[arch]
            assert torch.equal(r["tokens"], toks)
            assert r["block"][2] == (r["block"][2][0],
                                     r["block"][2][0] + cfg.n_kv_heads // 2)
            for got, w in zip(r["logits"], want):
                torch.testing.assert_close(got, w, atol=1e-5 * w.abs().max(),
                                           rtol=0)
            assert "gloo" in r["captured_raised"]
        with activate(_shape_only(1, 2), dryrun.rules_for(cfg, False)[1]):
            with pytest.raises(NotImplementedError,
                               match="cannot be captured"):
                CapturedServeStep(cfg, params, 1, 8, device="cpu")
    cfg = reduced_config("qwen3-1.7b").replace(dtype="float32")
    params = unflatten({k.split("/", 1)[1]: torch.tensor(v)
                        for k, v in data.items()
                        if k.startswith("qwen3-1.7b/")})
    xcfg, xrules = _xlstm_heads_split("mlstm")
    xparams = init_params(model_specs(xcfg), torch.Generator().manual_seed(0),
                          torch.float32, "cpu")
    tok = torch.zeros((1, 1), dtype=torch.long)
    pos = torch.zeros((), dtype=torch.int32)
    with activate(_shape_only(1, 2), xrules), torch.no_grad():
        # the cache of the rank at (data 0, model 0): a shape-only mesh
        # has no coordinate of its own
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(Mesh, "coordinate",
                       lambda self: {"data": 0, "model": 0})
            xcache = init_cache(xcfg, 1, 8, "cpu")
            with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
                decode_step(xparams, xcfg, xcache, tok, pos)
            with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
                generate(xcfg, xparams, tok, 2, device="cpu", capture=False)
    # on a (1, 1) mesh nothing is split: the step decodes
    cache = init_cache(cfg, 1, 8, "cpu")
    with activate(_shape_only(1, 1), dryrun.rules_for(cfg, False)[1]):
        logits, _ = decode_step(params, cfg, cache, tok, pos)
    assert logits.shape == (1, cfg.vocab_size)


# ------------------------------------------------ the rules are copies

def _reference_dryrun():
    """``repro.launch.dryrun``, whose import adds 512 forced host devices
    to ``XLA_FLAGS``: the variable is put back at once (it is read when
    JAX's backend starts, which the import does not do)."""
    before = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return ref


@pytest.mark.parametrize("arch", list_archs())
def test_rules_equal_the_reference(arch):
    import repro.configs as jax_configs

    ref = _reference_dryrun()
    cfg, jcfg = get_config(arch), jax_configs.get_config(arch)
    for multi_pod, scope, pp in itertools.product(
            (False, True), ("all", "attn"), (False, True)):
        mine = dryrun.rules_for(cfg, multi_pod, scope, pp)
        theirs = ref.rules_for(jcfg, multi_pod, scope, pp)
        assert [r.rules for r in mine] == [r.rules for r in theirs]
        assert dryrun.opt_rules_for(mine[1], multi_pod).rules == \
            ref.opt_rules_for(theirs[1], multi_pod).rules
        for batch, model_axis in itertools.product((1, 8, 16, 64), (2, 16)):
            assert dryrun.decode_rules(
                cfg, mine[0], batch, model_axis).rules == ref.decode_rules(
                jcfg, theirs[0], batch, model_axis).rules


def test_rules_take_the_ports_rules_type():
    _, storage = dryrun.rules_for(get_config("qwen2.5-14b"), False)
    assert isinstance(storage, ShardingRules)
    assert storage.rules["attn_in"] == ("data",)
