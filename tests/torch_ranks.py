"""Spawned gloo ranks for the port's distributed tests, and the programs
they run.

``run_ranks(program, world, tmp_path, **args)`` starts ``world`` Python
processes of this file, each of which joins one gloo process group through
a ``file://`` rendezvous in ``tmp_path`` (no port is fixed, so the suite's
xdist workers cannot collide), runs ``PROGRAMS[program](**args)`` and
writes its result with ``torch.save``.  The group, every collective and
the join carry a deadline, so a hang fails the test instead of eating the
suite's clock.  Inputs travel as ``.npz`` files written by the test; the
programs import torch and the port only (the JAX reference runs in its
own process, ``tests/jax_dist_ref.py``).
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import time
import uuid

import numpy as np
import torch

from repro_torch.models.common import tree_leaves

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "src")
#: seconds a spawn of ranks may take, start-up included (also each
#: collective's timeout in the ranks' process group)
DEADLINE = 60.0
#: seconds the JAX reference's process may take: it compiles every case
#: (a hang still fails; the reference's own subprocess tests allow 600 s)
REFERENCE_DEADLINE = 300.0


def start(args: list, tmp_path, tag: str, env: dict | None = None):
    """A child process with its output in a file under ``tmp_path``."""
    log = open(os.path.join(str(tmp_path), f"{tag}.log"), "w+")
    e = dict(os.environ, PYTHONPATH=os.pathsep.join([_SRC, _HERE]),
             OMP_NUM_THREADS="1", **(env or {}))
    e.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, *args], stdout=log,
                            stderr=subprocess.STDOUT, env=e), log


def finish(procs: list, deadline: float) -> None:
    """Wait for every ``(process, log)`` until ``deadline`` (monotonic);
    kill them all and fail with their logs if one is late or fails."""
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        for p, _ in procs:
            p.kill()
            p.wait(timeout=10)
    bad = [(p, log) for p, log in procs if p.returncode != 0]
    tails = []
    for p, log in procs:
        log.seek(0)
        if (p, log) in bad:
            tails.append(f"--- exit {p.returncode}\n{log.read()[-3000:]}")
        log.close()
    assert not bad, "\n".join(tails)


def spawn_ranks(program: str, world: int, tmp_path, **args) -> tuple:
    """Start ``world`` ranks of ``program``; returns what :func:`collect`
    takes (so a test can run the JAX reference meanwhile)."""
    tag = f"{program}_{world}_{uuid.uuid4().hex[:8]}"
    out = os.path.join(str(tmp_path), tag)
    os.makedirs(out)
    with open(os.path.join(out, "args.json"), "w") as f:
        json.dump(args, f)
    init = os.path.join(out, "rendezvous")
    procs = [start([__file__, program, str(r), str(world), init, out],
                   tmp_path, f"{tag}_r{r}") for r in range(world)]
    return procs, out, world


def collect(spawned: tuple, deadline: float = DEADLINE) -> list:
    """Every rank's result, in rank order."""
    procs, out, world = spawned
    finish(procs, time.monotonic() + deadline)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def run_ranks(program: str, world: int, tmp_path, **args) -> list:
    return collect(spawn_ranks(program, world, tmp_path, **args))


def spawn_reference(program: str, n_devices: int, tmp_path, inputs: str,
                    **args) -> tuple:
    """Start ``tests/jax_dist_ref.py PROGRAM`` on ``n_devices`` forced host
    devices; :func:`collect_reference` returns its ``.npz`` as a dict."""
    outp = os.path.join(str(tmp_path), f"ref_{program}_{uuid.uuid4().hex[:8]}"
                        f".npz")
    proc = start([os.path.join(_HERE, "jax_dist_ref.py"), program,
                  str(n_devices), inputs, outp, json.dumps(args)],
                 tmp_path, os.path.basename(outp)[:-4])
    return [proc], outp


def collect_reference(spawned: tuple,
                      deadline: float = REFERENCE_DEADLINE) -> dict:
    procs, outp = spawned
    finish(procs, time.monotonic() + deadline)
    return dict(np.load(outp))


# ------------------------------------------------------------------ programs

def _mesh(shape):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).view(*shape),
                      mesh_dim_names=("data", "model"))


def _rules(fsdp: bool = False, dense_whole: bool = False):
    from repro_torch.distributed import ShardingRules

    rules = ShardingRules()
    if fsdp:
        rules = rules.override(expert_mlp="data")
    if dense_whole:
        rules = rules.override(qheads=None, kv_heads=None, mlp=None,
                               vocab=None)
    return rules


def _local(ctx, specs: dict, full: dict) -> dict:
    """This rank's blocks of the full numpy leaves ``full`` (flat keys), as
    tensors of their own (a step updates them in place)."""
    out = {}
    for key, s in tree_leaves(specs):
        spec = ctx.spec(s.logical, s.shape)
        out[key] = torch.tensor(full[key][ctx.mesh.local_slices(
            spec, s.shape)])
    return out


def moe(inputs: str, cases: list) -> dict:
    """``moe_block`` on each (D, M, fsdp, cf) case whose mesh has this
    world's size: the objective mean_t(y_t . cot_t) + lb on this rank's
    batch rows, its gradients reduced to the global objective's (each
    rank's blocks).  On four ranks also ``below_rule``: per (D, M, fsdp)
    in ``BELOW_RULE``, ``moe_block`` on the expert shards and this rank's
    batch rows at S 3, where M does not divide S and the one-hot path is
    chosen: its output and load-balance loss without grad, and its
    gradients under grad (``_one_hot_grads``); and ``one_hot_1x4``: the
    one-hot path on the (1, 4) mesh's expert shards at each of
    ``ONE_HOT_SHAPES`` (below the a2a rule), without grad and under
    grad."""
    import torch.distributed as dist

    from repro_torch.configs import reduced_config
    from repro_torch.distributed import activate
    from repro_torch.models.moe import moe_block, moe_specs

    data = dict(np.load(inputs))
    out = {}
    for D, M, fsdp, cf in cases:
        if D * M != dist.get_world_size():
            continue
        cfg = reduced_config("olmoe-1b-7b").replace(
            dtype="float32", capacity_factor=cf)
        with activate(_mesh((D, M)), _rules(fsdp)) as ctx:
            specs = moe_specs(cfg)
            p = {k: v.requires_grad_(True)
                 for k, v in _local(ctx, specs, data).items()}
            bi, nb = ctx.batch_shard()
            rows = slice(bi * data["x"].shape[0] // nb,
                         (bi + 1) * data["x"].shape[0] // nb)
            x = torch.from_numpy(data["x"][rows]).requires_grad_(True)
            cot = torch.from_numpy(data["cot"][rows])
            y, lb = moe_block(p, cfg, x)
            obj = (y * cot).sum(-1).mean() + lb
            keys = sorted(p)
            grads = torch.autograd.grad(obj, [x] + [p[k] for k in keys])
            gx, gp = grads[0] / nb, dict(zip(keys, grads[1:]))
            data_group = ctx.mesh.group(("data",))
            for k in keys:
                fsdp_leaf = fsdp and k != "router" and D > 1
                if not fsdp_leaf:
                    dist.all_reduce(gp[k], group=data_group)
                gp[k] /= nb
        out[f"{D}x{M}_fsdp{int(fsdp)}_cf{cf}"] = {
            "y": y.detach(), "lb": lb.detach(), "gx": gx, "grads": gp,
            "rows": (rows.start, rows.stop), "slices": {
                k: [(sl.start, sl.stop) for sl in ctx.mesh.local_slices(
                    ctx.spec(s.logical, s.shape), s.shape)]
                for k, s in specs.items()}}
    if dist.get_world_size() == 4:
        cfg = reduced_config("olmoe-1b-7b").replace(dtype="float32")
        out["below_rule"] = {}
        for D, M, fsdp in BELOW_RULE:
            with activate(_mesh((D, M)), _rules(fsdp)) as ctx:
                p = _local(ctx, moe_specs(cfg), data)
                bi, nb = ctx.batch_shard()
                n = data["x"].shape[0] // nb
                rows = slice(bi * n, (bi + 1) * n)
                x = torch.from_numpy(np.ascontiguousarray(
                    data["x"][rows, :3]))
                with torch.no_grad():
                    y, lb = moe_block(p, cfg, x)
                grads = _one_hot_grads(ctx, cfg, p, x, torch.from_numpy(
                    np.ascontiguousarray(data["cot"][rows, :3])), nb)
            out["below_rule"][f"{D}x{M}_fsdp{int(fsdp)}"] = {
                "y": y, "lb": lb, "rows": (rows.start, rows.stop), **grads}
        out["one_hot_1x4"] = {}
        with activate(_mesh((1, 4)), _rules()) as ctx:
            p = _local(ctx, moe_specs(cfg), data)
            for b, s in ONE_HOT_SHAPES:
                x = torch.from_numpy(np.ascontiguousarray(
                    data["x"][:b, :s]))
                with torch.no_grad():
                    got = moe_block(p, cfg, x)
                out["one_hot_1x4"][f"{b}x{s}"] = got
                out["one_hot_1x4"][f"{b}x{s}/grad"] = _one_hot_grads(
                    ctx, cfg, p, x, torch.from_numpy(np.ascontiguousarray(
                        data["cot"][:b, :s])), 1)
    return out


def _one_hot_grads(ctx, cfg, p: dict, x, cot, nb: int) -> dict:
    """``moe_block`` under grad on this rank's rows ``x`` and expert blocks
    ``p``: the gradients of mean_t(y_t . cot_t) + lb over its rows, each
    leaf's reduced as the train step reduces it (summed over the batch
    axes it is not stored over, divided by ``nb``, their size), the
    input's divided by ``nb``, y, lb and each leaf's slices."""
    import torch.distributed as dist

    from repro_torch.models.moe import moe_block, moe_specs

    p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    x = x.clone().requires_grad_(True)
    y, lb = moe_block(p, cfg, x)
    keys = sorted(p)
    g = torch.autograd.grad((y * cot).sum(-1).mean() + lb,
                            [x] + [p[k] for k in keys])
    grads = dict(zip(keys, g[1:]))
    specs = moe_specs(cfg)
    for k in keys:
        s = specs[k]
        stored = {a for part in ctx.layout(s.logical, s.shape)
                  for a in part}
        axes = ctx.mesh.in_order([a for a in ctx.batch_axes()
                                  if a not in stored])
        if axes:
            dist.all_reduce(grads[k], group=ctx.mesh.group(axes))
        grads[k] /= nb
    return {"y_grad_run": y.detach(), "lb": lb.detach(), "gx": g[0] / nb,
            "grads": grads,
            "slices": {k: _slices(ctx, specs[k].logical, specs[k].shape)
                       for k in keys}}


#: meshes whose expert shards meet the one-hot path at S 3 (M does not
#: divide S): experts over model, and over model and data (FSDP)
BELOW_RULE = [(1, 4, False), (2, 2, True)]
#: (B, S) below the a2a rule on a (1, 4) mesh: M does not divide S, and
#: fewer than 4 M tokens
ONE_HOT_SHAPES = [(4, 3), (1, 4)]


def dp_train(inputs: str, cases: list) -> dict:
    """The port's train step under a (D, M) mesh per case (name, arch, D,
    M, remat, cf, steps, rules) whose mesh has this world's size (rules:
    "whole" keeps the dense leaves whole, "whole_fsdp" adds
    ``expert_mlp="data"``, "default" are the default rules):
    each rank feeds its batch rows and holds its parameter shards; the
    losses, clip norms and final shards (or the ``NotImplementedError``
    the step raised)."""
    import torch.distributed as dist

    from repro_torch.configs import reduced_config
    from repro_torch.distributed import activate
    from repro_torch.models.transformer import model_specs
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.weights import unflatten

    data = dict(np.load(inputs))
    out = {}
    for name, arch, D, M, remat, cf, steps, rules in cases:
        if D * M != dist.get_world_size():
            continue
        cfg = reduced_config(arch).replace(dtype="float32", remat=remat,
                                           capacity_factor=cf)
        opt = AdamWConfig(lr=1e-2, eps=1e-3, warmup_steps=1,
                          decay_steps=steps)
        full = {k[len(arch) + 1:]: v for k, v in data.items()
                if k.startswith(arch + "/")}
        res = {"losses": [], "grad_norms": []}
        with activate(_mesh((D, M)), _rules(
                fsdp=rules == "whole_fsdp",
                dense_whole=rules != "default")) as ctx:
            specs = model_specs(cfg)
            local = _local(ctx, specs, full)
            res["slices"] = {
                k: [(sl.start, sl.stop) for sl in ctx.mesh.local_slices(
                    ctx.spec(s.logical, s.shape), s.shape)]
                for k, s in tree_leaves(specs)}
            state = init_train_state(unflatten(local), opt)
            step = make_train_step(cfg, opt)
            bi, nb = ctx.batch_shard()
            for i in range(steps):
                toks = data[f"tokens/{arch}"][i]
                n = toks.shape[0] // nb
                try:
                    state, m = step(state, {"tokens": torch.from_numpy(
                        toks[bi * n:(bi + 1) * n])})
                except NotImplementedError as e:
                    res["raised"] = str(e)
                    break
                res["losses"].append(m["loss"].item())
                res["grad_norms"].append(m["grad_norm"].item())
        res["params"] = {k: v.detach().clone()
                         for k, v in tree_leaves(state["params"])}
        out[name] = res
    return out


#: the stub inputs of the encdec and vlm families, by batch key
STUBS = ("frames", "patches")


def _batch(data: dict, arch: str, i: int, rows: slice) -> dict:
    """This rank's ``rows`` of batch ``i`` of ``arch``: its tokens, and
    its frames or patches where the inputs hold them (``STUBS/ARCH``
    ``[steps, B, n, F]``)."""
    out = {"tokens": torch.from_numpy(data[f"tokens/{arch}"][i][rows])}
    for k in STUBS:
        if f"{k}/{arch}" in data:
            out[k] = torch.from_numpy(data[f"{k}/{arch}"][i][rows])
    return out


def tp_train(inputs: str, cases: list, root: str) -> dict:
    """The port's train step per case (name, arch, D, M, steps, loss_dtype,
    remat, zero1, save) whose mesh has this world's size, under the
    storage rules of ``launch.dryrun.rules_for`` (tensor parallelism, the
    dense FSDP of its archs, expert FSDP), from
    ``init_sharded_train_state`` (ZeRO-1 moments with ``zero1``), on this
    rank's rows of each batch (``_batch``): each
    step's loss and clip norm, the gradients AdamW received at step 0,
    the moments' bytes and the final blocks with their slices.  With
    ``save``: the state saved through an async ``CheckpointManager``
    under ``root/NAME``, the step ``latest_step`` then sees, this rank's
    moment blocks and their slices, the two step counters, and whether
    ``restore_checkpoint(shardings=)`` gives back this rank's blocks bit
    for bit."""
    import torch.distributed as dist

    import repro_torch.train.step as train_step
    from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                        restore_checkpoint)
    from repro_torch.configs import reduced_config
    from repro_torch.distributed import activate
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.models.common import local_tree
    from repro_torch.models.transformer import model_specs
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.weights import unflatten

    data = dict(np.load(inputs))
    out = {}
    real = train_step.adamw_apply
    for name, arch, D, M, steps, loss_dtype, remat, zero1, save in cases:
        if D * M != dist.get_world_size():
            continue
        cfg = reduced_config(arch).replace(dtype="float32", remat=remat,
                                           loss_dtype=loss_dtype)
        opt = AdamWConfig(lr=1e-2, eps=1e-3, warmup_steps=1,
                          decay_steps=steps, zero1=zero1)
        full = {k[len(arch) + 1:]: v for k, v in data.items()
                if k.startswith(arch + "/")}
        res = {"losses": [], "grad_norms": []}
        # the registry arch's rules (_FSDP_ARCHS names full configs)
        _, storage = rules_for(cfg.replace(name=arch), False)
        with activate(_mesh((D, M)), storage) as ctx:
            specs = model_specs(cfg)
            res["slices"] = {
                k: [(sl.start, sl.stop) for sl in ctx.mesh.local_slices(
                    ctx.spec(s.logical, s.shape), s.shape)]
                for k, s in tree_leaves(specs)}
            state = train_step.init_sharded_train_state(
                unflatten(_local(ctx, specs, full)), cfg, opt)
            step = train_step.make_train_step(cfg, opt)
            bi, nb = ctx.batch_shard()
            seen = []

            def recording(grads, *a, **kw):
                if not seen:
                    seen.append({k: g.detach().clone()
                                 for k, g in tree_leaves(grads)})
                return real(grads, *a, **kw)

            train_step.adamw_apply = recording
            try:
                n = data[f"tokens/{arch}"].shape[1] // nb
                for i in range(steps):
                    state, m = step(state, _batch(
                        data, arch, i, slice(bi * n, (bi + 1) * n)))
                    res["losses"].append(m["loss"].item())
                    res["grad_norms"].append(m["grad_norm"].item())
            finally:
                train_step.adamw_apply = real
            res["grads0"] = seen[0]
            res["moment_bytes"] = sum(
                t.numel() * t.element_size()
                for k in ("m", "v") for _, t in tree_leaves(state["opt"][k]))
            if save:
                shardings = train_step.train_state_shardings(cfg, state)
                d = os.path.join(root, name)
                mgr = CheckpointManager(d, every_steps=steps, keep=1)
                assert mgr.maybe_save(steps, state, shardings=shardings)
                mgr.wait()
                res["latest_step"] = latest_step(d)
                res["steps"] = (state["opt"]["step"].clone(),
                                state["step"].clone())
                flat_sh = dict(tree_leaves(shardings["opt"]))
                res["opt"] = {k: t.detach().clone() for k, t in
                              tree_leaves(state["opt"]) if k != "step"}
                res["opt_slices"] = {}
                for k, t in res["opt"].items():
                    pl = flat_sh[k]
                    shape = full[k.split("/", 1)[1]].shape
                    res["opt_slices"][k] = [
                        (sl.start, sl.stop) for sl in pl.mesh.local_slices(
                            pl.spec, shape)]
                back, got = restore_checkpoint(d, state, device="cpu",
                                               shardings=shardings)
                back = dict(tree_leaves(local_tree(back)))
                res["restored_step"] = got
                res["restored_bit_exact"] = all(
                    torch.equal(back[k], t.detach())
                    for k, t in tree_leaves(state))
        res["params"] = {k: v.detach().clone()
                         for k, v in tree_leaves(state["params"])}
        out[name] = res
    if "mamba/x" in data and dist.get_world_size() == 2:
        out["mamba_block"] = _mamba_block(data, "mamba", MAMBA_CFG(), (1, 2),
                                          ("shared_sum", "identity"))
    if "mamba/x" in data and dist.get_world_size() == 4:
        out["mamba_block_w_in_whole"] = _mamba_block(
            data, "mamba_w_in_whole", MAMBA_W_IN_WHOLE_CFG(), (1, 4),
            ("shared_sum",))
    if dist.get_world_size() == 2:
        for arch in MEMORY_ARCHS:
            if f"tokens/{arch}" in data:
                out[f"memory_grads/{arch}"] = _memory_grads(data, arch)
    return out


#: the archs whose memory gradient the (1, 2) ranks report
MEMORY_ARCHS = ("whisper-large-v3", "llama-3.2-vision-11b")


def _memory_grads(data: dict, arch: str) -> dict:
    """The gradients of ``lm_loss`` on batch 0 on a (1, 2) mesh under the
    arch's ``rules_for`` storage rules, whose cross-attention reads the
    memory on this rank's heads, per variant: ``copy_to_model`` as it is
    (``sound``), and a stand-in that passes the memory by
    (``memory_skips_copy``: the memory's gradient stays this rank's heads'
    part) -- ``frontend_proj``'s, and every encoder leaf's with the slices
    of this rank's blocks."""
    from repro_torch.configs import reduced_config
    from repro_torch.distributed import activate
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.models import transformer as T
    from repro_torch.weights import unflatten

    cfg = reduced_config(arch).replace(dtype="float32")
    full = {k[len(arch) + 1:]: v for k, v in data.items()
            if k.startswith(arch + "/")}
    real_copy, real_encode = C.copy_to_model, T.encode
    out = {}
    with activate(_mesh((1, 2)), rules_for(cfg.replace(name=arch),
                                           False)[1]) as ctx:
        specs = T.model_specs(cfg)
        for variant in ("sound", "memory_skips_copy"):
            local = {k: v.requires_grad_(True)
                     for k, v in _local(ctx, specs, full).items()}
            memory = []
            if variant == "memory_skips_copy":
                def encode(*a, **kw):
                    memory.append(real_encode(*a, **kw))
                    return memory[-1]

                T.encode = encode
                C.copy_to_model = lambda t, g: t if any(
                    t is m for m in memory) else real_copy(t, g)
            try:
                loss = T.lm_loss(unflatten(local), cfg,
                                 _batch(data, arch, 0, slice(None)))
                keys = [k for k in sorted(local) if k == "frontend_proj"
                        or k.startswith("encoder/")]
                grads = torch.autograd.grad(loss, [local[k] for k in keys])
            finally:
                C.copy_to_model, T.encode = real_copy, real_encode
            out[variant] = dict(zip(keys, grads))
        out["slices"] = {
            k: [(sl.start, sl.stop) for sl in ctx.mesh.local_slices(
                ctx.spec(s.logical, s.shape), s.shape)]
            for k, s in tree_leaves(specs)}
    return out


def MAMBA_CFG():
    """Reduced zamba2 at f32: its Mamba2 block (2 SSM heads, ``w_in`` 290
    columns)."""
    from repro_torch.configs import reduced_config

    return reduced_config("zamba2-7b").replace(dtype="float32")


def MAMBA_W_IN_WHOLE_CFG():
    """Reduced zamba2 with 4 SSM heads and a state of 17: on four ranks
    the heads tile the model axis while ``w_in``'s 294 columns do not (the
    rules keep it whole)."""
    return MAMBA_CFG().replace(ssm_heads=4, ssm_state=17)


def _mamba_block(data: dict, prefix: str, cfg, shape: tuple,
                 variants: tuple) -> dict:
    """One Mamba2 block of ``cfg`` on a ``shape`` mesh under reduced
    zamba2's ``rules_for`` storage rules (each rank on its SSM heads),
    with ``data``'s leaves, input and cotangent under ``prefix``: the
    output and the gradients of ``sum(y * cot)`` -- the input's, and each
    leaf's block, the leaves ``mamba_partial_leaves`` names summed over
    ``model`` as the train step sums them -- per variant: the gated
    norm's ``shared_sum`` as it is (``shared_sum``) or a stand-in whose
    backward is the identity (``identity``: ``reduce_from_model``)."""
    import torch.distributed as dist

    from repro_torch.distributed import activate
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.models import ssm

    specs = ssm.mamba2_specs(cfg)
    full = {k: data[f"{prefix}/{k}"] for k in specs}
    real = C.shared_sum
    out = {}
    with activate(_mesh(shape), rules_for(cfg, False)[1]) as ctx:
        for variant in variants:
            p = {k: v.requires_grad_(True)
                 for k, v in _local(ctx, specs, full).items()}
            x = torch.tensor(data[f"{prefix}/x"], requires_grad=True)
            if variant == "identity":
                C.shared_sum = C.reduce_from_model
            try:
                y = ssm.mamba2_forward(p, cfg, x)
                keys = sorted(p)
                g = torch.autograd.grad((y * torch.from_numpy(
                    data[f"{prefix}/cot"])).sum(), [x] + [p[k] for k in keys])
            finally:
                C.shared_sum = real
            grads = dict(zip(keys, g[1:]))
            for k in ssm.mamba_partial_leaves(cfg):
                dist.all_reduce(grads[k], group=ctx.model_group())
            out[variant] = {"y": y.detach(), "gx": g[0], "grads": grads,
                            "heads": ssm.mamba_heads(cfg),
                            "partial": ssm.mamba_partial_leaves(cfg),
                            "slices": {
                                k: [(sl.start, sl.stop) for sl in
                                    ctx.mesh.local_slices(ctx.spec(
                                        s.logical, s.shape), s.shape)]
                                for k, s in specs.items()}}
    return out


def compression(inputs: str, steps: int) -> dict:
    """On a 4-rank data mesh: this rank's (q, scale) of its row of ``g``,
    ``compressed_reduce_scatter`` and ``compressed_mean`` of it, then
    ``steps`` error-feedback steps of ``make_compressed_allreduce`` on
    grads every rank holds alike (``same``) and on each rank's own
    (``own``); the dtype of every ``all_to_all_single`` input, recorded
    through a wrapper."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed import Mesh
    from repro_torch.optim import compression as Q

    data = dict(np.load(inputs))
    r = dist.get_rank()
    dm = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("data",))
    group = Mesh.of(dm).group(("data",))
    wire = []
    real = dist.all_to_all_single

    def recording(out, inp, *a, **kw):
        wire.append(str(inp.dtype))
        return real(out, inp, *a, **kw)

    dist.all_to_all_single = recording
    try:
        g = torch.from_numpy(data["g"][r])
        q, scale = Q.quantize_int8(g)
        res = {"q": q, "scale": scale,
               "rs": Q.compressed_reduce_scatter(g, group),
               "mean": Q.compressed_mean(g, group)}
        reduce = Q.make_compressed_allreduce(dm, ("data",))
        for kind, rows in (("same", lambda t: data["same"][t]),
                           ("own", lambda t: data["own"][t][r])):
            err = torch.zeros(data[kind].shape[-1])
            for t in range(steps):
                m, err = reduce(torch.from_numpy(rows(t)), err)
                res[f"{kind}/mean{t}"], res[f"{kind}/err{t}"] = m, err
    finally:
        dist.all_to_all_single = real
    res["wire"] = wire
    return res


def restore(root: str, step: int, ports: list, arch: str, shape: list,
            fsdp: bool) -> dict:
    """A checkpoint of ``arch``'s reduced config restored over loopback
    mirrors with ``shardings=sharding_tree(...)`` on a ``shape`` mesh built
    by ``make_local_mesh``; this rank's local shards, their placements, the
    ``full_tensor()`` of every leaf, ``plan_for_ctx`` and the mesh's
    coordinate; the bytes the restore copied out into this rank's leaves;
    ``distribute_tree`` / ``constrain`` / ``local_tree`` of the restored
    full tree; and ``make_production_mesh``'s error here."""
    import torch.distributed as dist

    from repro_torch.checkpoint import manager, restore_checkpoint
    from repro_torch.configs import reduced_config
    from repro_torch.distributed import activate, constrain
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    from repro_torch.models.common import (distribute_tree, full_tree,
                                           local_tree, sharding_tree)
    from repro_torch.models.transformer import model_specs
    from repro_torch.transfer import Replica
    from repro_torch.transfer.shard import plan_for_ctx

    specs = model_specs(reduced_config(arch))
    dm = make_local_mesh(*shape, device="cpu")
    out = {"rank": dist.get_rank(), "coordinate": dm.get_coordinate()}
    made = []

    class Recorded(manager._StreamingRestore):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    with activate(dm, _rules(fsdp)):
        shardings = sharding_tree(specs)
        manager._StreamingRestore = Recorded
        try:
            tree, got = restore_checkpoint(
                root, specs, step=step, device="cpu", shardings=shardings,
                replicas=[Replica("127.0.0.1", p, "/ckpt") for p in ports])
        finally:
            manager._StreamingRestore = Recorded.__base__
        out["landed_bytes"] = sum(s.landed_bytes for s in made)
        flat = dict(tree_leaves(tree))
        out["step"] = got
        out["local"] = {k: t.to_local().clone() for k, t in flat.items()}
        out["placements"] = {k: [repr(p) for p in t.placements]
                             for k, t in flat.items()}
        out["full"] = dict(tree_leaves(full_tree(tree)))
        again = distribute_tree(full_tree(tree), shardings)
        out["redistributed"] = dict(tree_leaves(local_tree(again)))
        emb = flat["embed"]
        out["constrained"] = constrain(emb, "vocab", None).full_tensor()
        out["host"], plan = plan_for_ctx(4096)
        out["n_hosts"] = plan.n_hosts
    try:
        make_production_mesh(device="cpu")
    except ValueError as e:
        out["production_error"] = str(e)
    return out


def _serve_loop(step, params, cache, prompt, s_max):
    """The serve step over a prompt, teacher-forced, then greedy to
    ``s_max`` tokens, as ``launch.serve.generate`` runs it: the tokens,
    the logits of every step and the cache's leaves after every step."""
    toks, logits, caches, nxt = prompt, [], [], None
    for t in range(s_max):
        if t >= prompt.shape[1]:
            toks = torch.cat([toks, nxt], dim=1)
        nxt, lg, _ = step(params, cache, toks[:, t:t + 1],
                          torch.tensor(t, dtype=torch.int32))
        logits.append(lg.clone())
        caches.append({k: v.clone() for k, v in tree_leaves(cache)})
    return toks, logits, caches


def decode(inputs: str, cases: list, root: str) -> dict:
    """Decode under a mesh per case (name, arch, D, M, B, S_max,
    prompt_len, cf, save) whose mesh has this world's size, under
    ``launch.dryrun.serve_rules`` of the registry arch: each rank's blocks
    of the parameters, ``init_cache`` under the context, then the serve
    step over the prompt and greedy to S_max (tokens, each step's logits,
    the cache's blocks after each step), the same through
    ``generate(capture=False)``, this rank's ``KVBlock``, each cache
    leaf's block as ``ShardingCtx.block`` gives it (a stacked leaf's
    layers whole), and what ``generate(capture=True)`` and
    ``CapturedServeStep`` raise on the gloo mesh.  encdec and vlm decode
    against the memory of ``frames/NAME`` / ``patches/NAME`` ``[B, n,
    F]``: ``encode`` of the whole batch under the context, this rank's
    rows written into the cache (``generate`` is given the whole).  With
    ``save``: the blocks saved as a sharded checkpoint under ``root/NAME``,
    restored with ``shardings=`` under the same rules and decoded again
    (its logits)."""
    import torch.distributed as dist

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import reduced_config
    from repro_torch.distributed import activate
    from repro_torch.launch.dryrun import serve_rules
    from repro_torch.launch.serve import generate
    from repro_torch.models.common import local_tree, sharding_tree
    from repro_torch.models.transformer import (cache_specs, encode,
                                                init_cache, model_specs)
    from repro_torch.serve.step import CapturedServeStep, make_serve_step
    from repro_torch.weights import unflatten

    data = dict(np.load(inputs))
    out = {}
    for name, arch, D, M, B, s_max, prompt_len, cf, save in cases:
        if D * M != dist.get_world_size():
            continue
        cfg = reduced_config(arch).replace(dtype="float32",
                                           capacity_factor=cf)
        full = {k[len(arch) + 1:]: v for k, v in data.items()
                if k.startswith(arch + "/")}
        mesh = _mesh((D, M))
        prompt = torch.from_numpy(data[f"prompt/{name}"]).long()
        res = {}
        with activate(mesh, serve_rules(cfg.replace(name=arch), mesh, B)) \
                as ctx, torch.no_grad():
            specs = model_specs(cfg)
            params = unflatten(_local(ctx, specs, full))
            stub = next((k for k in STUBS if f"{k}/{name}" in data), None)
            memory, mem_len = None, 0
            if stub is not None:
                memory = encode(params, cfg, {stub: torch.from_numpy(
                    data[f"{stub}/{name}"])})
                mem_len = memory.shape[1]
            rows = ctx.batch_rows(B)[0]

            def new_cache():
                c = init_cache(cfg, B, s_max, "cpu", mem_len=mem_len)
                if memory is not None:
                    c["memory"].copy_(memory[rows])
                return c

            cache = new_cache()
            step = make_serve_step(cfg)
            res["tokens"], res["logits"], res["caches"] = _serve_loop(
                step, params, cache, prompt, s_max)
            blk = ctx.kv_block((B, s_max, cfg.n_kv_heads, cfg.hd))
            res["block"] = [(sl.start, sl.stop)
                            for sl in (blk.rows, blk.keys, blk.heads)]
            res["seq_axes"], res["batch_axes"] = blk.seq_axes, blk.batch_axes
            res["slices"] = {}
            for key, sp in tree_leaves(cache_specs(cfg, B, s_max, mem_len)):
                if key == "memory":     # its batch rows (init_cache)
                    res["slices"][key] = [(rows.start, rows.stop)] + [
                        (0, n) for n in sp.shape[1:]]
                    continue
                lead = int(sp.logical[0] == "layers")
                res["slices"][key] = [(0, n) for n in sp.shape[:lead]] + [
                    (sl.start, sl.stop) for sl in ctx.block(
                        sp.logical[lead:], sp.shape[lead:])]
            res["generate"] = generate(cfg, params, prompt, s_max - prompt_len,
                                       device="cpu", capture=False,
                                       memory=memory)
            for what, fn in (
                    ("generate", lambda: generate(cfg, params, prompt, 1,
                                                  device="cpu")),
                    ("captured", lambda: CapturedServeStep(
                        cfg, params, B, s_max, device="cpu",
                        mem_len=mem_len))):
                try:
                    fn()
                    res[f"{what}_raised"] = None
                except NotImplementedError as e:
                    res[f"{what}_raised"] = str(e)
            if save:
                shardings = sharding_tree(specs)
                d = os.path.join(root, name)
                save_checkpoint(d, 1, params, shardings=shardings)
                back, _ = restore_checkpoint(d, specs, device="cpu",
                                             shardings=shardings)
                restored = local_tree(back)
                res["restored_equal"] = all(
                    torch.equal(a, b) for (_, a), (_, b) in zip(
                        tree_leaves(restored), tree_leaves(params)))
                cache = new_cache()
                _, res["restored_logits"], _ = _serve_loop(
                    step, restored, cache, prompt, s_max)
        out[name] = res
    return out


#: the multi-pod mesh's axes (``launch.mesh.make_production_mesh(
#: multi_pod=True)``'s, at a small size)
POD_AXES = ("pod", "data", "model")


def _pod_mesh(shape):
    """A (pod, data, model) mesh of the process group's ranks, built by
    the code ``make_production_mesh`` builds its mesh with."""
    from repro_torch.launch.mesh import _mesh

    return _mesh(tuple(shape), POD_AXES, "cpu")


def _slices(ctx, logical, shape) -> list:
    return [(sl.start, sl.stop) for sl in ctx.mesh.local_slices(
        ctx.spec(logical, shape), shape)]


def _pod_train(data: dict, case: list, root: str) -> dict:
    """One case (name, arch, mesh shape, save) of ``multipod``: one train
    step of ``arch``'s reduced config at f32 under the multi-pod storage
    rules with ZeRO-1 moments, on this rank's rows of batch 0; its loss
    and clip norm, the gradients AdamW received, the updated parameter
    and moment blocks with their slices.  With ``save``: the state saved
    under ``root/NAME`` with ``shardings=`` and restored with them onto
    the mesh (its local blocks and ``full_tree``)."""
    import repro_torch.train.step as train_step
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import reduced_config
    from repro_torch.distributed import activate
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.models.common import full_tree, local_tree
    from repro_torch.models.transformer import model_specs
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.weights import unflatten

    name, arch, shape, save = case
    cfg = reduced_config(arch).replace(dtype="float32")
    opt = AdamWConfig(lr=1e-2, eps=1e-3, warmup_steps=1, decay_steps=1,
                      zero1=True)
    full = {k[len(arch) + 1:]: v for k, v in data.items()
            if k.startswith(arch + "/")}
    _, storage = rules_for(cfg.replace(name=arch), True)
    res = {}
    with activate(_pod_mesh(shape), storage) as ctx:
        specs = model_specs(cfg)
        res["slices"] = {k: _slices(ctx, s.logical, s.shape)
                         for k, s in tree_leaves(specs)}
        state = train_step.init_sharded_train_state(
            unflatten(_local(ctx, specs, full)), cfg, opt)
        step = train_step.make_train_step(cfg, opt)
        bi, nb = ctx.batch_shard()
        real, seen = train_step.adamw_apply, []

        def recording(grads, *a, **kw):
            seen.append({k: g.detach().clone()
                         for k, g in tree_leaves(grads)})
            return real(grads, *a, **kw)

        train_step.adamw_apply = recording
        try:
            n = data[f"tokens/{name}"].shape[1] // nb
            state, m = step(state, _batch(
                {f"{k}/{arch}": data[f"{k}/{name}"] for k in
                 ("tokens", *STUBS) if f"{k}/{name}" in data}, arch, 0,
                slice(bi * n, (bi + 1) * n)))
        finally:
            train_step.adamw_apply = real
        res.update(loss=m["loss"].item(), grad_norm=m["grad_norm"].item(),
                   grads0=seen[0], params={
                       k: v.detach().clone()
                       for k, v in tree_leaves(state["params"])})
        shardings = train_step.train_state_shardings(cfg, state)
        flat_sh = dict(tree_leaves(shardings))
        res["opt"] = {k: t.clone() for k, t in tree_leaves(state["opt"])
                      if k != "step"}
        res["opt_slices"] = {
            k: [(sl.start, sl.stop) for sl in flat_sh[f"opt/{k}"].mesh
                .local_slices(flat_sh[f"opt/{k}"].spec,
                              full[k.split("/", 1)[1]].shape)]
            for k in res["opt"]}
        if save:
            d = os.path.join(root, name)
            save_checkpoint(d, 1, state, shardings=shardings)
            back, _ = restore_checkpoint(d, state, device="cpu",
                                         shardings=shardings)
            res["restored_local"] = dict(tree_leaves(local_tree(back)))
            res["restored_full"] = dict(tree_leaves(full_tree(back)))
            res["placements"] = {
                k: (tuple(repr(p) for p in pl), pl.axes)
                for k, pl in flat_sh.items() if pl is not None}
            res["state"] = {k: t.detach().clone()
                            for k, t in tree_leaves(state)}
    return res


def _pod_moe(data: dict, case: list) -> dict:
    """One case (tag, mesh shape, axis names, multi_pod, B, S) of
    ``multipod``: ``moe_block`` of reduced olmoe at f32 under grad on
    this rank's rows of ``x[:B, :S]`` and its expert blocks, below the
    a2a rule (the one-hot path across ranks), under the multi-pod storage
    rules (``multi_pod``) or the default ones (``_one_hot_grads``)."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import reduced_config
    from repro_torch.distributed import ShardingRules, activate
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.models.moe import moe_specs

    tag, shape, names, multi_pod, B, S = case
    cfg = reduced_config("olmoe-1b-7b").replace(dtype="float32")
    rules = (rules_for(cfg, True)[1] if multi_pod else ShardingRules())
    mesh = DeviceMesh("cpu", torch.arange(int(np.prod(shape))).view(
        *shape), mesh_dim_names=tuple(names))
    with activate(mesh, rules) as ctx:
        bi, nb = ctx.batch_shard()
        rows = slice(bi * B // nb, (bi + 1) * B // nb)
        return {"rows": (rows.start, rows.stop), **_one_hot_grads(
            ctx, cfg, _local(ctx, moe_specs(cfg), data),
            torch.tensor(data["x"][rows, :S]),
            torch.tensor(data["cot"][rows, :S]), nb)}


def _pod_decode(data: dict, case: list) -> dict:
    """One case (name, arch, mesh shape, B, S_max, prompt_len) of
    ``multipod``: decode of ``arch``'s reduced config at f32 under
    ``serve_rules(..., multi_pod=True)``, the prompt teacher-forced and
    greedy to S_max (tokens, each step's logits), the same through
    ``generate(capture=False)``, this rank's cache blocks, and what
    ``CapturedServeStep`` raises on the gloo mesh."""
    from repro_torch.configs import reduced_config
    from repro_torch.distributed import activate
    from repro_torch.launch.dryrun import serve_rules
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import init_cache, model_specs
    from repro_torch.serve.step import CapturedServeStep, make_serve_step
    from repro_torch.weights import unflatten

    name, arch, shape, B, s_max, prompt_len = case
    cfg = reduced_config(arch).replace(dtype="float32")
    full = {k[len(arch) + 1:]: v for k, v in data.items()
            if k.startswith(arch + "/")}
    mesh = _pod_mesh(shape)
    res = {}
    with activate(mesh, serve_rules(cfg.replace(name=arch), mesh, B,
                                    multi_pod=True)) as ctx, \
            torch.no_grad():
        params = unflatten(_local(ctx, model_specs(cfg), full))
        cache = init_cache(cfg, B, s_max, "cpu")
        prompt = torch.from_numpy(data[f"prompt/{name}"]).long()
        res["tokens"], res["logits"], _ = _serve_loop(
            make_serve_step(cfg), params, cache, prompt, s_max)
        res["generate"] = generate(cfg, params, prompt, s_max - prompt_len,
                                   device="cpu", capture=False)
        blk = ctx.kv_block((B, s_max, cfg.n_kv_heads, cfg.hd))
        res["block"] = [(sl.start, sl.stop)
                        for sl in (blk.rows, blk.keys, blk.heads)]
        res["batch_axes"] = blk.batch_axes
        try:
            CapturedServeStep(cfg, params, B, s_max, device="cpu")
            res["captured_raised"] = None
        except NotImplementedError as e:
            res["captured_raised"] = str(e)
    return res


def _pod_order(shape) -> dict:
    """The collectives over ``("data", "pod")`` on a (pod, data, model)
    mesh: each rank's data-major block of ``arange(8 * 3)`` gathered
    (``gather_dim``), its gradient reduce-scattered back (the gradient of
    sum(gathered * w) for a known w), ``split`` of the whole, and
    ``all_gather_stacked``; the same gather with the group's recorded
    member order dropped (``mutated``: the members in global-rank order,
    pod-major), which a sound check must tell apart; this rank's
    coordinate and group rank."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.context import Mesh, PartitionSpec

    mesh = Mesh.of(_pod_mesh(shape))
    axes = ("data", "pod")
    group = mesh.group(axes)
    whole = torch.arange(8 * 3, dtype=torch.float32).view(8, 3)
    block = whole[mesh.local_slices(PartitionSpec(axes), whole.shape)]
    w = torch.arange(8 * 3, dtype=torch.float32).view(8, 3) * 0.5 + 1
    b = block.clone().requires_grad_(True)
    gathered = C.gather_dim(b, group, 0)
    (grad,) = torch.autograd.grad((gathered * w).sum(), [b])
    out = {"coordinate": mesh.coordinate(), "group_rank": C.group_rank(
        group), "block": block, "gathered": gathered.detach(),
        "grad": grad, "split": C.split(whole, group),
        "stacked": C.all_gather_stacked(block, group),
        "members": mesh.member_coords(axes)}
    order = C._ORDER.pop(group)
    try:
        out["mutated"] = C.gather_dim(block, group, 0)
    finally:
        C._ORDER[group] = order
    return out


def multipod(inputs: str, train: list, moe: list, decode: list,
             order: list, root: str) -> dict:
    """The multi-pod production layout on four ranks: ``train`` cases
    (``_pod_train``), ``moe`` cases (``_pod_moe``), ``decode`` cases
    (``_pod_decode``) and the member order of a group over ``("data",
    "pod")`` on an ``order``-shaped mesh (``_pod_order``)."""
    data = dict(np.load(inputs))
    out = {"order": _pod_order(order)}
    for case in train:
        out[case[0]] = _pod_train(data, case, root)
    for case in moe:
        out[case[0]] = _pod_moe({k[len("moe/"):]: v for k, v in data.items()
                                 if k.startswith("moe/")}, case)
    for case in decode:
        out[case[0]] = _pod_decode(data, case)
    return out


PROGRAMS = {"moe": moe, "dp_train": dp_train, "tp_train": tp_train,
            "compression": compression, "restore": restore,
            "decode": decode, "multipod": multipod}


def _main(program: str, rank: int, world: int, init: str, out: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(os.path.join(out, "args.json")) as f:
        args = json.load(f)
    dist.init_process_group(
        "gloo", init_method=f"file://{init}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=DEADLINE))
    try:
        res = PROGRAMS[program](**args)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
          sys.argv[5])
