"""The JAX reference's side of the port's distributed tests.

Run as its own process, with ``N`` forced host devices (JAX fixes the
device count when it starts, and the test process must keep seeing one):

    python tests/jax_dist_ref.py PROGRAM N IN.npz OUT.npz ARGS_JSON

Each program reads its inputs from ``IN.npz`` (written with numpy by the
test), runs the reference on a mesh of the forced devices and writes what
the test compares to ``OUT.npz``.
"""

from __future__ import annotations

import json
import os
import sys


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *path, last = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def moe(data: dict, cases: list) -> dict:
    """``moe_block`` under ``activate`` per (D, M, fsdp, cf): y, lb and the
    gradients of mean_t(y_t . cot_t) + lb."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import reduced_config
    from repro.distributed.context import ShardingRules, activate
    from repro.launch.mesh import make_local_mesh
    from repro.models.moe import moe_block

    out = {}
    p = {k: jnp.asarray(data[k]) for k in ("router", "wi", "wg", "wo")}
    x, cot = jnp.asarray(data["x"]), jnp.asarray(data["cot"])
    for D, M, fsdp, cf in cases:
        cfg = reduced_config("olmoe-1b-7b").replace(
            dtype="float32", capacity_factor=cf)
        rules = ShardingRules()
        if fsdp:
            rules = rules.override(expert_mlp="data")
        with activate(make_local_mesh(D, M), rules):
            def f(p, x):
                y, lb = moe_block(p, cfg, x)
                return jnp.mean(jnp.sum(y * cot, -1)) + lb, (y, lb)

            (_, (y, lb)), (gp, gx) = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True))(p, x)
        name = f"{D}x{M}_fsdp{int(fsdp)}_cf{cf}"
        out[f"{name}/y"], out[f"{name}/lb"] = np.asarray(y), np.asarray(lb)
        out[f"{name}/gx"] = np.asarray(gx)
        for k, g in gp.items():
            out[f"{name}/grads/{k}"] = np.asarray(g)
    return out


def dp_train(data: dict, cases: list) -> dict:
    """``make_train_step`` jitted under ``activate`` per (name, arch, D, M,
    remat, cf, steps, rules): the loss of each step and the final
    parameters.  Rules keep the dense leaves whole; "whole_fsdp" adds
    ``expert_mlp="data"``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import reduced_config
    from repro.distributed.context import ShardingRules, activate
    from repro.launch.mesh import make_local_mesh
    from repro.optim.adamw import AdamWConfig
    from repro.train.step import init_train_state, make_train_step

    whole = ShardingRules().override(qheads=None, kv_heads=None, mlp=None,
                                     vocab=None)
    out = {}
    for name, arch, D, M, remat, cf, steps, rules in cases:
        rules = (whole.override(expert_mlp="data") if rules == "whole_fsdp"
                 else whole)
        cfg = reduced_config(arch).replace(dtype="float32", remat=remat,
                                           capacity_factor=cf)
        params = _nest({k[len(arch) + 1:]: jnp.asarray(v)
                        for k, v in data.items() if k.startswith(arch + "/")})
        opt = AdamWConfig(lr=1e-2, eps=1e-3, warmup_steps=1,
                          decay_steps=steps)
        state = init_train_state(params, opt)
        with activate(make_local_mesh(D, M), rules):
            step = jax.jit(make_train_step(cfg, opt))
            for i in range(steps):
                state, m = step(state, {"tokens": jnp.asarray(
                    data[f"tokens/{arch}"][i])})
                out[f"{name}/loss{i}"] = np.asarray(m["loss"])
                out[f"{name}/grad_norm{i}"] = np.asarray(m["grad_norm"])
        for k, v in _flat(state["params"]).items():
            out[f"{name}/params/{k}"] = np.asarray(v)
    return out


#: the stub inputs of the encdec and vlm families, by batch key
STUBS = ("frames", "patches")


def _batch(data: dict, arch: str, i: int, jnp) -> dict:
    """Batch ``i`` of ``arch``: its tokens, and its frames or patches
    where the inputs hold them (``STUBS/ARCH`` ``[steps, B, n, F]``)."""
    out = {"tokens": jnp.asarray(data[f"tokens/{arch}"][i])}
    for k in STUBS:
        if f"{k}/{arch}" in data:
            out[k] = jnp.asarray(data[f"{k}/{arch}"][i])
    return out


def tp_train(data: dict, cases: list) -> dict:
    """``make_train_step`` jitted under ``activate`` with the compute rules
    of ``repro.launch.dryrun.rules_for`` per (name, arch, D, M, steps,
    loss_dtype, remat): the loss and clip norm of each step, the final
    parameters, and the gradients of the first batch's ``lm_loss``
    (batches: ``_batch``)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    # the launch module adds forced host devices to XLA_FLAGS when it is
    # imported: the backend starts first, with this process's count
    jax.devices()
    from repro.configs import reduced_config
    from repro.distributed.context import activate
    from repro.launch.dryrun import rules_for
    from repro.launch.mesh import make_local_mesh
    from repro.models.transformer import lm_loss
    from repro.optim.adamw import AdamWConfig
    from repro.train.step import init_train_state, make_train_step

    out = {}
    for name, arch, D, M, steps, loss_dtype, remat in cases:
        cfg = reduced_config(arch).replace(dtype="float32", remat=remat,
                                           loss_dtype=loss_dtype)
        # the registry arch's rules (_FSDP_ARCHS names full configs)
        rules, _ = rules_for(cfg.replace(name=arch), False)
        params = _nest({k[len(arch) + 1:]: jnp.asarray(v)
                        for k, v in data.items() if k.startswith(arch + "/")})
        opt = AdamWConfig(lr=1e-2, eps=1e-3, warmup_steps=1,
                          decay_steps=steps)
        with activate(make_local_mesh(D, M), rules):
            grads = jax.jit(jax.grad(lambda p, b: lm_loss(p, cfg, b)))(
                params, _batch(data, arch, 0, jnp))
            state = init_train_state(params, opt)
            step = jax.jit(make_train_step(cfg, opt))
            for i in range(steps):
                state, m = step(state, _batch(data, arch, i, jnp))
                out[f"{name}/loss{i}"] = np.asarray(m["loss"])
                out[f"{name}/grad_norm{i}"] = np.asarray(m["grad_norm"])
        for k, v in _flat(grads).items():
            out[f"{name}/grads/{k}"] = np.asarray(v)
        for k, v in _flat(state["params"]).items():
            out[f"{name}/params/{k}"] = np.asarray(v)
    return out


def decode(data: dict, cases: list) -> dict:
    """``decode_step`` jitted under ``activate`` with ``decode_rules`` of
    the compute rules of ``repro.launch.dryrun.rules_for`` (a decode
    cell's, as ``run_cell`` composes them) per (name, arch, D, M, B,
    S_max, prompt_len, cf): the prompt teacher-forced, then greedy to
    S_max tokens, as the port's ``generate`` runs it; the tokens, each
    step's logits and the cache's leaves after each step.  encdec and vlm
    decode against the memory of ``frames/NAME`` / ``patches/NAME`` ``[B,
    n, F]``: the encoder's output or the projected patches, computed
    under the same mesh and written into the cache first."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.devices()       # the backend starts with this process's count
    from repro.configs import reduced_config
    from repro.distributed.context import activate
    from repro.launch.dryrun import decode_rules, rules_for
    from repro.launch.mesh import make_local_mesh
    from repro.models.transformer import (_encoder_forward, decode_step,
                                          init_cache)

    out = {}
    for name, arch, D, M, B, s_max, prompt_len, cf in cases:
        cfg = reduced_config(arch).replace(dtype="float32",
                                           capacity_factor=cf)
        rules, _ = rules_for(cfg.replace(name=arch), False)
        params = _nest({k[len(arch) + 1:]: jnp.asarray(v)
                        for k, v in data.items() if k.startswith(arch + "/")})
        toks = np.asarray(data[f"prompt/{name}"], np.int32)
        with activate(make_local_mesh(D, M),
                      decode_rules(cfg, rules, B, model_axis=M)):
            step = jax.jit(lambda p, c, t, pos: decode_step(p, cfg, c, t,
                                                            pos))
            stub = next((k for k in STUBS if f"{k}/{name}" in data), None)
            if stub is None:
                cache = init_cache(cfg, B, s_max)
            else:
                src = jnp.asarray(data[f"{stub}/{name}"])
                cache = init_cache(cfg, B, s_max, src.shape[1])
                cache["memory"] = jax.jit(
                    lambda p, f: _encoder_forward(cfg, p, f)
                    if cfg.family == "encdec" else jnp.einsum(
                        "bpf,fd->bpd", f.astype(cfg.jdtype),
                        p["frontend_proj"]))(params, src)
            nxt = None
            for t in range(s_max):
                if t >= prompt_len:
                    toks = np.concatenate([toks, nxt], axis=1)
                logits, cache = step(params, cache, jnp.asarray(
                    toks[:, t:t + 1]), jnp.int32(t))
                nxt = np.asarray(jnp.argmax(logits, axis=-1))[:, None]
                out[f"{name}/logits{t}"] = np.asarray(logits)
                for k, v in _flat(cache).items():
                    out[f"{name}/cache{t}/{k}"] = np.asarray(v)
        out[f"{name}/tokens"] = toks
    return out


def compression(data: dict, steps: int) -> dict:
    """On a (4,) data mesh: each device's (q, scale),
    ``compressed_reduce_scatter`` and ``compressed_mean`` of its row of
    ``g``; then ``steps`` error-feedback steps, (a) through
    ``make_compressed_allreduce`` on grads every device holds alike and
    (b) through ``compressed_mean`` inside ``shard_map`` on each device's
    own grads, composed as that function composes it."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.optim.compression import (compressed_mean,
                                         compressed_reduce_scatter,
                                         dequantize_int8,
                                         make_compressed_allreduce,
                                         quantize_int8)

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("data",))
    g = jnp.asarray(data["g"])
    out = {}
    for i in range(4):
        q, s = quantize_int8(g[i])
        out[f"q{i}"], out[f"scale{i}"] = np.asarray(q), np.asarray(s)
    rs = shard_map(lambda g: compressed_reduce_scatter(g[0], "data"),
                   mesh=mesh, in_specs=P("data"), out_specs=P("data"))
    cm = shard_map(lambda g: compressed_mean(g[0], ("data",)), mesh=mesh,
                   in_specs=P("data"), out_specs=P())
    out["rs"] = np.asarray(rs(g))
    out["mean"] = np.asarray(cm(g))

    reduce = jax.jit(make_compressed_allreduce(mesh, ("data",)))
    err = jnp.zeros(data["same"].shape[1:], jnp.float32)
    for t in range(steps):
        m, err = reduce(jnp.asarray(data["same"][t]), err)
        out[f"same/mean{t}"], out[f"same/err{t}"] = (np.asarray(m),
                                                     np.asarray(err))
    err = jnp.zeros(data["own"].shape[1:], jnp.float32)
    for t in range(steps):
        gin = jnp.asarray(data["own"][t]) + err
        m = cm(gin)
        q, s = quantize_int8(m)
        err = gin - dequantize_int8(q, s)[None]
        out[f"own/mean{t}"], out[f"own/err{t}"] = (np.asarray(m),
                                                   np.asarray(err))
    return out


def slices(data: dict, cases: list) -> dict:
    """``NamedSharding(mesh, spec).devices_indices_map(shape)`` per (mesh
    shape, axis names, spec, shape): each device's (start, stop) per dim,
    in the order of the mesh's devices."""
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    out = {}
    for i, (sizes, names, spec, shape) in enumerate(cases):
        n = int(np.prod(sizes))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(sizes), tuple(names))
        entries = [tuple(e) if isinstance(e, list) else e for e in spec]
        idx = NamedSharding(mesh, P(*entries)).devices_indices_map(
            tuple(shape))
        rows = []
        for dev in mesh.devices.reshape(-1):
            rows.append([(sl.start or 0, shape[d] if sl.stop is None
                          else sl.stop) for d, sl in enumerate(idx[dev])])
        out[f"case{i}"] = np.asarray(rows, np.int64).reshape(n, len(shape),
                                                               2)
    return out


def _pod_mesh(jax, np, shape, names=("pod", "data", "model")):
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape),
                             tuple(names))


def multipod(data: dict, train: list, moe: list, decode: list) -> dict:
    """The multi-pod production layout: on a ``(pod, data, model)`` mesh
    of the forced devices, under the compute rules of
    ``rules_for(cfg, multi_pod=True)``: per ``train`` case (name, arch,
    mesh shape) one jitted ``make_train_step`` on batch 0 (loss, clip
    norm, the parameters and moments after it) and the gradients of
    ``lm_loss``; per ``moe`` case (tag, mesh shape, axis names,
    multi_pod, B, S) ``moe_block`` on ``x[:B, :S]`` (y, lb and the
    gradients of mean_t(y_t . cot_t) + lb); per ``decode`` case (name,
    arch, mesh shape, B, S_max, prompt_len) ``decode_step`` under
    ``decode_rules``, the prompt teacher-forced then greedy (tokens, each
    step's logits)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.devices()       # the backend starts with this process's count
    from repro.configs import reduced_config
    from repro.distributed.context import ShardingRules, activate
    from repro.launch.dryrun import decode_rules, rules_for
    from repro.models.moe import moe_block
    from repro.models.transformer import decode_step, init_cache, lm_loss
    from repro.optim.adamw import AdamWConfig
    from repro.train.step import init_train_state, make_train_step

    out = {}
    for name, arch, shape, _ in train:
        cfg = reduced_config(arch).replace(dtype="float32")
        rules, _ = rules_for(cfg.replace(name=arch), True)
        params = _nest({k[len(arch) + 1:]: jnp.asarray(v)
                        for k, v in data.items() if k.startswith(arch + "/")})
        batch = {k: jnp.asarray(data[f"{k}/{name}"][0])
                 for k in ("tokens", *STUBS) if f"{k}/{name}" in data}
        opt = AdamWConfig(lr=1e-2, eps=1e-3, warmup_steps=1, decay_steps=1)
        with activate(_pod_mesh(jax, np, shape), rules):
            grads = jax.jit(jax.grad(lambda p, b: lm_loss(p, cfg, b)))(
                params, batch)
            state, m = jax.jit(make_train_step(cfg, opt))(
                init_train_state(params, opt), batch)
        out[f"{name}/loss"] = np.asarray(m["loss"])
        out[f"{name}/grad_norm"] = np.asarray(m["grad_norm"])
        for k, v in _flat(grads).items():
            out[f"{name}/grads/{k}"] = np.asarray(v)
        for k, v in _flat(state["params"]).items():
            out[f"{name}/params/{k}"] = np.asarray(v)
        for k in ("m", "v"):
            for key, v in _flat(state["opt"][k]).items():
                out[f"{name}/opt/{k}/{key}"] = np.asarray(v)
    p = {k: jnp.asarray(data[f"moe/{k}"]) for k in ("router", "wi", "wg",
                                                    "wo")}
    for tag, shape, names, multi_pod, B, S in moe:
        cfg = reduced_config("olmoe-1b-7b").replace(dtype="float32")
        rules = rules_for(cfg, True)[0] if multi_pod else ShardingRules()
        x = jnp.asarray(data["moe/x"][:B, :S])
        cot = jnp.asarray(data["moe/cot"][:B, :S])
        with activate(_pod_mesh(jax, np, shape, names), rules):
            def f(p, x):
                y, lb = moe_block(p, cfg, x)
                return jnp.mean(jnp.sum(y * cot, -1)) + lb, (y, lb)

            (_, (y, lb)), (gp, gx) = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True))(p, x)
        out[f"{tag}/y"], out[f"{tag}/lb"] = np.asarray(y), np.asarray(lb)
        out[f"{tag}/gx"] = np.asarray(gx)
        for k, g in gp.items():
            out[f"{tag}/grads/{k}"] = np.asarray(g)
    for name, arch, shape, B, s_max, prompt_len in decode:
        cfg = reduced_config(arch).replace(dtype="float32")
        rules, _ = rules_for(cfg.replace(name=arch), True)
        params = _nest({k[len(arch) + 1:]: jnp.asarray(v)
                        for k, v in data.items() if k.startswith(arch + "/")})
        toks = np.asarray(data[f"prompt/{name}"], np.int32)
        with activate(_pod_mesh(jax, np, shape),
                      decode_rules(cfg, rules, B, model_axis=shape[-1])):
            step = jax.jit(lambda p, c, t, pos: decode_step(p, cfg, c, t,
                                                            pos))
            cache, nxt = init_cache(cfg, B, s_max), None
            for t in range(s_max):
                if t >= prompt_len:
                    toks = np.concatenate([toks, nxt], axis=1)
                logits, cache = step(params, cache, jnp.asarray(
                    toks[:, t:t + 1]), jnp.int32(t))
                nxt = np.asarray(jnp.argmax(logits, axis=-1))[:, None]
                out[f"{name}/logits{t}"] = np.asarray(logits)
        out[f"{name}/tokens"] = toks
    return out


PROGRAMS = {"moe": moe, "dp_train": dp_train, "tp_train": tp_train,
            "compression": compression, "slices": slices, "decode": decode,
            "multipod": multipod}


def main(program: str, n: int, inp: str, outp: str, args: str) -> None:
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import numpy as np

    data = dict(np.load(inp)) if os.path.exists(inp) else {}
    res = PROGRAMS[program](data, **json.loads(args))
    np.savez(outp, **res)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
