#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a card and ``nvcc``:

    python3 chip_smoke.py

Phases (one JSON line each, ``"phase"`` names them):

1. ``env``: the card, its power limit, torch and CUDA versions.  Without a
   card the script exits non-zero and prints no result.
2. ``build``: ``nvcc`` builds every kernel of the path from
   ``src/repro_torch/csrc`` for ``sm_90a``, with ``ptxas``'s register,
   shared-memory and spill lines.
3. ``kernels``: each kernel against its plain PyTorch version on the card
   over the JAX package's test sweeps and the main path's shapes (one line
   per case: error beside tolerance), then timed with CUDA events beside
   its plain version, one library call and its bound.
4. ``restore``: qwen3-1.7b at full width, random weights from a seeded
   ``torch.Generator`` on the card, saved with ``save_checkpoint`` and
   restored over MDTP from three throttled loopback mirrors (rates 1:2:4;
   the slowest is killed mid-restore) into device memory, every leaf
   checked bit for bit.
5. ``serve``: ``generate`` with the restored weights (4 requests, 16 prompt
   + 32 generated tokens, greedy), its kernel launch counts held to the
   exact per-step counts, then four teacher-forced steps of the kernel
   path against the plain path on the card.
6. ``profile``: device time by kernel over four decode steps
   (``torch.profiler``) beside the unprofiled step time.

Then the ``{"kernels": [...]}`` summary, the card's name and power limit as
``nvidia-smi`` reports them, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
those lines.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MB = 1 << 20

#: published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, dense
#: bf16 tensor-core and f32 (non-tensor) flop/s
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

#: tolerances of the JAX package's kernel tests, per dtype
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

#: the slowest mirror's rate (the others run 2x and 4x), chosen so the three
#: together stay below what one host's loopback sustains and the mirrors,
#: not the sockets, set each one's share; the slowest dies once it has
#: served this many bytes (about a second of its share), mid-restore
MIRROR_RATE = 64 * MB
KILL_AT_BYTES = 64 * MB


class CheckFailed(Exception):
    pass


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_time_ms(torch, fn, iters: int) -> tuple[float, float]:
    """(graph_ms, eager_ms) per call of ``fn``.  graph_ms replays ``iters``
    calls captured in one CUDA graph, so the host's launch overhead drops
    out and what is left is device time; eager_ms issues the same calls back
    to back from Python, as the serving loop does.  Both with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def timed(run) -> float:
        torch.cuda.synchronize()
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    graph_ms = timed(graph.replay)
    del graph

    def eager():
        for _ in range(iters):
            fn()

    return graph_ms, timed(eager)


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# ------------------------------------------------------------------ kernels

def kernel_phase(torch, K, dev):
    """Sweeps and timings of both kernels.  Returns the summary entries
    (launch counts are filled in after the main path's run)."""
    import torch.nn.functional as F

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dtypes[dt])

    # worst error per kernel and dtype, each beside its dtype's tolerance
    worst = {name: dict.fromkeys(dtypes, 0.0)
             for name in ("decode_attention", "rmsnorm")}

    def record(name, label, dt, out, ref):
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[dt]
        ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
        print(json.dumps({"case": f"{name} {dt} {label}", "max_abs_err": err,
                          "tol": tol, "ok": ok}), flush=True)
        check(ok, f"{name} {dt} {label}: max abs err {err} over tol {tol}")
        worst[name][dt] = max(worst[name][dt], err)

    # decode attention: the JAX sweep (tests/test_kernels_decode_ssm.py),
    # then the main path's shape and the timing shape
    dcases = ([(2, 2, 4, hd, 512, 300, None) for hd in (64, 112, 128)]
              + [(2, 2, g, 64, 512, 511, None) for g in (1, 2, 8)]
              + [(2, 2, 4, 64, 512, p, None) for p in (0, 1, 255, 256, 500)]
              + [(2, 2, 4, 64, 1024, 900, w) for w in (None, 32, 256, 1 << 20)]
              + [(2, 2, 4, 64, 700, 600, None),
                 (4, 8, 2, 128, 48, 47, None),
                 (4, 8, 2, 128, 4096, 4095, None)])
    for dt in dtypes:
        for B, KV, G, hd, S, pos, win in dcases:
            q = randn((B, 1, KV * G, hd), dt)
            k, v = randn((B, S, KV, hd), dt), randn((B, S, KV, hd), dt)
            p = torch.tensor(pos, dtype=torch.int32, device=dev)
            out = K.decode_attention(q, k, v, p, window=win)
            ref = K.decode_attention_plain(q, k, v, p, window=win)
            torch.cuda.synchronize()
            record("decode_attention",
                   f"B{B} KV{KV} G{G} hd{hd} S{S} pos{pos} window{win}",
                   dt, out, ref)

    # rmsnorm: the JAX sweep (tests/test_kernels.py) with and without the
    # fused residual, then the main path's shapes (bf16 x and scale)
    rshapes = [(64, 256), (3, 7, 512), (1000, 128), (4, 2048)]
    for dt in dtypes:
        for shape in rshapes:
            for with_res in (False, True):
                x = randn(shape, dt)
                s = randn(shape[-1:], "float32") * 0.1 + 1.0
                r = randn(shape, dt) if with_res else None
                out, ref = K.rmsnorm(x, s, r), K.rmsnorm_plain(x, s, r)
                torch.cuda.synchronize()
                record("rmsnorm", f"{shape} residual={with_res}", dt, out, ref)
    for shape in [(4, 1, 2048), (4, 1, 16, 128), (4, 1, 8, 128)]:
        x, s = randn(shape, "bfloat16"), randn(shape[-1:], "bfloat16")
        out, ref = K.rmsnorm(x, s), K.rmsnorm_plain(x, s)
        torch.cuda.synchronize()
        record("rmsnorm", f"{shape} main-path", "bfloat16", out, ref)

    # timings at the slice's shapes, bf16.  The decode caches (67 MB of
    # K+V) exceed the 50 MB L2, as each layer's cache does on the path.
    B, KV, G, hd, S, pos = 4, 8, 2, 128, 4096, 4095
    H, e = KV * G, 2
    q = randn((B, 1, H, hd), "bfloat16")
    k, v = randn((B, S, KV, hd), "bfloat16"), randn((B, S, KV, hd), "bfloat16")
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(hd)
    qs = q.transpose(1, 2)
    ks, vs = k[:, :pos + 1].transpose(1, 2), v[:, :pos + 1].transpose(1, 2)
    d_ms, d_eager = cuda_time_ms(torch, lambda: K.decode_attention(q, k, v, p),
                                 100)
    d_plain, _ = cuda_time_ms(
        torch, lambda: K.decode_attention_plain(q, k, v, p), 20)
    d_lib = None        # torch < 2.5 has no GQA in scaled_dot_product_attention
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        d_lib, _ = cuda_time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, scale=scale, enable_gqa=True), 100)
    nbytes = 2 * B * H * hd * e + 2 * B * KV * (pos + 1) * hd * e
    d_bound, d_by = bound_ms(nbytes, 4.0 * B * H * (pos + 1) * hd, "bfloat16")
    emit("kernel_time", kernel="decode_attention",
         shape=f"B{B} KV{KV} G{G} hd{hd} S{S} pos{pos} bf16",
         kernel_ms=d_ms, kernel_eager_ms=d_eager, plain_ms=d_plain,
         library_ms=d_lib,
         library="F.scaled_dot_product_attention(enable_gqa=True)",
         bound_ms=d_bound, bound_by=d_by, bytes=nbytes)

    r_times = []
    for rows, d in ((4, 2048), (64, 128)):
        x = randn((rows, d), "bfloat16")
        s = randn((d,), "bfloat16")
        r_ms, r_eager = cuda_time_ms(torch, lambda: K.rmsnorm(x, s), 200)
        r_plain, _ = cuda_time_ms(torch, lambda: K.rmsnorm_plain(x, s), 200)
        r_lib = (cuda_time_ms(torch, lambda: F.rms_norm(x, (d,), s, 1e-6),
                              200)[0]
                 if hasattr(F, "rms_norm") else None)     # torch >= 2.4
        nb = 2 * rows * d * e + d * e
        r_bound, r_by = bound_ms(nb, 4.0 * rows * d, "float32")
        r_times.append((rows, d, r_ms, r_eager, r_plain, r_lib, r_bound,
                        r_by))
        emit("kernel_time", kernel="rmsnorm", shape=f"({rows}, {d}) bf16",
             kernel_ms=r_ms, kernel_eager_ms=r_eager, plain_ms=r_plain,
             library_ms=r_lib,
             library="F.rms_norm", bound_ms=r_bound, bound_by=r_by, bytes=nb)

    rows, d, r_ms, r_eager, r_plain, r_lib, r_bound, r_by = r_times[0]
    return [
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:92",
         "launches": None,
         "max_abs_err": max(worst["decode_attention"].values()),
         "max_abs_err_by_dtype": worst["decode_attention"], "tol": TOL,
         "ms": d_ms, "eager_ms": d_eager, "plain_ms": d_plain,
         "bound_ms": d_bound,
         "bound_by": d_by, "library_ms": d_lib,
         "timed_shape": f"B{B} KV{KV} G{G} hd{hd} S{S} pos{pos} bf16"},
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm/kernel.py:39",
         "launches": None, "max_abs_err": max(worst["rmsnorm"].values()),
         "max_abs_err_by_dtype": worst["rmsnorm"], "tol": TOL,
         "ms": r_ms, "eager_ms": r_eager, "plain_ms": r_plain,
         "bound_ms": r_bound,
         "bound_by": r_by, "library_ms": r_lib,
         "timed_shape": f"({rows}, {d}) bf16"},
    ]


# ------------------------------------------------------------------ restore

def restore_phase(torch, cfg, dev):
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import Decoder, model_specs
    from repro_torch.transfer import RangeServer, Replica, Throttle

    t0 = time.perf_counter()
    source = Decoder(cfg, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in tree_leaves(source.tree()))

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    servers = []
    try:
        t0 = time.perf_counter()
        d = save_checkpoint(tmp, 1, source.tree())
        t_save = time.perf_counter() - t0
        total = os.path.getsize(os.path.join(d, "data.bin"))

        rates = [MIRROR_RATE, 2 * MIRROR_RATE, 4 * MIRROR_RATE]
        t0 = time.perf_counter()
        for rate in rates:
            s = RangeServer(throttle=Throttle(bytes_per_s=rate, chunk=MB,
                                              shared=True)).start()
            servers.append(s)
            for name in ("manifest.json", "data.bin"):
                s.add_file(f"/ckpt/step_0000000001/{name}",
                           os.path.join(d, name))
        t_mount = time.perf_counter() - t0

        victim = servers[0]
        done = threading.Event()
        killed_at = []

        def kill_when_due():
            while not done.wait(0.005):
                if victim.served_bytes >= KILL_AT_BYTES:
                    killed_at.append(time.perf_counter() - t0)
                    victim.stop()
                    victim.kill_connections()
                    return

        replicas = [Replica("127.0.0.1", s.port, "/ckpt") for s in servers]
        killer = threading.Thread(target=kill_when_due)
        t0 = time.perf_counter()
        killer.start()
        try:
            restored, step = restore_checkpoint(tmp, model_specs(cfg), step=1,
                                                replicas=replicas, device=dev)
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
        finally:
            done.set()
            killer.join()
        served = [s.served_bytes for s in servers]
    finally:
        for s in servers:       # stopping the killed mirror again is a no-op
            s.stop()
        shutil.rmtree(tmp, ignore_errors=True)

    want = dict(tree_leaves(source.tree()))
    got = dict(tree_leaves(restored))
    check(sorted(want) == sorted(got), "restored keys differ from saved")
    for key, t in want.items():
        r = got[key]
        check(r.device.type == "cuda", f"{key} restored on {r.device}")
        check(r.dtype == t.dtype and r.shape == t.shape and torch.equal(r, t),
              f"restored leaf {key} is not bit-exact")
    check(bool(killed_at), "the slowest mirror was never killed mid-restore")
    check(victim.served_bytes < total, "the killed mirror served everything")
    emit("restore", arch=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, params=n_params, bytes=total, dtype=cfg.dtype,
         init_s=t_init, save_s=t_save, mount_s=t_mount,
         restore_s=t_restore, gb_per_s=total / t_restore / 1e9,
         mirror_rates_mib_s=[r / MB for r in rates],
         served_bytes_per_mirror=served, killed_mirror=0,
         killed_after_s=killed_at[0], leaves=len(got), bit_exact=True)
    del source, want
    torch.cuda.empty_cache()
    return restored


# ------------------------------------------------------------------ serve

def serve_phase(torch, K, cfg, dev, params):
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import Decoder, decode_step, init_cache

    model = Decoder(cfg, params, device=dev)
    B, S0, gen = 4, 16, 32
    prompt = torch.randint(0, cfg.vocab_size, (B, S0), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    generate(cfg, model, prompt[:, :2], 2, device=dev)        # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    K.decode_attention.launches = 0
    K.rmsnorm.launches = 0
    t0 = time.perf_counter()
    toks = generate(cfg, model, prompt, gen, device=dev)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"decode_attention": K.decode_attention.launches,
                "rmsnorm": K.rmsnorm.launches}
    peak = torch.cuda.max_memory_allocated()

    steps = S0 + gen
    per_step = {"decode_attention": cfg.n_layers,
                "rmsnorm": 4 * cfg.n_layers + 1}   # ln1, ln2, q/k-norm; final
    for name, n in per_step.items():
        check(launches[name] == n * steps,
              f"{name}: {launches[name]} launches, expected {n} x {steps}")
    check(tuple(toks.shape) == (B, S0 + gen), f"tokens {tuple(toks.shape)}")
    check(torch.equal(toks[:, :S0], prompt), "prompt not preserved")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "token range")

    # the kernel path against the plain path on the card, teacher-forced
    n_cmp, atol, rtol = 4, 0.08, 0.05
    params = model.tree()
    ck, cp = init_cache(cfg, B, n_cmp, dev), init_cache(cfg, B, n_cmp, dev)
    errs, coss = [], []
    with torch.inference_mode():
        for t in range(n_cmp):
            pos = torch.tensor(t, dtype=torch.int32, device=dev)
            lk, ck = decode_step(params, cfg, ck, toks[:, t:t + 1], pos)
            lp, cp = decode_step(params, cfg, cp, toks[:, t:t + 1], pos,
                                 plain=True)
            lk, lp = lk.float(), lp.float()
            check(bool(torch.isfinite(lk).all()), f"non-finite logits, step {t}")
            errs.append((lk - lp).abs().max().item())
            coss.append(torch.nn.functional.cosine_similarity(
                lk.flatten(), lp.flatten(), dim=0).item())
            check(torch.allclose(lk, lp, atol=atol, rtol=rtol),
                  f"step {t}: kernel vs plain logits differ by {errs[-1]}")
    check(min(coss) > 0.999, f"cosine similarity {min(coss)}")
    emit("serve", batch=B, prompt_len=S0, gen=gen, steps=steps,
         seconds=elapsed, ms_per_step=elapsed / steps * 1e3,
         tokens_per_s=B * steps / elapsed,
         generated_tokens_per_s=B * gen / elapsed,
         max_memory_allocated=peak, launches=launches,
         launches_per_step={k: v / steps for k, v in launches.items()},
         plain_vs_kernel_max_abs_err=max(errs),
         plain_vs_kernel_tol={"atol": atol, "rtol": rtol},
         cosine_similarity_min=min(coss), teacher_forced_steps=n_cmp)
    return launches, params, toks, elapsed / steps * 1e3


def profile_phase(torch, cfg, dev, params, toks, ms_per_step: float):
    """Where a decode step's time goes: device time by kernel over a few
    steps under ``torch.profiler``, set against the unprofiled step time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer import decode_step, init_cache

    n = 4
    cache = init_cache(cfg, toks.shape[0], n, dev)
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(n):
            pos = torch.tensor(t, dtype=torch.int32, device=dev)
            decode_step(params, cfg, cache, toks[:, t:t + 1], pos)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kernels) / n / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    ours = [e for e in kernels
            if "decode_attention_kernel" in e.key or "rmsnorm_kernel" in e.key]
    emit("profile", steps=n, device_busy_ms_per_step=busy_ms,
         step_ms_unprofiled=ms_per_step,
         device_idle_share=(1.0 - busy_ms / ms_per_step) if busy_ms else None,
         top_kernels=[{"name": e.key[:90], "ms_per_step": dev_us(e) / n / 1e3,
                       "calls_per_step": e.count / n,
                       "us_per_call": dev_us(e) / max(e.count, 1)}
                      for e in top],
         port_kernels=[{"name": e.key[:90], "ms_per_step": dev_us(e) / n / 1e3,
                        "calls_per_step": e.count / n,
                        "us_per_call": dev_us(e) / max(e.count, 1)}
                       for e in ours])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch under {ROOT}; run it from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, src)

    import repro_torch.kernels as K
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), python=sys.version.split()[0])
    try:
        t0 = time.perf_counter()
        b = build()
        emit("build", seconds=time.perf_counter() - t0, cached=b.cached,
             library=os.path.relpath(b.path, ROOT), ptxas=list(b.ptxas))

        summary = kernel_phase(torch, K, dev)

        cfg = get_config("qwen3-1.7b")
        params = restore_phase(torch, cfg, dev)
        launches, params, toks, step_ms = serve_phase(torch, K, cfg, dev,
                                                      params)
        profile_phase(torch, cfg, dev, params, toks, step_ms)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for entry in summary:
        entry["launches"] = launches[entry["name"]]
    print(json.dumps({"kernels": summary}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
