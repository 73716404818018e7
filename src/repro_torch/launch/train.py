"""End-to-end training driver (port of ``repro.launch.train``).

Wires the port's pieces together: config registry -> model -> AdamW ->
MDTP multi-source data pipeline -> checkpoint manager (async, atomic,
keep-k) -> train loop with resume.  The token stream is served by
throttled ``RangeServer`` mirrors on loopback; each step's numpy batch
moves to the device.  Runs on the card by default (raises without one);
``--device cpu`` runs the plain PyTorch path on the CPU (use with
``--reduced``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --reduced --device cpu --steps 20 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --steps 10 --batch 4 --seq 2048 --ckpt-dir build/train_ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
      --reduced --device cpu --steps 10 --ckpt-dir /tmp/ck --resume
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint)
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.data import (MultiSourcePipeline, TokenDatasetSpec,
                              synthetic_tokens, write_token_dataset)
from repro_torch.models.common import init_params, tree_map
from repro_torch.models.transformer import model_specs
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.transfer import RangeServer, Replica, Throttle

__all__ = ["main", "run_training", "start_mirror", "stop_mirror"]


def start_mirror(blobs: dict, rate: float) -> RangeServer:
    """A started ``RangeServer`` holding ``blobs`` (path -> bytes), paced
    at ``rate`` bytes/s."""
    s = RangeServer(throttle=Throttle(bytes_per_s=rate)).start()
    for path, data in blobs.items():
        s.add_blob(path, data)
    return s


def stop_mirror(server: RangeServer) -> None:
    """Stop a mirror for good: sever its sessions, stop its accept loop,
    then sever what was accepted in between (``stop`` alone leaves the
    open sessions served)."""
    server.kill_connections()
    server.stop()
    server.kill_connections()


def run_training(cfg, steps: int, batch: int, seq: int, *,
                 ckpt_dir: Optional[str] = None, resume: bool = False,
                 mirrors: int = 3, lr: float = 3e-4, log_every: int = 1,
                 seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 params: Optional[dict] = None,
                 mirror: Callable[[dict, float], RangeServer] = start_mirror,
                 step_seconds: Optional[list] = None):
    """Returns ``(final_state, losses)``, as the reference's does.

    ``device``: ``"cuda"`` by default (raises without a card), ``"cpu"``
    for the plain path.  The weights are drawn from a ``torch.Generator``
    seeded with ``seed`` on the device, or taken from ``params`` (a tree
    already on the device, trained in place).  ``mirror(blobs, rate)``
    starts each of the ``mirrors`` data mirrors (rates 40, 80, 120 MiB/s,
    ...); every mirror is stopped, its sessions severed, before this
    returns.  ``step_seconds`` receives each step's host seconds (batch
    fetch to loss on the host)."""
    dev = resolve_device(device)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                          decay_steps=max(steps, 2))
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(model_specs(cfg), gen, cfg.torch_dtype, dev)
    state = init_train_state(params, opt_cfg)

    start_step = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, every_steps=max(steps // 4, 1),
                                keep=2)
        if resume and latest_step(ckpt_dir) is not None:
            state, start_step = restore_checkpoint(ckpt_dir, state,
                                                   device=dev)
            state["params"] = tree_map(lambda t: t.requires_grad_(True),
                                       state["params"])
            print(f"# resumed from step {start_step}")

    # replicated mirrors serving the token stream (MDTP multi-source input)
    tokens = synthetic_tokens(
        max(batch * (seq + 1) * (steps + 4), 65_536), cfg.vocab_size,
        seed=seed)
    blobs = {"/ds/" + name: data
             for name, data in write_token_dataset(None, tokens).items()}
    servers = []
    pipe = None
    step_fn = make_train_step(cfg, opt_cfg)
    losses = []
    try:
        for i in range(mirrors):
            servers.append(mirror(blobs, (i + 1) * 40 * 1024 * 1024))
        replicas = [Replica("127.0.0.1", s.port, "/ds") for s in servers]
        spec = TokenDatasetSpec(n_tokens=tokens.size, seq_len=seq,
                                global_batch=batch)
        pipe = MultiSourcePipeline(replicas, spec, depth=2)
        for step in range(start_step, steps):
            t0 = time.perf_counter()
            toks = pipe.get_batch(step)
            batch_arrs = {"tokens": torch.from_numpy(
                toks[:, :-1].astype(np.int32)).to(dev)}
            state, metrics = step_fn(state, batch_arrs)
            loss = float(metrics["loss"])
            losses.append(loss)
            if step_seconds is not None:
                step_seconds.append(time.perf_counter() - t0)
            if step % log_every == 0:
                print(f"step {step:5d} loss {loss:8.4f} "
                      f"gnorm {float(metrics['grad_norm']):7.3f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"dt {time.perf_counter() - t0:6.2f}s", flush=True)
            if mgr is not None:
                mgr.maybe_save(step + 1, state)
    finally:
        if mgr is not None:
            mgr.wait()
        if pipe is not None:
            pipe.close()
        for s in servers:
            stop_mirror(s)
    return state, losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mirrors", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    _, losses = run_training(
        cfg, args.steps, args.batch, args.seq, ckpt_dir=args.ckpt_dir,
        resume=args.resume, mirrors=args.mirrors, lr=args.lr,
        device=args.device)
    print(f"# done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
