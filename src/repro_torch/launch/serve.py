"""Serving driver: teacher-forced prefill of a prompt batch through the
decode step, then batched greedy (or sampled) decode, on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --prompt-len 16 --gen 16 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
      --prompt-len 16 --gen 16 --batch 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch nemotron-4-15b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama-3.2-vision-11b

On the card every step replays one CUDA graph of the decode step and its
sampling (``serve.step.CapturedServeStep``).

The hybrid's cache holds, per mamba block, its f32 SSD state and conv
window, and one KV cache per application of the shared attention block;
the xLSTM's, per block, its f32 recurrent state (no sequence axis).
encdec (whisper-large-v3) and vlm (llama-3.2-vision-11b) decode against a
memory held in the cache: by default the reference's stub of 8 zero rows,
or the encoder output / projected patches passed as ``memory``.

``--device cpu`` runs the plain PyTorch path on the CPU (use with
``--reduced``).

Under an active sharding context (decode under a mesh; rules from
``launch.dryrun.serve_rules``) ``generate`` allocates this rank's block of
the cache (for encdec and vlm the ``memory``'s batch rows too), each step
runs the rank's batch rows, and every rank returns the same tokens.  On a
gloo mesh of more than one rank ask for ``capture=False``:
``capture=True`` raises there (``serve.step.check_capturable``).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.distributed.context import active_ctx
from repro_torch.models.transformer import Decoder, init_cache
from repro_torch.serve.step import (CapturedServeStep, check_capturable,
                                    make_serve_step)

__all__ = ["main", "generate"]


def generate(cfg, params: Union[dict, Decoder], prompt: torch.Tensor,
             gen: int, temperature: float = 0.0, seed: int = 0, *,
             device: Optional[Union[str, torch.device]] = None,
             capture: bool = True,
             step_log: Optional[list] = None,
             memory: Optional[torch.Tensor] = None) -> torch.Tensor:
    """prompt ``[B, S0]`` -> tokens ``[B, S0 + gen]`` (greedy, or sampled
    from a ``torch.Generator`` seeded with ``seed``).

    ``params`` is a parameter tree or a :class:`Decoder`, already on
    ``device`` (default ``"cuda"``; raises without a card).  On the card
    every step, prompt and generated, replays one
    :class:`CapturedServeStep`; a capture or replay that fails raises.
    ``capture=False`` runs the step eagerly instead (the comparison the
    captured step is held to); the CPU always runs it eagerly.  A
    ``step_log`` list receives the captured step, whose ``launches`` and
    ``replays`` give the kernel launches of the run.

    encdec and vlm read ``memory`` ``[B, M, d]`` (the encoder's output or
    the projected patches), written into the cache before the first step;
    without it, the reference's stub: 8 rows of zeros.

    Under an active sharding context ``params`` are this rank's blocks,
    ``prompt`` and ``memory`` the whole batch's, of which the cache takes
    this rank's rows (``ShardingCtx.batch_rows``); ``capture=True`` raises
    on a mesh whose collectives cannot be captured (gloo's), on the CPU
    too."""
    if capture:
        check_capturable()
    dev = resolve_device(device)
    if isinstance(params, Decoder):
        params = params.tree()
    if params["embed"].device.type != dev.type:
        raise ValueError(f"parameters live on {params['embed'].device}, "
                         f"generate was asked for {dev}")
    B, S0 = prompt.shape
    s_max = S0 + gen
    mem_len = 0
    if cfg.family in ("encdec", "vlm"):
        mem_len = 8 if memory is None else memory.shape[1]
    rng = torch.Generator(device=dev).manual_seed(seed)
    # every position as a device scalar: the step reads pos on the device
    positions = torch.arange(s_max, dtype=torch.int32, device=dev)
    toks = prompt.to(dev, torch.long)
    if capture and dev.type == "cuda":
        captured = CapturedServeStep(cfg, params, B, s_max, temperature, rng,
                                     device=dev, mem_len=mem_len)
        cache = captured.cache
        if step_log is not None:
            step_log.append(captured)

        def step(t: int) -> torch.Tensor:
            return captured(toks[:, t:t + 1], positions[t])[0]
    else:
        cache = init_cache(cfg, B, s_max, dev, mem_len=mem_len)
        serve_step = make_serve_step(cfg, temperature)

        def step(t: int) -> torch.Tensor:
            return serve_step(params, cache, toks[:, t:t + 1], positions[t],
                              rng)[0]
    if mem_len and memory is not None:
        ctx = active_ctx()
        rows = slice(0, B) if ctx is None else ctx.batch_rows(B)[0]
        cache["memory"].copy_(memory[rows])
    nxt = None
    with torch.inference_mode():
        # teacher-forced prefill through the decode path (exact cache build)
        for t in range(S0):
            nxt = step(t)
        for t in range(S0, s_max):
            toks = torch.cat([toks, nxt], dim=1)
            nxt = step(t)
    return toks


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = Decoder(cfg, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    t0 = time.perf_counter()
    toks = generate(cfg, model, prompt, args.gen,
                    temperature=args.temperature, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n_new = args.batch * args.gen
    print(f"# generated {tuple(toks.shape)} on {dev} in {dt:.2f}s "
          f"({n_new / dt:.1f} tok/s incl. prefill and kernel build)")
    print(toks[:, args.prompt_len:].cpu())


if __name__ == "__main__":
    main()
