"""Serving driver: teacher-forced prefill of a prompt batch through the
decode step, then batched greedy (or sampled) decode, on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --prompt-len 16 --gen 16 --batch 4

``--device cpu`` runs the plain PyTorch path on the CPU (use with
``--reduced``).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.models.transformer import Decoder, init_cache
from repro_torch.serve.step import make_serve_step

__all__ = ["main", "generate"]


def generate(cfg, params: Union[dict, Decoder], prompt: torch.Tensor,
             gen: int, temperature: float = 0.0, seed: int = 0, *,
             device: Optional[Union[str, torch.device]] = None
             ) -> torch.Tensor:
    """prompt ``[B, S0]`` -> tokens ``[B, S0 + gen]`` (greedy, or sampled
    from a ``torch.Generator`` seeded with ``seed``).

    ``params`` is a parameter tree or a :class:`Decoder`, already on
    ``device`` (default ``"cuda"``; raises without a card)."""
    dev = resolve_device(device)
    if isinstance(params, Decoder):
        params = params.tree()
    if params["embed"].device.type != dev.type:
        raise ValueError(f"parameters live on {params['embed'].device}, "
                         f"generate was asked for {dev}")
    B, S0 = prompt.shape
    s_max = S0 + gen
    cache = init_cache(cfg, B, s_max, dev)
    serve_step = make_serve_step(cfg, temperature)
    rng = torch.Generator(device=dev).manual_seed(seed)
    # every position as a device scalar: the step reads pos on the device
    positions = torch.arange(s_max, dtype=torch.int32, device=dev)
    toks = prompt.to(dev, torch.long)
    nxt = None
    with torch.inference_mode():
        # teacher-forced prefill through the decode path (exact cache build)
        for t in range(S0):
            nxt, _, cache = serve_step(params, cache, toks[:, t:t + 1],
                                       positions[t], rng)
        for t in range(S0, s_max):
            toks = torch.cat([toks, nxt], dim=1)
            nxt, _, cache = serve_step(params, cache, toks[:, t:t + 1],
                                       positions[t], rng)
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
