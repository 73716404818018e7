"""End-to-end driver: train a ~100M-param LM with the full stack (port of
``examples/train_100m.py``).

Everything is exercised for real: model (qwen3-family blocks), AdamW with
warmup-cosine, MDTP multi-source input pipeline over three throttled
localhost mirrors, async atomic checkpoints with keep-k GC, and
resume-from-latest (``launch.train.run_training``).

The defaults are the reference's (~100M params, a short run); pass
``--steps 300`` for the full few-hundred-step run.  ``--reduced`` trains
a miniature of the same config (2 layers, d 64) for a quick check on the
CPU.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 30
      (``--device cpu --reduced`` without a card)
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.launch.train import run_training, start_mirror
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import num_params


def config_100m() -> ModelConfig:
    return ModelConfig(
        name="repro-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=32_000,
        qk_norm=True, mlp_act="swiglu", tie_embeddings=True, remat="none",
    )


def reduced_100m() -> ModelConfig:
    """A miniature of :func:`config_100m` with the same blocks, for the
    CPU."""
    return config_100m().replace(name="repro-100m-reduced", n_layers=2,
                                 d_model=64, n_heads=4, n_kv_heads=2,
                                 d_ff=128, vocab_size=512)


def main(argv=None, *, mirror=start_mirror) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="the miniature config (for the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = reduced_100m() if args.reduced else config_100m()
    print(f"model: {cfg.name}, {num_params(cfg) / 1e6:.1f}M params")
    ckpt = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                         "repro_100m_ckpt")
    _, losses = run_training(
        cfg, args.steps, args.batch, args.seq, ckpt_dir=ckpt,
        resume=args.resume, lr=6e-4, log_every=1, device=args.device,
        mirror=mirror)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({len(losses)} steps); checkpoints in {ckpt}")
    if len(losses) >= 10:  # too noisy to assert on a handful of steps
        head = sum(losses[:3]) / 3
        tail = sum(losses[-3:]) / 3
        assert tail < head, f"loss should trend down: {head:.3f}->{tail:.3f}"
    return {"arch": cfg.name, "params": num_params(cfg), "losses": losses,
            "ckpt_dir": ckpt}


if __name__ == "__main__":
    main()
