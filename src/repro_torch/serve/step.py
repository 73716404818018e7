"""Serving steps: full-sequence prefill, and batched one-token decode
against the cache followed by greedy or temperature sampling on the device
(port of ``repro.serve.step``).

:class:`CapturedServeStep` is the port's counterpart of the reference's
``jax.jit(make_serve_step(...), donate_argnums=(1,))``: the whole decode
step and its sampling captured once in a CUDA graph and replayed, so a
step costs one graph launch from the host instead of ~1,000 kernel
launches issued from Python.

Under an active sharding context (decode under a mesh,
``models.transformer.decode_step``) both steps run this rank's share and
return the whole batch's tokens and logits on every rank.  A captured
step needs collectives that a CUDA graph can record: NCCL's (the 1-rank
mesh on one card).  On a mesh of more than one rank whose collectives are
gloo's, which run on the host, :func:`check_capturable` raises; nothing
falls back to the eager step.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch._device import resolve_device
from repro_torch.models.common import ModelConfig, tree_leaves
from repro_torch.models.transformer import decode_step, forward, init_cache

__all__ = ["make_serve_step", "make_prefill_step", "CapturedServeStep",
           "check_capturable"]

#: the kernel wrappers whose launches a captured step records
_WRAPPERS = ("decode_attention", "decode_attention_partials",
             "decode_attention_merge", "rmsnorm", "flash_attention",
             "ssm_scan")


def make_prefill_step(cfg: ModelConfig, *, plain: bool = False,
                      q_block: int = 1024):
    """prefill_step(params, batch) -> last-position logits ``[B, V]`` f32.
    ``batch`` holds ``tokens``, and ``frames`` (encdec) or ``patches``
    (vlm).

    ``plain=True`` runs the plain PyTorch versions of the kernels, with
    attention in blocks of ``q_block`` queries (``forward``)."""

    def prefill_step(params: dict, batch: dict) -> torch.Tensor:
        logits, _ = forward(params, cfg, batch, plain=plain, q_block=q_block)
        return logits[:, -1].float()

    return prefill_step


def make_serve_step(cfg: ModelConfig, temperature: float = 0.0):
    """serve_step(params, cache, token, pos, generator=None) ->
    (next_token [B, 1], logits [B, V] f32, cache)."""

    def serve_step(params: dict, cache: dict, token: torch.Tensor,
                   pos: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
        logits, cache = decode_step(params, cfg, cache, token, pos)
        logits = logits.float()
        if temperature > 0.0 and generator is not None:
            probs = torch.softmax(logits / temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=generator)
        else:
            next_tok = torch.argmax(logits, dim=-1, keepdim=True)
        return next_tok, logits, cache

    return serve_step


def check_capturable() -> None:
    """Raise ``NotImplementedError`` where the active sharding context's
    collectives cannot be captured in a CUDA graph: a mesh of more than one
    rank that is shape-only or whose backend is not NCCL (gloo's
    collectives run on the host)."""
    from repro_torch.distributed.context import active_ctx

    ctx = active_ctx()
    if ctx is None or math.prod(ctx.mesh.axis_sizes) == 1:
        return
    dm = ctx.mesh.device_mesh
    backend = None
    if dm is not None:
        import torch.distributed as dist

        backend = dist.get_backend(dm.get_group(0))
    if backend != "nccl":
        raise NotImplementedError(
            f"a captured serve step on a {ctx.mesh.shape} mesh of "
            f"{backend or 'no'} process groups: a CUDA graph records NCCL's "
            f"collectives, gloo's run on the host and cannot be captured; "
            f"run the eager step (make_serve_step, generate(capture=False))")


def _launch_counts() -> dict:
    return {name: getattr(kernels, name).launches for name in _WRAPPERS}


class CapturedServeStep:
    """The serve step of one (cfg, parameters, batch, s_max, temperature)
    captured in one CUDA graph, with its own cache.

    Built once: the step runs eagerly on a side stream (as
    ``torch.cuda.graphs`` requires; this also builds the kernels, opts each
    kernel instance the step reaches into its shared memory and fills the
    launch-plan caches), the cache is zeroed, and the step and its sampling
    are captured with static inputs: a token buffer ``[B, 1]``, a
    one-element int32 position, the cache tree (updated in place) and the
    parameters.  For encdec and vlm the cache holds a ``memory`` of
    ``mem_len`` rows, zeroed after the warm-up: the caller writes it (into
    ``cache["memory"]``, in place) before the first replay, and every
    replay reads what it holds then.  A call copies the token and the position into those
    buffers and replays the graph; it returns the graph's own output
    tensors ``(next_token [B, 1], logits [B, V] f32)``, overwritten by the
    next call.  A capture or a replay that fails raises; nothing falls back
    to the eager step.

    The kernel wrappers count their launches while the step is captured,
    not when the graph replays them: ``launches`` holds each wrapper's
    launches in one replay and ``replays`` the replays so far, so a step's
    launches on a path are ``launches[name] * replays``.

    ``generator`` is the sampling generator (``temperature > 0``); it is
    registered with the graph, so each replay draws fresh numbers from it.
    Under an active sharding context it captures this rank's share of the
    step, with its block of the cache (``init_cache``), on an NCCL mesh;
    before it allocates anything it raises ``NotImplementedError`` on a
    mesh whose collectives cannot be captured (:func:`check_capturable`).
    For encdec and vlm the cache's ``memory`` is then this rank's batch
    rows, which the caller writes.
    """

    def __init__(self, cfg: ModelConfig, params: dict, batch: int,
                 s_max: int, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None, *,
                 device=None, mem_len: int = 0):
        # before anything is allocated
        check_capturable()
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError(f"CapturedServeStep: CUDA graphs need the card, "
                             f"got {dev}; the CPU runs make_serve_step")
        self.cache = init_cache(cfg, batch, s_max, dev, mem_len=mem_len)
        self.token = torch.zeros((batch, 1), dtype=torch.long, device=dev)
        self.pos = torch.zeros((), dtype=torch.int32, device=dev)
        self.graph = torch.cuda.CUDAGraph()
        self.replays = 0
        sampled = temperature > 0.0 and generator is not None
        step = make_serve_step(cfg, temperature)

        def run():
            return step(params, self.cache, self.token, self.pos,
                        generator if sampled else None)

        with torch.inference_mode():
            rng_state = generator.get_state() if sampled else None
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                run()
            torch.cuda.current_stream(dev).wait_stream(side)
            if sampled:             # the warm-up's draws are not the run's
                generator.set_state(rng_state)
            for _, leaf in tree_leaves(self.cache):   # the warm-up wrote them
                leaf.zero_()
            if sampled:
                self.graph.register_generator_state(generator)
            before = _launch_counts()
            with torch.cuda.graph(self.graph):
                self.next_token, self.logits, _ = run()
            after = _launch_counts()
        self.launches = {k: after[k] - before[k] for k in _WRAPPERS}

    def __call__(self, token: torch.Tensor,
                 pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        self.token.copy_(token)
        self.pos.copy_(pos)
        self.graph.replay()
        self.replays += 1
        return self.next_token, self.logits
