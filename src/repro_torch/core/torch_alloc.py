"""Vectorized PyTorch implementation of the MDTP bin-packing allocator.

The port's counterpart of ``repro.core.jax_alloc``.  It mirrors
``repro_torch.core.chunking`` (cross-checked in tests) as a fused tensor
computation over the throughput vector, so the on-device simulators
(``repro_torch.core.torch_sim``) can run it inside their step loops for a
whole batch of lanes at once.

Lanes are a leading batch axis: throughputs are ``[..., N]`` (N servers),
and ``remaining`` and the chunk geometry are ``[...]`` (one value per lane)
or scalars.  Chunk geometry is **data**: the ``(C, L, min_chunk)`` triple
is a :class:`ChunkArrays` of float32 tensors, so a whole (C, L) grid is one
more set of lanes.  Only ``mode`` (a branch structure) is a Python value.

All sizes are float32 bytes; the integer clamping of the Python allocator
is reproduced with ``torch.round``, which rounds half to even exactly as
``jnp.round`` does.  float32 is exact to ~16 bytes at the 160 MB chunk
scale, far below the allocator's 64 KiB ``min_chunk``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from .chunking import ChunkParams

__all__ = [
    "ChunkArrays",
    "as_chunk_arrays",
    "chunk_sizes",
    "round_allocate",
    "geometric_mean",
]


class ChunkArrays(NamedTuple):
    """``(C, L, min_chunk)`` of the MDTP allocator as float32 tensors:
    scalars, or one entry per lane."""

    initial_chunk: torch.Tensor
    large_chunk: torch.Tensor
    min_chunk: torch.Tensor

    @classmethod
    def from_params(cls, params: ChunkParams,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> "ChunkArrays":
        def f(x):
            return torch.tensor(float(x), dtype=torch.float32, device=device)

        return cls(f(params.initial_chunk), f(params.large_chunk),
                   f(params.min_chunk))


ChunkParamsLike = Union[ChunkParams, ChunkArrays, tuple]


def as_chunk_arrays(params: ChunkParamsLike, mode: str | None = None,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> tuple[ChunkArrays, str]:
    """Normalize any chunk-parameter form to ``(ChunkArrays, mode)``.

    Accepts a :class:`~repro_torch.core.chunking.ChunkParams` (mode read
    from it unless overridden), a :class:`ChunkArrays`, or a bare
    ``(C, L, min)`` triple of numbers or tensors.
    """
    if isinstance(params, ChunkParams):
        return ChunkArrays.from_params(params, device), (mode or params.mode)
    if isinstance(params, ChunkArrays):
        arrays = params
    else:
        c, l, m = params
        arrays = ChunkArrays(
            *(torch.as_tensor(x, dtype=torch.float32, device=device)
              for x in (c, l, m)))
    return arrays, (mode or "proportional")


def geometric_mean(throughputs: torch.Tensor) -> torch.Tensor:
    """GM over the positive entries of the last axis; 0.0 if none (matches
    chunking.py)."""
    mask = throughputs > 0.0
    n = mask.sum(-1)
    logs = torch.where(mask, torch.log(torch.where(mask, throughputs, 1.0)),
                       0.0)
    gm = torch.exp(logs.sum(-1) / n.clamp(min=1))
    return torch.where(n > 0, gm, 0.0)


def _lane(x: torch.Tensor) -> torch.Tensor:
    """A per-lane value ``[...]`` broadcast against the server axis."""
    return x.unsqueeze(-1)


def chunk_sizes(
    throughputs: torch.Tensor,
    remaining,
    params: ChunkParamsLike,
    mode: str | None = None,
    exact: bool = True,
) -> torch.Tensor:
    """Next-request sizes ``[..., N]``, one per server.

    Equivalent to ``chunking.round_chunk_sizes`` evaluated for every server
    against the same ``remaining`` (i.e. "what would each server get if it
    asked right now").

    Args:
      throughputs: ``[..., N]`` bytes/s; ``<= 0`` = not yet probed.
      remaining: ``[...]`` (or scalar) unassigned bytes.
      params: allocator constants, a ``ChunkParams`` or a ``ChunkArrays`` /
        ``(C, L, min)`` triple whose entries are scalars or ``[...]``.
      mode: branch selector; defaults to ``params.mode`` for
        ``ChunkParams`` and ``"proportional"`` otherwise.  ``"static"``
        gives every probed server exactly ``L`` (fixed-chunk baseline).
      exact: when False, skip the integer ``torch.round`` on proportional
        sizes: a continuous relaxation whose output is differentiable in
        ``(C, L)``, used by the gradient-based tuner.  The relaxation error
        is < 1 byte per request.

    Returns:
      ``[..., N]`` float32 sizes, clamped to ``remaining``; 0 when done.
    """
    th = throughputs.to(torch.float32)
    arrays, mode = as_chunk_arrays(params, mode, device=th.device)
    remaining = _lane(torch.as_tensor(remaining, dtype=torch.float32,
                                      device=th.device))
    probed = th > 0.0
    any_probed = probed.any(-1, keepdim=True)
    th_max = torch.where(probed, th, -torch.inf).amax(-1, keepdim=True)
    th_max = torch.where(any_probed, th_max, 1.0)   # avoid -inf division

    C = _lane(arrays.initial_chunk)
    L = _lane(arrays.large_chunk)

    proportional = L * th / th_max
    if exact:
        proportional = torch.round(proportional)
    if mode == "fast_get_large":
        gm = _lane(geometric_mean(th))
        adaptive = torch.where(th >= gm, L, proportional)
    elif mode == "static":
        adaptive = L.expand_as(th)
    else:
        adaptive = torch.where(th >= th_max, L, proportional)

    size = torch.where(probed, adaptive, C)
    size = torch.maximum(size, _lane(arrays.min_chunk))
    size = torch.minimum(size, remaining)
    return torch.where(remaining > 0.0, size, 0.0)


def grant(sizes: torch.Tensor, remaining: torch.Tensor,
          draw_counts: torch.Tensor, zero: Optional[torch.Tensor] = None
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The budget clamp of :func:`round_allocate` on already-computed
    ``sizes``: an ``[N, N]`` masked sum of the draws landing before each
    server's ask, debited from ``remaining``.  ``zero`` (a float32 scalar
    tensor on the device) spares a fill when called in a loop."""
    before = (draw_counts * sizes.unsqueeze(-2)).sum(-1)
    if zero is None:
        zero = torch.zeros((), dtype=torch.float32, device=sizes.device)
    avail = torch.maximum(_lane(remaining) - before, zero)
    granted = torch.minimum(sizes, avail)
    return granted, granted.sum(-1)


def round_allocate(
    throughputs: torch.Tensor,
    remaining,
    order_key: torch.Tensor,
    params: ChunkParamsLike,
    mode: str | None = None,
    exact: bool = True,
    eligible: Optional[torch.Tensor] = None,
    draw_counts: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Allocate one full round for all N servers in a single vector op.

    The event-driven core draws one request per loop iteration, updating
    the shared cursor between draws.  A round-synchronous round makes the
    same N draws, so they can be fused: compute every server's candidate
    size against the round-start ``remaining`` (:func:`chunk_sizes`), then
    replay the sequential budget clamp as an exclusive prefix sum in *ask
    order* (``order_key`` ascending, stable ties by index).  Because the
    adaptive size formula depends on ``remaining`` only through the final
    clamp, ``min(size_i, remaining - sum(earlier grants))`` is identical to
    the event core's per-draw recomputation.

    Args:
      throughputs: ``[..., N]`` observed bytes/s (``<= 0`` = unprobed).
      remaining: ``[...]`` unassigned bytes at round start.
      order_key: ``[..., N]`` ask-time proxy (per-server clock).
      params / mode / exact: forwarded to :func:`chunk_sizes`.
      eligible: optional ``[..., N]`` bool mask; ineligible servers draw
        nothing this round (retired connections).
      draw_counts: optional ``[..., N, N]`` float matrix: ``counts[i, j]``
        = how many draws of server j's current size land before server i's
        ask.  Defaults to the 0/1 ask-order precedence above; the round
        simulator passes a time-aware count.

    Returns:
      ``(granted, total)``: ``[..., N]`` per-server grants and their
      ``[...]`` sum (the round's single cursor update).

    The budget debit is an ``[N, N]`` masked sum rather than sort, cumsum
    and scatter: at simulator N (4-16 servers) the N² form is a handful of
    elementwise ops.
    """
    th = throughputs.to(torch.float32)
    remaining = torch.as_tensor(remaining, dtype=torch.float32,
                                device=th.device)
    sizes = chunk_sizes(th, remaining, params, mode=mode, exact=exact)
    if eligible is not None:
        sizes = torch.where(eligible, sizes, 0.0)
    if draw_counts is None:
        key = torch.as_tensor(order_key, device=th.device)
        idx = torch.arange(key.shape[-1], device=key.device)
        # j is served before i iff it asks earlier (stable ties by index)
        draw_counts = ((key.unsqueeze(-2) < key.unsqueeze(-1)) | (
            (key.unsqueeze(-2) == key.unsqueeze(-1))
            & (idx[None, :] < idx[:, None]))).to(torch.float32)
    return grant(sizes, remaining, draw_counts)
