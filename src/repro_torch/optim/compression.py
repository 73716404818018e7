"""Gradient compression for the data-parallel reduction (port of
``repro.optim.compression``).

int8 quantization with per-tensor scales and **error feedback**: the
quantization residual is carried to the next step, so the compressed SGD
trajectory tracks the uncompressed one (Karimireddy et al., 2019).  This
cuts the DP all-reduce volume 4x (f32) / 2x (bf16).

Each rank quantizes its local gradient and the group reduces it with
``torch.distributed`` collectives over the data group: ``compressed_mean``
all-reduces the bf16 ``q * scale``; ``compressed_reduce_scatter`` sends
the int8 quants through one ``all_to_all_single`` (the only full-size
collective) beside an all-gather of the f32 scales.  ``quantize_int8``
rounds half to even (``torch.round``, as ``jnp.round``), so q and the
scale are bit-equal to the reference's.

A stand-alone drop-in, as in the reference: the train step does not call
it.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import all_gather_into
from repro_torch.distributed.context import Mesh
from repro_torch.models.common import tree_map

__all__ = ["quantize_int8", "dequantize_int8", "compressed_mean",
           "compressed_reduce_scatter", "make_compressed_allreduce"]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8.  Returns (q, scale), scale a 0-d f32."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_mean(local: Any, group) -> Any:
    """Mean over ``group`` of an int8-compressed tree: each rank's bf16
    ``q * scale`` summed by one all-reduce, divided by the group size, in
    f32."""
    n = dist.get_world_size(group)

    def one(x):
        q, scale = quantize_int8(x)
        # contiguous for the collective (a gradient may be transposed)
        total = (q.to(torch.bfloat16) * scale.to(torch.bfloat16)).contiguous()
        dist.all_reduce(total, group=group)
        return (total / n).float()

    return tree_map(one, local)


def compressed_reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """int8-on-the-wire reduce-scatter MEAN over ``group``.

    Each rank quantizes its local partial to int8 (its own scale), pads the
    flattened quants to a multiple of the group size N, and
    ``all_to_all_single``s the int8 shards — the only full-size collective,
    1 B/elem on the wire — beside an all-gather of the N f32 scales, then
    dequant-sums the N received shards in f32.  Returns this rank's f32
    shard of the mean: shape ``[size / N]`` of the flattened, zero-padded
    input."""
    n = dist.get_world_size(group)
    q, scale = quantize_int8(x)
    flat = q.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    recv = torch.empty_like(flat)
    dist.all_to_all_single(recv, flat, group=group)     # int8 [N * shard]
    scales = scale.new_empty(n)
    all_gather_into(scales, scale.reshape(1), group)    # f32 [N] (tiny)
    deq = recv.reshape(n, -1).float() * scales.reshape(n, 1)
    return deq.sum(dim=0) / n


def make_compressed_allreduce(mesh: Any,
                              data_axes: Sequence[str] = ("data", "pod"),
                              error_feedback: bool = True):
    """Returns ``reduce(grads, err) -> (mean_grads, new_err)``.

    ``grads`` are this rank's local-batch gradients; the mean runs over
    the mesh's ``data_axes`` (a ``DeviceMesh`` or
    ``repro_torch.distributed.Mesh``).  ``err`` is the error-feedback
    state (same tree, f32), carried across steps."""
    mesh = Mesh.of(mesh)
    axes = tuple(a for a in data_axes if a in mesh.axis_names)
    if not axes:
        raise ValueError(f"the mesh {mesh.axis_names} has none of the data "
                         f"axes {tuple(data_axes)}")
    group = mesh.group(axes)

    def reduce(grads: Any, err: Optional[Any]):
        if err is not None:
            grads = tree_map(lambda g, e: g.float() + e, grads, err)
        meaned = compressed_mean(grads, group)
        if not error_feedback:
            return meaned, err
        new_err = tree_map(lambda g, m: g.float() - _requant_view(m),
                        grads, meaned)
        return meaned, new_err

    def _requant_view(m):
        q, s = quantize_int8(m)
        return dequantize_int8(q, s)

    return reduce
