"""Device meshes (port of ``repro.launch.mesh``).

Functions, not module constants: importing this module touches no process
group.  Each takes the process group the caller initialised
(``torch.distributed.init_process_group``, one process per rank) and lays
its ranks out row-major, so rank ``r`` of a ``(data, model)`` mesh sits at
``(r // model, r % model)``, where JAX's ``reshape(data, model)`` of its
devices puts device ``r``.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device

__all__ = ["make_production_mesh", "make_local_mesh"]


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...],
          device: Optional[Union[str, torch.device]]):
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs an initialised process group of "
            f"{math.prod(shape)} ranks (torch.distributed."
            f"init_process_group)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh over {axes} needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    if dev.type == "cuda":
        # each rank's card before the mesh's communicators start: the one
        # named, else rank modulo the cards on this host
        torch.cuda.set_device(dev if dev.index is not None else
                              dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[Union[str, torch.device]] = None):
    """16x16 = 256 ranks per pod; multi-pod adds a leading 2-pod axis.

    Axis roles: ``pod`` = outer data parallelism; ``data`` = data
    parallelism (+FSDP storage sharding); ``model`` = tensor/expert
    parallelism.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_local_mesh(data: int = 1, model: int = 1,
                    device: Optional[Union[str, torch.device]] = None):
    """A ``(data, model)`` mesh over the process group's ``data * model``
    ranks, on the card unless ``device="cpu"`` (gloo ranks)."""
    return _mesh((data, model), ("data", "model"), device)
