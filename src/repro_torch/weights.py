"""Carry weights between the JAX reference package and the port.

The reference hands out its parameter tree as numpy arrays
(``jax.device_get``): a nested dict whose bf16 leaves are
``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` rejects.  The
port keeps the reference's key paths and shapes, so the mapping is by
"/"-joined key; bf16 crosses as raw 16-bit words
(``.view(np.uint16)`` -> ``torch.from_numpy`` -> ``.view(torch.bfloat16)``),
bit for bit.  Nothing here needs ``ml_dtypes`` except turning a bf16
tensor back into a numpy bf16 array.

A train state crosses the same way: ``{"params", "opt": {"m", "v",
"step"}, "step"}`` with its 0-d leaves (the optimizer's f32 step, the
state's int32 step) and moments in either ``moment_dtype``.  Parameters
that require grad go out detached; :func:`to_torch` returns plain
tensors, to which ``repro_torch.train.init_train_state`` gives
``requires_grad``.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models.common import tree_leaves

__all__ = ["flatten", "unflatten", "tensor_from_numpy", "tensor_to_numpy",
           "to_torch", "to_numpy"]


def flatten(tree: Any) -> dict[str, Any]:
    """Nested dict -> ``{"/"-joined key: leaf}`` (sorted, as JAX orders)."""
    return dict(tree_leaves(tree))


def unflatten(flat: dict[str, Any]) -> dict:
    """``{"/"-joined key: leaf}`` -> nested dict."""
    out: dict = {}
    for key, leaf in flat.items():
        node = out
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """numpy array (bf16 included) -> CPU tensor with the same bits."""
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy(order="C")       # e.g. a read-only view of a JAX buffer
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy array with the same bits (bf16 via ``ml_dtypes``)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_torch(tree: Any,
             device: Optional[Union[str, torch.device]] = None) -> dict:
    """numpy tree (nested or "/"-flat) -> nested dict of tensors on
    ``device`` (``None``: the card; pass ``"cpu"`` for the CPU), ready for
    ``Decoder(cfg, params=...)``."""
    dev = resolve_device(device)
    return unflatten({k: tensor_from_numpy(np.asarray(v)).to(dev)
                      for k, v in flatten(tree).items()})


def to_numpy(tree: Any) -> dict:
    """Tree of tensors -> nested dict of numpy arrays (the reference's
    parameter-tree form)."""
    return unflatten({k: tensor_to_numpy(v) for k, v in flatten(tree).items()})
