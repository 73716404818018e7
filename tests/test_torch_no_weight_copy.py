"""No decode step copies a weight.

One eager ``decode_step`` of the reduced config of every registered
architecture runs under ``torch.profiler`` with ``record_shapes=True``; no
``aten::clone`` or ``aten::copy_`` may take an input with as many
elements as one of the model's weight matrices (a leaf of two or more
dimensions, one layer's slice of a stacked leaf).  An einsum whose
operand order differs from the weight's layout (``bsnh,nhd->bsd`` against
``wo [H, hd, d]``) copies the whole weight permuted on every call; at a
14B model's decode that is ~35 us a layer.

The step runs at f32, where every cast the model asks for (the f32
router, the sLSTM's f32 recurrence) is a no-op, so any copy of a
weight-sized tensor is a layout copy.  B 3 keeps the states' and caches'
sizes apart from the weights'.
"""

import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import list_archs, reduced_config
from repro_torch.models import transformer as TT
from repro_torch.models.common import tree_leaves

COPIES = ("aten::clone", "aten::copy_")
STACKED = ("blocks/", "encoder/blocks/")


def _weight_sizes(params: dict) -> set:
    sizes = set()
    for key, t in tree_leaves(params):
        leaf = t[0] if key.startswith(STACKED) else t
        if leaf.dim() >= 2:
            sizes.add(leaf.numel())
    return sizes


def _copies(fn) -> list:
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU],
                                         record_shapes=True) as prof:
        fn()
    return [(e.name, e.input_shapes[0]) for e in prof.events()
            if e.name in COPIES and e.input_shapes and e.input_shapes[0]]


@pytest.mark.parametrize("arch", list_archs())
def test_decode_step_copies_no_weight(arch):
    cfg = reduced_config(arch).replace(dtype="float32")
    params = TT.Decoder(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0)).tree()
    B = 3
    cache = TT.init_cache(cfg, B, 8, "cpu", mem_len=5)
    if "memory" in cache:
        cache["memory"].normal_(generator=torch.Generator().manual_seed(1))
    tok = torch.zeros((B, 1), dtype=torch.long)
    pos = torch.tensor(2, dtype=torch.int32)
    sizes = _weight_sizes(params)
    copies = _copies(lambda: TT.decode_step(params, cfg, cache, tok, pos))
    bad = [(name, shape) for name, shape in copies
           if math.prod(shape) in sizes]
    assert not bad, f"{arch}: weight-sized copies {bad}"


def test_the_check_sees_a_permuted_weight_copy():
    """The profile catches the einsum form the out-projections no longer
    use."""
    cfg = reduced_config("qwen3-1.7b").replace(dtype="float32")
    params = TT.Decoder(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0)).tree()
    wo = params["blocks"]["b0_attn"]["attn"]["wo"][0]
    out = torch.ones((3, 1, cfg.n_heads, cfg.hd))
    copies = _copies(lambda: torch.einsum("bsnh,nhd->bsd", out, wo))
    assert any(math.prod(shape) == wo.numel() for _, shape in copies)
