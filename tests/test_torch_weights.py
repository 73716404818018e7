"""numpy -> torch -> numpy carries weights bit for bit (bf16 included)."""

import numpy as np
import pytest
import torch

from repro_torch.weights import (flatten, tensor_from_numpy, tensor_to_numpy,
                                 to_numpy, to_torch, unflatten)

ml_dtypes = pytest.importorskip("ml_dtypes")

#: values that a lossy path would change: signed zero, infinities, NaN,
#: subnormals, the largest finite value
SPECIAL = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-45, 3.3e38, 1.0,
           -2.5]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_is_bit_exact(dtype):
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.standard_normal(1000) * 10, SPECIAL])
    a = vals.astype(np.float32)
    if dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16)
    a = a.reshape(-1, 2)
    t = tensor_from_numpy(a)
    assert t.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert tuple(t.shape) == a.shape
    back = tensor_to_numpy(t)
    assert back.dtype == a.dtype
    assert back.tobytes() == a.tobytes()


def test_bf16_values_agree_with_torch_rounding():
    """The bits torch reads are the values ml_dtypes meant."""
    a = np.array([1.0, -3.140625, 65280.0, 2.0 ** -20], ml_dtypes.bfloat16)
    t = tensor_from_numpy(a)
    assert t.float().tolist() == a.astype(np.float32).tolist()


def test_tree_round_trip_and_flat_keys():
    rng = np.random.default_rng(1)
    tree = {"blocks": {"b0_attn": {"attn": {
                "wq": rng.standard_normal((2, 8, 2, 4)).astype(
                    ml_dtypes.bfloat16)}}},
            "embed": rng.standard_normal((16, 8)).astype(np.float32),
            "tail": {}}
    flat = flatten(tree)
    assert list(flat) == ["blocks/b0_attn/attn/wq", "embed"]
    assert unflatten(flat)["blocks"]["b0_attn"]["attn"]["wq"] is \
        tree["blocks"]["b0_attn"]["attn"]["wq"]
    tt = to_torch(tree)
    assert tt["blocks"]["b0_attn"]["attn"]["wq"].dtype == torch.bfloat16
    assert to_torch(flat).keys() == tt.keys()       # flat input, same tree
    back = flatten(to_numpy(tt))
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and back[k].tobytes() == v.tobytes()
