"""The captured serve step's CPU side, and the RoPE tables hoisted out of
the layers.

On the card ``generate`` replays one CUDA graph of the decode step
(``serve.step.CapturedServeStep``; held against the eager step in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``).  The CPU has no
graphs: ``generate`` runs the eager step there whatever ``capture`` says,
and the captured step refuses a CPU device.  The decode step and the
forward compute the RoPE sin / cos once and hand them to every layer;
that must give the very bits the per-layer computation gave.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.launch.serve import generate
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve.step import CapturedServeStep


def _model(arch, dtype="float32"):
    cfg = reduced_config(arch).replace(dtype=dtype)
    return cfg, TT.Decoder(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-1b", "zamba2-7b"])
def test_generate_on_the_cpu_runs_the_eager_step_either_way(arch):
    cfg, model = _model(arch)
    prompt = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 6)))
    log = []
    a = generate(cfg, model, prompt, 6, device="cpu", step_log=log)
    b = generate(cfg, model, prompt, 6, device="cpu", capture=False)
    assert torch.equal(a, b) and a.shape == (2, 12)
    assert log == []                 # nothing was captured


def test_captured_step_refuses_the_cpu():
    cfg, model = _model("qwen3-1.7b")
    with pytest.raises(ValueError, match="CUDA graphs need the card"):
        CapturedServeStep(cfg, model.tree(), 2, 8, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-1b"])
def test_hoisted_rope_is_bit_identical_to_per_layer_rope(arch, dtype):
    """One layer's attention with the step's (sin, cos) handed in equals
    the same layer computing them itself, bit for bit, in both modes."""
    cfg, model = _model(arch, dtype)
    p = TT._layer(model.tree()["blocks"], 0)
    p = p[next(iter(p))]["attn"]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 1, cfg.d_model))).to(
        cfg.torch_dtype)
    shape = (2, 20, cfg.n_kv_heads, cfg.hd)
    k = torch.from_numpy(rng.standard_normal(shape)).to(cfg.torch_dtype)
    v = torch.from_numpy(rng.standard_normal(shape)).to(cfg.torch_dtype)
    pos = torch.tensor(17, dtype=torch.int32)
    rope = TL.rope_sin_cos(pos.reshape(1), cfg.hd, cfg.rope_theta)
    y0, k0, v0 = TL.attention_from_cache(p, cfg, x, k.clone(), v.clone(),
                                         pos)
    y1, k1, v1 = TL.attention_from_cache(p, cfg, x, k.clone(), v.clone(),
                                         pos, rope=rope)
    assert torch.equal(y0, y1) and torch.equal(k0, k1) and torch.equal(v0,
                                                                       v1)
    xs = torch.from_numpy(rng.standard_normal((2, 24, cfg.d_model))).to(
        cfg.torch_dtype)
    rope = TL.rope_sin_cos(torch.arange(24, dtype=torch.int32), cfg.hd,
                           cfg.rope_theta)
    assert torch.equal(TL.attention(p, cfg, xs),
                       TL.attention(p, cfg, xs, rope=rope))
