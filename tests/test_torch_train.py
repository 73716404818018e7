"""The port's training path against the JAX package, on the CPU.

``repro_torch.optim.adamw``, ``lm_loss``, the norm levers
(``norm_custom_bwd``, ``norm_mult_dtype="compute"``), ``remat``,
``make_train_step`` with microbatches, the ``run_training`` driver with
resume over loopback mirrors, and train states and checkpoints crossing
between the packages.  Inputs are made from a seed with numpy; parameters
are drawn by the JAX package and carried across bit for bit
(``tests/torch_parity.py``).

Tolerances, each with its reason:
- f32 AdamW: atol = rtol = 1e-6 after every step (the two compile
  ``b1 ** step``, the clip and the update to different instructions, an
  ulp apart); a leaf stored in bf16 (parameters or ``moment_dtype``
  bf16): atol = rtol = 1e-2, one bf16 ulp (an f32 value an ulp off can
  round to the neighbouring bf16 value).  ``grad_norm`` rtol 1e-6 (sum
  order), ``lr`` rtol 1e-6.
- ``lm_loss`` and its gradients at f32: loss rtol 1e-5, gradients atol =
  rtol = 1e-4 of each leaf's largest entry; at bf16 the loss within
  0.05 (``tests/test_torch_model.py``'s bf16 tolerance).
- the norm levers alone: f32 atol = rtol = 1e-5; bf16 atol = rtol = 2e-2
  (bf16 rounding at other points: XLA fuses the bf16 multiplies).
- loss curves of ``make_train_step`` (f32 model, 3 steps): rtol 1e-4;
  with bf16 gradient accumulation (MoE, 2 microbatches) rtol 1e-3.
- ``remat`` none / full / dots and ``attn_block_remat``: identical
  gradients (the recompute repeats the same operations).
- checkpoints, resume and weights: bit for bit.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.weights import to_numpy, to_torch  # noqa: E402
from torch_loopback import loopback, no_thread_left  # noqa: E402,F401
from torch_parity import batch_pair, fresh, pair, setup  # noqa: E402

F32 = dict(atol=1e-6, rtol=1e-6)
BF16 = dict(atol=1e-2, rtol=1e-2)


def jflat(tree) -> dict:
    return {"/".join(str(k.key) for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(
                jax.device_get(tree))[0]}


def tflat(tree) -> dict:
    return {k: v.detach().float().numpy() for k, v in tree_leaves(tree)}


def assert_trees(t, j, tol_of, what=""):
    a, b = tflat(t), jflat(j)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], **tol_of(k),
                                   err_msg=f"{what} {k}")


# ---------------------------------------------------------------- AdamW

SHAPES = {"w": (8, 16), "scale": (16,), "blk": {"k": (4, 4, 8), "b": (3,)}}


def _tree(rng, dtype, mult=1.0, shapes=SHAPES):
    return {k: _tree(rng, dtype, mult, v) if isinstance(v, dict) else
            jnp.asarray(rng.standard_normal(v) * mult,
                        jnp.float32).astype(dtype)
            for k, v in shapes.items()}


def test_lr_at_step_matches_reference():
    cfg = JA.AdamWConfig(lr=1e-3, warmup_steps=3, decay_steps=10)
    tcfg = TA.AdamWConfig(**cfg.__dict__)
    for s in range(14):
        want = float(JA.lr_at_step(cfg, jnp.float32(s)))
        got = TA.lr_at_step(tcfg, torch.tensor(float(s)))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(got.item(), want, rtol=1e-6)


def test_opt_state_specs_and_init_match_reference():
    from repro.models.common import ParamSpec as JSpec
    from repro_torch.models.common import ParamSpec as TSpec

    cfg = JA.AdamWConfig(moment_dtype="bfloat16")
    js = JA.opt_state_specs({"a": JSpec((3, 4), ("x", "y"), "normal")}, cfg)
    ts = TA.opt_state_specs({"a": TSpec((3, 4), ("x", "y"), "normal")},
                            TA.AdamWConfig(**cfg.__dict__))
    assert ts["m"]["a"] == TSpec((3, 4), ("x", "y"), "zeros") == ts["v"]["a"]
    assert js["step"].shape == ts["step"].shape == ()
    st = TA.adamw_init({"a": torch.ones(3, 4)}, TA.AdamWConfig(**cfg.__dict__))
    assert st["m"]["a"].dtype == torch.bfloat16 and st["step"].item() == 0.0


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
def test_adamw_matches_reference_over_steps(mdt, clip, mask, pdtype):
    rng = np.random.default_rng(0)
    cfg = JA.AdamWConfig(lr=1e-2, warmup_steps=2, decay_steps=6,
                         moment_dtype=mdt, grad_clip=clip)
    tcfg = TA.AdamWConfig(**cfg.__dict__)
    dt = jnp.dtype(pdtype)
    jp = _tree(rng, dt)
    tp = to_torch(jax.device_get(jp), "cpu")
    js, ts = JA.adamw_init(jp, cfg), TA.adamw_init(tp, tcfg)
    jmask = tmask = None
    if mask:        # decay every leaf, 1-D ones included
        jmask = jax.tree.map(lambda p: 0.05, jp)
        tmask = tree_map(lambda p: 0.05, tp)
    japply = jax.jit(lambda g, s, p: JA.adamw_apply(g, s, p, cfg, jmask))
    bf16 = {"float32": F32, "bfloat16": BF16}
    for _ in range(5):
        jg = _tree(rng, dt, 3.0)
        tg = to_torch(jax.device_get(jg), "cpu")
        jp, js, jm = japply(jg, js, jp)
        tp2, ts, tm = TA.adamw_apply(tg, ts, tp, tcfg, tmask)
        assert tp2 is tp                        # updated in place
        assert_trees(tp, jp, lambda k: bf16[pdtype], "params")
        for name in ("m", "v"):
            assert_trees(ts[name], js[name], lambda k: bf16[mdt], name)
        np.testing.assert_allclose(ts["step"].item(), float(js["step"]))
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]),
                                   rtol=1e-6)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(5)
    j = _tree(rng, jnp.bfloat16, 4.0)
    np.testing.assert_allclose(
        TA.global_norm(to_torch(jax.device_get(j), "cpu")).item(),
        float(JA.global_norm(j)), rtol=1e-6)


# ------------------------------------------------------------- lm_loss

@pytest.mark.parametrize("loss_dtype", ["float32", "compute"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b"])
def test_lm_loss_matches_reference_at_f32(arch, loss_dtype):
    jcfg, tcfg, jp, tp = setup(arch, "float32")
    jcfg = jcfg.replace(loss_dtype=loss_dtype)
    tcfg = tcfg.replace(loss_dtype=loss_dtype)
    jb, tb = batch_pair(tcfg, seed=7)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(p, jcfg, b)))(jp, jb)
    params = fresh(tp)
    keys, leaves = zip(*tree_leaves(params))
    tl = TT.lm_loss(params, tcfg, tb)
    assert tl.dtype == torch.float32 and tl.dim() == 0
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    grads = torch.autograd.grad(tl, leaves)
    want = jflat(jg)
    for k, g in zip(keys, grads):
        peak = float(np.abs(want[k]).max())
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4,
                                   atol=1e-4 * peak + 1e-7, err_msg=k)


@pytest.mark.parametrize("loss_dtype", ["float32", "compute"])
def test_lm_loss_matches_reference_at_bf16(loss_dtype):
    jcfg, tcfg, jp, tp = setup("qwen3-1.7b", "bfloat16")
    jb, tb = batch_pair(tcfg, seed=8)
    jl = JT.lm_loss(jp, jcfg.replace(loss_dtype=loss_dtype), jb)
    tl = TT.lm_loss(tp, tcfg.replace(loss_dtype=loss_dtype), tb)
    np.testing.assert_allclose(tl.item(), float(jl), atol=0.05)


def test_attention_refuses_compute_probs():
    """``attn_probs_dtype="compute"`` raised until its port; it now computes
    the reference's compute-dtype attention: under ``remat="full"`` the
    loss and every leaf's gradient hold ``jax.value_and_grad`` of the
    reference's at f32 (loss rtol 1e-5, gradients atol = rtol = 1e-4 of
    each leaf's largest entry, as the f32 ``lm_loss`` test above).
    ``tests/test_torch_compute_probs.py`` holds the option in full."""
    jcfg, tcfg, jp, tp = setup("qwen3-1.7b", "float32")
    jcfg = jcfg.replace(attn_probs_dtype="compute", remat="full")
    tcfg = tcfg.replace(attn_probs_dtype="compute", remat="full")
    jb, tb = batch_pair(tcfg, seed=11)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(p, jcfg, b)))(jp, jb)
    params = fresh(tp)
    keys, leaves = zip(*tree_leaves(params))
    tl = TT.lm_loss(params, tcfg, tb)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    want = jflat(jg)
    for k, g in zip(keys, torch.autograd.grad(tl, leaves)):
        peak = float(np.abs(want[k]).max())
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4,
                                   atol=1e-4 * peak + 1e-7, err_msg=k)


# ----------------------------------------------------------- norm levers

NORM_CASES = [("rmsnorm", True, True), ("rmsnorm", False, True),
              ("rmsnorm", False, False), ("layernorm", False, False),
              ("layernorm", True, False), ("rmsnorm", True, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,custom,f32_mult", NORM_CASES, ids=str)
def test_apply_norm_levers_match_reference(kind, custom, f32_mult, dtype):
    """Value and VJP (x, scale, bias) of every branch of ``apply_norm``."""
    rng = np.random.default_rng(9)
    dt = jnp.dtype(dtype)
    jx, tx = pair(rng.standard_normal((3, 5, 64)), dt)
    jdy, tdy = pair(rng.standard_normal((3, 5, 64)), dt)
    js, ts = pair(1.0 + 0.3 * rng.standard_normal(64), dt)
    jbias, tbias = pair(0.2 * rng.standard_normal(64), dt)
    jpar = {"scale": js, "bias": jbias} if kind == "layernorm" else \
        {"scale": js}
    tpar = {"scale": ts.requires_grad_(True)}
    if kind == "layernorm":
        tpar["bias"] = tbias.requires_grad_(True)
    y, vjp = jax.vjp(lambda x, p: JL.apply_norm(p, x, 1e-6, kind, f32_mult,
                                                custom_bwd=custom), jx, jpar)
    jdx, jdp = vjp(jdy)
    tx.requires_grad_(True)
    ty = TL.apply_norm(tpar, tx, 1e-6, kind, f32_mult, custom)
    got = torch.autograd.grad(ty, [tx, *tpar.values()], tdy)
    tol = F32 if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    tol = dict(atol=max(tol["atol"], 1e-5), rtol=max(tol["rtol"], 1e-5))
    np.testing.assert_allclose(ty.detach().float().numpy(),
                               np.asarray(y, np.float32), **tol)
    for g, w in zip(got, [jdx, *(jdp[k] for k in tpar)]):
        assert g.dtype == tx.dtype
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=tol["rtol"],
                                   atol=tol["atol"] * max(
                                       1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("lever", [{"norm_custom_bwd": 1},
                                   {"norm_mult_dtype": "compute"}], ids=str)
def test_model_gradients_with_norm_levers_match_reference(lever):
    jcfg, tcfg, jp, tp = setup("qwen3-1.7b", "float32")
    jcfg, tcfg = jcfg.replace(**lever), tcfg.replace(**lever)
    jb, tb = batch_pair(tcfg, seed=10)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(p, jcfg, b)))(jp, jb)
    params = fresh(tp)
    keys, leaves = zip(*tree_leaves(params))
    tl = TT.lm_loss(params, tcfg, tb)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    want = jflat(jg)
    for k, g in zip(keys, torch.autograd.grad(tl, leaves)):
        peak = float(np.abs(want[k]).max())
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-4,
                                   atol=1e-4 * peak + 1e-7, err_msg=k)


# ---------------------------------------------------------------- remat

def _grads(tp, tcfg, tb, **kw):
    params = fresh(tp)
    keys, leaves = zip(*tree_leaves(params))
    loss = TT.lm_loss(params, tcfg, tb, **kw)
    return loss, dict(zip(keys, torch.autograd.grad(loss, leaves)))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-7b",
                                  "whisper-large-v3"])
def test_remat_variants_give_the_same_gradients(arch):
    _, tcfg, _, tp = setup(arch, "float32")
    _, tb = batch_pair(tcfg, seed=11)
    l0, g0 = _grads(tp, tcfg.replace(remat="none"), tb)
    for remat in ("full", "dots"):
        l1, g1 = _grads(tp, tcfg.replace(remat=remat), tb)
        assert torch.equal(l0, l1)
        for k in g0:
            assert torch.equal(g0[k], g1[k]), (remat, k)


def test_attn_block_remat_gives_the_same_gradients():
    """The plain path's query blocks (``q_block`` 4 of S 16), checkpointed
    or not."""
    _, tcfg, _, tp = setup("qwen3-1.7b", "float32")
    _, tb = batch_pair(tcfg, seed=12)
    l0, g0 = _grads(tp, tcfg, tb, plain=True, q_block=4)
    l1, g1 = _grads(tp, tcfg.replace(attn_block_remat=1), tb, plain=True,
                    q_block=4)
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_forward_without_grad_takes_no_checkpoint(monkeypatch):
    """Serving and prefill (no grad) never go through the checkpoint."""
    _, tcfg, _, tp = setup("qwen3-1.7b", "float32")
    _, tb = batch_pair(tcfg)

    def refuse(*a, **kw):
        raise AssertionError("checkpoint under no_grad")

    monkeypatch.setattr(TT, "checkpoint", refuse)
    with torch.inference_mode():
        TT.forward(tp, tcfg.replace(remat="full"), tb)


# ------------------------------------------------------------ train step

STEP_CASES = [("qwen3-1.7b", 1, 1e-4), ("qwen3-1.7b", 2, 1e-4),
              ("olmoe-1b-7b", 2, 1e-3)]


@pytest.mark.parametrize("arch,mb,rtol", STEP_CASES, ids=str)
def test_train_step_loss_curve_matches_reference(arch, mb, rtol):
    """Three steps from the same weights on the same batches.  olmoe at 2
    microbatches accumulates its gradients in bf16, as the reference's
    does."""
    jcfg, tcfg, jp, tp = setup(arch, "float32")
    jcfg, tcfg = jcfg.replace(microbatches=mb), tcfg.replace(microbatches=mb)
    opt = JA.AdamWConfig(lr=3e-3, warmup_steps=1, decay_steps=4)
    topt = TA.AdamWConfig(**opt.__dict__)
    jstate = JS.init_train_state(jp, opt)
    tstate = TS.init_train_state(fresh(tp), topt)
    jstep = jax.jit(JS.make_train_step(jcfg, opt))
    tstep = TS.make_train_step(tcfg, topt)
    rng = np.random.default_rng(13)
    for _ in range(3):
        toks = rng.integers(0, tcfg.vocab_size, (4, 16)).astype(np.int32)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=rtol)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=10 * rtol)
    assert tstate["step"].dtype == torch.int32
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    assert all(p.requires_grad for _, p in tree_leaves(tstate["params"]))


# ------------------------------------------------------ driver and resume

def test_run_training_resumes_with_the_same_losses(tmp_path, loopback):
    """Four steps over three loopback mirrors, checkpointed every step
    (keep 2); then the last checkpoint is removed and the run resumed from
    step 3: its loss equals the uninterrupted run's, bit for bit, and the
    final states are bit-equal."""
    cfg = reduced_config("qwen3-1.7b")

    def mirror(blobs, rate):
        return loopback.server(blobs, rate=rate)

    kw = dict(mirrors=3, device="cpu", mirror=mirror, log_every=10)
    full, losses = loopback.bounded(lambda: run_training(
        cfg, 4, 4, 16, ckpt_dir=str(tmp_path / "a"), **kw), timeout=60)
    assert len(losses) == 4 and all(np.isfinite(losses))
    ck = str(tmp_path / "a")
    assert latest_step(ck) == 4
    import shutil

    shutil.rmtree(os.path.join(ck, f"step_{4:010d}"))
    assert latest_step(ck) == 3
    resumed, tail = loopback.bounded(lambda: run_training(
        cfg, 4, 4, 16, ckpt_dir=ck, resume=True, **kw), timeout=60)
    assert tail == losses[3:]
    a, b = dict(tree_leaves(full)), dict(tree_leaves(resumed))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------ crossing the packages

def _jax_state(arch="qwen3-1.7b", moment_dtype="float32"):
    """A reference train state one step in (moments and steps nonzero)."""
    jcfg, _, jp, _ = setup(arch, "bfloat16")
    opt = JA.AdamWConfig(moment_dtype=moment_dtype, warmup_steps=1)
    state = JS.init_train_state(jp, opt)
    toks = np.random.default_rng(14).integers(0, jcfg.vocab_size, (2, 16))
    state, _ = jax.jit(JS.make_train_step(jcfg, opt))(
        state, {"tokens": jnp.asarray(toks, jnp.int32)})
    return jax.device_get(state)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same_bits(t_tree, j_tree):
    a = {k: v for k, v in tree_leaves(to_numpy(t_tree))}
    b = {"/".join(str(k.key) for k in path): v for path, v in
         jax.tree_util.tree_flatten_with_path(j_tree)[0]}
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), err_msg=k)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_train_state_crosses_through_weights(moment_dtype):
    js = _jax_state(moment_dtype=moment_dtype)
    ts = to_torch(js, "cpu")
    assert ts["opt"]["step"].dtype == torch.float32
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    _same_bits(ts, js)


def test_reference_train_checkpoint_restores_into_the_port(tmp_path):
    js = _jax_state()
    jax_save(str(tmp_path), 1, js)
    ts, step = restore_checkpoint(str(tmp_path), to_torch(js, "cpu"),
                                  device="cpu")
    assert step == 1
    _same_bits(ts, js)


def test_port_train_checkpoint_restores_into_the_reference(tmp_path):
    _, tcfg, _, tp = setup("qwen3-1.7b", "bfloat16")
    opt = TA.AdamWConfig(warmup_steps=1)
    state = TS.init_train_state(fresh(tp), opt)
    toks = np.random.default_rng(15).integers(0, tcfg.vocab_size, (2, 16))
    state, _ = TS.make_train_step(tcfg, opt)(
        state, {"tokens": torch.from_numpy(toks.astype(np.int32))})
    save_checkpoint(str(tmp_path), 1, state)
    like = jax.tree.map(jnp.asarray, to_numpy(state))
    js, step = jax_restore(str(tmp_path), like)
    assert step == 1
    _same_bits(state, jax.device_get(js))
