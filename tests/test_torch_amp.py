"""Port parity of amp (bf16 activations, ``dicttts_tpu_torch/ops/amp.py``)
against the JAX task under amp, and the port's amp contract.

The inputs and weights are chip_smoke.py phase 10d's (``amp_check_inputs``,
``amp_check_weights``; the JAX side gets the same weights through
convert.py's map, inverted): small widths, gathered banks (the eager S2PA
branch on both sides), dropout 0, the posterior noise, the crop starts
and the prior sample pinned.

autocast is not the JAX package's explicit dtype policy. The modules
that the JAX package builds without a compute dtype (the duration
predictor, the discriminator's ``adv`` head, the JCU discriminator) run
in f32 islands in the port too, so the frames each word gets at
inference are equal (mel2word, checked here). Inside the hot layers the
two still round different tensors to bf16 (autocast rounds each conv's
weights and inputs, the JAX modules their activations). So the port under
amp is held to the JAX task under amp within the gap that the JAX package
itself shows between amp and f32 on the same inputs, measured in the same
test: over the vector of losses, the largest |port_amp - jax_amp| of any
loss <= the largest |jax_amp - jax_f32| (measured: 1.70e-3 against
1.74e-3, both in the discriminator's real term; 1.44e-3 before the f32
islands). chip_smoke.py keeps that JAX gap as a constant and bounds the
card's own amp-vs-f32 gap on the same inputs by twice it; this test holds
the constant to the measurement (1 %). On mel_out the two policies'
rounding errors are independent and add, so the bound there is twice the
JAX gap in its largest element, the factor phase 10d uses (measured: 1.13x
the gap in training, 1.27x at inference by the largest element, unchanged
by the f32 islands, which mel_out does not pass through in training and
which at inference only set the frame counts; 0.96-1.12x by the L2 norm
and the mean). The f32 port stays at
tests/test_torch_train_task.py's tolerances (checked here too: rtol 1e-5,
atol 1e-6). K3 under amp (bf16 q, f32 k and v) is held to the JAX
kernel's f32 outputs (interpret mode) rounded to bf16, to one bf16
rounding (rtol 2**-7).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402
import test_torch_train_task as T  # noqa: E402

from dicttts_tpu.models import discriminator as jdisc  # noqa: E402
from dicttts_tpu.ops.s2pa_pallas import s2pa_fused as j_s2pa_fused  # noqa: E402
from dicttts_tpu.train.tasks.dict_tts import DictTTSTask as JTask  # noqa: E402
from dicttts_tpu_torch.convert import jax_params_to_state, load_jax_params  # noqa: E402
from dicttts_tpu_torch.ops.amp import task_activation_dtype  # noqa: E402
from dicttts_tpu_torch.ops.s2pa_fused import s2pa_fused  # noqa: E402
from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask  # noqa: E402

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

CFG = cs.AMP_CHECK_CFG
INFER_FRAMES = CFG["max_frames"]


def to_flax(module, template):
    """The flax tree (layout of ``template``, a tree of shapes) whose
    ``load_jax_params`` gives ``module``'s parameters: convert.py's map run
    on a tree of element indices, then inverted."""
    leaves, treedef = jax.tree.flatten(template)
    offsets = np.cumsum([0] + [int(np.prod(leaf.shape)) for leaf in leaves])
    index = treedef.unflatten([np.arange(offsets[i], offsets[i + 1]).reshape(leaf.shape)
                               for i, leaf in enumerate(leaves)])
    flat = np.full(offsets[-1], np.nan, np.float32)
    state = module.state_dict()
    for name, idx in jax_params_to_state(module, index).items():
        flat[np.asarray(idx).ravel()] = state[name].numpy().ravel()
    assert not np.isnan(flat).any()
    return treedef.unflatten([flat[offsets[i]:offsets[i + 1]].reshape(leaf.shape)
                              for i, leaf in enumerate(leaves)])


@pytest.fixture(scope="module")
def setup():
    """chip_smoke.py phase 10d's inputs and weights (the JAX side gets the
    same weights through convert.py's map, inverted), and a prior sample."""
    batch, eps, u, starts = cs.amp_check_inputs()
    assert np.array_equal(starts, T._starts(u, batch["mel_lengths"]))
    jt = JTask(dict(CFG), None)
    state = jax.eval_shape(lambda r: {k: v for k, v in jt.build_state(r).items()
                                      if k.startswith("params")}, jax.random.PRNGKey(0))
    task = DictTTSTask(dict(CFG), device="cpu")
    task.build_state(cs.SEED)
    cs.amp_check_weights(task)
    params_g, params_d = to_flax(task.model, state["params_g"]), to_flax(task.disc, state["params_d"])
    for module, tree in ((task.model, params_g), (task.disc, params_d)):  # the inverse is exact
        want = {k: v.clone() for k, v in module.state_dict().items()}
        load_jax_params(module, tree)
        assert all(torch.equal(want[k], v) for k, v in module.state_dict().items())
    z_p = np.random.RandomState(4).randn(2, INFER_FRAMES // 4, CFG["latent_size"]).astype(np.float32)
    return {"params_g": params_g, "params_d": params_d, "batch": batch, "u": u, "starts": starts,
            "eps": eps, "z_p": z_p}


@pytest.fixture
def pinned_jax(monkeypatch, setup):
    """jax.random.normal gives the pinned arrays of its shapes, uniform the
    crop uniforms; the discriminator blocks have no dropout."""
    normal = jax.random.normal
    by_shape = {setup["eps"].shape: setup["eps"], setup["z_p"].shape: setup["z_p"]}

    def pinned(key, shape, dtype=jnp.float32):
        return jnp.asarray(by_shape[tuple(shape)], dtype) if tuple(shape) in by_shape else normal(key, shape, dtype)

    monkeypatch.setattr(jax.random, "normal", pinned)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(setup["u"]))
    monkeypatch.setattr(jdisc, "Disc2DBlockStack", T._NoDropoutBlock)


def _jax_step(setup, amp):
    """The JAX task's generator and discriminator losses and mel_out, in one
    jitted call under its amp scope, and its inference mel_out."""
    jt = JTask(dict(CFG, amp=amp), None)
    jb = {k: jnp.asarray(v) for k, v in setup["batch"].items()}

    def f(pg, pd, b, key):
        with jt._amp_scope():
            loss, (losses, out) = jt._gen_losses(pg, pd, b, key, True, 1.0)
            loss_d, d_losses = jt._disc_losses(pd, out["mel_out"], b["mels"], b["mel_lengths"], key)
        return {**losses, **d_losses, "total_loss": loss, "disc_loss": loss_d}, out["mel_out"]

    losses, mel = jax.jit(f)(setup["params_g"], setup["params_d"], jb, jax.random.PRNGKey(5))
    infer = jax.jit(jt.test_step)({"params_g": setup["params_g"]}, jb, jax.random.PRNGKey(6))
    return ({k: float(v) for k, v in losses.items()}, np.asarray(mel),
            {k: np.asarray(infer[k]) for k in ("mel_out", "mel2word")})


def _port_task(setup, amp, **cfg):
    task = DictTTSTask({**CFG, "amp": amp, **cfg}, device="cpu")
    task.build_state(0)
    load_jax_params(task.model, setup["params_g"])
    load_jax_params(task.disc, setup["params_d"])
    return task


def _port_step(setup, amp):
    task = _port_task(setup, amp)
    tb = task.to_device(setup["batch"])
    starts = torch.tensor(setup["starts"])
    task.model.train()
    task.disc.train()
    loss, losses, out = task._gen_losses(tb, None, True, 1.0, torch.tensor(setup["eps"]), starts)
    loss_d, d_losses = task._disc_losses(out["mel_out"].detach(), tb["mels"], tb["mel_lengths"], None,
                                         starts)
    got = {**{k: v.item() for k, v in {**losses, **d_losses}.items()}, "total_loss": loss.item(),
           "disc_loss": loss_d.item()}
    assert all(v.dtype == torch.float32 for v in (*losses.values(), *d_losses.values(), loss, loss_d))
    infer = task.test_step(tb, noise=torch.tensor(setup["z_p"]))
    return got, out["mel_out"].detach().numpy(), {k: infer[k].numpy() for k in ("mel_out", "mel2word")}


def test_amp_step_and_infer_match_jax_within_its_amp_gap(setup, pinned_jax):
    j32, jmel32, jinf32 = _jax_step(setup, False)
    j16, jmel16, jinf16 = _jax_step(setup, True)
    p32, pmel32, pinf32 = _port_step(setup, False)
    p16, pmel16, pinf16 = _port_step(setup, True)
    assert set(p16) == set(j16) == set(j32)
    for k in j32:  # f32: the training slice's tolerances
        np.testing.assert_allclose(p32[k], j32[k], rtol=1e-5, atol=1e-6, err_msg=k)
    gap = max(abs(j16[k] - j32[k]) for k in j32)
    err = max(abs(p16[k] - j16[k]) for k in j32)
    assert 0 < gap < 0.01 and err <= gap, (err, gap, {k: (j32[k], j16[k], p16[k]) for k in j32})
    # chip_smoke.py phase 10d bounds the card's amp-vs-f32 gap on these
    # inputs by twice this one, which it keeps as a constant
    assert gap == pytest.approx(cs.JAX_AMP_LOSS_GAP, rel=0.01), gap
    # and the port's own amp step, as that phase runs it
    port = {"f32": cs.amp_check_losses("cpu", False), "amp": cs.amp_check_losses("cpu", True)}
    assert set(port["amp"]) == set(j16)
    for k in j32:
        np.testing.assert_allclose(port["f32"][k], j32[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert max(abs(port["amp"][k] - j16[k]) for k in j32) <= gap
    # the duration predictor runs in f32 under amp in both packages, so the
    # frames each word gets at inference are the JAX package's
    for p, j in ((pinf16, jinf16), (pinf32, jinf32)):
        np.testing.assert_array_equal(p["mel2word"], j["mel2word"])
    np.testing.assert_array_equal((pinf16["mel2word"] > 0).sum(-1), (jinf16["mel2word"] > 0).sum(-1))
    # mel_out: 2x, measured 1.13x (train) and 1.27x (infer) of the JAX gap
    for name, (p, ja, jf) in {"train mel_out": (pmel16, jmel16, jmel32),
                              "infer mel_out": (pinf16["mel_out"], jinf16["mel_out"],
                                                jinf32["mel_out"])}.items():
        gap, err = np.abs(ja - jf).max(), np.abs(p - ja).max()
        assert p.dtype == np.float32 and np.isfinite(p).all(), name
        assert 0 < gap and err <= 2 * gap, (name, err, gap)
    np.testing.assert_allclose(pinf32["mel_out"], jinf32["mel_out"], rtol=1e-4, atol=1e-4)


def test_amp_train_step_keeps_params_optimizer_and_losses_f32(setup):
    task = _port_task(setup, True)
    assert task_activation_dtype(task.cfg) == torch.bfloat16
    batch = task.to_device(setup["batch"])
    metrics = task.train_step(batch, torch.Generator().manual_seed(0))
    for k, v in metrics.items():
        assert v.dtype == torch.float32 and bool(torch.isfinite(v)), k
    assert "grad_norm_g" in metrics and "grad_norm_d" in metrics
    for module, opt in ((task.model, task.opt_g), (task.disc, task.opt_d)):
        assert all(p.dtype == torch.float32 for p in module.parameters())
        for st in opt.state.values():
            assert all(v.dtype == torch.float32 for v in st.values() if v.is_floating_point() and v.ndim)


def test_amp_holds_an_f32_bank_as_bf16_and_trains_on_it(setup):
    bank = T._bank(0)
    task = DictTTSTask({**T.CFG, "amp": True}, bank=bank, device="cpu")
    task.build_state(0)
    assert task.bank["keys"].dtype == torch.bfloat16 and task.bank["key_map"].dtype == torch.int32
    metrics = task.train_step(task.to_device(T._batch(1)), torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    off = DictTTSTask({**T.CFG, "amp": True, "amp_bf16_activations": False}, bank=bank, device="cpu")
    assert off.act_dtype is None and off.bank["keys"].dtype == torch.float32


class _Dtypes(TorchDispatchMode):
    """Records the dtype of every tensor every op returns."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.seen.update(t.dtype for t in tree_leaves(out) if isinstance(t, torch.Tensor))
        return out


@pytest.mark.parametrize("amp", [False, True])
def test_no_op_runs_in_reduced_precision_with_amp_off(setup, amp):
    """With amp off no op of a train step (forward, backward, both
    optimizers) returns a bf16 or f16 tensor, as the JAX package's traced
    f32 step holds no bf16; with amp on, ops do."""
    task = _port_task(setup, amp)
    batch = task.to_device(setup["batch"])
    with _Dtypes() as mode:
        metrics = task.train_step(batch, torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert bool(mode.seen & {torch.bfloat16, torch.float16}) == amp, mode.seen


def test_k3_under_amp_matches_the_jax_kernel():
    """K3's wrapper with a bf16 q and f32 k, v (what the JAX inference under
    amp hands its kernel): outputs in bf16, the f32 call rounded, within one
    bf16 rounding of the JAX kernel's f32 outputs (interpret mode) rounded
    to bf16. The JAX kernel itself cannot take that call: it writes f32
    values into bf16 outputs, which Pallas refuses (ROADMAP Queue 3)."""
    rng = np.random.RandomState(8)
    B, Tw, L, H, P = 2, 5, 7, 8, 4
    q = rng.randn(B, Tw, H).astype(np.float32)
    k = rng.randn(B, Tw, L, H).astype(np.float32)
    v = rng.randn(B, Tw, L, H).astype(np.float32)
    km = rng.randint(0, 3, (B, Tw, L)).astype(np.int32)
    km[0, 1] = 0  # an all-masked row
    pm = np.tile(np.array([1, 1, 2, 0], np.int32), (B, Tw, 1))
    qb = torch.tensor(q).to(torch.bfloat16)
    maps = (torch.tensor(km), torch.tensor(pm))
    got = s2pa_fused(qb, torch.tensor(k), torch.tensor(v), *maps)
    f32 = s2pa_fused(qb.float(), torch.tensor(k), torch.tensor(v), *maps)
    jq = jnp.asarray(qb.float().numpy())
    want = j_s2pa_fused(jq, jnp.asarray(k), jnp.asarray(v), jnp.asarray(km), jnp.asarray(pm),
                        interpret=True)
    for name, g, w, f in zip(("ctx", "w", "pron"), got, want, f32):
        assert g.dtype == torch.bfloat16, name
        torch.testing.assert_close(g, f.to(torch.bfloat16), rtol=0, atol=0, msg=name)
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.bfloat16), np.float32),
                                   rtol=2 ** -7, atol=1e-6, err_msg=name)
    with pytest.raises(ValueError, match="dtype"):
        j_s2pa_fused(jq.astype(jnp.bfloat16), jnp.asarray(k), jnp.asarray(v), jnp.asarray(km),
                     jnp.asarray(pm), interpret=True)
