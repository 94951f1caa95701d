"""PortaSpeech under amp (bf16 autocast, ``dicttts_tpu_torch/ops/amp.py``)
against the JAX flow task under amp, with the post-net Glow.

The JAX package's amp and autocast round different tensors to bf16 (its
modules their activations, autocast each matmul's and conv's inputs). On
one input the two amp runs then differ by an amount of the order of either
package's own amp-vs-f32 gap, in either direction: over the six seeded
inputs here, |port_amp - jax_amp| / (the JAX gap on that input) is
0.53-5.9 (the generator losses' largest; most of it the KL, from the FVAE
posterior's WN). So the port is held over all six inputs, each input's
weights, batch and noise seeded apart, with the JAX package's gap measured
here on the same inputs:

- the port's own amp-vs-f32 gap (the largest over KL, SSIM, L1, word
  duration and the Glow's NLL), averaged over the inputs, <= 2 x the JAX
  package's averaged the same way (measured: 0.86e-3 against 0.61e-3);
- on every input the port's gap <= 6 x the JAX package's gap on that
  input (measured: 0.47-4.86 x);
- on every input |port_amp - jax_amp| <= 2 x the largest JAX gap over the
  inputs (measured: at most 0.97e-3 against 3.09e-3).

The Glow is an f32 island in both packages: every convolution and matmul
inside it runs in f32 here while the phone encoder's run in bf16. One amp
train step in each stage keeps the
parameters and the optimizer states f32. The JAX side runs under
``jax.jit``, compiled once for f32 and once for amp.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_ps_task as P  # noqa: E402

from dicttts_tpu.train.tasks.ps_flow import PortaSpeechFlowTask as JFlow  # noqa: E402
from dicttts_tpu_torch.train.tasks.ps_flow import PortaSpeechFlowTask  # noqa: E402

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

KEYS = ("kl", "ssim", "l1", "wdur", "postflow")
SEEDS = range(2, 8)


def _inputs(seed):
    params_g, params_d = P.jax_state(JFlow(dict(P.FLOW), None), seed)
    return params_g, params_d, P.batch(seed - 1), P.eps(seed + 2)


def _jax_fn(cfg, cur):
    """The JAX task's generator losses, jitted once; the pinned posterior
    noise is an argument of the traced function."""
    jt = JFlow(dict(cfg), None)

    def losses(pg, pd, jb, noise):
        cur["noise"] = noise
        with jt._amp_scope():
            _, (out, _) = jt._gen_losses(pg, pd, jb, jax.random.PRNGKey(5), True, 1.0)
        return jnp.stack([out[k] for k in KEYS])

    return jax.jit(losses)


def _port_losses(task, b, noise):
    task.model.train()
    _, losses, _ = task._gen_losses(task.to_device(b), None, True, 1.0, torch.tensor(noise))
    return np.array([float(losses[k].detach()) for k in KEYS])


def test_amp_losses_within_the_jax_gap_and_the_glow_stays_f32(monkeypatch):
    cur = {"noise": jnp.zeros(0)}
    normal = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: (
        cur["noise"].astype(dtype) if tuple(shape) == cur["noise"].shape else normal(key, shape, dtype)))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(P.U))
    monkeypatch.setattr(P.jdisc, "Disc2DBlockStack", P._NoDropoutBlock)
    j_f32, j_amp = _jax_fn(P.FLOW, cur), _jax_fn(dict(P.FLOW, amp=True), cur)
    jax_gap, port_gap, cross = [], [], []
    for seed in SEEDS:
        pg, pd, b, noise = _inputs(seed)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        jf, ja = (np.asarray(f(pg, pd, jb, jnp.asarray(noise))) for f in (j_f32, j_amp))
        pf = _port_losses(P.ported(PortaSpeechFlowTask, P.FLOW, pg, pd), b, noise)
        pa = _port_losses(P.ported(PortaSpeechFlowTask, dict(P.FLOW, amp=True), pg, pd), b, noise)
        np.testing.assert_allclose(pf, jf, rtol=1e-5, atol=1e-6)  # f32: the task test's tolerance
        jax_gap.append(np.abs(ja - jf).max())
        port_gap.append(np.abs(pa - pf).max())
        cross.append(np.abs(pa - ja).max())
    assert min(jax_gap) > 0
    assert np.mean(port_gap) <= 2 * np.mean(jax_gap), (port_gap, jax_gap)
    assert max(cross) <= 2 * max(jax_gap), (cross, jax_gap)
    ratio = np.array(port_gap) / np.array(jax_gap)
    assert ratio.max() <= 6, (port_gap, jax_gap)  # per input: one bad input fails alone


def test_amp_keeps_the_glow_and_the_training_state_f32():
    pg, pd, b, noise = _inputs(2)
    task = P.ported(PortaSpeechFlowTask, dict(P.FLOW, amp=True), pg, pd)
    dtypes = {}

    def record(name):
        def hook(module, args, out):
            dtypes.setdefault(name, set()).add(out.dtype)
        return hook

    for name, m in task.model.named_modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.Linear)):
            m.register_forward_hook(record(name))
    _port_losses(task, b, noise)
    glow = {n: d for n, d in dtypes.items() if n.startswith("post_flow.")}
    assert glow and all(d == {torch.float32} for d in glow.values()), glow
    assert dtypes["ph_encoder.pre.conv_layers.0"] == {torch.bfloat16}
    assert dtypes["attn_out"] == {torch.float32}  # the word-to-frame attention: f32, as JAX's
    for start in (1, 0):  # a step of stage 1, then one of stage 2
        task = P.ported(PortaSpeechFlowTask, dict(P.FLOW, amp=True, post_glow_training_start=start),
                        pg, pd)
        m = task.train_step(task.to_device(b), None, eps=torch.tensor(noise))
        assert np.isfinite(float(m["total_loss"])) and float(m["post_stage"]) == float(start == 0)
        assert all(p.dtype == torch.float32 for p in task.model.parameters())
        for opt in (task.opt_g, task.opt_pf):
            for st in opt.state.values():
                assert all(v.dtype == torch.float32 for k, v in st.items() if k != "step")
