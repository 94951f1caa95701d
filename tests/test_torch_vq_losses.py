"""Port parity of the EMA vector quantizer (dicttts_tpu_torch.models.vq),
the probabilistic losses (train/prob_losses.py) and the attention
diagnostics (eval/attention.py) against the JAX package's, on the CPU.

- VQ: from the JAX module's initial statistics, three training calls: the
  assignments equal, the codes, the commitment loss and the perplexity
  within 1e-6, and the codebook and both moving averages after each
  update within 1e-6 (one rounding of a few f32 sums apart); the
  straight-through gradient of a loss on the codes and the commitment
  against ``jax.grad``, 1e-6; eval mode leaves the statistics alone;
- the mixture-of-logistics NLL (with targets at both edges and on the
  tails, where the pdf branch applies), the Gaussian NLL and the Laplace
  sharpness, rtol 1e-5; the mixture's gradient rtol 1e-4 / atol 1e-4 of
  its largest element (the branches' where-selects pass gradients of
  ~1e-7 that round apart); the sampler by its range and by the component
  it picks;
- focus rate, phone coverage and diagonal focus rate exactly (the same
  numpy on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dicttts_tpu.eval import attention as jatt
from dicttts_tpu.models.vq import VQEmbeddingEMA as JVQ
from dicttts_tpu.train import prob_losses as jpl
from dicttts_tpu_torch.eval import attention as tatt
from dicttts_tpu_torch.models.vq import VQEmbeddingEMA
from dicttts_tpu_torch.train import prob_losses as tpl

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

N, D = 16, 8


def test_vq_assignments_ema_updates_and_straight_through_match_jax():
    rng = np.random.RandomState(0)
    xs = [(rng.randn(3, 20, D) * 0.2).astype(np.float32) for _ in range(3)]
    jm = JVQ(N, D, decay=0.9)
    stats = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))["vq_stats"])
    tm = VQEmbeddingEMA(N, D, decay=0.9)
    for name in ("embedding", "ema_count", "ema_weight"):
        getattr(tm, name).copy_(torch.tensor(np.asarray(stats[name])))
    step = jax.jit(lambda st, x: jm.apply({"vq_stats": st}, x, train=True, mutable=["vq_stats"]))
    tm.train()
    for x in xs:
        (q, idx, aux), new = step(stats, jnp.asarray(x))
        stats = jax.device_get(new["vq_stats"])
        tq, tidx, taux = tm(torch.tensor(x))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
        np.testing.assert_allclose(tq.numpy(), np.asarray(q), atol=1e-6)
        for k in ("commitment", "perplexity"):
            np.testing.assert_allclose(float(taux[k]), float(aux[k]), rtol=1e-6, atol=1e-7, err_msg=k)
        for name in ("embedding", "ema_count", "ema_weight"):
            np.testing.assert_allclose(getattr(tm, name).numpy(), np.asarray(stats[name]), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
    assert len(np.unique(np.asarray(idx))) > 3
    w = rng.randn(3, 20, D).astype(np.float32)

    def jloss(x):
        q, _, aux = jm.apply({"vq_stats": stats}, x)
        return jnp.sum(q * w) + 3.0 * aux["commitment"]

    want = jax.grad(jloss)(jnp.asarray(xs[0]))
    tm.eval()
    before = {n: b.clone() for n, b in tm.named_buffers()}
    x = torch.tensor(xs[0], requires_grad=True)
    q, _, aux = tm(x)
    (torch.sum(q * torch.tensor(w)) + 3.0 * aux["commitment"]).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), atol=1e-6)
    assert all(torch.equal(before[n], b) for n, b in tm.named_buffers())  # eval: no update
    assert {n for n, _ in tm.named_buffers()} == {"embedding", "ema_count", "ema_weight"}
    assert not list(tm.parameters())


def _mixture_case(seed, n_mix=4):
    rng = np.random.RandomState(seed)
    y_hat = rng.randn(2, 30, 3 * n_mix).astype(np.float32)
    y_hat[..., 2 * n_mix:] = rng.uniform(-9, 1, (2, 30, n_mix))  # log scales, some below the floor
    y = rng.uniform(-1, 1, (2, 30, 1)).astype(np.float32)
    y[0, :3], y[1, :3] = -1.0, 1.0  # the edge branches
    y_hat[0, 3:6, n_mix:2 * n_mix] = y[0, 3:6] + 3.0  # far from every mean: the pdf branch
    y_hat[0, 3:6, 2 * n_mix:] = -8.0
    return y_hat, y


def test_mixture_gaussian_and_laplace_losses_match_jax():
    for seed in (1, 2):
        y_hat, y = _mixture_case(seed)
        want, want_g = jax.value_and_grad(jpl.discretized_mix_logistic_loss)(jnp.asarray(y_hat), jnp.asarray(y))
        t = torch.tensor(y_hat, requires_grad=True)
        got = tpl.discretized_mix_logistic_loss(t, torch.tensor(y))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
        top = np.abs(np.asarray(want_g)).max()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-4 * top)
    rng = np.random.RandomState(3)
    mean, log_std, target = (rng.randn(4, 10, 6).astype(np.float32) for _ in range(3))
    np.testing.assert_allclose(float(tpl.gaussian_nll(*map(torch.tensor, (mean, log_std, target)))),
                               float(jpl.gaussian_nll(*map(jnp.asarray, (mean, log_std, target)))), rtol=1e-5)
    mel = rng.randn(2, 20, 16).astype(np.float32)
    np.testing.assert_allclose(float(tpl.laplace_sharpness(torch.tensor(mel))),
                               float(jpl.laplace_sharpness(jnp.asarray(mel))), rtol=1e-5)


def test_mixture_sampler_range_and_component():
    n_mix = 3
    y_hat = np.zeros((4, 500, 3 * n_mix), np.float32)
    y_hat[..., :n_mix] = [-20.0, 20.0, -20.0]  # component 1 almost surely
    y_hat[..., n_mix:2 * n_mix] = [-0.9, 0.3, 0.9]
    y_hat[..., 2 * n_mix:] = -7.0  # scale e^-7
    s = tpl.sample_from_mix_logistic(torch.tensor(y_hat), torch.Generator().manual_seed(0))
    assert s.shape == (4, 500) and (s.abs() <= 1).all()
    assert float((s - 0.3).abs().max()) < 0.02 and float(s.std()) > 0
    j = np.asarray(jpl.sample_from_mix_logistic(jnp.asarray(y_hat), jax.random.PRNGKey(0)))
    assert abs(float(s.mean()) - j.mean()) < 1e-3
    y_hat[..., 2 * n_mix:] = 3.0  # wide: clipped to [-1, 1]
    s = tpl.sample_from_mix_logistic(torch.tensor(y_hat), torch.Generator().manual_seed(1))
    assert float(s.max()) == 1.0 and float(s.min()) == -1.0


def test_attention_diagnostics_match_jax_exactly():
    rng = np.random.RandomState(4)
    for T_out, T_in in ((30, 12), (1, 5), (12, 1)):
        attn = rng.rand(T_out, T_in).astype(np.float32)
        attn /= attn.sum(-1, keepdims=True)
        out_mask, in_mask = rng.rand(T_out) < 0.7, rng.rand(T_in) < 0.8
        assert tatt.focus_rate(attn, out_mask) == jatt.focus_rate(attn, out_mask)
        assert tatt.phone_coverage_rate(attn, in_mask, 0.2) == jatt.phone_coverage_rate(attn, in_mask, 0.2)
        assert tatt.diagonal_focus_rate(attn, 0.1) == jatt.diagonal_focus_rate(attn, 0.1)
        lens = (max(T_in - 1, 1), max(T_out - 2, 1))
        assert tatt.attention_metrics(attn, *lens) == jatt.attention_metrics(attn, *lens)
        assert tatt.attention_metrics(attn) == jatt.attention_metrics(attn)
    assert tatt.focus_rate(np.zeros((3, 2)), np.zeros(3)) == 0.0
    assert tatt.diagonal_focus_rate(np.zeros((3, 2))) == jatt.diagonal_focus_rate(np.zeros((3, 2))) == 0.0
