"""Data-parallel training of the port (``parallel/mesh.py``) on the CPU:
two gloo ranks, spawned once for the file (``tests/torch_ddp_workers.py``),
against one process on the whole batch, and against the JAX task on a
2-device mesh.

Every batch's halves (rank 0's rows, rank 1's rows) differ in frames and
in words or phones, so a loss normalized by a shard's own count would
differ from the global batch's. Dropout is 0, and the posterior noise and
the crop starts are pinned (each rank gets its rows of the noise).

Tolerances: losses, gradient norms and metrics rtol 1e-5 / atol 1e-6 (the
sums run in another order); parameters atol 1e-6 plus, per element, what
a gradient difference at the gradient tolerance can move one Adam step
(``torch_ddp_workers.adam_atol``, as tests/test_torch_accumulate.py),
summed over the updates taken;
against JAX, tests/test_torch_train_task.py's: losses rtol 1e-5 / atol
1e-6, gradients rtol 1e-3 / atol 1e-6 of the largest of their set; only
the conv biases before the discriminator's instance norms
(``INSTANCE_NORMED_BIAS``, ROADMAP Queue 3) add the one-process port's
own distance from JAX. The two ranks' gradients are also held to the one
process's at the gradient tolerance, and their parameters are equal bit
for bit.
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_ddp_workers as W  # noqa: E402

from dicttts_tpu.models import discriminator as jdisc  # noqa: E402
from dicttts_tpu.parallel.mesh import make_mesh, replicate_state  # noqa: E402
from dicttts_tpu.parallel.mesh import shard_batch as jax_shard_batch  # noqa: E402
from dicttts_tpu.train.tasks.dict_tts import DictTTSTask as JTask  # noqa: E402
from dicttts_tpu_torch.convert import jax_params_to_state, load_jax_params  # noqa: E402
from dicttts_tpu_torch.parallel import mesh  # noqa: E402

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

JAX_KEYS = ("word_size", "hidden_size", "num_heads", "enc_ffn_kernel_size", "dropout",
            "predictor_dropout", "value_embedding_size", "dict_embed_dim", "dur_predictor_layers",
            "dur_predictor_kernel", "latent_size", "fvae_enc_dec_hidden", "fvae_kernel_size",
            "fvae_enc_n_layers", "fvae_dec_n_layers", "prior_glow_hidden", "glow_kernel_size",
            "prior_glow_n_blocks", "mel_disc_hidden_size")
DICT_BATCHES = [W.dict_batch(1), W.dict_batch(2)]
DICT_NOISE = [W.dict_eps(4), W.dict_eps(5)]
FS2_BATCH = W.fs2_batch(1)
HIFI_BATCH = W.hifigan_batch(1)
PS_BATCH = W.ps_batch(1)
PS_NOISE = np.random.RandomState(6).randn(4, W.TPS // 4, 4).astype(np.float32)
INSTANCE_NORMED_BIAS = re.compile(r"discs\.win_\d+\.conv_[12]\.bias")


def _nan_batch():
    batch = W.dict_batch(7)
    batch["mels"][3, 5, 7] = np.nan  # a row of rank 1
    return batch


class _NoDropoutBlock(jdisc.Disc2DBlockStack):
    dropout: float = 0.0


@pytest.fixture(scope="module")
def jax_params():
    jt = JTask({k: W.DICT_CFG[k] for k in JAX_KEYS}, None)
    shapes = jax.eval_shape(lambda r: {k: v for k, v in jt.build_state(r).items() if k.startswith("params")},
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(2)
    rand = lambda tree, scale: jax.tree.map(  # noqa: E731
        lambda s: (rng.randn(*s.shape) * scale).astype(np.float32), tree)
    return jt, rand(shapes["params_g"], 0.2), rand(shapes["params_d"], 0.05)


@pytest.fixture(scope="module")
def state(jax_params):
    _, params_g, params_d = jax_params
    task = W.dict_task()
    load_jax_params(task.model, params_g)
    load_jax_params(task.disc, params_d)
    return W.state_of(task)


@pytest.fixture(scope="module")
def ranks(state, tmp_path_factory):
    """Every scenario on two ranks, in one spawn."""
    scenarios = [
        ("dict_steps", W.dict_tts_steps, dict(state=state, batches=DICT_BATCHES, noise=DICT_NOISE)),
        ("dict_grads", W.dict_tts_grads, dict(state=state, batch=DICT_BATCHES[0], eps=DICT_NOISE[0])),
        ("fs2", W.fs2_step, dict(batch=FS2_BATCH)),
        ("hifigan", W.hifigan_step, dict(batch=HIFI_BATCH)),
        ("ps_flow", W.ps_flow_step, dict(batch=PS_BATCH, eps=PS_NOISE)),
        ("nan", W.nan_step, dict(state=state, batch=_nan_batch(), eps=DICT_NOISE[0])),
    ]
    results = W.spawn(tmp_path_factory.mktemp("ddp"), W.run_scenarios, scenarios)
    for name, *_ in scenarios:
        for r, res in enumerate(results):
            assert name in res, f"rank {r} did not reach {name}"
            assert "error" not in res[name], f"rank {r}, {name}:\n{res[name]['error']}"
    return results


def _close(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=f"{what} {k}")


def _assert_params(got: dict, ref: dict, atol: dict) -> None:
    """``got`` (a rank's parameters) against the one-process ``ref``."""
    for key, want in ref.items():
        err = (got[key] - want).abs().numpy()
        assert (err <= atol[key]).all(), (key, float(err.max()))


def _ranks_agree(ranks, name) -> None:
    a, b = ranks[0][name]["params"], ranks[1][name]["params"]
    for k in a:
        assert torch.equal(a[k], b[k]), (name, k)


def test_dict_tts_steps_match_one_process(ranks, state):
    ref = W.dict_tts_steps(state, DICT_BATCHES, DICT_NOISE, keep_task=True)
    for r in ranks:
        got = r["dict_steps"]
        assert got["updates"] == ref["updates"] == (2, 2, 2)
        for i in range(2):
            _close(got["metrics"][i], ref["metrics"][i], f"step {i}")
        _assert_params(got["params"], ref["params"], ref["atol"])
    _ranks_agree(ranks, "dict_steps")
    # the parameters moved: a rank whose gradients were not reduced would differ
    moved = max(float((ref["params"][k] - v).abs().max()) for k, v in
                W.params(W.dict_task(state).model, W.dict_task(state).disc).items())
    assert moved > 1e-4


def test_dict_tts_step_matches_the_jax_step_on_a_2_device_mesh(ranks, state, jax_params, monkeypatch):
    jt, params_g, params_d = jax_params
    batch, eps = DICT_BATCHES[0], DICT_NOISE[0]
    bank = W.dict_bank()
    wt = batch["word_tokens"]
    jbatch = {k: np.asarray(v) for k, v in batch.items()}
    jbatch.update(keys=bank["keys"][wt], values=bank["keys"][wt],
                  **{k: bank[k][wt] for k in ("key_map", "pinyin", "pinyin_map")})
    dev_mesh = make_mesh(2)
    jbatch = jax_shard_batch(jbatch, dev_mesh)
    pg, pd = replicate_state(params_g, dev_mesh), replicate_state(params_d, dev_mesh)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(eps, dtype))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(W.U))
    monkeypatch.setattr(jdisc, "Disc2DBlockStack", _NoDropoutBlock)
    key = jax.random.PRNGKey(5)
    (loss_g, (g_losses, out)), grads_g = jax.jit(
        jax.value_and_grad(lambda a, b, bt, k: jt._gen_losses(a, b, bt, k, True, 1.0), has_aux=True))(
        pg, pd, jbatch, key)
    (loss_d, d_losses), grads_d = jax.jit(jax.value_and_grad(jt._disc_losses, has_aux=True))(
        pd, out["mel_out"], jbatch["mels"], jbatch["mel_lengths"], key)
    assert len(jbatch["mels"].sharding.device_set) == 2
    one = W.dict_tts_grads(state, batch, eps)  # the port in one process
    task = W.dict_task()
    for r in ranks:
        got = r["dict_grads"]
        want = {**{k: float(v) for k, v in {**g_losses, **d_losses}.items()}, "total": float(loss_g),
                "disc": float(loss_d)}
        assert set(got["losses"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got["losses"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
        for module, jg, which in ((task.model, grads_g, "grads_g"), (task.disc, grads_d, "grads_d")):
            ref = jax_params_to_state(module, jax.device_get(jg))
            assert set(ref) == set(got[which])
            top = max(np.abs(np.asarray(g)).max() for g in ref.values())
            for n, g in ref.items():
                g, tg, og = np.asarray(g), got[which][n].numpy(), one[which][n].numpy()
                np.testing.assert_allclose(tg, og, rtol=1e-3, atol=1e-6 * top, err_msg=f"one process {n}")
                bound = 1e-3 * np.abs(g) + 1e-6 * top
                if INSTANCE_NORMED_BIAS.fullmatch(n):
                    # a conv bias before an instance norm: the norm all but cancels its gradient,
                    # and the packages differ on it (ROADMAP Queue 3), so only here the bound
                    # is widened by the one-process port's own distance from JAX
                    print(f"{n}: one process vs JAX {float(np.abs(og - g).max()):.3e}")
                    bound = bound + np.abs(og - g)
                assert (np.abs(tg - g) <= bound).all(), (n, float(np.abs(tg - g).max()))


@pytest.mark.parametrize("name", ["fs2", "hifigan", "ps_flow"])
def test_other_tasks_step_matches_one_process(ranks, name):
    if name == "fs2":
        ref = W.fs2_step(FS2_BATCH, keep_task=True)
        modules = (ref["task"].model,)
    elif name == "hifigan":
        ref = W.hifigan_step(HIFI_BATCH, keep_task=True)
        modules = (ref["task"].model, ref["task"].disc)
        assert {"sc", "mag", "fm", "grad_norm_d"} <= set(ref["metrics"])
    else:
        ref = W.ps_flow_step(PS_BATCH, PS_NOISE, keep_task=True)
        modules = (ref["task"].model,)
        assert ref["metrics"]["post_stage"] == 1.0 and ref["updates"] == (1, 0, 1)
    atol = W.update_atol(ref["task"], modules)
    for r in ranks:
        _close(r[name]["metrics"], ref["metrics"], name)
        _assert_params(r[name]["params"], ref["params"], atol)
    _ranks_agree(ranks, name)


def test_a_non_finite_loss_on_one_rank_skips_the_update_on_both(ranks):
    for r in ranks:
        got = r["nan"]
        assert not np.isfinite(got["metrics"]["total_loss"])
        # the skip is decided on the card: the step reports the norm it did not apply
        assert not np.isfinite(got["metrics"]["grad_norm_g"]) and got["updates"] == (1, 0, 0)
        for k, v in got["before"].items():
            assert torch.equal(v, got["after"][k]), k
        assert got["updates_next"] == (2, 1, 0)  # the next step ran on both ranks


def test_shard_and_pad_are_the_identity_without_a_group():
    batch = W.dict_batch(1)
    assert mesh.world_size() == 1 and mesh.rank() == 0 and mesh.is_chief()
    assert mesh.shard_batch(batch) is batch
    assert mesh.pad_batch_to_devices(batch, 1)["mels"] is batch["mels"]
    g = [torch.ones(3)]
    assert mesh.reduce_metrics({"a": g[0]})["a"] is g[0]
    assert torch.equal(mesh.shard_denominator(torch.tensor(0.0)), torch.tensor(1.0))
