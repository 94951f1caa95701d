"""Port parity: HiFi-GAN generator and spec2wav of dicttts_tpu_torch against
dicttts_tpu.models.hifigan / vocoders.hifigan (which runs its lane-folded
TPU layout; the math is the same).

The generator tests run the JAX model with ``fold_lanes=False`` (the
unfolded math, quick to trace on the CPU); the spec2wav test runs the JAX
vocoder as it ships, lane folding on. Seeded random parameters, numpy mels. Tolerance atol 1e-4 on the tanh
output: f32 on the CPU, only summation orders differ, through ~40
convolutions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dicttts_tpu.models.hifigan import HifiGanGenerator as JGen
from dicttts_tpu.utils.torch_convert import convert_hifigan_generator
from dicttts_tpu.vocoders.hifigan import HifiGanVocoder
from dicttts_tpu_torch.convert import load_jax_params
from dicttts_tpu_torch.models.hifigan import HifiGanGenerator
from dicttts_tpu_torch.vocoders.hifigan import spec2wav

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

CFG = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=16,
           resblock_kernel_sizes=(3, 7, 11))


def _params(cfg, seed):
    """Seeded random values in the shapes of a flax init (traced, not run)."""
    shapes = jax.eval_shape(JGen(fold_lanes=False, **cfg).init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 80)))
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda s: (rng.randn(*s.shape) * 0.2).astype(np.float32), shapes["params"])


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_generator(resblock):
    jm = JGen(resblock=resblock, fold_lanes=False, **CFG)
    p = _params(dict(CFG, resblock=resblock), 0)
    mel = np.random.RandomState(1).randn(2, 20, 80).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)({"params": p}, jnp.asarray(mel)))
    tm = load_jax_params(HifiGanGenerator(resblock=resblock, **CFG), p)
    with torch.no_grad():
        out = tm(torch.tensor(mel)).numpy()
    assert out.shape == (2, 20 * 16)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_generator_state_names_round_trip():
    p = _params(CFG, 2)
    tm = load_jax_params(HifiGanGenerator(**CFG), p)
    back = convert_hifigan_generator({k: v.numpy() for k, v in tm.state_dict().items()},
                                     upsample_rates=CFG["upsample_rates"])
    flat_a = jax.tree_util.tree_flatten_with_path(p)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))


def test_spec2wav_pads_at_silence_floor():
    cfg = dict(CFG, upsample_initial_channel=128)  # stages of 64 and 32 channels fold 2x and 4x
    p = _params(cfg, 3)
    voc = HifiGanVocoder(dict(hop_size=16, **cfg), params=p)
    mel = np.random.RandomState(4).randn(2, 37, 80).astype(np.float32)  # 37 -> bucket 64
    ref = voc.spec2wav(mel)
    tm = load_jax_params(HifiGanGenerator(**cfg), p)
    out = spec2wav(tm, torch.tensor(mel)).numpy()
    assert out.shape == (2, 37 * 16)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    np.testing.assert_allclose(spec2wav(tm, torch.tensor(mel[0])).numpy(), ref[0], atol=1e-4)
