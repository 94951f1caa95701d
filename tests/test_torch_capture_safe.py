"""Every task's train step is what a CUDA graph can capture, checked on the
CPU at small widths: after a warm-up step, steps run under a dispatch mode
that raises on every op that reads a device value on the host
(``_local_scalar_dense`` behind ``.item()``, ``bool()``, ``float()``;
``nonzero``, ``masked_select``, ``equal``, ``is_nonzero``; indexing by a
bool mask; ``repeat_interleave`` without its output size; ``unique``,
``bincount``) or brings host data into the step (``lift_fresh``: a tensor
built from Python or numpy values, a host-to-device copy on the card).

Covered: PortaSpeech with the discriminator across both gates; the
two-stage PortaSpeech flow across its switch, with and without gradient
accumulation; FastSpeech2's recipe and every entry of its encoder and
decoder registries; HiFi-GAN across the discriminators' start, with
feature matching and the STFT loss; Dict-TTS with accumulation and a NaN
micro-step. For each, no optimizer or accumulation buffer is allocated
after the warm-up (the data pointers of every moment, count, lr and
running mean are the same after the second step and after the last), the
task declares its step capture-safe, and its ``step_key`` /
``step_key_live`` follow the step index.
"""

import os
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_fs2_task as F  # noqa: E402
import test_torch_hifigan_train as H  # noqa: E402
import test_torch_ps_task as P  # noqa: E402
import test_torch_train_task as T  # noqa: E402

from dicttts_tpu_torch.models.fastspeech2 import FS_DECODERS, FS_ENCODERS  # noqa: E402
from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask  # noqa: E402
from dicttts_tpu_torch.train.tasks.fs2 import FastSpeech2Task  # noqa: E402
from dicttts_tpu_torch.train.tasks.hifigan import HifiGanTask  # noqa: E402
from dicttts_tpu_torch.train.tasks.ps_adv import PortaSpeechAdvTask  # noqa: E402
from dicttts_tpu_torch.train.tasks.ps_flow import PortaSpeechFlowTask  # noqa: E402

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

A = torch.ops.aten
HOST_READS = {A._local_scalar_dense.default, A.nonzero.default, A.masked_select.default, A.equal.default,
              A.is_nonzero.default, A._unique2.default, A.unique_consecutive.default, A.unique_dim.default,
              A.bincount.default, A.lift_fresh.default}
INDEXING = {A.index.Tensor, A.index_put.default, A.index_put_.default, A._index_put_impl_.default}


class NoHostReads(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        bad = func in HOST_READS
        if func in INDEXING:
            bad = any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in args[1] if i is not None)
        if func is A.repeat_interleave.Tensor:
            bad = kwargs.get("output_size") is None
        if bad:
            raise AssertionError(f"{func} reads the card on the host or copies host data into the step")
        return func(*args, **kwargs)


def _buffers(task) -> set:
    """The data pointers of every optimizer's state (moments, counts, lr)
    and every accumulator's mean and count."""
    ptrs = set()
    for opt in (v for v in vars(task).values() if isinstance(v, torch.optim.Optimizer)):
        ptrs |= {t.data_ptr() for st in opt.state.values() for t in st.values() if isinstance(t, torch.Tensor)}
        ptrs |= {g["lr"].data_ptr() for g in opt.param_groups}
    for acc in getattr(task, "acc", {}).values():
        ptrs |= {acc.mean.data_ptr(), acc.n.data_ptr()}
    return ptrs


def _run(task, batches, keys) -> list:
    """A warm-up step, then the rest under ``NoHostReads``; each step's
    ``step_key`` against ``keys(step)``. Returns the metrics."""
    task.build_state(0)
    assert task.capture_safe and task.capture_reason == ""
    out, ptrs = [], None
    for i, batch in enumerate(batches):
        assert task.step == i and tuple(task.step_key()) == keys(i), (i, task.step_key())
        device_batch = task.to_device(batch)
        if i == 0:
            out.append(task.train_step(device_batch, torch.Generator().manual_seed(i)))
        else:
            with NoHostReads():
                out.append(task.train_step(device_batch, torch.Generator().manual_seed(i)))
        if i == 1:
            ptrs = _buffers(task)
    assert ptrs and _buffers(task) == ptrs  # nothing allocated after the warm-up
    return out


def _live(task, key) -> bool:
    return task.step_key_live(key) if hasattr(task, "step_key_live") else True


@pytest.mark.parametrize("accumulate", [1, 2])
def test_portaspeech_adv_across_both_gates(accumulate):
    cfg = dict(P.CFG, dropout=0.1, disc_start_steps=2, disc_interval=1, accumulate_grad_batches=accumulate)
    task = PortaSpeechAdvTask(cfg, device="cpu")
    _run(task, [P.batch(s) for s in range(4)], lambda i: (i >= 2, i >= 2))
    assert not _live(task, (False, False)) and _live(task, (True, True))
    assert task.updates_d == 2 // accumulate


@pytest.mark.parametrize("accumulate", [1, 2])
def test_portaspeech_flow_two_stages(accumulate):
    cfg = dict(P.FLOW, post_glow_training_start=2, accumulate_grad_batches=accumulate)
    task = PortaSpeechFlowTask(cfg, device="cpu")
    assert task.step_key_names == ("post_on",)
    metrics = _run(task, [P.batch(s) for s in range(4)], lambda i: (i >= 2,))
    assert [float(m["post_stage"]) for m in metrics] == [0.0, 0.0, 1.0, 1.0]
    assert not _live(task, (False,)) and _live(task, (True,))
    assert (task.updates_g, task.updates_pf) == (2 // accumulate, 2 // accumulate)


def test_portaspeech_flow_joint_mode():
    task = PortaSpeechFlowTask(dict(P.FLOW, two_stage=False), device="cpu")
    _run(task, [P.batch(s) for s in range(3)], lambda i: (False, False))


FS2_ENTRIES = [("recipe", {})] + [(f"encoder {e}", {"encoder_type": e}) for e in FS_ENCODERS] + [
    (f"decoder {d}", {"decoder_type": d}) for d in FS_DECODERS]


@pytest.mark.parametrize("name,entry", FS2_ENTRIES, ids=[n for n, _ in FS2_ENTRIES])
def test_fastspeech2_recipe_and_registry(name, entry):
    cfg = dict(F.CFG, dropout=0.1, predictor_dropout=0.5, **entry)
    task = FastSpeech2Task(cfg, device="cpu")
    assert task.step_key_names == ()
    _run(task, [F.batch(s) for s in range(3)], lambda i: ())
    assert task.opt.updates() == 3


def test_hifigan_across_the_discriminators_start():
    cfg = dict(H.CFG, disc_start_steps=2, use_fm_loss=True, use_ms_stft=True)
    task = HifiGanTask(cfg, device="cpu")
    metrics = _run(task, [H._batch(s) for s in range(4)], lambda i: (i >= 2,))
    assert ["grad_norm_d" in m for m in metrics] == [False, False, True, True]
    assert (task.updates_g, task.updates_d) == (4, 2)
    assert not _live(task, (False,)) and _live(task, (True,))


def test_dict_tts_accumulation_with_a_nan_micro_step():
    """The discriminator starts after the NaN micro-step: its own update has
    no NaN guard (nor has the JAX task's), and a NaN folded into its mean
    would reach every later loss."""
    batches = [T._batch(s) for s in range(5)]
    batches[2]["mels"][0, 3, 5] = np.nan
    cfg = dict(T.CFG, dropout=0.1, accumulate_grad_batches=2, disc_start_steps=3)
    task = DictTTSTask(cfg, bank=T._bank(0), device="cpu")
    metrics = _run(task, batches, lambda i: (i >= 3, i >= 3))
    assert [bool(torch.isfinite(m["total_loss"])) for m in metrics] == [True, True, False, True, True]
    # micro-steps 1, 2, 4, 5 count: the generator updates at 2 and 5, the discriminator at 5
    assert (task.updates_g, int(task.acc["g"].n)) == (2, 0)
    assert (task.updates_d, int(task.acc["d"].n)) == (1, 0)


def test_the_mode_catches_a_host_read():
    with pytest.raises(AssertionError, match="reads the card"), NoHostReads():
        bool(torch.ones(()) > 0)
    mask = torch.tensor([True, False, True])
    with pytest.raises(AssertionError, match="reads the card"), NoHostReads():
        torch.ones(3)[mask]
