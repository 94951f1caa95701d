"""Port parity of the offline pipeline (``dicttts_tpu_torch/text/binarizer.py``,
``text/binarize.py``, ``ops/f0.py``, ``ops/cwt.py``, ``text/textgrid.py``,
``text/mfa.py``, ``vocoders/denoise.py``) against the JAX package's, on the
CPU.

Tolerances, with what they rest on:
- f0: voiced frames within rtol 1e-5 of JAX ``autocorr_f0`` (measured
  1.5e-6 on seeded tones and the tracked wavs, 9.1e-7 on the 110-330 Hz
  glides: the two f32 FFTs round differently), the voiced frames the
  same: no frame is set apart as a voicing flip or a pick at another lag
  (none was measured on the CPU; the card-vs-CPU check in chip_smoke
  phase 11a counts them by the extractor's own peak lag and band spread,
  ``ops.f0.autocorr_f0_frames``).
- the subharmonic picks of the extractor are the JAX package's: on
  110-330 Hz harmonic glides both pick half or a third of the seeded f0 on
  the same frames (the window-ACF division lifts the peaks at 2 and 3
  periods; 230 of the 1038 frames of the 6 glides here, 22 %);
- the binarizer's mel against the JAX binarizer's in the linear domain:
  |10^mel - 10^mel_jax| <= 2e-6 x the frame's loudest bin, the rounding
  floor of an f32 FFT relative to the frame's energy (measured 1.0e-6 on
  the tracked wavs; in log10 that is up to 1.6e-2 on bins near the 1e-6
  floor of quiet frames, 1.5e-5 on the toy corpus); f0 as above; the cwt
  arrays exactly the JAX package's cwt of the port's f0 (the per-scale
  z-norm magnifies f0's 1e-6 differences to 4.5e-3); every other field
  (ph, words, word_tokens, mel2ph, mel2word, ph2word, pron_modified, phone
  and the wav) exact, with the JAX dtypes; dict_embed and
  pinyin_encoder.pkl byte for byte;
- cwt, textgrid, the MFA lexicon and inputs, and process_wav (trim,
  denoise, resample): exact.
"""

import csv
import filecmp
import json
import os
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402

from dicttts_tpu.ops import cwt as jcwt  # noqa: E402
from dicttts_tpu.ops.f0 import autocorr_f0 as j_f0  # noqa: E402
from dicttts_tpu.text import binarizer as jbin  # noqa: E402
from dicttts_tpu.text import mfa as jmfa  # noqa: E402
from dicttts_tpu.text import textgrid as jtg  # noqa: E402
from dicttts_tpu_torch.ops import cwt as tcwt  # noqa: E402
from dicttts_tpu_torch.ops.f0 import autocorr_f0 as t_f0  # noqa: E402
from dicttts_tpu_torch.text import binarize as tbinarize  # noqa: E402
from dicttts_tpu_torch.text import binarizer as tbin  # noqa: E402
from dicttts_tpu_torch.text import mfa as tmfa  # noqa: E402
from dicttts_tpu_torch.text import textgrid as ttg  # noqa: E402
from dicttts_tpu_torch.utils.indexed_dataset import IndexedDataset  # noqa: E402
from dicttts_tpu_torch.vocoders.hifigan import load_wav, save_wav  # noqa: E402

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CORPUS = os.path.join(ROOT, ".prod_corpus")
SR = 22050
TOY_DICT = {
    "你": {"nǐ": ["代词。称对方。"]},
    "好": {"hǎo": ["优点多的，使人满意的。"], "hào": ["喜爱。"]},
    "天": {"tiān": ["日，太阳升落一次的时间。"]},
    "气": {"qì": ["没有一定形状的流体。"]},
    "很": {"hěn": ["非常，甚。"]},
}
TOY_TEXTS = {"000001": "你好", "000002": "天气很好", "000003": "你好天气", "000004": "很好，你好"}


def glide(rng, seconds, f_lo, f_hi, noise=0.005):
    """A tone whose f0 moves linearly from f_lo to f_hi, with 2 harmonics
    and white noise; returns (wav, the f0 at each sample)."""
    n = int(SR * seconds)
    f = np.linspace(f_lo, f_hi, n)
    ph = 2 * np.pi * np.cumsum(f) / SR
    wav = 0.3 * np.sin(ph) + 0.1 * np.sin(2 * ph) + 0.05 * np.sin(3 * ph) + noise * rng.randn(n)
    return wav.astype(np.float32), f


def _f0_pair(wav):
    return np.asarray(j_f0(jnp.asarray(wav))), t_f0(torch.tensor(wav)).numpy()


def assert_f0_close(got, want, what=""):
    """The same voiced frames, every one within rtol 1e-5: no voicing flip
    and no pick at another lag is set apart."""
    assert got.shape == want.shape and got.dtype == np.float32, what
    np.testing.assert_array_equal(got > 0, want > 0, err_msg=what)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0, err_msg=what)


@pytest.mark.parametrize("case", ["glide_up", "glide_down", "s0000", "s0001", "s0002"])
def test_f0_matches_jax(case):
    if case.startswith("glide"):
        lo, hi = (110, 155) if case == "glide_up" else (150, 90)
        wav, _ = glide(np.random.RandomState(len(case)), 2.0, lo, hi)
        wav[: SR // 5] = 0.0  # a silent lead: unvoiced frames
    else:
        wav, sr = load_wav(os.path.join(CORPUS, "raw", f"{case}.wav"))
        assert sr == SR
    want, got = _f0_pair(wav)
    assert (want > 0).sum() > 50
    assert_f0_close(got, want, case)
    if case.startswith("glide"):
        assert (got[:15] == 0).all()  # the silent lead


def test_f0_batched_with_n_frames_matches_per_item():
    from dicttts_tpu_torch.ops.f0 import batched_f0

    rng = np.random.RandomState(3)
    wavs = np.stack([glide(rng, 1.0, 100, 140)[0], glide(rng, 1.0, 130, 95)[0]])
    got = batched_f0(torch.tensor(wavs), n_frames=70).numpy()
    assert got.shape == (2, 70)
    for i in range(2):
        assert_f0_close(got[i], np.asarray(j_f0(jnp.asarray(wavs[i]), n_frames=70)), str(i))


def test_subharmonic_picks_are_the_jax_packages():
    rng = np.random.RandomState(11)
    off_total = n_total = 0
    for _ in range(6):
        lo, hi = rng.uniform(110, 330, 2)
        wav, f = glide(rng, 2.0, lo, hi)  # one length: one JAX compile
        want, got = _f0_pair(wav)
        assert_f0_close(got, want, f"{lo:.0f}-{hi:.0f} Hz")  # the band where near-ties between lags occur
        centers = np.minimum(np.arange(len(got)) * 256, len(wav) - 1)
        off_j = (want > 0) & (np.abs(want - f[centers]) / f[centers] > 0.02)
        off_t = (got > 0) & (np.abs(got - f[centers]) / f[centers] > 0.02)
        np.testing.assert_array_equal(off_t, off_j)
        off_total += int(off_t.sum())
        n_total += len(got)
    assert off_total > 0.05 * n_total  # the picks this test is about do occur


def test_cwt_matches_jax_exactly():
    rng = np.random.RandomState(5)
    f0 = np.abs(rng.randn(300)).astype(np.float32) * 50 + 100
    f0[:20] = 0
    f0[140:170] = 0
    f0[-7:] = 0
    got, want = tcwt.f0_cwt(f0), jcwt.f0_cwt(f0)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    norm, _, _ = tcwt.norm_scale(got["cwt_spec"])
    np.testing.assert_array_equal(tcwt.inverse_cwt(norm), jcwt.inverse_cwt(norm))
    np.testing.assert_array_equal(tcwt.convert_continuous_f0(np.zeros(5))[1], np.zeros(5))


TEXTGRID = '''File type = "ooTextFile"
Object class = "TextGrid"
xmin = 0
xmax = 1.2
tiers? <exists>
size = 2
item []:
    item [1]:
        class = "IntervalTier"
        name = "words"
        intervals: size = 1
        intervals [1]:
            xmin = 0
            xmax = 1.2
            text = "x"
    item [2]:
        class = "IntervalTier"
        name = "phones"
        intervals: size = 6
        intervals [1]:
            xmin = 0
            xmax = 0.1
            text = "sil"
        intervals [2]:
            xmin = 0.1
            xmax = 0.3
            text = "n"
        intervals [3]:
            xmin = 0.3
            xmax = 0.55
            text = "i3"
        intervals [4]:
            xmin = 0.55
            xmax = 0.6
            text = "sp"
        intervals [5]:
            xmin = 0.6
            xmax = 0.9
            text = "h"
        intervals [6]:
            xmin = 0.9
            xmax = 1.2
            text = "ao3"
'''


@pytest.mark.parametrize("n_frames", [80, 104, 120])
def test_textgrid_matches_jax_exactly(n_frames):
    ph = ["<BOS>", "n", "i3", "#", "h", "ao3", "<EOS>"]
    got, want = ttg.parse_textgrid(TEXTGRID), jtg.parse_textgrid(TEXTGRID)
    assert got == want and len(got) == 6
    assert ttg.textgrid_to_mel2ph(got, ph, n_frames) == jtg.textgrid_to_mel2ph(want, ph, n_frames)
    assert ttg.parse_textgrid(TEXTGRID, "words") == jtg.parse_textgrid(TEXTGRID, "words")


def test_mfa_guard_lexicon_and_inputs_match_jax(tmp_path, monkeypatch):
    dict_path = str(tmp_path / "zh-dict.json")
    with open(dict_path, "w") as f:
        json.dump(TOY_DICT, f, ensure_ascii=False)
    assert tmfa.mfa_available() == jmfa.mfa_available()
    wav = str(tmp_path / "a.wav")
    save_wav(wav, np.zeros(100, np.float32))
    for name, mod in (("port", tmfa), ("jax", jmfa)):
        proc = tmp_path / name
        proc.mkdir()
        with open(proc / "metadata_phone.csv", "w", newline="") as f:
            csv.writer(f).writerows([["a", wav, "你好", "n i3 # h ao3", "<SINGLE_SPK>"]])
        cfg = {"dict_path": dict_path, "processed_data_dir": str(proc)}
        mod.build_mfa_lexicon(cfg, str(proc / "lex.txt"))
        mod.prepare_mfa_inputs(cfg)
        monkeypatch.setattr(mod.shutil, "which", lambda name: None)
        with pytest.raises(RuntimeError, match="mfa"):
            mod.mfa_train_and_align(cfg)
    for rel in ("lex.txt", "mfa_inputs/000/a.lab", "mfa_inputs/000/a.wav"):
        assert filecmp.cmp(tmp_path / "port" / rel, tmp_path / "jax" / rel, shallow=False), rel


@pytest.mark.parametrize("args", [{"trim_sil": True}, {"denoise": True}, {"resample": True},
                                  {"trim_sil": True, "denoise": True, "resample": True}])
def test_process_wav_matches_jax_exactly(tmp_path, args):
    rng = np.random.RandomState(2)
    wav = np.concatenate([np.zeros(6000), glide(rng, 0.8, 120, 150)[0], 1e-4 * rng.randn(9000)])
    src = str(tmp_path / "in.wav")
    save_wav(src, wav.astype(np.float32), sr=16000)
    outs = []
    for name, cls in (("port", tbin.PreAlign), ("jax", jbin.PreAlign)):
        cfg = {"pre_align_args": args, "processed_data_dir": str(tmp_path / name),
               "audio_sample_rate": SR, "dict_path": str(tmp_path / "unused.json")}
        pre = cls.__new__(cls)  # process_wav needs only the config
        pre.cfg = cfg
        outs.append(load_wav(pre.process_wav("x", src)))
    (w_t, sr_t), (w_j, sr_j) = outs
    assert sr_t == sr_j and w_t.dtype == w_j.dtype and np.array_equal(w_t, w_j)
    assert sr_t == (SR if args.get("resample") else 16000)
    if args.get("trim_sil"):
        assert len(w_t) < len(wav) * sr_t / 16000 - 2048  # the silent lead went


# -- the binarizer, both stages ---------------------------------------------------------

def _toy_raw(root):
    raw = root / "raw"
    (raw / "ProsodyLabeling").mkdir(parents=True)
    (raw / "Wave").mkdir()
    lines = []
    rng = np.random.RandomState(0)
    for name, text in TOY_TEXTS.items():
        lines += [f"{name}\t{text}", "  (pinyin ignored)"]
        wav, _ = glide(rng, 0.7 + 0.2 * len(text), 100, 150)
        save_wav(str(raw / "Wave" / f"{name}.wav"), wav * np.hanning(len(wav)).astype(np.float32))
    (raw / "ProsodyLabeling" / "000001-010000.txt").write_text("\n".join(lines), encoding="utf-8")
    dict_path = str(root / "zh-dict.json")
    with open(dict_path, "w") as f:
        json.dump(TOY_DICT, f, ensure_ascii=False)
    return raw, dict_path


def _toy_cfg(root, name, raw, dict_path, **kw):
    return {"raw_data_dir": str(raw), "processed_data_dir": str(root / name / "processed"),
            "binary_data_dir": str(root / name / "binary"), "dict_path": dict_path, "word_size": 50,
            "dict_embed_dim": 16, "test_num": 1, "valid_num": 1, "use_dict": True, "hop_size": 256,
            "audio_sample_rate": SR, "with_wav": True, "with_f0cwt": True, **kw}


def assert_binaries_equal(port_dir, jax_dir, splits=("test", "valid", "train")):
    """Every item of every split (mel by ``chip_smoke.mel_frame_error`` <= 2e-6, f0 as
    ``assert_f0_close``, the rest exact with the JAX dtypes); the bank and
    the side files byte for byte. Returns the largest mel error."""
    mel_err = 0.0
    for split in splits:
        got_ds, want_ds = IndexedDataset(os.path.join(port_dir, split)), IndexedDataset(os.path.join(jax_dir, split))
        assert len(got_ds) == len(want_ds) > 0, split
        for i in range(len(want_ds)):
            got, want = got_ds[i], want_ds[i]
            assert set(got) == set(want), (split, i)
            for k, w in want.items():
                g = got[k]
                what = f"{split}[{i}].{k}"
                if k == "mel":
                    assert g.dtype == w.dtype and g.shape == w.shape, what
                    mel_err = max(mel_err, cs.mel_frame_error(g, w))
                    assert mel_err <= 2e-6, (what, mel_err)
                elif k == "f0":
                    assert_f0_close(g, w, what)
                elif k in ("cwt_spec", "cwt_mean", "cwt_std"):
                    # the JAX package's cwt of the port's own f0, exactly (its
                    # per-scale z-norm magnifies the f0's 1e-6 differences)
                    w = jcwt.f0_cwt(got["f0"])[k]
                    assert g.dtype == w.dtype and np.array_equal(g, w), what
                elif isinstance(w, np.ndarray):
                    assert g.dtype == w.dtype and np.array_equal(g, w), what
                else:
                    assert type(g) is type(w) and g == w, what
        for name in (f"{split}_lengths.npy",):
            assert np.array_equal(np.load(os.path.join(port_dir, name)), np.load(os.path.join(jax_dir, name)))
        stats = [np.load(os.path.join(d, f"{split}_f0s_mean_std.npy")) for d in (port_dir, jax_dir)]
        # mean and std of f0 values that agree to rtol 1e-5: within 1e-5 of the mean
        np.testing.assert_allclose(stats[0], stats[1], rtol=0, atol=1e-5 * stats[1][0])
    for name in ("dict_embed.data", "dict_embed.idx", "pinyin_encoder.pkl", "phone_set.json",
                 "word_set.json", "spk_map.json"):
        assert filecmp.cmp(os.path.join(port_dir, name), os.path.join(jax_dir, name), shallow=False), name
    return mel_err


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy corpus pre-aligned and binarized by both packages."""
    root = tmp_path_factory.mktemp("toy")
    raw, dict_path = _toy_raw(root)
    cfgs = {}
    for name, (pre, binz) in {"port": (tbin.BiaobeiPreAlign, lambda c: tbin.ZhBinarizer(c, device="cpu")),
                              "jax": (jbin.BiaobeiPreAlign, jbin.ZhBinarizer)}.items():
        cfg = _toy_cfg(root, name, raw, dict_path)
        pre(cfg).process()
        binz(cfg).process()
        cfgs[name] = cfg
    return root, raw, dict_path, cfgs


def test_pre_align_matches_jax(toy):
    _, _, _, cfgs = toy
    for name in ("metadata_phone.csv", "phone_set.json", "word_set.json"):
        assert filecmp.cmp(os.path.join(cfgs["port"]["processed_data_dir"], name),
                           os.path.join(cfgs["jax"]["processed_data_dir"], name), shallow=False), name


def test_toy_binaries_match_jax(toy):
    _, _, _, cfgs = toy
    assert_binaries_equal(cfgs["port"]["binary_data_dir"], cfgs["jax"]["binary_data_dir"])
    item = IndexedDataset(os.path.join(cfgs["port"]["binary_data_dir"], "train"))[0]
    assert item["wav"].dtype == np.float32 and item["len"] == 1 + len(item["wav"]) // 256


def test_cli_end_to_end_on_the_cpu_with_workers(toy, tmp_path):
    """``python -m dicttts_tpu_torch.text.binarize`` (its main), both stages,
    the host text work in 2 spawned workers: the JAX binarizer's binaries."""
    root, raw, dict_path, cfgs = toy
    cfg = _toy_cfg(tmp_path, "cli", raw, dict_path, binarize_workers=2)
    config = tmp_path / "cfg.yaml"
    config.write_text(json.dumps({**cfg, "pre_align_cls": "dicttts_tpu.text.binarizer.BiaobeiPreAlign",
                                  "binarizer_cls": "dicttts_tpu.text.binarizer.ZhBinarizer"}))
    pre, binz = tbinarize.main(["--config", str(config), "--device", "cpu"])
    assert isinstance(pre, tbin.BiaobeiPreAlign) and isinstance(binz, tbin.ZhBinarizer)
    assert binz.stats["workers"] == 2 and binz.stats["items"] == len(TOY_TEXTS)
    assert binz.stats["splits"] == {"test": 1, "valid": 1, "train": 2}
    assert_binaries_equal(cfg["binary_data_dir"], cfgs["jax"]["binary_data_dir"])


def test_the_cli_raises_without_a_card(tmp_path):
    config = tmp_path / "cfg.yaml"
    config.write_text(json.dumps({"processed_data_dir": str(tmp_path), "binary_data_dir": str(tmp_path),
                                  "dict_path": os.path.join(CORPUS, "zh-dict.json")}))
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tbinarize.main(["--config", str(config), "--stage", "binarize"])
    # the speaker-embedding binarizer (tests/test_torch_speaker.py) needs the card too
    with pytest.raises(RuntimeError, match="cuda"):
        tbin.ZhBinarizer({"with_spk_embed": True, "dict_path": os.path.join(CORPUS, "zh-dict.json")})


@pytest.fixture(scope="module")
def tracked(tmp_path_factory):
    """4 tracked wavs with their metadata rows and the repo's dictionary,
    binarized by both packages (the word set: the repo's, cut to these
    rows' characters, in its order)."""
    root = tmp_path_factory.mktemp("tracked")
    with open(os.path.join(CORPUS, "processed", "metadata_phone.csv")) as f:
        rows = list(csv.reader(f))[:4]
    for row in rows:  # the csv names the wavs where the corpus was binarized
        row[1] = os.path.join(CORPUS, "raw", os.path.basename(row[1]))
    chars = {c for row in rows for c in row[2]} | {"<BOS>", "<EOS>"}
    with open(os.path.join(CORPUS, "processed", "word_set.json")) as f:
        words = [w for w in json.load(f) if w in chars]
    cfgs = {}
    for name, make in {"port": lambda c: tbin.ZhBinarizer(c, device="cpu"), "jax": jbin.ZhBinarizer}.items():
        proc = root / name / "processed"
        proc.mkdir(parents=True)
        with open(proc / "metadata_phone.csv", "w", newline="") as f:
            csv.writer(f).writerows(rows)
        (proc / "word_set.json").write_text(json.dumps(words, ensure_ascii=False))
        with open(os.path.join(CORPUS, "processed", "phone_set.json")) as f:
            (proc / "phone_set.json").write_text(f.read())
        cfg = {"processed_data_dir": str(proc), "binary_data_dir": str(root / name / "binary"),
               "dict_path": os.path.join(CORPUS, "zh-dict.json"), "dict_embed_dim": 16, "test_num": 1,
               "valid_num": 1, "with_wav": True, "with_f0cwt": True, "binarize_batch": 3}
        make(cfg).process()
        cfgs[name] = cfg
    return rows, cfgs


def test_tracked_wavs_binarize_as_the_jax_package(tracked):
    rows, cfgs = tracked
    assert_binaries_equal(cfgs["port"]["binary_data_dir"], cfgs["jax"]["binary_data_dir"])
    train = IndexedDataset(os.path.join(cfgs["port"]["binary_data_dir"], "train"))
    assert [train[i]["item_name"] for i in range(len(train))] == [r[0] for r in rows[2:]]
    for i in range(len(train)):
        item = train[i]
        assert item["wav"] is not None and len(item["wav"]) // 256 + 1 == item["len"] == len(item["mel"])
    with open(os.path.join(cfgs["port"]["binary_data_dir"], "pinyin_encoder.pkl"), "rb") as f:
        assert pickle.load(f)[:2] == ["<pad>", "<UNK>"]


def test_the_tracked_items_mel_and_f0_come_from_this_pipeline(tracked):
    """The repo's binarized test item s0000 (written by the JAX binarizer on
    a TPU, whose f32 mel-basis product runs in bf16 passes) against the
    port's run on its wav: ``chip_smoke.mel_frame_error`` within 1e-2 (measured 4.8e-3),
    f0 as ``assert_f0_close`` (measured 1.5e-6, no flips), the
    structures exact."""
    _, cfgs = tracked
    got = IndexedDataset(os.path.join(cfgs["port"]["binary_data_dir"], "test"))[0]
    want = IndexedDataset(os.path.join(CORPUS, "binary", "test"))
    want = next(want[i] for i in range(len(want)) if want[i]["item_name"] == got["item_name"])
    assert want["wav"] is None and got["len"] == want["len"]
    assert cs.mel_frame_error(got["mel"], want["mel"]) <= 1e-2
    assert_f0_close(got["f0"], want["f0"], "s0000")
    for k in ("ph", "words", "ph2word", "mel2word", "mel2ph", "pron_modified"):
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
