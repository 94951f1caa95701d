"""scripts/torch_reproduce_biaobei.sh end to end on the CPU (DEVICE=cpu), on a
miniature Biaobei-layout corpus as tests/test_reproduce_runbook.py builds it
for the JAX runbook: pre-align -> binarize -> train (4 steps) -> --infer ->
PER against a label file of the test rows, all from one command."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from dicttts_tpu_torch.text.pinyin import ZhG2P, pinyin_to_tone3
from dicttts_tpu_torch.tools.synth_corpus import gen_dictionary
from dicttts_tpu_torch.vocoders.hifigan import save_wav

# one intra-op thread: the OpenMP thread teams of parallel pytest workers stall each other
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mini_biaobei(root):
    """ProsodyLabeling/000001-010000.txt + Wave/, 8 utterances; returns the
    raw dir, the dictionary and the texts."""
    d = gen_dictionary(30, seed=7)
    chars = list(d)
    dict_fn = os.path.join(root, "zh-dict.json")
    with open(dict_fn, "w") as f:
        json.dump(d, f, ensure_ascii=False)
    raw = os.path.join(root, "raw")
    os.makedirs(os.path.join(raw, "ProsodyLabeling"))
    os.makedirs(os.path.join(raw, "Wave"))
    rng = np.random.RandomState(7)
    lines, texts = [], []
    for i in range(8):
        name = f"{i + 1:06d}"
        a, b = "".join(rng.choice(chars, 6)), "".join(rng.choice(chars, 4))
        lines += [f"{name}\t{a}#1{b}\n", "\tpinyin-line-unused\n"]
        texts.append((name, a + b))
        t = np.arange(int(22050 * 1.4)) / 22050
        save_wav(os.path.join(raw, "Wave", f"{name}.wav"), (0.3 * np.sin(2 * np.pi * (150 + 20 * i) * t)))
    with open(os.path.join(raw, "ProsodyLabeling", "000001-010000.txt"), "w") as f:
        f.writelines(lines)
    return raw, dict_fn, texts


def _labels(path, dict_fn, rows):
    """label_set0.csv rows: each character's first reading."""
    g2p = ZhG2P(dict_fn)
    out = [",item_name,spk,txt,ph,wav_fn,others"]
    for i, (name, text) in enumerate(rows):
        phs = []
        for ch in text:
            ini, fin = pinyin_to_tone3(g2p.zh_dict.prons(ch)[0])
            phs.append(f"{ini} {fin}" if ini else fin)
        out.append(f"{i},{name},SPK1,{text},<BOS> {' | '.join(phs)} <EOS>,{name}.wav,{{}}")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(out) + "\n")


def test_runbook_end_to_end(tmp_path):
    root = str(tmp_path)
    raw, dict_fn, texts = _mini_biaobei(root)
    labels = os.path.join(root, "labels.csv")
    _labels(labels, dict_fn, texts[:2])  # the test split: the first test_num rows
    exp = f"torch_runbook_{os.getpid()}"
    env = {
        **os.environ,
        "DEVICE": "cpu",
        "OMP_NUM_THREADS": "1",  # each stage's process: one intra-op thread, as above
        "PYTHON": sys.executable,
        "LABELS": labels,
        "HP": ",".join([
            f"dict_path={dict_fn}", f"processed_data_dir={root}/processed", f"binary_data_dir={root}/binary",
            "test_num=2", "valid_num=2", "word_size=40", "hidden_size=16", "fvae_enc_dec_hidden=16",
            "latent_size=4", "fvae_enc_n_layers=1", "fvae_dec_n_layers=1", "prior_glow_hidden=8",
            "prior_glow_n_blocks=1", "mel_disc_hidden_size=8", "max_updates=4", "val_check_interval=4",
            "num_sanity_val_steps=0", "max_sentences=4", "max_frames=128", "mel_buckets=[128]",
            "txt_buckets=[16]", "use_pallas_s2pa=False", "use_device_dict_bank=False", "vocoder_ckpt=",
            "lm_model=", "dict_embed_dim=16", "num_ckpt_keep=1", "eval_max_batches=1",
        ]),
    }
    out_dir = os.path.join(REPO, "checkpoints", exp)
    try:
        res = subprocess.run(["bash", "scripts/torch_reproduce_biaobei.sh", raw, exp], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, f"stdout:\n{res.stdout[-4000:]}\nstderr:\n{res.stderr[-4000:]}"
        for stage in range(1, 6):
            assert f"== [{stage}/5]" in res.stdout
        meta = os.path.join(out_dir, "generated", "meta.csv")
        with open(meta, encoding="utf-8") as f:
            rows = f.read().splitlines()[1:]
        assert [r.split(",")[1] for r in rows] == ["000001", "000002"]
        per_line = [line for line in res.stdout.splitlines() if line.startswith("| PER: ")]
        assert len(per_line) == 1 and 0.0 <= float(per_line[0][7:-1]) <= 100.0, res.stdout[-2000:]
        mel = np.load(os.path.join(out_dir, "generated", "000001.mel.npy"))
        assert mel.ndim == 2 and mel.shape[1] == 80 and np.isfinite(mel).all()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
