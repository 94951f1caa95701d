#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dicttts_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each announced on its own line:
 0. the card: name, nvidia-smi name and power limit; TF32 off for f32
    matmuls and convolutions;
 1. build the CUDA kernels from dicttts_tpu_torch/csrc with nvcc (one
    process per source, all at once) and print ptxas's registers, shared
    memory and spills for each kernel;
 2. K1 (s2pa_bank_fwd) against its plain version at the serving geometry
    (bank 8000 x 96 x 768, N = 1000 word slots), bf16 and f32, then timed
    with L2 flushed before each call, beside its byte bound;
 3. K3 (s2pa_fused) against its plain version at B=16, T=64, L=96, H=192,
    P=8, f32, then timed, with the kernel's plan (cluster size, CTAs,
    ring);
 4. serving at full production width with seeded random weights on the
    device-resident bf16 bank: three batches (B=1/Tw=32, B=4/Tw=48,
    B=16/Tw=64) word ids -> wav, K1 launched once per batch; one request
    also served on the CPU through the plain versions as a reference;
 5. one batch of gathered-bank serving with use_pallas_s2pa, through K3;
 6. K1 and K2 (s2pa_bank_bwd) against their plain versions at the
    training geometry (bank 8000 x 96 x 768, N = 60 x 64 = 3840 slots, one
    all-masked slot, a dropout mask), bf16 and f32, with three kinds of
    word ids: laid out as the training batches of the repo's corpus
    (sentences of 20-58 words padded to 64 slots with id 0; the main
    case), uniform, and Zipf-distributed (s = 1.1 over the 8000 words);
    two launches bitwise equal; the autograd function (K1 + K2) against
    autograd through K1's plain version (f32); each case's kernels timed
    alone beside their byte bounds (the slot order they share timed on its
    own), with the distinct rows and the kernels' chunks of slots;
 7. training at production width (the recipe's DictTTSTask, seeded random
    weights, the recipe's bf16 device bank, dropout on): synthetic batches of B=60,
    Tw=64, 512 frames; 2 warm-up and 10 timed steps; K1 and K2 launched
    once per step, K3 never; then 3 steps under torch.profiler (top
    kernels, convolutions by shape, the device's idle share) and 5 with
    cuDNN autotuning, for comparison;
 7b. Trainer.fit for 2 steps into a temporary directory, then a resume
    from its checkpoint and a third step;
 7c. one train step at full width on the card and on the CPU (plain
    versions) from the same weights, dropout 0, pinned noise and crops, at
    B=2, Tw=16, 128 frames: every loss and both gradient norms compared;
 8. the recipe's own entry point on the corpus: ``python -m
    dicttts_tpu_torch.run``'s ``main`` with the recipe's config
    (configs/datasets/biaobei/dict_tts.yaml: its widths, its token-budget
    batching into the 256/512/768-frame buckets, the frame cache) on the
    repo's binarized train/valid/test splits (.prod_corpus/binary; a corpus
    of the same format and statistics written from the seed where the
    checkout has none) and a stand-in dict_embed written from the seed (all
    8000 word ids, glosses of 1-56 tokens, so L = 64): 16 steps (two
    epochs) with validations and checkpoints, a resume for 2 more, then
    --infer over the 18 test utterances into meta.csv; K1 and K2 checked
    against their plain versions on the recipe's bank and a real batch's
    word ids. It prints the step ms by batch shape and mel bucket, the
    host's wait for batches, the bank's and the frame cache's bytes and
    upload seconds, peak memory and ms per test utterance.
 9. on phase 8's directory: (a) Chinese text -> wav through the port's
    DictTTSInferencer (the recipe's config, the repo's dictionary, phase
    8's newest checkpoint and stand-in dict_embed, a seeded vocoder at the
    recipe's HiFi-GAN widths) on the 50 PER test sentences
    (data/per_test_set.json): one sentence written to a wav and read back,
    then 8 calls at B=1 and the 50 in batches of 16, with eager S2PA (the
    recipe) and with use_pallas_s2pa (K3 once per call, eager never); the
    two runs' frame counts and pinyin equal and their mels close; per-stage
    ms, RTF, the bf16 vocoder's time and deviation, and K3 alone at the
    inferencer's own shapes (the largest B=1 call and the first B=16 batch),
    with its plan, and on the kernel A/B script's seeded B=16 case of the
    same layout. Tone sandhi runs through jieba where it
    imports, else from the committed overrides of those sentences
    (tests/sandhi_per_test_set.json); the route is printed. (b) run.main on
    the corpus with per-utterance gathered banks (use_device_dict_bank
    false) for 4 steps: finite losses, K1/K2 never launched, step ms by
    batch shape beside phase 8's.
10. the recipe's other settings on phase 8's directory: (a) the splits
    converted to .rio by the port's converter and read by its native
    reader; run.main under amp (bf16 autocast, the bank held bf16, mels
    sent as f16) for phase 8's 16 steps, step ms by batch shape beside
    phase 8's f32 times, peak memory, K1/K2 launched every step; one
    profiled step of the largest 512-frame batch, with the device time in
    kernels named FFT; then --infer under amp with use_pallas_s2pa on
    gathered banks (K3 once per test utterance, outputs finite, meta.csv
    full), and K3 with a bf16 q against its plain version; (b)
    accumulate_grad_batches=2: 3 micro-steps, the checkpoint after the
    third holding one pending micro-step per optimizer, a resume
    and on to 8: 4 updates of each optimizer; (c) 4 steps with speaker
    ids (num_spk 2000), the flow-less prior, Gumbel senses, the
    discriminator without norm and with the sum reduction, on the unfused
    bank (K1/K2 never launched), and 4 with the sense mode on the fused
    bank (K1/K2 launched); (d) one train step under amp beside one in f32
    on the card at tests/test_torch_amp.py's small widths, inputs and
    weights: the largest loss gap within twice the JAX package's own
    amp-vs-f32 gap on those inputs, measured on the CPU by that test.
11. the offline pipeline and vocoder training, which launch none of the
    three kernels: (a) 120 wavs written from the seed (tones of 1.5-4 s
    whose f0 glides within 90-155 Hz, after 0.15 s of silence) paired with
    the first rows of the repo's metadata (texts and phones), binarized by
    ``python -m dicttts_tpu_torch.text.binarize``'s main on the card with
    the recipe's config (dict_embed_dim 768), with_wav and with_f0cwt:
    the seeded f0 recovered within 2 %, one chunk's mel and f0 on the card
    against the CPU, every item's wav and frames consistent, the bank
    holding every word id; items per second, card ms per chunk for the mel
    and the f0, the bank's seconds and bytes, the split sizes; (b) run.main
    with configs/datasets/biaobei/hifigan.yaml (generator 512 channels,
    MPD + MSD, 24 crops of 8192 samples) on those binaries with
    disc_start_steps 2: 2 steps with the discriminator and its optimizer
    untouched, a resume to 8 with them trained, a resume to 10, --infer
    (wavs of T_mel * 256 samples); step ms of G-only and GAN steps, a
    profiled GAN step (top kernels, the device's busy time), peak memory,
    host wait, and one step under amp beside one in f32; (c) one
    HiFi-GAN step on the card and on the CPU from the same weights and
    crops at width 32: every loss and both gradient norms.

12. the PortaSpeech recipes, which launch none of the three kernels, on
    the repo's splits (or the synthetic corpus): (a) run.main with
    configs/datasets/biaobei/ps_adv.yaml at the recipe's widths (hidden
    192, 4 + 4 encoder layers, FVAE 8/4, prior flow 4 blocks, the mel
    discriminator; token-budget batches of 20000 frames) for 16 steps with
    validations and checkpoints, a resume for 2 more, --infer over the test
    split: step ms by batch shape, host wait, peak memory, ms per test
    utterance; (b) ps_flow.yaml with use_post_glow (12 blocks of 3 WN layers
    at 192, 3 shared WN stacks) and post_glow_training_start cut from 160000
    to 4: 3 steps, a resume to 8 across the switch, the frozen part of each
    stage checked untouched through the checkpoints, --infer with the
    Glow's sample (finite mels, not all equal); (c) one ps_adv step and one
    post-glow stage-2 step on the card and on the CPU from the same
    weights, batch, noise and crops at B=2 and small widths: every loss and
    gradient norm within 2e-3.

13. the FastSpeech2 family, which launches none of the three kernels,
    on the repo's splits (or the synthetic corpus): (a) run.main with
    configs/datasets/biaobei/fs2.yaml at the recipe's widths (hidden 256,
    the rel_fft encoder of 4 layers, the conv decoder of 4 x k9, the
    pitch predictor; batches of 32000 frames) for 16 steps with
    validations and checkpoints, a resume for 2 more, --infer over the test
    split: step ms by batch shape (the card synchronized after each step),
    host wait, peak memory, ms per test utterance, and one profiled step of
    the largest batch and one of the slowest shape (top kernels, the share
    in FFT kernels); (b) each
    other encoder and decoder of the registry at the recipe's width on that
    batch: one train step and one inference, finite, ms; (c) TransformerTTS
    at its default widths (256, 4 + 4 layers): a teacher-forced train step,
    a cached decode of 200 frames at B = 1 and B = 16 in ms per frame, and
    the decode against the teacher-forced pass on its own frames; (d) the
    GE2E encoder's embed_utterance on the card against the CPU from a
    seeded Resemblyzer state_dict; (e) one fs2 step on the card and on the
    CPU at B=2 and small widths: every loss and the gradient norm within
    2e-3.

14. data parallelism, the serving export and the validation artifacts:
    (a) on phase 8's directory, run.main of the recipe for 4 steps inside a
    world-size-1 NCCL group (``--multihost`` with torchrun's variables, so
    every collective runs over one rank) against the same 4 steps without a
    group, deterministic kernels in both: losses within 1e-6, K1 and K2
    launched every step; (b) two spawned ranks on the one card (gloo over a
    FileStore, CUDA tensors) against one process on the whole batch: the
    recipe's task at full width on the seeded bf16 bank, a 16-row corpus
    batch whose halves differ in frames, dropout 0, pinned noise and crops,
    deterministic kernels, 2 steps: losses and gradient norms within 1e-3, parameters within 1e-6
    plus each update's Adam term at a gradient tolerance of 1e-2 |g| + 1e-5
    of the largest (``update_atol``), the ranks' parameters equal; K1/K2 launches and peak memory per rank; (d)
    the validation artifacts on phase 8's newest checkpoint: the card pass
    (``validation_outputs``, K1 once), the figures where matplotlib
    imports, whether tensorboardX is there; (c, after phase 13) the serving
    export at the recipe's widths with use_pallas_s2pa and the recipe's
    HiFi-GAN (512 channels), buckets 1x32 and 8x64: export and load
    seconds, artifact bytes, ms a call of the exported module beside the
    live test_step + vocoder (CUDA events), mel2word and pinyin_pred equal,
    mels within 1e-4 and wavs within 1e-3, K3 once a call and a graph
    node, eager S2PA's plain version never run.

15. the reference's checkpoints and the PER pipeline: (a, inside phase 8's
    directory, after 14d) a seeded DictTTS at the recipe's widths (phase 8's
    vocabulary) and a HiFi-GAN at 512 channels written with torch.save in the
    reference's layouts (weight-norm pairs where the JAX converter folds, the
    task checkpoint nested under state_dict/model beside mel_disc, the
    vocoder under generator, the unused keys present), converted by
    ``dicttts_tpu_torch.tools.convert_torch_ckpt``; DictTTSInferencer from
    the converted checkpoints and from the models in memory on 8 PER
    sentences with pinned noise and use_pallas_s2pa: mel2word and pinyin
    equal, mels within 1e-5 relative, wavs within 1e-4, K3 once a call;
    (b, at the end) ``tools.per_eval.main`` on the repo's stand-in
    dictionary (.prod_corpus/zh-dict.json; its phones and sandhi from
    tests/per_standin_text.json) with --n_items 300, --max_updates 200 and
    --score_train: binarize seconds and items/s, step ms by shape under the
    config's amp, K1 and K2 once a train step, ms per test utterance, PER and
    the first-reading baseline, the slot breakdown; 50 label and meta.csv
    rows, get_pron_error printing the same PER, the held-in probe without
    error (a pipeline check after 200 updates from random weights: no
    quality claimed); (c) ``tools.attn_probe`` on (b)'s experiment: slot
    counts, finite statistics, K1 once a test utterance.

16. the trainer's grouped dispatch (``steps_per_dispatch``): (a, inside
    phase 8's directory, after 15a) run.main of the recipe on phase 8's
    corpus for 20 steps at K = 1 and K = 16, in f32 and under amp, the
    discriminator from step 10 (so both graph keys, generator-only and
    GAN, occur), deterministic kernels: every step's losses and the final
    weights, Adam moments, counts and lr equal to the bit; (b) the graphs
    captured with their keys (batch shapes, gates), capture seconds,
    replays, K1/K2 launches a step with the replays counted, peak memory
    and step ms by shape and by how the step ran (eager, captured,
    replayed) for both K, steady_per_step_s; (c) the recipe's task at full
    width on the seeded bf16 bank, 8 synthetic 16 x 32 x 256 steps with a
    NaN in step 6's mels, K = 1 against K = 4 (the NaN step a replay inside
    a group): losses and final state equal to the bit, the update skipped;
    (d) in (a)'s f32 K = 16 run, the checkpoint at step 10, written on a
    thread while steps 11-20 ran, against the state read synchronously at
    step 10, bit for bit, with the ms save() held the loop and the
    thread's seconds. Phases 8-10, 14a and 15b reach graphs too: their
    run.main calls take the config's steps_per_dispatch.

Before the last line it prints one JSON line of kernel results
({"kernels": [...], "corpus": "repo" or "synthetic"}) and the total
seconds; the last line is {"ok": true, "device": {...}}. Any failure raises
and exits non-zero; so does a machine without CUDA. Nothing is written
outside the gitignored build directory dicttts_tpu_torch/_build/, the
temporary directories that phases 7b, 8, 9, 10, 11, 12, 13, 14, 15 and 16
remove, and phase 15b's work dir checkpoints/per_eval_chip_smoke<pid>,
which it removes.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import faulthandler
import io
import json
import math
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

T_START = time.time()

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 1234
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor-core bf16; f32 outside them
BANK_V, BANK_L, BANK_E, BANK_P = 8000, 96, 768, 8
SAMPLE_RATE, HOP = 22050, 256
# phase 10d: one train step's settings (small widths, gathered banks,
# dropout 0), and the JAX task's largest |amp - f32| loss gap on its inputs
# (amp_check_inputs, amp_check_weights), which tests/test_torch_amp.py
# measures on the CPU and holds this constant to
AMP_CHECK_CFG = dict(word_size=40, hidden_size=16, num_heads=2, enc_ffn_kernel_size=3, dropout=0.0,
                     predictor_dropout=0.0, disc_dropout=0.0, value_embedding_size=30, dict_embed_dim=32,
                     dur_predictor_layers=2, dur_predictor_kernel=3, latent_size=4, fvae_enc_dec_hidden=16,
                     fvae_kernel_size=3, fvae_enc_n_layers=1, fvae_dec_n_layers=1, prior_glow_hidden=8,
                     glow_kernel_size=3, prior_glow_n_blocks=1, mel_disc_hidden_size=8,
                     use_device_dict_bank=False, max_frames=96)
JAX_AMP_LOSS_GAP = 1.738e-3
BATCHES = ((1, 32), (4, 48), (16, 64))  # (requests, word slots per request)
TRAIN_B, TRAIN_TW, TRAIN_T = 60, 64, 512  # recipe max_sentences 60, the 512-frame bucket
TRAIN_WARMUP, TRAIN_STEPS = 2, 10  # few timed steps: the whole run stays near half its time limit
REPO = os.path.dirname(os.path.abspath(__file__))
RECIPE_CONFIG = "dicttts_tpu_torch/configs/datasets/biaobei/dict_tts.yaml"
RECIPE_STEPS, RESUME_STEPS = 16, 2  # two epochs of the train split's 8 batches
# phase 14: steps of the world-size-1 runs and of the two-rank runs, the two-rank batch's rows,
# the export's buckets
DDP_STEPS, TWO_RANK_STEPS, DDP_ROWS = 4, 2, 16
EXPORT_BUCKETS = ((1, 32), (8, 64))
CORPUS_SPLITS = {"train": 324, "valid": 18, "test": 18}  # the repo's corpus, .prod_corpus/binary
CORPUS_FILES = ("word_set.json", "phone_set.json", "pinyin_encoder.pkl", "spk_map.json")
# phase 12: the PortaSpeech recipes on the corpus (post_glow_training_start
# cut from 160000 to PS_FLOW_SWITCH), and one step of each on card and CPU
PS_ADV_CONFIG = "dicttts_tpu_torch/configs/datasets/biaobei/ps_adv.yaml"
PS_FLOW_CONFIG = "dicttts_tpu_torch/configs/datasets/biaobei/ps_flow.yaml"
PS_STEPS, PS_RESUME = 16, 2
PS_FLOW_STOP, PS_FLOW_SWITCH, PS_FLOW_STEPS = 3, 4, 8
PS_CHECK_CFG = dict(n_vocab=64, hidden_size=32, enc_layers=2, word_enc_layers=2, dropout=0.0,
                    predictor_dropout=0.0, disc_dropout=0.0, fvae_enc_dec_hidden=32, latent_size=4,
                    fvae_enc_n_layers=2, fvae_dec_n_layers=2, prior_glow_hidden=16,
                    mel_disc_hidden_size=16, post_glow_hidden=32, post_glow_n_blocks=4,
                    post_glow_n_block_layers=2, share_wn_layers=2)
# phase 13: the FastSpeech2 recipe on the corpus, the other registry entries,
# TransformerTTS, the GE2E encoder, and one fs2 step on card and CPU
FS2_CONFIG = "dicttts_tpu_torch/configs/datasets/biaobei/fs2.yaml"
FS2_STEPS, FS2_RESUME = 16, 2
FS2_OTHER_ENTRIES = (("fft", "conv"), ("conformer", "conv"), ("tacotron", "conv"), ("tacotron2", "conv"),
                     ("rel_fft", "fft"), ("rel_fft", "wn"), ("rel_fft", "conformer"), ("rel_fft", "rnn"))
FS2_CHECK_CFG = dict(n_vocab=64, hidden_size=32, enc_layers=2, dec_layers=2, enc_ffn_kernel_size=5,
                     dec_ffn_kernel_size=5, dropout=0.0, predictor_dropout=0.0, pitch_norm="standard",
                     mel_loss="l1:0.5|ssim:0.5", encoder_type="rel_fft", decoder_type="conv")
TTS_DECODE_FRAMES = 200
# phase 11: the offline pipeline and HiFi-GAN training
VOCODER_CONFIG = "dicttts_tpu_torch/configs/datasets/biaobei/hifigan.yaml"
VOC_ROWS = 120  # 12 test, 12 valid and 96 train rows: 4 batches of the recipe's 24 crops
VOC_LEAD_S = 0.15  # each wav opens with this much silence (unvoiced frames)
# seeded f0 glides stay below 160 Hz, where twice the period lies past the
# extractor's lag band (22050 / 80 samples), so its subharmonic picks
# (tests/test_torch_binarizer.py) cannot occur and the f0 must be recovered
VOC_F0_HZ = (90.0, 155.0)
VOC_F0_RTOL = 0.02
# the card-vs-CPU f0 check also runs a chunk of glides in this band (the
# corpus voice's), where the subharmonic picks and near-ties between lags occur
VOC_F0_HIGH_HZ = (160.0, 330.0)
VOC_CHUNK = 16  # wavs in the chunk run on the card and on the CPU
# phase 15: per_eval's updates (its sentences: tests/per_standin_text.json's n_items) and the
# test utterances attn_probe reads
PER_UPDATES, PER_PROBE_N = 200, 30
# phase 16: the recipe's runs at K = 1 and K = GRAPH_K, by precision: their steps, the discriminator's
# start inside them, and the replays each graph of the K = GRAPH_K run must reach. The corpus has 8
# shapes an epoch: in f32 (whose steps from 49 sentences take 1-2 s) the graphs of both gates replay
# once; under amp each of the 8 discriminator-step graphs replays twice after its capture.
# 16c's synthetic same-shape steps (B, Tw, T), the ones with a NaN (the last step among them), its K
GRAPH_K = 16
GRAPH_RUNS = {"f32": (20, 10, 1), "amp": (36, 4, 3)}
NAN_STEPS, NAN_AT, NAN_K, NAN_SHAPE = 8, (5, 7), 4, (16, 32, 256)
# phase 17: every other task's step (and Dict-TTS under accumulation) at the recipes' widths, K =
# GROUP_K against K = 1 on fixed-shape synthetic batches: PortaSpeech's (B, T_ph, Tw, T) below 49
# sentences, FastSpeech2's (B, T_txt, T), HiFi-GAN's crops (B, samples). A gate (the discriminators'
# start in 17a and 17d, the Glow's in 17b) switches at GROUP_SWITCH (0-based), so each gate's graph
# has a group of replays only, whose ms are its replay ms. The NaN step of 17a and of 17e; the
# replays every graph must reach (the one that completes its capture and two more)
GROUP_K, GROUP_REPLAYS, GROUP_STEPS, GROUP_SWITCH = 4, 3, 16, 8
PS_GROUP_SHAPE, PS_NAN_AT = (32, 96, 40, 512), 14
FS2_GROUP_SHAPE, FS2_GROUP_STEPS = (32, 96, 512), 12
FS2_REGISTRY_SHAPE, FS2_REGISTRY_STEPS = (8, 48, 128), 6  # the other entries: a short, small check
VOC_GROUP_SHAPE = (24, 8192)
ACC_GROUP_STEPS, ACC_NAN_AT = 12, 10
# a frame whose normalized ACF spans less than this over the lag band has no
# peak (seeded tones: voiced frames span 1.2 at their 1st percentile, frames
# at a silence's edge 1e-6 to 2e-3)
F0_FLAT = 1e-2


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_ops: float, dtype: str) -> tuple[float, str]:
    """Least time (ms) for the work: bytes over memory rate vs ops over peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def make_bank(device, gen, dtype=torch.bfloat16):
    """Seeded [V, L, E] bank (bf16 for serving, f32 for training) and its
    maps, made on the device. Sense
    ids are contiguous runs over each word's gloss tokens; each sense owns
    two pinyin slots. Rows 0/1/2 (pad, BOS, EOS) follow the collater
    convention: zero keys, maps 1."""
    V, L, E, P = BANK_V, BANK_L, BANK_E, BANK_P
    keys = torch.randn((V, L, E), generator=gen, device=device, dtype=dtype)
    n_senses = torch.randint(1, 4, (V, 1), generator=gen, device=device)
    glen = torch.randint(8, L + 1, (V, 1), generator=gen, device=device)
    ll = torch.arange(L, device=device)[None]
    key_map = torch.where(ll < glen, ll * n_senses // glen + 1, 0).to(torch.int32)
    pp = torch.arange(P, device=device)[None]
    pinyin_map = torch.where(pp < 2 * n_senses, pp // 2 + 1, 0).to(torch.int32)
    pinyin = torch.where(pp < 2 * n_senses,
                         torch.randint(1, 185, (V, P), generator=gen, device=device), 0).to(torch.int32)
    keys[:3] = 0
    key_map[:3] = 1
    pinyin[:3] = 0
    pinyin_map[:3] = 1
    return {"keys": keys, "key_map": key_map, "pinyin": pinyin, "pinyin_map": pinyin_map}


def time_ms_cold(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` calls, each between its own
    pair of CUDA events after L2 is flushed (a 128 MB write), so no call
    finds the previous call's bank rows in the 50 MB L2, as a train step
    would not. All calls are queued before one synchronize: the host runs
    ahead of the card, and the wrapper's host time stays outside the events."""
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / iters


def device_kernel_ms(fn, iters: int = 20, cold: bool = False, load: int = 0) -> dict:
    """Device time of fn()'s kernels per call, by kernel name, from
    torch.profiler: for index preparation made of a few small kernels, and
    for kernels shorter than their wrapper's host time, where CUDA events
    around each call would count the host's launch gaps. ``cold``: L2
    flushed (a 128 MB write) before each call. ``load``: that many 4096^3
    f32 matmuls (~3 ms each) queued just ahead of the calls, so the card
    comes to them busy. The flush's and the load's kernels are named by a
    profile of their own and left out.

    On the H100 a profiler session drops the records of the kernels it
    meets first (one in a fresh process; several late in chip_smoke), so
    each session opens with a pause and a ~1 ms spin kernel, the flush is
    named from ``iters`` flushes, a session that kept no record of the
    calls is run again (up to 3 sessions), and a kernel's time per call is
    its mean over the records kept times its launches per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    a = torch.ones((4096, 4096), device="cuda") if load else None

    def kernels(body):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.002)
            torch.cuda._sleep(1 << 21)
            body()
            torch.cuda.synchronize()
        return [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]

    def others():
        for _ in range(iters):
            torch.cuda._sleep(1000)  # names the opening spin
            if cold:
                flush.zero_()
        for _ in range(2 if load else 0):
            a @ a

    skip = {key for key, _, _ in kernels(others)}
    fn()

    def run():
        for _ in range(load):
            a @ a
        for _ in range(iters):
            if cold:
                flush.zero_()
            fn()

    for _ in range(3):  # a session late in the run can drop every record of the calls
        out = {key: t / n * math.ceil(n / iters) / 1e3 for key, n, t in kernels(run) if key not in skip}
        if out:
            return out
    raise RuntimeError("torch.profiler recorded no kernel of the timed calls in 3 sessions")


def device_ms(fn, iters: int = 20, cold: bool = False, load: int = 0) -> float:
    """Mean device time of fn()'s kernels per call (device_kernel_ms, summed)."""
    return sum(device_kernel_ms(fn, iters, cold, load).values())


def word_ids(gen, N, ids):
    """[N] int32 word ids on gen's device.
    "corpus": N / 64 sentences of 64 word slots, laid out as the training
    collater lays out the repo's corpus (.prod_corpus/binary/train; measured
    by scripts/corpus_word_id_stats.py): a start id (3), n - 2 words uniform
    over [4, V), an end id (1), then the pad id 0 up to 64 slots, with n
    uniform over [20, 58] words (the corpus's range, near uniform): about
    37 % of the slots are padding (the corpus's own batches: 19-65 %, as
    they are cut by length), and the words repeat little.
    "uniform": uniform over the bank. "zipf": P(rank k) ~ k ** -1.1 over the
    V words, ranks shuffled over the ids, for text that repeats its
    function words."""
    dev = gen.device
    if ids == "corpus":
        B, Tw = N // TRAIN_TW, TRAIN_TW
        n = torch.randint(20, 59, (B, 1), generator=gen, device=dev)
        pos = torch.arange(Tw, device=dev)
        words = torch.randint(4, BANK_V, (B, Tw), generator=gen, device=dev)
        wt = torch.where(pos < n - 1, words, torch.where(pos == n - 1, 1, 0))
        wt[:, 0] = 3
        return wt.flatten().to(torch.int32)
    if ids == "uniform":
        return torch.randint(0, BANK_V, (N,), generator=gen, device=dev, dtype=torch.int32)
    p = torch.arange(1, BANK_V + 1, device=dev, dtype=torch.float64) ** -1.1
    ranks = torch.multinomial(p / p.sum(), N, replacement=True, generator=gen)
    return torch.randperm(BANK_V, generator=gen, device=dev)[ranks].to(torch.int32)


def bank_case(device, gen, dtype, N, ids="uniform"):
    """K1/K2 inputs at V=8000, L=96, E=768: seeded bank, word ids, one
    all-masked slot, a dropout keep-scale mask (p = 0.1), upstream gradients."""
    V, L, E = BANK_V, BANK_L, BANK_E
    bank = torch.randn((V, L, E), generator=gen, device=device).to(dtype)
    wt = word_ids(gen, N, ids)
    qe = (torch.randn((N, E), generator=gen, device=device) * (3.0 / math.sqrt(E))).to(dtype)
    km = torch.randint(0, 4, (N, L), generator=gen, device=device, dtype=torch.int32)
    km[:, 0] = 1
    km[7] = 0  # an all-masked slot: uniform weights, zero gradient
    mask = (torch.rand((N, L), generator=gen, device=device) >= 0.1).float() / 0.9
    g_ctx = torch.randn((N, E), generator=gen, device=device).to(dtype)
    g_w = torch.randn((N, L), generator=gen, device=device)
    return (bank, wt, qe, km, mask), g_ctx, g_w


def bank_bound(args, bwd):
    """K1's (or K2's) least time for these inputs: (ms, 'bytes' or
    'operations', bytes moved, distinct bank rows read). Each distinct row
    is read once, and each of the function's other inputs and outputs."""
    bank, wt, qe, km, mask = args
    _, L, E = bank.shape
    N, elt = wt.shape[0], bank.element_size()
    n_rows = torch.unique(wt).numel()  # bank rows this run's ids read
    n_bytes = n_rows * L * E * elt + N * 4 + N * E * elt + 2 * N * L * 4  # in: rows, wt, qe, km, mask
    if bwd:
        n_bytes += N * E * elt + N * L * 4 + N * E * elt  # in: g_ctx, g_w; out: d_qe
    else:
        n_bytes += N * E * elt + N * L * 4  # out: ctx, w
    dt = "bfloat16" if bank.dtype == torch.bfloat16 else "float32"
    bound_ms, bound_by = bound(n_bytes, (6.0 if bwd else 4.0) * N * L * E, dt)
    return bound_ms, bound_by, n_bytes, n_rows


FUSED_H, FUSED_P = 192, 8  # K3's width on every path: the recipe's hidden size; pinyin slots bucketed to 8


def text_layout(rng, B, T, L, P):
    """key_map [B, T, L] and pinyin_map [B, T, P] (int32 numpy) laid out as
    the text path's K3 inputs are (DictTTSInferencer._collate over
    data/utterance_bank on phase 8's stand-in dict_embed): sentence b of
    the PER test set gives BOS + its characters + EOS words; a word's gloss
    has floor(triangular(1, 1, 57)) tokens (cut to L) and 1-3 senses over
    contiguous tokens, each sense two pinyin slots; the BOS and EOS rows
    carry maps 1 over the utterance's widest gloss and pinyin; the batch's
    pad words are all-masked (maps 0)."""
    km = np.zeros((B, T, L), np.int32)
    pm = np.zeros((B, T, P), np.int32)
    for b, text in enumerate(per_sentences()[:B]):
        n = min(len(text) + 2, T)
        glen = np.minimum(np.floor(rng.triangular(1, 1, 57, n - 2)).astype(int), L)
        senses = rng.randint(1, 4, n - 2)
        km[b, [0, n - 1], :glen.max()] = 1
        pm[b, [0, n - 1], :min(P, 2 * senses.max())] = 1
        for i, (g, ns) in enumerate(zip(glen, senses), 1):
            km[b, i, :g] = np.arange(g) * ns // g + 1
            pm[b, i, :min(P, 2 * ns)] = np.repeat(np.arange(1, ns + 1), 2)[:P]
    return km, pm


def fused_case(device, gen, B, T, L, layout="synthetic", H=FUSED_H, P=FUSED_P):
    """K3's inputs (q, k, v, key_map, pinyin_map), f32 on the device: q
    scaled by H ** -0.5, k and v unit normal. ``synthetic`` (phase 3):
    key_map random in 0-3 with its first token 1, row (0, 3) all-masked,
    pinyin_map 1 1 2 2 3 3 0 0; ``text``: the text path's layout
    (text_layout, from a numpy seed drawn from gen)."""
    q = torch.randn((B, T, H), generator=gen, device=device) * (1.0 / math.sqrt(H))
    k = torch.randn((B, T, L, H), generator=gen, device=device)
    v = torch.randn((B, T, L, H), generator=gen, device=device)
    if layout == "text":
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen, device=device).item())
        km, pm = (torch.from_numpy(a).to(device) for a in text_layout(np.random.RandomState(seed), B, T, L, P))
    else:
        km = torch.randint(0, 4, (B, T, L), generator=gen, device=device, dtype=torch.int32)
        km[:, :, 0] = 1
        km[0, 3] = 0  # an all-masked row
        pm = torch.tensor([1, 1, 2, 2, 3, 3, 0, 0], device=device, dtype=torch.int32)[:P].expand(B, T, P).contiguous()
    return q, k, v, km, pm


def mask_shares(km):
    """(share of masked gloss tokens, share of all-masked rows) of a key_map."""
    masked = km == 0
    return masked.float().mean().item(), masked.all(dim=-1).float().mean().item()


def fused_bound(N, L, H, P):
    """K3's least time for N rows: (ms, 'bytes' or 'operations', bytes),
    each input read once and each output written once."""
    n_bytes = 4 * (N * H + 2 * N * L * H + N * L + N * P  # in: q, k, v, key_map, pinyin_map
                   + N * H + N * L + N * P)  # out: ctx, w, pron
    return (*bound(n_bytes, 4.0 * N * L * H + 2.0 * N * L * P, "float32"), n_bytes)


def check_bank_case(args, g_ctx, g_w, label, smi, bwd=True):
    """K1 (and K2) against their plain versions on one case, then timed
    (L2 flushed before each call) beside the byte bound. Returns the
    case's record."""
    from dicttts_tpu_torch.ops.s2pa_bank import (_bwd, _fwd, bank_slot_chunks, s2pa_bank_bwd_plain,
                                                 s2pa_bank_fwd_plain, slot_order)

    bank, wt, qe, km, mask = args
    dtype, (N, L) = bank.dtype, km.shape
    slots = slot_order(wt)
    n_chunks = bank_slot_chunks(slots[0])[0].numel()
    ctx, w = _fwd(*args, slots)
    torch.cuda.synchronize()
    ctx_p, w_p = s2pa_bank_fwd_plain(*args)
    err_w = (w - w_p).abs().max().item()
    err_c = (ctx.float() - ctx_p.float()).abs().max().item()
    # f32: the JAX package's own tolerances. bf16: w as f32; ctx to two bf16
    # ulps of its largest value (output and w*mask are rounded to bf16, so a
    # last-bit difference in an f32 sum can flip a rounding)
    tol_c = 2e-5 if dtype == torch.float32 else 2 ** -7 * ctx_p.float().abs().max().item()
    uniform = abs(w[7, 0].item() - 1 / L)
    say(f"K1 {label}: max|dw|={err_w:.3e} (tol 2e-6) max|dctx|={err_c:.3e} (tol {tol_c:.3e}); "
        f"all-masked row uniform: {uniform:.1e}")
    if not (err_w <= 2e-6 and err_c <= tol_c and uniform < 1e-7):
        raise AssertionError(f"K1 {label} disagrees with its plain version")
    if not (torch.isfinite(ctx.float()).all() and torch.isfinite(w).all()):
        raise AssertionError(f"K1 {label} produced non-finite values")
    del ctx_p, w_p
    rec = {"case": label, "dtype": str(dtype).replace("torch.", ""), "N": N,
           "distinct_rows": torch.unique(wt).numel(), "chunks": n_chunks}
    k1 = {"max_abs_err": max(err_w, err_c),
          "ms": time_ms_cold(lambda: _fwd(*args, slots)),
          "sort_ms": device_ms(lambda: slot_order(wt)),
          "plain_ms": time_ms_cold(lambda: s2pa_bank_fwd_plain(*args), iters=5)}
    k1["bound_ms"], k1["bound_by"], n_bytes, _ = bank_bound(args, bwd=False)
    say(f"K1 {label}: kernel {k1['ms']:.4f} ms (+ slot order {k1['sort_ms']:.4f} ms of device time), plain "
        f"{k1['plain_ms']:.4f} ms, bound {k1['bound_ms']:.4f} ms ({k1['bound_by']}; "
        f"{n_bytes / 1e6:.1f} MB; {rec['distinct_rows']} distinct rows, {n_chunks} chunks of "
        f"{N} slots), {100 * k1['bound_ms'] / k1['ms']:.1f} % of the bound; on {smi}")
    rec["k1"] = k1
    if not bwd:
        return rec
    d_qe = _bwd(*args, g_ctx, g_w, slots)
    torch.cuda.synchronize()
    ref = s2pa_bank_bwd_plain(*args, g_ctx, g_w).float()
    err = (d_qe.float() - ref).abs().max().item()
    scale = ref.abs().max().item()
    # f32: summation order only; bf16: d_logits and d_qe are rounded to bf16,
    # so a last-bit difference in an f32 sum can flip a rounding (two ulps)
    tol = 2e-5 * scale if dtype == torch.float32 else 2 ** -7 * scale
    masked_row = d_qe[7].float().abs().max().item()
    say(f"K2 {label}: max|d d_qe|={err:.3e} (tol {tol:.3e}, max|d_qe| {scale:.3e}); "
        f"all-masked slot max|d_qe| {masked_row:.1e} (must be 0)")
    if not (err <= tol and masked_row == 0.0 and torch.isfinite(d_qe.float()).all()):
        raise AssertionError(f"K2 {label} disagrees with its plain version")
    again = _bwd(*args, g_ctx, g_w, slots)
    if not torch.equal(again, d_qe) or not torch.equal(_fwd(*args, slots)[0], ctx):
        raise AssertionError(f"K1/K2 {label}: two launches differ")
    del ref, again
    k2 = {"max_abs_err": err,
          "ms": time_ms_cold(lambda: _bwd(*args, g_ctx, g_w, slots)),
          "plain_ms": time_ms_cold(lambda: s2pa_bank_bwd_plain(*args, g_ctx, g_w), iters=5)}
    k2["bound_ms"], k2["bound_by"], n_bytes, _ = bank_bound(args, bwd=True)
    say(f"K2 {label}: kernel {k2['ms']:.4f} ms, plain {k2['plain_ms']:.4f} ms, bound "
        f"{k2['bound_ms']:.4f} ms ({k2['bound_by']}; {n_bytes / 1e6:.1f} MB), "
        f"{100 * k2['bound_ms'] / k2['ms']:.1f} % of the bound; on {smi}")
    rec["k2"] = k2
    return rec


def k3_case(args, label, smi):
    """K3 alone on one call's own inputs: against its plain version (and
    every output finite), its device time with L2 flushed before each call
    (torch.profiler: the wrapper's host time exceeds the kernel's, and the
    text path's inputs fit in the 50 MB L2) by kernel name, CUDA events
    around each call after the flush (they count the wrapper's host time)
    and around 20 back-to-back calls, the plain version's time, the byte
    bound and the kernel's plan."""
    from dicttts_tpu_torch.ops.s2pa_fused import fused_kernel_plan, s2pa_fused, s2pa_fused_plain

    (B, T, H), L, P = args[0].shape, args[1].shape[2], args[4].shape[2]
    out = s2pa_fused(*args)
    ref = s2pa_fused_plain(*args)
    err = torch.stack([(x - y).abs().max() for x, y in zip(out, ref)]).max().item()  # NaN propagates
    finite = all(bool(torch.isfinite(o).all()) for o in out)
    by_kernel = device_kernel_ms(lambda: s2pa_fused(*args), cold=True)
    ms = sum(by_kernel.values())
    cold_event_ms = time_ms_cold(lambda: s2pa_fused(*args))
    plain_ms = device_ms(lambda: s2pa_fused_plain(*args), cold=True)
    event_ms = time_ms(lambda: s2pa_fused(*args))
    bound_ms, bound_by, n_bytes = fused_bound(B * T, L, H, P)
    plan = fused_kernel_plan(B * T, L, H, P)
    masked, empty = mask_shares(args[3])
    case = f"{label} B={B} Tw={T} L={L} H={H} P={P}"
    kernels = "; ".join(f"{k[:48]} {v:.4f}" for k, v in by_kernel.items())
    say(f"K3 at {case}: max abs err {err:.3e} (tol 1e-5), outputs finite {finite}, kernel {ms:.4f} ms of "
        f"device time with L2 flushed [{kernels}] (events around each call after the flush: "
        f"{cold_event_ms:.4f} ms; around back-to-back calls: {event_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}; {n_bytes / 1e6:.2f} MB), {100 * bound_ms / ms:.1f} % of the bound; masked "
        f"gloss tokens {100 * masked:.1f} %, all-masked rows {100 * empty:.1f} %; plan {json.dumps(plan)}; on {smi}")
    if not (err <= 1e-5 and finite):
        raise AssertionError(f"K3 disagrees with its plain version at {case}")
    return {"case": case, "max_abs_err": err, "ms": ms, "kernels_ms": by_kernel,
            "cold_event_ms": cold_event_ms, "event_ms": event_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "masked_shares": [masked, empty], "plan": plan}


def check_bank_autograd(args):
    """K1 + K2 through the autograd function against autograd through K1's
    plain version: loss = sum(ctx^2) + sum(sin(w))."""
    from dicttts_tpu_torch.ops.s2pa_bank import s2pa_bank_attend, s2pa_bank_fwd_plain

    bank, wt, qe, km, mask = args
    grads = []
    for fwd in (s2pa_bank_attend, s2pa_bank_fwd_plain):
        q = qe.detach().clone().requires_grad_(True)
        ctx, w = fwd(bank, wt, q, km, mask)
        ((ctx.float() ** 2).sum() + torch.sin(w).sum()).backward()
        grads.append(q.grad.float())
    torch.cuda.synchronize()
    err = (grads[0] - grads[1]).abs().max().item()
    tol = 2e-4 * grads[1].abs().max().item()
    say(f"autograd K1+K2 vs autograd through the plain forward: max|d grad|={err:.3e} "
        f"(tol {tol:.3e}: 2e-4 of the largest, the JAX package's rtol for this backward)")
    if not err <= tol:
        raise AssertionError("the K1+K2 autograd function disagrees with the plain gradient")


def make_train_batches(rng, n, B, Tw, T, V):
    """Collater-format batches: BOS, words of 4-12 frames, EOS, until Tw
    words or T frames; log-mel-like values, zero past mel_lengths."""
    out = []
    for _ in range(n):
        wt = np.zeros((B, Tw), np.int32)
        m2w = np.zeros((B, T), np.int32)
        wl = np.zeros(B, np.int32)
        for b in range(B):
            f = w = 0
            while w < Tw and f < T:
                d = min(rng.randint(4, 13), T - f)
                m2w[b, f:f + d] = w + 1
                f, w = f + d, w + 1
            wt[b, :w] = np.concatenate([[1], rng.randint(3, V, w - 1)])
            wt[b, w - 1] = 2
            wl[b] = w
        lengths = (m2w > 0).sum(1).astype(np.int32)
        mels = (rng.randn(B, T, 80) * 1.5 - 4.0).astype(np.float32) * (m2w > 0)[:, :, None]
        pron = np.where(rng.rand(B, Tw) < 0.1, rng.randint(1, 3, (B, Tw)), 0).astype(np.int32) * (wt > 2)
        out.append({"word_tokens": wt, "pron_modified": pron, "mel2word": m2w, "mels": mels,
                    "word_lengths": wl, "mel_lengths": lengths})
    return out


def param_snapshot(task):
    return [p.detach().clone() for p in (*task.model.parameters(), *task.disc.parameters())]


def train_full_width(device, bank, gen_seed, k1_ms, k2_ms, smi):
    """Phase 7: the recipe's train step at production width; returns the
    median step ms and the K1 / K2 launch counts of the timed steps."""
    from dicttts_tpu_torch.ops.s2pa_bank import s2pa_bank_bwd, s2pa_bank_fwd
    from dicttts_tpu_torch.ops.s2pa_fused import s2pa_fused
    from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask

    task = DictTTSTask(bank=bank, device=device)  # the recipe, dropout 0.1 / 0.2 / 0.25 on
    task.build_state(SEED)
    rng = np.random.RandomState(SEED)
    batches = [task.to_device(b) for b in make_train_batches(rng, 4, TRAIN_B, TRAIN_TW, TRAIN_T, BANK_V)]
    frames = [int(b["mel_lengths"].sum()) for b in batches]
    n_params = (sum(p.numel() for p in task.model.parameters()), sum(p.numel() for p in task.disc.parameters()))
    say(f"generator {n_params[0]} params, discriminator {n_params[1]}; real frames per batch {frames}")
    before = param_snapshot(task)
    n_g = len(list(task.model.parameters()))

    def step_gen(i):
        return torch.Generator(device=device).manual_seed(gen_seed + i)

    for i in range(TRAIN_WARMUP):
        task.train_step(batches[i % len(batches)], step_gen(i))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s2pa_bank_fwd.launches = s2pa_bank_bwd.launches = s2pa_fused.launches = 0
    times, history = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = task.train_step(batches[i % len(batches)], step_gen(TRAIN_WARMUP + i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        history.append(m)
    launches = (s2pa_bank_fwd.launches, s2pa_bank_bwd.launches, s2pa_fused.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    keys = list(history[0])
    if any(list(m) != keys for m in history):
        raise AssertionError("a training step skipped an update (non-finite loss)")
    vals = {k: np.array([float(m[k]) for m in history]) for k in keys}
    bad = [k for k, v in vals.items() if not np.isfinite(v).all()]
    if bad:
        raise AssertionError(f"non-finite training losses: {bad}")
    after = param_snapshot(task)
    changed_g = any(not torch.equal(a, b) for a, b in zip(before[:n_g], after[:n_g]))
    changed_d = any(not torch.equal(a, b) for a, b in zip(before[n_g:], after[n_g:]))
    if not (changed_g and changed_d):
        raise AssertionError(f"parameters did not change: generator {changed_g}, disc {changed_d}")
    med = float(np.median(times))
    say(f"train step ms (host clock after synchronize, {TRAIN_STEPS} steps): median {med:.2f}, "
        f"mean {np.mean(times):.2f}, min {min(times):.2f}, max {max(times):.2f}; "
        f"peak memory {peak:.2f} GiB; on {smi}")
    say("per-step ms " + " ".join(f"{t:.1f}" for t in times))
    say("losses, first -> last timed step: " + ", ".join(
        f"{k} {v[0]:.4f} -> {v[-1]:.4f}" for k, v in vals.items()))
    say(f"K1 with its slot order + K2 (bf16, corpus-like ids, isolated, phase 6): {k1_ms:.4f} + "
        f"{k2_ms:.4f} ms = {100 * (k1_ms + k2_ms) / med:.2f} % of the median step, on {smi}")
    say(f"launches in {TRAIN_STEPS} timed steps: K1 {launches[0]}, K2 {launches[1]}, K3 {launches[2]}")
    if launches != (TRAIN_STEPS, TRAIN_STEPS, 0):
        raise AssertionError(f"expected K1 and K2 once per step and no K3, got {launches}")
    profile_steps(task, batches, step_gen, smi)
    # the same steps with cuDNN autotuning its convolution algorithms, for
    # comparison only: the rest of the run keeps cuDNN's default heuristics
    torch.backends.cudnn.benchmark = True
    for i in range(TRAIN_WARMUP):
        task.train_step(batches[i % len(batches)], step_gen(2000 + i))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tuned = []
    for i in range(5):
        t = time.perf_counter()
        task.train_step(batches[i % len(batches)], step_gen(2100 + i))
        torch.cuda.synchronize()
        tuned.append((time.perf_counter() - t) * 1e3)
    torch.backends.cudnn.benchmark = False
    say(f"with cudnn.benchmark=True (comparison only): median step {np.median(tuned):.2f} ms over 5 "
        f"steps, peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; on {smi}")
    return med, launches[0], launches[1]


def profile_steps(task, batches, step_gen, smi, n=3):
    """Where a step's device time goes: torch.profiler over n more steps,
    the top kernels by device time and the device's busy share of the wall
    clock. Reports, and does not fail, if the profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        t = time.perf_counter()
        for i in range(n):
            task.train_step(batches[i % len(batches)], step_gen(1000 + i))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = [e for e in prof.key_averages()  # the kernels themselves, not the ops that launch them
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        say("profiler: no device time recorded (device idle share not measured)")
        return
    say(f"profiler over {n} steps ({wall_ms:.1f} ms wall, profiled): device busy {busy_ms:.1f} ms, "
        f"idle share {100 * (1 - busy_ms / wall_ms):.1f} %, {sum(e.count for e in events)} device "
        f"op records; on {smi}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        say(f"  {e.self_device_time_total / 1e3 / n:9.2f} ms/step {e.count // n:6d} x  {e.key[:110]}")
    conv_ops = ("aten::cudnn_convolution", "aten::cudnn_convolution_transpose",
                "aten::convolution_backward")
    convs = [e for e in prof.key_averages(group_by_input_shape=True)
             if e.key in conv_ops and e.device_time_total > 0]
    say("convolutions and their backward by input shape (device time of their kernels):")
    for e in sorted(convs, key=lambda e: -e.device_time_total)[:8]:
        say(f"  {e.device_time_total / 1e3 / n:9.2f} ms/step {e.count // n:4d} x  {e.key} "
            f"{str(e.input_shapes)[:120]}")


def trainer_resume(device, bank):
    """Phase 7b: fit 2 steps (a checkpoint each), resume at step 2 and check
    the parameters are the saved ones, then fit on to step 3."""
    from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask
    from dicttts_tpu_torch.train.trainer import Trainer
    from dicttts_tpu_torch.utils.checkpoint import get_all_ckpts

    batches = make_train_batches(np.random.RandomState(SEED + 1), 2, TRAIN_B, TRAIN_TW, TRAIN_T, BANK_V)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as work_dir:
        task = DictTTSTask(bank=bank, device=device)
        trainer = Trainer(work_dir, max_updates=2, val_check_interval=1, num_ckpt_keep=2, device=device)
        trainer.fit(task, batches, batches[:1])
        names = [os.path.basename(p) for p in get_all_ckpts(work_dir)]
        saved = param_snapshot(task)
        say(f"fit to step {trainer.global_step}: checkpoints {names}, "
            f"val total_loss {trainer.val_metrics.get('total_loss', float('nan')):.4f}")
        if names != ["model_ckpt_steps_2.ckpt", "model_ckpt_steps_1.ckpt"] or task.step != 2:
            raise AssertionError(f"unexpected checkpoints {names} at step {task.step}")
        if not all(math.isfinite(v) for v in trainer.val_metrics.values()):
            raise AssertionError(f"non-finite validation losses {trainer.val_metrics}")
        resumed = DictTTSTask(bank=bank, device=device)
        t2 = Trainer(work_dir, max_updates=2, device=device)
        t2.fit(resumed, batches)
        same = all(torch.equal(a, b) for a, b in zip(saved, param_snapshot(resumed)))
        if not (t2.global_step == 2 and resumed.step == 2 and same):
            raise AssertionError("resume did not restore step 2's parameters")
        t3 = Trainer(work_dir, max_updates=3, num_ckpt_keep=2, device=device)
        t3.fit(resumed, batches)
        names = [os.path.basename(p) for p in get_all_ckpts(work_dir)]
        moved = any(not torch.equal(a, b) for a, b in zip(saved, param_snapshot(resumed)))
        finite = all(bool(torch.isfinite(p).all()) for p in param_snapshot(resumed))
        say(f"resumed at step 2 with the saved parameters, fit on to step {t3.global_step}: "
            f"checkpoints {names}, parameters moved {moved}")
        if not (t3.global_step == 3 and resumed.step == 3 and moved and finite
                and names[0] == "model_ckpt_steps_3.ckpt"):
            raise AssertionError("the resumed run did not continue")
    if os.path.exists(work_dir):
        raise AssertionError(f"{work_dir} was not removed")


def crop_starts(u, lengths, T):
    """Crop starts as the discriminator draws them, for given uniforms."""
    max_len = int(np.max(lengths))
    return torch.tensor([min(int(np.floor(ui * (max(max_len - w, 0) + 1))), max(T - w, 0))
                         for ui, w in zip(u, (32, 64, 128))])


def train_step_card_vs_cpu(device, bank):
    """Phase 7c: one step at full width from the same weights on the card
    and on the CPU (plain versions), dropout 0, pinned noise and crops."""
    from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask

    cfg = {"dropout": 0.0, "predictor_dropout": 0.0, "disc_dropout": 0.0}
    card = DictTTSTask(cfg, bank=bank, device=device)
    card.build_state(SEED + 2)
    cpu = DictTTSTask(cfg, bank={k: v.cpu() for k, v in bank.items()}, device="cpu")
    cpu.build_state(SEED + 2)
    cpu.model.load_state_dict(card.model.state_dict())
    cpu.disc.load_state_dict(card.disc.state_dict())
    B, Tw, T = 2, 16, 128
    rng = np.random.RandomState(SEED + 3)
    batch = make_train_batches(rng, 1, B, Tw, T, BANK_V)[0]
    eps = torch.tensor(rng.randn(B, T // 4, 16).astype(np.float32))
    sg = crop_starts(rng.rand(3), batch["mel_lengths"], T)
    sd = crop_starts(rng.rand(3), batch["mel_lengths"], T)
    out = {}
    for name, task in (("card", card), ("cpu", cpu)):
        dev = task.device
        t = time.perf_counter()
        m = task.train_step(task.to_device(batch), eps=eps.to(dev), start_frames_g=sg.to(dev),
                            start_frames_d=sd.to(dev))
        out[name] = {k: float(v) for k, v in m.items()}
        say(f"{name}: one step {(time.perf_counter() - t) * 1e3:.1f} ms")
    rtol = 2e-3  # TF32 off; the bf16 bank kernels and their plain versions may round a
    # value differently, and summation orders differ through the whole model
    worst = 0.0
    for k, ref in out["cpu"].items():
        got = out["card"][k]
        rel = abs(got - ref) / max(abs(ref), 1e-6)
        worst = max(worst, rel)
        say(f"  {k}: card {got:.6f} cpu {ref:.6f} rel {rel:.2e}")
    say(f"card vs CPU: worst relative difference {worst:.2e} (tol {rtol:.0e}) over "
        f"{len(out['cpu'])} losses and gradient norms")
    if set(out["card"]) != set(out["cpu"]) or worst > rtol:
        raise AssertionError("card and CPU train steps disagree")


def make_requests(rng, n_req, tw, gathered_from=None):
    from dicttts_tpu_torch.serve import Request

    reqs = []
    for _ in range(n_req):
        ids = np.concatenate([[1], rng.randint(3, BANK_V, tw - 2), [2]]).astype(np.int32)
        pron = np.where(rng.rand(tw) < 0.1, rng.randint(1, 3, tw), 0).astype(np.int32)
        pron[[0, -1]] = 0
        bank = None
        if gathered_from is not None:  # per-utterance rows, as infer.py::_collate gets them
            idx = torch.as_tensor(ids, device=gathered_from["keys"].device).long()
            bank = {k: v[idx] for k, v in gathered_from.items()}
            bank["keys"] = bank["keys"].float()
        reqs.append(Request(ids, pron, bank))
    return reqs


def check_results(results, hop):
    for r in results:
        if r.n_frames <= 0 or r.wav.shape != (r.n_frames * hop,):
            raise AssertionError(f"wav of {r.wav.shape} for {r.n_frames} frames")
        if not (np.isfinite(r.wav).all() and np.isfinite(r.mel).all()):
            raise AssertionError("non-finite wav or mel")
        if np.abs(r.wav).max() < 1e-4:
            raise AssertionError("silent wav")


def synthetic_corpus(binary, rng):
    """A corpus in the binarizer's format with the repo corpus's statistics,
    for a checkout without .prod_corpus: 324/18/18 utterances of 214-574
    frames and 22-58 words (one character each, between <BOS> and <EOS>),
    a vocabulary of 7998 words and 166 pinyin tokens, log-mel-like values,
    phone alignments and an f0 glide."""
    from dicttts_tpu_torch.utils.indexed_dataset import IndexedDatasetBuilder
    from dicttts_tpu_torch.utils.text_encoder import TokenTextEncoder

    chars = [chr(0x4E00 + i) for i in range(7996)]
    with open(os.path.join(binary, "word_set.json"), "w") as f:
        json.dump(["<BOS>", "<EOS>", *chars], f)
    with open(os.path.join(binary, "phone_set.json"), "w") as f:
        json.dump(["#", "<BOS>", "<EOS>", *(f"ph{i}" for i in range(164))], f)
    with open(os.path.join(binary, "pinyin_encoder.pkl"), "wb") as f:
        pickle.dump(["<pad>", "<UNK>", "", *(f"py{i}" for i in range(163))], f)
    with open(os.path.join(binary, "spk_map.json"), "w") as f:
        json.dump({"<SINGLE_SPK>": 0}, f)
    words = TokenTextEncoder.from_json(os.path.join(binary, "word_set.json"))
    n_item = 0
    for split, n in CORPUS_SPLITS.items():
        lengths = []
        with IndexedDatasetBuilder(os.path.join(binary, split)) as b:
            for _ in range(n):
                T, n_words = rng.randint(214, 575), rng.randint(22, 59)
                text = "".join(chars[j] for j in rng.randint(0, len(chars), n_words - 2))
                ws = ["<BOS>", *text, "<EOS>"]
                dur = np.concatenate([[5], 1 + rng.multinomial(T - 29 - (n_words - 2),
                                                               np.full(n_words - 2, 1 / (n_words - 2))),
                                      [24]])
                mel2word = np.repeat(np.arange(1, n_words + 1), dur)
                ph2word = np.concatenate([[1], np.repeat(np.arange(2, n_words), 2), [n_words]])
                # each word's frames split evenly over its phones; an f0 glide, the first word unvoiced
                first_ph = np.searchsorted(ph2word, np.arange(1, n_words + 1))
                n_ph = np.bincount(ph2word, minlength=n_words + 1)[1:]
                pos = np.arange(T) - np.repeat(np.cumsum(dur) - dur, dur)
                mel2ph = 1 + first_ph[mel2word - 1] + pos * n_ph[mel2word - 1] // dur[mel2word - 1]
                f0 = np.where(mel2word > 1, np.linspace(120.0, 200.0, T), 0.0)
                b.add_item({
                    "item_name": f"s{n_item:04d}", "txt": text, "ph": "", "spk_id": 0,
                    "phone": rng.randint(3, 167, len(ph2word)).tolist(),
                    "mel": (rng.randn(T, 80) * 0.8 - 4.5).astype(np.float32),
                    "words": ws, "word_tokens": [words.token_to_id[w] for w in ws],
                    "ph2word": ph2word, "mel2word": mel2word, "mel2ph": mel2ph,
                    "f0": f0.astype(np.float32), "pron_modified": np.zeros(n_words, np.int64)})
                lengths.append(T)
                n_item += 1
        np.save(os.path.join(binary, f"{split}_lengths.npy"), np.array(lengths))


def standin_bank(binary, rng):
    """dict_embed in the binarizer's format, written from the seed: an entry
    for every word id, gloss keys of 1-56 tokens (mean ~19, as the
    corpus's 494 MB file has; so L buckets to 64) by 768 in float16, 1-3
    senses over contiguous gloss tokens, two pinyin tokens a sense drawn
    from pinyin_encoder.pkl, and the value: the key itself, as in the
    corpus's file (one array, pickled once). Only what device_bank and the
    gathered banks read."""
    from dicttts_tpu_torch.utils.indexed_dataset import IndexedDatasetBuilder

    with open(os.path.join(binary, "pinyin_encoder.pkl"), "rb") as f:
        pinyin = pickle.load(f)
    V = BANK_V
    lens = np.floor(rng.triangular(1, 1, 57, V)).astype(int)
    lens[5] = 56
    keys = rng.randn(int(lens.sum()), BANK_E).astype(np.float16)
    offsets = np.concatenate([[0], np.cumsum(lens)])
    with IndexedDatasetBuilder(os.path.join(binary, "dict_embed")) as b:
        for i in range(V):
            n, ns = lens[i], rng.randint(1, 4)
            key = keys[offsets[i]:offsets[i + 1]]
            b.add_item({"key": key, "value": key,
                        "key_map": np.arange(n) * ns // n + 1,
                        "pinyin": [pinyin[j] for j in rng.randint(2, len(pinyin), 2 * ns)],
                        "pinyin_map": np.repeat(np.arange(1, ns + 1), 2)})
    return lens


def link_corpus(binary, rng):
    """Link the repo's splits into ``binary``, or write a synthetic corpus
    where the checkout has none. Returns "repo" or "synthetic"."""
    src = os.path.join(REPO, ".prod_corpus", "binary")
    if os.path.exists(os.path.join(src, "train.idx")):
        for name in (*CORPUS_FILES, *(f"{s}{ext}" for s in CORPUS_SPLITS
                                      for ext in (".data", ".idx", "_lengths.npy"))):
            os.symlink(os.path.join(src, name), os.path.join(binary, name))
        return "repo"
    synthetic_corpus(binary, rng)
    return "synthetic"


def prepare_corpus(binary, rng):
    """``link_corpus``, then the stand-in bank. Returns "repo" or "synthetic"."""
    corpus = link_corpus(binary, rng)
    lens = standin_bank(binary, rng)
    where = ("the repo's .prod_corpus/binary splits" if corpus == "repo"
             else "written from the seed: the checkout has no .prod_corpus/binary")
    say(f"corpus: {corpus} ({where}); stand-in dict_embed from seed {SEED}: {BANK_V} entries, gloss "
        f"tokens {lens.min()}-{lens.max()} (mean {lens.mean():.1f}), "
        f"{os.path.getsize(os.path.join(binary, 'dict_embed.data')) / 1e6:.0f} MB")
    return corpus


def step_report(history, label, smi):
    """Step ms by batch shape (sentences x mel frames): the shape's first
    step, which meets new shapes in cuDNN and the allocator, apart from its
    repeats; the median of the repeats by mel bucket; the host's wait."""
    by_shape = {}
    for h in history:
        by_shape.setdefault((h["frames"], h["sentences"]), []).append(h["step_ms"])
    for (frames, b), ms in sorted(by_shape.items()):
        say(f"{label} {b} x {frames} frames: {len(ms)} steps, ms " + " ".join(f"{t:.1f}" for t in ms)
            + f"; on {smi}")
    buckets = {}
    for (frames, b), ms in by_shape.items():
        buckets.setdefault(frames, []).extend(ms[1:])
    for frames, later in sorted(buckets.items()):
        if later:
            say(f"{label} bucket {frames} frames: median {statistics.median(later):.2f} ms over the "
                f"{len(later)} repeated shapes' steps; on {smi}")
    waits = [h["wait_ms"] for h in history]
    say(f"{label} host wait for the next batch (prefetch queue): median {statistics.median(waits):.3f} ms, "
        f"max {max(waits):.3f} ms, first {waits[0]:.3f} ms over {len(waits)} steps")
    return {"step_ms": {f"{b}x{frames}": ms for (frames, b), ms in sorted(by_shape.items())},
            "wait_ms": waits}


def recipe_bank_case(task, gen):
    """K1/K2 inputs at the recipe path's shapes: the task's bank and the
    word ids of the corpus's first train batch, one all-masked slot."""
    batch = next(iter(task.data.train_batches()))
    wt = torch.as_tensor(batch["word_tokens"], device="cuda").flatten()
    bank = task.bank["keys"]
    N, L, E = wt.shape[0], bank.shape[1], bank.shape[2]
    qe = (torch.randn((N, E), generator=gen, device="cuda") * (3.0 / math.sqrt(E))).to(bank.dtype)
    km = task.bank["key_map"][wt.long()].clone()
    km[7] = 0  # an all-masked slot: uniform weights, zero gradient
    mask = (torch.rand((N, L), generator=gen, device="cuda") >= 0.1).float() / 0.9
    g_ctx = torch.randn((N, E), generator=gen, device="cuda").to(bank.dtype)
    g_w = torch.randn((N, L), generator=gen, device="cuda")
    return (bank, wt, qe, km, mask), g_ctx, g_w, tuple(batch["word_tokens"].shape)


@contextlib.contextmanager
def in_dir(path):
    """Run in ``path`` (run.py's work_dir is checkpoints/<exp_name> under the
    current directory), then return to where we were."""
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(cwd)


def recipe_entry_point(gen, smi, root):
    """Phase 8: train, resume and infer through dicttts_tpu_torch.run.main on
    the corpus, in ``root``. Returns (corpus, launches by run, the K1/K2 case
    at the recipe's shapes, the report)."""
    from dicttts_tpu_torch import run
    from dicttts_tpu_torch.ops.s2pa_bank import s2pa_bank_bwd, s2pa_bank_fwd
    from dicttts_tpu_torch.ops.s2pa_fused import s2pa_fused
    from dicttts_tpu_torch.utils.checkpoint import BEST, get_all_ckpts

    def counts():
        return s2pa_bank_fwd.launches, s2pa_bank_bwd.launches, s2pa_fused.launches

    report, launches = {}, {}
    binary = os.path.join(root, "binary")
    os.makedirs(binary)
    t = time.time()
    corpus = prepare_corpus(binary, np.random.RandomState(SEED))
    say(f"corpus ready in {time.time() - t:.1f} s")
    base = ["--config", os.path.join(REPO, RECIPE_CONFIG), "--exp_name", "recipe", "--device", "cuda"]
    work_dir = os.path.join(root, "checkpoints", "recipe")
    with in_dir(root):
        hp = (f"binary_data_dir={binary},max_updates={RECIPE_STEPS},"
              f"val_check_interval={RECIPE_STEPS // 2},num_sanity_val_steps=1")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s2pa_bank_fwd.launches = s2pa_bank_bwd.launches = s2pa_fused.launches = 0
        t = time.time()
        trainer, task = run.main(base + ["--hparams", hp])
        torch.cuda.synchronize()
        launches["recipe_train"] = counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        say(f"run.main trained {trainer.global_step} steps in {time.time() - t:.1f} s (the bank's and "
            f"the cache's build, validations and checkpoints included); peak memory {peak:.2f} GiB; on {smi}")
        c = task.cfg
        say(f"recipe widths: hidden {c['hidden_size']}, dict_embed_dim {c['dict_embed_dim']}, word_size "
            f"{c['word_size']}, value_embedding_size {c['value_embedding_size']}, max_tokens {c['max_tokens']}, "
            f"max_sentences {c['max_sentences']}, mel_buckets {c['mel_buckets']}, frame cache "
            f"{c['use_device_frame_cache']}, bank {tuple(task.bank['keys'].shape)} {task.bank['keys'].dtype}")
        for name, u in task.uploads.items():
            say(f"{name}: {u['bytes']} bytes ({u['bytes'] / 1e6:.1f} MB), built on the host in "
                f"{u['build_s']:.2f} s, uploaded in {u['upload_s']:.3f} s; on {smi}")
        report = {"corpus": corpus, "peak_gib": peak, "uploads": task.uploads,
                  "train": step_report(trainer.history, "train", smi)}
        vals = {k: float(v) for k, v in trainer.metrics.items()}
        say(f"last step: {vals}; validation: {trainer.val_metrics}")
        finite = all(math.isfinite(v) for v in (*vals.values(), *trainer.val_metrics.values()))
        finite = finite and all(bool(torch.isfinite(p).all()) for p in task.model.parameters())
        names = [os.path.basename(p) for p in get_all_ckpts(work_dir)]
        say(f"launches in the run (K1, K2, K3): {launches['recipe_train']}; checkpoints {names}, "
            f"best {os.path.exists(os.path.join(work_dir, BEST))}")
        if not (trainer.global_step == RECIPE_STEPS and finite and "grad_norm_g" in vals):
            raise AssertionError(f"the recipe's run did not train {RECIPE_STEPS} finite steps")
        want = [f"model_ckpt_steps_{RECIPE_STEPS}.ckpt", f"model_ckpt_steps_{RECIPE_STEPS // 2}.ckpt"]
        if names[:2] != want or not os.path.exists(os.path.join(work_dir, BEST)):
            raise AssertionError(f"missing checkpoints: {names}")
        k1, k2, k3 = launches["recipe_train"]
        if not (k2 == RECIPE_STEPS and k1 > RECIPE_STEPS and k3 == 0):
            raise AssertionError(f"K1/K2 not launched every step (K1 {k1}, K2 {k2}, K3 {k3})")
        args, g_ctx, g_w, shape = recipe_bank_case(task, gen)
        del trainer, task
        torch.cuda.empty_cache()

        s2pa_bank_fwd.launches = s2pa_bank_bwd.launches = s2pa_fused.launches = 0
        trainer, task = run.main(base + ["--hparams", f"max_updates={RECIPE_STEPS + RESUME_STEPS}"])
        torch.cuda.synchronize()
        launches["recipe_resume"] = counts()
        names = [os.path.basename(p) for p in get_all_ckpts(work_dir)]
        say(f"resumed at step {RECIPE_STEPS}, trained to {trainer.global_step}: checkpoints {names}, "
            f"launches (K1, K2, K3) {launches['recipe_resume']}")
        report["resume"] = step_report(trainer.history, "resume", smi)
        if not ([h["step"] for h in trainer.history] == [RECIPE_STEPS + 1, RECIPE_STEPS + 2]
                and names[0] == f"model_ckpt_steps_{RECIPE_STEPS + RESUME_STEPS}.ckpt"
                and launches["recipe_resume"][1] == RESUME_STEPS):
            raise AssertionError("the resumed run did not continue from its checkpoint")
        del trainer, task

        s2pa_bank_fwd.launches = s2pa_bank_bwd.launches = s2pa_fused.launches = 0
        trainer, task = run.main(base + ["--infer"])
        torch.cuda.synchronize()
        launches["recipe_infer"] = counts()
        n_test = CORPUS_SPLITS["test"]
        report["test_ms_per_utterance"] = trainer.test_seconds / n_test * 1e3
        say(f"--infer: {n_test} test utterances in {trainer.test_seconds:.2f} s, "
            f"{report['test_ms_per_utterance']:.2f} ms per utterance (batches of 1, max_frames "
            f"{task.cfg['max_frames']}, mel and meta.csv writes included); launches (K1, K2, K3) "
            f"{launches['recipe_infer']}; on {smi}")
        check_meta(os.path.join(work_dir, "generated"), binary, n_test)
        if launches["recipe_infer"] != (n_test, 0, 0):
            raise AssertionError(f"--infer launched {launches['recipe_infer']}, not K1 once a batch")
        del trainer, task
    torch.cuda.empty_cache()
    return corpus, launches, (args, g_ctx, g_w, shape), report


def check_meta(gen_dir, binary, n_test):
    """meta.csv: the JAX layout, a row per test utterance, two pinyin
    tokens per character; a mel file per row."""
    from dicttts_tpu_torch.utils.indexed_dataset import IndexedDataset

    with open(os.path.join(gen_dir, "meta.csv"), newline="") as f:
        rows = list(csv.reader(f))
    with IndexedDataset(os.path.join(binary, "test")) as ds:
        n_words = {ds[i]["item_name"]: len(ds[i]["word_tokens"]) for i in range(len(ds))}
    header = ["", "item_name", "text", "pinyin_tokens", "wav_fn_pred", "wav_fn_gt"]
    bad = [r[1] for r in rows[1:] if len(r) != 6 or not r[3]
           or len(r[3].split(" ")) != 2 * (n_words[r[1]] - 2)
           or not os.path.exists(os.path.join(gen_dir, f"{r[1]}.mel.npy"))]
    say(f"meta.csv: {len(rows) - 1} rows; first: {rows[1][:4] if len(rows) > 1 else None}")
    if rows[0] != header or len(rows) != n_test + 1 or bad:
        raise AssertionError(f"meta.csv is not the JAX layout with {n_test} rows (bad rows {bad})")


def per_sentences():
    with open(os.path.join(REPO, "data", "per_test_set.json"), encoding="utf-8") as f:
        return [d["text"] for d in json.load(f)]


def sandhi_route():
    """("jieba", None) where jieba imports (the inferencer's own
    SandhiProcessor runs), else ("fixture", FixedSandhi) with the committed
    overrides of the PER sentences (tests/sandhi_per_test_set.json, which
    tests/test_torch_text.py holds to the JAX engine)."""
    from dicttts_tpu_torch.text.sandhi import FixedSandhi

    try:
        import jieba  # noqa: F401
        return "jieba", None
    except ImportError:
        with open(os.path.join(REPO, "tests", "sandhi_per_test_set.json"), encoding="utf-8") as f:
            return "fixture", FixedSandhi(json.load(f))


def text_cfg(root, binary, work_dir):
    """The recipe's config as phase 8 saved it, with the repo's dictionary,
    per-stage timers on, no vocoder checkpoint."""
    from dicttts_tpu_torch.config import load_config
    from dicttts_tpu_torch.run import autoconfigure_vocabs

    dict_path = os.path.join(REPO, ".prod_corpus", "zh-dict.json")
    if not os.path.exists(dict_path):
        raise FileNotFoundError(f"the text path needs the repo's dictionary {dict_path}")
    with in_dir(root):
        cfg = load_config(config=os.path.join(REPO, RECIPE_CONFIG), exp_name="recipe", infer=True)
    cfg = autoconfigure_vocabs(dict(cfg, binary_data_dir=binary))
    return dict(cfg, binary_data_dir=binary, dict_path=dict_path, work_dir=work_dir, profile_infer=True,
                vocoder_ckpt="")


def synth_run(inf, texts, batch, seed0):
    """synthesize_batch over ``texts`` in batches of ``batch``: per-sentence
    results, seconds (host clock, each call ends with its host copies) and
    the stage totals of Timer."""
    from dicttts_tpu_torch.eval.metrics import Timer

    Timer.totals = {}
    out, secs = [], 0.0
    for i in range(0, len(texts), batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out += inf.synthesize_batch(texts[i:i + batch], seed=seed0 + i)
        secs += time.perf_counter() - t
    return out, secs, dict(Timer.totals)


def check_wavs(results, texts, hop):
    for (wav, info), text in zip(results, texts):
        n = info["n_frames"]
        if not (0 < n and wav.shape == (n * hop,) and info["mel"].shape == (n, 80)):
            raise AssertionError(f"{text}: wav {wav.shape} for {n} frames")
        if not (np.isfinite(wav).all() and np.isfinite(info["mel"]).all() and np.abs(wav).max() > 1e-4):
            raise AssertionError(f"{text}: non-finite or silent output")
        if len(info["pinyin"]) != len(info["text"]):
            raise AssertionError(f"{text}: {len(info['pinyin'])} syllables for {len(info['text'])} characters")


def text_to_wav(root, binary, work_dir, smi):
    """Phase 9a: DictTTSInferencer, text -> wav at the recipe's width on
    phase 8's newest checkpoint, eager S2PA (the recipe) and K3. Returns the
    K3 records at the inferencer's shapes (the largest B=1 call, the first
    B=16 batch), K3's launches and the report."""
    import dicttts_tpu_torch.models.dict_encoder as dict_encoder
    from dicttts_tpu_torch.infer import DictTTSInferencer
    from dicttts_tpu_torch.ops.s2pa_bank import s2pa_bank_bwd, s2pa_bank_fwd
    from dicttts_tpu_torch.ops.s2pa_fused import s2pa_fused
    from dicttts_tpu_torch.utils.checkpoint import get_last_checkpoint, load_checkpoint
    from dicttts_tpu_torch.vocoders.hifigan import HifiGanVocoder, load_wav, spec2wav

    route, sandhi = sandhi_route()
    say(f'sandhi route: {json.dumps({"sandhi": route})}')
    texts = per_sentences()
    cfg = text_cfg(root, binary, work_dir)
    sr, n_b1 = cfg["audio_sample_rate"], 8
    ckpt = get_last_checkpoint(work_dir)
    saved = load_checkpoint(ckpt, map_location="cuda")[1]["params_g"]
    runs, report, k3_inputs = {}, {"sandhi": route}, []
    for use_pallas in (False, True):
        mode = "k3" if use_pallas else "eager"
        t = time.perf_counter()
        inf = DictTTSInferencer(dict(cfg, use_pallas_s2pa=use_pallas), sandhi=sandhi)
        say(f"{mode}: inferencer built in {time.perf_counter() - t:.2f} s from {os.path.basename(ckpt)}; "
            f"vocoder {type(inf.vocoder).__name__} (seeded init, upsample_initial_channel "
            f"{inf.vocoder.generator.conv_pre.out_channels}, hop {inf.vocoder.hop})")
        state = inf.task.model.state_dict()
        if not all(torch.equal(state[k], v) for k, v in saved.items()):
            raise AssertionError("the inferencer did not restore phase 8's newest checkpoint")
        if not use_pallas:  # one sentence to a file, read back
            path = os.path.join(root, "one.wav")
            wav, info = inf.synthesize(texts[0], seed=0, out_wav=path)
            back, back_sr = load_wav(path)
            d = float(np.abs(back - np.clip(wav, -1, 1)).max())
            say(f"synthesize({texts[0]!r}) -> {path}: {info['n_frames']} frames, pinyin "
                f"{' '.join(info['pinyin'][:6])} ..., read back {back.shape[0]} samples at {back_sr} Hz, "
                f"max|d| {d:.2e} (tol 1e-4: 16-bit PCM, written at 32767 and read at 32768 a unit)")
            check_wavs([(wav, info)], texts[:1], inf.vocoder.hop)
            if back_sr != sr or back.shape != wav.shape or d > 1e-4:
                raise AssertionError("the written wav does not read back")
        synth_run(inf, texts[:n_b1], 1, 0)  # warm-up: every shape the timed runs meet
        synth_run(inf, texts, 16, 1000)
        s2pa_bank_fwd.launches = s2pa_bank_bwd.launches = s2pa_fused.launches = 0
        if use_pallas:  # every call's K3 inputs, for K3 alone below
            def capture(*args):
                k3_inputs.append(args)
                return s2pa_fused(*args)
            dict_encoder.s2pa_fused = capture
        try:
            b1, b1_s, b1_stages = synth_run(inf, texts[:n_b1], 1, 0)
            k3_b1 = s2pa_fused.launches
            s2pa_fused.launches = 0
            b16, b16_s, b16_stages = synth_run(inf, texts, 16, 1000)
        finally:
            dict_encoder.s2pa_fused = s2pa_fused
        n_batches = -(-len(texts) // 16)
        launches = (s2pa_bank_fwd.launches, s2pa_bank_bwd.launches, k3_b1, s2pa_fused.launches)
        say(f"{mode}: launches K1 {launches[0]}, K2 {launches[1]}, K3 {k3_b1} over {n_b1} calls at B=1 and "
            f"{launches[3]} over {n_batches} calls at B=16")
        want = n_b1 if use_pallas else 0, n_batches if use_pallas else 0
        if launches[:2] != (0, 0) or (launches[2], launches[3]) != want:
            raise AssertionError(f"{mode}: expected K3 {want} and no K1/K2, got {launches}")
        check_wavs(b1, texts[:n_b1], inf.vocoder.hop)
        check_wavs(b16, texts, inf.vocoder.hop)
        rec = {"k3_launches": k3_b1 + launches[3]}
        for name, res, secs, stages, n in (("B=1", b1, b1_s, b1_stages, n_b1),
                                           ("B=16", b16, b16_s, b16_stages, n_batches)):
            frames = sum(i["n_frames"] for _, i in res)
            audio = frames * inf.vocoder.hop / sr
            ms = {k: v * 1e3 / n for k, v in stages.items()}
            rec[name] = {"calls": n, "sentences": len(res), "frames": frames, "audio_s": audio,
                         "wall_ms_per_call": secs * 1e3 / n, "rtf": secs / audio, "stage_ms_per_call": ms}
            say(f"{mode} {name}: {len(res)} sentences in {n} calls, {secs * 1e3 / n:.2f} ms per call, "
                f"{frames} frames ({frames / sum(len(i['text']) for _, i in res):.2f} a character), audio "
                f"{audio:.2f} s, RTF {secs / audio:.5f}; per call: front end {ms['front_end']:.2f} ms "
                f"(normalization, sandhi, _bank_for, collate), acoustic {ms['acoustic']:.2f} ms, vocoder "
                f"{ms['vocoder']:.2f} ms (f32); on {smi}")
        runs[mode] = b16
        report[mode] = rec
        if not use_pallas:  # the bf16 vocoder against the f32 one on the B=16 mels
            voc16 = HifiGanVocoder(dict(cfg, vocoder_infer_dtype="bfloat16"),
                                   params=inf.vocoder.generator.state_dict())
            mels = [i["mel"] for _, i in b16[:16]]
            batch = np.full((16, max(len(m) for m in mels), 80), -6.0, np.float32)
            for j, m in enumerate(mels):
                batch[j, :len(m)] = m
            mel_t = torch.tensor(batch, device="cuda")
            ms32 = time_ms(lambda: spec2wav(inf.vocoder.generator, mel_t), iters=5, warmup=1)
            ms16 = time_ms(lambda: spec2wav(voc16.generator, mel_t), iters=5, warmup=1)
            w32 = spec2wav(inf.vocoder.generator, mel_t)
            w16 = spec2wav(voc16.generator, mel_t)
            rel = float(torch.sqrt(torch.mean((w16 - w32) ** 2)) / torch.sqrt(torch.mean(w32 ** 2)))
            report["vocoder_b16"] = {"frames": batch.shape[1], "f32_ms": ms32, "bf16_ms": ms16, "bf16_rms_rel": rel}
            say(f"vocoder alone at B=16 x {batch.shape[1]} frames: f32 {ms32:.2f} ms, bf16 {ms16:.2f} ms; bf16 "
                f"rms deviation {100 * rel:.2f} % of the f32 signal's rms (tol 5 %); on {smi}")
            if not rel < 0.05:
                raise AssertionError("the bf16 vocoder strays from the f32 one")
            del voc16, w32, w16, mel_t
        del inf
        torch.cuda.empty_cache()

    worst, ties = 0.0, []
    for text, (_, a), (_, b) in zip(texts, runs["eager"], runs["k3"]):
        if a["n_frames"] != b["n_frames"]:
            ties.append(text)
            continue
        if a["pinyin"] != b["pinyin"]:
            raise AssertionError(f"{text}: pinyin differs between eager S2PA and K3")
        worst = max(worst, float(np.abs(a["mel"] - b["mel"]).max()))
    say(f"K3 vs eager S2PA over {len(texts)} sentences: n_frames and pinyin equal in "
        f"{len(texts) - len(ties)}, max|dmel| {worst:.3e} (tol 1e-3: f32 with TF32 off; K3 projects k "
        f"and v to H before the dot products, eager S2PA takes q to E, and the difference runs through "
        f"the model)")
    if ties:
        raise AssertionError(f"frame counts differ between eager S2PA and K3 for {ties}")
    if not worst <= 1e-3:
        raise AssertionError("K3 and eager S2PA mels disagree")
    report["k3_vs_eager_max_dmel"] = worst

    # K3 alone on the largest B=1 call's and the first B=16 batch's own inputs,
    # and on the A/B script's seeded B=16 case of the same layout
    # (scripts/torch_bank_kernels_ab.py, K3_CASES[1]), which a fresh process times
    b1_args = max(k3_inputs[:n_b1], key=lambda a: a[1].shape[1] * a[1].shape[2])
    cases = [k3_case(tuple(a.contiguous() for a in args), "text path", smi)
             for args in (b1_args, k3_inputs[n_b1])]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 101)
    seeded = k3_case(fused_case(torch.device("cuda"), gen, 16, 32, 56, "text"), "seeded text layout", smi)
    return [*cases, seeded], report["k3"]["k3_launches"], report


def gathered_training(root, binary, smi, recipe_report):
    """Phase 9b: run.main on the corpus with per-utterance gathered banks
    (use_device_dict_bank=False) for a few steps. Returns the report."""
    from dicttts_tpu_torch import run
    from dicttts_tpu_torch.ops.s2pa_bank import s2pa_bank_bwd, s2pa_bank_fwd
    from dicttts_tpu_torch.ops.s2pa_fused import s2pa_fused

    steps = 4
    hp = (f"binary_data_dir={binary},use_device_dict_bank=False,max_updates={steps},"
          f"val_check_interval={steps},num_sanity_val_steps=0")
    with in_dir(root):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s2pa_bank_fwd.launches = s2pa_bank_bwd.launches = s2pa_fused.launches = 0
        t = time.time()
        trainer, task = run.main(["--config", os.path.join(REPO, RECIPE_CONFIG), "--exp_name", "gathered",
                                  "--device", "cuda", "--hparams", hp])
        torch.cuda.synchronize()
    launches = (s2pa_bank_fwd.launches, s2pa_bank_bwd.launches, s2pa_fused.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    vals = {k: float(v) for k, v in trainer.metrics.items()}
    say(f"run.main on gathered banks: {trainer.global_step} steps in {time.time() - t:.1f} s (validation "
        f"and checkpoint included), peak memory {peak:.2f} GiB; launches (K1, K2, K3) {launches}; device "
        f"bank held: {task.bank is not None}; last step {vals}; validation {trainer.val_metrics}; on {smi}")
    report = {"train": step_report(trainer.history, "gathered", smi), "peak_gib": peak, "launches": launches}
    device_bank = recipe_report["train"]["step_ms"]
    for shape, ms in report["train"]["step_ms"].items():
        if shape in device_bank:
            say(f"step ms at {shape}: gathered banks {' '.join(f'{x:.1f}' for x in ms)}; the device bank "
                f"(phase 8) {' '.join(f'{x:.1f}' for x in device_bank[shape])}; on {smi}")
    finite = all(math.isfinite(v) for v in (*vals.values(), *trainer.val_metrics.values()))
    if not (trainer.global_step == steps and finite and task.bank is None):
        raise AssertionError(f"gathered-bank training did not take {steps} finite steps")
    if launches != (0, 0, 0):
        raise AssertionError(f"gathered-bank training launched K1/K2/K3 {launches}")
    del trainer, task
    torch.cuda.empty_cache()
    return report


def rio_corpus(root, binary):
    """Phase 10a's corpus: phase 8's splits converted to .rio by the port's
    converter, beside links to the rest of phase 8's directory (the
    vocabularies, the lengths, the stand-in dict_embed)."""
    from dicttts_tpu_torch.data.recordio import convert_indexed_dataset

    rio_dir = os.path.join(root, "binary_rio")
    os.makedirs(rio_dir)
    splits = {f"{s}{ext}" for s in CORPUS_SPLITS for ext in (".data", ".idx")}
    for name in os.listdir(binary):
        if name not in splits:
            os.symlink(os.path.realpath(os.path.join(binary, name)), os.path.join(rio_dir, name))
    t = time.time()
    counts = {s: convert_indexed_dataset(os.path.join(binary, s), os.path.join(rio_dir, s))
              for s in CORPUS_SPLITS}
    size = sum(os.path.getsize(os.path.join(rio_dir, f"{s}.rio")) for s in CORPUS_SPLITS)
    say(f".rio corpus: {counts} records, {size / 1e6:.1f} MB, converted in {time.time() - t:.2f} s")
    if counts != CORPUS_SPLITS:
        raise AssertionError(f"converted {counts}, not the corpus's {CORPUS_SPLITS}")
    return rio_dir


def launch_counts():
    from dicttts_tpu_torch.ops.s2pa_bank import s2pa_bank_bwd, s2pa_bank_fwd
    from dicttts_tpu_torch.ops.s2pa_fused import s2pa_fused

    return s2pa_bank_fwd.launches, s2pa_bank_bwd.launches, s2pa_fused.launches


def zero_launch_counts():
    from dicttts_tpu_torch.ops.s2pa_bank import s2pa_bank_bwd, s2pa_bank_fwd
    from dicttts_tpu_torch.ops.s2pa_fused import s2pa_fused

    s2pa_bank_fwd.launches = s2pa_bank_bwd.launches = s2pa_fused.launches = 0


def run_main(root, exp_name, hparams, *extra, config=RECIPE_CONFIG):
    """run.main on ``config`` (the recipe's) in ``root``, the launch counts
    set to 0 just before and read just after. Returns (trainer, task, (K1,
    K2, K3))."""
    from dicttts_tpu_torch import run

    with in_dir(root):
        torch.cuda.synchronize()
        zero_launch_counts()
        out = run.main(["--config", os.path.join(REPO, config), "--exp_name", exp_name,
                        "--device", "cuda", *extra, *(["--hparams", hparams] if hparams else [])])
        torch.cuda.synchronize()
    return (*out, launch_counts())


def finite_run(trainer, task):
    vals = {k: float(v) for k, v in trainer.metrics.items()}
    finite = all(math.isfinite(v) for v in (*vals.values(), *trainer.val_metrics.values()))
    return vals, finite and all(bool(torch.isfinite(p).all()) for p in task.model.parameters())


def profile_step(step, label, smi, top=10):
    """One call of step() under torch.profiler, after one call outside it
    (the shape's first: cuDNN's choices and the allocator): its wall ms,
    the device's busy ms, the device time in kernels whose names say FFT
    (cuDNN's FFT convolutions) and in complex GEMMs (their spectral
    products), and the top kernels. None where the profiler recorded no
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # device events without the ranges that annotate them (Optimizer.step#...)
    def kernel(e):
        return (e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
                and "#" not in e.key)

    events = [e for e in prof.key_averages() if kernel(e) and e.self_device_time_total > 0]
    if not events:
        say(f"profiler: no device time recorded for the {label} (its breakdown is not measured)")
        return None
    busy = sum(e.self_device_time_total for e in events) / 1e3
    # the time some kernel ran: the union of the kernels' intervals, in ms
    spans, covered, end = sorted((e.time_range.start, e.time_range.end) for e in prof.events() if kernel(e)), 0.0, 0.0
    for a, b in spans:
        covered += max(b - max(a, end), 0.0)
        end = max(end, b)
    covered /= 1e3
    fft = [e for e in events if "fft" in e.key.lower()]
    fft_ms = sum(e.self_device_time_total for e in fft) / 1e3
    # the FFT convolutions multiply their spectra in complex GEMMs (cf32 in the name)
    cgemm_ms = sum(e.self_device_time_total for e in events if "cf32" in e.key) / 1e3
    say(f"{label} profiled: {wall_ms:.1f} ms wall, kernels {busy:.1f} ms summed, some kernel running "
        f"{covered:.1f} ms (idle {100 * max(1 - covered / wall_ms, 0.0):.1f} % of the wall); kernels named "
        f"FFT: {len(fft)} kinds, {fft_ms:.2f} ms ({100 * fft_ms / max(busy, 1e-9):.1f} % of kernel time), with "
        f"the complex GEMMs {fft_ms + cgemm_ms:.2f} ms ({100 * (fft_ms + cgemm_ms) / max(busy, 1e-9):.1f} %); "
        f"on {smi}")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
    for e in ranked:
        say(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:5d} x  {e.key[:110]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "covered_ms": covered, "fft_kernels": [e.key[:80] for e in fft],
            "fft_ms": fft_ms, "complex_gemm_ms": cgemm_ms,
            "top": [[e.key[:80], e.self_device_time_total / 1e3, e.count] for e in ranked]}


def profile_fft(task, batch, smi):
    """Phase 10a's profiled train step of ``batch``."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    dev_batch = task.to_device({k: v for k, v in batch.items() if k != "_meta"})
    shape = tuple(batch["mel2word"].shape)
    prof = profile_step(lambda: task.train_step(dev_batch, gen), f"amp step {shape[0]}x{shape[1]}", smi)
    return {"shape": shape, "fft_kernels": None} if prof is None else {"shape": shape, **prof}


def amp_recipe(root, binary, smi, recipe_report):
    """Phase 10a: the recipe under amp from a .rio corpus (the device bank,
    the frame cache, K1/K2), a profiled 60x512 step, then --infer with
    use_pallas_s2pa on gathered banks (K3). Returns (launches by run, the
    report)."""
    from dicttts_tpu_torch.data.recordio import RecordReader

    rio_dir = rio_corpus(root, binary)
    hp = (f"binary_data_dir={rio_dir},amp=True,max_updates={RECIPE_STEPS},"
          f"val_check_interval={RECIPE_STEPS // 2},num_sanity_val_steps=1")
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    trainer, task, launches = run_main(root, "amp", hp)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    readers = [getattr(p.ds.ds, "is_native", False) for p in (task.data.train, task.data.valid, task.data.test)]
    say(f"amp run.main: {trainer.global_step} steps in {time.time() - t:.1f} s; splits read by the native "
        f".rio reader {readers}; bank {task.bank['keys'].dtype}; peak memory {peak:.2f} GiB; launches "
        f"(K1, K2, K3) {launches}; on {smi}")
    report = {"peak_gib": peak, "launches": {"amp_train": launches},
              "train": step_report(trainer.history, "amp", smi)}
    f32 = recipe_report["train"]["step_ms"]
    for shape, ms in report["train"]["step_ms"].items():
        if shape in f32:
            say(f"step ms at {shape}: amp {' '.join(f'{x:.1f}' for x in ms)}; f32 (phase 8) "
                f"{' '.join(f'{x:.1f}' for x in f32[shape])}; on {smi}")
    vals, finite = finite_run(trainer, task)
    say(f"amp last step {vals}; validation {trainer.val_metrics}")
    if not (all(readers) and isinstance(task.data.train.ds.ds, RecordReader)):
        raise AssertionError("the .rio splits were not read by the native reader")
    if not (trainer.global_step == RECIPE_STEPS and finite and task.act_dtype == torch.bfloat16
            and task.bank["keys"].dtype == torch.bfloat16):
        raise AssertionError(f"the amp run did not train {RECIPE_STEPS} finite steps in bf16")
    if not (launches[1] == RECIPE_STEPS and launches[0] > RECIPE_STEPS and launches[2] == 0):
        raise AssertionError(f"K1/K2 not launched every amp step: {launches}")
    batches = [b for b in task.data.train_batches() if b["mel2word"].shape[1] == 512]
    report["profile"] = profile_fft(task, max(batches, key=lambda b: b["mel2word"].shape[0]), smi)
    del trainer, task
    torch.cuda.empty_cache()

    hp = "amp=True,use_pallas_s2pa=True,use_device_dict_bank=False"
    trainer, task, launches = run_main(root, "amp", hp, "--infer")
    n_test = CORPUS_SPLITS["test"]
    gen_dir = os.path.join(root, "checkpoints", "amp", "generated")
    mels = [np.load(os.path.join(gen_dir, f)) for f in os.listdir(gen_dir) if f.endswith(".mel.npy")]
    say(f"amp --infer with use_pallas_s2pa on gathered banks: {n_test} test utterances in "
        f"{trainer.test_seconds:.2f} s ({trainer.test_seconds / n_test * 1e3:.2f} ms each); launches "
        f"(K1, K2, K3) {launches}; {len(mels)} mels, all finite {all(np.isfinite(m).all() for m in mels)}; "
        f"on {smi}")
    check_meta(gen_dir, binary, n_test)
    if launches != (0, 0, n_test) or len(mels) != n_test or not all(np.isfinite(m).all() for m in mels):
        raise AssertionError(f"amp --infer: launches {launches}, {len(mels)} mels")
    report["launches"]["amp_infer"] = launches
    report["test_ms_per_utterance"] = trainer.test_seconds / n_test * 1e3
    del trainer, task
    torch.cuda.empty_cache()
    report["k3_amp_max_abs_err"] = k3_under_amp(smi)
    return report


def k3_under_amp(smi):
    """K3 as the inference under amp calls it (a bf16 q, f32 k and v; the
    wrapper upcasts q and rounds the outputs to bf16) against its plain
    version's f32 outputs rounded to bf16, at the text path's B=16 shape:
    within one bf16 rounding (rtol 2**-7, atol 1e-5)."""
    from dicttts_tpu_torch.ops.s2pa_fused import s2pa_fused, s2pa_fused_plain

    q, k, v, km, pm = fused_case(torch.device("cuda"), torch.Generator(device="cuda").manual_seed(SEED + 11),
                                 16, 32, 56, "text")
    qb = q.to(torch.bfloat16)
    got = s2pa_fused(qb, k, v, km, pm)
    want = [w.to(torch.bfloat16) for w in s2pa_fused_plain(qb.float(), k, v, km, pm)]
    torch.cuda.synchronize()
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    ok = all(g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
             and torch.allclose(g.float(), w.float(), rtol=2 ** -7, atol=1e-5) for g, w in zip(got, want))
    say(f"K3 under amp (bf16 q) at B=16 Tw=32 L=56 vs its plain version rounded to bf16: max abs err "
        f"{err:.3e} (tol: one bf16 rounding, rtol 2**-7), outputs bf16 and finite {ok}; on {smi}")
    if not ok:
        raise AssertionError("K3 under amp disagrees with its plain version")
    return err


def accumulation(root, binary, smi):
    """Phase 10b: accumulate_grad_batches=2 through run.main: 3 micro-steps
    (a checkpoint after the odd one, mid-accumulation), a resume, and on to
    8: 4 updates of each optimizer. Returns the launches of both runs."""
    from dicttts_tpu_torch.utils.checkpoint import load_checkpoint

    hp = (f"binary_data_dir={binary},accumulate_grad_batches=2,max_updates=3,val_check_interval=3,"
          "num_sanity_val_steps=0")
    trainer, task, first = run_main(root, "accumulate", hp)
    work_dir = os.path.join(root, "checkpoints", "accumulate")
    _, saved = load_checkpoint(os.path.join(work_dir, "model_ckpt_steps_3.ckpt"), "cpu")
    counts = (task.step, task.updates_g, task.updates_d, int(task.acc["g"].n), int(task.acc["d"].n))
    pending = (int(saved["acc_g"]["n"]), int(saved["acc_d"]["n"]))
    say(f"accumulate 2: 3 micro-steps, (step, updates g, updates d, pending g, pending d) {counts}; the "
        f"step-3 checkpoint holds {pending[0]} and {pending[1]} pending micro-steps; graphs "
        f"{graph_summary(trainer)}")
    if counts != (3, 1, 1, 1, 1) or pending != (1, 1):
        raise AssertionError(f"accumulation counts {counts} after 3 micro-steps")
    del trainer, task
    trainer, task, second = run_main(root, "accumulate", "max_updates=8")
    counts = (task.step, task.updates_g, task.updates_d, int(task.acc["g"].n), int(task.acc["d"].n))
    vals, finite = finite_run(trainer, task)
    say(f"resumed at micro-step 3 and ran to {trainer.global_step}: (step, updates g, updates d, pending "
        f"g, pending d) {counts}; launches (K1, K2, K3) {first} + {second}; last step {vals}; finite "
        f"{finite}; step ms {[round(h['step_ms'], 1) for h in trainer.history]}; runs "
        f"{[h['run'] for h in trainer.history]}; graphs {graph_summary(trainer)}; on {smi}")
    if not (counts == (8, 4, 4, 0, 0) and finite and "grad_norm_g" in vals and "grad_norm_d" in vals
            and [h["step"] for h in trainer.history] == list(range(4, 9))):
        raise AssertionError(f"8 micro-steps did not give 4 updates of each optimizer: {counts}")
    del trainer, task
    torch.cuda.empty_cache()
    return tuple(a + b for a, b in zip(first, second))


def other_settings(root, binary, smi):
    """Phase 10c: the recipe's other settings for 4 steps each: speaker ids,
    the flow-less prior, Gumbel senses, the discriminator without norm and
    with the sum reduction, on the unfused bank (K1/K2 never launched); then
    the sense mode on the fused bank (K1/K2 launched). Returns the launches."""
    steps, out = 4, {}
    base = (f"binary_data_dir={binary},max_updates={steps},val_check_interval={steps},"
            "num_sanity_val_steps=0")
    runs = {"settings_unfused": ("use_spk_id=True,num_spk=2000,use_prior_glow=False,s2pa_sense_mode=gumbel,"
                                 "disc_norm=none,disc_reduction=sum,s2pa_bank_fused=False"),
            "settings_sense": "s2pa_sense_mode=sense"}
    for name, hp in runs.items():
        t = time.time()
        trainer, task, launches = run_main(root, name, f"{base},{hp}")
        vals, finite = finite_run(trainer, task)
        say(f"{name} ({hp}): {trainer.global_step} steps in {time.time() - t:.1f} s, launches (K1, K2, K3) "
            f"{launches}, speakers {task.model.num_spk}, prior flow {task.model.fvae.prior_flow is not None}, "
            f"bank fused {task.bank_fused}; last step {vals}; finite {finite}; on {smi}")
        fused = name == "settings_sense"
        if not (trainer.global_step == steps and finite and task.bank_fused == fused):
            raise AssertionError(f"{name} did not train {steps} finite steps")
        if fused != (launches[1] == steps and launches[0] >= steps) or (not fused and launches != (0, 0, 0)):
            raise AssertionError(f"{name}: K1/K2 launches {launches}")
        if not fused and not (task.model.num_spk == 2000 and task.model.fvae.prior_flow is None):
            raise AssertionError(f"{name}: the settings did not reach the model")
        out[name] = launches
        del trainer, task
        torch.cuda.empty_cache()
    return out


def amp_check_inputs():
    """Phase 10d's inputs, which tests/test_torch_amp.py also feeds to the
    JAX task on the CPU to measure its own amp-vs-f32 gap: small widths
    (AMP_CHECK_CFG), a [40, 12, 32] bank gathered into a batch of 2
    sentences of 8 words and 144 frames, the posterior noise, and crop
    starts from fixed uniforms (float32 math, as the JAX discriminator
    draws them). All numpy, from SEED."""
    rng = np.random.RandomState(SEED + 9)
    V, L, E, P, B, Tw, T = 40, 12, 32, 6, 2, 8, 144
    km = (rng.randint(0, 3, (V, L)) + (np.arange(L) == 0)).astype(np.int32)
    bank = {"keys": (rng.randn(V, L, E) * 0.5).astype(np.float32), "key_map": km,
            "pinyin": rng.randint(1, 30, (V, P)).astype(np.int32),
            "pinyin_map": np.tile(np.array([1, 1, 2, 2, 0, 0], np.int32), (V, 1))}
    wt = np.zeros((B, Tw), np.int32)
    m2w = np.zeros((B, T), np.int32)
    lengths = np.array([T, 100], np.int32)
    for b, n_frames in enumerate(lengths):
        f = w = 0
        while f < n_frames and w < Tw:
            d = min(rng.randint(8, 21), n_frames - f)
            m2w[b, f:f + d] = w + 1
            f, w = f + d, w + 1
        wt[b, :w] = np.concatenate([[1], rng.randint(5, V, w - 1)])
    batch = {"word_tokens": wt, "mel2word": m2w, "mel_lengths": lengths,
             "word_lengths": (wt > 0).sum(1).astype(np.int32),
             "pron_modified": (np.where(rng.rand(B, Tw) < 0.2, 1, 0) * (wt > 0)).astype(np.int32),
             "mels": (rng.randn(B, T, 80) * 0.5 - 2).astype(np.float32) * (m2w > 0)[:, :, None],
             **{k: bank[k][wt] for k in ("key_map", "pinyin", "pinyin_map")},
             "keys": bank["keys"][wt], "values": bank["keys"][wt]}
    eps = rng.randn(B, T // 4, AMP_CHECK_CFG["latent_size"]).astype(np.float32)
    u = np.array([0.3, 0.8, 0.45], np.float32)
    max_len = int(lengths.max())
    starts = np.array([min(int(np.floor(ui * np.float32(max(max_len - w, 0) + 1))), max(T - w, 0))
                       for ui, w in zip(u, (32, 64, 128))], np.int64)
    return batch, eps, u, starts


def amp_check_weights(task):
    """Seeded weights for phase 10d's generator and discriminator, drawn
    in parameter order with numpy (the same on any machine)."""
    rng = np.random.RandomState(SEED + 10)
    with torch.no_grad():
        for module, scale in ((task.model, 0.2), (task.disc, 0.05)):
            for p in module.parameters():
                p.copy_(torch.from_numpy((rng.randn(*p.shape) * scale).astype(np.float32)))


def amp_check_losses(device, amp):
    """One train step's losses (generator and discriminator) of the port at
    AMP_CHECK_CFG on phase 10d's inputs, with or without amp."""
    from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask

    batch, eps, _, starts = amp_check_inputs()
    task = DictTTSTask({**AMP_CHECK_CFG, "amp": amp}, device=device)
    task.build_state(SEED)
    amp_check_weights(task)
    starts = torch.from_numpy(starts).to(task.device)
    metrics = task.train_step(task.to_device(batch), eps=torch.from_numpy(eps).to(task.device),
                              start_frames_g=starts, start_frames_d=starts)
    return {k: float(v) for k, v in metrics.items() if not k.startswith("grad_norm")}


def amp_vs_f32_step(device, smi):
    """Phase 10d: one train step under amp beside one in f32 on the card,
    from the same weights, batch, dropout 0, noise and crops; the largest
    loss gap against twice the JAX package's own amp-vs-f32 gap on these
    inputs (measured on the CPU by tests/test_torch_amp.py)."""
    torch.cuda.synchronize()
    zero_launch_counts()
    out = {"f32": amp_check_losses(device, False), "amp": amp_check_losses(device, True)}
    torch.cuda.synchronize()
    launches = launch_counts()
    gap = max(abs(out["amp"][k] - out["f32"][k]) for k in out["f32"])
    for k in out["f32"]:
        say(f"  {k}: amp {out['amp'][k]:.6f} f32 {out['f32'][k]:.6f} |gap| {abs(out['amp'][k] - out['f32'][k]):.2e}")
    say(f"amp vs f32 on the card: largest loss gap {gap:.3e}; the JAX package's on the same inputs "
        f"{JAX_AMP_LOSS_GAP:.3e} (tests/test_torch_amp.py, CPU), bound 2x {2 * JAX_AMP_LOSS_GAP:.3e}; "
        f"launches (K1, K2, K3) {launches}; on {smi}")
    if not all(math.isfinite(v) for o in out.values() for v in o.values()) or gap > 2 * JAX_AMP_LOSS_GAP:
        raise AssertionError("the amp step's losses are not within twice the JAX package's amp gap")
    if launches != (0, 0, 0):
        raise AssertionError(f"the gathered-bank steps launched (K1, K2, K3) {launches}")
    return launches


def seeded_tone(rng, f0_hz):
    """VOC_LEAD_S of silence, then a tone of 1.5-4 s whose f0 glides
    linearly between two values drawn from f0_hz, with 2 harmonics and white
    noise, at 22050 Hz. Returns (wav, (lead samples, f0 at the tone's first
    and last sample, tone samples))."""
    n, lead = int(SAMPLE_RATE * rng.uniform(1.5, 4.0)), int(SAMPLE_RATE * VOC_LEAD_S)
    lo, hi = rng.uniform(*f0_hz, 2)
    ph = 2 * np.pi * np.cumsum(np.linspace(lo, hi, n)) / SAMPLE_RATE
    tone = 0.3 * np.sin(ph) + 0.1 * np.sin(2 * ph) + 0.05 * np.sin(3 * ph) + 0.005 * rng.randn(n)
    return np.concatenate([np.zeros(lead), tone]).astype(np.float32), (lead, lo, hi, n)


def seeded_wavs(raw, rows, rng):
    """A ``seeded_tone`` in VOC_F0_HZ for each metadata row, written as
    16-bit PCM. Returns {item_name: the tone's truth}."""
    from dicttts_tpu_torch.vocoders.hifigan import save_wav

    truth = {}
    for row in rows:
        wav, truth[row[0]] = seeded_tone(rng, VOC_F0_HZ)
        row[1] = os.path.join(raw, f"{row[0]}.wav")
        save_wav(row[1], wav)
    return truth


def seeded_f0_frames(f0, truth):
    """Frames of one seeded tone's f0 track: (inside: the 2048-sample window
    lies in the tone, silent: it lies in the lead, voiced: inside and
    voiced, the relative error of the voiced frames against the seeded f0
    at the frame's center)."""
    lead, lo, hi, n = truth
    c = np.arange(len(f0)) * HOP
    inside = (c - 1024 >= lead) & (c + 1024 <= lead + n)
    silent = c + 1024 < lead
    f_true = lo + (hi - lo) * (c - lead) / (n - 1)
    voiced = inside & (f0 > 0)
    return inside, silent, voiced, np.abs(f0[voiced] - f_true[voiced]) / f_true[voiced]


def check_seeded_f0(items, truth):
    """Voiced frames inside the tone within VOC_F0_RTOL of the seeded f0, at
    least 95 % of those frames voiced, and every frame whose window lies in
    the silent lead unvoiced. Returns (largest relative error, frames
    checked)."""
    worst, n_checked = 0.0, 0
    for item in items:
        f0 = item["f0"]
        inside, silent, voiced, rel = seeded_f0_frames(f0, truth[item["item_name"]])
        if (f0[silent] != 0).any() or voiced.sum() < 0.95 * inside.sum() or (rel > VOC_F0_RTOL).any():
            raise AssertionError(f"{item['item_name']}: seeded f0 not recovered (voiced {voiced.sum()} of "
                                 f"{inside.sum()}, max rel err {rel.max():.3e}, lead voiced "
                                 f"{(f0[silent] != 0).sum()})")
        worst, n_checked = max(worst, float(rel.max())), n_checked + int(voiced.sum())
    return worst, n_checked


def f0_disagreement(got, want, rtol):
    """Two runs of ``ops.f0.autocorr_f0_frames`` on the same frames, each
    (f0, peak lag, band spread) in numpy, against each other. Frames set
    apart and counted: voicing flips (voiced on one side only); flat frames
    (both voiced, outside rtol, either side's band spread below F0_FLAT: a
    window that holds a silence's edge, whose ACF is the window's own, so
    the pick near f0_max is rounding noise); other-lag picks (both voiced,
    outside rtol, the integer peak differs: an argmax near-tie). Every other
    voiced frame is held to rtol. Returns (voicing flips, those of them at
    a flat frame, flat frames, other-lag picks, the largest relative error
    of the rest)."""
    (fg, pg, sg), (fw, pw, sw) = got, want
    fg, fw = fg.astype(np.float64), fw.astype(np.float64)
    both = (fg > 0) & (fw > 0)
    rel = np.zeros(len(fw))
    rel[both] = np.abs(fg[both] - fw[both]) / fw[both]
    out, no_peak = both & (rel > rtol), np.minimum(sg, sw) < F0_FLAT
    flat = out & no_peak
    other = out & ~flat & (pg != pw)
    vflips = (fg > 0) != (fw > 0)
    return (int(vflips.sum()), int((vflips & no_peak).sum()), int(flat.sum()), int(other.sum()),
            float(rel[both & ~flat & ~other].max(initial=0.0)))


def mel_frame_error(got, want) -> float:
    """The largest |10^got - 10^want| of a frame over that frame's loudest
    bin of ``want`` (log10 mels): f32 FFT rounding scales with a frame's
    energy, so bins near the 1e-6 floor of a quiet frame differ most in log10."""
    lin_g, lin_w = 10.0 ** got.astype(np.float64), 10.0 ** want.astype(np.float64)
    return float((np.abs(lin_g - lin_w) / lin_w.max(-1, keepdims=True)).max())


def binarize_on_card(root, smi):
    """Phase 11a: wavs written from the seed for the first VOC_ROWS rows of
    the repo's metadata (their texts and phones), binarized by the port's
    command line on the card with the recipe's config (dict_tts.yaml:
    dict_embed_dim 768) and with_wav, with_f0cwt. Returns (binary dir,
    report)."""
    from dicttts_tpu_torch.data.collate import shape_bucket
    from dicttts_tpu_torch.ops.f0 import autocorr_f0_frames, batched_f0
    from dicttts_tpu_torch.ops.mel import batched_log10_mel
    from dicttts_tpu_torch.text import binarize
    from dicttts_tpu_torch.text.binarizer import ZhBinarizer
    from dicttts_tpu_torch.utils.indexed_dataset import IndexedDataset
    from dicttts_tpu_torch.utils.text_encoder import TokenTextEncoder
    from dicttts_tpu_torch.vocoders.hifigan import load_wav

    corpus = os.path.join(REPO, ".prod_corpus")
    meta, dict_path = os.path.join(corpus, "processed", "metadata_phone.csv"), os.path.join(corpus, "zh-dict.json")
    if not (os.path.exists(meta) and os.path.exists(dict_path)):
        raise FileNotFoundError(f"phase 11 needs the repo's {meta} and {dict_path}")
    raw, proc, binary = (os.path.join(root, d) for d in ("raw", "processed", "binary"))
    for d in (raw, proc):
        os.makedirs(d)
    with open(meta) as f:
        rows = list(csv.reader(f))[:VOC_ROWS]
    truth = seeded_wavs(raw, rows, np.random.RandomState(SEED + 11))
    with open(os.path.join(proc, "metadata_phone.csv"), "w", newline="") as f:
        csv.writer(f).writerows(rows)
    for name in ("phone_set.json", "word_set.json"):
        with open(os.path.join(corpus, "processed", name)) as f, open(os.path.join(proc, name), "w") as g:
            g.write(f.read())
    # tone sandhi: jieba where it imports, else the overrides these texts
    # got when the repo's corpus was binarized (its items' pron_modified)
    hparams = (f"processed_data_dir={proc},binary_data_dir={binary},dict_path={dict_path},"
               f"with_wav=True,with_f0cwt=True,test_num={VOC_ROWS // 10},valid_num={VOC_ROWS // 10}")
    try:
        import jieba  # noqa: F401
        route = "jieba"
    except ImportError:
        overrides = {}
        for split in CORPUS_SPLITS:
            ds = IndexedDataset(os.path.join(corpus, "binary", split))
            for i in range(len(ds)):
                item = ds[i]
                overrides[item["txt"]] = [int(v) for v in item["pron_modified"][1:-1]]
        missing = [r[0] for r in rows if r[2] not in overrides]
        if missing:
            raise AssertionError(f"no sandhi overrides for {missing[:5]}")
        path = os.path.join(root, "sandhi_overrides.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(overrides, f, ensure_ascii=False)
        hparams += f",sandhi_overrides={path}"
        route = "the repo corpus's pron_modified"
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, binz = binarize.main(["--config", os.path.join(REPO, RECIPE_CONFIG), "--stage", "binarize",
                             "--device", "cuda", "--hparams", hparams])
    total_s = time.perf_counter() - t
    st = binz.stats
    if binz.cfg["dict_embed_dim"] != 768 or st["splits"] != {"test": 12, "valid": 12, "train": 96}:
        raise AssertionError(f"binarized {st['splits']} at dict_embed_dim {binz.cfg['dict_embed_dim']}")
    items = [ds[i] for split in ("test", "valid", "train")
             for ds in (IndexedDataset(os.path.join(binary, split)),) for i in range(len(ds))]
    for item in items:
        if item["wav"] is None or item["wav"].dtype != np.float32 or not (
                len(item["wav"]) // HOP + 1 == item["len"] == len(item["mel"]) == len(item["f0"])
                == len(item["mel2word"]) == len(item["cwt_spec"])):
            raise AssertionError(f"{item['item_name']}: wav, mel and frames disagree")
    worst, n_f0 = check_seeded_f0(items, truth)
    n_words = TokenTextEncoder.from_json(os.path.join(binary, "word_set.json")).vocab_size
    bank = IndexedDataset(os.path.join(binary, "dict_embed"))
    if len(bank) != n_words or bank[5]["key"].shape[1] != 768:
        raise AssertionError(f"dict_embed holds {len(bank)} entries for {n_words} word ids")
    say(f"binarized {st['items']} items in {total_s:.2f} s ({st['items'] / total_s:.1f} items/s; items "
        f"{st['items_s']:.2f} s with {st['workers']} text workers, of which the card's mel and f0 "
        f"{st['features_s']:.2f} s over {st['chunks']} chunks of {binz.cfg.get('binarize_batch', 16)}); "
        f"bank {len(bank)} entries in {st['bank_s']:.2f} s, {st['bank_bytes'] / 1e6:.1f} MB; splits "
        f"{st['splits']}; sandhi from {route}; on {smi}")
    say(f"seeded f0 recovered on {n_f0} voiced frames: max relative error {worst:.3e} (tol {VOC_F0_RTOL})")

    # one chunk of the binarized wavs, and one of glides in VOC_F0_HIGH_HZ,
    # on the card and on the CPU
    cpu = ZhBinarizer(binz.cfg, device="cpu")
    high_rng = np.random.RandomState(SEED + 12)
    high = [seeded_tone(high_rng, VOC_F0_HIGH_HZ) for _ in range(VOC_CHUNK)]
    chunks = {f"seeded {VOC_F0_HZ[0]:.0f}-{VOC_F0_HZ[1]:.0f} Hz": [load_wav(r[1])[0] for r in rows[:VOC_CHUNK]],
              f"glides {VOC_F0_HIGH_HZ[0]:.0f}-{VOC_F0_HIGH_HZ[1]:.0f} Hz": [w for w, _ in high]}

    def stack(wavs):  # the binarizer's bucketed chunk
        x = torch.zeros((len(wavs), shape_bucket(max(len(w) for w in wavs), multiple=HOP * 128)),
                        device=binz.device)
        for i, w in enumerate(wavs):
            x[i, :len(w)] = torch.as_tensor(w)
        return x

    card_vs_cpu = {}
    for name, wavs in chunks.items():
        got, want = binz._batched_features(wavs, SAMPLE_RATE), cpu._batched_features(wavs, SAMPLE_RATE)
        mel_err = max(mel_frame_error(g[0], w[0]) for g, w in zip(got, want))
        # the same f0 with each frame's peak lag and band spread, on both sides
        x = stack(wavs)
        sides = [[t.cpu().numpy() for t in autocorr_f0_frames(xs, n_frames=x.shape[1] // HOP + 1)]
                 for xs in (x, x.cpu())]
        counts, f0_rel, frames = np.zeros(4, int), 0.0, 0
        for i, w in enumerate(wavs):
            n = 1 + len(w) // HOP
            g, c = ([a[i, :n] for a in side] for side in sides)
            if not (np.array_equal(g[0], got[i][1]) and np.array_equal(c[0], want[i][1])):
                raise AssertionError(f"autocorr_f0_frames disagrees with the binarizer's f0 on {name}[{i}]")
            *cnt, r = f0_disagreement(g, c, 1e-4)
            counts, f0_rel, frames = counts + cnt, max(f0_rel, r), frames + n
        vflips, vflips_flat, flat, picks = (int(v) for v in counts)
        rep = {"mel": mel_err, "f0": f0_rel, "voicing_flips": vflips, "voicing_flips_flat": vflips_flat,
               "flat_frames": flat, "other_lag_picks": picks, "frames": frames}
        sub_share = ""
        if name.startswith("glides"):  # the share of voiced frames the extractor puts off the seeded f0
            for side, feats in (("card", got), ("cpu", want)):
                per_item = [seeded_f0_frames(f0, t) for (_, f0), (_, t) in zip(feats, high)]
                off = sum(int((rel > VOC_F0_RTOL).sum()) for _, _, _, rel in per_item)
                rep[f"subharmonic_share_{side}"] = off / max(sum(int(v.sum()) for _, _, v, _ in per_item), 1)
            sub_share = (f"; voiced frames off the seeded f0 by more than {VOC_F0_RTOL:.0%} (subharmonic picks): "
                         f"card {rep['subharmonic_share_card']:.4f}, CPU {rep['subharmonic_share_cpu']:.4f}")
        card_vs_cpu[name] = rep
        say(f"one chunk of {VOC_CHUNK} {name} on the card vs the CPU: mel max |10^a - 10^b| / frame max "
            f"{mel_err:.3e} (tol 1e-5: f32 FFTs and mel products, TF32 off), f0 voiced max rel {f0_rel:.3e} "
            f"(tol 1e-4); set apart: voicing flips {vflips} ({vflips_flat} at flat frames), flat frames {flat}, "
            f"other-lag picks {picks}, of "
            f"{frames} frames (tol 1 % together){sub_share}")
        if mel_err > 1e-5 or f0_rel > 1e-4 or vflips + flat + picks > 0.01 * frames:
            raise AssertionError(f"the card's mel and f0 of the {name} chunk disagree with the CPU's")
    x = stack(chunks[next(iter(chunks))])
    mel_ms = time_ms(lambda: batched_log10_mel(x), iters=10)
    f0_ms = time_ms(lambda: batched_f0(x, n_frames=x.shape[1] // HOP + 1), iters=10)
    say(f"card ms per chunk [{VOC_CHUNK}, {x.shape[1]}]: mel {mel_ms:.3f}, f0 {f0_ms:.3f}; on {smi}")
    return binary, {"items": st["items"], "seconds": total_s, "items_per_s": st["items"] / total_s,
                    "features_s": st["features_s"], "chunks": st["chunks"], "workers": st["workers"],
                    "bank_s": st["bank_s"], "bank_bytes": st["bank_bytes"], "splits": st["splits"],
                    "chunk_shape": list(x.shape), "mel_ms": mel_ms, "f0_ms": f0_ms,
                    "f0_max_rel_err": worst, "card_vs_cpu": card_vs_cpu}


def vocoder_training(root, binary, smi):
    """Phase 11b: run.main with the recipe's HiFi-GAN config (generator 512
    channels, MPD + MSD, 24 crops of 8192 samples) on 11a's binaries,
    disc_start_steps 2: 2 steps (D and its optimizer untouched), a resume
    to 8 (D trained from step 2), a resume to 10, --infer; then step times
    with the card synchronized, and one step under amp beside one in f32.
    Returns the report."""
    from dicttts_tpu_torch import run
    from dicttts_tpu_torch.train.tasks.hifigan import HifiGanTask

    hparams = f"binary_data_dir={binary},disc_start_steps=2,val_check_interval=8"

    def main(max_updates, *extra):
        with in_dir(root):
            out = run.main(["--config", os.path.join(REPO, VOCODER_CONFIG), "--exp_name", "vocoder",
                            "--device", "cuda", *extra, "--hparams", f"{hparams},max_updates={max_updates}"])
            torch.cuda.synchronize()
        return out

    def finite(trainer):
        return all(math.isfinite(float(v)) for v in (*trainer.metrics.values(), *trainer.val_metrics.values()))

    torch.cuda.reset_peak_memory_stats()
    trainer, task = main(2)
    cfg = task.cfg
    if (cfg["max_sentences"], cfg["max_samples"], cfg["upsample_initial_channel"]) != (24, 8192, 512):
        raise AssertionError("not the recipe's HiFi-GAN widths")
    init = HifiGanTask(cfg, device="cuda")
    init.build_state(trainer.seed)
    same = all(torch.equal(a, b) for a, b in zip(init.disc.state_dict().values(), task.disc.state_dict().values()))
    if not (same and untouched(task.opt_d) and task.updates_d == 0 and task.updates_g == 2
            and finite(trainer)):
        raise AssertionError("the discriminator or its optimizer moved before disc_start_steps")
    d2 = {k: v.clone() for k, v in task.disc.state_dict().items()}
    history = list(trainer.history)
    del init, task
    trainer, task = main(8)
    moved = sum(not torch.equal(d2[k], v) for k, v in task.disc.state_dict().items())
    opt_d = task.opt_d.state_dict()["state"]
    if not (task.updates_d == 6 and moved == len(d2) and opt_d and all(int(v["step"]) == 6 for v in opt_d.values())
            and finite(trainer)):
        raise AssertionError(f"D after its start: {task.updates_d} updates, {moved} of {len(d2)} tensors moved")
    history += trainer.history
    trainer, task = main(10)
    if trainer.global_step != 10 or task.updates_d != 8 or not finite(trainer):
        raise AssertionError("the resume to step 10 failed")
    history += trainer.history
    peak_train = torch.cuda.max_memory_allocated() / 2**30
    losses = {k: float(v) for k, v in trainer.metrics.items()}
    say(f"10 steps over 3 runs (2 D-free, a resume to 8, a resume to 10): last losses "
        + " ".join(f"{k}={v:.4f}" for k, v in losses.items()) + f"; peak memory {peak_train:.2f} GiB; "
        f"host wait per batch median {statistics.median(h['wait_ms'] for h in history):.3f} ms, "
        f"max {max(h['wait_ms'] for h in history):.3f}; on {smi}")

    # step times, the card synchronized around each step (repeats only)
    batch = task.to_device(next(iter(task.train_batches())))

    def timed(step, n=3):
        ms = []
        for _ in range(n + 1):
            task.step = step
            torch.cuda.synchronize()
            t = time.perf_counter()
            task.train_step(batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return ms[1:]

    g_only, gan = timed(0), timed(2)

    def gan_step():
        task.step = 2
        task.train_step(batch)

    profiled = profile_step(gan_step, "HiFi-GAN GAN step, 24 x 8192 samples", smi, top=12)
    torch.cuda.empty_cache()
    peaks = {}
    for amp in (False, True):
        t = HifiGanTask({**cfg, "amp": amp}, device="cuda")
        t.build_state(trainer.seed)
        t.load_state_dict(task.state_dict())
        t.step = 2
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m = t.train_step(batch)
        torch.cuda.synchronize()
        peaks["amp" if amp else "f32"] = torch.cuda.max_memory_allocated() / 2**30
        if not all(bool(torch.isfinite(v)) for v in m.values()):
            raise AssertionError(f"a {'amp' if amp else 'f32'} step is not finite: {m}")
        del t
    say(f"step ms at 24 x 8192 samples: G only {' '.join(f'{x:.1f}' for x in g_only)}, GAN "
        f"{' '.join(f'{x:.1f}' for x in gan)}; one GAN step's peak memory f32 {peaks['f32']:.2f} GiB, "
        f"amp {peaks['amp']:.2f} GiB; on {smi}")
    del task
    trainer, task = main(10, "--infer")
    outputs = trainer.test(task)
    shapes = {o["wav_out"].shape for o in outputs}
    if shapes != {(24, 32 * HOP)} or not all(np.isfinite(o["wav_out"]).all() for o in outputs):
        raise AssertionError(f"--infer gave wavs of {shapes}, not 24 x T_mel * 256 = 8192")
    say(f"--infer: {len(outputs)} batches of 24 crops of 32 frames -> wavs {shapes.pop()}, finite, in "
        f"{trainer.test_seconds * 1e3:.1f} ms")
    return {"losses": losses, "peak_gib": peak_train, "g_only_ms": g_only, "gan_ms": gan,
            "wait_ms": [h["wait_ms"] for h in history], "step_peak_gib": peaks,
            "infer_batches": len(outputs), "profile": profiled}


def vocoder_card_vs_cpu(binary, smi):
    """Phase 11c: one HiFi-GAN step on the card and on the CPU from the same
    weights and crops, generator width 32, 2 crops of 2048 samples, the
    discriminator on: every loss and both gradient norms."""
    from dicttts_tpu_torch.data.datasets import VocoderDataset
    from dicttts_tpu_torch.train.tasks.hifigan import HifiGanTask

    cfg = {"upsample_initial_channel": 32, "max_samples": 2048, "disc_start_steps": 0}
    batch = next(VocoderDataset(binary, "train", cfg, batch_size=2).train_batches())
    out = {}
    card = HifiGanTask(cfg, device="cuda")
    card.build_state(SEED + 12)
    cpu = HifiGanTask(cfg, device="cpu")
    cpu.build_state(SEED + 12)
    cpu.model.load_state_dict(card.model.state_dict())
    cpu.disc.load_state_dict(card.disc.state_dict())
    for name, task in (("card", card), ("cpu", cpu)):
        t = time.perf_counter()
        out[name] = {k: float(v) for k, v in task.train_step(task.to_device(batch)).items()}
        say(f"{name}: one step {(time.perf_counter() - t) * 1e3:.1f} ms")
    rtol, worst = 1e-3, 0.0  # TF32 off; cuDNN and the CPU sum in different orders
    for k, ref in out["cpu"].items():
        rel = abs(out["card"][k] - ref) / max(abs(ref), 1e-6)
        worst = max(worst, rel)
        say(f"  {k}: card {out['card'][k]:.6f} cpu {ref:.6f} rel {rel:.2e}")
    say(f"card vs CPU: worst relative difference {worst:.2e} (tol {rtol:.0e}) over {len(out['cpu'])} "
        f"losses and gradient norms; on {smi}")
    if set(out["card"]) != set(out["cpu"]) or worst > rtol:
        raise AssertionError("card and CPU HiFi-GAN steps disagree")
    return worst


def ps_batch(rng, B, T_ph, Tw, T):
    """A word batch in the collater's format: BOS, words of 1-3 phones and
    8-20 frames, mels zero past each row's length, phones and words
    padded; the last row 3/4 of the others' length."""
    lengths = [T] * (B - 1) + [3 * T // 4]
    ph2word = np.zeros((B, T_ph), np.int32)
    m2w = np.zeros((B, T), np.int32)
    wl = np.zeros(B, np.int32)
    for b, n_frames in enumerate(lengths):
        f = w = p = 0
        while f < n_frames and w < Tw and p < T_ph:
            n_ph = min(rng.randint(1, 4), T_ph - p)
            d = min(rng.randint(8, 21), n_frames - f)
            ph2word[b, p:p + n_ph], m2w[b, f:f + d] = w + 1, w + 1
            f, w, p = f + d, w + 1, p + n_ph
        wl[b] = w
    return {"txt_tokens": np.where(ph2word > 0, rng.randint(3, 60, ph2word.shape), 0).astype(np.int32),
            "ph2word": ph2word, "mel2word": m2w,
            "word_tokens": np.where(np.arange(Tw)[None] < wl[:, None], 5, 0).astype(np.int32),
            "mels": (rng.randn(B, T, 80) * 0.8 - 4.5).astype(np.float32) * (m2w > 0)[:, :, None],
            "word_lengths": wl, "mel_lengths": np.array(lengths, np.int32)}


def ps_widths(task) -> str:
    c, m = task.cfg, task.model
    glow = m.post_flow
    return (f"hidden {c['hidden_size']}, phone encoder {c['enc_layers']} + word encoder "
            f"{c['word_enc_layers']} layers, FVAE {c['fvae_enc_n_layers']}/{c['fvae_dec_n_layers']} "
            f"at {c['fvae_enc_dec_hidden']}, prior flow {c['prior_glow_n_blocks']} blocks, n_vocab "
            f"{c['n_vocab']}, max_tokens {c['max_tokens']}, "
            + (f"post-glow {len(glow.coupling)} blocks of {c['post_glow_n_block_layers']} layers at "
               f"{c['post_glow_hidden']} ({len(glow.shared_wn)} shared WN), " if glow is not None else "")
            + f"{sum(p.numel() for p in m.parameters()) / 1e6:.2f}M generator parameters")


def portaspeech_adv(root, binary, smi):
    """Phase 12a: configs/datasets/biaobei/ps_adv.yaml through run.main on
    the corpus: PS_STEPS steps with validations and checkpoints, a resume
    for PS_RESUME more, --infer over the test split. Returns the report and
    the launch counts of each run."""
    hp = (f"binary_data_dir={binary},max_updates={PS_STEPS},val_check_interval={PS_STEPS // 2},"
          "num_sanity_val_steps=1")
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    trainer, task, train_launches = run_main(root, "ps_adv", hp, config=PS_ADV_CONFIG)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"ps_adv: {ps_widths(task)}")
    say(f"ps_adv: run.main trained {trainer.global_step} steps in {time.time() - t:.1f} s (validations "
        f"and checkpoints included); peak memory {peak:.2f} GiB; launches (K1, K2, K3) {train_launches}; "
        f"on {smi}")
    report = {"peak_gib": peak, "train": step_report(trainer.history, "ps_adv train", smi)}
    vals, finite = finite_run(trainer, task)
    say(f"ps_adv last step: {vals}; validation: {trainer.val_metrics}")
    if not (trainer.global_step == task.updates_g == task.updates_d == PS_STEPS and finite):
        raise AssertionError(f"ps_adv did not train {PS_STEPS} finite steps of both optimizers")
    del trainer, task
    trainer, task, resume_launches = run_main(root, "ps_adv", f"max_updates={PS_STEPS + PS_RESUME}",
                                              config=PS_ADV_CONFIG)
    report["resume"] = step_report(trainer.history, "ps_adv resume", smi)
    if [h["step"] for h in trainer.history] != [PS_STEPS + i + 1 for i in range(PS_RESUME)]:
        raise AssertionError("the resumed ps_adv run did not continue from its checkpoint")
    del trainer, task
    trainer, task, infer_launches = run_main(root, "ps_adv", "", "--infer", config=PS_ADV_CONFIG)
    n_test = CORPUS_SPLITS["test"]
    report["test_ms_per_utterance"] = trainer.test_seconds / n_test * 1e3
    say(f"ps_adv --infer: {n_test} test utterances in {trainer.test_seconds:.2f} s, "
        f"{report['test_ms_per_utterance']:.2f} ms per utterance (batches of 1, max_frames "
        f"{task.cfg['max_frames']}, no writes); on {smi}")
    del trainer, task
    torch.cuda.empty_cache()
    return report, {"ps_adv_train": train_launches, "ps_adv_resume": resume_launches,
                    "ps_adv_infer": infer_launches}


def portaspeech_flow(root, binary, smi):
    """Phase 12b: configs/datasets/biaobei/ps_flow.yaml with use_post_glow,
    post_glow_training_start cut to PS_FLOW_SWITCH: PS_FLOW_STOP steps
    (stage 1), a resume to PS_FLOW_STEPS across the switch, each stage's
    frozen part checked untouched through the checkpoints, then --infer
    with the Glow's sample. Returns the report and the launch counts."""
    from dicttts_tpu_torch.train.tasks.ps_flow import POST_FLOW_PREFIX
    from dicttts_tpu_torch.utils.checkpoint import load_checkpoint

    work_dir = os.path.join(root, "checkpoints", "ps_flow")
    hp = (f"binary_data_dir={binary},max_updates={PS_FLOW_STOP},val_check_interval={PS_FLOW_SWITCH},"
          f"num_sanity_val_steps=1,use_post_glow=True,post_glow_training_start={PS_FLOW_SWITCH}")
    torch.cuda.reset_peak_memory_stats()
    trainer, task, first = run_main(root, "ps_flow", hp, config=PS_FLOW_CONFIG)
    say(f"ps_flow: {ps_widths(task)}")
    with torch.random.fork_rng(devices=[]):  # the weights build_state(seed) made, before any step
        torch.manual_seed(trainer.seed)
        init = task.build_model().state_dict()
    history = list(trainer.history)
    del trainer, task
    trainer, task, second = run_main(root, "ps_flow", f"max_updates={PS_FLOW_STEPS}",
                                     config=PS_FLOW_CONFIG)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    history += trainer.history
    report = {"peak_gib": peak, "train": step_report(history, "ps_flow train", smi)}
    # h["step"] counts the steps taken, this one included: stage 2 from the switch on
    report["stage_ms"] = {f"stage {1 + (h['step'] > PS_FLOW_SWITCH)}": [] for h in history}
    for h in history:
        report["stage_ms"][f"stage {1 + (h['step'] > PS_FLOW_SWITCH)}"].append(
            [h["step"], f"{h['sentences']}x{h['frames']}", h["step_ms"]])
    say(f"ps_flow step, batch and ms by stage: {report['stage_ms']}; on {smi}")
    vals, finite = finite_run(trainer, task)
    say(f"ps_flow last step: {vals}; validation: {trainer.val_metrics}; peak memory {peak:.2f} GiB; "
        f"launches (K1, K2, K3) {first} then {second}; on {smi}")
    counts = (task.step, task.updates_g, task.updates_pf, task.updates_d)
    want = (PS_FLOW_STEPS, PS_FLOW_SWITCH, PS_FLOW_STEPS - PS_FLOW_SWITCH, 0)
    if counts != want or not finite or float(vals["post_stage"]) != 1.0:
        raise AssertionError(f"ps_flow (step, main, post-flow, disc updates) {counts}, not {want}")
    ckpt = {n: load_checkpoint(os.path.join(work_dir, f"model_ckpt_steps_{n}.ckpt"))[1]["params_g"]
            for n in (PS_FLOW_STOP, PS_FLOW_SWITCH, PS_FLOW_STEPS)}

    def same(a, b, post):
        return all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a if k.startswith(POST_FLOW_PREFIX) == post)

    checks = {"post-flow untouched in stage 1": same(init, ckpt[PS_FLOW_SWITCH], True),
              "main untouched in stage 2": same(ckpt[PS_FLOW_SWITCH], ckpt[PS_FLOW_STEPS], False),
              "main trained in stage 1 (after the resume too)": not same(ckpt[PS_FLOW_STOP],
                                                                         ckpt[PS_FLOW_SWITCH], False),
              "post-flow trained in stage 2": not same(ckpt[PS_FLOW_SWITCH], ckpt[PS_FLOW_STEPS], True)}
    say(f"ps_flow partitions through checkpoints {sorted(ckpt)}: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"ps_flow stages moved the wrong partition: {checks}")
    del trainer, task
    trainer, task, infer_launches = run_main(root, "ps_flow", "", "--infer", config=PS_FLOW_CONFIG)
    n_test = CORPUS_SPLITS["test"]
    report["test_ms_per_utterance"] = trainer.test_seconds / n_test * 1e3
    zero_launch_counts()
    outputs = trainer.test(task)  # run.main --infer returns none; the same pass again
    torch.cuda.synchronize()
    infer_launches = tuple(a + b for a, b in zip(infer_launches, launch_counts()))
    mels = [o["mel_out"][0][o["mel2word"][0] > 0] for o in outputs]
    spread = [float(m.std()) for m in mels]
    say(f"ps_flow --infer with the post-glow sample: {n_test} test utterances in "
        f"{trainer.test_seconds:.2f} s, {report['test_ms_per_utterance']:.2f} ms per utterance; frames "
        f"{[len(m) for m in mels]}, mel std {min(spread):.4f}-{max(spread):.4f}; on {smi}")
    if not (len(mels) == n_test and all(len(m) and np.isfinite(m).all() for m in mels)
            and min(spread) > 0):
        raise AssertionError("ps_flow --infer mels are not finite, or empty, or all equal")
    report["counts"] = dict(zip(("step", "updates_main", "updates_post_flow", "updates_disc"), counts))
    del trainer, task
    torch.cuda.empty_cache()
    return report, {"ps_flow_train": tuple(a + b for a, b in zip(first, second)),
                    "ps_flow_infer": infer_launches}


def portaspeech_card_vs_cpu(smi):
    """Phase 12c: one ps_adv step and one post-glow stage-2 step on the card
    and on the CPU from the same weights, batch, noise and crop starts, at
    B=2 and PS_CHECK_CFG's small widths: every loss and gradient norm."""
    from dicttts_tpu_torch.train.tasks.ps_adv import PortaSpeechAdvTask
    from dicttts_tpu_torch.train.tasks.ps_flow import PortaSpeechFlowTask

    rng = np.random.RandomState(SEED + 12)
    B, T = 2, 128
    batch = ps_batch(rng, B, 24, 10, T)
    eps = torch.tensor(rng.randn(B, T // 4, PS_CHECK_CFG["latent_size"]).astype(np.float32))
    sg = crop_starts(rng.rand(3), batch["mel_lengths"], T)
    sd = crop_starts(rng.rand(3), batch["mel_lengths"], T)
    rtol, worst = 2e-3, 0.0  # TF32 off; cuDNN and the CPU sum in different orders
    for label, cls, extra in (("ps_adv", PortaSpeechAdvTask, {}),
                              ("ps_flow stage 2", PortaSpeechFlowTask,
                               {"use_post_glow": True, "post_glow_training_start": 0})):
        cfg = {**PS_CHECK_CFG, **extra}
        card, cpu = cls(cfg, device="cuda"), cls(cfg, device="cpu")
        card.build_state(SEED + 13)
        cpu.build_state(SEED + 13)
        cpu.model.load_state_dict(card.model.state_dict())
        cpu.disc.load_state_dict(card.disc.state_dict())
        out = {}
        for name, task in (("card", card), ("cpu", cpu)):
            dev = task.device
            m = task.train_step(task.to_device(batch), eps=eps.to(dev), start_frames_g=sg.to(dev),
                                start_frames_d=sd.to(dev))
            out[name] = {k: float(v) for k, v in m.items()}
        for k, ref in out["cpu"].items():
            rel = abs(out["card"][k] - ref) / max(abs(ref), 1e-6)
            worst = max(worst, rel)
            say(f"  {label} {k}: card {out['card'][k]:.6f} cpu {ref:.6f} rel {rel:.2e}")
        if set(out["card"]) != set(out["cpu"]):
            raise AssertionError(f"{label}: card and CPU report different values")
    say(f"card vs CPU: worst relative difference {worst:.2e} (tol {rtol:.0e}) over both steps' losses "
        f"and gradient norms; on {smi}")
    if worst > rtol:
        raise AssertionError("card and CPU PortaSpeech steps disagree")
    return worst


def fs2_widths(task) -> str:
    c, m = task.cfg, task.model
    return (f"encoder {c['encoder_type']} ({c['enc_layers']} layers, ffn k{c['enc_ffn_kernel_size']}), "
            f"decoder {c['decoder_type']} ({c['dec_layers']} layers, k{c['dec_ffn_kernel_size']}), hidden "
            f"{c['hidden_size']}, pitch {c['use_pitch_embed']} ({c['pitch_norm']}, uv {c['use_uv']}), n_vocab "
            f"{c['n_vocab']}, max_tokens {c['max_tokens']}, mel loss {c['mel_loss']}, "
            f"{sum(p.numel() for p in m.parameters()) / 1e6:.2f}M parameters")


def fastspeech2_recipe(root, binary, smi):
    """Phase 13a: configs/datasets/biaobei/fs2.yaml through run.main on the
    corpus: FS2_STEPS steps with validations and checkpoints (each group
    of steps ends synchronized, for its time), a profiled step of the largest batch and
    one of the shape whose repeats were slowest, a resume for FS2_RESUME
    more, --infer over the test split. Returns the
    report, the launch counts of each run, the recipe's config and the
    largest batch (host arrays)."""
    hp = (f"binary_data_dir={binary},max_updates={FS2_STEPS},val_check_interval={FS2_STEPS // 2},"
          "num_sanity_val_steps=1")
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    trainer, task, train_launches = run_main(root, "fs2", hp, config=FS2_CONFIG)  # a group ends synchronized
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"fs2: {fs2_widths(task)}")
    say(f"fs2: run.main trained {trainer.global_step} steps in {time.time() - t:.1f} s (validations and "
        f"checkpoints included); peak memory {peak:.2f} GiB; launches (K1, K2, K3) {train_launches}; on {smi}")
    report = {"peak_gib": peak, "train": step_report(trainer.history, "fs2 train", smi)}
    say("fs2 train steps in order (step, shape, host wait ms, step ms): " + "; ".join(
        f"{h['step']} {h['sentences']}x{h['frames']} {h['wait_ms']:.1f} {h['step_ms']:.1f}" for h in trainer.history))
    vals, finite = finite_run(trainer, task)
    say(f"fs2 last step: {vals}; validation: {trainer.val_metrics} (f0 in Hz: its loss ~1e4)")
    if not (trainer.global_step == task.step == FS2_STEPS and finite):
        raise AssertionError(f"fs2 did not train {FS2_STEPS} finite steps")
    batches = [{k: v for k, v in b.items() if k != "_meta"} for b in task.train_batches()]
    big = max(batches, key=lambda b: b["mels"].shape[0] * b["mels"].shape[1])
    # the largest batch, and the shape whose repeated steps were slowest where that is another
    repeats = {shape: statistics.median(ms[1:]) for shape, ms in report["train"]["step_ms"].items()
               if len(ms) > 1}
    slowest = max(repeats, key=repeats.get) if repeats else None
    picks = [big] + [b for b in batches if b is not big and "x".join(map(str, b["mels"].shape[:2])) == slowest
                     and b["mels"].shape[:2] != big["mels"].shape[:2]][:1]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    zero_launch_counts()
    report["profile"] = []
    for b in picks:
        shape = tuple(b["mels"].shape[:2])
        dev = task.to_device(b)
        prof = profile_step(lambda: task.train_step(dev, gen), f"fs2 step {shape[0]}x{shape[1]}", smi, top=12)
        report["profile"].append({"shape": shape, **(prof or {"fft_kernels": None})})
        del dev
    report["step_gap"] = fs2_step_gap(task, batches, big, gen, smi)
    torch.cuda.synchronize()
    profile_launches = launch_counts()
    cfg = dict(task.cfg)
    del trainer, task
    trainer, task, resume_launches = run_main(root, "fs2", f"max_updates={FS2_STEPS + FS2_RESUME}",
                                              config=FS2_CONFIG)
    report["resume"] = step_report(trainer.history, "fs2 resume", smi)
    if [h["step"] for h in trainer.history] != [FS2_STEPS + i + 1 for i in range(FS2_RESUME)]:
        raise AssertionError("the resumed fs2 run did not continue from its checkpoint")
    del trainer, task
    trainer, task, infer_launches = run_main(root, "fs2", "", "--infer", config=FS2_CONFIG)
    n_test = CORPUS_SPLITS["test"]
    report["test_ms_per_utterance"] = trainer.test_seconds / n_test * 1e3
    zero_launch_counts()
    outputs = trainer.test(task)  # run.main --infer returns none; the same pass again
    torch.cuda.synchronize()
    infer_launches = tuple(a + b for a, b in zip(infer_launches, launch_counts()))
    frames = [int((o["mel2ph"][0] > 0).sum()) for o in outputs]
    ok = all(np.isfinite(o["mel_out"]).all() and not o["mel_out"][0, n:].any() and o["mel_out"][0, :n].std() > 0
             for o, n in zip(outputs, frames))
    say(f"fs2 --infer: {n_test} test utterances in {trainer.test_seconds:.2f} s, "
        f"{report['test_ms_per_utterance']:.2f} ms per utterance (batches of 1, max_frames "
        f"{task.cfg['max_frames']}, no writes); frames {frames}; on {smi}")
    if not (len(outputs) == n_test and min(frames) > 0 and ok):
        raise AssertionError("fs2 --infer mels are not finite, empty, all equal or nonzero past their frames")
    del trainer, task
    torch.cuda.empty_cache()
    return report, {"fs2_train": train_launches, "fs2_profile": profile_launches,
                    "fs2_resume": resume_launches, "fs2_infer": infer_launches}, cfg, big


def fs2_step_gap(task, batches, big, gen, smi, n=3):
    """Phase 13a: what the trainer's step ms holds beyond a profiled step.
    The largest batch's step, each synchronized and timed as the trainer
    times it (the transfer and the step), n times each:
    - on_card: the batch already on the card, as profiled (no transfer);
    - to_device: the transfer alone;
    - with_to_device: the transfer and the step;
    - after_other_shape: right after a step of another shape;
    - after_smallest: right after a step of the smallest batch, which ends
      each epoch of the trainer;
    - after_idle: after the card idled 30 ms, as through the host wait at
      an epoch's start;
    - during_prefetch: while the trainer's prefetch thread collates an
      epoch (started just before);
    - epoch_start: as the trainer starts an epoch, a new prefetch thread
      and its first batch (the largest, in this corpus's order) taken from
      it, then that batch's step.
    With the segments the caching allocator took from cudaMalloc in each."""
    from dicttts_tpu_torch.utils.prefetch import prefetch_iterator

    def segments():
        return torch.cuda.memory_stats().get("segment.all.allocated", 0)

    host = {k: v for k, v in big.items() if k != "_meta"}
    dev = task.to_device(host)
    others = [b for b in batches if b["mels"].shape[:2] != big["mels"].shape[:2]] or [big]
    smallest = min(batches, key=lambda b: b["mels"].shape[0] * b["mels"].shape[1])

    def step(batch=host):
        return task.train_step(task.to_device(batch), gen)

    def run(timed, prep=lambda i: None):
        ms, segs = [], []
        for i in range(n):
            prep(i)
            torch.cuda.synchronize()
            s0 = segments()
            ms += timed_ms(timed)
            segs.append(segments() - s0)
        return {"ms": ms, "cuda_mallocs": segs}

    out = {"on_card": run(lambda: task.train_step(dev, gen)), "to_device": run(lambda: task.to_device(host)),
           "with_to_device": run(step),
           "after_other_shape": run(step, lambda i: step(others[i % len(others)])),
           "after_smallest": run(step, lambda i: step(smallest)),
           "after_idle": run(step, lambda i: (torch.cuda.synchronize(), time.sleep(0.03)))}
    del dev
    for name in ("during_prefetch", "epoch_start"):
        ms, segs, shapes = [], [], []
        for _ in range(n):
            torch.cuda.synchronize()
            with contextlib.closing(prefetch_iterator(task.train_batches(), depth=8)) as epoch:
                batch = host if name == "during_prefetch" else {k: v for k, v in next(epoch).items() if k != "_meta"}
                shapes.append("x".join(map(str, batch["mels"].shape[:2])))
                s0 = segments()
                ms += timed_ms(lambda: step(batch))
                segs.append(segments() - s0)
                for _b in epoch:  # let the thread finish its epoch before the next one starts
                    pass
        out[name] = {"ms": ms, "cuda_mallocs": segs, "shapes": shapes}
    shape = "x".join(map(str, big["mels"].shape[:2]))
    say(f"fs2 {shape} step, synchronized, ms (cudaMalloc segments): " + "; ".join(
        f"{k} {[round(x, 1) for x in v['ms']]} ({v['cuda_mallocs']})" for k, v in out.items())
        + f"; epoch_start stepped {out['epoch_start']['shapes']}; on {smi}")
    return out


def timed_ms(fn, n=1):
    """Host ms of ``fn()`` with the card synchronized around it, over n calls."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def fs2_registry(cfg, batch, smi):
    """Phase 13b: each other encoder and decoder of FastSpeech2's registry
    at the recipe's width on one corpus batch: a train step (the first,
    then one timed) and an inference of its first row, both finite."""
    from dicttts_tpu_torch.train.tasks.fs2 import FastSpeech2Task

    report = {}
    shape = tuple(batch["mels"].shape[:2])
    for enc, dec in FS2_OTHER_ENTRIES:
        task = FastSpeech2Task({**cfg, "encoder_type": enc, "decoder_type": dec}, device="cuda")
        task.build_state(SEED)
        dev = task.to_device(batch)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
        steps = []
        first = timed_ms(lambda: steps.append(task.train_step(dev, gen)))[0]
        step = timed_ms(lambda: steps.append(task.train_step(dev, gen)))[0]
        outs = []
        infer = timed_ms(lambda: outs.append(task.test_step({"txt_tokens": dev["txt_tokens"][:1]})), 2)
        n = int((outs[-1]["mel2ph"] > 0).sum())
        finite = (all(bool(torch.isfinite(v)) for m in steps for v in m.values())
                  and bool(torch.isfinite(outs[-1]["mel_out"]).all())
                  and all(bool(torch.isfinite(p).all()) for p in task.model.parameters()))
        n_params = sum(p.numel() for p in task.model.parameters()) / 1e6
        say(f"fs2 {enc} + {dec} ({n_params:.2f}M parameters) at {shape[0]}x{shape[1]}: first step "
            f"{first:.1f} ms, step {step:.1f} ms, inference of one row {infer[-1]:.1f} ms ({n} frames); "
            f"loss {float(steps[-1]['total_loss']):.2f}; on {smi}")
        if not finite or n == 0:
            raise AssertionError(f"fs2 {enc} + {dec}: a value is not finite, or no frame was predicted")
        report[f"{enc}+{dec}"] = {"first_ms": first, "step_ms": step, "infer_ms": infer[-1], "frames": n}
        del task, dev, steps, outs
    torch.cuda.empty_cache()
    return report


def transformer_tts_phase(batch, n_vocab, smi):
    """Phase 13c: TransformerTTS at its default widths on a corpus batch: a
    teacher-forced train step (L1 mel + stop BCE, AdamW), a cached decode
    of TTS_DECODE_FRAMES frames at B = 1 and 16, and the decode against the
    teacher-forced pass on the frames it produced (prenet dropout 0)."""
    from dicttts_tpu_torch.models.transformer_tts import TransformerTTS

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        model = TransformerTTS(vocab_size=n_vocab).cuda()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.98))
    tokens = torch.as_tensor(batch["txt_tokens"], device="cuda")
    mels = torch.as_tensor(batch["mels"], device="cuda").float()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    nonpad = (mels.abs().sum(-1) > 0).float()
    last = (torch.arange(mels.shape[1], device="cuda")[None] >= nonpad.sum(1, keepdim=True) - 1).float()
    losses = []

    def step():
        model.train()
        opt.zero_grad(set_to_none=True)
        out = model(tokens, mels, generator=gen)
        l1 = ((out["mel_out"] - mels).abs().mean(-1) * nonpad).sum() / nonpad.sum()
        stop = torch.nn.functional.binary_cross_entropy_with_logits(out["stop_logits"], last)
        (l1 + stop).backward()
        opt.step()
        losses.append(float((l1 + stop).detach()))

    train_ms = timed_ms(step, 4)
    model.eval()
    decode = {}
    for B in (1, 16):
        model.infer(tokens[:B], 8, generator=gen)  # warm-up: this batch size's first kernels
        outs = []
        ms = timed_ms(lambda: outs.append(model.infer(tokens[:B], TTS_DECODE_FRAMES, generator=gen)))[0]
        decode[B] = {"ms": ms, "ms_per_frame": ms / TTS_DECODE_FRAMES,
                     "stops": outs[0]["out_mask"].sum(1).tolist()[:4]}
        if not bool(torch.isfinite(outs[0]["mel_raw"]).all()):
            raise AssertionError(f"TransformerTTS decode at B={B} is not finite")
    model.prenet_dropout = 0.0
    dec = model.infer(tokens[:2], TTS_DECODE_FRAMES)
    with torch.no_grad():
        tf = model(tokens[:2], dec["mel_raw"])
    err = float((tf["mel_out"] - dec["mel_raw"]).abs().max())
    err_stop = float((tf["stop_logits"] - dec["stop_logits"]).abs().max())
    n_params = sum(p.numel() for p in model.parameters()) / 1e6
    say(f"TransformerTTS (hidden {model.hidden_size}, {len(model.encoder.attn)} + {len(model.dec_layers)} "
        f"layers, {n_params:.2f}M parameters) at {tokens.shape[0]} x "
        f"{mels.shape[1]} frames: train step ms {' '.join(f'{x:.1f}' for x in train_ms)} (the first is the "
        f"shape's first), losses {losses[0]:.3f} -> {losses[-1]:.3f}; cached decode of {TTS_DECODE_FRAMES} "
        f"frames: B=1 {decode[1]['ms']:.1f} ms ({decode[1]['ms_per_frame']:.3f} ms a frame), B=16 "
        f"{decode[16]['ms']:.1f} ms ({decode[16]['ms_per_frame']:.3f} ms a frame); decode vs teacher-forced "
        f"on its own frames: max |d mel| {err:.2e}, |d stop| {err_stop:.2e} (tol 1e-3); on {smi}")
    if not all(math.isfinite(x) for x in losses) or max(err, err_stop) > 1e-3:
        raise AssertionError("TransformerTTS: a non-finite loss, or the decode disagrees with its teacher-forced pass")
    del model, opt
    torch.cuda.empty_cache()
    return {"train_ms": train_ms, "decode": decode, "decode_vs_teacher_forced": [err, err_stop]}


def ge2e_card_vs_cpu(smi):
    """Phase 13d: the GE2E encoder (Resemblyzer's widths, a seeded
    state_dict) embeds one 7 s utterance on the card and on the CPU."""
    from dicttts_tpu_torch.models.speaker_encoder import GE2ESpeakerEncoder, embed_utterance

    rng = np.random.RandomState(SEED + 16)
    sd = {}
    for k in range(3):
        sd[f"lstm.weight_ih_l{k}"] = rng.randn(1024, 40 if k == 0 else 256) * 0.06
        sd[f"lstm.weight_hh_l{k}"] = rng.randn(1024, 256) * 0.06
        sd[f"lstm.bias_ih_l{k}"] = rng.randn(1024) * 0.05
        sd[f"lstm.bias_hh_l{k}"] = rng.randn(1024) * 0.05
    sd["linear.weight"], sd["linear.bias"] = rng.randn(256, 256) * 0.06, rng.randn(256) * 0.05
    mel = np.abs(rng.randn(700, 40)).astype(np.float32)
    cpu = GE2ESpeakerEncoder.from_state_dict(sd).eval()
    card = GE2ESpeakerEncoder.from_state_dict(sd).cuda().eval()
    embed_utterance(card, mel)  # warm-up
    got = []
    ms = timed_ms(lambda: got.append(embed_utterance(card, mel)), 3)
    want = embed_utterance(cpu, mel)
    err = float(np.abs(got[-1] - want).max())
    say(f"GE2E embed_utterance of 700 frames (8 windows of 160) on the card in {min(ms):.2f}-{max(ms):.2f} ms; "
        f"card vs CPU max |d| {err:.2e} (tol 1e-4) on a unit-norm 256-d embedding; on {smi}")
    if err > 1e-4 or not np.isfinite(got[-1]).all():
        raise AssertionError("the GE2E embeddings of the card and the CPU disagree")
    return {"ms": ms, "max_abs_err": err}


def fs_batch(rng, B, T_txt, T, n_vocab):
    """A phone-level batch in the collater's format ('fs'): phones padded,
    random durations, mels zero past each row's frames, f0 in Hz through
    the unvoiced frames (uv 1), the last row 3/4 of the others' length."""
    lengths = [T] * (B - 1) + [3 * T // 4]
    tokens, mel2ph = np.zeros((B, T_txt), np.int32), np.zeros((B, T), np.int32)
    for b, n_fr in enumerate(lengths):
        n_ph = T_txt - 2 * b
        tokens[b, :n_ph] = rng.randint(1, n_vocab, n_ph)
        cuts = np.sort(rng.choice(np.arange(1, n_fr), n_ph - 1, replace=False))
        mel2ph[b, :n_fr] = np.searchsorted(cuts, np.arange(n_fr), side="right") + 1
    real = mel2ph > 0
    return {"txt_tokens": tokens, "mel2ph": mel2ph,
            "mels": ((rng.randn(B, T, 80) * 0.8 - 4.5) * real[:, :, None]).astype(np.float32),
            "f0": (rng.uniform(100, 300, (B, T)) * real).astype(np.float32),
            "uv": ((rng.rand(B, T) < 0.3) | ~real).astype(np.float32),
            "mel_lengths": np.array(lengths, np.int32)}


FS2_GRAD_GROUPS = {"encoder": ("encoder",), "decoder and mel head": ("decoder", "mel_head"),
                   "predictors": ("dur_predictor", "pitch_predictor", "pitch_embed")}


def fs2_card_vs_cpu(smi):
    """Phase 13e: one fs2 step on the card and on the CPU from the same
    weights and batch, dropout 0 (the pitch predictor's fixed 0.1 too), at
    B=2 and FS2_CHECK_CFG's small widths: every loss, the global gradient
    norm, and each parameter's gradient norm (the worst leaf, its norm
    floored at 1e-6 of the largest leaf's; the global norm is almost all f0
    gradient, so it alone cannot see a wrong backward elsewhere). The
    gradients are read after the step's clip, which scales each side by
    its own global norm."""
    from dicttts_tpu_torch.train.tasks.fs2 import FastSpeech2Task

    batch = fs_batch(np.random.RandomState(SEED + 17), 2, 24, 128, FS2_CHECK_CFG["n_vocab"])
    card, cpu = FastSpeech2Task(FS2_CHECK_CFG, device="cuda"), FastSpeech2Task(FS2_CHECK_CFG, device="cpu")
    card.build_state(SEED + 18)
    cpu.build_state(SEED + 18)
    cpu.model.load_state_dict(card.model.state_dict())
    out, leaf = {}, {}
    for name, task in (("card", card), ("cpu", cpu)):
        task.model.pitch_predictor.dropout_rate = 0.0
        out[name] = {k: float(v) for k, v in task.train_step(task.to_device(batch)).items()}
        leaf[name] = {n: float(torch.linalg.vector_norm(p.grad)) for n, p in task.model.named_parameters()}
    rtol, worst = 2e-3, 0.0  # TF32 off; cuDNN and the CPU sum in different orders
    for k, ref in out["cpu"].items():
        rel = abs(out["card"][k] - ref) / max(abs(ref), 1e-6)
        worst = max(worst, rel)
        say(f"  fs2 {k}: card {out['card'][k]:.6f} cpu {ref:.6f} rel {rel:.2e}")
    floor = 1e-6 * max(leaf["cpu"].values())
    rel_leaf = {n: abs(leaf["card"][n] - ref) / max(ref, floor) for n, ref in leaf["cpu"].items()}
    worst_leaf = max(rel_leaf, key=rel_leaf.get)
    for group, prefixes in FS2_GRAD_GROUPS.items():
        names = [n for n in leaf["cpu"] if n.split(".")[0] in prefixes]
        g = {side: float(np.sqrt(sum(leaf[side][n] ** 2 for n in names))) for side in leaf}
        say(f"  fs2 clipped gradient norm of the {group} ({len(names)} leaves): card {g['card']:.6e} "
            f"cpu {g['cpu']:.6e}; its worst leaf rel {max(rel_leaf[n] for n in names):.2e}")
    if set().union(*FS2_GRAD_GROUPS.values()) != {n.split(".")[0] for n in leaf["cpu"]}:
        raise AssertionError("a FastSpeech2 parameter lies outside the gradient groups")
    say(f"card vs CPU: worst relative difference {worst:.2e} over the fs2 step's losses and global gradient "
        f"norm, {rel_leaf[worst_leaf]:.2e} over the {len(rel_leaf)} parameters' gradient norms "
        f"({worst_leaf}), tol {rtol:.0e}; on {smi}")
    if set(out["card"]) != set(out["cpu"]) or set(leaf["card"]) != set(leaf["cpu"]) \
            or max(worst, rel_leaf[worst_leaf]) > rtol:
        raise AssertionError("card and CPU FastSpeech2 steps disagree")
    return {"losses_rel": worst, "worst_leaf_rel": rel_leaf[worst_leaf], "worst_leaf": worst_leaf}


# -- phase 14: data parallelism, the serving export, validation artifacts ------------------------

def free_port() -> int:
    """A free TCP port on localhost, for a rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def deterministic():
    """Deterministic kernels, cuDNN's and torch's (index_select's backward
    adds with atomics otherwise, and two runs of one step differ by ~1e-5),
    for the runs that phase 14 holds to each other."""
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags[:2]
        torch.use_deterministic_algorithms(flags[2], warn_only=flags[3])


def nccl_world_one(root, binary, smi):
    """Phase 14a: run.main of the recipe on phase 8's corpus for DDP_STEPS
    steps inside a world-size-1 NCCL group (``--multihost`` with torchrun's
    variables: every collective runs, over one rank), and the same steps
    without a group, deterministic kernels in both (cuDNN's and torch's).
    Returns the launches (K1, K2, K3) of the run in the group."""
    from dicttts_tpu_torch.parallel import mesh

    hp = (f"binary_data_dir={binary},max_updates={DDP_STEPS},val_check_interval={DDP_STEPS},"
          "num_sanity_val_steps=0")
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "WORLD_SIZE": "1", "RANK": "0",
           "LOCAL_RANK": "0"}
    runs = {}
    with deterministic():
        for label in ("nccl_world_1", "no_group"):
            os.environ.update(env if label == "nccl_world_1" else {})
            try:
                t = time.time()
                extra = ("--multihost", "--dist_timeout", "300") if label == "nccl_world_1" else ()
                trainer, task, n = run_main(root, label, hp, *extra)
            finally:
                for k in env:
                    os.environ.pop(k, None)
            if mesh.initialized():
                raise AssertionError("run.main left its process group behind")
            vals, finite = finite_run(trainer, task)
            runs[label] = {"metrics": vals, "val": dict(trainer.val_metrics), "launches": n,
                           "params": {k: v.detach().clone() for k, v in task.model.state_dict().items()},
                           "step": trainer.global_step, "finite": finite}
            say(f"{label}: {trainer.global_step} steps in {time.time() - t:.1f} s, launches (K1, K2, K3) {n}, "
                f"last step {vals}")
            del trainer, task
            torch.cuda.empty_cache()
    g, p = runs["nccl_world_1"], runs["no_group"]
    worst = max(abs(g[s][k] - p[s][k]) / max(abs(p[s][k]), 1.0) for s in ("metrics", "val") for k in p[s])
    d_param = max(float((g["params"][k].float() - v.float()).abs().max()) for k, v in p["params"].items())
    say(f"world-size-1 NCCL group vs no group, {DDP_STEPS} steps: largest loss difference {worst:.3e} "
        f"(relative past 1; tol 1e-6), largest parameter difference {d_param:.3e}; on {smi}")
    if not (g["finite"] and p["finite"] and g["step"] == p["step"] == DDP_STEPS):
        raise AssertionError("the world-size-1 runs did not train finite steps")
    if set(g["metrics"]) != set(p["metrics"]) or worst > 1e-6:
        raise AssertionError("the run in a world-size-1 NCCL group differs from the run without a group")
    k1, k2, k3 = g["launches"]
    if not (k2 == DDP_STEPS and k1 >= DDP_STEPS and k3 == 0) or g["launches"] != p["launches"]:
        raise AssertionError(f"K1/K2 not launched every step in the group: {g['launches']}, {p['launches']}")
    return g["launches"]


DDP_CFG = {"dropout": 0.0, "predictor_dropout": 0.0, "disc_dropout": 0.0}


def ddp_task(device):
    """The recipe's DictTTSTask at full width on the seeded bf16 bank,
    dropout 0, seeded weights."""
    from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask

    bank = make_bank(device, torch.Generator(device=device).manual_seed(SEED + 7))
    task = DictTTSTask(DDP_CFG, bank=bank, device=device)
    task.build_state(SEED + 7)
    return task


def ddp_steps(task, batch, noise, starts):
    """One step per noise draw on this rank's rows (the whole batch in one
    process): the metrics of each, the peak memory and the launches."""
    from dicttts_tpu_torch.parallel import mesh

    mesh.broadcast_state(task.state_dict())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    metrics, atol = [], {}
    for eps in noise:
        m = task.train_step(task.to_device(mesh.shard_batch(batch)), None,
                            eps=torch.as_tensor(mesh.shard_batch({"e": eps})["e"]).to(task.device),
                            start_frames_g=starts, start_frames_d=starts)
        metrics.append({k: float(v) for k, v in m.items()})
        for k, v in update_atol(task).items():
            atol[k] = atol.get(k, 0.0) + v
    torch.cuda.synchronize()
    return {"metrics": metrics, "launches": launch_counts(), "atol": atol,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "params": {f"{i}.{n}": p.detach().cpu() for i, mod in enumerate((task.model, task.disc))
                       for n, p in mod.named_parameters()}}


def update_atol(task) -> dict:
    """Per parameter: 1e-6 plus what a gradient difference at the gradient
    tolerance (1e-3 |g| + 1e-6 of the largest) can move the update just
    taken, Adam's lr * tol / (sqrt(v_hat) + eps), at most 2 lr
    (tests/torch_ddp_workers.adam_atol)."""
    out = {}
    for i, (mod, opt) in enumerate(((task.model, task.opt_g), (task.disc, task.opt_d))):
        top = max(float(p.grad.abs().max()) for p in mod.parameters() if p.grad is not None)
        group = opt.param_groups[0]
        lr, eps, b2 = float(group["lr"]), group["eps"], group["betas"][1]
        for n, p in mod.named_parameters():
            if p not in opt.state:
                out[f"{i}.{n}"] = 1e-6
                continue
            st = opt.state[p]
            g = (st["exp_avg_sq"] / (1 - b2 ** float(st["step"]))).sqrt()
            out[f"{i}.{n}"] = (1e-6 + torch.clamp(lr * (1e-3 * g + 1e-6 * top) / (g + eps), max=2 * lr)).cpu()
    return out


def ddp_rank(rank, store, out, batch, noise, starts, tf32):
    """One of phase 14b's two ranks: gloo over a FileStore, CUDA tensors on
    the one card, the parent's TF32 settings."""
    import datetime

    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        from dicttts_tpu_torch.ops import cuda_build

        cuda_build.library()  # the parent's build, loaded from dicttts_tpu_torch/_build
        with deterministic():
            res = ddp_steps(ddp_task(torch.device("cuda", 0)), batch, noise, starts.cuda())
    finally:
        dist.destroy_process_group()
    res.pop("atol")
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def ddp_two_ranks(binary, smi):
    """Phase 14b: two spawned ranks on the one card with gloo against one
    process on the whole batch: one corpus batch whose halves differ in
    frames, the recipe's task at full width, dropout 0, pinned noise and
    crops, deterministic kernels, TWO_RANK_STEPS steps. Returns the launches (K1, K2, K3) summed
    over the ranks."""
    from dicttts_tpu_torch.config import load_config
    from dicttts_tpu_torch.data.datasets import TTSBatchProvider, TTSBinaryDataset

    cfg = {**load_config(os.path.join(REPO, RECIPE_CONFIG), save=False), "binary_data_dir": binary,
           "max_sentences": DDP_ROWS}
    provider = TTSBatchProvider(TTSBinaryDataset(binary, "train", cfg, "dict"), cfg, shuffle=False,
                                devices_multiple=2)
    batch = {k: v for k, v in next(iter(provider.train_batches())).items() if k != "_meta"}
    B, T = batch["mel2word"].shape
    lengths = batch["mel_lengths"]
    say(f"batch {B} x {T} frames; rank 0's rows {lengths[:B // 2].tolist()}, rank 1's {lengths[B // 2:].tolist()}")
    if B % 2 or lengths[:B // 2].sum() == lengths[B // 2:].sum():
        raise AssertionError("the batch's halves must differ in frames")
    rng = np.random.RandomState(SEED + 8)
    noise = [rng.randn(B, T // 4, 16).astype(np.float32) for _ in range(TWO_RANK_STEPS)]
    starts = crop_starts(rng.rand(3), lengths, T)
    device = torch.device("cuda")
    t = time.time()
    with deterministic():
        task = ddp_task(device)
        ref = {**ddp_steps(task, batch, noise, starts.to(device)), "task": task}
    say(f"one process, {B} rows: {TWO_RANK_STEPS} steps in {time.time() - t:.1f} s, launches (K1, K2, K3) "
        f"{ref['launches']}, peak memory {ref['peak_gib']:.2f} GiB")
    del task
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_") as out:
        t = time.time()
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32  # off since phase 0
        torch.multiprocessing.spawn(ddp_rank, args=(os.path.join(out, "store"), out, batch, noise, starts, tf32),
                                    nprocs=2, join=True)
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    say(f"two ranks (gloo, one card): spawned, joined and stepped in {time.time() - t:.1f} s")
    worst_loss, worst_param, over = (0.0, ""), 0.0, {}
    n_params = sum(v.numel() for v in ref["params"].values())
    opts = (ref["task"].opt_g, ref["task"].opt_d)
    lr_max = 2 * TWO_RANK_STEPS * max(float(g["lr"]) for o in opts for g in o.param_groups)
    for r, res in enumerate(ranks):
        for i, (got, want) in enumerate(zip(res["metrics"], ref["metrics"])):
            if set(got) != set(want):
                raise AssertionError(f"rank {r} step {i} reports {sorted(got)}, one process {sorted(want)}")
            for k in want:
                rel = abs(got[k] - want[k]) / max(abs(want[k]), 1e-6)
                worst_loss = max(worst_loss, (rel, f"step {i} {k}: {got[k]:.7g} vs {want[k]:.7g}"))
        for k, want in ref["params"].items():
            err = (res["params"][k] - want).abs()
            worst_param = max(worst_param, float(err.max()))
            n_over = int((err > ref["atol"][k]).sum())
            if n_over:
                over[(r, k)] = (n_over, float(err.max()))
                normed = k.startswith("1.discs.") and any(f".{b}" in k for b in ("conv_1.", "conv_2.", "in_"))
                if not normed:
                    raise AssertionError(f"rank {r}: {k} differs from one process by {float(err.max()):.3e}")
        k1, k2, k3 = res["launches"]
        say(f"rank {r}: launches (K1, K2, K3) {res['launches']}, peak memory {res['peak_gib']:.2f} GiB; "
            f"losses step by step {[round(m['total_loss'], 6) for m in res['metrics']]}")
        if not (k2 == TWO_RANK_STEPS and k1 >= TWO_RANK_STEPS and k3 == 0):
            raise AssertionError(f"rank {r} did not launch K1 and K2 every step: {res['launches']}")
    same = all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]) for k in ref["params"])
    beyond = sum(n for n, _ in over.values())
    say(f"two ranks vs one process: largest relative loss or gradient-norm difference {worst_loss[0]:.3e} "
        f"({worst_loss[1]}; tol 1e-3), largest parameter difference {worst_param:.3e} (at most {lr_max:.1e}, "
        f"2 lr a step); {beyond} of 2 x {n_params} parameter elements beyond 1e-6 plus the Adam term of "
        f"each update at the gradient tolerance, all in the discriminator's instance-normed blocks "
        f"(rank, parameter: elements, largest difference): {over}; the ranks' parameters equal: {same}; "
        f"on {smi}")
    if worst_loss[0] > 1e-3 or worst_param > lr_max or not same:
        raise AssertionError("two ranks differ from one process")
    del ref
    return tuple(map(sum, zip(*(res["launches"] for res in ranks))))


def export_phase(smi):
    """Phase 14c: the serving export at the recipe's widths with
    use_pallas_s2pa and the recipe's HiFi-GAN, buckets 1x32 and 8x64:
    export and load seconds, artifact bytes, ms a call of the exported
    module beside the live test_step + vocoder (CUDA events), their outputs
    compared, K3 launched once a call, eager S2PA never. Returns the
    exported calls' launches (K1, K2, K3)."""
    from dicttts_tpu_torch.models.hifigan import HifiGanGenerator
    from dicttts_tpu_torch.ops import s2pa_fused as fused_mod
    from dicttts_tpu_torch.serving_export import ExportedTTS, export_tts
    from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask
    from dicttts_tpu_torch.vocoders.hifigan import spec2wav

    device = torch.device("cuda")
    cfg = {"use_pallas_s2pa": True, "use_device_dict_bank": False}
    task = DictTTSTask(cfg, device=device)
    task.build_state(SEED + 9)
    with torch.no_grad():  # speech-like frame counts, as in phase 4
        task.model.dur_predictor.linear[0].bias.fill_(3.0)
    torch.manual_seed(SEED + 9)
    vocoder = HifiGanGenerator().to(device).eval()  # the recipe's widths (512 channels)
    bank = make_bank(device, torch.Generator(device=device).manual_seed(SEED + 9), torch.float32)
    plain_calls = []
    plain = fused_mod.s2pa_fused_plain
    fused_mod.s2pa_fused_plain = lambda *a: plain_calls.append(1) or plain(*a)
    launches = [0, 0, 0]
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as out:
            t = time.time()
            export_tts(task.cfg, task, vocoder, buckets=EXPORT_BUCKETS, gloss_len=BANK_L, pinyin_len=BANK_P,
                       out_dir=out)
            export_s = time.time() - t
            sizes = {f: os.path.getsize(os.path.join(out, f)) for f in sorted(os.listdir(out))}
            say(f"export of {len(EXPORT_BUCKETS)} buckets in {export_s:.1f} s; artifacts {sizes}")
            served = ExportedTTS(out)
            rng = np.random.RandomState(SEED + 9)
            report = {"export_s": export_s, "bytes": sizes, "buckets": {}}
            for B, Tw in EXPORT_BUCKETS:
                t = time.time()
                _, fn = served.module_for(B, Tw)
                load_s = time.time() - t
                n_ops = sum(str(n.target) == "dicttts_tpu_torch.s2pa_fused.default" for n in fn.graph.nodes)
                wt = torch.tensor(rng.randint(3, BANK_V, (B, Tw)), device=device)
                wt[:, 0] = 1
                wt[:, -1] = 2
                keys = bank["keys"][wt].contiguous()
                x = {"word_tokens": wt.int(), "keys": keys, "values": keys, "key_map": bank["key_map"][wt],
                     "pinyin": bank["pinyin"][wt], "pinyin_map": bank["pinyin_map"][wt],
                     "pron_modified": torch.zeros((B, Tw), dtype=torch.int32, device=device)}
                noise = served.noise(B, seed=B)
                args = (*(x[k] for k in ("word_tokens", "keys", "values", "key_map", "pinyin", "pinyin_map",
                                         "pron_modified")), noise)

                def exported():
                    with torch.no_grad():
                        return fn(*args)

                def live():
                    out_ = task.test_step(x, noise=noise)
                    return spec2wav(vocoder, out_["mel_out"]), out_

                torch.cuda.synchronize()
                zero_launch_counts()
                wav, mel, m2w, pp = exported()
                torch.cuda.synchronize()
                n_exp = launch_counts()
                live_wav, ref = live()
                torch.cuda.synchronize()
                n_live = launch_counts()
                d_mel = float((mel - ref["mel_out"]).abs().max())
                d_wav = float((wav - live_wav).abs().max())
                exp_ms, live_ms = time_ms(exported, iters=5, warmup=1), time_ms(live, iters=5, warmup=1)
                zero_launch_counts()
                exported()
                torch.cuda.synchronize()
                launches = [a + b for a, b in zip(launches, launch_counts())]
                say(f"bucket {B}x{Tw}: load {load_s:.2f} s, {n_ops} K3 node(s) in the graph; exported "
                    f"{exp_ms:.2f} ms a call vs live test_step + vocoder {live_ms:.2f} ms (CUDA events); "
                    f"frames {(m2w > 0).sum(1).tolist()}; max|dmel| {d_mel:.3e} (tol 1e-4), max|dwav| "
                    f"{d_wav:.3e} (tol 1e-3); launches (K1, K2, K3) exported {n_exp}, live minus exported "
                    f"{tuple(b - a for a, b in zip(n_exp, n_live))}; on {smi}")
                report["buckets"][f"{B}x{Tw}"] = {"load_s": load_s, "exported_ms": exp_ms, "live_ms": live_ms,
                                                  "max_abs_dmel": d_mel, "max_abs_dwav": d_wav}
                if not (torch.equal(m2w, ref["mel2word"].int()) and torch.equal(pp, ref["pinyin_pred"].int())):
                    raise AssertionError(f"bucket {B}x{Tw}: mel2word or pinyin_pred differ from the live path")
                if d_mel > 1e-4 or d_wav > 1e-3 or not bool(torch.isfinite(wav).all()):
                    raise AssertionError(f"bucket {B}x{Tw}: the exported outputs differ from the live path")
                if n_ops != 1 or n_exp != (0, 0, 1) or n_live != (0, 0, 2):
                    raise AssertionError(f"bucket {B}x{Tw}: K3 not launched once a call ({n_exp}, {n_live})")
    finally:
        fused_mod.s2pa_fused_plain = plain
    if plain_calls:
        raise AssertionError(f"eager S2PA's plain version ran {len(plain_calls)} times")
    say("phase 14c report " + json.dumps(report))
    return tuple(launches)


def validation_artifacts_phase(root, gen, smi):
    """Phase 14d: the trainer's validation artifacts on phase 8's newest
    checkpoint: ``validation_outputs`` (the card pass) of the first
    validation batch, the figures where matplotlib imports, and
    ``Trainer.log_artifacts`` (a no-op without a TensorBoard writer).
    Returns the card pass's launches (K1, K2, K3)."""
    import importlib.util

    from dicttts_tpu_torch import run
    from dicttts_tpu_torch.config import load_config
    from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask
    from dicttts_tpu_torch.train.trainer import Trainer

    have = {m: importlib.util.find_spec(m) is not None for m in ("tensorboardX", "matplotlib")}
    with in_dir(root):
        cfg = load_config(config=os.path.join(REPO, RECIPE_CONFIG), exp_name="recipe", infer=True)
        run.autoconfigure_vocabs(cfg)
        task = DictTTSTask(cfg, run.build_data_provider(cfg), device="cuda")
        trainer = Trainer(cfg["work_dir"], device="cuda", seed=cfg.get("seed", 1234))
        trainer._restore(task)
        batch = task.to_device({k: v for k, v in next(iter(task.val_batches())).items() if k != "_meta"})
        torch.cuda.synchronize()
        zero_launch_counts()
        t = time.perf_counter()
        v = task.validation_outputs(batch, gen)
        ms = (time.perf_counter() - t) * 1e3
        n = launch_counts()
        say(f"validation_outputs on step {trainer.global_step}'s checkpoint: {ms:.1f} ms, predicted mel "
            f"{v['mel_pred'].shape}, target {v['mel_gt'].shape}, pron_attn {v['pron_attn'].shape}; "
            f"launches (K1, K2, K3) {n}; tensorboardX {'present' if have['tensorboardX'] else 'absent'} "
            f"(a writer {'is' if trainer.writer() else 'is not'} made), matplotlib "
            f"{'present' if have['matplotlib'] else 'absent'}; on {smi}")
        if not all(np.isfinite(a).all() and a.size for a in v.values()) or n != (1, 0, 0):
            raise AssertionError(f"validation_outputs: non-finite or empty outputs, or launches {n}")
        if have["matplotlib"]:
            arts = task.validation_artifacts(batch, gen)
            say(f"validation_artifacts: figures {sorted(arts['figures'])}, audio {sorted(arts['audio'])}")
        trainer.log_artifacts(task, task.val_batches())
        if trainer._writer:
            trainer._writer.close()
    return n


# -- phase 16: K-step groups as CUDA-graph replays of the Dict-TTS step, the background checkpoint ----

def to_cpu(tree):
    """``tree`` (nested dicts, lists, tuples) with its tensors copied to the host."""
    from dicttts_tpu_torch.utils.checkpoint import map_tensors

    return map_tensors(tree, lambda t: t.detach().cpu())


@contextlib.contextmanager
def hooked_steps(on_step):
    """Call ``on_step(metrics, launches)`` after every train step of any
    task, whether it ran eagerly or as a graph replay, with the (K1, K2,
    K3) launches it added; a graph's capture, which runs no step, is none,
    and a task's step that calls its parent's counts once."""
    from dicttts_tpu_torch.train.graphs import StepGraphs
    from dicttts_tpu_torch.train.tasks.adv_base import AdversarialTTSTask
    from dicttts_tpu_torch.train.tasks.fs2 import FastSpeech2Task
    from dicttts_tpu_torch.train.tasks.hifigan import HifiGanTask
    from dicttts_tpu_torch.train.tasks.ps_flow import PortaSpeechFlowTask

    inside = [0]
    owners = (AdversarialTTSTask, PortaSpeechFlowTask, FastSpeech2Task, HifiGanTask, StepGraphs)
    names = ("train_step",) * 4 + ("step",)
    originals = [vars(cls)[n] for cls, n in zip(owners, names)]

    def hooked(fn):
        def run(self, *a, **kw):
            outer = not inside[0]
            before = launch_counts()
            inside[0] += 1
            try:
                m = fn(self, *a, **kw)
            finally:
                inside[0] -= 1
            if outer:
                on_step(m, tuple(x - y for x, y in zip(launch_counts(), before)))
            return m

        return run

    for cls, n, fn in zip(owners, names, originals):
        setattr(cls, n, hooked(fn))
    try:
        yield
    finally:
        for cls, n, fn in zip(owners, names, originals):
            setattr(cls, n, fn)


@contextlib.contextmanager
def recorded_steps():
    """Every train step's metrics, as device copies queued after the step (no
    host read), eager or replayed."""
    out = []
    with hooked_steps(lambda m, _: out.append({k: v.detach().clone() for k, v in m.items()})):
        yield out


def graph_report_lines(label, trainer, steps, launches, val_batches, smi, bank_kernels=True):
    """Print a run's graphs, capture seconds, replays, K1/K2 a step and
    steady_per_step_s; returns them as a dict. K1 and K2 must launch once
    a train step (``bank_kernels``), or never."""
    rep = trainer.graph_report or {"graphs": [], "replays": 0, "capture_s": 0.0, "eager_steps": steps}
    for g in rep["graphs"]:
        shapes = {k: v for k, v in g["key"][0].items() if k in ("mel2word", "word_tokens", "mel2ph", "wavs")}
        say(f"{label} graph {shapes} gates {g['key'][1]}: captured in "
            f"{g['capture_s'] * 1e3:.1f} ms ({g['free_gib']:.2f} GiB free on the card, {g['reserved_gib']:.2f} "
            f"reserved by the allocator before it), replayed {g['replays']} times, K1/K2 nodes {g['nodes']}")
    by_run = {}
    for h in trainer.history:  # groups all of one kind, so that step_ms is theirs
        if all(o["run"] == h["run"] for o in trainer.history if o["group"] == h["group"]):
            by_run.setdefault((h["run"], f"{h['sentences']}x{h['frames']}"), []).append(round(h["step_ms"], 1))
    for (how, shape), ms in sorted(by_run.items()):
        say(f"{label} {how} steps at {shape}: ms {ms}")
    k1, k2, k3 = launches
    per_step = ((k1 - val_batches) / steps, k2 / steps)
    say(f"{label}: {len(rep['graphs'])} graphs, {rep['replays']} replays, {rep['eager_steps']} eager steps, "
        f"capture {rep['capture_s']:.2f} s; K1 {k1} ({val_batches} of them validation), K2 {k2}: "
        f"{per_step[0]:g} and {per_step[1]:g} a train step, replays included; steady_per_step_s "
        f"{trainer.steady_per_step_s}; on {smi}")
    if (per_step != (1.0, 1.0) if bank_kernels else launches != (0, 0, 0)) or k3:
        raise AssertionError(f"{label}: K1/K2 not {'once a step' if bank_kernels else 'unlaunched'} "
                             f"({launches}, {val_batches} validation batches)")
    return {"graphs": rep["graphs"], "replays": rep["replays"], "capture_s": rep["capture_s"],
            "eager_steps": rep["eager_steps"], "steady_per_step_s": trainer.steady_per_step_s,
            "step_ms_by_run": {f"{how} {shape}": ms for (how, shape), ms in sorted(by_run.items())}}


def graph_summary(trainer) -> str:
    """A run's graphs in one line: each key's gates and replays; or why the
    task ran eagerly."""
    rep = trainer.graph_report
    if not rep:
        return "none"
    if rep.get("not_captured"):
        return f"none (eager: {rep['not_captured']})"
    if not rep["graphs"]:
        return f"none ({rep['eager_steps']} eager warm-ups: no key came twice)"
    return ", ".join(f"{g['key'][1]} x{g['replays']}" for g in rep["graphs"])


def untouched(opt) -> bool:
    """An optimizer whose state (allocated when its task built it) no update
    has touched: every count 0, every moment zero."""
    return all(float(st["step"]) == 0 and not st["exp_avg"].any() and not st["exp_avg_sq"].any()
               for st in opt.state_dict()["state"].values())


def first_difference(a: list, b: list):
    """(step, keys) of the first step whose metrics differ in any bit, or None."""
    from dicttts_tpu_torch.utils.checkpoint import bit_differences

    for i, (x, y) in enumerate(zip(a, b)):
        diff = bit_differences(x, y)
        if diff:
            return i, diff
    return None if len(a) == len(b) else (min(len(a), len(b)), ["steps"])


def graph_recipe_runs(root, binary, smi):
    """Phase 16a, b, d: run.main of the recipe on phase 8's corpus at K = 1
    and K = GRAPH_K, in f32 and under amp (GRAPH_RUNS: the steps, the
    discriminator's start inside them), deterministic kernels: every step's
    losses and the final state (weights, Adam moments, counts, lr) equal
    bit for bit, and every graph of the grouped run replayed as often as
    GRAPH_RUNS asks. The K = GRAPH_K f32 run's checkpoint at its validation
    mark, written on a thread while the next steps ran, equals the state
    taken synchronously at that step. Returns (report, launches by run)."""
    from dicttts_tpu_torch.train.trainer import Trainer
    from dicttts_tpu_torch.utils.checkpoint import bit_differences, checkpoint_path, load_checkpoint

    report, launches, runs = {}, {}, {}
    save = Trainer.save
    sync_copies = {}

    def saving(self, task, val_metrics):  # the state at the save, read synchronously
        sync_copies[self.global_step] = to_cpu(task.state_dict())
        return save(self, task, val_metrics)

    with deterministic():
        for prec, (n_steps, disc_start, least_replays) in GRAPH_RUNS.items():
            mark = n_steps // 2
            hp = (f"binary_data_dir={binary},max_updates={n_steps},val_check_interval={mark},"
                  f"num_sanity_val_steps=0,disc_start_steps={disc_start},amp={prec == 'amp'}")
            for k in (1, GRAPH_K):
                label = f"{prec} K={k}"
                sync_copies.clear()
                Trainer.save = saving
                try:
                    with recorded_steps() as steps:
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats()
                        t = time.time()
                        trainer, task, n = run_main(root, f"graphs_{prec}_k{k}", hp + f",steps_per_dispatch={k}")
                        seconds = time.time() - t
                        steps = to_cpu(steps)
                finally:
                    Trainer.save = save
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                val_batches = 2 * len(list(task.val_batches()))  # validations at the mark and at the end
                say(f"{label}: {trainer.global_step} steps in {seconds:.1f} s, peak memory {peak:.2f} GiB, "
                    f"launches (K1, K2, K3) {n}; on {smi}")
                rep = graph_report_lines(label, trainer, n_steps, n, val_batches, smi)
                rep.update(peak_gib=peak, seconds=seconds, train=step_report(trainer.history, label, smi))
                if k > 1 and prec == "f32":
                    ckpt_step, ckpt = load_checkpoint(checkpoint_path(os.path.join(root, task.cfg["work_dir"]), mark),
                                                      "cpu")
                    diff = bit_differences(ckpt, sync_copies[mark])
                    save_rec = next(r for r in trainer.saves if r["step"] == mark)
                    say(f"{label}: the checkpoint at step {ckpt_step}, written on a thread while steps "
                        f"{mark + 1}-{n_steps} ran, against the state read synchronously at step {mark}: "
                        f"{len(diff)} tensors differ; save() held the loop {save_rec['hold_ms']:.1f} ms, the "
                        f"thread wrote for {save_rec['write_s']:.2f} s; on {smi}")
                    if ckpt_step != mark or diff:
                        raise AssertionError(f"the background checkpoint differs from its step's state: {diff[:5]}")
                    rep["background_save"] = {"hold_ms": save_rec["hold_ms"], "write_s": save_rec["write_s"]}
                vals, finite = finite_run(trainer, task)
                if not (finite and trainer.global_step == n_steps and len(steps) == n_steps):
                    raise AssertionError(f"{label}: not {n_steps} finite steps ({len(steps)} recorded)")
                if k > 1 and (not rep["graphs"] or min(g["replays"] for g in rep["graphs"]) < least_replays):
                    raise AssertionError(f"{label}: not every graph replayed {least_replays} times: "
                                         f"{[g['replays'] for g in rep['graphs']]}")
                runs[label] = {"steps": steps, "state": to_cpu(task.state_dict())}
                report[label], launches[f"graphs_{label}"] = rep, n
                del trainer, task
                torch.cuda.empty_cache()
            one, grouped = runs[f"{prec} K=1"], runs[f"{prec} K={GRAPH_K}"]
            step_diff = first_difference(one["steps"], grouped["steps"])
            state_diff = bit_differences(one["state"], grouped["state"])
            say(f"{prec}: K={GRAPH_K} against K=1 over {n_steps} steps (the discriminator from step {disc_start}): "
                f"first step whose losses differ {step_diff}, final-state tensors that differ {len(state_diff)} "
                f"(the weights, both Adam moments, the counts and the lr; bit for bit); on {smi}")
            if step_diff or state_diff:
                raise AssertionError(f"{prec}: K={GRAPH_K} differs from K=1: {step_diff} {state_diff[:5]}")
            report[f"{prec} equal to the bit"] = True
    return report, launches


@contextlib.contextmanager
def profiled_graph_steps(first, last, out):
    """torch.profiler (CUDA activity) over the graph runner's calls first to
    last (0-based calls of ``StepGraphs.step``: a key's eager warm-up, its
    capture with the first replay, the replays). ``out`` gets how each ran,
    the (K1, K2, K3) launches the wrappers' counts added over them, and the
    device kernels the trace holds, by name with their counts. The session
    opens with a pause and spin kernels, which take the records a session
    drops first (``device_kernel_ms``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dicttts_tpu_torch.train.graphs import StepGraphs

    step, calls = StepGraphs.step, [0]
    prof = profile(activities=[ProfilerActivity.CUDA])

    def profiled(self, *a, **kw):
        i = calls[0]
        calls[0] += 1
        if i == first:
            torch.cuda.synchronize()
            prof.start()
            time.sleep(0.002)
            for n in (1 << 21, *(1000,) * 32):
                torch.cuda._sleep(n)
            out["before"] = launch_counts()
        m = step(self, *a, **kw)
        if first <= i <= last:
            out.setdefault("runs", []).append(self.last)
        if i == last:
            torch.cuda.synchronize()
            out["launches"] = tuple(x - y for x, y in zip(launch_counts(), out.pop("before")))
            prof.stop()
            out["kernels"] = {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
        return m

    StepGraphs.step = profiled
    try:
        yield out
    finally:
        StepGraphs.step = step


def graph_nan_skip(smi):
    """Phase 16c: the recipe's task at full width on the seeded bf16 bank,
    NAN_STEPS synthetic steps of one shape with a NaN in the mels of the
    batches NAN_AT, the last step among them: at K = NAN_K those steps are
    graph replays inside a group. Every step's losses and the final state
    (the lr included) equal K = 1's bit for bit, the skipped steps left the
    generator's update count short by theirs. A third run at K = NAN_K
    runs its capture and replays under torch.profiler (apart, so that the
    profiler's cost stays out of the timed runs): the trace holds as many
    K1 and K2 kernels as the wrappers' counts added for them, and its state
    equals K = 1's too. Returns (report, launches)."""
    from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask
    from dicttts_tpu_torch.train.trainer import Trainer
    from dicttts_tpu_torch.utils.checkpoint import bit_differences

    B, Tw, T = NAN_SHAPE
    batches = make_train_batches(np.random.RandomState(SEED + 16), NAN_STEPS, B, Tw, T, BANK_V)
    for i in NAN_AT:
        batches[i]["mels"][1, 7, 11] = np.nan
    nan_steps = [i + 1 for i in NAN_AT]
    bank = make_bank(torch.device("cuda"), torch.Generator(device="cuda").manual_seed(SEED + 16))
    runs, launches, report = {}, {}, {}
    with deterministic(), tempfile.TemporaryDirectory(prefix="chip_smoke_graph_nan_") as work:
        for k, profiled in ((1, False), (NAN_K, False), (NAN_K, True)):
            trainer = Trainer(os.path.join(work, f"k{k}{'p' if profiled else ''}"), max_updates=NAN_STEPS,
                              val_check_interval=10 ** 6, num_sanity_val_steps=0, device="cuda",
                              steps_per_dispatch=k)
            task = DictTTSTask({}, bank=bank, device="cuda")
            label = f"16c K={k}{' profiled' if profiled else ''}"
            trace_cm = profiled_graph_steps(1, NAN_STEPS - 1, {}) if profiled else contextlib.nullcontext({})
            with recorded_steps() as steps, trace_cm as trace:
                torch.cuda.synchronize()
                zero_launch_counts()
                trainer.fit(task, batches, batches[:1])
                torch.cuda.synchronize()
                steps = to_cpu(steps)
            launches[f"graphs_nan k={k}{' profiled' if profiled else ''}"] = launch_counts()
            rep = graph_report_lines(label, trainer, NAN_STEPS, launch_counts(), 1, smi)
            groups = [h["group_size"] for h in trainer.history]
            how = [trainer.history[i]["run"] for i in NAN_AT]
            lrs = [float(opt.param_groups[0]["lr"]) for opt in (task.opt_g, task.opt_d)]
            say(f"{label}: group sizes {groups}; steps {nan_steps} (NaN) in groups "
                f"{[trainer.history[i]['group'] for i in NAN_AT]}, run {how}; updates (generator, discriminator) "
                f"{task.updates_g}, {task.updates_d}; lr (generator, discriminator) {lrs}; step ms "
                f"{[round(h['step_ms'], 1) for h in trainer.history]}; on {smi}")
            if (any(math.isfinite(float(steps[i]["total_loss"])) for i in NAN_AT)
                    or task.updates_g != NAN_STEPS - len(NAN_AT)):
                raise AssertionError(f"{label}: the NaN steps were not skipped")
            if k > 1 and (min(groups[i] for i in NAN_AT) < 2 or set(how) != {"replayed"}):
                raise AssertionError(f"16c: the NaN steps did not run as replays inside a group: {how}")
            if profiled:
                count = {name: sum(n for key, n in trace["kernels"].items() if f"{name}_kernel" in key)
                         for name in ("s2pa_bank_fwd", "s2pa_bank_bwd")}
                say(f"{label}: torch.profiler over steps 2-{NAN_STEPS} (run {trace['runs']}): the trace holds "
                    f"{count['s2pa_bank_fwd']} K1 and {count['s2pa_bank_bwd']} K2 kernels, the wrappers' counts "
                    f"added (K1, K2, K3) {trace['launches']}; {sum(trace['kernels'].values())} device kernels "
                    f"in all; on {smi}")
                if (set(trace["runs"][1:]) != {"replayed"}
                        or (count["s2pa_bank_fwd"], count["s2pa_bank_bwd"], 0) != trace["launches"]
                        or trace["launches"][:2] != (NAN_STEPS - 1, NAN_STEPS - 1)):
                    raise AssertionError(f"16c: the replays' K1/K2 kernels in the trace {count} disagree with "
                                         f"the counts {trace['launches']}")
                rep["profiled"] = {"runs": trace["runs"], "trace_k1_k2": [count["s2pa_bank_fwd"],
                                                                          count["s2pa_bank_bwd"]],
                                   "counted": list(trace["launches"])}
            runs[label] = {"steps": steps, "state": to_cpu(task.state_dict())}
            report[label[4:]] = {**rep, "groups": groups, "lr": lrs}
            del task, trainer
            torch.cuda.empty_cache()
    one = runs["16c K=1"]
    for label, run in list(runs.items())[1:]:
        step_diff = first_difference(one["steps"], run["steps"])
        state_diff = bit_differences(one["state"], run["state"])
        say(f"{label} against K=1 with NaNs at steps {nan_steps} (the last step a skipped replay): first step "
            f"whose losses differ {step_diff}, final-state tensors that differ {len(state_diff)} (the lr "
            f"included); on {smi}")
        if step_diff or state_diff:
            raise AssertionError(f"{label} differs from K=1 around the NaN steps: {step_diff} {state_diff[:5]}")
    return report, launches


# -- phase 17: K-step groups as CUDA-graph replays of every other task's step -----------------------

def recipe_cfg(config, **over) -> dict:
    """A recipe's config (its YAML chain) with ``over`` set."""
    from dicttts_tpu_torch.config import load_config

    return {**load_config(os.path.join(REPO, config), save=False), **over}


def grouped_pair(label, make_task, batches, smi, bank_kernels=False, profile=None):
    """``make_task()`` through ``Trainer.fit`` on ``batches`` at K = 1 and
    K = GROUP_K (and, with ``profile`` = (first, last), a third K = GROUP_K
    run under torch.profiler over those calls of the graph runner),
    deterministic kernels, no checkpoint: every step's losses and the final
    state (weights, moments, counts, lrs, accumulators) equal bit for bit,
    and every graph replayed GROUP_REPLAYS times. Prints each graph's key,
    capture seconds and free memory, replay ms against eager ms, and peak
    memory. Returns (report, launches by run, the K = 1 run's steps and
    task)."""
    from dicttts_tpu_torch.train.trainer import Trainer
    from dicttts_tpu_torch.utils.checkpoint import bit_differences

    runs, report, launches = {}, {}, {}
    one_task = None
    plan = [(1, False), (GROUP_K, False)] + ([(GROUP_K, True)] if profile else [])
    with deterministic(), tempfile.TemporaryDirectory(prefix="chip_smoke_groups_") as work:
        for k, profiled in plan:
            run_label = f"{label} K={k}{' profiled' if profiled else ''}"
            task = make_task()
            trainer = Trainer(os.path.join(work, run_label.replace(" ", "_")), max_updates=len(batches),
                              val_check_interval=10 ** 6, num_sanity_val_steps=0, device="cuda",
                              steps_per_dispatch=k)
            trainer.save = lambda *a, **kw: ""  # no checkpoint: phase 17 holds the state in memory
            trace_cm = profiled_graph_steps(*profile, {}) if profiled else contextlib.nullcontext({})
            with recorded_steps() as steps, trace_cm as trace:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                zero_launch_counts()
                t = time.time()
                trainer.fit(task, batches)
                torch.cuda.synchronize()
                seconds = time.time() - t
                steps = to_cpu(steps)
            n = launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            say(f"{run_label}: {len(steps)} steps in {seconds:.1f} s (model build and captures included), "
                f"peak memory {peak:.2f} GiB, launches (K1, K2, K3) {n}; on {smi}")
            rep = graph_report_lines(run_label, trainer, len(batches), n, 0, smi, bank_kernels)
            rep.update(peak_gib=peak, seconds=seconds)
            if k == 1:
                rep["eager_ms"] = [round(h["step_ms"], 2) for h in trainer.history[1:]]  # past the first
            elif not profiled:
                groups = {}
                for h in trainer.history:
                    groups.setdefault(h["group"], []).append(h)
                # each group of replays only: its steps (1-based) and its ms a step
                rep["replay_ms"] = {f"steps {g[0]['step']}-{g[-1]['step']}": round(g[0]["step_ms"], 2)
                                    for g in groups.values() if all(h["run"] == "replayed" for h in g)}
                low = min((g["replays"] for g in rep["graphs"]), default=0)
                if not rep["graphs"] or low < GROUP_REPLAYS or rep["eager_steps"] != len(rep["graphs"]):
                    raise AssertionError(f"{run_label}: not every graph replayed {GROUP_REPLAYS} times after "
                                         f"its key's eager step: {graph_summary(trainer)}")
            if profiled:
                count = {name: sum(c for key, c in trace["kernels"].items() if f"{name}_kernel" in key)
                         for name in ("s2pa_bank_fwd", "s2pa_bank_bwd")}
                span = profile[1] - profile[0] + 1
                say(f"{run_label}: torch.profiler over the graph runner's calls {profile[0]}-{profile[1]} "
                    f"(run {trace['runs']}): the trace holds {count['s2pa_bank_fwd']} K1 and "
                    f"{count['s2pa_bank_bwd']} K2 kernels, the wrappers' counts added (K1, K2, K3) "
                    f"{trace['launches']}; {sum(trace['kernels'].values())} device kernels in all; on {smi}")
                if (set(trace["runs"]) != {"replayed"} or trace["launches"] != (span, span, 0)
                        or (count["s2pa_bank_fwd"], count["s2pa_bank_bwd"], 0) != trace["launches"]):
                    raise AssertionError(f"{run_label}: the replayed group's K1/K2 kernels in the trace {count} "
                                         f"disagree with the counts {trace['launches']}")
                rep["profiled"] = {"runs": trace["runs"], "counted": list(trace["launches"]),
                                   "trace_k1_k2": [count["s2pa_bank_fwd"], count["s2pa_bank_bwd"]]}
            runs[run_label] = {"steps": steps, "state": to_cpu(task.state_dict())}
            report[run_label] = rep
            launches[f"groups {run_label}"] = n
            if k == 1:
                one_task = task
            else:
                del task
            del trainer
            torch.cuda.empty_cache()
    one = runs[f"{label} K=1"]
    for run_label, run in list(runs.items())[1:]:
        step_diff = first_difference(one["steps"], run["steps"])
        state_diff = bit_differences(one["state"], run["state"])
        say(f"{run_label} against K=1 over {len(batches)} steps: first step whose losses differ {step_diff}, "
            f"final-state tensors that differ {len(state_diff)} (weights, moments, counts, lrs, accumulators; "
            f"bit for bit); on {smi}")
        if step_diff or state_diff:
            raise AssertionError(f"{run_label} differs from K=1: {step_diff} {state_diff[:5]}")
    replay_ms = report[f"{label} K={GROUP_K}"]["replay_ms"]
    say(f"{label}: groups of replays only, ms a step {replay_ms}, against K=1's eager steps 2-{len(batches)} "
        f"{report[f'{label} K=1']['eager_ms']} ms; on {smi}")
    report[label] = {"equal_to_the_bit": True, "replay_ms": replay_ms,
                     "eager_ms": report[f"{label} K=1"]["eager_ms"]}
    return report, launches, one["steps"], one_task


def skipped_alike(label, steps, task, nan_at, updates_g):
    """The NaN step's losses are not finite, and the generator's updates
    are ``updates_g``: the non-finite steps counted for nothing."""
    bad = [i for i, m in enumerate(steps) if not math.isfinite(float(m["total_loss"]))]
    say(f"{label}: steps with a non-finite loss {bad} (a NaN in the mels of step {nan_at}), generator updates "
        f"{task.updates_g} (want {updates_g}), discriminator updates {task.updates_d}")
    if nan_at not in bad or task.updates_g != updates_g:
        raise AssertionError(f"{label}: the NaN step was not skipped: {bad}, {task.updates_g} updates")
    return {"non_finite_steps": bad, "updates_g": task.updates_g, "updates_d": task.updates_d}


def task_maker(cls, cfg, **kw):
    """A new task for each run (the trainer builds its state from its seed)."""
    return lambda: cls(cfg, device="cuda", **kw)


def group_ps_batches():
    """GROUP_STEPS word batches of PS_GROUP_SHAPE, and the same with a NaN
    in the mels of step PS_NAN_AT."""
    B, T_ph, Tw, T = PS_GROUP_SHAPE
    rng = np.random.RandomState(SEED + 17)
    ps = [ps_batch(rng, B, T_ph, Tw, T) for _ in range(GROUP_STEPS)]
    ps_nan = list(ps)
    ps_nan[PS_NAN_AT] = dict(ps[PS_NAN_AT], mels=ps[PS_NAN_AT]["mels"].copy())
    ps_nan[PS_NAN_AT]["mels"][1, 7, 11] = np.nan
    return ps, ps_nan


def group_ps_adv(smi):
    """17a: ps_adv, the discriminator from GROUP_SWITCH, a NaN step."""
    from dicttts_tpu_torch.train.tasks.ps_adv import PortaSpeechAdvTask

    _, ps_nan = group_ps_batches()
    B, _, _, T = PS_GROUP_SHAPE
    cfg = recipe_cfg(PS_ADV_CONFIG, disc_start_steps=GROUP_SWITCH)
    say(f"phase 17a: ps_adv at the recipe's widths, {GROUP_STEPS} steps of {B}x{T}, the discriminator from "
        f"step {GROUP_SWITCH}, a NaN in the mels of step {PS_NAN_AT}")
    rep, n, steps, task = grouped_pair("17a ps_adv", task_maker(PortaSpeechAdvTask, cfg), ps_nan, smi)
    finite = sum(math.isfinite(float(m["total_loss"])) for m in steps)
    rep["17a ps_adv"]["nan"] = skipped_alike("17a ps_adv", steps, task, PS_NAN_AT, finite)
    return rep, n


def group_ps_flow(smi, acc):
    """17b: the two-stage ps_flow with the post-glow across its switch."""
    from dicttts_tpu_torch.train.tasks.ps_flow import PortaSpeechFlowTask

    ps, _ = group_ps_batches()
    B, _, _, T = PS_GROUP_SHAPE
    cfg = recipe_cfg(PS_FLOW_CONFIG, use_post_glow=True, post_glow_training_start=GROUP_SWITCH,
                     accumulate_grad_batches=acc)
    label = f"17b ps_flow accumulate {acc}"
    say(f"phase {label}: two-stage with the post-glow, {GROUP_STEPS} steps of {B}x{T} across the switch "
        f"at step {GROUP_SWITCH}")
    rep, n, steps, task = grouped_pair(label, task_maker(PortaSpeechFlowTask, cfg), ps, smi)
    counts = (task.updates_g, task.updates_pf)
    want = (GROUP_SWITCH // acc, (GROUP_STEPS - GROUP_SWITCH) // acc)
    say(f"{label}: updates (main, post-flow) {counts}, want {want}; stages "
        f"{[int(float(m['post_stage'])) for m in steps]}")
    if counts != want:
        raise AssertionError(f"{label}: updates {counts}, not {want}")
    rep[label]["updates"] = list(counts)
    return rep, n


def group_fs2(smi, entries=((None, None),), shape=FS2_GROUP_SHAPE, n_steps=FS2_GROUP_STEPS):
    """17c: fs2 at the recipe's widths, its own encoder and decoder (None)
    or the (encoder, decoder) ``entries``."""
    from dicttts_tpu_torch.train.tasks.fs2 import FastSpeech2Task

    B, T_txt, T = shape
    rng = np.random.RandomState(SEED + 17)
    report, launches = {}, {}
    for enc, dec in entries:
        over = {k: v for k, v in (("encoder_type", enc), ("decoder_type", dec)) if v}
        cfg = recipe_cfg(FS2_CONFIG, n_vocab=80, **over)
        batches = [fs_batch(rng, B, T_txt, T, cfg["n_vocab"]) for _ in range(n_steps)]
        label = f"17c fs2 {cfg['encoder_type']}+{cfg['decoder_type']}"
        say(f"phase {label}: at the recipe's widths, {n_steps} steps of {B}x{T}")
        rep, n, _, task = grouped_pair(label, task_maker(FastSpeech2Task, cfg), batches, smi)
        report.update(rep)
        launches.update(n)
    return report, launches


def group_hifigan(smi):
    """17d: HiFi-GAN at the recipe's widths, the discriminators from
    GROUP_SWITCH."""
    from dicttts_tpu_torch.train.tasks.hifigan import HifiGanTask

    B, S = VOC_GROUP_SHAPE
    rng = np.random.RandomState(SEED + 17)
    cfg = recipe_cfg(VOCODER_CONFIG, disc_start_steps=GROUP_SWITCH)
    crops = [{"wavs": (0.3 * rng.randn(B, S)).astype(np.float32),
              "mels": rng.uniform(-5, 0, (B, S // HOP, 80)).astype(np.float32)} for _ in range(GROUP_STEPS)]
    say(f"phase 17d: HiFi-GAN at the recipe's widths (upsample_initial_channel "
        f"{cfg['upsample_initial_channel']}), {GROUP_STEPS} steps of {B}x{S} crops, the discriminators "
        f"from step {GROUP_SWITCH}")
    rep, n, _, task = grouped_pair("17d hifigan", task_maker(HifiGanTask, cfg), crops, smi)
    if (task.updates_g, task.updates_d) != (GROUP_STEPS, GROUP_STEPS - GROUP_SWITCH):
        raise AssertionError(f"17d: updates {(task.updates_g, task.updates_d)}")
    return rep, n


def group_dict_tts_accumulate(smi):
    """17e: Dict-TTS at full width under accumulate_grad_batches=2, a NaN
    micro-step inside a group; one replayed group under torch.profiler."""
    from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask

    B, Tw, T = NAN_SHAPE
    bank = make_bank(torch.device("cuda"), torch.Generator(device="cuda").manual_seed(SEED + 17))
    batches = make_train_batches(np.random.RandomState(SEED + 17), ACC_GROUP_STEPS, B, Tw, T, BANK_V)
    batches[ACC_NAN_AT]["mels"][1, 7, 11] = np.nan
    label = "17e dict_tts accumulate 2"
    say(f"phase 17e: Dict-TTS at full width with accumulate_grad_batches=2, {ACC_GROUP_STEPS} micro-steps of "
        f"{B}x{Tw}x{T}, a NaN in the mels of micro-step {ACC_NAN_AT}; the replayed group of calls "
        f"{GROUP_K}-{2 * GROUP_K - 1} under torch.profiler")
    rep, n, steps, task = grouped_pair(label, task_maker(DictTTSTask, {"accumulate_grad_batches": 2}, bank=bank),
                                       batches, smi, bank_kernels=True, profile=(GROUP_K, 2 * GROUP_K - 1))
    finite = sum(math.isfinite(float(m["total_loss"])) for m in steps)
    rep[label]["nan"] = skipped_alike(label, steps, task, ACC_NAN_AT, finite // 2)
    return rep, n


def grouped_tasks(smi):
    """Phase 17: 17a ps_adv, 17b the two-stage ps_flow (with and without
    accumulation), 17c fs2 (the recipe, then the other registry entries on
    a smaller batch), 17d HiFi-GAN, 17e Dict-TTS under accumulation, each
    at the recipe's widths, K = GROUP_K against K = 1 (``grouped_pair``).
    Returns (report, launches by run)."""
    report, launches = {}, {}
    parts = [("17a", lambda: group_ps_adv(smi)), ("17b", lambda: group_ps_flow(smi, 1)),
             ("17b accumulate", lambda: group_ps_flow(smi, 2)), ("17c", lambda: group_fs2(smi)),
             ("17c registry", lambda: group_fs2(smi, FS2_OTHER_ENTRIES, FS2_REGISTRY_SHAPE, FS2_REGISTRY_STEPS)),
             ("17d", lambda: group_hifigan(smi)), ("17e", lambda: group_dict_tts_accumulate(smi))]
    for name, part in parts:
        t = time.time()
        rep, n = part()
        report.update(rep)
        launches.update(n)
        torch.cuda.empty_cache()
        say(f"phase {name} done in {time.time() - t:.1f} s")
    return report, launches


# -- phase 15: reference checkpoints into the port, the PER pipeline, attention diagnostics ---------

# the keys the JAX converter documents as unused (convert_dict_tts), at the recipe's hidden width
REFERENCE_UNUSED = {"sin_pos._float_tensor": (1,), "enc_pos_proj.weight": (192, 384), "enc_pos_proj.bias": (192,),
                    "dec_query_proj.weight": (192, 384), "dec_query_proj.bias": (192,),
                    "dec_res_proj.weight": (192, 384), "dec_res_proj.bias": (192,),
                    "attn.in_proj_weight": (576, 192), "attn.out_proj.weight": (192, 192)}


def reference_layout(module, rng, unused=None):
    """``module``'s state dict in the reference's layout: weight norm split
    into weight_v = w * s (s > 0 per output row) and weight_g = ||w|| on
    every convolution the JAX converter folds (all but the attention's 1x1
    q/k/v/o and a coupling's ``pre``, which it reads as they are), the
    ``unused`` keys filled from ``rng``. Returns (state, pairs)."""
    from torch import nn

    state = {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}
    names = [f"{n}.weight" for n, m in module.named_modules() if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d))
             and n.split(".")[-1] not in ("conv_q", "conv_k", "conv_v", "conv_o", "pre")]
    for name in names:
        w = state.pop(name)
        s = torch.tensor(rng.uniform(0.5, 2.0, (w.shape[0],) + (1,) * (w.ndim - 1)), dtype=w.dtype)
        state[name + "_v"] = w * s
        state[name + "_g"] = torch.linalg.vector_norm(w, dim=tuple(range(1, w.ndim)), keepdim=True)
    for k, shape in (unused or {}).items():
        state[k] = torch.tensor(rng.randn(*shape), dtype=torch.float32)
    return state, len(names)


def reference_import_phase(root, binary, smi):
    """Phase 15a: a seeded DictTTS at the recipe's widths (phase 8's
    vocabulary) and a HiFi-GAN at 512 channels written with torch.save in
    the reference's layouts, converted by tools.convert_torch_ckpt, and
    DictTTSInferencer from the converted checkpoints against the same models
    in memory: 8 PER sentences, pinned noise, use_pallas_s2pa (K3 once a
    call). Returns the report and the launches (K1, K2, K3)."""
    from dicttts_tpu_torch.infer import DictTTSInferencer
    from dicttts_tpu_torch.tools import convert_torch_ckpt
    from dicttts_tpu_torch.train.tasks.dict_tts import DictTTSTask
    from dicttts_tpu_torch.vocoders.hifigan import HifiGanVocoder, build_generator

    route, sandhi = sandhi_route()
    cfg = dict(text_cfg(root, binary, ""), use_pallas_s2pa=True, profile_infer=False)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED + 15)
        task = DictTTSTask(cfg, device="cpu")
        model, disc, vocoder = task.build_model(), task._build_disc(), build_generator(cfg)
    with torch.no_grad():
        model.dur_predictor.linear[0].bias.fill_(3.0)  # speech-like frame counts, as in phase 4
    rng = np.random.RandomState(SEED + 15)
    unused = dict(REFERENCE_UNUSED, **{"dict_encoder.S2PA_module.emb.weight": (cfg["word_size"], 192)})
    model_state, model_pairs = reference_layout(model, rng, unused)
    voc_state, voc_pairs = reference_layout(vocoder, rng)
    ref_dir = os.path.join(root, "reference")
    os.makedirs(ref_dir)
    src = {"dict_tts": os.path.join(ref_dir, "model_ckpt_steps_300000.ckpt"),
           "hifigan": os.path.join(ref_dir, "model_ckpt_steps_2168000.ckpt")}
    torch.save({"state_dict": {"model": model_state, "mel_disc": disc.state_dict()}, "global_step": 300000},
               src["dict_tts"])
    torch.save({"generator": voc_state}, src["hifigan"])
    dst, report = {}, {"sandhi": route}
    for name, hp in (("dict_tts", f"binary_data_dir={binary}"), ("hifigan", "")):
        dst[name] = os.path.join(root, f"converted_{name}")
        t = time.perf_counter()
        out = convert_torch_ckpt.main(["--model", name, "--src", src[name], "--dst", dst[name],
                                       *(["--hparams", hp] if hp else [])])
        secs = time.perf_counter() - t
        want = (model_pairs, len(unused)) if name == "dict_tts" else (voc_pairs, 0)
        say(f"{name}: {out['params'] / 1e6:.2f}M parameters converted in {secs:.2f} s; {out['folded']} weight-norm "
            f"pairs folded, {len(out['dropped'])} unused keys dropped ({', '.join(out['dropped'][:3])}"
            f"{', ...' if len(out['dropped']) > 3 else ''})")
        if (out["folded"], len(out["dropped"])) != want:
            raise AssertionError(f"{name}: folded {out['folded']} and dropped {len(out['dropped'])}, want {want}")
        report[name] = {"params": out["params"], "folded": out["folded"], "dropped": len(out["dropped"]),
                        "convert_s": secs}

    texts = per_sentences()[:8]
    converted = DictTTSInferencer(dict(cfg, work_dir=dst["dict_tts"], vocoder_ckpt=dst["hifigan"]), sandhi=sandhi)
    in_memory = DictTTSInferencer(dict(cfg, vocoder_ckpt=""), state={"params_g": model.state_dict()},
                                  sandhi=sandhi)
    in_memory.vocoder = HifiGanVocoder(cfg, params=vocoder.state_dict())
    c = converted.task.cfg
    noise = torch.randn((len(texts), c["max_frames"] // 4, c["latent_size"]),
                        generator=torch.Generator().manual_seed(SEED + 150))
    outs = {}
    torch.cuda.synchronize()
    zero_launch_counts()
    for name, inf in (("converted", converted), ("in_memory", in_memory)):
        steps = []
        test_step = inf.task.test_step
        inf.task.test_step = lambda *a, **k: steps.append(test_step(*a, **k)) or steps[-1]
        before = launch_counts()[2]
        t = time.perf_counter()
        results = inf.synthesize_batch(texts, noise=noise)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        if launch_counts()[2] - before != 1:
            raise AssertionError(f"{name}: K3 launched {launch_counts()[2] - before} times in one call")
        for wav, info in results:  # random weights: the decode may hold pad ids, so no syllable count
            if not (0 < info["n_frames"] and wav.shape == (info["n_frames"] * inf.vocoder.hop,)
                    and np.isfinite(wav).all() and np.isfinite(info["mel"]).all()):
                raise AssertionError(f"{name}: wav {wav.shape} for {info['n_frames']} frames, or not finite")
        outs[name] = (steps[0], results)
        say(f"{name}: one call of {len(texts)} sentences in {ms:.1f} ms, frames "
            f"{[info['n_frames'] for _, info in results]}")
    launches = launch_counts()
    (a, ra), (b, rb) = outs["converted"], outs["in_memory"]
    mel_rel = float((a["mel_out"] - b["mel_out"]).abs().max() / b["mel_out"].abs().max())
    wav_err = max(float(np.abs(wa - wb).max()) for (wa, _), (wb, _) in zip(ra, rb))
    same_m2w = torch.equal(a["mel2word"], b["mel2word"])
    same_pinyin = all(ia["pinyin"] == ib["pinyin"] for (_, ia), (_, ib) in zip(ra, rb))
    say(f"converted vs in memory: mel2word equal {same_m2w}, pinyin equal {same_pinyin}, mel max|d| / max|mel| "
        f"{mel_rel:.3e} (tol 1e-5: the folded weights differ from the originals by f32 rounding), wav max|d| "
        f"{wav_err:.3e} (tol 1e-4); launches (K1, K2, K3) {launches}; on {smi}")
    if not (same_m2w and same_pinyin and mel_rel <= 1e-5 and wav_err <= 1e-4):
        raise AssertionError("the converted reference checkpoints do not reproduce the models they came from")
    report.update(mel_rel=mel_rel, wav_max_abs=wav_err, launches=list(launches))
    return report, launches


def per_pipeline_phase(smi):
    """Phase 15b-c: tools.per_eval.main on the repo's stand-in dictionary
    (its phones and sandhi from tests/per_standin_text.json: no jieba on
    the card's machine), then tools.attn_probe on its experiment. The train
    and test runs go through run.main in this process (to count launches
    and read the trainer), the held-in probe through per_eval's own
    subprocess. Returns the report and the launches by run."""
    from dicttts_tpu_torch import run
    from dicttts_tpu_torch.tools import attn_probe, get_pron_error, per_eval

    with open(os.path.join(REPO, "tests", "per_standin_text.json"), encoding="utf-8") as f:
        table = json.load(f)
    fixed = per_eval.FixedText(table)
    exp = f"per_eval_chip_smoke{os.getpid()}"
    work_dir = os.path.join(REPO, "checkpoints", exp)
    report, launches, runs, built, per_step = {}, {}, {}, {}, []
    orig = {"run_cli": per_eval.run_cli, "build": per_eval.build_per_corpus}

    def build(*a, **k):
        t = time.perf_counter()
        out = orig["build"](*a, **k)
        built.update(seconds=time.perf_counter() - t, binarizer=out[4])
        return out

    def run_cli(cfg_fn, exp_name, log_fn, infer=False, hparams="", device="cuda"):
        if "test_set_name=" in hparams:  # the held-in probe: per_eval's own subprocess
            t = time.perf_counter()
            orig["run_cli"](cfg_fn, exp_name, log_fn, infer, hparams, device)
            runs["probe_subprocess_s"] = time.perf_counter() - t
            return
        name = "infer" if infer else "train"
        with in_dir(REPO):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_launch_counts()
            t = time.perf_counter()
            runs[name] = run.main(per_eval.run_argv(cfg_fn, exp_name, infer, hparams, device))
            torch.cuda.synchronize()
            runs[f"{name}_s"] = time.perf_counter() - t
            runs[f"{name}_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            launches[f"per_eval_{name}"] = launch_counts()

    per_eval.run_cli, per_eval.build_per_corpus = run_cli, build
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_per_") as tmp:
            root = os.path.join(tmp, "corpus")
            t = time.perf_counter()
            with hooked_steps(lambda _, n: per_step.append(n)):  # each step's launches, replays included
                result = per_eval.main(
                    ["--dict", os.path.join(REPO, table["dict"]), "--root", root, "--test_set",
                     os.path.join(tmp, "test_set.json"), "--out", os.path.join(tmp, "per.json"),
                     "--tag", exp[len("per_eval_"):], "--n_items", str(table["n_items"]),
                     "--max_updates", str(PER_UPDATES), "--score_train", "--device", "cuda"], text=fixed)
            total_s = time.perf_counter() - t
            per_eval.run_cli, per_eval.build_per_corpus = orig["run_cli"], orig["build"]
            st = built["binarizer"].stats
            say(f"15b corpus: {result['provenance']['n_heteronym_chars']} heteronyms, "
                f"{result['provenance']['heteronym_slots']} slots, {result['provenance']['distinct_syllables']} "
                f"syllables; built and binarized on the card in {built['seconds']:.2f} s ({st['items']} items, "
                f"{st['items'] / built['seconds']:.1f} items/s; items {st['items_s']:.2f} s with {st['workers']} "
                f"text workers, the card's mel and f0 {st['features_s']:.2f} s; bank {st['bank_s']:.2f} s, "
                f"{st['bank_bytes'] / 1e6:.1f} MB); splits {st['splits']}; on {smi}")
            trainer, task = runs["train"]
            c = task.cfg
            say(f"15b training: {trainer.global_step} steps in {runs['train_s']:.1f} s (amp {c['amp']}, max_sentences "
                f"{c['max_sentences']}, mel_buckets {c['mel_buckets']}, bank {tuple(task.bank['keys'].shape)} "
                f"{task.bank['keys'].dtype}, s2pa_bank_fused {c['s2pa_bank_fused']}); peak memory "
                f"{runs['train_peak_gib']:.2f} GiB; launches (K1, K2, K3) {launches['per_eval_train']}")
            by_shape = {}
            for h in trainer.history:
                by_shape.setdefault(f"{h['sentences']}x{h['frames']}", []).append(h["step_ms"])
            for shape, ms in sorted(by_shape.items()):
                later = ms[1:] or ms
                say(f"15b step ms at {shape}: {len(ms)} steps, first {ms[0]:.1f}, repeats median "
                    f"{statistics.median(later):.2f} (min {min(later):.2f}, max {max(later):.2f}); on {smi}")
            report["steps"] = {k: {"n": len(v), "first": v[0], "median": statistics.median(v[1:] or v)}
                               for k, v in by_shape.items()}
            # the discriminator and its optimizer step only from disc_start_steps on (max_updates // 4)
            start = c["disc_start_steps"]
            stages = {"generator only": [h["step_ms"] for h in trainer.history[1:] if h["step"] <= start],
                      "with the discriminator": [h["step_ms"] for h in trainer.history if h["step"] > start + 1]}
            stages = {k: v for k, v in stages.items() if v}
            say("15b step ms by stage (disc_start_steps " + str(start) + "): " + "; ".join(
                f"{k} {len(v)} steps, median {statistics.median(v):.2f}, min {min(v):.2f}, max {max(v):.2f}"
                for k, v in stages.items()) + f"; on {smi}")
            report["stage_median_ms"] = {k: statistics.median(v) for k, v in stages.items()}
            kinds = sorted(set(per_step))
            say(f"15b launches per train step (K1, K2, K3): {kinds} over {len(per_step)} steps")
            if kinds != [(1, 1, 0)] or len(per_step) != PER_UPDATES:
                raise AssertionError(f"per_eval's training launched {kinds} per step over {len(per_step)} steps")
            infer_trainer, _ = runs["infer"]
            ms_utt = 1e3 * infer_trainer.test_seconds / result["n_test_items"]
            say(f"15b --infer: {result['n_test_items']} test utterances, {ms_utt:.2f} ms each (test loop), run "
                f"{runs['infer_s']:.1f} s; launches {launches['per_eval_infer']}; the held-in probe's "
                f"subprocess {runs['probe_subprocess_s']:.1f} s")
            if launches["per_eval_infer"] != (result["n_test_items"], 0, 0):
                raise AssertionError(f"--infer launched {launches['per_eval_infer']}")

            labels, meta = os.path.join(root, "labels.csv"), os.path.join(root, "meta_test.csv")
            n_rows = {p: sum(1 for _ in open(p, encoding="utf-8")) - 1 for p in (labels, meta)}
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                per = get_pron_error.main(["--pred", meta, "--labels", labels])
            printed = buf.getvalue().strip().splitlines()[-1]
            bd, probe = result["breakdown"], result["train_probe"]
            say(f"15b PER {result['per_pct']} % (first-reading baseline "
                f"{result['provenance']['first_pron_baseline_per_pct']} %); get_pron_error printed {printed!r}; "
                f"heteronym slots {bd['heteronym_slots']} ({bd['heteronym_errors']} wrong, free "
                f"{bd['free_slots']}/{bd['free_errors']}, sandhi-forced {bd['sandhi_forced_slots']}/"
                f"{bd['sandhi_forced_errors']}), single-reading syllables {bd['single_pron_syllables']} "
                f"({bd['single_pron_errors']} wrong), first reading predicted {bd['model_predicts_first_reading_pct']} "
                f"%, rows skipped {bd['rows_skipped_len_mismatch']}; held-in probe {probe}; per_eval "
                f"{total_s:.1f} s")
            if n_rows != {labels: 50, meta: 50}:
                raise AssertionError(f"labels and meta.csv rows {n_rows}, want 50 each")
            if not (math.isfinite(result["per_pct"]) and 0 <= result["per_pct"] <= 100):
                raise AssertionError(f"PER {result['per_pct']}")
            if printed != f"| PER: {100 * per:.2f}%" or round(100 * per, 3) != result["per_pct"]:
                raise AssertionError(f"get_pron_error printed {printed!r} for per_eval's {result['per_pct']}")
            if probe is None or "error" in probe or not math.isfinite(probe["per_pct"]):
                raise AssertionError(f"the held-in probe failed: {probe}")
            report.update(per=result, seconds=total_s, binarize_s=built["seconds"], items=st["items"],
                          ms_per_test_utterance=ms_utt, launches_per_step=kinds)

            say("phase 15c: tools.attn_probe on 15b's experiment")
            torch.cuda.synchronize()
            zero_launch_counts()
            t = time.perf_counter()
            probe_summary = attn_probe.main(["--exp", exp, "--root", root, "--n", str(PER_PROBE_N)])
            torch.cuda.synchronize()
            launches["attn_probe"] = launch_counts()
            means = [v for k, m in probe_summary.items() if k.endswith("_means") for v in m.values()]
            say(f"15c: {probe_summary} in {time.perf_counter() - t:.1f} s; launches {launches['attn_probe']}")
            if (probe_summary["correct"] + probe_summary["wrong"] == 0 or not means
                    or not all(math.isfinite(v) for v in means) or launches["attn_probe"] != (PER_PROBE_N, 0, 0)):
                raise AssertionError(f"attn_probe: {probe_summary}, launches {launches['attn_probe']}")
            report["attn_probe"] = probe_summary
    finally:
        per_eval.run_cli, per_eval.build_per_corpus = orig["run_cli"], orig["build"]
        shutil.rmtree(work_dir, ignore_errors=True)
    return report, launches


def main() -> int:
    faulthandler.dump_traceback_later(1100, exit=True)  # never outlive the run's limit
    say("phase 0: device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr, flush=True)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dicttts_tpu_torch.models.dict_tts import DictTTS
    from dicttts_tpu_torch.models.hifigan import HifiGanGenerator
    from dicttts_tpu_torch.ops import cuda_build
    from dicttts_tpu_torch.ops.s2pa_bank import s2pa_bank_fwd
    from dicttts_tpu_torch.ops.s2pa_fused import s2pa_fused
    from dicttts_tpu_torch.serve import DictTTSServer

    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"device {name} (count {torch.cuda.device_count()}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; TF32 off for matmuls and cuDNN convolutions")

    say("phase 1: build kernels with nvcc")
    t = time.time()
    so, log = cuda_build.build()
    cuda_build.library()
    say(f"built {so.name} in {time.time() - t:.1f} s")
    say("ptxas -v: each kernel's registers, shared memory and spills")
    for line in log.splitlines():  # entry names, then their resource lines
        if any(k in line for k in ("entry function", "registers", "spill", "smem")) or line.startswith("["):
            print("  " + line.strip(), flush=True)

    gen = torch.Generator(device=device).manual_seed(SEED)
    say("phase 2: K1 s2pa_bank_fwd vs plain at V=8000 L=96 E=768 N=1000 (serving geometry)")
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        args, _, _ = bank_case(device, gen, dtype, 1000)
        cases.append(check_bank_case(args, None, None, f"serving {str(dtype)[6:]} N=1000 uniform", smi,
                                     bwd=False))
        del args
        torch.cuda.empty_cache()
    say("phase 3: K3 s2pa_fused vs plain at B=16 T=64 L=96 H=192 P=8")
    k3_phase3 = k3_case(fused_case(device, gen, 16, 64, 96), "synthetic", smi)

    say("phase 4: full-width serving on the device bank (random weights, seed %d)" % SEED)
    torch.manual_seed(SEED)
    acoustic = DictTTS(use_pallas_s2pa=True)  # production widths; K3 for gathered banks
    # random weights predict about one frame per word; a duration-head bias
    # of 3.0 (softplus 3.05, about 20 frames a word) gives speech-like frame
    # counts, so the FVAE and the vocoder do a real request's work
    with torch.no_grad():
        acoustic.dur_predictor.linear[0].bias.fill_(3.0)
    vocoder = HifiGanGenerator()
    acoustic_cpu, vocoder_cpu = copy.deepcopy(acoustic), copy.deepcopy(vocoder)
    bank = make_bank(device, gen)
    server = DictTTSServer(acoustic, vocoder, bank, max_frames=1548, device=device)
    rng = np.random.RandomState(SEED)
    batches = [make_requests(rng, b, tw) for b, tw in BATCHES]
    server.synthesize_batch(batches[0], seed=0)  # warm-up: cuDNN handles, allocator
    s2pa_bank_fwd.launches = s2pa_fused.launches = 0
    for i, reqs in enumerate(batches):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        results = server.synthesize_batch(reqs, seed=i)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        check_results(results, server.hop)
        audio_s = sum(r.n_frames for r in results) * HOP / SAMPLE_RATE
        say(f"batch B={len(reqs)} Tw={len(reqs[0].word_ids)}: {dt * 1e3:.2f} ms per request "
            f"(whole batch), frames {[r.n_frames for r in results][:4]}..., audio {audio_s:.2f} s, "
            f"RTF {dt / audio_s:.5f}, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"on {name}")
        if s2pa_bank_fwd.launches != i + 1:
            raise AssertionError(f"K1 launched {s2pa_bank_fwd.launches} times after {i + 1} batches")
    k1_serving = s2pa_bank_fwd.launches
    if s2pa_fused.launches != 0:
        raise AssertionError("K3 launched on the device-bank path")
    for i, reqs in enumerate(batches):  # split: the acoustic pass alone, same inputs
        torch.cuda.synchronize()
        t = time.perf_counter()
        server.acoustic_batch(reqs, seed=i)
        torch.cuda.synchronize()
        say(f"batch B={len(reqs)}: acoustic pass alone {(time.perf_counter() - t) * 1e3:.2f} ms "
            f"(the rest of the request is the vocoder and host copies)")

    say("phase 4b: one request on the CPU through the plain versions, same weights and noise")
    ref_req = batches[0]
    noise = torch.randn((1, 1548 // 4, 16), generator=torch.Generator().manual_seed(SEED))
    cpu_server = DictTTSServer(acoustic_cpu, vocoder_cpu, {k: v.cpu() for k, v in bank.items()},
                               max_frames=1548, device="cpu")
    ref = cpu_server.synthesize_batch(ref_req, noise=noise)[0]
    got = server.synthesize_batch(ref_req, noise=noise)[0]
    d_mel = float(np.abs(got.mel - ref.mel).max())
    d_wav = float(np.abs(got.wav - ref.wav).max()) if got.wav.shape == ref.wav.shape else math.inf
    say(f"card vs CPU: frames {got.n_frames} vs {ref.n_frames}, max|dmel|={d_mel:.3e}, "
        f"max|dwav|={d_wav:.3e} (tol 1e-2: K1 and its plain version may round a bf16 "
        f"value differently, and that difference runs through the whole model)")
    if got.n_frames != ref.n_frames or d_mel > 1e-2 or d_wav > 1e-2:
        raise AssertionError("card and CPU runs of the port disagree")
    if not np.array_equal(got.pinyin_pred, ref.pinyin_pred):
        raise AssertionError("pinyin decode differs between card and CPU")
    del cpu_server, acoustic_cpu, vocoder_cpu

    say("phase 5: gathered-bank serving with use_pallas_s2pa (K3)")
    reqs = make_requests(rng, 4, 48, gathered_from=bank)
    s2pa_bank_fwd.launches = s2pa_fused.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    results = server.synthesize_batch(reqs, seed=5)
    dt = time.perf_counter() - t
    check_results(results, server.hop)
    say(f"gathered batch B=4 Tw=48: {dt * 1e3:.2f} ms, frames {[r.n_frames for r in results]}")
    if s2pa_fused.launches != 1 or s2pa_bank_fwd.launches != 0:
        raise AssertionError(f"gathered path launched K3 {s2pa_fused.launches} times")
    k3_gathered = s2pa_fused.launches
    del server, bank, acoustic, vocoder, batches, results
    torch.cuda.empty_cache()
    say(f"phases 0-5 done at {time.time() - T_START:.1f} s")

    N = TRAIN_B * TRAIN_TW
    say(f"phase 6: K1 and K2 vs plain at V=8000 L=96 E=768 N={N} (training geometry), "
        f"bf16 and f32, corpus-like, uniform and Zipf word ids")
    for dtype in (torch.bfloat16, torch.float32):
        for ids in ("corpus", "uniform", "zipf"):
            args, g_ctx, g_w = bank_case(device, gen, dtype, N, ids)
            cases.append(check_bank_case(args, g_ctx, g_w, f"training {str(dtype)[6:]} N={N} {ids}", smi))
            if dtype == torch.float32 and ids == "corpus":
                check_bank_autograd(args)
            del args, g_ctx, g_w
            torch.cuda.empty_cache()
    main_case = next(c for c in cases if c["case"] == f"training bfloat16 N={N} corpus")
    say(f"phase 6 done at {time.time() - T_START:.1f} s")

    say(f"phase 7: training at production width, B={TRAIN_B} Tw={TRAIN_TW} T={TRAIN_T}, bf16 bank")
    train_bank = make_bank(device, gen, torch.bfloat16)  # the recipe's device_bank() dtype
    _, k1_train, k2_train = train_full_width(device, train_bank, SEED,
                                             main_case["k1"]["ms"] + main_case["k1"]["sort_ms"],
                                             main_case["k2"]["ms"], smi)
    say(f"phase 7 done at {time.time() - T_START:.1f} s")

    say("phase 7b: Trainer.fit, checkpoint, resume")
    trainer_resume(device, train_bank)
    say(f"phase 7b done at {time.time() - T_START:.1f} s")

    say("phase 7c: one train step on the card and on the CPU, same weights, dropout 0")
    train_step_card_vs_cpu(device, train_bank)
    say(f"phase 7c done at {time.time() - T_START:.1f} s")
    del train_bank
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_recipe_") as root:
        say(f"phase 8: the recipe's entry point (dicttts_tpu_torch.run) on the corpus, {RECIPE_CONFIG}")
        corpus, recipe_launches, (args, g_ctx, g_w, shape), report = recipe_entry_point(gen, smi, root)
        N = args[1].shape[0]
        cases.append(check_bank_case(args, g_ctx, g_w, f"recipe bf16 L={args[0].shape[1]} N={N} "
                                     f"(a corpus batch {shape[0]}x{shape[1]})", smi))
        del args, g_ctx, g_w
        torch.cuda.empty_cache()
        say("phase 8 report " + json.dumps(report))
        say(f"phase 8 done at {time.time() - T_START:.1f} s")

        binary, work_dir = os.path.join(root, "binary"), os.path.join(root, "checkpoints", "recipe")
        say("phase 9a: Chinese text -> wav through DictTTSInferencer on phase 8's checkpoint, the PER "
            "test sentences, eager S2PA (the recipe) and K3")
        k3_text_cases, k3_text_launches, text_report = text_to_wav(root, binary, work_dir, smi)
        say("phase 9a report " + json.dumps(text_report))
        say(f"phase 9a done at {time.time() - T_START:.1f} s")
        say("phase 9b: run.main on the corpus with gathered banks (use_device_dict_bank=False)")
        gathered_report = gathered_training(root, binary, smi, report)
        say("phase 9b report " + json.dumps(gathered_report))
        say(f"phase 9 done at {time.time() - T_START:.1f} s")

        say("phase 10a: the recipe under amp from a .rio corpus, a profiled 60x512 step, --infer with K3")
        amp_report = amp_recipe(root, binary, smi, report)
        recipe_launches.update(amp_report["launches"])
        say("phase 10a report " + json.dumps(amp_report))
        say("phase 10b: accumulate_grad_batches=2, 8 micro-steps with a resume after the third")
        recipe_launches["accumulate"] = accumulation(root, binary, smi)
        say("phase 10c: speaker ids, flow-less prior, Gumbel and sense modes, the discriminator variants, "
            "the unfused bank")
        recipe_launches.update(other_settings(root, binary, smi))
        say(f"phase 10c done at {time.time() - T_START:.1f} s")
        t14 = time.time()
        say(f"phase 14a: run.main of the recipe for {DDP_STEPS} steps in a world-size-1 NCCL group "
            "(--multihost), against the same steps without a group")
        ddp_launches = {"nccl_world_1": nccl_world_one(root, binary, smi)}
        say(f"phase 14b: two ranks on the one card (gloo over a FileStore) against one process, "
            f"{TWO_RANK_STEPS} steps of the recipe's task at full width on a corpus batch")
        ddp_launches["two_ranks"] = ddp_two_ranks(binary, smi)
        recipe_launches["ddp"] = tuple(map(sum, zip(*ddp_launches.values())))
        say(f"phase 14a-b launches (K1, K2, K3) by run {ddp_launches}")
        say("phase 14d: validation artifacts on phase 8's checkpoint")
        recipe_launches["validation_artifacts"] = validation_artifacts_phase(root, gen, smi)
        say(f"phase 14a, 14b and 14d done in {time.time() - t14:.1f} s, at {time.time() - T_START:.1f} s")
        t15 = time.time()
        say("phase 15a: reference-layout checkpoints (a seeded DictTTS at the recipe's widths, HiFi-GAN at 512 "
            "channels) through tools.convert_torch_ckpt, DictTTSInferencer from them against the models in memory")
        reference_report, recipe_launches["reference_import"] = reference_import_phase(root, binary, smi)
        say("phase 15a report " + json.dumps(reference_report))
        say(f"phase 15a done in {time.time() - t15:.1f} s, at {time.time() - T_START:.1f} s")
        t16 = time.time()
        say(f"phase 16a-b, d: run.main of the recipe at K=1 and K={GRAPH_K} (steps_per_dispatch), by precision "
            f"(steps, the discriminator's start, each graph's least replays) {GRAPH_RUNS}, deterministic "
            "kernels; the checkpoint written on a thread")
        graph_report, graph_launches = graph_recipe_runs(root, binary, smi)
        say(f"phase 16c: {NAN_STEPS} same-shape steps {NAN_SHAPE} with NaNs at steps {[i + 1 for i in NAN_AT]}, "
            f"K=1 and K={NAN_K}, the K={NAN_K} replays under torch.profiler")
        graph_report["nan_skip"], nan_launches = graph_nan_skip(smi)
        recipe_launches.update(graph_launches)
        recipe_launches.update(nan_launches)
        say("phase 16 report " + json.dumps(graph_report))
        say(f"phase 16 done in {time.time() - t16:.1f} s, at {time.time() - T_START:.1f} s")
    say("phase 10d: one amp train step beside one f32 step on the card, same weights, batch and noise")
    recipe_launches["amp_vs_f32"] = amp_vs_f32_step(device, smi)
    say(f"phase 10 done at {time.time() - T_START:.1f} s")
    if os.path.exists(root):
        raise AssertionError(f"{root} was not removed")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_vocoder_") as root:
        torch.cuda.synchronize()
        zero_launch_counts()
        say(f"phase 11a: the offline pipeline on the card: {VOC_ROWS} seeded wavs -> binaries with mel, f0 "
            "and wav (python -m dicttts_tpu_torch.text.binarize, the recipe's config)")
        binary, binarize_report = binarize_on_card(root, smi)
        say("phase 11a report " + json.dumps(binarize_report))
        say(f"phase 11a done at {time.time() - T_START:.1f} s")
        say(f"phase 11b: HiFi-GAN training at the recipe's width through run.main, {VOCODER_CONFIG}")
        vocoder_report = vocoder_training(root, binary, smi)
        say("phase 11b report " + json.dumps(vocoder_report))
        say("phase 11c: one HiFi-GAN step on the card and on the CPU, same weights and crops")
        vocoder_report["card_vs_cpu_rel"] = vocoder_card_vs_cpu(binary, smi)
        torch.cuda.synchronize()
        recipe_launches["offline_pipeline_and_vocoder"] = launch_counts()
        if recipe_launches["offline_pipeline_and_vocoder"] != (0, 0, 0):
            raise AssertionError("phase 11 launched a bank or S2PA kernel")
    say(f"phase 11 done at {time.time() - T_START:.1f} s")

    t12 = time.time()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_portaspeech_") as root:
        binary = os.path.join(root, "binary")
        os.makedirs(binary)
        ps_corpus = link_corpus(binary, np.random.RandomState(SEED))
        say(f"phase 12a: PortaSpeech with the mel discriminator through run.main on the {ps_corpus} "
            f"corpus, {PS_ADV_CONFIG}")
        ps_report, ps_launches = portaspeech_adv(root, binary, smi)
        say("phase 12a report " + json.dumps(ps_report))
        say(f"phase 12b: PortaSpeech flow with the two-stage post-glow, {PS_FLOW_CONFIG}, "
            f"post_glow_training_start cut from 160000 to {PS_FLOW_SWITCH}")
        flow_report, flow_launches = portaspeech_flow(root, binary, smi)
        say("phase 12b report " + json.dumps(flow_report))
        say("phase 12c: one ps_adv step and one post-glow step on the card and on the CPU")
        torch.cuda.synchronize()
        zero_launch_counts()
        portaspeech_card_vs_cpu(smi)
        torch.cuda.synchronize()
        by_run = {**ps_launches, **flow_launches, "ps_card_vs_cpu": launch_counts()}
        recipe_launches["portaspeech"] = tuple(map(sum, zip(*by_run.values())))
        say(f"phase 12 launches (K1, K2, K3) by run {by_run}, in all {recipe_launches['portaspeech']}")
        if any(n != (0, 0, 0) for n in by_run.values()):
            raise AssertionError(f"phase 12 launched a bank or S2PA kernel: {by_run}")
    say(f"phase 12 done in {time.time() - t12:.1f} s, at {time.time() - T_START:.1f} s")

    t13 = time.time()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fastspeech2_") as root:
        binary = os.path.join(root, "binary")
        os.makedirs(binary)
        fs_corpus = link_corpus(binary, np.random.RandomState(SEED))
        say(f"phase 13a: FastSpeech2 through run.main on the {fs_corpus} corpus, {FS2_CONFIG}")
        fs2_report, by_run, fs2_cfg, big = fastspeech2_recipe(root, binary, smi)
        say("phase 13a report " + json.dumps(fs2_report))
        say(f"phase 13b: the other registry entries at the recipe's width on one {big['mels'].shape[0]}x"
            f"{big['mels'].shape[1]} batch")
        torch.cuda.synchronize()
        zero_launch_counts()
        fs2_report["registry"] = fs2_registry(fs2_cfg, big, smi)
        torch.cuda.synchronize()
        by_run["fs2_registry"] = launch_counts()
        say("phase 13c: TransformerTTS at its default widths, teacher-forced step and cached decode")
        zero_launch_counts()
        fs2_report["transformer_tts"] = transformer_tts_phase(big, fs2_cfg["n_vocab"], smi)
        torch.cuda.synchronize()
        by_run["transformer_tts"] = launch_counts()
        say("phase 13d: GE2E embed_utterance on the card and on the CPU")
        zero_launch_counts()
        fs2_report["ge2e"] = ge2e_card_vs_cpu(smi)
        torch.cuda.synchronize()
        by_run["ge2e"] = launch_counts()
        say("phase 13e: one fs2 step on the card and on the CPU")
        zero_launch_counts()
        fs2_report["card_vs_cpu"] = fs2_card_vs_cpu(smi)
        torch.cuda.synchronize()
        by_run["fs2_card_vs_cpu"] = launch_counts()
        recipe_launches["fastspeech2"] = tuple(map(sum, zip(*by_run.values())))
        say(f"phase 13 launches (K1, K2, K3) by run {by_run}, in all {recipe_launches['fastspeech2']}")
        if any(n != (0, 0, 0) for n in by_run.values()):
            raise AssertionError(f"phase 13 launched a bank or S2PA kernel: {by_run}")
        say("phase 13 report " + json.dumps({k: fs2_report[k] for k in ("registry", "transformer_tts", "ge2e",
                                                                        "card_vs_cpu")}))
    say(f"phase 13 done in {time.time() - t13:.1f} s, at {time.time() - T_START:.1f} s")

    t14 = time.time()
    say(f"phase 14c: the serving export at the recipe's widths with use_pallas_s2pa and HiFi-GAN, buckets "
        f"{EXPORT_BUCKETS}")
    recipe_launches["export"] = export_phase(smi)
    say(f"phase 14c done in {time.time() - t14:.1f} s, at {time.time() - T_START:.1f} s")

    t15 = time.time()
    say(f"phase 15b: tools.per_eval on the repo's stand-in dictionary, --n_items 300 --max_updates {PER_UPDATES} "
        "--score_train: build, binarize on the card, train, --infer, score, slot diagnostics")
    per_report, per_launches = per_pipeline_phase(smi)
    recipe_launches.update(per_launches)
    say("phase 15 report " + json.dumps({k: v for k, v in per_report.items() if k != "per"}))
    say(f"phase 15b-c launches (K1, K2, K3) by run {per_launches}")
    say(f"phase 15b-c done in {time.time() - t15:.1f} s, at {time.time() - T_START:.1f} s")

    t17 = time.time()
    say(f"phase 17: K={GROUP_K} against K=1 for ps_adv, ps_flow, fs2, HiFi-GAN and Dict-TTS under accumulation, "
        "deterministic kernels, TF32 off")
    group_report, group_launches = grouped_tasks(smi)
    recipe_launches.update(group_launches)
    say(f"phase 17 launches (K1, K2, K3) by run {group_launches}")
    say("phase 17 report " + json.dumps(group_report))
    say(f"phase 17 done in {time.time() - t17:.1f} s, at {time.time() - T_START:.1f} s")

    kernels = []
    for key, name_, src, line in (("k1", "s2pa_bank_fwd", "s2pa_bank_fwd.cu", 128),
                                  ("k2", "s2pa_bank_bwd", "s2pa_bank_bwd.cu", 163)):
        launches = ({"serving": k1_serving, "training": k1_train} if key == "k1"
                    else {"training": k2_train})
        i = 0 if key == "k1" else 1
        launches.update({path: n[i] for path, n in recipe_launches.items()})
        by_case = [{"case": c["case"], "distinct_rows": c["distinct_rows"], "chunks": c["chunks"],
                    **{k: v for k, v in c[key].items() if k != "bound_by"}} for c in cases if key in c]
        main_ = main_case[key]  # the training path: the recipe's bf16 bank, corpus-like ids
        kernels.append({"name": name_, "route": "cuda", "source": f"dicttts_tpu_torch/csrc/{src}",
                        "replaces": f"dicttts_tpu/ops/s2pa_bank_pallas.py:{line}",
                        "launches": sum(launches.values()), "launches_by_path": launches,
                        "max_abs_err": max(c["max_abs_err"] for c in by_case),
                        "ms": main_["ms"], "plain_ms": main_["plain_ms"], "bound_ms": main_["bound_ms"],
                        "bound_by": main_["bound_by"], "library_ms": None,
                        # K1's slot order (one torch.sort, shared with K2) is timed apart
                        **({"sort_ms": main_["sort_ms"]} if "sort_ms" in main_ else {}),
                        "main_case": main_case["case"], "cases": by_case})
    # K3's own path is the inferencer's: its numbers are taken at its first B=16 batch
    k3_cases = [k3_phase3, *k3_text_cases]
    k3_main = k3_text_cases[1]
    k3_launches = {"gathered_serving": k3_gathered, "text": k3_text_launches,
                   **{path: n[2] for path, n in recipe_launches.items()}}
    k3 = {"name": "s2pa_fused", "route": "cuda", "source": "dicttts_tpu_torch/csrc/s2pa_fused.cu",
          "replaces": "dicttts_tpu/ops/s2pa_pallas.py:104", "launches": sum(k3_launches.values()),
          "launches_by_path": k3_launches, **{k: v for k, v in k3_main.items() if k != "case"},
          "max_abs_err": max(c["max_abs_err"] for c in k3_cases), "library_ms": None,
          "main_case": k3_main["case"], "cases": k3_cases}
    print(json.dumps({"kernels": [*kernels, k3], "corpus": corpus}), flush=True)
    print(f"chip_smoke total {time.time() - T_START:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
