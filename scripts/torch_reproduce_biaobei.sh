#!/usr/bin/env bash
# One-command Biaobei reproduction runbook on the PyTorch/CUDA port.
#
# Chains the reference workflow on dicttts_tpu_torch:
#   [1/5] pre-align (python -m dicttts_tpu_torch.text.binarize --stage pre_align)
#   [2/5] MFA train + align where the `mfa` binary exists (text/mfa.py),
#         else the binarizer's uniform alignment
#   [3/5] binarize (mel and f0 on $DEVICE; the gloss bank from RoFormer
#         where the config's lm_model is a local directory, else the
#         deterministic stand-in)
#   [4/5] train to max_updates, then --infer the test split (meta.csv)
#   [5/5] PER of meta.csv against $LABELS (tools.get_pron_error)
#
# With the Biaobei corpus at $RAW, the reference's data/zh-dict.json and
# the RoFormer weights in place (or a checkpoint converted by
# dicttts_tpu_torch.tools.convert_torch_ckpt), the published PER anchor is:
#
#     scripts/torch_reproduce_biaobei.sh data/raw/biaobei dicttts_biaobei
#
# DEVICE=cpu runs every stage on the host (tests/test_torch_reproduce_runbook.py
# does, on a miniature corpus); HP adds --hparams overrides to every stage.
set -euo pipefail
cd "$(dirname "$0")/.."

RAW=${1:-data/raw/biaobei}
EXP=${2:-dicttts_biaobei}
CFG=${CFG:-dicttts_tpu_torch/configs/datasets/biaobei/dict_tts.yaml}
LABELS=${LABELS:-data/pron_label/label_set0.csv}
DEVICE=${DEVICE:-cuda}
HP=${HP:-}   # extra --hparams overrides, e.g. HP="max_updates=300000"
COMMON_HP="raw_data_dir=${RAW}${HP:+,$HP}"
PY=${PYTHON:-python3}

echo "== [1/5] pre-align (config: $CFG, raw: $RAW)"
"$PY" -m dicttts_tpu_torch.text.binarize --config "$CFG" --stage pre_align \
    --hparams "$COMMON_HP" --device "$DEVICE"

if command -v mfa >/dev/null 2>&1; then
    echo "== [2/5] MFA train + align"
    "$PY" - "$CFG" "$COMMON_HP" <<'PY'
import sys
from dicttts_tpu_torch.config import load_config
from dicttts_tpu_torch.text.mfa import mfa_train_and_align
cfg = load_config(config=sys.argv[1], overrides=sys.argv[2], save=False)
mfa_train_and_align(cfg)
PY
else
    echo "== [2/5] MFA binary not found: uniform alignment" \
         "(install montreal-forced-aligner for the published-quality anchor)"
fi

echo "== [3/5] binarize on $DEVICE (the dict bank uses RoFormer when lm_model is local)"
"$PY" -m dicttts_tpu_torch.text.binarize --config "$CFG" --stage binarize \
    --hparams "$COMMON_HP" --device "$DEVICE"

echo "== [4/5] train to max_updates, then infer the test split"
"$PY" -m dicttts_tpu_torch.run --config "$CFG" --exp_name "$EXP" --hparams "$COMMON_HP" \
    --device "$DEVICE"
"$PY" -m dicttts_tpu_torch.run --config "$CFG" --exp_name "$EXP" --infer \
    --hparams "$COMMON_HP" --device "$DEVICE"

echo "== [5/5] PER vs $LABELS"
if [ -f "$LABELS" ]; then
    "$PY" -m dicttts_tpu_torch.tools.get_pron_error \
        --pred "checkpoints/$EXP/generated/meta.csv" --labels "$LABELS"
else
    echo "label file $LABELS missing: PER skipped"
fi
echo "== done: checkpoints/$EXP"
