#!/bin/bash
# Staged recipe for the PyTorch/CUDA port (wavenet_vocoder_tpu_torch):
# the stages of run_common.sh, run by the port's CLIs.
# Usage (from a recipe dir, with $preset set):
#   preset=conf/mol_wavenet.json . ../run_common_torch.sh [--flag value ...]
# Flags: --stage N --stop-stage M --db-root DIR --hours H --num-workers N
#        --device DEV (passed to train and evaluate; default: the GPU)
# Extra arguments: train_args="..." (train), eval_args="..." (evaluate).
set -euo pipefail

stage=0
stop_stage=3
db_root=${db_root:-}
hours=${hours:-}
num_workers=${num_workers:-4}
inference_batch_size=${inference_batch_size:-32}
spk=${spk:-ljspeech}
device=${device:-}

# minimal --flag value parser (replaces Kaldi utils/parse_options.sh)
while [[ $# -gt 0 ]]; do
  case "$1" in
    --*) name="${1#--}"; name="${name//-/_}"
         declare "$name"="$2"; shift 2 ;;
    *) echo "unknown arg: $1" >&2; exit 1 ;;
  esac
done

dumpdir=dump
expname="${spk}_$(basename "${preset%.*}")"
expdir=exp/$expname
PYTHON=${PYTHON:-python}
PKG="wavenet_vocoder_tpu_torch.cli"
device_flag=""
[ -n "$device" ] && device_flag="--device $device"

if [ "${stage}" -le 0 ] && [ "${stop_stage}" -ge 0 ]; then
  echo "stage 0: data subset/split"
  [ -n "$db_root" ] || { echo "--db-root required for stage 0" >&2; exit 1; }
  limit_flag=""
  [ -n "$hours" ] && limit_flag="--limit $hours"
  $PYTHON -m $PKG.mksubset "$db_root" data $limit_flag \
      --train-dev-test-split \
      --dev-size "${dev_size:-5}" --test-size "${test_size:-5}"
fi

if [ "${stage}" -le 1 ] && [ "${stop_stage}" -ge 1 ]; then
  echo "stage 1: feature extraction + normalization"
  for s in train_no_dev dev eval; do
    $PYTHON -m $PKG.preprocess wavallin "data/$s" "$dumpdir/raw/$s" \
        --preset "$preset" --num-workers "$num_workers"
  done
  $PYTHON -m $PKG.compute_meanvar_stats "$dumpdir/raw/train_no_dev" \
      "$dumpdir/meanvar.npz"
  for s in train_no_dev dev eval; do
    $PYTHON -m $PKG.preprocess_normalize "$dumpdir/raw/$s" \
        "$dumpdir/norm/$s" "$dumpdir/meanvar.npz" --num-workers "$num_workers"
  done
fi

if [ "${stage}" -le 2 ] && [ "${stop_stage}" -ge 2 ]; then
  echo "stage 2: training"
  $PYTHON -m $PKG.train --dump-root "$dumpdir/norm" \
      --checkpoint-dir "$expdir" --preset "$preset" \
      --log-event-path "$expdir/log" $device_flag ${train_args:-}
fi

if [ "${stage}" -le 3 ] && [ "${stop_stage}" -ge 3 ]; then
  echo "stage 3: evaluation synthesis"
  for s in dev eval; do
    $PYTHON -m $PKG.evaluate "$dumpdir/norm/$s" \
        "$expdir/checkpoint_latest_ema.npz" "$expdir/generated/$s" \
        --preset "$preset" --batch-size "$inference_batch_size" \
        $device_flag ${eval_args:-}
  done
fi
echo "recipe done: $expdir"
