#!/bin/bash
# Periodic during-training evaluation loop of the PyTorch port: the
# counterpart of `scripts/infer_every_n_min.sh`. Every N minutes, pick the
# newest checkpoint of the port's trainer under the log dir (the
# `checkpoints/embeddings_gs-N` directories `Trainer.save` writes) and run
# the prompt-set evaluation orchestrator `gen_prompts_and_eval_torch.py` on
# it (generation on the card). A plain loop, as the original.
#
# Usage: scripts/infer_every_n_min_torch.sh N_MINUTES SUBJECTS_ROOT \
#          [SUBJECT_RANGE] [CKPT_GLOB]
#   N_MINUTES      re-run period
#   SUBJECTS_ROOT  folder of per-subject image dirs (e.g. subjects-ood/)
#   SUBJECT_RANGE  passed as --subject_range (default: all)
#   CKPT_GLOB      checkpoint glob (default: logs/*/checkpoints/embeddings_gs-*)
set -u
N=${1:?usage: infer_every_n_min_torch.sh N_MINUTES SUBJECTS_ROOT [RANGE] [CKPT_GLOB]}
SUBJECTS=${2:?subjects root required}
RANGE=${3:-}
GLOB=${4:-logs/*/checkpoints/embeddings_gs-*}
cd "$(dirname "$0")/.."

while true; do
  # -d: the checkpoints are directories; list them, not their contents
  CKPT=$(ls -drt $GLOB 2>/dev/null | tail -1)
  if [ -n "$CKPT" ]; then
    echo "[$(date -Is)] evaluating $CKPT"
    python scripts/gen_prompts_and_eval_torch.py \
      --subjects_root "$SUBJECTS" \
      ${RANGE:+--subject_range "$RANGE"} \
      --out_root samples --scores_csv samples/scores.csv \
      --extra_args --adaface_ckpt "$CKPT" --guidance_scale 5 \
      >> infer_every_n_min.log 2>&1
  else
    echo "[$(date -Is)] no checkpoint matches $GLOB yet"
  fi
  sleep $((N * 60))
done
