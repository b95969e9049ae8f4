#!/bin/bash
# DINOv2 feature extraction sweep (reference dino_features_job.sh).
# Usage: dino_features.sh [SAMPLE] [overrides...]
set -euo pipefail
overrides=()
if [ "$#" -ge 1 ] && [[ "$1" != *=* ]]; then overrides+=("sample=$1"); shift; fi
python -m cryovit_tpu_torch.training.dino_features "${overrides[@]}" "$@"
