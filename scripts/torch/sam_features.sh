#!/bin/bash
# SAM2 feature extraction sweep (reference sam_features_job.sh).
# Usage: sam_features.sh [SAMPLE] [overrides...]
set -euo pipefail
overrides=()
if [ "$#" -ge 1 ] && [[ "$1" != *=* ]]; then overrides+=("sample=$1"); shift; fi
python -m cryovit_tpu_torch.training.sam_features "${overrides[@]}" "$@"
