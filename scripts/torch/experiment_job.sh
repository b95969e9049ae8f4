#!/bin/bash
# Train + eval one experiment configuration (reference single_experiment_job.sh).
# Usage: experiment_job.sh EXPERIMENT MODEL [SAMPLE] [extra overrides...]
set -euo pipefail
exp_name=$1; model=$2; shift 2
overrides=()
if [ "$#" -ge 1 ] && [[ "$1" != *=* ]]; then
    overrides+=("datamodule.sample=$1"); shift
fi
overrides+=("$@")

python -m cryovit_tpu_torch.training.train_model "+experiments=${exp_name}" "model=${model}" "${overrides[@]}"
python -m cryovit_tpu_torch.training.eval_model "+experiments=${exp_name}" "model=${model}" "${overrides[@]}"
