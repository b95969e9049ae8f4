#!/bin/bash
# Fan an experiment sweep out across workers (one GPU each).
# Usage: SWEEP_WORKER=i SWEEP_NUM_WORKERS=n sweep.sh EXPERIMENT MODEL
set -euo pipefail
exp_name=$1; model=$2; shift 2
worker=${SWEEP_WORKER:-0}
num_workers=${SWEEP_NUM_WORKERS:-1}

total=$(python -m cryovit_tpu_torch.training.train_model "+experiments=${exp_name}" "model=${model}" --list-sweep | wc -l)
echo "sweep ${exp_name}/${model}: ${total} grid points, worker ${worker}/${num_workers}"
for ((i=worker; i<total; i+=num_workers)); do
    echo "=== grid point ${i}"
    python -m cryovit_tpu_torch.training.train_model "+experiments=${exp_name}" "model=${model}" --sweep-index "$i" "$@"
    python -m cryovit_tpu_torch.training.eval_model  "+experiments=${exp_name}" "model=${model}" --sweep-index "$i" "$@"
done
