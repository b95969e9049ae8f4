"""Eval-experiment entry point (port of ``cryovit_tpu/training/eval_model.py``;
reference ``training/eval_model.py``)."""

from cryovit_tpu_torch.config import validate_experiment_config
from cryovit_tpu_torch.run.eval_model import run_trainer
from cryovit_tpu_torch.training import run_module_main

if __name__ == "__main__":
    run_module_main("eval_model", run_trainer, validate_experiment_config)
