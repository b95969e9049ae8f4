"""Train-experiment entry point (port of ``cryovit_tpu/training/train_model.py``;
reference ``training/train_model.py``)."""

from cryovit_tpu_torch.config import validate_experiment_config
from cryovit_tpu_torch.run.train_model import run_trainer
from cryovit_tpu_torch.training import run_module_main

if __name__ == "__main__":
    run_module_main("train_model", run_trainer, validate_experiment_config)
