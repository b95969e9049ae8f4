"""SAM2 feature-extraction entry point (port of
``cryovit_tpu/training/sam_features.py``; reference ``training/sam_features.py``)."""

from cryovit_tpu_torch.config import validate_dino_config
from cryovit_tpu_torch.run.sam_features import run_trainer
from cryovit_tpu_torch.training import run_module_main

if __name__ == "__main__":
    run_module_main("sam_features", run_trainer, validate_dino_config)
