"""DINOv2 feature-extraction entry point (port of
``cryovit_tpu/training/dino_features.py``; reference ``training/dino_features.py``)."""

from cryovit_tpu_torch.config import validate_dino_config
from cryovit_tpu_torch.run.dino_features import run_trainer
from cryovit_tpu_torch.training import run_module_main

if __name__ == "__main__":
    run_module_main("dino_features", run_trainer, validate_dino_config)
