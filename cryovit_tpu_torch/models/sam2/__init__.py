"""SAM2 (port of ``cryovit_tpu/models/sam2``):

- :mod:`config`           — ``HieraConfig`` / ``SAM2Config``
- :mod:`hiera`            — the hierarchical windowed-attention trunk
- :mod:`encoder`          — FPN neck + sine position encodings
- :mod:`layers`           — the heads' layers, computing in their input's dtype
- :mod:`prompts`          — the prompt encoder (boxes, dense mask prompts)
- :mod:`prompt_predictor` — the 3D U-Net predicting each slice's prompts
- :mod:`decoder`          — the LoRA mask decoder
- :mod:`memory`           — memory encoder, memory attention, axial RoPE
- :mod:`model`            — the memory bank and the tracking loop (``SAM2Model``)
- :mod:`family`           — the ``SAM2`` / MedSAM model family (training recipe)
"""

from cryovit_tpu_torch.models.sam2.config import HieraConfig, SAM2Config

__all__ = ["HieraConfig", "SAM2Config"]
