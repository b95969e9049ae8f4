"""The SAM2 image encoder (port of ``cryovit_tpu/models/sam2``, the encoder
half so far):

- :mod:`config`  — ``HieraConfig`` / ``SAM2Config``
- :mod:`hiera`   — the hierarchical windowed-attention trunk
- :mod:`encoder` — FPN neck + sine position encodings
"""

from cryovit_tpu_torch.models.sam2.config import HieraConfig, SAM2Config

__all__ = ["HieraConfig", "SAM2Config"]
