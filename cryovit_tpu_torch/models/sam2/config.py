"""SAM2 image-encoder configurations (port of ``cryovit_tpu/models/sam2/config.py``).

``large()`` mirrors ``sam2.1_hiera_l.yaml`` (the published
``sam2.1_hiera_large.pt``) at image size 512; ``medsam_tiny()`` the
MedSAM2 / ``sam2.1_hiera_t`` trunk; ``tiny_test()`` is a scaled-down config
for CPU tests. Only the fields the image encoder reads are here; the SAM2
heads and tracking will add theirs with their code. Every stage transition
pools queries 2×, as in every published Hiera (``q_stride`` 2).
"""

from __future__ import annotations

import dataclasses

__all__ = ["HieraConfig", "SAM2Config"]


@dataclasses.dataclass(frozen=True)
class HieraConfig:
    embed_dim: int = 144
    num_heads: int = 2
    stages: tuple[int, ...] = (2, 6, 36, 4)
    window_spec: tuple[int, ...] = (8, 4, 16, 8)
    global_att_blocks: tuple[int, ...] = (23, 33, 43)
    patch_kernel: int = 7
    patch_stride: int = 4
    patch_padding: int = 3
    window_pos_embed_bkg_spatial_size: tuple[int, int] = (7, 7)
    mlp_ratio: float = 4.0

    @property
    def stage_dims(self) -> tuple[int, ...]:
        return tuple(self.embed_dim * (2**i) for i in range(len(self.stages)))

    @classmethod
    def large(cls) -> "HieraConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "HieraConfig":
        """MedSAM2 / sam2.1_hiera_t trunk."""
        return cls(
            embed_dim=96,
            num_heads=1,
            stages=(1, 2, 7, 2),
            window_spec=(8, 4, 14, 7),
            global_att_blocks=(5, 7, 9),
        )

    @classmethod
    def test(cls) -> "HieraConfig":
        return cls(
            embed_dim=8,
            num_heads=1,
            stages=(1, 1, 2, 1),
            window_spec=(4, 2, 4, 2),
            global_att_blocks=(3,),
        )


@dataclasses.dataclass(frozen=True)
class SAM2Config:
    hiera: HieraConfig = HieraConfig.large()
    d_model: int = 256  # FPN hidden dim
    image_size: int = 512
    num_feature_levels: int = 3  # strides 4, 8, 16 after scalp

    @classmethod
    def large(cls) -> "SAM2Config":
        return cls()

    @classmethod
    def medsam_tiny(cls) -> "SAM2Config":
        return cls(hiera=HieraConfig.tiny())

    @classmethod
    def tiny_test(cls) -> "SAM2Config":
        return cls(hiera=HieraConfig.test(), d_model=32, image_size=64)
