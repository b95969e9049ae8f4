"""SAM2 image-encoder configurations (port of ``cryovit_tpu/models/sam2/config.py``).

``large()`` mirrors ``sam2.1_hiera_l.yaml`` (the published
``sam2.1_hiera_large.pt``) at image size 512; ``medsam_tiny()`` the
MedSAM2 / ``sam2.1_hiera_t`` trunk; ``tiny_test()`` is a scaled-down config
for CPU tests, field for field the JAX package's. Every stage transition
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
    d_model: int = 256  # FPN / SAM hidden dim
    image_size: int = 512
    backbone_stride: int = 16  # stride of the SAM-head feature level
    num_feature_levels: int = 3  # strides 4, 8, 16 after scalp
    mem_dim: int = 64
    num_maskmem: int = 7  # 1 cond + 6 rolling non-cond memories
    memory_attention_layers: int = 4
    decoder_depth: int = 2
    decoder_heads: int = 8
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    max_obj_ptrs: int = 16
    no_obj_score: float = -1024.0  # reference models/sam2.py:45
    # sam2.1's affine on the sigmoid mask before the memory encoder
    # (sam2.1_hiera_l.yaml: sigmoid_scale/bias_for_mem_enc)
    sigmoid_scale_for_mem_enc: float = 20.0
    sigmoid_bias_for_mem_enc: float = -10.0
    # sam2.1: temporal sine PE projected onto the object-pointer tokens
    add_tpos_enc_to_obj_ptrs: bool = True
    # conditioning-memory slots of the bank (the reference trains with a
    # random number of initial cond slices up to num_init_cond_slices)
    max_cond_slices: int = 1

    @property
    def embed_size(self) -> int:
        return self.image_size // self.backbone_stride

    @property
    def mask_input_size(self) -> int:
        return self.image_size // 4

    @classmethod
    def large(cls) -> "SAM2Config":
        return cls()

    @classmethod
    def medsam_tiny(cls) -> "SAM2Config":
        return cls(hiera=HieraConfig.tiny())

    @classmethod
    def tiny_test(cls) -> "SAM2Config":
        return cls(
            hiera=HieraConfig.test(),
            d_model=32,
            image_size=64,
            mem_dim=16,
            num_maskmem=3,
            memory_attention_layers=1,
            decoder_depth=1,
            decoder_heads=2,
            max_obj_ptrs=4,
        )
