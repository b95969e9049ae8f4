"""Models: DINOv2 ViT backbone, CryoVIT decoder, and the fused pipeline."""
