"""SAM mask decoder with LoRA on the attention q/v projections.

Port of ``cryovit_tpu/models/sam2/decoder.py`` (sam2.1 ``MaskDecoder``: an
object-score token, high-resolution skips s0/s1, 3 + 1 mask tokens), with
the reference's ``LoRAMaskDecoderFactory(r=128, alpha=128)`` on q_proj and
v_proj of every decoder attention: self-attention, both cross-attentions of
each layer and the final token-to-image attention
(``models/sam2_blocks.py:251-286``).

Parameters carry the names of the reference's trained state dict (the
layout ``cryovit_tpu.train.torch_export_sam2`` writes): a LoRA-wrapped
projection holds its base Linear under ``.proj`` and the factors under
``.w_a``/``.w_b``; with rank 0 the projection is a plain Linear, as
published. The attention is plain softmax attention
(``F.scaled_dot_product_attention``); mask logits, IoU and object scores
come back in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cryovit_tpu_torch.models.sam2.config import SAM2Config
from cryovit_tpu_torch.models.sam2.layers import Conv2d, ConvTranspose2d, LayerNorm, Linear, cast

__all__ = ["LoRAAttention", "LoRALinear", "MaskDecoder", "TwoWayAttentionBlock", "attention"]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax attention of ``(B, N, heads·hd)`` projections, scale hd^-½;
    ``mask`` ``(B, M)`` bool marks the keys that count."""
    b, n, c = q.shape
    hd = c // heads

    def split(t):
        return t.reshape(b, t.shape[1], heads, hd).transpose(1, 2)

    attn_mask = None if mask is None else mask[:, None, None, :]
    out = F.scaled_dot_product_attention(split(q), split(k), split(v), attn_mask=attn_mask,
                                         scale=hd**-0.5)
    return out.transpose(1, 2).reshape(b, n, c)


class LoRALinear(nn.Module):
    """``y = W x + (α/r)·B(A x)`` (reference ``sam2_blocks.py:226-248``):
    A kaiming-uniform, B zero, so it starts as the base projection."""

    def __init__(self, cin: int, cout: int, rank: int, alpha: float):
        super().__init__()
        self.scale = alpha / rank
        self.proj = Linear(cin, cout)
        self.w_a = Linear(cin, rank, bias=False)
        self.w_b = Linear(rank, cout, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x) + self.w_b(self.w_a(x)) * self.scale


def _lora_or_linear(cin: int, cout: int, rank: int, alpha: float) -> nn.Module:
    return LoRALinear(cin, cout, rank, alpha) if rank > 0 else Linear(cin, cout)


class LoRAAttention(nn.Module):
    """SAM decoder attention with internal downsampling and LoRA on q/v."""

    def __init__(self, dim: int, num_heads: int, downsample_rate: int = 1,
                 lora_rank: int = 0, lora_alpha: float = 1.0):
        super().__init__()
        inner = dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = _lora_or_linear(dim, inner, lora_rank, lora_alpha)
        self.k_proj = Linear(dim, inner)
        self.v_proj = _lora_or_linear(dim, inner, lora_rank, lora_alpha)
        self.out_proj = Linear(inner, dim)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        out = attention(self.q_proj(q), self.k_proj(k), self.v_proj(v), self.num_heads)
        return self.out_proj(out)


class _MLP(nn.Module):
    """``layers.{0..n-1}`` Linear with ReLU between (sam2 ``MLP``)."""

    def __init__(self, dims: list[int], sigmoid_output: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.sigmoid_output = sigmoid_output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


class TwoWayAttentionBlock(nn.Module):
    """Token self-attention, token→image cross-attention, MLP (ReLU, 8·d),
    image→token cross-attention; LayerNorm eps 1e-6 after each."""

    def __init__(self, dim: int, num_heads: int, lora_rank: int, lora_alpha: float,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha)
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = LoRAAttention(dim, num_heads, **lora)
        self.cross_attn_token_to_image = LoRAAttention(dim, num_heads, 2, **lora)
        self.cross_attn_image_to_token = LoRAAttention(dim, num_heads, 2, **lora)
        self.mlp = _MLP([dim, dim * 8, dim])
        self.norm1, self.norm2, self.norm3, self.norm4 = (LayerNorm(dim, eps=1e-6) for _ in range(4))

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        k = keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(queries + query_pe, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, queries + query_pe, queries))
        return queries, keys


class _Transformer(nn.Module):
    def __init__(self, cfg: SAM2Config, lora_rank: int, lora_alpha: float):
        super().__init__()
        d = cfg.d_model
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(d, cfg.decoder_heads, lora_rank, lora_alpha, i == 0)
            for i in range(cfg.decoder_depth)
        )
        self.final_attn_token_to_image = LoRAAttention(d, cfg.decoder_heads, 2, lora_rank, lora_alpha)
        self.norm_final_attn = LayerNorm(d, eps=1e-6)


class MaskDecoder(nn.Module):
    """``forward(image_embeddings (B, e, e, d), image_pe (e, e, d), sparse
    (B, n, d), dense (B, e, e, d), high_res (s0 (B, 4e, 4e, d), s1 (B, 2e,
    2e, d)))`` → (mask logits ``(B, M, 4e, 4e)`` f32, IoU ``(B, M)`` f32,
    mask tokens ``(B, M, d)``, object score ``(B, 1)`` f32), M = 3 + 1."""

    def __init__(self, cfg: SAM2Config, lora_rank: int = 128, lora_alpha: float = 128.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d = cfg.d_model
        m = cfg.num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(m, d)
        self.obj_score_token = nn.Embedding(1, d)
        self.transformer = _Transformer(cfg, lora_rank, lora_alpha)
        self.output_upscaling = nn.ModuleList([
            ConvTranspose2d(d, d // 4, 2, 2), LayerNorm(d // 4, eps=1e-6), nn.GELU(),
            ConvTranspose2d(d // 4, d // 8, 2, 2),
        ])
        self.conv_s0 = Conv2d(d, d // 8, 1)
        self.conv_s1 = Conv2d(d, d // 4, 1)
        self.output_hypernetworks_mlps = nn.ModuleList(_MLP([d, d, d, d // 8]) for _ in range(m))
        self.iou_prediction_head = _MLP([d] + [d] * (cfg.iou_head_depth - 1) + [m], sigmoid_output=True)
        self.pred_obj_score_head = _MLP([d, d, d, 1])

    def forward(self, image_embeddings, image_pe, sparse, dense, high_res):
        dt = self.dtype
        b, e = image_embeddings.shape[:2]
        d = self.cfg.d_model
        m = self.cfg.num_multimask_outputs + 1
        keys = (image_embeddings + dense).to(dt).reshape(b, e * e, d)
        out_tokens = torch.cat([cast(t.weight, keys) for t in
                                (self.obj_score_token, self.iou_token, self.mask_tokens)])
        tokens = torch.cat([out_tokens[None].expand(b, -1, -1), sparse.to(dt)], dim=1)
        pe = image_pe.reshape(1, e * e, d).to(dt).expand(b, -1, -1)

        queries = tokens
        tf = self.transformer
        for layer in tf.layers:
            queries, keys = layer(queries, keys, tokens, pe)
        queries = queries + tf.final_attn_token_to_image(queries + tokens, keys + pe, keys)
        queries = tf.norm_final_attn(queries)
        obj_out, iou_out, mask_out = queries[:, 0], queries[:, 1], queries[:, 2 : 2 + m]

        up = self.output_upscaling
        up1 = up[0](keys.reshape(b, e, e, d)) + self.conv_s1(high_res[1].to(dt))
        up1 = F.gelu(up[1](up1))
        up2 = F.gelu(up[3](up1) + self.conv_s0(high_res[0].to(dt)))

        hyper = torch.stack(
            [mlp(mask_out[:, i]) for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1
        )
        masks = torch.einsum("bmc,bhwc->bmhw", hyper.float(), up2.float())
        ious = self.iou_prediction_head(iou_out).float()
        obj_score = self.pred_obj_score_head(obj_out).float()
        return masks, ious, mask_out, obj_score

