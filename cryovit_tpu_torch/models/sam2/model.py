"""SAM2 tracking over a z-stack: the memory bank and the slice loop.

Port of ``cryovit_tpu/models/sam2/model.py`` (reference ``SAM2Train``,
``models/sam2.py:322-796``): box + dense-mask prompts from the prompt
predictor on every slice; the conditioning slices (the first ``num_cond``
of ``order``) go first with multimask outputs and no memory; every other
slice attends to the memory bank and takes the single-mask output; masks
are gated by the object score at ``no_obj_score``, upsampled 4× and
returned as sigmoid probabilities.

The JAX package carries the bank through a ``lax.scan``; here the loop over
slices is a Python loop over the same fixed ring buffer: ``max_cond_slices``
cond slots, then ``num_maskmem − 1`` rolling slots, each written memory
positioned by a recency-indexed ``maskmem_tpos_enc``, and the object
pointers on their own slot axis. The bank's validity is known on the host,
so empty slots are left out of the memory tokens rather than masked (the
masked softmax weighs them exactly zero) and cond slices skip the memory
attention instead of computing and discarding it. Nothing is detached
between slices: the loss of a later slice reaches the LoRA factors and the
prompt predictor through the memories it read, as in the JAX package,
which differentiates through the scan.

``kv_cache=True`` (off by default, as in the JAX package) takes the cached
memory attention: each written slot is projected through every layer's
cross k/v once, at write time, and kept in the bank beside the memory; a
slice then attends to those entries plus the parameter-only position terms
instead of re-projecting every valid slot. The projections and RoPE are
linear, so both give the same features.

The image encoder is frozen: it runs in ``encoder_chunk``-slice chunks
under ``torch.no_grad`` on a compute copy (RGB replication folded into the
patch embed, qkv scales folded for the kernels, weights in the compute
dtype) made once from the f32 weights this module holds. On a GPU in bf16
its Hiera-L stage-3 blocks run the window kernels (rows 9–11).

With ``forward(..., mesh=...)`` (a mesh of more than one rank, every rank
holding the whole batch) the encoder is split over the ranks: each encodes
its equal, contiguous share of the ``B·D`` slices and every pyramid level is
gathered whole (``Mesh.gather``, exact). No gradient crosses the gather, as
the encoder is frozen, so the prompt predictor, the prompt encoder, the
tracking loop and the resize run on every rank over the whole batch and
give the single process's outputs and gradients.

Parameters carry the reference's trained state-dict names: the SAM2Base
tree under ``model.`` and the predictor under ``prompt_predictor.``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from cryovit_tpu_torch.models._init import lecun_normal
from cryovit_tpu_torch.models.sam2.config import SAM2Config
from cryovit_tpu_torch.models.sam2.decoder import LoRALinear, MaskDecoder
from cryovit_tpu_torch.models.sam2.encoder import (
    ImageEncoder,
    fold_rgb_patch_embed,
    make_image_encoder,
    random_encoder_state_dict,
    sine_position_encoding,
)
from cryovit_tpu_torch.models.sam2.layers import Linear, casts_kept_in
from cryovit_tpu_torch.models.sam2.memory import MemoryAttention, MemoryEncoder, sine_pe_1d
from cryovit_tpu_torch.models.sam2.prompt_predictor import PromptPredictor
from cryovit_tpu_torch.models.sam2.prompts import PromptEncoder
from cryovit_tpu_torch.ops.resize import resize_linear_2d
from cryovit_tpu_torch.parallel.mesh import Mesh

__all__ = ["MemoryBank", "SAM2Model", "random_sam2_state_dict"]


@dataclasses.dataclass
class MemoryBank:
    """Tracking state: ``spatial[slot]`` is a written memory ``(B, e·e,
    mem_dim)`` or None; ``obj_ptrs[slot]`` a pointer ``(B, d_model)`` or
    None. Slots ``[0, max_cond_slices)`` hold conditioning memories, the
    rest the rolling ring. ``write_idx`` counts non-cond writes + 1. With
    ``kv_cache``, ``k_sp``/``v_sp[slot]`` hold the slot's cross k/v entries
    ``(B, e·e, L·d_model)`` and ``k_pt``/``v_pt[slot]`` the pointer's
    ``(B, d_model/mem_dim, L·d_model)`` (``MemoryAttention.project_memory``
    / ``project_ptr``); otherwise they are None."""

    spatial: list
    obj_ptrs: list
    write_idx: int = 1
    cond_count: int = 0
    k_sp: list | None = None
    v_sp: list | None = None
    k_pt: list | None = None
    v_pt: list | None = None

    @classmethod
    def empty(cls, cfg: SAM2Config, kv_cache: bool = False) -> "MemoryBank":
        n, p = cfg.max_cond_slices + cfg.num_maskmem - 1, cfg.max_obj_ptrs
        caches = dict(k_sp=[None] * n, v_sp=[None] * n, k_pt=[None] * p, v_pt=[None] * p)
        return cls([None] * n, [None] * p, **(caches if kv_cache else {}))

    @property
    def spatial_valid(self) -> list[bool]:
        return [m is not None for m in self.spatial]


class _SAM2Base(nn.Module):
    """The published SAM2Base modules and embeddings (the ``model.`` tree)."""

    def __init__(self, cfg: SAM2Config, lora_rank: int, lora_alpha: float, dtype: torch.dtype):
        super().__init__()
        d = cfg.d_model
        self.image_encoder = ImageEncoder(cfg, in_chans=3)
        self.sam_prompt_encoder = PromptEncoder(cfg, dtype)
        self.sam_mask_decoder = MaskDecoder(cfg, lora_rank, lora_alpha, dtype)
        self.memory_encoder = MemoryEncoder(cfg, dtype)
        self.memory_attention = MemoryAttention(cfg, dtype)
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, d))
        # sam2's fallback position code, unused by the directly-added no-mem
        # embedding of sam2.1 but kept so checkpoints map completely
        self.no_mem_pos_enc = nn.Parameter(torch.zeros(1, 1, d))
        self.maskmem_tpos_enc = nn.Parameter(torch.zeros(cfg.num_maskmem, 1, 1, cfg.mem_dim))
        self.obj_ptr_proj = Linear(d, d)
        if cfg.add_tpos_enc_to_obj_ptrs:
            self.obj_ptr_tpos_proj = Linear(d, cfg.mem_dim)
        self.no_obj_ptr = nn.Parameter(torch.zeros(1, d))


class SAM2Model(nn.Module):
    """``forward(slices (B, D, S, S), backbone=None, order=None,
    num_cond=None, mesh=None)`` → ``{"preds": (B, D, S, S) sigmoid
    probabilities, "prompts": (B, D, S, S) mask-prompt logits}``.

    ``backbone`` is a cached pyramid ``{"backbone_fpn", "vision_pos_enc"}``
    of flat ``(B·D, h, w, C)`` levels (the live encoder runs otherwise);
    ``order`` the processing order with the cond slices first, ``num_cond``
    how many of them are cond slices (defaults: natural order, one);
    ``mesh`` splits the live encoder over its ranks (see above).
    ``kv_cache`` takes the cached memory attention (see above)."""

    def __init__(self, cfg: SAM2Config | None = None, lora_rank: int = 128,
                 lora_alpha: float = 128.0, dtype: torch.dtype = torch.float32,
                 encoder_chunk: int = 64, kv_cache: bool = False):
        super().__init__()
        self.cfg = cfg = cfg or SAM2Config.large()
        self.dtype, self.encoder_chunk, self.kv_cache = dtype, encoder_chunk, kv_cache
        self.model = _SAM2Base(cfg, lora_rank, lora_alpha, dtype)
        self.prompt_predictor = PromptPredictor(in_channels=cfg.d_model, dtype=dtype)
        self._encoder_copy: dict = {}
        self._head_casts: dict = {}  # the heads' frozen weights in the compute dtype

    def load_state_dict(self, *args, **kwargs):
        self._encoder_copy.clear()
        self._head_casts.clear()
        return super().load_state_dict(*args, **kwargs)

    # ---- the frozen encoder ---------------------------------------------

    def compute_encoder(self) -> ImageEncoder:
        """The encoder's compute copy for the device and dtype of the
        weights it is made from (made once; frozen weights do not change)."""
        src = self.model.image_encoder
        device = src.trunk.pos_embed.device
        key = (device, self.dtype)
        if key not in self._encoder_copy:
            self._encoder_copy.clear()
            sd = fold_rgb_patch_embed({k: v.detach() for k, v in src.state_dict().items()})
            self._encoder_copy[key] = make_image_encoder(sd, self.cfg, device, self.dtype)
        return self._encoder_copy[key]

    @torch.no_grad()
    def encode_images(self, slices: torch.Tensor,
                      mesh: Mesh | None = None) -> dict[str, list[torch.Tensor]]:
        """``(N, S, S)`` grayscale slices → the backbone pyramids, in chunks
        of ``encoder_chunk`` slices. With a ``mesh`` of more than one rank
        this rank encodes only its share of the ``N`` slices (``N`` must
        divide by the mesh size) and each level is gathered whole."""
        enc = self.compute_encoder()
        n = slices.shape[0]
        split = mesh is not None and mesh.size > 1
        if split:
            if n % mesh.size:
                raise ValueError(f"{n} slices do not split over a mesh of {mesh.size}")
            k = n // mesh.size
            slices = slices[mesh.rank * k : (mesh.rank + 1) * k]
        ch = self.encoder_chunk or slices.shape[0]
        outs = [enc(slices[i : i + ch, ..., None]) for i in range(0, slices.shape[0], ch)]
        levels = range(len(outs[0]["backbone_fpn"]))
        fpn = [torch.cat([o["backbone_fpn"][lvl] for o in outs]) for lvl in levels]
        if split:
            fpn = [mesh.gather(f) for f in fpn]
        # the position codes are the same for every slice: one, broadcast
        return {"backbone_fpn": fpn,
                "vision_pos_enc": [outs[0]["vision_pos_enc"][lvl][:1].expand(n, -1, -1, -1)
                                   for lvl in levels]}

    # ---- sub-steps ------------------------------------------------------

    def _recency(self, bank: MemoryBank) -> tuple[list[int], list[int]]:
        """Per spatial slot its ``maskmem_tpos_enc`` row (cond slots pin the
        conditioning row), per pointer slot its temporal distance."""
        cfg = self.cfg
        mc, nm = cfg.max_cond_slices, cfg.num_maskmem
        recency = [nm - 1 if i < mc else (bank.write_idx - 1 - (i - mc + 1)) % (nm - 1)
                   for i in range(len(bank.spatial))]
        pdist = [0 if p < mc else 1 + (bank.write_idx - 1 - (p - mc + 1)) % (cfg.max_obj_ptrs - mc)
                 for p in range(len(bank.obj_ptrs))]
        return recency, pdist

    def _position_tables(self, dtype: torch.dtype):
        """Per tracking pass: the memory grid's sine code ``(e·e, mem_dim)``;
        with ``add_tpos_enc_to_obj_ptrs``, each pointer distance's projected
        temporal sine code ``(max_obj_ptrs, mem_dim)`` (a pointer slot's
        distance is below ``max_obj_ptrs``), else None; the prompt encoder's
        dense code of the image grid ``(e, e, d)`` f32; with ``kv_cache`` the
        memory attention's parameter-only key terms, else None."""
        cfg, m = self.cfg, self.model
        e, md = cfg.embed_size, cfg.mem_dim
        device = m.no_mem_embed.device
        grid = torch.from_numpy(sine_position_encoding(e, e, md).copy()).to(device, dtype)
        grid = grid.reshape(e * e, md)
        image_pe = m.sam_prompt_encoder.dense_pe()
        static = (m.memory_attention.static_keys(grid, m.maskmem_tpos_enc.reshape(-1, md))
                  if self.kv_cache else None)
        if not cfg.add_tpos_enc_to_obj_ptrs:
            return grid, None, image_pe, static
        dist = torch.arange(cfg.max_obj_ptrs, dtype=torch.float32, device=device)
        ptr_pe = m.obj_ptr_tpos_proj(
            sine_pe_1d(dist / max(cfg.max_obj_ptrs - 1, 1), cfg.d_model).to(self.dtype))
        return grid, ptr_pe.to(dtype), image_pe, static

    def _memory_tokens(self, bank: MemoryBank, tables):
        """The valid slots as ``(B, M, mem_dim)`` tokens, their position
        stream (the grid's sine code + the recency row; the pointers'
        projected temporal sine code) and the spatial token count."""
        cfg, m = self.cfg, self.model
        md = cfg.mem_dim
        grid_pe, ptr_pe = tables[:2]
        recency, pdist = self._recency(bank)
        tpos = m.maskmem_tpos_enc.reshape(cfg.num_maskmem, md).to(grid_pe.dtype)
        slots = [i for i, s in enumerate(bank.spatial) if s is not None]
        tokens = [bank.spatial[i] for i in slots]
        b = tokens[0].shape[0]
        pos = [(grid_pe + tpos[recency[i]]).expand(b, -1, -1) for i in slots]
        n_spatial = len(slots) * grid_pe.shape[0]

        ptrs = [p for p in range(len(bank.obj_ptrs)) if bank.obj_ptrs[p] is not None]
        ratio = cfg.d_model // md
        tokens += [bank.obj_ptrs[p].reshape(b, ratio, md) for p in ptrs]
        for p in ptrs:
            pe = ptr_pe[pdist[p]] if ptr_pe is not None else torch.zeros_like(grid_pe[0])
            pos.append(pe.expand(b, ratio, md))
        return torch.cat(tokens, dim=1), torch.cat(pos, dim=1), n_spatial

    def _condition(self, feats, pos, bank: MemoryBank, use_memory: bool, tables):
        """Memory-conditioned features, or the learned no-memory embedding
        for cond slices and while the bank is empty."""
        if not (use_memory and any(bank.spatial_valid)):
            return feats + self.model.no_mem_embed.reshape(1, 1, 1, -1).to(feats.dtype)
        if bank.k_sp is not None:
            return self._condition_cached(feats, pos, bank, tables)
        tokens, mem_pos, n_rope_k = self._memory_tokens(bank, tables)
        return self.model.memory_attention(feats, pos, tokens, mem_pos, None, n_rope_k)

    def _condition_cached(self, feats, pos, bank: MemoryBank, tables):
        """The cached path: the valid slots' cache entries, their recency
        rows and the valid pointers' temporal codes (zeros without
        ``add_tpos_enc_to_obj_ptrs``)."""
        grid_pe, ptr_pe, _, static = tables
        recency, pdist = self._recency(bank)
        slots = [i for i, s in enumerate(bank.spatial) if s is not None]
        ptrs = [p for p, t in enumerate(bank.obj_ptrs) if t is not None]
        pe = (torch.stack([ptr_pe[pdist[p]] for p in ptrs]) if ptr_pe is not None
              else grid_pe.new_zeros(len(ptrs), grid_pe.shape[1]))
        return self.model.memory_attention.cached(
            feats, pos, torch.stack([bank.k_sp[i] for i in slots], dim=1),
            torch.stack([bank.v_sp[i] for i in slots], dim=1),
            torch.stack([bank.k_pt[p] for p in ptrs], dim=1),
            torch.stack([bank.v_pt[p] for p in ptrs], dim=1),
            [recency[i] for i in slots], pe, static)

    def _encode_prompts(self, boxes: torch.Tensor, prompts: torch.Tensor):
        """Prompt encoding for all slices at once: boxes ``(B, D, 4)`` in
        [0, 1], prompts ``(B, D, S, S)`` → sparse ``(B, D, 3, d)``, dense
        ``(B, D, e, e, d)``. The prompt is resized to the mask-input size
        with ``jax.image.resize``'s antialiased linear weights."""
        cfg = self.cfg
        b, d = boxes.shape[:2]
        s = cfg.mask_input_size
        mp = resize_linear_2d(prompts.reshape(b * d, *prompts.shape[2:]), s, s)[..., None]
        sparse, dense = self.model.sam_prompt_encoder(boxes.reshape(b * d, 4) * cfg.image_size, mp)
        return sparse.reshape(b, d, *sparse.shape[1:]), dense.reshape(b, d, *dense.shape[1:])

    def _sam_heads(self, pix, image_pe, sparse, dense, high_res, multimask: bool):
        """Mask decoding, object-score gating and the selection: multimask
        (cond slices) predicts the max over outputs 1..3 and sends the
        best-IoU mask and token on; otherwise output 0 throughout."""
        cfg, m = self.cfg, self.model
        masks, ious, tokens, obj_score = m.sam_mask_decoder(pix, image_pe, sparse, dense, high_res)
        is_obj = obj_score > 0
        masks = torch.where(is_obj[:, :, None, None], masks, torch.full_like(masks, cfg.no_obj_score))
        if multimask:
            low = masks[:, 1:].amax(dim=1)
            rows = torch.arange(masks.shape[0], device=masks.device)
            best = ious[:, 1:].argmax(dim=-1)
            mem_mask, token = masks[:, 1:][rows, best], tokens[:, 1:][rows, best]
        else:
            low, mem_mask, token = masks[:, 0], masks[:, 0], tokens[:, 0]
        obj_ptr = m.obj_ptr_proj(token)
        lam = is_obj.to(obj_ptr.dtype)
        obj_ptr = lam * obj_ptr + (1 - lam) * m.no_obj_ptr.to(obj_ptr.dtype)
        high = resize_linear_2d(mem_mask, cfg.image_size, cfg.image_size)[..., None]
        return low, high, obj_ptr

    def _write_memory(self, bank: MemoryBank, pix_feat, high_res_mask, obj_ptr,
                      is_cond: bool) -> MemoryBank:
        """Encode one memory from the raw features and the sigmoid mask (with
        sam2.1's affine) and write it: cond memories to the next cond slot,
        the rest round the ring."""
        cfg = self.cfg
        mc = cfg.max_cond_slices
        mask = (torch.sigmoid(high_res_mask) * cfg.sigmoid_scale_for_mem_enc
                + cfg.sigmoid_bias_for_mem_enc)
        mem = self.model.memory_encoder(pix_feat, mask, skip_sigmoid=True)
        mem = mem.reshape(mem.shape[0], -1, cfg.mem_dim)
        if is_cond:
            slot = pslot = min(bank.cond_count, mc - 1)
        else:
            slot = mc + (bank.write_idx - 1) % (cfg.num_maskmem - 1)
            pslot = mc + (bank.write_idx - 1) % (cfg.max_obj_ptrs - mc)
        spatial, ptrs = list(bank.spatial), list(bank.obj_ptrs)
        spatial[slot], ptrs[pslot] = mem, obj_ptr
        caches = {}
        if bank.k_sp is not None:
            # the written slot through every layer's cross k/v, once
            ma = self.model.memory_attention
            caches = {name: list(getattr(bank, name)) for name in ("k_sp", "v_sp", "k_pt", "v_pt")}
            caches["k_sp"][slot], caches["v_sp"][slot] = ma.project_memory(mem)
            caches["k_pt"][pslot], caches["v_pt"][pslot] = ma.project_ptr(
                obj_ptr.reshape(obj_ptr.shape[0], -1, cfg.mem_dim))
        return MemoryBank(spatial, ptrs, bank.write_idx + (0 if is_cond else 1),
                          bank.cond_count + (1 if is_cond else 0), **caches)

    def _slice_step(self, bank: MemoryBank, feat, pos, s0, s1, sparse, dense, is_cond: bool,
                    tables):
        pix = self._condition(feat, pos, bank, not is_cond, tables)
        low, high, obj_ptr = self._sam_heads(pix, tables[2], sparse, dense, (s0, s1), is_cond)
        # sam2 encodes the raw backbone features into memory, not the
        # memory-conditioned ones
        return self._write_memory(bank, feat, high, obj_ptr, is_cond), low

    # ---- the tracking pass ------------------------------------------------

    def forward(self, slices: torch.Tensor, backbone: dict | None = None,
                order=None, num_cond=None, mesh: Mesh | None = None) -> dict[str, torch.Tensor]:
        with casts_kept_in(self._head_casts):
            return self._track(slices, backbone, order, num_cond, mesh)

    def _track(self, slices, backbone, order, num_cond, mesh=None) -> dict[str, torch.Tensor]:
        cfg = self.cfg
        b, d, s, _ = slices.shape
        order = list(range(d)) if order is None else [int(i) for i in order]
        num_cond = 1 if num_cond is None else int(num_cond)
        if sorted(order) != list(range(d)):
            raise ValueError(f"order must be a permutation of range({d}): {order}")
        if backbone is None:
            backbone = self.encode_images(slices.reshape(b * d, s, s), mesh)
        fpn, pos = backbone["backbone_fpn"], backbone["vision_pos_enc"]

        def unflat(x):
            return x.reshape(b, d, *x.shape[1:])

        s0, s1, s2 = (unflat(f) for f in fpn[:3])
        pos2 = unflat(pos[2])
        boxes, prompts = self.prompt_predictor(s0)
        boxes, prompts = boxes.reshape(b, d, 4), prompts.reshape(b, d, s, s)
        sparse, dense = self._encode_prompts(boxes, prompts)

        bank = MemoryBank.empty(cfg, self.kv_cache)
        tables = self._position_tables(self.model.memory_encoder.dtype)
        lows: list = [None] * d
        for t, i in enumerate(order):
            bank, lows[i] = self._slice_step(
                bank, s2[:, i], pos2[:, i], s0[:, i], s1[:, i], sparse[:, i], dense[:, i],
                t < num_cond, tables,
            )
        up = resize_linear_2d(torch.stack(lows, dim=1), s, s)
        return {"preds": torch.sigmoid(up), "prompts": prompts}


def random_sam2_state_dict(cfg: SAM2Config, generator: torch.Generator, lora_rank: int = 128,
                           lora_alpha: float = 128.0) -> dict[str, torch.Tensor]:
    """A :class:`SAM2Model` state dict drawn with flax's init laws, as the
    JAX package's ``model.init``: lecun-normal kernels (fan-in over input
    channels and taps), zero biases, unit LayerNorm scales, learned
    embeddings N(0, 0.02²), the Fourier matrix N(0, 1), LayerScale 1e-6,
    LoRA A kaiming-uniform and B zero; the encoder by
    ``random_encoder_state_dict``. Drawn in f32 on the generator's device."""
    device = generator.device
    with torch.device("meta"):
        template = SAM2Model(cfg, lora_rank, lora_alpha)
    modules = dict(template.named_modules())
    lora_a = {f"{n}.w_a.weight" for n, mod in modules.items() if isinstance(mod, LoRALinear)}
    out = {f"model.image_encoder.{k}": v
           for k, v in random_encoder_state_dict(cfg, generator).items()}
    for name, t in template.state_dict().items():
        if name in out:
            continue
        shape = tuple(t.shape)
        owner = modules[name.rsplit(".", 1)[0]] if "." in name else template
        leaf = name.rsplit(".", 1)[-1]
        if name in lora_a:
            bound = math.sqrt(6.0 / shape[1])
            out[name] = torch.empty(shape, device=device).uniform_(-bound, bound, generator=generator)
        elif name.endswith(".w_b.weight") or leaf == "bias":
            out[name] = torch.zeros(shape, device=device)
        elif isinstance(owner, nn.LayerNorm):
            out[name] = torch.ones(shape, device=device)
        elif isinstance(owner, nn.ConvTranspose2d):  # (in, out, kh, kw)
            out[name] = lecun_normal(shape, shape[0] * shape[2] * shape[3], generator)
        elif isinstance(owner, (nn.Linear, nn.Conv2d, nn.Conv3d)):
            out[name] = lecun_normal(shape, t[0].numel(), generator)
        elif leaf == "positional_encoding_gaussian_matrix":
            out[name] = torch.randn(shape, generator=generator, device=device)
        elif leaf == "gamma":
            out[name] = torch.full(shape, 1e-6, device=device)
        else:  # tokens, embeddings, no-mem / no-obj parameters
            out[name] = torch.randn(shape, generator=generator, device=device) * 0.02
    return out
