"""Weight bridges into the port's parameter names: numpy in, numpy out.

- :func:`dinov2_from_jax`: the JAX package's DINOv2 params (scanned
  ``blocks`` with a leading depth axis, or per-block ``block{i}``) → port
  state dict (torch hub names, patch embed folded to one channel).
- :func:`dinov2_from_torch_hub`: a torch hub DINOv2 state dict (e.g. the
  published ``dinov2_vitg14_reg4_pretrain.pth``) → port state dict, folding
  the 3-channel patch embed (and optionally ImageNet normalization) into one
  channel.
- :func:`cryovit_from_jax`: the JAX ``CryoVITModule`` params → the
  reference CryoVIT state dict (the layout
  ``cryovit_tpu.train.torch_export.export_cryovit_state_dict`` writes).
- :func:`unet3d_from_jax`: the JAX ``UNet3DModule`` params → the reference
  UNet3D state dict (the layout
  ``cryovit_tpu.train.torch_export.export_unet3d_state_dict`` writes).
- :func:`sam2_encoder_from_jax`: the JAX SAM2 ``ImageEncoder`` params → port
  state dict (the published sam2 names without ``image_encoder.``).
- :func:`sam2_encoder_from_published`: a published sam2 checkpoint's
  ``model`` dict (e.g. ``sam2.1_hiera_large.pt``) → port state dict.
- :func:`sam2_from_jax`: the JAX ``SAM2Model`` variables (encoder, heads,
  LoRA, prompt predictor; bare or under the family's ``sam`` scope) → the
  reference's trained SAM2 state dict (the layout
  ``cryovit_tpu.train.torch_export_sam2.export_sam2_state_dict`` writes),
  the names of the port's ``SAM2Model``.
- :func:`sam2_from_published`: a published sam2 checkpoint's ``model``
  dict → the same names, for every module the checkpoint has; the LoRA
  factors and the prompt predictor are not in it and stay fresh.

Layout rules: a flax Dense kernel ``(in, out)`` is a torch Linear weight
``(out, in)``; a flax conv kernel ``(kd, kh, kw, in, out)`` is a torch Conv3d
weight ``(out, in, kd, kh, kw)``; a flax ConvTranspose kernel is a torch
ConvTranspose3d weight ``(in, out, kd, kh, kw)`` with its taps flipped.
"""

from __future__ import annotations

from typing import Any

import numpy as np

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "cryovit_from_jax",
    "dinov2_from_jax",
    "dinov2_from_torch_hub",
    "fold_patch_embed",
    "sam2_encoder_from_jax",
    "sam2_encoder_from_published",
    "sam2_from_jax",
    "sam2_from_published",
    "unet3d_from_jax",
]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _np(x: Any) -> np.ndarray:
    """numpy float32 view of a numpy/jax array or a torch tensor."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _params(tree: dict) -> dict:
    return tree.get("params", tree)


def fold_patch_embed(
    weight: np.ndarray, bias: np.ndarray, normalize: bool
) -> tuple[np.ndarray, np.ndarray]:
    """Fold 3-channel replication (+ optional ImageNet normalization) of
    grayscale slices into the patch embed: ``(E, 3, p, p)`` weight →
    ``(E, 1, p, p)``, and the matching bias. With identical channels x:
    ``Σ_c W_c ⊛ (x−m_c)/s_c = (Σ_c W_c/s_c) ⊛ x − Σ_c m_c/s_c·(ΣW_c)``."""
    w = np.asarray(weight, dtype=np.float64)
    b = np.asarray(bias, dtype=np.float64)
    if normalize:
        scale = np.asarray(IMAGENET_STD, dtype=np.float64)
        mean = np.asarray(IMAGENET_MEAN, dtype=np.float64)
        folded = (w / scale[None, :, None, None]).sum(axis=1)
        b = b - (w.sum(axis=(2, 3)) * (mean / scale)[None, :]).sum(axis=1)
    else:
        folded = w.sum(axis=1)
    return folded[:, None].astype(np.float32), b.astype(np.float32)


def _block_names(i: int) -> dict[str, tuple[str, ...]]:
    """Port name → path in a JAX block's param tree (``T`` = transpose)."""
    p = f"blocks.{i}"
    return {
        f"{p}.norm1.weight": ("norm1", "scale"),
        f"{p}.norm1.bias": ("norm1", "bias"),
        f"{p}.attn.qkv.weight": ("attn", "qkv", "kernel", "T"),
        f"{p}.attn.qkv.bias": ("attn", "qkv", "bias"),
        f"{p}.attn.proj.weight": ("attn", "proj", "kernel", "T"),
        f"{p}.attn.proj.bias": ("attn", "proj", "bias"),
        f"{p}.ls1.gamma": ("ls1_gamma",),
        f"{p}.norm2.weight": ("norm2", "scale"),
        f"{p}.norm2.bias": ("norm2", "bias"),
        f"{p}.mlp.w12.weight": ("mlp", "w12", "kernel", "T"),
        f"{p}.mlp.w12.bias": ("mlp", "w12", "bias"),
        f"{p}.mlp.w3.weight": ("mlp", "w3", "kernel", "T"),
        f"{p}.mlp.w3.bias": ("mlp", "w3", "bias"),
        f"{p}.ls2.gamma": ("ls2_gamma",),
    }


def dinov2_from_jax(params: dict) -> dict[str, np.ndarray]:
    """JAX ``DinoV2`` params → port state dict. Takes the scanned layout
    (``blocks`` leaves with a leading depth axis, ViT-g's default) and the
    per-block ``block{i}`` layout."""
    params = _params(params)
    kernel = _np(params["patch_kernel"])  # (p·p, E), single channel
    e = kernel.shape[1]
    p = int(round(kernel.shape[0] ** 0.5))
    out = {
        "patch_embed.proj.weight": np.ascontiguousarray(kernel.T.reshape(e, 1, p, p)),
        "patch_embed.proj.bias": _np(params["patch_bias"]),
        "cls_token": _np(params["cls_token"]).reshape(1, 1, e),
        "register_tokens": _np(params["register_tokens"]).reshape(1, -1, e),
        "pos_embed": _np(params["pos_embed"]).reshape(1, -1, e),
    }
    if "blocks" in params:
        stacked = params["blocks"]
        depth = _np(stacked["ls1_gamma"]).shape[0]
        blocks = [(stacked, i) for i in range(depth)]
    else:
        depth = sum(1 for k in params if k.startswith("block"))
        blocks = [(params[f"block{i}"], None) for i in range(depth)]
    for i, (tree, index) in enumerate(blocks):
        for name, path in _block_names(i).items():
            keys = [k for k in path if k != "T"]
            leaf = tree
            for k in keys:
                leaf = leaf[k]
            arr = _np(leaf if index is None else leaf[index])
            out[name] = np.ascontiguousarray(arr.T if path[-1] == "T" else arr)
    out["norm.weight"] = _np(params["norm"]["scale"])
    out["norm.bias"] = _np(params["norm"]["bias"])
    return out


def dinov2_from_torch_hub(
    state_dict: dict[str, Any], normalize: bool = True
) -> dict[str, np.ndarray]:
    """torch hub DINOv2 state dict → port state dict: the 3-channel patch
    embed folds to one channel (``normalize`` also folds ImageNet
    normalization); keys the extractor does not use (``mask_token``) are
    dropped."""
    weight, bias = fold_patch_embed(
        _np(state_dict["patch_embed.proj.weight"]),
        _np(state_dict["patch_embed.proj.bias"]),
        normalize,
    )
    out = {"patch_embed.proj.weight": weight, "patch_embed.proj.bias": bias}
    for key in ("cls_token", "register_tokens", "pos_embed", "norm.weight", "norm.bias"):
        out[key] = _np(state_dict[key])
    depth = 1 + max(int(k.split(".")[1]) for k in state_dict if k.startswith("blocks."))
    for i in range(depth):
        for name in _block_names(i):
            out[name] = _np(state_dict[name])
    return out


def _conv_w(k: Any) -> np.ndarray:
    """flax (kd, kh, kw, in, out) → torch Conv3d (out, in, kd, kh, kw)."""
    return np.ascontiguousarray(_np(k).transpose(4, 3, 0, 1, 2))


def _convt_w(k: Any) -> np.ndarray:
    """flax ConvTranspose (kd, kh, kw, in, out) → torch ConvTranspose3d
    (in, out, kd, kh, kw), taps flipped."""
    return np.ascontiguousarray(_np(k).transpose(3, 4, 0, 1, 2)[:, :, ::-1, ::-1, ::-1])


# flax param trees of the 3D models → the torch weight of each kind of layer
_WEIGHT = {
    "conv": lambda t: _conv_w(t["kernel"]),
    "convt": lambda t: _convt_w(t["kernel"]),
    "dense": lambda t: np.ascontiguousarray(_np(t["kernel"]).T),
    "norm": lambda t: _np(t["scale"]),  # GroupNorm scale → norm weight
}


def _emit(out: dict, prefix: str, tree: dict, kind: str) -> None:
    out[f"{prefix}.weight"] = _WEIGHT[kind](tree)
    out[f"{prefix}.bias"] = _np(tree["bias"])


def cryovit_from_jax(params: dict) -> dict[str, np.ndarray]:
    """JAX ``CryoVITModule`` params → reference CryoVIT state dict."""
    params = _params(params)
    out: dict[str, np.ndarray] = {}
    _emit(out, "layers.0", params["Conv_0"], "conv")
    for i in range(4):
        block = params[f"SynthesisBlock_{i}"]
        base = f"layers.{2 + i}.layers"
        _emit(out, f"{base}.0", block["GroupNorm_0"], "norm")
        _emit(out, f"{base}.1", block["Conv_0"], "conv")
        _emit(out, f"{base}.3", block["Conv_1"], "conv")
        _emit(out, f"{base}.5", block["ConvTranspose_0"], "convt")
    _emit(out, "output_layer.0", params["Conv_1"], "conv")
    _emit(out, "output_layer.2", params["Conv_2"], "conv")
    return out


def unet3d_from_jax(params: dict) -> dict[str, np.ndarray]:
    """JAX ``UNet3DModule`` params → reference UNet3D state dict (flax
    GroupNorm with one group per channel is the reference's affine
    InstanceNorm3d; a Dense kernel is the projection's Linear)."""
    params = _params(params)
    out: dict[str, np.ndarray] = {}
    for i in range(3):
        block, base = params[f"AnalysisBlock_{i}"], f"analysis_layers.{i}"
        for name, key, kind in (("layers.0", "Conv_0", "conv"), ("layers.1", "GroupNorm_0", "norm"),
                                ("layers.3", "Conv_1", "conv"), ("layers.4", "GroupNorm_1", "norm"),
                                ("pool.0", "Conv_2", "conv"), ("pool.1", "GroupNorm_2", "norm")):
            _emit(out, f"{base}.{name}", block[key], kind)
    for name, key, kind in (("0", "Conv_0", "conv"), ("1", "GroupNorm_0", "norm"),
                            ("3", "Conv_1", "conv"), ("4", "GroupNorm_1", "norm")):
        _emit(out, f"bottom_layer.{name}", params[key], kind)
    for i in range(3):
        block, base = params[f"SynthesisBlock_{i}"], f"synthesis_layers.{i}"
        for name, key, kind in (
            ("upconv.0", "ConvTranspose_0", "convt"), ("upconv.1", "GroupNorm_0", "norm"),
            ("layers.0.proj", "Dense_0", "dense"), ("layers.1", "GroupNorm_1", "norm"),
            ("layers.3", "Conv_0", "conv"), ("layers.4", "GroupNorm_2", "norm"),
        ):
            _emit(out, f"{base}.{name}", block[key], kind)
    _emit(out, "output_layer", params["Conv_2"], "conv")
    return out


def _conv2d_w(k: Any) -> np.ndarray:
    """flax (kh, kw, in, out) → torch Conv2d (out, in, kh, kw)."""
    return np.ascontiguousarray(_np(k).transpose(3, 2, 0, 1))


def sam2_encoder_from_jax(params: dict) -> dict[str, np.ndarray]:
    """JAX SAM2 ``ImageEncoder`` params → port state dict. The JAX
    ``neck_conv{i}`` follows the trunk's output order (high resolution
    first); sam2's ``neck.convs.{j}`` the reverse (``models/sam2/
    convert.py:105-114`` of the JAX package)."""
    params = _params(params)
    trunk = params["trunk"]
    out = {
        "trunk.patch_embed.proj.weight": _conv2d_w(trunk["patch_embed"]["kernel"]),
        "trunk.patch_embed.proj.bias": _np(trunk["patch_embed"]["bias"]),
    }
    for name in ("pos_embed", "pos_embed_window"):  # (h, w, C) → (1, C, h, w)
        out[f"trunk.{name}"] = np.ascontiguousarray(_np(trunk[name]).transpose(2, 0, 1)[None])
    depth = sum(1 for k in trunk if k.startswith("block"))
    for i in range(depth):
        block, p = trunk[f"block{i}"], f"trunk.blocks.{i}"
        dense = {"attn.qkv": block["attn"]["qkv"], "attn.proj": block["attn"]["proj"],
                 "mlp.layers.0": block["mlp_fc1"], "mlp.layers.1": block["mlp_fc2"]}
        if "proj" in block:
            dense["proj"] = block["proj"]
        for name, tree in dense.items():
            out[f"{p}.{name}.weight"] = np.ascontiguousarray(_np(tree["kernel"]).T)
            out[f"{p}.{name}.bias"] = _np(tree["bias"])
        for norm in ("norm1", "norm2"):
            out[f"{p}.{norm}.weight"] = _np(block[norm]["scale"])
            out[f"{p}.{norm}.bias"] = _np(block[norm]["bias"])
    levels = sum(1 for k in params if k.startswith("neck_conv"))
    for i in range(levels):
        conv, p = params[f"neck_conv{i}"], f"neck.convs.{levels - 1 - i}.conv"
        out[f"{p}.weight"] = _conv2d_w(conv["kernel"])
        out[f"{p}.bias"] = _np(conv["bias"])
    return out


def sam2_encoder_from_published(state_dict: dict[str, Any]) -> dict[str, np.ndarray]:
    """The image encoder of a published sam2 checkpoint (its ``model``
    dict): the ``image_encoder.*`` tensors with that prefix stripped."""
    prefix = "image_encoder."
    return {k[len(prefix):]: _np(v) for k, v in state_dict.items() if k.startswith(prefix)}


def _dense2(out: dict, prefix: str, tree: dict) -> None:
    out[f"{prefix}.weight"] = np.ascontiguousarray(_np(tree["kernel"]).T)
    if "bias" in tree:
        out[f"{prefix}.bias"] = _np(tree["bias"])


def _conv2(out: dict, prefix: str, tree: dict) -> None:
    out[f"{prefix}.weight"] = _conv2d_w(tree["kernel"])
    if "bias" in tree:
        out[f"{prefix}.bias"] = _np(tree["bias"])


def _ln2(out: dict, prefix: str, tree: dict) -> None:
    out[f"{prefix}.weight"] = _np(tree["scale"])
    out[f"{prefix}.bias"] = _np(tree["bias"])


def _attention(out: dict, prefix: str, tree: dict) -> None:
    """Decoder attention; a LoRA-wrapped q/v keeps its base under ``.proj``
    and its factors as ``.w_a``/``.w_b`` (a rank-0 one is a plain Linear)."""
    for name in ("q_proj", "v_proj"):
        sub = tree[name]
        if "w_a" in sub:
            for part in ("proj", "w_a", "w_b"):
                _dense2(out, f"{prefix}.{name}.{part}", sub[part])
        else:
            _dense2(out, f"{prefix}.{name}", sub["proj"])
    _dense2(out, f"{prefix}.k_proj", tree["k_proj"])
    _dense2(out, f"{prefix}.out_proj", tree["out_proj"])


def _count(tree: dict, prefix: str, suffix: str = "") -> int:
    return sum(1 for k in tree if k.startswith(prefix) and k.endswith(suffix)
               and k[len(prefix):len(k) - len(suffix)].isdigit())


def sam2_from_jax(params: dict) -> dict[str, np.ndarray]:
    """JAX ``SAM2Model`` variables → the port's ``SAM2Model`` state dict:
    the SAM2Base tree under ``model.`` and the prompt predictor under
    ``prompt_predictor.``, as the JAX package exports a trained SAM2
    (``train/torch_export_sam2.py``). Layer counts come from the tree."""
    params = _params(params)
    params = params.get("sam", params)
    out = {f"model.image_encoder.{k}": v
           for k, v in sam2_encoder_from_jax(params["image_encoder"]).items()}

    pe, penc = "model.sam_prompt_encoder", params["prompt_encoder"]
    out[f"{pe}.pe_layer.positional_encoding_gaussian_matrix"] = _np(penc["pe_gaussian"])
    for i in range(4):
        out[f"{pe}.point_embeddings.{i}.weight"] = _np(penc["point_embeddings"])[i][None]
    out[f"{pe}.not_a_point_embed.weight"] = _np(penc["not_a_point_embed"])[None]
    out[f"{pe}.no_mask_embed.weight"] = _np(penc["no_mask_embed"])[None]
    for idx, key in ((0, "mask_down0"), (3, "mask_down1"), (6, "mask_down2")):
        _conv2(out, f"{pe}.mask_downscaling.{idx}", penc[key])
    for idx, key in ((1, "mask_ln0"), (4, "mask_ln1")):
        _ln2(out, f"{pe}.mask_downscaling.{idx}", penc[key])

    md, dec = "model.sam_mask_decoder", params["mask_decoder"]
    for name in ("iou_token", "mask_tokens", "obj_score_token"):
        out[f"{md}.{name}.weight"] = _np(dec[name])
    for idx, key in ((0, "upscale1"), (3, "upscale2")):  # flax (kh, kw, in, out), unflipped
        out[f"{md}.output_upscaling.{idx}.weight"] = np.ascontiguousarray(
            _np(dec[key]["kernel"]).transpose(2, 3, 0, 1))
        out[f"{md}.output_upscaling.{idx}.bias"] = _np(dec[key]["bias"])
    _ln2(out, f"{md}.output_upscaling.1", dec["upscale_ln"])
    _conv2(out, f"{md}.conv_s0", dec["conv_s0"])
    _conv2(out, f"{md}.conv_s1", dec["conv_s1"])
    for i in range(_count(dec, "hyper")):
        for j in range(_count(dec[f"hyper{i}"], "layer")):
            _dense2(out, f"{md}.output_hypernetworks_mlps.{i}.layers.{j}", dec[f"hyper{i}"][f"layer{j}"])
    for head, key in (("iou_prediction_head", "iou_head"), ("pred_obj_score_head", "obj_score_head")):
        for j in range(_count(dec[key], "layer")):
            _dense2(out, f"{md}.{head}.layers.{j}", dec[key][f"layer{j}"])
    tp = f"{md}.transformer"
    for i in range(_count(dec, "layer")):
        layer, lp = dec[f"layer{i}"], f"{tp}.layers.{i}"
        for name in ("self_attn", "cross_attn_token_to_image", "cross_attn_image_to_token"):
            _attention(out, f"{lp}.{name}", layer[name])
        for n in ("norm1", "norm2", "norm3", "norm4"):
            _ln2(out, f"{lp}.{n}", layer[n])
        _dense2(out, f"{lp}.mlp.layers.0", layer["mlp"]["lin1"])
        _dense2(out, f"{lp}.mlp.layers.1", layer["mlp"]["lin2"])
    _attention(out, f"{tp}.final_attn_token_to_image", dec["final_attn_token_to_image"])
    _ln2(out, f"{tp}.norm_final_attn", dec["norm_final"])

    me, menc = "model.memory_encoder", params["memory_encoder"]
    _conv2(out, f"{me}.pix_feat_proj", menc["pix_proj"])
    _conv2(out, f"{me}.out_proj", menc["out_proj"])
    _conv2(out, f"{me}.mask_downsampler.encoder.12", menc["mask_down_final"])
    for i in range(4):
        _conv2(out, f"{me}.mask_downsampler.encoder.{3 * i}", menc[f"mask_down{i}"])
        _ln2(out, f"{me}.mask_downsampler.encoder.{3 * i + 1}", menc[f"mask_ln{i}"])
    for i in range(2):
        fp = f"{me}.fuser.layers.{i}"
        _conv2(out, f"{fp}.dwconv", menc[f"fuser_dw{i}"])
        _ln2(out, f"{fp}.norm", menc[f"fuser_ln{i}"])
        _dense2(out, f"{fp}.pwconv1", menc[f"fuser_fc1_{i}"])
        _dense2(out, f"{fp}.pwconv2", menc[f"fuser_fc2_{i}"])
        out[f"{fp}.gamma"] = _np(menc[f"fuser_gamma{i}"])

    ma, mattn = "model.memory_attention", params["memory_attention"]
    _ln2(out, f"{ma}.norm", mattn["norm_out"])
    for i in range(_count(mattn, "layer")):
        layer, lp = mattn[f"layer{i}"], f"{ma}.layers.{i}"
        for key, name in (("self_q", "self_attn.q_proj"), ("self_k", "self_attn.k_proj"),
                          ("self_v", "self_attn.v_proj"), ("self_out", "self_attn.out_proj"),
                          ("cross_q", "cross_attn_image.q_proj"),
                          ("cross_k", "cross_attn_image.k_proj"),
                          ("cross_v", "cross_attn_image.v_proj"),
                          ("cross_out", "cross_attn_image.out_proj"),
                          ("mlp_fc1", "linear1"), ("mlp_fc2", "linear2")):
            _dense2(out, f"{lp}.{name}", layer[key])
        for n in ("norm1", "norm2", "norm3"):
            _ln2(out, f"{lp}.{n}", layer[n])

    out["model.no_mem_embed"] = _np(params["no_mem_embed"])
    out["model.no_mem_pos_enc"] = _np(params["no_mem_pos_enc"])
    tpos = _np(params["maskmem_tpos_enc"])
    out["model.maskmem_tpos_enc"] = tpos.reshape(tpos.shape[0], 1, 1, -1)
    _dense2(out, "model.obj_ptr_proj", params["obj_ptr_proj"])
    if "obj_ptr_tpos_proj" in params:
        _dense2(out, "model.obj_ptr_tpos_proj", params["obj_ptr_tpos_proj"])
    out["model.no_obj_ptr"] = _np(params["no_obj_ptr"]).reshape(1, -1)

    if "prompt_predictor" not in params:  # a converted published checkpoint has none
        return out
    pd, pp = "prompt_predictor", params["prompt_predictor"]

    def conv3(prefix: str, tree: dict) -> None:
        out[f"{prefix}.weight"] = _conv_w(tree["kernel"])
        if "bias" in tree:
            out[f"{prefix}.bias"] = _np(tree["bias"])

    conv3(f"{pd}.init_conv.layers.0.conv", pp["in0"]["Conv_0"])
    conv3(f"{pd}.init_conv.layers.1.conv", pp["in1"]["Conv_0"])
    depth = _count(pp, "down", "_0")
    for i in range(depth):
        conv3(f"{pd}.down_layers.{i}.layers.1.conv", pp[f"down{i}_0"]["Conv_0"])
        conv3(f"{pd}.down_layers.{i}.layers.2.conv", pp[f"down{i}_1"]["Conv_0"])
    for j, i in enumerate(reversed(range(depth))):  # up_layers count from the bottom
        conv3(f"{pd}.up_layers.{j}.layers.0.conv", pp[f"up{i}_0"]["Conv_0"])
        conv3(f"{pd}.up_layers.{j}.layers.1.conv", pp[f"up{i}_1"]["Conv_0"])
    conv3(f"{pd}.prompt_out", pp["prompt_out"])
    _dense2(out, f"{pd}.box_out.fc", pp["box_out"])
    return out


_LORA_PROJ = (".self_attn.", ".cross_attn_token_to_image.", ".cross_attn_image_to_token.",
              ".final_attn_token_to_image.")


def sam2_from_published(state_dict: dict[str, Any]) -> dict[str, np.ndarray]:
    """A published sam2 checkpoint's ``model`` dict (``sam2.1_hiera_large.pt``,
    ``MedSAM2_latest.pt``) → port ``SAM2Model`` names: every tensor under
    ``model.``, the decoder's q/v projections moved under ``.proj`` (where
    the LoRA wrapper keeps its base). The result is partial: the LoRA
    factors and the prompt predictor are not in a published checkpoint.
    Tensors the port has no place for (sam2 options the reference's config
    leaves off) are left for the caller to report."""
    out = {}
    for k, v in state_dict.items():
        name = f"model.{k}"
        if (k.startswith("sam_mask_decoder.transformer.")
                and any(p in k for p in _LORA_PROJ)
                and (".q_proj." in k or ".v_proj." in k)):
            head, leaf = name.rsplit(".", 1)
            name = f"{head}.proj.{leaf}"
        out[name] = _np(v)
    return out
