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
- :func:`sam2_encoder_from_jax`: the JAX SAM2 ``ImageEncoder`` params → port
  state dict (the published sam2 names without ``image_encoder.``).
- :func:`sam2_encoder_from_published`: a published sam2 checkpoint's
  ``model`` dict (e.g. ``sam2.1_hiera_large.pt``) → port state dict.

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


def cryovit_from_jax(params: dict) -> dict[str, np.ndarray]:
    """JAX ``CryoVITModule`` params → reference CryoVIT state dict."""
    params = _params(params)
    out: dict[str, np.ndarray] = {}

    def emit(prefix: str, tree: dict, weight) -> None:
        out[f"{prefix}.weight"] = weight(tree)
        out[f"{prefix}.bias"] = _np(tree["bias"])

    conv = lambda t: _conv_w(t["kernel"])  # noqa: E731
    convt = lambda t: _convt_w(t["kernel"])  # noqa: E731
    norm = lambda t: _np(t["scale"])  # noqa: E731
    emit("layers.0", params["Conv_0"], conv)
    for i in range(4):
        block = params[f"SynthesisBlock_{i}"]
        base = f"layers.{2 + i}.layers"
        emit(f"{base}.0", block["GroupNorm_0"], norm)
        emit(f"{base}.1", block["Conv_0"], conv)
        emit(f"{base}.3", block["Conv_1"], conv)
        emit(f"{base}.5", block["ConvTranspose_0"], convt)
    emit("output_layer.0", params["Conv_1"], conv)
    emit("output_layer.2", params["Conv_2"], conv)
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
