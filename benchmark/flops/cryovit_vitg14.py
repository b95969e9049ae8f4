"""Operations and kernel launches of DINOv2 ViT-g/14 (registers) and the
CryoVIT decoder, from the configuration's widths and the traffic's shapes.

Model FLOPs count the matrix products (2 per multiply-add): the patch
embed, the blocks' projections and attention, and the decoder's convs and
projection. Norms, activations and the 14/16 resize are not counted, and
nothing is counted twice: a train step is forward, input gradient and
weight gradient, except the decoder's projection, whose input (the
features) takes no gradient.

The launches are those of the port's kernels: the paired-heads attention
once per block and batch; the decoder's depth-major tail (blocks 2-3 and
the head, ``cryovit_tpu_torch/models/cryovit.py``) on the conv kernels,
whose input gradient is the same conv kernel with the weights swapped.
"""

from __future__ import annotations

from flops import kernels as K

DEPTH_MAJOR_FROM = 2  # the port runs blocks 2-3 and the head on its kernels


def tokens(cfg: dict, grid: int) -> int:
    """cls + registers + the patch grid."""
    return 1 + cfg["num_register_tokens"] + grid * grid


def backbone_flops_per_slice(cfg: dict, grid: int) -> float:
    c, f, n = cfg["embed_dim"], cfg["ffn_hidden"], tokens(cfg, grid)
    p = cfg["patch_size"]
    block = (2.0 * n * c * 3 * c + 4.0 * n * n * c + 2.0 * n * c * c
             + 2.0 * n * c * 2 * f + 2.0 * n * f * c)
    return cfg["depth"] * block + 2.0 * grid * grid * p * p * cfg["in_chans"] * c


def _decoder_layers(cfg: dict, depth: int, grid: int):
    """(kind, ci, co, voxels, depth_major, needs_dx) for every product of the
    decoder: ``voxels`` are output voxels, or input voxels for ``convt``."""
    dec = cfg["decoder"]
    c = dec["proj_channels"]
    hw = grid
    out = [("proj", cfg["embed_dim"], c, depth * hw * hw, False, False)]
    for i, (c2, c3, _d1, _d2) in enumerate(dec["blocks"]):
        v = depth * hw * hw
        dm = i >= DEPTH_MAJOR_FROM
        out += [("conv", c, c2, v, dm, True), ("conv", c2, c2, v, dm, True),
                ("convt", c2, c3, v, dm, True)]
        hw *= 2
        c = c3
    v = depth * hw * hw
    head = dec["head_channels"]
    out += [("conv", c, head, v, True, True), ("conv", head, 1, v, True, True)]
    return out


def _layer_flops(kind: str, ci: int, co: int, voxels: int) -> float:
    if kind == "conv":
        return K.conv_flops(voxels, ci, co, 27)
    if kind == "convt":
        return K.conv_flops(4 * voxels, ci, co, 1)
    return K.conv_flops(voxels, ci, co, 1)


def decoder_flops(cfg: dict, depth: int, grid: int, train: bool = False) -> float:
    total = 0.0
    for kind, ci, co, v, _dm, needs_dx in _decoder_layers(cfg, depth, grid):
        fwd = _layer_flops(kind, ci, co, v)
        total += fwd * ((3 if needs_dx else 2) if train else 1)
    return total


def decoder_launches(cfg: dict, depth: int, grid: int, train: bool):
    """(counter name, flops, bytes) of every kernel launch of one decoder
    pass (forward, and with ``train`` the backward)."""
    out = []
    for kind, ci, co, v, dm, _ in _decoder_layers(cfg, depth, grid):
        if not dm:
            continue
        if kind == "conv":
            out.append(("conv3d_dm", *K.conv3d_dm(v, ci, co)))
            if train:
                out.append(("conv3d_dm", *K.conv3d_dm(v, co, ci)))
                out.append(("conv3d_dm_dw", *K.conv3d_dm_dw(v, ci, co)))
        else:
            out.append(("convt2x_dm", *K.convt2x_dm(v, ci, co)))
            if train:
                out.append(("convt2x_dm_bwd", *K.convt2x_dm_bwd(v, ci, co)))
    return out


GROUPS = {  # counter name -> the roofline group it belongs to
    "flash_attention": "flash_attention",
    "conv3d_dm": "conv_dm", "conv3d_dm_dw": "conv_dm",
    "convt2x_dm": "conv_dm", "convt2x_dm_bwd": "conv_dm",
}


def _work(model_flops: float, launches) -> dict:
    bounds: dict[str, float] = {}
    counts: dict[str, int] = {}
    for name, flops, nbytes in launches:
        group = GROUPS[name]
        bounds[group] = bounds.get(group, 0.0) + K.bound_s(flops, nbytes)
        counts[name] = counts.get(name, 0) + 1
    return {"model_flops": model_flops, "bounds_s": bounds, "launches": counts}


def infer_work(cfg: dict, depths: list[int], side: int, slice_batch: int) -> dict:
    """Fused inference over tomograms of ``depths`` slices of ``side``²
    voxels (a 16-voxel patch per DINO token), the backbone in batches of
    ``slice_batch`` slices."""
    grid = side // 16
    n, heads = tokens(cfg, grid), cfg["num_heads"]
    head_dim = cfg["embed_dim"] // heads
    flops = 0.0
    launches = []
    for d in depths:
        flops += d * backbone_flops_per_slice(cfg, grid) + decoder_flops(cfg, d, grid)
        batches = [slice_batch] * (d // slice_batch) + ([d % slice_batch] if d % slice_batch else [])
        for b in batches:
            launches += [("flash_attention", *K.flash_attention(b, n, heads, head_dim))] * cfg["depth"]
        launches += decoder_launches(cfg, d, grid, train=False)
    return _work(flops, launches)


def train_work(cfg: dict, depth: int, side: int, steps: int) -> dict:
    """``steps`` decoder train steps on a crop of ``depth`` × ``side``²
    voxels (features on the ``side/16`` patch grid)."""
    grid = side // 16
    flops = steps * decoder_flops(cfg, depth, grid, train=True)
    return _work(flops, decoder_launches(cfg, depth, grid, train=True) * steps)
