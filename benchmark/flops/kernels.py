"""Operations and bytes of one launch of each hand-written kernel, from its
shapes: each input read once and each output written once, at the real
sizes (no padding). Activations and weights are bf16 (2 bytes); the weight
gradients the kernels reduce are written in f32 (4 bytes).

The least time a launch could take is :func:`bound_s`: the larger of the
operations over the bf16 tensor-core peak and the bytes over the memory
rate (``harness/peaks.py``).
"""

from __future__ import annotations

BF16 = 2
F32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    from harness.peaks import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S

    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def flash_attention(batch: int, tokens: int, heads: int, head_dim: int) -> tuple[float, float]:
    """Softmax attention over all tokens: QKᵀ and PV (4·B·H·N²·d), reading
    q, k, v and the (3, C) biases and writing the output."""
    c = heads * head_dim
    flops = 4.0 * batch * heads * tokens * tokens * head_dim
    nbytes = BF16 * (4.0 * batch * tokens * c + 3 * c)
    return flops, nbytes


def conv3d_dm(voxels: int, ci: int, co: int) -> tuple[float, float]:
    """A SAME 3³ conv over ``voxels`` output voxels (B·D·H·W): x and the
    27·Ci·Co weights in, y out."""
    flops = 2.0 * 27 * ci * co * voxels
    nbytes = BF16 * (voxels * (ci + co) + 27.0 * ci * co)
    return flops, nbytes


def conv3d_dm_dw(voxels: int, ci: int, co: int) -> tuple[float, float]:
    """The weight gradient of :func:`conv3d_dm`: x and g in, the f32
    27·Ci·Co gradient out."""
    flops = 2.0 * 27 * ci * co * voxels
    nbytes = BF16 * voxels * (ci + co) + F32 * 27.0 * ci * co
    return flops, nbytes


def convt2x_dm(in_voxels: int, ci: int, co: int) -> tuple[float, float]:
    """The 2× lateral ConvTranspose: each of ``in_voxels`` input voxels
    writes 4 output voxels; x and the 4·Ci·Co weights in, y out."""
    flops = 2.0 * 4 * ci * co * in_voxels
    nbytes = BF16 * (in_voxels * (ci + 4.0 * co) + 4.0 * ci * co)
    return flops, nbytes


def convt2x_dm_bwd(in_voxels: int, ci: int, co: int) -> tuple[float, float]:
    """Both gradients of :func:`convt2x_dm` in one launch: g, x and the
    weights in, dx (bf16) and the f32 4·Ci·Co weight gradient out."""
    flops = 2.0 * 2 * 4 * ci * co * in_voxels
    nbytes = (BF16 * (in_voxels * (4.0 * co + ci + ci) + 4.0 * ci * co)
              + F32 * 4.0 * ci * co)
    return flops, nbytes


def conv_flops(out_voxels: int, ci: int, co: int, taps: int) -> float:
    """Multiply-adds ×2 of a conv (or a 1×1 projection, ``taps`` = 1) over
    ``out_voxels`` output voxels; a k2 stride-2 ConvTranspose is ``taps`` = 1
    over its output voxels (each output voxel takes one tap)."""
    return 2.0 * taps * ci * co * out_voxels
