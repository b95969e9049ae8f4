"""SAME 3×3×3 convolution on depth-major activations (the decoder tail).

Counterpart of ``cryovit_tpu/ops/conv3d_dm.py:conv3d_dm``: x is
``(B, D, Ci, H, W)``, the kernel is in the flax ``(3, 3, 3, Ci, Co)`` tap
order, dilation acts on depth only, out-of-range taps count as zero, sums
accumulate in f32 and the output ``(B, D, Co, H, W)`` has x's dtype.

- :func:`conv3d_dm` is the wrapper: a CPU tensor takes the plain version, a
  CUDA tensor launches the Hopper kernel (``csrc/conv3d_dm.cu``, a bf16
  tensor-core implicit GEMM) or raises. Unlike the TPU kernel it takes any W
  (no ``W % 128`` gate); it takes Ci in :data:`KERNEL_CIN`.
- :func:`conv3d_dm_reference` is the plain PyTorch version (``F.conv3d`` on a
  permuted view, in f32).
- :func:`pack_weights` lays the kernel's weights out as the kernel's mma B
  fragments (a gather of a few KB).

Its weight gradient, counterpart of ``conv3d_dm_dw`` (all 27 taps from one
pass over x and the cotangent g, f32 ``(3, 3, 3, Ci, Co)``):

- :func:`conv3d_dm_dw` is the wrapper (``csrc/conv3d_dm_dw.cu`` on a GPU);
- :func:`conv3d_dm_dw_reference` is the plain version: 27 shifted-window
  contractions in f32.

The input gradient needs no kernel of its own: it is :func:`conv3d_dm` with
the tap-flipped, in/out-swapped kernel (``models/cryovit.py``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from cryovit_tpu_torch import kernels

__all__ = [
    "KERNEL_CIN",
    "KERNEL_COUT",
    "conv3d_dm",
    "conv3d_dm_dw",
    "conv3d_dm_dw_reference",
    "conv3d_dm_reference",
    "pack_weights",
]

KERNEL_COUT = (1, 8, 16, 32)  # output widths the CUDA kernels are built for
KERNEL_CIN = (1, 8, 16, 24, 32)  # input widths the forward kernel is built for


def _check_activation(t: torch.Tensor, name: str) -> None:
    if t.dim() != 5 or t.dtype != torch.bfloat16 or not t.is_contiguous():
        raise ValueError(
            f"{name} kernel takes contiguous bf16 (B, D, C, H, W); got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def _depth_dilation(dilation, name: str) -> int:
    dd, dh, dw = (int(s) for s in dilation)
    if (dh, dw) != (1, 1) or dd < 1:
        raise ValueError(f"{name} dilates depth only, got {(dd, dh, dw)}")
    return dd


def conv3d_dm_reference(
    x: torch.Tensor, kernel: torch.Tensor, dilation=(1, 1, 1)
) -> torch.Tensor:
    """Plain SAME k=3³ conv on depth-major ``(B, D, Ci, H, W)``, f32 sums."""
    dilation = tuple(int(s) for s in dilation)
    xt = x.permute(0, 2, 1, 3, 4).float()  # (B, Ci, D, H, W)
    wt = kernel.permute(4, 3, 0, 1, 2).float()  # (Co, Ci, kd, kh, kw)
    y = F.conv3d(xt, wt, padding=dilation, dilation=dilation)
    return y.permute(0, 2, 1, 3, 4).to(x.dtype).contiguous()


@functools.lru_cache(maxsize=None)
def _pack_index(ci: int, co: int, device: torch.device) -> torch.Tensor:
    """For each element of :func:`pack_weights`' result, its flat index into
    the ``(3, 3, 3, Ci, Co)`` kernel, or ``27·Ci·Co`` for a zero; kept on
    ``device``, so a call copies nothing from the host."""
    zero = 27 * ci * co
    nt = -(-co // 8)
    idx = torch.arange(zero).reshape(3, 3, 3, ci, co)
    idx = F.pad(idx, (0, 8 * nt - co), value=zero)  # Co padded to n-tiles of 8
    if ci == 1:
        # one column group per depth tap; k = the 9 lateral taps kh·3 + kw, 7 zeros
        idx = F.pad(idx.reshape(3, 1, 9, 8 * nt), (0, 0, 0, 7), value=zero)
    elif ci == 8:
        # column groups are pairs of (kd, kw) (9 and a zero one); k = the
        # pair's first 8 channels, then its second's
        idx = idx.permute(0, 2, 1, 3, 4).reshape(9, 3, 8, 8 * nt)  # ((kd, kw), kh, ci, co)
        idx = F.pad(idx, (0, 0, 0, 0, 0, 0, 0, 1), value=zero)
        idx = idx.reshape(5, 2, 3, 8, 8 * nt).transpose(1, 2).reshape(5, 3, 16, 8 * nt)
    else:
        # column groups (kd, kw, 16 channels); Ci = 24 padded to 32
        cip = 16 if ci == 16 else 32
        idx = F.pad(idx, (0, 0, 0, cip - ci), value=zero)
        ks = cip // 16
        idx = idx.reshape(3, 3, 3, ks, 16, 8 * nt).permute(0, 2, 3, 1, 4, 5)
        idx = idx.reshape(9 * ks, 3, 16, 8 * nt)  # ((kd, kw, k16 step), kh, k, co)
    cg, kh = idx.shape[:2]
    # B fragment of mma m16n8k16 (col-major 16x8): lane g·4 + q holds
    # B[2q, g], B[2q + 1, g] in one register and B[2q + 8, g], B[2q + 9, g]
    # in the other; k = w·8 + 2q + h
    idx = idx.reshape(cg, kh, 2, 4, 2, nt, 8).permute(0, 1, 5, 6, 3, 2, 4)
    return idx.reshape(-1).to(device)


def pack_weights(kernel: torch.Tensor) -> torch.Tensor:
    """The ``(3, 3, 3, Ci, Co)`` kernel as the CUDA kernel's mma B fragments:
    ``(column groups, kh taps, n-tiles, 32 lanes, 4)``, flat, in the kernel's
    dtype. A column group is (kd, kw, 16 input channels) for Ci of 16 or
    more, a pair of (kd, kw) of 8 channels each for Ci = 8, and a depth tap
    (its 9 lateral taps as k) for Ci = 1; each group's k16 × 8 fragment
    holds the weights of kh = 0, 1, 2 (just one for Ci = 1)."""
    idx = _pack_index(kernel.shape[3], kernel.shape[4], kernel.device)
    return F.pad(kernel.reshape(-1), (0, 1))[idx]


def conv3d_dm(
    x: torch.Tensor, kernel: torch.Tensor, dilation=(1, 1, 1)
) -> torch.Tensor:
    """The conv as :func:`conv3d_dm_reference` computes it.

    On a CUDA device the Hopper kernel runs: contiguous bf16 x with Ci in
    :data:`KERNEL_CIN`, a bf16 ``(3, 3, 3, Ci, Co)`` kernel with Co in
    :data:`KERNEL_COUT`, dilation ``(d, 1, 1)``. Anything else raises; it
    never falls back. Each output voxel is summed in one fixed order, so the
    result does not change from run to run.
    """
    if x.device.type == "cpu":
        return conv3d_dm_reference(x, kernel, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"no conv3d_dm kernel for device {x.device}")
    dd = _depth_dilation(dilation, "conv3d_dm")
    _check_activation(x, "conv3d_dm")
    b, d, ci, h, w = x.shape
    if tuple(kernel.shape[:4]) != (3, 3, 3, ci) or kernel.dim() != 5:
        raise ValueError(f"kernel {tuple(kernel.shape)} is not (3, 3, 3, {ci}, Co)")
    if kernel.dtype != torch.bfloat16:
        raise ValueError(f"conv3d_dm kernel takes bf16 weights, got {kernel.dtype}")
    if ci not in KERNEL_CIN:
        raise ValueError(
            f"conv3d_dm kernel supports Ci in {KERNEL_CIN} (1 or a multiple of 8 up to "
            f"32), got {ci}"
        )
    co = kernel.shape[4]
    if co not in KERNEL_COUT:
        raise ValueError(f"conv3d_dm kernel supports Co in {KERNEL_COUT}, got {co}")
    if kernel.device != x.device:
        raise ValueError(f"kernel is on {kernel.device}, x on {x.device}")
    lib = kernels.load_library()
    # one persistent block per SM, as its 87-231 KB of shared memory allow;
    # the kernel launches no more blocks than it has work units
    nblocks = torch.cuda.get_device_properties(x.device).multi_processor_count
    wpk = pack_weights(kernel)
    y = torch.empty((b, d, co, h, w), dtype=x.dtype, device=x.device)
    rc = lib.cryovit_conv3d_dm(
        x.data_ptr(), wpk.data_ptr(), y.data_ptr(), b, d, ci, co, h, w, dd, nblocks,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check(rc, "conv3d_dm")
    kernels.count_launch("conv3d_dm")
    return y


def conv3d_dm_dw_reference(
    x: torch.Tensor, g: torch.Tensor, dilation=(1, 1, 1)
) -> torch.Tensor:
    """Plain weight gradient of :func:`conv3d_dm_reference`: for each of the
    27 taps, the shifted window of the zero-padded x contracted with g over
    (B, D, H, W), in f32. Returns ``(3, 3, 3, Ci, Co)`` f32."""
    dd = int(dilation[0])
    _, d, _, h, w = x.shape
    xp = F.pad(x.float(), (1, 1, 1, 1, 0, 0, dd, dd))  # pads W, H, (not C), D
    gf = g.float()
    taps = [
        torch.einsum(
            "bdihw,bdohw->io", xp[:, kd * dd : kd * dd + d, :, kh : kh + h, kw : kw + w], gf
        )
        for kd in range(3)
        for kh in range(3)
        for kw in range(3)
    ]
    return torch.stack(taps).reshape(3, 3, 3, x.shape[2], g.shape[2])


def conv3d_dm_dw(
    x: torch.Tensor, g: torch.Tensor, dilation=(1, 1, 1)
) -> torch.Tensor:
    """The weight gradient as :func:`conv3d_dm_dw_reference` computes it.

    On a CUDA device the Hopper kernel runs: contiguous bf16 x
    ``(B, D, Ci, H, W)`` and g ``(B, D, Co, H, W)`` with Co in
    :data:`KERNEL_COUT`, dilation ``(d, 1, 1)``. Anything else raises; it
    never falls back. Sums run in a fixed order, so the result does not
    change from run to run.
    """
    if x.device.type == "cpu":
        return conv3d_dm_dw_reference(x, g, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"no conv3d_dm_dw kernel for device {x.device}")
    dd = _depth_dilation(dilation, "conv3d_dm_dw")
    _check_activation(x, "conv3d_dm_dw")
    _check_activation(g, "conv3d_dm_dw")
    b, d, ci, h, w = x.shape
    co = g.shape[2]
    if (g.shape[0], g.shape[1], g.shape[3], g.shape[4]) != (b, d, h, w):
        raise ValueError(f"g {tuple(g.shape)} does not match x {tuple(x.shape)}")
    if co not in KERNEL_COUT:
        raise ValueError(f"conv3d_dm_dw kernel supports Co in {KERNEL_COUT}, got {co}")
    if g.device != x.device:
        raise ValueError(f"g is on {g.device}, x on {x.device}")
    lib = kernels.load_library()
    # at most the kernel's work units: (b, depth residue mod dd, segment of
    # up to 32 planes of that residue's chain, 64-wide tile of 4, 8 or 16
    # rows); one block per SM, as its 160-224 KB of shared memory allow
    chain = -(-d // dd)
    n_units = b * min(dd, d) * -(-chain // 32) * -(-h // 4) * -(-w // 64)
    nblocks = kernels.grid_blocks(x.device, n_units, per_sm=1)
    partial = torch.empty(nblocks * 27 * ci * co, dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, 3, ci, co), dtype=torch.float32, device=x.device)
    rc = lib.cryovit_conv3d_dm_dw(
        x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(), b, d, ci, co, h, w,
        dd, nblocks, torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check(rc, "conv3d_dm_dw")
    kernels.count_launch("conv3d_dm_dw")
    return dw
