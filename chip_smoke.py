"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device  — a CUDA device is required (there is no CPU path); prints the
   card's name and power limit from nvidia-smi.
2. build   — builds the hand-written kernels from ``cryovit_tpu_torch/csrc``
   (one nvcc per source, started together).
3. kernels — each kernel against its plain PyTorch version, in bf16, at the
   shapes its main paths give it: the forward kernels at the serving path's
   shapes for a 64×512×512 tomogram (the head-major attention with q/k/v as
   permuted views of one projection and contiguous, its (B, N, H, D) twin,
   and the fused residual + LayerNorm for three dtype/LayerScale cases, at
   ViT-g's 64×1029 tokens); at the training crop's (128×512×512 labels) the
   backward kernels and conv3d_dm's twelve calls of a train step (forward,
   and input gradient with flipped, in/out-swapped taps); the three Hiera
   kernels at Hiera-L's stage-3 shapes for a batch of 64 slices at 512²,
   and the global attention again at Hiera-T's (4 heads of 96); the pair
   attention also at ViT-g's 16×4101 tokens (1024²);
   the int8 attention (``flash_attention(quant=...)``, each of qk, pv,
   qkpv) and its scale pre-pass at ViT-g's 64×1029 and 16×4101 tokens, on
   inputs with outliers (plain random inputs cannot tell int8 from bf16),
   held also by the RMS of each output row's relative error, whose limit
   must fall below the readings of planted faults in the plain version.
   Kernel, plain and library times from CUDA events, and the least time the
   card could take (``bound_ms``); TFLOP/s on every attention row. The JSON
   rows of conv3d_dm (its six serving calls, and under ``train_step`` its
   twelve train-step calls) and of conv3d_dm_dw (its six) list each call.
4. reference — the serving path on the GPU (bf16, kernels) against the same
   path on the CPU (f32, plain versions) on a small input, once for each
   DINOv2 configuration: the default, ``pair_heads=False`` and
   ``fused_ln=True``.
5. train reference — one train step of the full-width decoder on a small
   input, GPU bf16 through the kernels against CPU f32 through the plain
   versions: the probabilities, the Dice loss and every parameter's
   gradient.
6. SAM reference — the SAM2 image encoder on the GPU (bf16, kernels)
   against the CPU (f32, plain versions), seeded weights, a small config
   that opens both Hiera kernel gates, at head width 72 and again at 96:
   cosine and relative L2 error per FPN level.
7. serving main path — a synthetic 64×512×512 uint8 tomogram written as MRC;
   the full-width DINOv2 ViT-g/14 with seeded random weights and a seeded
   CryoVIT decoder saved as a ``.model``; fused inference (raw tomogram →
   masks) and feature extraction on it. Then the DINOv2 variants on the same
   weights (shared, not copied) and tomogram: extraction with
   ``pair_heads=False`` (exactly 40 ``flash_attention_bhnd`` launches) and
   with ``fused_ln=True`` (exactly 40 ``flash_attention`` and 80
   ``residual_layernorm``): features against the default path's, slices/s
   beside the default's, peak memory, and a profile of one 64-slice batch of
   each configuration. Last, the int8 attention's main path: the same
   weights with LayerScale 0.2 in ``DinoV2(pair_attention_fn=partial(
   flash_attention, quant=m))`` on 16 synthetic 1024² slices (4101 tokens),
   the bf16 default first and then each mode: exactly 40 int8 attention
   and 40 scale launches per mode (none under the default), finite
   features within relative L2 0.1 of the default's (a check of finiteness
   and layout: bf16-level differences move 40 blocks as far, so the kernel
   rows hold the int8 arithmetic), device ms, slices/s, peak memory.
8. training main path — a synthetic 128×512×512 tomogram of bright blobs on
   noise, its ViT-g/14 features and blob labels; ``Trainer.fit`` of the
   full-width decoder in bf16 for 8 epochs with SWA and validation through
   the port's FileDataModule, DataLoader and collate; the trained decoder
   saved as a ``.model`` and served by fused inference on the same
   tomogram. One isolated train step's launches, the step time (median of
   5) and a profile of one step.
9. SAM serving main path — SAM2 feature extraction (``cryovit-torch features
   --use-sam``'s extractor) on a synthetic 64×512×512 tomogram at Hiera-L
   full width, slice batch 64: the pyramids' shapes and values, each Hiera
   kernel's launches against the counts its gates give, slices/s with host
   I/O, peak memory and a profile of one batch. Then the same at Hiera-T
   full width (``SAM2Config.medsam_tiny()``, MedSAM's trunk: its three
   global blocks run the attention kernel at head width 96; exactly 0/0/3
   launches per batch), slices/s and peak memory, with the last stage's
   window 14 instead of 7 (``HIERA_T_LAST_WINDOW``: with 7 the q-pool
   block 10 fails in the JAX reference and the port alike).

Launch counters are zeroed just before each main path and read just after;
every kernel of a path must have run (the SAM path: exactly the counts the
Hiera gates give). The next-to-last line is the card's
name and power limit, the one before it a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

# f32 products in the plain versions and the CPU reference run in full f32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEPTH, SIDE = 64, 512  # the serving path's tomogram
SLICE_BATCH = 64
TRAIN_DEPTH = 128  # the reference training crop: 128 slices of 512² voxels
TRAIN_EPOCHS = 8
ATTN_SHAPE = (64, 1029, 24)  # (slices per chunk, tokens at 512², heads of 64)
# row 1 at 1024² (4101 tokens): slices per batch, tokens, heads, slices per
# plain call (its B·H·N² f32 scores)
ATTN_SHAPE_1024 = (16, 4101, 24, 2)
# (Ci, Co, H = W, depth dilation) of every conv3d_dm call for a 512² tomogram
CONV_SHAPES = [(32, 32, 128, 8), (32, 32, 128, 4), (32, 16, 256, 2), (16, 16, 256, 1),
               (8, 8, 512, 1), (8, 1, 512, 1)]
# (Ci, Co, H = W) of every convt2x_dm call
CONVT_SHAPES = [(32, 32, 128), (16, 8, 256)]
KERNELS = {
    "flash_attention": ("cryovit_tpu_torch/csrc/attention_sm90.cu",
                        "cryovit_tpu/ops/flash_attention.py:226"),
    "conv3d_dm": ("cryovit_tpu_torch/csrc/conv3d_dm.cu", "cryovit_tpu/ops/conv3d_dm.py:162"),
    "convt2x_dm": ("cryovit_tpu_torch/csrc/convt_dm.cu", "cryovit_tpu/ops/convt_dm.py:74"),
    "conv3d_dm_dw": ("cryovit_tpu_torch/csrc/conv3d_dm_dw.cu",
                     "cryovit_tpu/ops/conv3d_dm.py:272"),
    "convt2x_dm_bwd": ("cryovit_tpu_torch/csrc/convt_dm_bwd.cu",
                       "cryovit_tpu/ops/convt_dm.py:162"),
    "window_block_attention": ("cryovit_tpu_torch/csrc/window_block.cu",
                               "cryovit_tpu/ops/window_attention.py:112"),
    "window_block_mlp": ("cryovit_tpu_torch/csrc/window_block.cu",
                         "cryovit_tpu/ops/window_attention.py:226"),
    "window_attention": ("cryovit_tpu_torch/csrc/attention_sm90.cu",
                         "cryovit_tpu/ops/window_attention.py:311"),
    "flash_attention_bhnd": ("cryovit_tpu_torch/csrc/attention_sm90.cu",
                             "cryovit_tpu/ops/flash_attention.py:53"),
    "flash_attention_bnhd": ("cryovit_tpu_torch/csrc/attention_sm90.cu",
                             "cryovit_tpu/ops/flash_attention.py:53"),
    "residual_layernorm": ("cryovit_tpu_torch/csrc/fused_norm.cu",
                           "cryovit_tpu/ops/fused_norm.py:69"),
    "flash_attention_int8": ("cryovit_tpu_torch/csrc/flash_attention.cu",
                             "cryovit_tpu/ops/flash_attention.py:226"),
    "flash_attention_int8_scales": ("cryovit_tpu_torch/csrc/flash_attention.cu",
                                    "cryovit_tpu/ops/flash_attention.py:386"),
}
DINO_KERNELS = ("flash_attention", "conv3d_dm", "convt2x_dm", "conv3d_dm_dw", "convt2x_dm_bwd")
# one train step of the decoder: 6 tail convs forward and 6 input gradients
# through conv3d_dm, 6 weight gradients, 2 ConvTransposes each way
TRAIN_STEP_LAUNCHES = {**dict.fromkeys(KERNELS, 0), "conv3d_dm": 12, "convt2x_dm": 2,
                       "conv3d_dm_dw": 6, "convt2x_dm_bwd": 2}
# Hiera-L's stage 3 for a batch of 64 slices at 512²: 256 windows of 16×16
# tokens, 576 channels in 8 heads of 72, MLP 2304; and its global blocks,
# 64 images of 32×32 tokens
WINDOW_SHAPE = (256, 256, 576, 8, 2304)  # (windows, tokens, C, heads, hidden)
GLOBAL_SHAPE = (64, 1024, 8, 72)  # (batch, tokens, heads, head dim)
# Hiera-T's (SAM2Config.medsam_tiny()) global blocks 5, 7, 9 for a batch of
# 64 slices at 512²: 32×32 tokens, 384 channels in 4 heads of 96
GLOBAL_SHAPE_T = (64, 1024, 4, 96)
# per 64-slice batch at 512², from the gates over HieraConfig.large(): of the
# 36 stage-3 blocks, block 8 pools and 23, 33, 43 are global
SAM_BATCH_LAUNCHES = {"window_block_attention": 32, "window_block_mlp": 32, "window_attention": 3}
# the same for Hiera-T: its windows (64, 16, 196 tokens) open no block
# gate, its three global blocks the attention gate
SAM_T_BATCH_LAUNCHES = {"window_block_attention": 0, "window_block_mlp": 0, "window_attention": 3}
# Hiera-T's last-stage window in the SAM serving phase: 14, not its 7. With
# 7 the q-pool block 10 pools 7×7 windows to 3×3 and cannot reassemble them
# (the JAX reference raises there too, at any image size: ROADMAP.md C2);
# every block before it, the three global blocks among them, is Hiera-T's
HIERA_T_LAST_WINDOW = 14
# the DINOv2 variants: make_dinov2 options and their launches per block of
# one 64-slice batch (ViT-g: 40 blocks)
# LayerScale of the variants' agreement check: the seeded 1e-5 leaves every
# block's update below the bf16 stream's rounding, so a wrong block would not
# move the features; at this value the 40 blocks move them by far more than
# the agreement limit
AGREEMENT_LAYERSCALE = 0.2
DINO_VARIANTS = {
    "head-major (pair_heads=False)": ({"pair_heads": False}, {"flash_attention_bhnd": 1}),
    "fused LayerNorm (fused_ln=True)": ({"fused_ln": True},
                                        {"flash_attention": 1, "residual_layernorm": 2}),
}
# the int8 internals of the pair attention (flash_attention(quant=...)):
# the modes, and (slices per batch, tokens, heads of 64, slices per plain
# call) at ViT-g's 512² and 1024² slices; the plain version holds
# B·H·N² f32 scores and float64 probabilities, so it runs a few slices a call
INT8_MODES = ("qk", "pv", "qkpv")
INT8_ATTN_SHAPES = {"512^2": (64, 1029, 24, 16), "1024^2": (16, 4101, 24, 2)}
INT8_SIDE, INT8_BATCH = 1024, 16  # the DINOv2 int8-attention phase's slices
# relative L2 of the int8 modes' features from the bf16 default's at 1024²,
# LayerScale AGREEMENT_LAYERSCALE (stated in PERF.md before the first chip
# run); a check of finiteness and layout, not of the int8 arithmetic
INT8_AGREEMENT = 0.1
# The int8 kernel rows' second limit: the RMS over output rows (one head's
# 64 values of one token) of each row's relative L2 error. On the outlier
# inputs max|err| ≤ 2^-6·max|plain| is loose (the largest values are those
# of the few rows that attend to the ×16 value row), so every row counts
# alike here. Planted faults of the plain version must read above it.
INT8_ROW_RMS = 2.0**-7
# H100 SXM data-sheet peaks (dense bf16 and int8 tensor cores, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds per call from CUDA events, after two warm-up calls."""
    for _ in range(2):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def with_bound(row: dict, n_bytes: float, flops: float, int8_ops: float = 0.0) -> dict:
    """``row`` with the least time the card could take for the work:
    the larger of the bytes (each input read once, each output written
    once) over the memory rate and the operations' time on the tensor
    cores (``flops`` at the bf16 peak plus ``int8_ops`` at the int8 peak),
    and which of the two it is."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS) * 1e3
    return dict(row, bytes=n_bytes, flops=flops, int8_ops=int8_ops,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def row_rms(got: torch.Tensor, want: torch.Tensor, width: int) -> float:
    """Root mean square over rows of ``width`` values of each row's
    relative L2 error ``‖got − want‖ / ‖want‖``."""
    got, want = (t.float().reshape(-1, width) for t in (got, want))
    return ((got - want).norm(dim=1) / want.norm(dim=1)).square().mean().sqrt().item()


def compare(name, kernel_fn, plain_fn, library_fn, iters, rel_tols=(2.0**-6,), row_limit=None):
    """Kernel vs plain version on the same inputs, output by output: max
    |error| within ``rel_tol``·max|plain| (2^-6, four bf16 ulps of the
    largest value, for bf16 outputs); with ``row_limit`` (width, limit) also
    :func:`row_rms` of the one output within limit; then kernel, plain and
    library ms."""
    got, want = kernel_fn(), plain_fn()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    err, rows = 0.0, {}
    for g, w, tol in zip(got, want, rel_tols, strict=True):
        g, w = g.float(), w.float()
        e = (g - w).abs().max().item()
        limit = tol * w.abs().max().item()
        if not (e <= limit and torch.isfinite(g).all()):
            raise AssertionError(f"{name}: kernel vs plain max |err| {e} > tol {limit}")
        err = max(err, e)
        if row_limit is not None:
            width, rms_limit = row_limit
            rows = dict(row_rms=row_rms(g, w, width), max_abs_limit=limit)
            if not rows["row_rms"] <= rms_limit:
                raise AssertionError(f"{name}: kernel vs plain row RMS relative error "
                                     f"{rows['row_rms']} > {rms_limit}")
    del got, want
    k_ms, p_ms = time_ms(kernel_fn, iters), time_ms(plain_fn, max(1, iters // 4))
    lib_ms = time_ms(library_fn, iters) if library_fn is not None else None
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, **rows)


def _accumulate(total: dict | None, row: dict) -> dict:
    """Sum of the rows of one kernel's shapes (one pass of its path): times,
    bytes and operations add, the bound is that of the summed work, the
    error is the largest."""
    if total is None:
        return row
    summed = {k: total[k] + row[k] for k in ("ms", "plain_ms", "library_ms")}
    summed["max_abs_err"] = max(total["max_abs_err"], row["max_abs_err"])
    return with_bound(summed, total["bytes"] + row["bytes"], total["flops"] + row["flops"],
                      total["int8_ops"] + row["int8_ops"])


def kernel_phase(dev: torch.device) -> dict[str, dict]:
    from cryovit_tpu_torch.ops import conv3d_dm as cd
    from cryovit_tpu_torch.ops import convt_dm as ct
    from cryovit_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf)

    def cf(t):  # depth-major (B, D, C, H, W) → channels-first for cuDNN
        return t.transpose(1, 2).contiguous()

    results = {}
    b, n, h = ATTN_SHAPE
    c = h * fa.HEAD_DIM
    qkv = randn(b, n, 3 * c)  # q, k, v as column views, as the model passes them
    q, k, v = qkv[..., :c], qkv[..., c : 2 * c], qkv[..., 2 * c :]
    bias = randn(3, c, scale=0.5)
    qh, kh, vh = ((t + bias[i]).view(b, n, h, fa.HEAD_DIM).transpose(1, 2).contiguous()
                  for i, t in enumerate((q, k, v)))
    row = compare(
        "flash_attention",
        lambda: fa.flash_attention(q, k, v, bias, h),
        lambda: fa.flash_attention_reference(q, k, v, bias, h),
        lambda: F.scaled_dot_product_attention(qh, kh, vh),
        iters=10,
    )
    flops = 4 * b * h * n * n * fa.HEAD_DIM
    row = with_bound(row, 2 * (4 * b * n * c + 3 * c), flops)
    log("kernels", f"flash_attention B={b} N={n} H={h}x64: max|err| {row['max_abs_err']:.3g}, "
        f"kernel {row['ms']:.3f} ms ({flops / row['ms'] / 1e9:.1f} TFLOP/s), plain "
        f"{row['plain_ms']:.3f} ms, library {row['library_ms']:.3f} ms "
        f"(scaled_dot_product_attention, (B, H, N, 64) bf16), bound {row['bound_ms']:.3f} ms "
        f"({row['bound_by']})")
    results["flash_attention"] = row
    del qkv, q, k, v, qh, kh, vh

    # the same kernel at 1024² (the DINOv2 int8 phase's bf16 default); the
    # plain version a few slices a call
    b, n, h, per_call = ATTN_SHAPE_1024
    c = h * fa.HEAD_DIM
    qkv = randn(b, n, 3 * c)
    q, k, v = qkv[..., :c], qkv[..., c : 2 * c], qkv[..., 2 * c :]
    bias = randn(3, c, scale=0.5)
    qh, kh, vh = ((t + bias[i]).view(b, n, h, fa.HEAD_DIM).transpose(1, 2).contiguous()
                  for i, t in enumerate((q, k, v)))
    row = compare(
        "flash_attention",
        lambda: fa.flash_attention(q, k, v, bias, h),
        lambda: torch.cat([fa.flash_attention_reference(q[i : i + per_call], k[i : i + per_call],
                                                        v[i : i + per_call], bias, h)
                           for i in range(0, b, per_call)]),
        lambda: F.scaled_dot_product_attention(qh, kh, vh),
        iters=5,
    )
    flops = 4 * b * h * n * n * fa.HEAD_DIM
    row = with_bound(row, 2 * (4 * b * n * c + 3 * c), flops)
    log("kernels", f"flash_attention B={b} N={n} H={h}x64: max|err| {row['max_abs_err']:.3g}, "
        f"kernel {row['ms']:.3f} ms ({flops / row['ms'] / 1e9:.1f} TFLOP/s), plain "
        f"{row['plain_ms']:.3f} ms ({per_call} slices a call), library {row['library_ms']:.3f} "
        f"ms (scaled_dot_product_attention, {flops / row['library_ms'] / 1e9:.1f} TFLOP/s), "
        f"bound {row['bound_ms']:.3f} ms ({row['bound_by']})")
    results["flash_attention 1024^2"] = row
    results["flash_attention"]["max_abs_err"] = max(results["flash_attention"]["max_abs_err"],
                                                    row["max_abs_err"])
    del qkv, q, k, v, qh, kh, vh

    def conv_flops(ci, co, side, dil, depth):
        # depth taps whose plane is in range: depth + 2·max(depth − dil, 0)
        return 2 * 9 * ci * co * side * side * (depth + 2 * max(depth - dil, 0))

    def conv_row(x, w, dil, what):
        """conv3d_dm against its plain version and F.conv3d on x (B, D, Ci, H, W)."""
        _, depth, ci, side, _ = x.shape
        co = w.shape[-1]
        x_cf, w_cf = cf(x), w.permute(4, 3, 0, 1, 2).contiguous()
        row = compare(
            "conv3d_dm",
            lambda: cd.conv3d_dm(x, w, (dil, 1, 1)),
            lambda: cd.conv3d_dm_reference(x, w, (dil, 1, 1)),
            lambda: F.conv3d(x_cf, w_cf, padding=(dil, 1, 1), dilation=(dil, 1, 1)),
            iters=8 if depth == DEPTH else 4,
        )
        row = with_bound(row, 2 * (ci + co) * depth * side * side + 2 * 27 * ci * co,
                         conv_flops(ci, co, side, dil, depth))
        log("kernels", f"conv3d_dm {what} {ci}->{co} at {depth}x{side}^2 dil {dil}: max|err| "
            f"{row['max_abs_err']:.3g}, kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
            f"library {row['library_ms']:.3f} ms (F.conv3d, channels-first bf16), "
            f"bound {row['bound_ms']:.3f} ms ({row['bound_by']})")
        return row

    def shape_entry(row, **shape):  # one call of a kernel row's JSON list
        return {**shape, **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                                                "bound_ms", "bound_by")}}

    total, per_shape = None, []
    for ci, co, side, dil in CONV_SHAPES:
        x = randn(1, DEPTH, ci, side, side)
        w = randn(3, 3, 3, ci, co, scale=(27 * ci) ** -0.5)
        row = conv_row(x, w, dil, "forward")
        total = _accumulate(total, row)
        per_shape.append(shape_entry(row, call="forward", ci=ci, co=co, side=side, dil=dil))
    results["conv3d_dm"] = dict(total, shapes=per_shape)

    # one train step's 12 calls at the training crop: each tail conv forward,
    # and its input gradient, the same kernel on g with the taps flipped and
    # Ci, Co swapped (the mask head's makes Ci = 1)
    total, per_shape = None, []
    for ci, co, side, dil in CONV_SHAPES:
        w = randn(3, 3, 3, ci, co, scale=(27 * ci) ** -0.5)
        x = randn(1, TRAIN_DEPTH, ci, side, side)
        row = conv_row(x, w, dil, "forward")
        total = _accumulate(total, row)
        per_shape.append(shape_entry(row, call="forward", ci=ci, co=co, side=side, dil=dil))
        gy = randn(1, TRAIN_DEPTH, co, side, side)
        w_dx = w.flip(0, 1, 2).transpose(3, 4).contiguous()
        row = conv_row(gy, w_dx, dil, "input gradient")
        total = _accumulate(total, row)
        per_shape.append(shape_entry(row, call="input gradient", ci=co, co=ci, side=side, dil=dil))
        del x, gy
    results["conv3d_dm_train_step"] = dict(total, shapes=per_shape)
    results["conv3d_dm"]["max_abs_err"] = max(total["max_abs_err"],
                                              results["conv3d_dm"]["max_abs_err"])
    log("kernels", f"conv3d_dm per train step (12 calls at {TRAIN_DEPTH}x{SIDE}^2): kernel "
        f"{total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, library "
        f"{total['library_ms']:.3f} ms, bound {total['bound_ms']:.3f} ms ({total['bound_by']})")

    total = None
    for ci, co, side in CONVT_SHAPES:
        x = randn(1, DEPTH, ci, side, side)
        w = randn(1, 2, 2, ci, co, scale=ci**-0.5)
        x_cf, w_t = cf(x), w[0].flip(0, 1).permute(2, 3, 0, 1)[:, :, None].contiguous()
        row = compare(
            "convt2x_dm", lambda: ct.convt2x_dm(x, w), lambda: ct.convt2x_dm_reference(x, w),
            lambda: F.conv_transpose3d(x_cf, w_t, stride=(1, 2, 2)), iters=8,
        )
        voxels = DEPTH * side * side
        row = with_bound(row, 2 * (ci + 4 * co) * voxels + 2 * 4 * ci * co, 8 * ci * co * voxels)
        log("kernels", f"convt2x_dm {ci}->{co} at {DEPTH}x{side}^2 -> {2 * side}^2: max|err| "
            f"{row['max_abs_err']:.3g}, kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
            f"library {row['library_ms']:.3f} ms (F.conv_transpose3d, channels-first bf16), "
            f"bound {row['bound_ms']:.3f} ms ({row['bound_by']})")
        total = _accumulate(total, row)
    results["convt2x_dm"] = total

    # the backward kernels at the training crop's shapes
    conv_bwd = torch.ops.aten.convolution_backward
    total, per_shape = None, []
    for ci, co, side, dil in CONV_SHAPES:
        x = randn(1, TRAIN_DEPTH, ci, side, side)
        gy = randn(1, TRAIN_DEPTH, co, side, side)
        x_cf, g_cf = cf(x), cf(gy)
        w_cf = torch.empty(co, ci, 3, 3, 3, device=dev, dtype=bf)
        row = compare(
            "conv3d_dm_dw",
            lambda: cd.conv3d_dm_dw(x, gy, (dil, 1, 1)),
            lambda: cd.conv3d_dm_dw_reference(x, gy, (dil, 1, 1)),
            lambda: conv_bwd(g_cf, x_cf, w_cf, None, [1, 1, 1], [dil, 1, 1], [dil, 1, 1],
                             False, [0, 0, 0], 1, [False, True, False]),
            iters=4, rel_tols=(1e-3,),
        )
        voxels = TRAIN_DEPTH * side * side
        row = with_bound(row, 2 * (ci + co) * voxels + 4 * 27 * ci * co,
                         conv_flops(ci, co, side, dil, TRAIN_DEPTH))
        log("kernels", f"conv3d_dm_dw {ci}->{co} at {TRAIN_DEPTH}x{side}^2 dil {dil}: max|err| "
            f"{row['max_abs_err']:.3g}, kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
            f"library {row['library_ms']:.3f} ms (aten.convolution_backward weight, "
            f"channels-first bf16), bound {row['bound_ms']:.3f} ms ({row['bound_by']})")
        total = _accumulate(total, row)
        per_shape.append(shape_entry(row, ci=ci, co=co, side=side, dil=dil))
        del x, gy, x_cf, g_cf
    results["conv3d_dm_dw"] = dict(total, shapes=per_shape)
    log("kernels", f"conv3d_dm_dw per train step (6 calls at {TRAIN_DEPTH}x{SIDE}^2): kernel "
        f"{total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, library "
        f"{total['library_ms']:.3f} ms, bound {total['bound_ms']:.3f} ms ({total['bound_by']})")

    total = None
    for ci, co, side in CONVT_SHAPES:
        x = randn(1, TRAIN_DEPTH, ci, side, side)
        gy = randn(1, TRAIN_DEPTH, co, 2 * side, 2 * side)
        w = randn(1, 2, 2, ci, co, scale=ci**-0.5)
        x_cf, g_cf = cf(x), cf(gy)
        w_t = w[0].flip(0, 1).permute(2, 3, 0, 1)[:, :, None].contiguous()
        row = compare(
            "convt2x_dm_bwd",
            lambda: ct.convt2x_dm_bwd(gy, x, w),
            lambda: ct.convt2x_dm_bwd_reference(gy, x, w),
            lambda: conv_bwd(g_cf, x_cf, w_t, None, [1, 2, 2], [0, 0, 0], [1, 1, 1],
                             True, [0, 0, 0], 1, [True, True, False]),
            iters=4, rel_tols=(2.0**-6, 1e-3),
        )
        voxels = TRAIN_DEPTH * side * side
        row = with_bound(row, 2 * (2 * ci + 4 * co) * voxels + 2 * 4 * ci * co
                         + 4 * 4 * ci * co, 16 * ci * co * voxels)
        log("kernels", f"convt2x_dm_bwd {ci}->{co} at {TRAIN_DEPTH}x{side}^2: max|err| "
            f"{row['max_abs_err']:.3g}, kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
            f"library {row['library_ms']:.3f} ms (aten.convolution_backward input+weight, "
            f"channels-first bf16), bound {row['bound_ms']:.3f} ms ({row['bound_by']})")
        total = _accumulate(total, row)
        del x, gy, x_cf, g_cf
    results["convt2x_dm_bwd"] = total
    results.update(window_kernel_rows(dev, randn))
    results.update(dino_variant_rows(randn))
    results.update(int8_attention_rows(dev))
    log("kernels", "ms of the four conv kernels are sums over the shapes above (one decoder "
        f"tail pass: forward at {DEPTH} slices, backward at {TRAIN_DEPTH}; conv3d_dm's "
        f"JSON ms is the serving pass, its max|err| covers the train step's calls too); "
        "the attention kernels' and the three Hiera kernels' ms are one call each (one "
        "block); residual_layernorm's JSON row is the (x bf16, h bf16, gamma) call, its "
        "max|err| covers all four cases")
    torch.cuda.empty_cache()
    return results


def window_kernel_rows(dev: torch.device, randn) -> dict[str, dict]:
    """The three Hiera kernels against their plain versions at Hiera-L's
    stage-3 shapes for a 64-slice batch at 512²."""
    from cryovit_tpu_torch.ops import window_attention as wa

    def block_params(c, f, c_out):
        inner = c if f == 3 * c else f
        return (1.0 + randn(c, scale=0.1).float(), randn(c, scale=0.1).float(),
                randn(f, c, scale=c**-0.5), randn(f, scale=0.1),
                randn(c_out, inner, scale=inner**-0.5), randn(c_out, scale=0.1))

    results = {}
    n, t, c, heads, hidden = WINDOW_SHAPE
    rows, d = n * t, c // heads
    x = randn(n, t, c)
    ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj = block_params(c, 3 * c, c)
    p = (ln_w, ln_b, *wa.fold_q_scale(w_qkv, b_qkv, heads), w_proj, b_proj)
    row = compare(
        "window_block_attention",
        lambda: wa.window_block_attention(x, *p, heads),
        lambda: wa.window_block_attention_reference(x, *p, heads),
        None, iters=10,
    )
    flops = 2 * rows * c * 3 * c + 4 * n * heads * t * t * d + 2 * rows * c * c
    n_bytes = 2 * 2 * rows * c + 2 * (4 * c * c + 4 * c) + 4 * 2 * c
    results["window_block_attention"] = row = with_bound(row, n_bytes, flops)
    log("kernels", f"window_block_attention N={n} T={t} C={c} ({heads}x{d}): max|err| "
        f"{row['max_abs_err']:.3g}, kernel {row['ms']:.3f} ms ({flops / row['ms'] / 1e9:.1f} "
        f"TFLOP/s), plain {row['plain_ms']:.3f} ms, library: none (no single PyTorch call "
        f"computes LN + qkv + attention + proj + residual), bound {row['bound_ms']:.3f} ms "
        f"({row['bound_by']})")

    p = block_params(c, hidden, c)
    row = compare(
        "window_block_mlp",
        lambda: wa.window_block_mlp(x, *p), lambda: wa.window_block_mlp_reference(x, *p),
        None, iters=10,
    )
    flops = 2 * 2 * rows * c * hidden
    n_bytes = 2 * 2 * rows * c + 2 * (2 * c * hidden + hidden + c) + 4 * 2 * c
    results["window_block_mlp"] = row = with_bound(row, n_bytes, flops)
    log("kernels", f"window_block_mlp {rows} tokens x {c} -> {hidden} -> {c}: max|err| "
        f"{row['max_abs_err']:.3g}, kernel {row['ms']:.3f} ms ({flops / row['ms'] / 1e9:.1f} "
        f"TFLOP/s), plain {row['plain_ms']:.3f} ms, library: none (no single PyTorch call "
        f"computes LN + fc1 + GELU + fc2 + residual), bound {row['bound_ms']:.3f} ms "
        f"({row['bound_by']})")
    del x, p

    for key, (b, t, heads, d) in (("window_attention", GLOBAL_SHAPE),
                                  ("window_attention hiera_t", GLOBAL_SHAPE_T)):
        c = heads * d
        qkv = randn(b, t, 3 * c)  # q, k, v as column views, as the global blocks pass them
        qkv[..., :c] *= d**-0.5 * wa.LOG2E  # q pre-scaled, as the folded projection gives it
        q, k, v = qkv[..., :c], qkv[..., c : 2 * c], qkv[..., 2 * c :]
        qh, kh, vh = (a.reshape(b, t, heads, d).transpose(1, 2).contiguous() for a in (q, k, v))
        row = compare(
            "window_attention",
            lambda: wa.window_attention(q, k, v, heads),
            lambda: wa.window_attention_reference(q, k, v, heads),
            lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=1.0 / wa.LOG2E),
            iters=10,
        )
        flops = 4 * b * heads * t * t * d
        results[key] = row = with_bound(row, 2 * 4 * b * t * c, flops)
        log("kernels", f"window_attention B={b} T={t} H={heads}x{d}: max|err| "
            f"{row['max_abs_err']:.3g}, kernel {row['ms']:.3f} ms ({flops / row['ms'] / 1e9:.1f} "
            f"TFLOP/s), plain {row['plain_ms']:.3f} ms, library {row['library_ms']:.3f} ms "
            f"(scaled_dot_product_attention, (B, H, T, {d}) bf16, "
            f"{flops / row['library_ms'] / 1e9:.1f} TFLOP/s), bound {row['bound_ms']:.3f} ms "
            f"({row['bound_by']})")
        del qkv, q, k, v, qh, kh, vh
    return results


def dino_variant_rows(randn) -> dict[str, dict]:
    """The head-major attention, its (B, N, H, D) twin and the fused residual
    + LayerNorm against their plain versions at ViT-g's shapes for a 64-slice
    batch at 512² (64 × 1029 tokens, 24 heads of 64, 1536 channels)."""
    from cryovit_tpu_torch.ops import flash_attention as fa
    from cryovit_tpu_torch.ops import fused_norm as fn

    results = {}
    b, n, h = ATTN_SHAPE
    d = fa.HEAD_DIM
    c = h * d
    flops = 4 * b * h * n * n * d
    qkv = randn(b, n, 3, h, d)  # the head-major branch's biased projection
    views = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
    contiguous = [t.contiguous() for t in views]
    rows = []
    for what, (q, k, v) in (("permuted views of one (B, N, 3, H, 64) projection", views),
                            ("contiguous (B, H, N, 64)", contiguous)):
        row = compare(
            "flash_attention_bhnd",
            lambda: fa.flash_attention_bhnd(q, k, v),
            lambda: fa.flash_attention_bhnd_reference(q, k, v),
            lambda: F.scaled_dot_product_attention(*contiguous),
            iters=10,
        )
        row = with_bound(row, 2 * 4 * b * n * c, flops)
        log("kernels", f"flash_attention_bhnd B={b} H={h} N={n} D={d}, q/k/v {what}: max|err| "
            f"{row['max_abs_err']:.3g}, kernel {row['ms']:.3f} ms ({flops / row['ms'] / 1e9:.1f} "
            f"TFLOP/s), plain {row['plain_ms']:.3f} ms, library {row['library_ms']:.3f} ms "
            f"(scaled_dot_product_attention, (B, H, N, 64) bf16), bound {row['bound_ms']:.3f} ms "
            f"({row['bound_by']})")
        rows.append(row)
    # the views' row (the model's layout), with the larger error
    results["flash_attention_bhnd"] = dict(rows[0], max_abs_err=max(r["max_abs_err"] for r in rows))

    q, k, v = (t.transpose(1, 2).contiguous() for t in contiguous)  # (B, N, H, 64)
    row = compare(
        "flash_attention_bnhd",
        lambda: fa.flash_attention_bnhd(q, k, v),
        lambda: fa.flash_attention_bnhd_reference(q, k, v),
        lambda: F.scaled_dot_product_attention(*contiguous),
        iters=10,
    )
    results["flash_attention_bnhd"] = row = with_bound(row, 2 * 4 * b * n * c, flops)
    log("kernels", f"flash_attention_bnhd B={b} N={n} H={h} D={d}: max|err| "
        f"{row['max_abs_err']:.3g}, kernel {row['ms']:.3f} ms ({flops / row['ms'] / 1e9:.1f} "
        f"TFLOP/s), plain {row['plain_ms']:.3f} ms, library {row['library_ms']:.3f} ms "
        f"(scaled_dot_product_attention, (B, H, N, 64) bf16), bound {row['bound_ms']:.3f} ms "
        f"({row['bound_by']})")
    del qkv, views, contiguous, q, k, v

    x16, h16 = randn(b, n, c), randn(b, n, c)
    gamma, scale, bias = randn(c, scale=0.5), 1 + randn(c, scale=0.1), randn(c, scale=0.1)
    rows = []
    # every (x, h, gamma) case of the model: the bf16 stream's two calls of a
    # block, and with an f32 stream (residual_dtype=torch.float32) the second
    # call (f32, bf16, gamma) and the first (f32, f32 deferred residual)
    for what, x, hh, g in (("x bf16, h bf16, gamma", x16, h16, gamma),
                           ("x bf16, h bf16, no gamma", x16, h16, None),
                           ("x f32, h bf16, gamma", x16.float(), h16, gamma),
                           ("x f32, h f32, no gamma", x16.float(), h16.float(), None)):
        # the unfused pair on parameters in x's dtype (F.layer_norm takes no
        # mixed types); its x' is not rounded between the two calls
        gx, sx, bx = (None if t is None else t.to(x.dtype) for t in (g, scale, bias))
        row = compare(
            "residual_layernorm",
            lambda: fn.residual_layernorm(x, hh, g, scale, bias),
            lambda: fn.residual_layernorm_reference(x, hh, g, scale, bias),
            lambda: F.layer_norm(x + hh if gx is None else torch.addcmul(x, hh, gx), (c,),
                                 sx, bx, 1e-6),
            iters=20, rel_tols=(2.0**-6, 2.0**-6),
        )
        elems = b * n * c
        row = with_bound(row, elems * (2 * x.element_size() + hh.element_size() + 2) + 3 * 2 * c,
                         8 * elems)
        log("kernels", f"residual_layernorm ({b}, {n}, {c}) {what}: max|err| "
            f"{row['max_abs_err']:.3g}, kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} "
            f"ms, library: none (no one call; the unfused addcmul + F.layer_norm pair "
            f"{row['library_ms']:.3f} ms), bound {row['bound_ms']:.3f} ms ({row['bound_by']})")
        rows.append(row)
    results["residual_layernorm"] = dict(rows[0], max_abs_err=max(r["max_abs_err"] for r in rows))
    return results


# Faults of the int8 numerics, planted in the plain version to show that
# INT8_ROW_RMS would catch them: each rewrites the scales (sq, sk, sv) its
# int8 attention takes, and touches the mode part named beside it.
def _next_chunk_sq(scales):
    sq, sk, sv = scales
    return torch.cat([sq[..., 1:], sq[..., -1:]], dim=-1), sk, sv


def _sv_per_head(scales):
    sq, sk, sv = scales
    return sq, sk, sv.amax(dim=-1, keepdim=True).expand_as(sv)


INT8_FAULTS = {"q rows given the next chunk's scale": ("qk", _next_chunk_sq),
               "one v scale per head, not per column": ("pv", _sv_per_head)}


@contextlib.contextmanager
def planted(fa, fault):
    """``fa``'s plain int8 attention on the scales ``fault`` rewrites."""
    real = fa.attention_int8_scales_reference
    fa.attention_int8_scales_reference = lambda *a, **kw: fault(real(*a, **kw))
    try:
        yield
    finally:
        fa.attention_int8_scales_reference = real


def int8_attention_rows(dev: torch.device) -> dict[str, dict]:
    """The int8 attention (each of ``INT8_MODES``) and its scale pre-pass
    against their plain versions at ViT-g's 512² and 1024² shapes, on
    outlier inputs (q ×4 with rows ≡ 3 mod 64 ×16, key 7 and value row 11
    ×16): plain random inputs cannot tell int8 from bf16. The attention is
    held to max|err| ≤ 2^-6·max|plain| and to ``INT8_ROW_RMS``, and each of
    ``INT8_FAULTS`` its mode touches must read above that limit. The plain
    version runs a few slices a call (memory); the kernel takes the whole
    batch. The JSON rows are qkpv at 1024² (the DINOv2 int8 phase's
    shape)."""
    from cryovit_tpu_torch.ops import flash_attention as fa

    def nonempty(scales):  # a mode's unused scales are empty tensors
        return tuple(t for t in scales if t.numel())

    g = torch.Generator(device=dev).manual_seed(5)
    results = {}
    for where, (b, n, h, per_call) in INT8_ATTN_SHAPES.items():
        d = fa.HEAD_DIM
        c = h * d
        qkv = torch.randn(b, n, 3 * c, generator=g, device=dev)
        qkv[..., :c] *= 4
        qkv[:, 3::64, :c] *= 16
        qkv[:, 7, c : 2 * c] *= 16
        qkv[:, 11, 2 * c :] *= 16
        qkv = qkv.to(torch.bfloat16)
        q, k, v = qkv[..., :c], qkv[..., c : 2 * c], qkv[..., 2 * c :]
        bias = (torch.randn(3, c, generator=g, device=dev) * 0.5).to(torch.bfloat16)
        qh, kh, vh = ((t + bias[i]).view(b, n, h, d).transpose(1, 2).contiguous()
                      for i, t in enumerate((q, k, v)))

        def plain(fn, *args, **kw):
            outs = [fn(q[i : i + per_call], k[i : i + per_call], v[i : i + per_call], *args,
                       **kw) for i in range(0, b, per_call)]
            return (torch.cat(outs) if isinstance(outs[0], torch.Tensor)
                    else tuple(torch.cat(parts) for parts in zip(*outs)))

        io_bytes = 2 * 4 * b * n * c  # q, k, v read, out written, bf16
        products = 2 * b * h * n * n * d  # operations of one of Q·Kᵀ, P·V
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), 5)
        for quant in INT8_MODES:
            row = compare(
                "flash_attention_int8",
                lambda: fa.flash_attention(q, k, v, bias, h, quant=quant),
                lambda: plain(fa.flash_attention_reference, bias, h, quant=quant),
                None, iters=5, row_limit=(d, INT8_ROW_RMS),
            )
            want = plain(fa.flash_attention_reference, bias, h, quant=quant)
            faults = {}
            for fault, (part, rewrite) in INT8_FAULTS.items():
                if part in quant:
                    with planted(fa, rewrite):
                        faults[fault] = row_rms(
                            plain(fa.flash_attention_reference, bias, h, quant=quant), want, d)
            del want
            readings = ", ".join(f"{f} {r:.4g}" for f, r in faults.items())
            if not all(r > INT8_ROW_RMS for r in faults.values()):
                raise AssertionError(f"flash_attention_int8 quant={quant} {where}: a planted "
                                     f"fault reads within the row RMS limit: {readings}")
            int8 = products * (("qk" in quant) + ("pv" in quant))
            row = with_bound(row, io_bytes, 2 * products - int8, int8)
            log("kernels", f"flash_attention_int8 quant={quant} {where} B={b} N={n} H={h}x{d}: "
                f"max|err| {row['max_abs_err']:.3g} (limit {row['max_abs_limit']:.4g}), row RMS "
                f"relative error {row['row_rms']:.4g} (limit {INT8_ROW_RMS:.4g}; planted faults "
                f"in the plain version: {readings}), kernel {row['ms']:.3f} ms (with the scale "
                f"pre-pass; {2 * products / row['ms'] / 1e9:.1f} TOP/s), plain "
                f"{row['plain_ms']:.3f} ms ({per_call} slices a call), library: "
                f"none (no PyTorch call computes int8 attention; scaled_dot_product_attention "
                f"bf16 on the same shape {sdpa_ms:.3f} ms), bound {row['bound_ms']:.3f} ms "
                f"({row['bound_by']})")
            results[f"flash_attention_int8 {quant} {where}"] = row
            n_out = 2 * ("qk" in quant) + ("pv" in quant)  # sq, sk / sv (the others empty)
            row = compare(
                "flash_attention_int8_scales",
                lambda: nonempty(fa.attention_int8_scales(q, k, v, bias, h, quant=quant)),
                lambda: nonempty(plain(fa.attention_int8_scales_reference, bias, h, quant=quant)),
                None, iters=5, rel_tols=(0.0,) * n_out,
            )
            row = with_bound(row, 2 * b * n * c * n_out, 0.0)  # q, k / v read
            log("kernels", f"flash_attention_int8_scales quant={quant} {where}: max|err| "
                f"{row['max_abs_err']:.3g} (bit-exact required), kernel {row['ms']:.3f} ms, plain "
                f"{row['plain_ms']:.3f} ms, library: none, bound {row['bound_ms']:.3f} ms "
                f"({row['bound_by']})")
            results[f"flash_attention_int8_scales {quant} {where}"] = row
        del qkv, q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    results["flash_attention_int8"] = results["flash_attention_int8 qkpv 1024^2"]
    results["flash_attention_int8_scales"] = results["flash_attention_int8_scales qkpv 1024^2"]
    for name in ("flash_attention_int8", "flash_attention_int8_scales"):
        results[name]["max_abs_err"] = max(
            r["max_abs_err"] for key, r in results.items() if key.startswith(name + " "))
    return results


def int8_attention_phase(dev: torch.device, backbone) -> dict[str, int]:
    """The int8 attention's main path: the JAX perf lab's configuration
    ``DinoV2(pair_attention_fn=partial(flash_attention, quant=m))`` at full
    ViT-g width on one batch of ``INT8_BATCH`` synthetic 1024² slices (4101
    tokens), on the serving phase's weights with LayerScale raised to
    ``AGREEMENT_LAYERSCALE``; the bf16 default first (row 1's kernel at 4101
    tokens), then each of ``INT8_MODES``. Per configuration: launches (exactly
    one int8 attention and one scale pre-pass per block under a mode, none
    under the default), finite features, cosine and relative L2 against the
    default (at most ``INT8_AGREEMENT``), device ms, peak memory, slices/s.
    Returns the launches of all four runs."""
    from functools import partial

    from cryovit_tpu_torch import kernels
    from cryovit_tpu_torch.data.transforms import dino_device_preprocess
    from cryovit_tpu_torch.models.dinov2 import DinoV2, assign_weights
    from cryovit_tpu_torch.ops.flash_attention import flash_attention

    name = torch.cuda.get_device_name(0)
    cfg, dtype = backbone.cfg, backbone.pos_embed.dtype
    state = {k: torch.full_like(t, AGREEMENT_LAYERSCALE) if k.endswith(".gamma") else t
             for k, t in backbone.state_dict().items()}
    g = torch.Generator(device=dev).manual_seed(6)
    slices = torch.randint(0, 256, (INT8_BATCH, INT8_SIDE, INT8_SIDE), generator=g, device=dev,
                           dtype=torch.uint8)
    x = dino_device_preprocess(slices)
    total = dict.fromkeys(kernels.KERNELS, 0)
    checks, ref = {}, None
    for quant in ("", *INT8_MODES):
        with torch.device("meta"):
            model = DinoV2(cfg, pair_attention_fn=partial(flash_attention, quant=quant)
                           if quant else flash_attention)
        model = assign_weights(model, state, dev, dtype)
        what = f"quant={quant}" if quant else "bf16 default"
        with torch.inference_mode():
            model(x[:2])  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            feats = model(x).float()
            stop.record()
            torch.cuda.synchronize()
        counts = kernels.launch_counts()
        ms = start.elapsed_time(stop)
        peak = torch.cuda.max_memory_allocated()
        total = {k: total[k] + counts[k] for k in total}
        n_tok = feats.shape[1] + 1 + cfg.num_registers
        want = ({"flash_attention_int8": cfg.depth, "flash_attention_int8_scales": cfg.depth}
                if quant else {"flash_attention": cfg.depth})
        want = {**dict.fromkeys(kernels.KERNELS, 0), **want}
        finite = bool(torch.isfinite(feats).all())
        log("int8", f"{what}: {INT8_BATCH} slices of {INT8_SIDE}^2 ({n_tok} tokens) in {ms:.3f} "
            f"ms of device time = {INT8_BATCH / ms * 1e3:.2f} slices/s, peak device memory "
            f"{peak / 2**30:.2f} GiB ({name}); features {tuple(feats.shape)} finite {finite}; "
            f"launches {counts}")
        checks[f"{what}: launches {want}"] = counts == want
        shape = (INT8_BATCH, (INT8_SIDE // 16) ** 2, cfg.embed_dim)
        checks[f"{what}: features {shape} finite"] = feats.shape == shape and finite
        with torch.inference_mode():
            _profile(lambda: model(x), f"one {INT8_BATCH}-slice ViT-g/14 batch at {INT8_SIDE}^2, "
                     f"{what}", INT8_PROFILE_GROUPS,
                     "other elementwise (SwiGLU, casts, copies, patch embed)", name, top=6)
        if ref is None:
            ref = feats
        else:
            cos = F.cosine_similarity(feats.flatten(), ref.flatten(), dim=0).item()
            rel = ((feats - ref).norm() / ref.norm()).item()
            log("int8", f"{what}, LayerScale {AGREEMENT_LAYERSCALE}: features against the bf16 "
                f"default's: cosine {cos:.6f}, relative L2 {rel:.4g}")
            checks[f"{what}: relative L2 <= {INT8_AGREEMENT} against the bf16 default "
                   "(finiteness and layout; the kernel rows hold the int8 arithmetic)"] = (
                rel <= INT8_AGREEMENT)
        del model, feats
    _report_checks(checks, "DINOv2 int8 attention")
    del ref, x, slices, state
    torch.cuda.empty_cache()
    return total


def reference_phase(dev: torch.device) -> None:
    """Small input: GPU bf16 through the kernels vs CPU f32 through the plain
    versions, same seeded weights; probabilities within 2e-2 (bf16). Once
    for each DINOv2 configuration (head width 64, so the default pairs
    heads), each GPU run launching its configuration's kernels."""
    from cryovit_tpu_torch import kernels
    from cryovit_tpu_torch.models.cryovit import make_cryovit, random_cryovit_state_dict
    from cryovit_tpu_torch.models.dinov2 import DinoV2Config, make_dinov2
    from cryovit_tpu_torch.models.fused import FusedDinoCryoVIT
    from cryovit_tpu_torch.run.dino_features import load_dinov2_variables

    cfg = DinoV2Config(embed_dim=128, depth=2, num_heads=2, ffn_hidden=256, pos_grid=8)
    dino_sd, _ = load_dinov2_variables(random_init=True, cfg=cfg, device="cpu", seed=2)
    for name, t in dino_sd.items():
        if name.endswith(".gamma"):
            t.fill_(0.5)  # LayerScale 1e-5 would hide the blocks, attention included
    dec_sd = random_cryovit_state_dict(torch.Generator().manual_seed(3), in_channels=128)
    dec_sd["output_layer.2.weight"] *= 40.0  # spread the probabilities over (0, 1)
    stack = torch.rand(4, 128, 160, generator=torch.Generator().manual_seed(4))
    configs = {"default": ({}, {"flash_attention": 2}),
               **{k: (opts, {name: 2 * n for name, n in per_block.items()})
                  for k, (opts, per_block) in DINO_VARIANTS.items()}}
    failed = []
    for what, (options, launches) in configs.items():
        probs = {}
        for device, dtype in ((dev, torch.bfloat16), (torch.device("cpu"), torch.float32)):
            fused = FusedDinoCryoVIT(
                make_dinov2(dino_sd, cfg, device=device, dtype=dtype, **options),
                make_cryovit(dec_sd, device=device, dtype=dtype),
            )
            kernels.reset_launch_counts()
            probs[device.type] = fused.segment(stack).float().cpu()
            if device.type == "cuda":
                counts = {k: n for k, n in kernels.launch_counts().items() if n}
        want = {"conv3d_dm": 6, "convt2x_dm": 2, **launches}
        err = (probs["cuda"] - probs["cpu"]).abs().max().item()
        agree = ((probs["cuda"] >= 0.5) == (probs["cpu"] >= 0.5)).float().mean().item()
        log("reference", f"{what}: 4x128x160 tomogram, small backbone + full decoder: GPU bf16 "
            f"vs CPU f32 max|dprob| {err:.3g} (tol 2e-2), masks agree on {100 * agree:.3f}% of "
            f"voxels, prob std {probs['cpu'].std().item():.3f}; GPU launches {counts}")
        if not (err <= 2e-2 and counts == want):
            failed.append(f"{what}: max|dprob| {err}, launches {counts} (want {want})")
    if failed:
        raise AssertionError(f"GPU path disagrees with the CPU reference: {failed}")


def train_reference_phase(dev: torch.device) -> None:
    """One train step on 4 slices of an 8x8 patch grid of 1536 channels
    (labels 4x128x128, the first slice unlabeled), the full-width decoder
    from the same seeded weights, its mask head scaled to spread the
    probabilities over (0, 1): GPU bf16 through the kernels vs CPU f32
    through the plain versions. Probabilities within 2e-2, Dice loss within
    2e-4; each parameter's gradient within relative L2 error 5e-2, or within
    5e-2 of the largest gradient norm for a tensor whose CPU gradient norm
    is below 1e-3 of it."""
    from cryovit_tpu_torch.models.cryovit import make_cryovit, random_cryovit_state_dict
    from cryovit_tpu_torch.models.losses import dice_loss

    sd = random_cryovit_state_dict(torch.Generator().manual_seed(5))
    sd["output_layer.2.weight"] *= 100.0  # probabilities' std 0.1 instead of 0.001
    gen = torch.Generator().manual_seed(6)
    feats = torch.randn(1, 4, 8, 8, 1536, generator=gen)
    label = (torch.rand(1, 4, 128, 128, generator=gen) > 0.7).to(torch.int8)
    label[:, 0] = -1
    out = {}
    for device, dtype in ((dev, torch.bfloat16), (torch.device("cpu"), torch.float32)):
        model = make_cryovit(sd, device=device, dtype=dtype, trainable=True)
        y = label.to(device)
        probs = model(feats.to(device))
        loss = dice_loss(probs, y, y > -1)
        loss.backward()
        out[device.type] = (probs.detach().float().cpu(), loss.item(),
                            {n: p.grad.float().cpu() for n, p in model.named_parameters()})
    (p_gpu, loss_gpu, g_gpu), (p_cpu, loss_cpu, g_cpu) = out["cuda"], out["cpu"]
    dprob = (p_gpu - p_cpu).abs().max().item()
    largest = max(g.norm().item() for g in g_cpu.values())
    worst, worst_name = 0.0, ""
    for name, want in g_cpu.items():
        diff = (g_gpu[name] - want).norm().item()
        norm = want.norm().item()
        rel = diff / (norm if norm >= 1e-3 * largest else largest)
        if rel > worst:
            worst, worst_name = rel, name
    log("train-ref", f"4 slices x 8x8 patches, full decoder, one step: max|dprob| {dprob:.3g} "
        f"(tol 2e-2, prob std {p_cpu.std().item():.3f}); Dice loss GPU bf16 {loss_gpu:.6f} vs "
        f"CPU f32 {loss_cpu:.6f}, |diff| {abs(loss_gpu - loss_cpu):.3g} (tol 2e-4); worst "
        f"gradient relative L2 error {worst:.4g} at {worst_name} (tol 5e-2) over "
        f"{len(g_cpu)} tensors")
    if not dprob <= 2e-2:
        raise AssertionError(f"train step probabilities disagree: max |diff| {dprob}")
    if not abs(loss_gpu - loss_cpu) <= 2e-4:
        raise AssertionError(f"train step loss disagrees: {loss_gpu} vs {loss_cpu}")
    if not worst <= 5e-2:
        raise AssertionError(f"gradient of {worst_name} disagrees: relative error {worst}")


def _pyramid_agreement(got: list, want: list) -> list[tuple[float, float]]:
    """(cosine, relative L2 error) of each FPN level of got against want."""
    out = []
    for a, b in zip(got, want, strict=True):
        a = torch.from_numpy(a.astype("float64")).ravel()
        b = torch.from_numpy(b.astype("float64")).ravel()
        out.append(((a @ b / (a.norm() * b.norm())).item(), ((a - b).norm() / b.norm()).item()))
    return out


def sam_reference_phase(dev: torch.device) -> None:
    """The SAM2 encoder on 2 slices at 512², GPU bf16 through the kernels vs
    CPU f32 through the plain versions, the same seeded weights, once for
    each head width the attention kernel takes: Hiera of width 72 (one head
    of 72 in every stage, as sam2.1_hiera_l) and of width 96 (Hiera-T's),
    stages (1, 1, 3, 1), stage-3 window 16 on a 32×32 grid and block 4
    global, so one block takes each kernel gate; d_model 256. Per FPN level
    cosine >= 0.9995 and relative L2 error <= 0.03 (the CPU's bf16 plain
    path gives >= 0.99995 and <= 0.0094 against f32 on the same input)."""
    import numpy as np

    from cryovit_tpu_torch import kernels
    from cryovit_tpu_torch.models.sam2.config import HieraConfig, SAM2Config
    from cryovit_tpu_torch.models.sam2.encoder import make_image_encoder, sine_position_encoding
    from cryovit_tpu_torch.run.sam_features import SamFeatureExtractor, make_sam_encoder_state

    checks = {}
    for width in (72, 96):
        cfg = SAM2Config(hiera=HieraConfig(embed_dim=width, num_heads=1, stages=(1, 1, 3, 1),
                                           window_spec=(8, 4, 16, 8), global_att_blocks=(4,)))
        sd = make_sam_encoder_state(cfg=cfg, random_init=True, device="cpu", seed=3)
        stack = np.random.default_rng(5).random((2, 512, 512)).astype(np.float32)
        kernels.reset_launch_counts()
        gpu = SamFeatureExtractor(make_image_encoder(sd, cfg, device=dev),
                                  batch_size=2).extract(stack)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        encoder = make_image_encoder(sd, cfg, device="cpu", dtype=torch.float32)
        cpu = SamFeatureExtractor(encoder, batch_size=2).extract(stack)
        agree = _pyramid_agreement(gpu["backbone_fpn"], cpu["backbone_fpn"])
        log("sam-ref", f"2x512x512 slices, Hiera {width}-wide (1 head of {width} per stage), GPU "
            "bf16 vs CPU f32 per FPN level: " + ", ".join(
                f"level {i} cos {c:.6f} rel L2 {r:.4g}" for i, (c, r) in enumerate(agree))
            + f" (limits cos >= 0.9995, rel <= 0.03); launches {counts}")
        # the encodings pass through the compute dtype: bf16 on the GPU, then fp16
        pos_equal = all(
            np.array_equal(p[0], torch.from_numpy(sine_position_encoding(*p.shape[2:], cfg.d_model)
                                                  .copy()).to(torch.bfloat16).to(torch.float16)
                           .permute(2, 0, 1).numpy())
            for p in gpu["vision_pos_enc"]
        )
        checks.update({
            f"width {width}: every level within the limits":
                all(c >= 0.9995 and r <= 0.03 for c, r in agree),
            f"width {width}: each Hiera kernel launched once":
                all(counts[k] == 1 for k in SAM_BATCH_LAUNCHES),
            f"width {width}: position encodings, the f32 sine table through bf16 and fp16":
                pos_equal,
        })
    _report_checks(checks, "SAM reference")


def sam_serving_phase(dev: torch.device, workdir: Path, tiny: bool = False) -> dict[str, int]:
    """``features --use-sam``'s extractor on a 64×512×512 tomogram at full
    width, seeded weights, bf16, slice batch 64: Hiera-L
    (``SAM2Config.large()``, ``run_sam``'s default) with a profile of one
    batch, or with ``tiny`` Hiera-T (``SAM2Config.medsam_tiny()``, MedSAM's
    trunk: three global blocks of 4 heads of 96) with its last-stage window
    set to ``HIERA_T_LAST_WINDOW``."""
    import importlib.util

    import numpy as np

    from cryovit_tpu_torch import kernels
    from cryovit_tpu_torch.io import load_files_from_path, write_mrc
    from cryovit_tpu_torch.models.sam2.config import SAM2Config
    from cryovit_tpu_torch.run.dino_features import save_feature_hdf
    from cryovit_tpu_torch.run.sam_features import (
        SamFeatureExtractor,
        extract_sam_features,
        load_sam_encoder,
    )

    name = torch.cuda.get_device_name(0)
    cfg, label = SAM2Config.large(), "Hiera-L"
    if tiny:
        t = SAM2Config.medsam_tiny()
        cfg = dataclasses.replace(t, hiera=dataclasses.replace(
            t.hiera, window_spec=(*t.hiera.window_spec[:-1], HIERA_T_LAST_WINDOW)))
        label = f"Hiera-T (last-stage window {HIERA_T_LAST_WINDOW})"
    batch_launches = SAM_T_BATCH_LAUNCHES if tiny else SAM_BATCH_LAUNCHES
    rng = np.random.default_rng(12)
    tomo_dir = workdir / f"sam_tomograms_{'t' if tiny else 'l'}"
    tomo_dir.mkdir()
    write_mrc(tomo_dir / "synthetic.mrc", rng.integers(0, 256, size=(DEPTH, SIDE, SIDE), dtype=np.uint8))
    files = load_files_from_path(tomo_dir)

    t0 = time.perf_counter()
    encoder = load_sam_encoder(random_init=True, cfg=cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in encoder.parameters())
    log("sam", f"SAM2 {label} + FPN ({n_params / 1e6:.1f} M params, "
        f"{encoder.trunk.blocks[0].attn.qkv.weight.dtype}) built in {time.perf_counter() - t0:.1f} s")
    extractor = SamFeatureExtractor(encoder, batch_size=SLICE_BATCH)
    extractor.extract(np.zeros((8, SIDE, SIDE), np.float32))  # warm-up (one padded batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    path, volume, feats = next(iter(extract_sam_features(files, extractor)))
    torch.cuda.synchronize()
    t_feat = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    batches = -(-DEPTH // SLICE_BATCH)
    want_counts = {k: (n * batches if k in batch_launches else 0)
                   for k, n in {**dict.fromkeys(kernels.KERNELS, 0), **batch_launches}.items()}
    log("sam", f"SAM2 {label} extraction: {DEPTH} slices in {t_feat:.3f} s = "
        f"{DEPTH / t_feat:.2f} slices/s, MRC read and fp16 pyramids back on the host included "
        f"({name})")
    log("sam", f"{label}: peak device memory {peak / 2**30:.2f} GiB ({name})")
    log("sam", f"launches during the {label} serving path: {counts}")
    shapes = [(DEPTH, 256, SIDE // s, SIDE // s) for s in (4, 8, 16)]
    fpn, pos = feats["backbone_fpn"], feats["vision_pos_enc"]
    checks = {
        f"backbone_fpn {shapes} fp16": [f.shape for f in fpn] == shapes
        and all(f.dtype == np.float16 for f in fpn),
        f"vision_pos_enc {shapes} fp16": [p.shape for p in pos] == shapes
        and all(p.dtype == np.float16 for p in pos),
        "pyramids finite": all(bool(np.isfinite(f).all()) for f in fpn + pos),
        "features vary over slices and channels": all(
            float(f.astype(np.float32).std(axis=(0, 1)).mean()) > 0 for f in fpn),
        f"launches {want_counts}": counts == want_counts,
    }
    log("sam", "backbone_fpn std per level " + " ".join(
        f"{f.astype(np.float32).std():.4f}" for f in fpn))
    if not tiny:
        _profile(lambda: extractor.extract(volume[:SLICE_BATCH]),
                 f"one {SLICE_BATCH}-slice SAM2 batch", SAM_PROFILE_GROUPS,
                 "elementwise, norms, softmax, copies on the device", name, top=15)
    _report_checks(checks, f"SAM {label} serving path")
    if importlib.util.find_spec("h5py") is None:
        log("sam", "h5py is not installed here: save_feature_hdf (run_sam's writer) is not run; "
            "the pyramids above come from extract_sam_features, the step right below it")
    else:
        out_dir = f"sam_features_{'t' if tiny else 'l'}"
        save_feature_hdf({"data": volume}, feats, f"{path.stem}.hdf", workdir / out_dir)
        log("sam", f"wrote {out_dir}/{path.stem}.hdf")
    del encoder, extractor
    torch.cuda.empty_cache()
    return counts


SAM_PROFILE_GROUPS = (
    ("port kernels (window blocks, attention)", ("attention_sm90", "ln_gemm")),
    ("cuBLAS / cuDNN (XLA-path projections, patch embed, FPN)",
     ("xmma", "cutlass", "nvjet", "gemm", "cudnn", "implicit", "conv")),
    ("host <-> device copies", ("Memcpy",)),
)


def serving_phase(dev: torch.device, workdir: Path) -> dict[str, int]:
    import importlib.util

    import numpy as np

    from cryovit_tpu_torch import kernels
    from cryovit_tpu_torch.callbacks import PredictionWriter, threshold_masks
    from cryovit_tpu_torch.io import load_files_from_path, write_mrc
    from cryovit_tpu_torch.models.cryovit import make_cryovit, random_cryovit_state_dict
    from cryovit_tpu_torch.run.dino_features import DinoExtractor, extract_features, save_feature_hdf
    from cryovit_tpu_torch.run.infer_model import fused_predictions, load_fused
    from cryovit_tpu_torch.train.checkpoint import save_model

    rng = np.random.default_rng(0)
    tomo_dir = workdir / "tomograms"
    tomo_dir.mkdir()
    write_mrc(tomo_dir / "synthetic.mrc", rng.integers(0, 256, size=(DEPTH, SIDE, SIDE), dtype=np.uint8))
    decoder = make_cryovit(random_cryovit_state_dict(torch.Generator(device=dev).manual_seed(1)))
    model_path = save_model("smoke", "mito", decoder, workdir / "smoke.model")
    del decoder
    files = load_files_from_path(tomo_dir)

    t0 = time.perf_counter()
    segmenter, label_key = load_fused(model_path, random_init=True, device=dev,
                                      slice_batch=SLICE_BATCH)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in segmenter.backbone.parameters())
    log("serve", f"ViT-g/14 ({n_params / 1e9:.3f} B params, "
        f"{segmenter.backbone.pos_embed.dtype}) + CryoVIT decoder from {model_path.name} "
        f"built in {time.perf_counter() - t0:.1f} s")
    segmenter.segment(torch.zeros(8, SIDE, SIDE))  # warm-up: library heuristics, allocator
    extractor = DinoExtractor(segmenter.backbone, batch_size=SLICE_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    predictions = list(fused_predictions(files, segmenter))
    torch.cuda.synchronize()
    t_infer = time.perf_counter() - t0
    t0 = time.perf_counter()
    extracted = list(extract_features(files, extractor))
    torch.cuda.synchronize()
    t_feat = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    probs = predictions[0].preds[0]
    masks = threshold_masks(probs, 0.5)
    _, _, feats = extracted[0]
    name = torch.cuda.get_device_name(0)
    log("serve", f"fused inference: {DEPTH} slices in {t_infer:.3f} s = "
        f"{DEPTH / t_infer:.2f} slices/s ({name})")
    log("serve", f"feature extraction: {DEPTH} slices in {t_feat:.3f} s = "
        f"{DEPTH / t_feat:.2f} slices/s ({name})")
    log("serve", f"peak device memory {peak / 2**30:.2f} GiB ({name})")
    log("serve", f"launches during the serving path: {counts}")
    checks = {
        f"probabilities {(DEPTH, SIDE, SIDE)}": probs.shape == (DEPTH, SIDE, SIDE),
        "probabilities finite": bool(np.isfinite(probs).all()),
        "probabilities in [0, 1]": bool(probs.min() >= 0.0 and probs.max() <= 1.0),
        "masks uint8 0/1": masks.dtype == np.uint8 and set(np.unique(masks)) <= {0, 1},
        f"features {(1536, DEPTH, SIDE // 16, SIDE // 16)} fp16":
            feats.shape == (1536, DEPTH, SIDE // 16, SIDE // 16) and feats.dtype == np.float16,
        "features finite": bool(np.isfinite(feats).all()),
        "every forward kernel of the path launched": all(
            counts[k] > 0 for k in ("flash_attention", "conv3d_dm", "convt2x_dm")
        ),
        "the default DINOv2 launches no head-major attention and no residual_layernorm": all(
            counts[k] == 0 for k in ("flash_attention_bhnd", "residual_layernorm")
        ),
    }
    log("serve", f"probabilities mean {probs.mean():.4f} std {probs.std():.4f}, "
        f"mask fraction {masks.mean():.4f}")
    _report_checks(checks, "serving path")

    if importlib.util.find_spec("h5py") is None:
        log("serve", "h5py is not installed here: the HDF5 writers (PredictionWriter, "
            "save_feature_hdf) are not run; the results above come from "
            "fused_predictions and extract_features, the steps right below them")
    else:
        writer = PredictionWriter(workdir / "masks", label_key)
        writer.on_predict_batch_end(predictions[0])
        path, volume, feats = extracted[0]
        save_feature_hdf({"data": volume}, feats, f"{path.stem}.hdf", workdir / "features")
        log("serve", f"wrote {writer.result_paths[0].name} and features/{path.stem}.hdf")
    del extractor
    variant_counts = dino_variants_phase(dev, segmenter.backbone, files, feats, DEPTH / t_feat)
    int8_counts = int8_attention_phase(dev, segmenter.backbone)
    del segmenter
    torch.cuda.empty_cache()
    return {k: counts[k] + variant_counts[k] + int8_counts[k] for k in counts}


# kernel-name fragments → the layer a device kernel of the DINOv2 forward
# belongs to
DINO_PROFILE_GROUPS = (
    ("residual_layernorm (fused residual + LayerScale + LayerNorm)", ("residual_layernorm",)),
    ("LayerNorm (F.layer_norm)", ("layer_norm",)),
    ("LayerScale + residual (addcmul)", ("addcmul",)),
    ("port attention kernel", ("flash_attention", "attention_sm90")),
    ("cuBLAS projections", ("xmma", "cutlass", "nvjet", "gemm", "sm90_")),
)


INT8_PROFILE_GROUPS = (
    ("int8 scale pre-pass", ("attention_int8_scales",)),
    ("port attention kernel", ("flash_attention", "attention_sm90")),
    *DINO_PROFILE_GROUPS[:3],
    DINO_PROFILE_GROUPS[4],
)


def dino_variants_phase(dev: torch.device, backbone, files, default_feats,
                        default_rate: float) -> dict[str, int]:
    """Extraction with each of ``DINO_VARIANTS`` on the serving phase's
    ViT-g/14 weights (the same tensors, not copies) and tomogram: launches
    (exact), features' layout and finiteness, slices/s, peak memory. Then
    the agreement that can fail on a wrong block: one 64-slice batch through
    each configuration with LayerScale raised to ``AGREEMENT_LAYERSCALE``
    (other weights shared), each variant against the default. Last, a
    profile of one batch of the backbone in each configuration, the default
    first. Returns the variants' launches."""
    import numpy as np

    from cryovit_tpu_torch import kernels
    from cryovit_tpu_torch.data.transforms import dino_device_preprocess
    from cryovit_tpu_torch.models.dinov2 import make_dinov2
    from cryovit_tpu_torch.run.dino_features import DinoExtractor, extract_features

    name = torch.cuda.get_device_name(0)
    state = backbone.state_dict()
    depth = backbone.cfg.depth
    batches = -(-DEPTH // SLICE_BATCH)
    ref = default_feats.astype(np.float64).ravel()
    total = dict.fromkeys(kernels.KERNELS, 0)
    models, checks = {"default": backbone}, {}
    for what, (options, per_block) in DINO_VARIANTS.items():
        model = make_dinov2(state, backbone.cfg, device=dev, dtype=backbone.pos_embed.dtype,
                            **options)
        models[what] = model
        extractor = DinoExtractor(model, batch_size=SLICE_BATCH)
        extractor.extract(np.zeros((8, SIDE, SIDE), np.float32))  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        _, volume, feats = next(iter(extract_features(files, extractor)))
        torch.cuda.synchronize()
        t_feat = time.perf_counter() - t0
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        want = {**dict.fromkeys(kernels.KERNELS, 0),
                **{k: n * depth * batches for k, n in per_block.items()}}
        got = feats.astype(np.float64).ravel()
        cos = float(got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref)))
        rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
        log("variants", f"{what}: {DEPTH} slices in {t_feat:.3f} s = {DEPTH / t_feat:.2f} "
            f"slices/s (default path, same run: {default_rate:.2f}), peak device memory "
            f"{peak / 2**30:.2f} GiB ({name})")
        log("variants", f"{what}: features {feats.shape} {feats.dtype}, finite "
            f"{bool(np.isfinite(feats).all())}; against the default path's: cosine {cos:.6f}, "
            f"relative L2 {rel:.4g}; launches {counts}")
        shape = (backbone.cfg.embed_dim, DEPTH, SIDE // 16, SIDE // 16)
        checks.update({
            f"{what}: weights shared with the default model":
                model.pos_embed.data_ptr() == backbone.pos_embed.data_ptr(),
            f"{what}: features {shape} fp16 finite":
                feats.shape == shape and feats.dtype == np.float16
                and bool(np.isfinite(feats).all()),
            f"{what}, LayerScale 1e-5 (layout only: the blocks barely move the features): "
            f"cosine >= 0.999 and relative L2 <= 0.05 against the default":
                cos >= 0.999 and rel <= 0.05,
            f"{what}: launches {want}": counts == want,
        })
        total = {k: total[k] + counts[k] for k in total}
        del extractor
    x = dino_device_preprocess(torch.as_tensor(volume[:SLICE_BATCH]).to(dev))

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm()).item()

    scaled = {k: torch.full_like(t, AGREEMENT_LAYERSCALE) if k.endswith(".gamma") else t
              for k, t in state.items()}
    with torch.inference_mode():
        outs = {what: make_dinov2(scaled, backbone.cfg, device=dev,
                                   dtype=backbone.pos_embed.dtype, **options)(x).float()
                 for what, (options, _) in {"default": ({}, {}), **DINO_VARIANTS}.items()}
        ref = outs.pop("default")
        moved = rel_l2(models["default"](x).float(), ref)
    log("variants", f"LayerScale {AGREEMENT_LAYERSCALE}: the blocks move the default path's "
        f"features by relative L2 {moved:.4g} from the LayerScale 1e-5 ones")
    checks[f"LayerScale {AGREEMENT_LAYERSCALE}: the blocks move the features by relative L2 "
           f">= 0.25, 5x the agreement limit"] = moved >= 0.25
    for what, got in outs.items():
        cos = F.cosine_similarity(got.flatten(), ref.flatten(), dim=0).item()
        rel = rel_l2(got, ref)
        log("variants", f"{what}, LayerScale {AGREEMENT_LAYERSCALE}: features "
            f"{tuple(got.shape)} against the default path's: cosine {cos:.6f}, relative L2 "
            f"{rel:.4g}")
        checks[f"{what}, LayerScale {AGREEMENT_LAYERSCALE}: cosine >= 0.999 and relative L2 "
               f"<= 0.05 against the default"] = cos >= 0.999 and rel <= 0.05
    del outs, ref, scaled
    for what, model in models.items():
        with torch.inference_mode():
            _profile(lambda: model(x), f"one {SLICE_BATCH}-slice ViT-g/14 batch, {what}",
                     DINO_PROFILE_GROUPS, "other elementwise (SwiGLU, casts, copies, patch embed)",
                     name, top=8)
    _report_checks(checks, "DINOv2 variants")
    del models, x
    return total


def _report_checks(checks: dict[str, bool], what: str) -> None:
    for item, ok in checks.items():
        log("check", f"{item}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError(f"{what} checks failed")


def blob_tomogram(rng, depth: int, side: int):
    """Bright ellipsoid blobs (~+120) on noise (60 ± 20) as uint8, and the
    blob mask as int8 labels with the first 16 slices unlabeled (−1)."""
    import numpy as np

    vol = rng.normal(60.0, 20.0, size=(depth, side, side)).astype(np.float32)
    mask = np.zeros((depth, side, side), dtype=bool)
    for _ in range(60):
        centre = rng.uniform((0, 0, 0), (depth, side, side))
        radii = rng.uniform((6, 16, 16), (20, 48, 48))
        lo = np.maximum(np.floor(centre - radii), 0).astype(int)
        hi = np.minimum(np.ceil(centre + radii) + 1, (depth, side, side)).astype(int)
        zz, yy, xx = np.ogrid[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        inside = (((zz - centre[0]) / radii[0]) ** 2 + ((yy - centre[1]) / radii[1]) ** 2
                  + ((xx - centre[2]) / radii[2]) ** 2) <= 1.0
        mask[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] |= inside
    vol[mask] += 120.0
    label = mask.astype(np.int8)
    label[:16] = -1
    return np.clip(vol, 0, 255).astype(np.uint8), label


class _Recorder:
    """Logger keeping every logged dict; callback snapshotting the weights
    of the last epoch before SWA swaps its average in."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.history: list[dict[str, float]] = []
        self.last_weights: dict[str, torch.Tensor] = {}

    def log_scalars(self, scalars, step):
        self.history.append(dict(scalars))

    def on_train_epoch_end(self, epoch, logs):
        self.last_weights = {n: p.detach().clone() for n, p in self.trainer.module.named_parameters()}

    def series(self, key):
        return [h[key] for h in self.history if key in h]


def training_phase(dev: torch.device, workdir: Path) -> dict[str, int]:
    import importlib.util

    import numpy as np

    from cryovit_tpu_torch import kernels
    from cryovit_tpu_torch.config import TrainConfig
    from cryovit_tpu_torch.data import FileDataset
    from cryovit_tpu_torch.io import load_files_from_path, write_hdf, write_mrc
    from cryovit_tpu_torch.run.dino_features import DinoExtractor, load_extractor, save_feature_hdf
    from cryovit_tpu_torch.run.infer_model import fused_predictions, load_fused
    from cryovit_tpu_torch.run.train_model import build_file_datamodule, build_model, build_trainer
    from cryovit_tpu_torch.train.checkpoint import save_model

    name = torch.cuda.get_device_name(0)
    tomo, label = blob_tomogram(np.random.default_rng(7), TRAIN_DEPTH, SIDE)
    tomo_dir = workdir / "train_tomograms"
    tomo_dir.mkdir()
    write_mrc(tomo_dir / "blobs.mrc", tomo)
    labelled = label[label > -1]
    log("train", f"synthetic {TRAIN_DEPTH}x{SIDE}x{SIDE} uint8 tomogram: blob fraction "
        f"{labelled.mean():.4f} of {labelled.size} labelled voxels, first 16 slices unlabeled")

    t0 = time.perf_counter()
    extractor = DinoExtractor(load_extractor(random_init=True, device=dev), batch_size=SLICE_BATCH)
    feats = extractor.extract(tomo)
    torch.cuda.synchronize()
    log("train", f"ViT-g/14 features {feats.shape} {feats.dtype} in "
        f"{time.perf_counter() - t0:.1f} s (model built and run)")
    del extractor
    torch.cuda.empty_cache()

    cfg = TrainConfig(label_key="mito", name="smoke_train")
    cfg = dataclasses.replace(cfg, trainer=dataclasses.replace(cfg.trainer, max_epochs=TRAIN_EPOCHS))
    volume = tomo.astype(np.float32) / 255.0
    feature_path, label_path = workdir / "features" / "blobs.hdf", workdir / "labels" / "blobs.hdf"
    if importlib.util.find_spec("h5py") is None:
        class ArrayDataset(FileDataset):
            """FileDataset one step below its HDF5 reader: the arrays a
            training-ready file would hold."""

            def _load(self, fd):
                return feats.astype(np.float32), label

            def _load_raw(self, fd):
                return volume

        for path in (feature_path, label_path):
            path.parent.mkdir(parents=True, exist_ok=True)
            path.touch()  # FileDataModule skips files that do not exist
        dataset_cls = ArrayDataset
        log("train", "h5py is not installed here: the dataset returns the arrays of the "
            "training-ready HDF5 (FileDataset below its reader); the loaders, collate, "
            "Trainer and .model writer are the port's own")
    else:
        save_feature_hdf({"data": volume, "mito": label}, feats, feature_path.name,
                         feature_path.parent)
        label_path.parent.mkdir(parents=True, exist_ok=True)
        write_hdf(label_path, {"mito": label})
        dataset_cls = FileDataset
    datamodule = build_file_datamodule(cfg, [feature_path], [label_path], labels=["mito"],
                                       dataset_cls=dataset_cls)
    trainer = build_trainer(cfg, device=dev, root_dir=workdir)
    rec = _Recorder(trainer)
    trainer.loggers.append(rec)
    trainer.callbacks.append(rec)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    module = trainer.fit(build_model(cfg), datamodule)
    model_path = save_model("smoke_train", "mito", module, workdir / "smoke_train.model")
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    segmenter, _ = load_fused(model_path, random_init=True, device=dev, slice_batch=SLICE_BATCH)
    probs = next(iter(fused_predictions(load_files_from_path(tomo_dir), segmenter))).preds[0]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    del segmenter

    losses = rec.series("train_dice_loss")
    log("train", f"Trainer.fit: {TRAIN_EPOCHS} epochs of one {TRAIN_DEPTH}x{SIDE}x{SIDE} crop "
        f"in {t_fit:.1f} s; train_dice_loss {' '.join(f'{v:.4f}' for v in losses)}")
    log("train", f"val_dice_loss {' '.join(f'{v:.4f}' for v in rec.series('val_dice_loss'))}; "
        f"val_dice_metric {' '.join(f'{v:.4f}' for v in rec.series('val_dice_metric'))}")
    log("train", f"epoch_time_s {' '.join(f'{v:.3f}' for v in rec.series('epoch_time_s'))} "
        f"({name})")
    log("train", f"peak device memory during fit {peak / 2**30:.2f} GiB ({name})")
    log("train", f"launches during the training path (fit, .model, fused inference): {counts}")
    swa_moved = max((rec.last_weights[n] - p).abs().max().item()
                    for n, p in module.named_parameters())
    checks = {
        "every logged value finite": all(np.isfinite(v) for h in rec.history for v in h.values()),
        f"{len(losses)} train steps logged": len(losses) == TRAIN_EPOCHS,
        "last train_dice_loss below the first": losses[-1] < losses[0],
        "grad_norm > 0": all(v > 0 for v in rec.series("grad_norm")),
        "SWA average differs from the last weights": swa_moved > 0,
        f"served probabilities {(TRAIN_DEPTH, SIDE, SIDE)} finite in [0, 1]":
            probs.shape == (TRAIN_DEPTH, SIDE, SIDE) and bool(np.isfinite(probs).all())
            and bool(probs.min() >= 0.0 and probs.max() <= 1.0),
        "every kernel of the path launched": all(counts[k] > 0 for k in DINO_KERNELS),
    }
    log("train", f"SWA moved the weights by up to {swa_moved:.3g}; served probabilities mean "
        f"{probs.mean():.4f}, blob voxels {probs[label == 1].mean():.4f}, background "
        f"{probs[label == 0].mean():.4f}")

    # one isolated train step on the same batch: launches, time, profile
    batch, _ = next(iter(datamodule.train_loader()))
    data, target = trainer.to_device(batch)
    kernels.reset_launch_counts()
    trainer.train_step(data, target)
    torch.cuda.synchronize()
    step_counts = kernels.launch_counts()
    checks[f"one train step launches {TRAIN_STEP_LAUNCHES}"] = step_counts == TRAIN_STEP_LAUNCHES
    times = []
    for _ in range(5):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.train_step(data, target)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    step_ms = statistics.median(times)
    voxels = TRAIN_DEPTH * SIDE * SIDE
    log("train", f"train step at {TRAIN_DEPTH}x{SIDE}x{SIDE} (batch 1, bf16): median of 5 "
        f"{step_ms:.2f} ms (all {' '.join(f'{t:.2f}' for t in times)}) = "
        f"{voxels / step_ms * 1e3 / 1e6:.1f} M voxels/s ({name})")
    log("train", f"launches in one train step: {step_counts}")
    _profile(lambda: trainer.train_step(data, target), "one train step", PROFILE_GROUPS,
             "elementwise, norms, reductions, copies", name)
    _report_checks(checks, "training path")
    return counts


# kernel-name fragments → the layer a device kernel belongs to
PROFILE_GROUPS = (
    ("port kernels (decoder tail)", ("conv3d_dm", "convt2x_dm", "sum_partials")),
    ("cuDNN / cuBLAS (projection, front convs)",
     ("convolve", "wgrad", "dgrad", "xmma", "cutlass", "nvjet", "gemm", "cudnn", "implicit")),
)


def _profile(run, what: str, groups, rest: str, name: str, top: int = 12) -> None:
    """Device time of one call of ``run`` by kernel and by layer (the first
    of ``groups`` whose name fragments a kernel's name holds, else ``rest``),
    from torch.profiler: device activity only, not the host ops that launch
    it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in rows) / 1e3
    by_group: dict[str, float] = {}
    for e in rows:
        group = next((g for g, keys in groups if any(k in e.key for k in keys)), rest)
        by_group[group] = by_group.get(group, 0.0) + e.self_device_time_total / 1e3
    log("profile", f"{what}: device busy {total:.2f} ms of {wall:.2f} ms wall (profiled) ({name})")
    for group, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        log("profile", f"{ms:9.3f} ms ({100 * ms / total:4.1f} %)  {group}")
    for e in rows[:top]:
        log("profile", f"{e.self_device_time_total / 1e3:9.3f} ms {e.count:4d}x  {e.key[:100]}")


def _kernel_names(build_log: str):
    """(kernel<template args>, ptxas usage) lines of the nvcc -Xptxas -v report."""
    kernel = ""
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"((?:attention_int8_scales|attention_sm90|flash_attention"
                          r"|conv3d_dm_dw|conv3d_dm|convt2x_dm_bwd|convt2x_dm"
                          r"|sum_partials|window_attention|ln_gemm|residual_layernorm)_kernel)"
                          r"(I(?:L[ib]\d+E)+E)?",
                          line)
            args = ",".join(re.findall(r"L[ib](\d+)E", m[2])) if m and m[2] else ""
            kernel = (f"{m[1]}<{args}>" if args else m[1]) if m else line
        elif "Used" in line:
            yield kernel, line.split(":", 1)[1].strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false); "
              "this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from cryovit_tpu_torch import kernels

    dev = torch.device("cuda")
    card = gpu_name_and_power()
    log("device", f"{card} | torch {torch.__version__} CUDA {torch.version.cuda} | "
        f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    kernels.load_library()
    log("build", f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for kernel, usage in _kernel_names(kernels.build_log()):
        log("build", f"{kernel}: {usage}")

    results = kernel_phase(dev)
    reference_phase(dev)
    train_reference_phase(dev)
    sam_reference_phase(dev)
    with tempfile.TemporaryDirectory(prefix="cryovit_smoke_") as tmp:
        serving = serving_phase(dev, Path(tmp))
        training = training_phase(dev, Path(tmp))
        sam = sam_serving_phase(dev, Path(tmp))
        sam_t = sam_serving_phase(dev, Path(tmp), tiny=True)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": serving[name] + training[name] + sam[name] + sam_t[name],
         **{k: results[name][k] for k in keys}}
        for name, (source, replaces) in KERNELS.items()
    ]}
    # the same kernel at Hiera-T's global shape (4 heads of 96), its launches
    # those of the Hiera-T batch
    row_t = results["window_attention hiera_t"]
    next(r for r in report["kernels"] if r["name"] == "window_attention")["hiera_t"] = {
        "launches": sam_t["window_attention"], **{k: row_t[k] for k in keys}}
    # the conv's six calls of a serving pass and twelve of a train step, and
    # the weight gradient's six, one by one
    row4 = next(r for r in report["kernels"] if r["name"] == "conv3d_dm")
    row4["shapes"] = results["conv3d_dm"]["shapes"]
    row4["train_step"] = {k: results["conv3d_dm_train_step"][k] for k in (*keys, "shapes")}
    next(r for r in report["kernels"] if r["name"] == "conv3d_dm_dw")["shapes"] = (
        results["conv3d_dm_dw"]["shapes"])
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
