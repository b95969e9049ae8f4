"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py --parallel-limits   # only the parallel limits' readings
    python3 chip_smoke.py --parallel-limits "unet3d depth-sharded"   # of one step

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
   and the global attention again at Hiera-T's (4 heads of 96), the two
   window blocks also product by product (profiler: LN → qkv, attention,
   proj; LN → fc1 → GELU, fc2) and beside a library composition of the same
   function (``F.layer_norm``, cuBLAS ``F.linear``, SDPA or ``F.gelu``, the
   residual add; timed, never used by the port); the pair
   attention also at ViT-g's 16×4101 tokens (1024²);
   the int8 attention (``flash_attention(quant=...)``, each of qk, pv,
   qkpv) and its two pre-pass launches (the scales, and K and V as the
   body's operands, both bit for bit) at ViT-g's 64×1029 and 16×4101
   tokens, on inputs with outliers (plain random inputs cannot tell int8
   from bf16), held also by the RMS of each output row's relative error,
   whose limit must fall below the readings of planted faults in the plain
   version; the attention body's time split between its two passes.
   Kernel, plain and library times from CUDA events, and the least time the
   card could take (``bound_ms``); TFLOP/s on every attention row. The JSON
   rows of conv3d_dm (its six serving calls, and under ``train_step`` its
   twelve train-step calls), of convt2x_dm (its two serving calls, and
   under ``train_step`` the same two at the training crop), of
   conv3d_dm_dw (its six) and of convt2x_dm_bwd (its two) list each call;
   convt2x_dm_bwd's dW must repeat bit for bit on a second call. Rows 4 and
   5 also at UNet3D's level 1 (128×512×512, dilation 1: conv3d_dm 1->16 and
   16->16 forward and 16->16 input gradient, conv3d_dm_dw Ci 1 and 16 ->
   16), listed per call under ``unet3d_step`` with that path's launches.
4. reference — the serving path on the GPU (bf16, kernels) against the same
   path on the CPU (f32, plain versions) on a small input, once for each
   DINOv2 configuration: the default, ``pair_heads=False`` and
   ``fused_ln=True``.
5. train reference — one train step of the full-width decoder on a small
   input, GPU bf16 through the kernels against CPU f32 through the plain
   versions: the probabilities, the Dice loss and every parameter's
   gradient. Then the same for one UNet3D train step at full width on
   1×32×64×64 voxels, its limits widened to twice what the CPU's own bf16
   plain path reads against f32 where that is larger.
6. SAM reference — the SAM2 image encoder on the GPU (bf16, kernels)
   against the CPU (f32, plain versions), seeded weights, a small config
   that opens both Hiera kernel gates, at head width 72 and again at 96:
   cosine and relative L2 error per FPN level. Then one SAM2 train step at
   ``SAM2Config.tiny_test()``'s widths and 256² on 1×32×256×256 blob
   voxels (two cond slices), GPU bf16 against CPU f32: probabilities, loss
   (Dice + prompt loss) and per group of trained leaves (LoRA factors,
   prompt predictor, no-memory embedding, other SAM2 embeddings) the
   gradient's direction and size, each limit the train reference's or twice
   the larger of two yardsticks (CPU bf16; CPU f32 on the input + 1e-3
   noise), printed beside it; planted zero and sign-flipped gradients must
   fail the limits in every group. Last, the w8a8 reference (``--int8``,
   ``ops/quant.py``): GPU bf16 against CPU f32, both int8, on the serving
   reference's small DINOv2 pair path (features and probabilities) and on
   the SAM reference's two Hiera widths (per FPN level), the weights given
   outlier output channels; each limit 2e-2 or twice the CPU's own bf16
   reading; the kernels and int8 products the gates give (4; 9 each), and
   two planted faults (a per-tensor weight scale, the activation scales on
   swapped token axes) must read above a limit.
7. serving main path — a synthetic 64×512×512 uint8 tomogram written as MRC;
   the full-width DINOv2 ViT-g/14 with seeded random weights and a seeded
   CryoVIT decoder saved as a ``.model``; fused inference (raw tomogram →
   masks) and feature extraction on it. Then ``features -v``
   (``run_dino(..., visualize=True)``, the same seeded weights built again):
   exactly 40 ``flash_attention`` launches, its features bit for bit the
   extraction's, seven PCA PNGs (slices 0, 10, ..., 60, SIDE × 2·SIDE RGB)
   read back by the port's reader; the device's PCA (float64 ``eigh`` on the
   card) against a float64 numpy reference on the host on the same fp16
   features: the top four eigenvalues, the largest principal angle between
   the top-3 subspaces, each component's embedding with its sign where its
   eigen-gap is wide; the PCA stage's, the PNG writes' and the batch's times.
   Then the DINOv2 variants on the same
   weights (shared, not copied) and tomogram: extraction with
   ``pair_heads=False`` (exactly 40 ``flash_attention_bhnd`` launches) and
   with ``fused_ln=True`` (exactly 40 ``flash_attention`` and 80
   ``residual_layernorm``): features against the default path's, slices/s
   beside the default's, peak memory, and a profile of one 64-slice batch of
   each configuration. Last, the int8 attention's main path: the same
   weights with LayerScale 0.2 in ``DinoV2(pair_attention_fn=partial(
   flash_attention, quant=m))`` on 16 synthetic 1024² slices (4101 tokens),
   the bf16 default first and then each mode: exactly 40 int8 attention,
   40 scale and 40 operand launches per mode (none under the default), finite
   features within relative L2 0.1 of the default's (a check of finiteness
   and layout: bf16-level differences move 40 blocks as far, so the kernel
   rows hold the int8 arithmetic), device ms, slices/s, peak memory. Then
   the w8a8 mode on the same weights (only the int8 qkv and w12 copies are
   new) and tomogram: ``features --int8``'s extractor (exactly 40
   ``flash_attention`` launches and 80 int8 products a batch; features
   against the default's, also at LayerScale 0.2; slices/s, peak memory;
   device ms of one batch beside the bf16 default's, in turns; a profile
   split into int8 products, quantize and dequantize passes, the attention
   kernel, bf16 cuBLAS and the rest), ``infer --fused --int8`` (masks
   against the bf16 fused masks, slices/s), and its two products alone at
   ViT-g's block shapes (``torch._int_mm`` beside bf16 ``F.linear`` and
   their bounds, the whole w8a8 projection and its quantize pass).
8. training main path — a synthetic 128×512×512 tomogram of bright blobs on
   noise, its ViT-g/14 features and blob labels; ``Trainer.fit`` of the
   full-width decoder in bf16 for 8 epochs with SWA and validation through
   the port's FileDataModule, DataLoader and collate; the trained decoder
   saved as a ``.model`` and served by fused inference on the same
   tomogram. One isolated train step's launches, the step time (median of
   5) and a profile of one step. Then ``evaluate`` and file-based ``infer``
   one step below their file readers: the ``.model`` reloaded in bf16,
   ``Trainer.test`` with ``CsvWriter`` (the row's metrics against the Dice
   and F1 recomputed in numpy from the returned predictions) and
   ``Trainer.predict`` on the stored fp16 features against the fused
   path's probabilities; device ms of one test and one predict step.
9. experiment mode — ``python -m cryovit_tpu_torch.training.*`` through
   ``sweep_main`` on a synthetic data tree (AD and Young, 3 blob tomograms
   of 64×512×512 each, ``csv/splits.csv``): the ``dino_features`` sweep
   (full-width ViT-g/14, seeded weights, ``export_features=true``) writes
   the training-ready files, its features bit for bit
   ``DinoExtractor.extract``'s, and seven PCA PNGs per tomogram under
   ``exp_dir/dino_images/<sample>/<stem>``; the
   ``sam_features`` sweep (Hiera-L, seeded, ``sample=Young``) writes
   Young's pyramids; ``train_model`` (``model=cryovit datamodule=single
   datamodule.sample=AD datamodule.split_id=1 datamodule.test_sample=Young
   trainer.max_epochs=2 logger={}``, the full-width decoder in bf16) writes
   ``weights.pt`` under ``<name>/AD/split_1`` with the composed recipe in
   its trainer (lr 1e-4, SWA from 0.8, 2 epochs); ``eval_model`` on the
   same overrides reads it back and writes one metrics row per Young
   tomogram. Each stage's launches exactly as its steps give them, its
   wall time and peak memory. Without h5py only the HDF5 file layer is
   replaced, in memory (``_HDF5Store``; the phase names the functions).
10. SAM serving main path — SAM2 feature extraction (``cryovit-torch features
   --use-sam``'s extractor) on a synthetic 64×512×512 tomogram at Hiera-L
   full width, slice batch 64: the pyramids' shapes and values, each Hiera
   kernel's launches against the counts its gates give, slices/s with host
   I/O, peak memory and a profile of one batch. Then the same at Hiera-T
   full width (``SAM2Config.medsam_tiny()``, MedSAM's trunk: its three
   global blocks run the attention kernel at head width 96; exactly 0/0/3
   launches per batch), slices/s and peak memory, with the last stage's
   window 14 instead of 7 (``HIERA_T_LAST_WINDOW``: with 7 the q-pool
   block 10 fails in the JAX reference and the port alike). Between the
   two, ``features --use-sam --int8``'s extractor at Hiera-L: exactly
   32/32/3 launches and 29 int8 products a batch, the pyramids against the
   bf16 ones per level, slices/s, peak memory, device ms of one encoder
   batch beside the bf16 encoder's.
11. UNet3D training main path — ``train --model unet3d`` one step below its
   file readers: a synthetic 128×512×512 blob tomogram's raw voxels,
   ``Trainer.fit`` of the full-width U-Net (bf16 on f32 masters, AdamW lr
   3e-3, SWA) for 6 epochs, its ``.model`` reloaded and scored by
   ``Trainer.test``; one isolated step's launches (5 conv3d_dm, 3
   conv3d_dm_dw), the step time (median of 5), voxels/s, epoch times, peak
   memory and a profile of one step split into the port's kernels, cuDNN,
   copies and the norm/GELU glue.
12. SAM2 training main path — ``train --model sam2`` one step below its
   file readers: a synthetic 128×512×512 blob tomogram's raw voxels,
   ``Trainer.fit`` of ``SAM2Config.large()`` (sam2.1_hiera_l at 512², LoRA
   r = α = 128) at full width, bf16 on f32 masters, AdamW lr 5e-5 and
   prompt_lr 1e-4, gradients clipped at norm 1, batch 1, cond slices
   [1, 1] / [True, False], for SAM2_EPOCHS epochs, the frozen Hiera-L
   run live on every step; the ``.model`` reloaded and run by one
   ``Trainer.test`` and one ``Trainer.predict``. One isolated step's launches (exactly 64/64/6 of
   rows 9/10/11: two 64-slice encoder chunks), the step time (median of
   5), the step split into encoder forward / heads forward / heads backward
   / optimizer (device and host ms), profiles of the encoder forward and of
   a whole step (device busy share), peak memory, epoch times, device ms of
   one test and one predict step. Last, ``kv_cache``: the trained module's
   tracking pass with the live encoder on 64 slices under ``torch.no_grad``,
   uncached and cached: max|dprob| and mask agreement against limits twice
   the CPU's bf16 reading of the same pass at tiny_test widths, device ms
   and host wall per slice, and exactly 32/32/3 launches each.
13. parallel — ``cryovit_tpu_torch.parallel`` on the card: 2 ranks spawned
   on the one card (``torch.multiprocessing``, kernels built by the parent
   first), joined by an explicit gloo group (NCCL refuses two ranks on one
   device; gloo's ``all_reduce`` and ``broadcast`` take CUDA tensors
   through the host, so the times say nothing of NCCL scaling). Each rank
   against the single process on the same card (run first): the
   data-parallel CryoVIT train step at full width (two crops of the
   training cell's 128 × 32×32 patches of 1536 features, one a rank), the
   depth-sharded step (one crop, 64 slices a rank: halo exchanges, global
   GroupNorm statistics) and the sharded DINOv2 extraction of the serving
   tomogram (32 slices a rank, features gathered): the Dice loss, the worst
   and the median gradient and the worst parameter update after the step
   within limits set from this comparison's own readings over five seeds
   (``python3 chip_smoke.py --parallel-limits`` prints them), the features
   within the serving reference's 2e-2 (relative L2), the ranks'
   parameters bit for bit equal; four planted faults (gradients averaged
   instead of summed, zero halos, GroupNorm statistics over each slab
   alone, features gathered into the other rank's slot) must read above
   those limits. Then UNet3D's depth-sharded train step at full width (the
   UNet3D training cell's 128×512×512 blob voxels, 64 slices a rank: halos
   at every level, InstanceNorm statistics over both ranks, rows 4 and 5 on
   each rank's halo'd slab): the Dice loss, each level's gradient as one
   vector (direction and size, as the SAM2 train reference holds its
   groups) and the gathered probabilities of the starting weights against
   the single process, within limits set the same way, which two planted
   faults (the halos of one level-2 conv zero, InstanceNorm statistics
   over each slab alone) must read above. Then SAM2's two steps at full
   width (SAM2Config.large(), live encoder, ``train --model sam2``'s norm
   clip) on the same blob voxels: at batch 1 the frozen encoder split over
   the ranks (64 slices a rank, the pyramids gathered), the heads whole on
   each rank; at batch 2 the data-parallel step (one crop a rank): the
   total loss and each trained gradient group before the clip (direction
   and size) against the single process, within limits set the same way,
   which three planted faults (rank 0 encoding rank 1's slab, the split
   step's gradients summed, the data-parallel gradients averaged) must read
   above; the bytes and host seconds of the pyramids' gather.
   Launches per rank (exactly 12/6/2/2 of rows 4-7 a CryoVIT step, 5/3 of
   rows 4/5 a UNet3D step, 32/32/3 of rows 9-11 a SAM2 encoder-split step
   and 64/64/6 a data-parallel one, 40 of row 1 an extraction), ms per
   step, peak GiB per rank against the single process.

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
import math
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
# UNet3D's level 1 at the reference crop (TRAIN_DEPTH x SIDE², dilation 1):
# a train step's conv3d_dm calls (forward of analysis convs 1->16, 16->16 and
# of the last synthesis conv 16->16; the input gradients of the two 16->16
# convs whose input needs one, the first conv's input being the data) and
# its conv3d_dm_dw calls (Ci -> Co of each conv)
UNET_CONV_CALLS = [("forward", 1, 16), ("forward", 16, 16), ("forward", 16, 16),
                   ("input gradient", 16, 16), ("input gradient", 16, 16)]
UNET_DW_CALLS = [(1, 16), (16, 16), (16, 16)]
UNET_EPOCHS = 6
# the experiment mode's phase: two samples of EXP_TOMOGRAMS blob tomograms of
# EXP_DEPTH x SIDE² each, the CryoVIT experiment trained EXP_EPOCHS epochs on
# AD (split 1 held out) and tested on Young
EXP_SAMPLES = ("AD", "Young")
EXP_TOMOGRAMS, EXP_DEPTH, EXP_EPOCHS = 3, 64, 2
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
    "flash_attention_int8": ("cryovit_tpu_torch/csrc/attention_int8_sm90.cu",
                             "cryovit_tpu/ops/flash_attention.py:226"),
    "flash_attention_int8_scales": ("cryovit_tpu_torch/csrc/attention_int8_sm90.cu",
                                    "cryovit_tpu/ops/flash_attention.py:386"),
    "flash_attention_int8_operands": ("cryovit_tpu_torch/csrc/attention_int8_sm90.cu",
                                      "cryovit_tpu/ops/flash_attention.py:393"),
}
DINO_KERNELS = ("flash_attention", "conv3d_dm", "convt2x_dm", "conv3d_dm_dw", "convt2x_dm_bwd")
# one train step of the decoder: 6 tail convs forward and 6 input gradients
# through conv3d_dm, 6 weight gradients, 2 ConvTransposes each way
TRAIN_STEP_LAUNCHES = {**dict.fromkeys(KERNELS, 0), "conv3d_dm": 12, "convt2x_dm": 2,
                       "conv3d_dm_dw": 6, "convt2x_dm_bwd": 2}
UNET_STEP_LAUNCHES = {**dict.fromkeys(KERNELS, 0), "conv3d_dm": len(UNET_CONV_CALLS),
                      "conv3d_dm_dw": len(UNET_DW_CALLS)}
UNET_STEP_NONZERO = {k: n for k, n in UNET_STEP_LAUNCHES.items() if n}
# one forward pass of the decoder (a validation or test step): its six tail
# convs and two ConvTransposes, as a fused pass launches them
DECODER_FORWARD_LAUNCHES = {**dict.fromkeys(KERNELS, 0), "conv3d_dm": 6, "convt2x_dm": 2}
# one SAM2 train step on the 128-slice crop: the frozen Hiera-L runs live in
# two 64-slice chunks, each launching rows 9, 10, 11 as a serving batch does
# (SAM_BATCH_LAUNCHES below); the heads have no kernel
SAM2_EPOCHS = 2
# the kv_cache check: the tracking pass with the live encoder on this many
# slices of the SAM2 phase's tomogram, cached and uncached
KV_SLICES = 64
# features -v: the slices drawn (every 10th) and the PCA's limits against a
# float64 host reference on the same fp16 features: the largest principal
# angle between the top-3 subspaces, and per component (with its sign) the
# embedding's max|diff| over its max|value|, held only where the component's
# eigen-gap to both neighbours exceeds PCA_GAP of the top eigenvalue
VIZ_SLICES = list(range(0, 64, 10))
PCA_ANGLE_LIMIT = 1e-6
PCA_EMB_LIMIT = 1e-4
PCA_GAP = 1e-3
SAM2_STEP_NONZERO = {"window_block_attention": 64, "window_block_mlp": 64, "window_attention": 6}
SAM2_STEP_LAUNCHES = {**dict.fromkeys(KERNELS, 0), **SAM2_STEP_NONZERO}
# the CryoVIT .model's file-based inference against the fused path on the
# same tomogram and weights: the largest |difference| of the probabilities
# (so the masks agree wherever a probability lies farther from 0.5)
PREDICT_VS_FUSED = 1e-2
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
# the w8a8 mode (--int8, ops/quant.py): its int8 products per ViT-g block on
# the pair path (qkv, w12), and per Hiera-L batch at 512² (the JAX package's
# _Dense calls: the qkv of the 13 blocks that take no attention gate, fc1 of
# the 16 that take no window-block gate)
W8A8_DINO_PER_BLOCK = 2
W8A8_SAM_PER_BATCH = 29
# the same in the SAM reference's Hiera (stages (1, 1, 3, 1)): blocks 0, 1,
# 2 and 5 both products, block 4 (global) fc1, block 3 (fused) none
W8A8_SAM_REF_PRODUCTS = 9
# the two products alone at ViT-g's block shapes for a 64-slice batch at
# 512²: (rows = 64 × 1029 tokens, K, N)
W8A8_PRODUCT_SHAPES = {"qkv": (65856, 1536, 4608), "w12": (65856, 1536, 8192)}
# the w8a8 reference (GPU bf16 against CPU f32, both int8): the serving
# reference's limit, widened to twice the CPU's own bf16 reading where larger
W8A8_REF_LIMIT = 2e-2
# outlier output channels planted into the reference weights (v third of
# qkv, w12, fc1): an eighth of the rows scaled by 16. Trained projections
# differ by channel, which is why their scales are per channel; seeded
# lecun-normal rows do not, and a per-tensor scale would pass unseen on them
W8A8_OUTLIER_ROWS, W8A8_OUTLIER_SCALE = 1 / 8, 16.0
W8A8_FAULTS = ("one weight scale per tensor, not per output channel",
               "activation scales broadcast on the wrong axes (the two token axes swapped)")
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


def conv_flops(ci, co, side, dil, depth):
    """Operations of a SAME 3³ conv: the depth taps whose plane is in
    range, depth + 2·max(depth − dil, 0), times 9 lateral taps."""
    return 2 * 9 * ci * co * side * side * (depth + 2 * max(depth - dil, 0))


def conv_row(x, w, dil, what):
    """conv3d_dm against its plain version and F.conv3d on x (B, D, Ci, H, W)."""
    from cryovit_tpu_torch.ops import conv3d_dm as cd

    _, depth, ci, side, _ = x.shape
    co = w.shape[-1]
    x_cf, w_cf = x.transpose(1, 2).contiguous(), w.permute(4, 3, 0, 1, 2).contiguous()
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


def shape_entry(row, **shape) -> dict:
    """One call of a kernel row's JSON list."""
    return {**shape, **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                                            "bound_ms", "bound_by")}}


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

    def convt_row(x, w):
        """convt2x_dm against its plain version and F.conv_transpose3d."""
        _, depth, ci, side, _ = x.shape
        co = w.shape[-1]
        x_cf, w_t = cf(x), w[0].flip(0, 1).permute(2, 3, 0, 1)[:, :, None].contiguous()
        row = compare(
            "convt2x_dm", lambda: ct.convt2x_dm(x, w), lambda: ct.convt2x_dm_reference(x, w),
            lambda: F.conv_transpose3d(x_cf, w_t, stride=(1, 2, 2)), iters=8,
        )
        voxels = depth * side * side
        row = with_bound(row, 2 * (ci + 4 * co) * voxels + 2 * 4 * ci * co, 8 * ci * co * voxels)
        log("kernels", f"convt2x_dm {ci}->{co} at {depth}x{side}^2 -> {2 * side}^2: max|err| "
            f"{row['max_abs_err']:.3g}, kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
            f"library {row['library_ms']:.3f} ms (F.conv_transpose3d, channels-first bf16), "
            f"bound {row['bound_ms']:.3f} ms ({row['bound_by']})")
        return row

    # the serving pass's two calls, then the same two at the training crop
    # (a train step's forward)
    for key, depth in (("convt2x_dm", DEPTH), ("convt2x_dm_train_step", TRAIN_DEPTH)):
        total, per_shape = None, []
        for ci, co, side in CONVT_SHAPES:
            row = convt_row(randn(1, depth, ci, side, side), randn(1, 2, 2, ci, co, scale=ci**-0.5))
            total = _accumulate(total, row)
            per_shape.append(shape_entry(row, ci=ci, co=co, side=side, depth=depth))
        results[key] = dict(total, shapes=per_shape)
    results["convt2x_dm"]["max_abs_err"] = max(total["max_abs_err"],
                                               results["convt2x_dm"]["max_abs_err"])
    log("kernels", f"convt2x_dm per train step (2 calls at {TRAIN_DEPTH}x{SIDE}^2): kernel "
        f"{total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, library "
        f"{total['library_ms']:.3f} ms, bound {total['bound_ms']:.3f} ms ({total['bound_by']})")

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
    results.update(unet3d_kernel_rows(dev, randn))

    total, per_shape = None, []
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
        # dW's partials are added in a fixed order: a second call gives the same bits
        if not torch.equal(ct.convt2x_dm_bwd(gy, x, w)[1], ct.convt2x_dm_bwd(gy, x, w)[1]):
            raise AssertionError(f"convt2x_dm_bwd {ci}->{co}: dW differs from run to run")
        voxels = TRAIN_DEPTH * side * side
        row = with_bound(row, 2 * (2 * ci + 4 * co) * voxels + 2 * 4 * ci * co
                         + 4 * 4 * ci * co, 16 * ci * co * voxels)
        log("kernels", f"convt2x_dm_bwd {ci}->{co} at {TRAIN_DEPTH}x{side}^2: max|err| "
            f"{row['max_abs_err']:.3g}, kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
            f"library {row['library_ms']:.3f} ms (aten.convolution_backward input+weight, "
            f"channels-first bf16), bound {row['bound_ms']:.3f} ms ({row['bound_by']}); "
            "dW the same bits on a second call")
        total = _accumulate(total, row)
        per_shape.append(shape_entry(row, ci=ci, co=co, side=side, depth=TRAIN_DEPTH))
        del x, gy, x_cf, g_cf
    results["convt2x_dm_bwd"] = dict(total, shapes=per_shape)
    results.update(window_kernel_rows(dev, randn))
    results.update(dino_variant_rows(randn))
    results.update(int8_attention_rows(dev))
    log("kernels", "ms of the four conv kernels are sums over the shapes above (one decoder "
        f"tail pass: forward at {DEPTH} slices, backward at {TRAIN_DEPTH}; conv3d_dm's "
        f"and convt2x_dm's JSON ms are the serving pass, their max|err| covers the train "
        "step's calls too); "
        "the attention kernels' and the three Hiera kernels' ms are one call each (one "
        "block); residual_layernorm's JSON row is the (x bf16, h bf16, gamma) call, its "
        "max|err| covers all four cases")
    torch.cuda.empty_cache()
    return results


def unet3d_kernel_rows(dev, randn) -> dict[str, dict]:
    """Rows 4 and 5 at UNet3D's level-1 shapes (TRAIN_DEPTH x SIDE², dilation
    1): each conv3d_dm call of a train step (UNET_CONV_CALLS; an input
    gradient is the kernel on g with the taps flipped and Ci, Co swapped)
    and each conv3d_dm_dw call (UNET_DW_CALLS), against the plain versions,
    F.conv3d and aten.convolution_backward."""
    from cryovit_tpu_torch.ops import conv3d_dm as cd

    results = {}
    total, per_shape = None, []
    for call, ci, co in UNET_CONV_CALLS:
        w = randn(3, 3, 3, ci, co, scale=(27 * ci) ** -0.5)
        if call == "input gradient":  # the conv ci -> co's dx: co -> ci
            w, ci, co = w.flip(0, 1, 2).transpose(3, 4).contiguous(), co, ci
        x = randn(1, TRAIN_DEPTH, ci, SIDE, SIDE)
        row = conv_row(x, w, 1, f"UNet3D {call}")
        total = _accumulate(total, row)
        per_shape.append(shape_entry(row, call=call, ci=ci, co=co, side=SIDE, dil=1))
        del x
    results["conv3d_dm_unet3d"] = dict(total, shapes=per_shape)
    log("kernels", f"conv3d_dm per UNet3D train step ({len(UNET_CONV_CALLS)} calls at "
        f"{TRAIN_DEPTH}x{SIDE}^2): kernel {total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, "
        f"library {total['library_ms']:.3f} ms, bound {total['bound_ms']:.3f} ms "
        f"({total['bound_by']})")

    conv_bwd = torch.ops.aten.convolution_backward
    total, per_shape = None, []
    voxels = TRAIN_DEPTH * SIDE * SIDE
    for ci, co in UNET_DW_CALLS:
        x = randn(1, TRAIN_DEPTH, ci, SIDE, SIDE)
        gy = randn(1, TRAIN_DEPTH, co, SIDE, SIDE)
        x_cf, g_cf = x.transpose(1, 2).contiguous(), gy.transpose(1, 2).contiguous()
        w_cf = torch.empty(co, ci, 3, 3, 3, device=dev, dtype=torch.bfloat16)
        row = compare(
            "conv3d_dm_dw",
            lambda: cd.conv3d_dm_dw(x, gy),
            lambda: cd.conv3d_dm_dw_reference(x, gy),
            lambda: conv_bwd(g_cf, x_cf, w_cf, None, [1, 1, 1], [1, 1, 1], [1, 1, 1],
                             False, [0, 0, 0], 1, [False, True, False]),
            iters=4, rel_tols=(1e-3,),
        )
        row = with_bound(row, 2 * (ci + co) * voxels + 4 * 27 * ci * co,
                         conv_flops(ci, co, SIDE, 1, TRAIN_DEPTH))
        log("kernels", f"conv3d_dm_dw UNet3D {ci}->{co} at {TRAIN_DEPTH}x{SIDE}^2 dil 1: max|err| "
            f"{row['max_abs_err']:.3g}, kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
            f"library {row['library_ms']:.3f} ms (aten.convolution_backward weight, "
            f"channels-first bf16), bound {row['bound_ms']:.3f} ms ({row['bound_by']})")
        total = _accumulate(total, row)
        per_shape.append(shape_entry(row, ci=ci, co=co, side=SIDE, dil=1))
        del x, gy, x_cf, g_cf
    results["conv3d_dm_dw_unet3d"] = dict(total, shapes=per_shape)
    log("kernels", f"conv3d_dm_dw per UNet3D train step ({len(UNET_DW_CALLS)} calls at "
        f"{TRAIN_DEPTH}x{SIDE}^2): kernel {total['ms']:.3f} ms, plain {total['plain_ms']:.3f} ms, "
        f"library {total['library_ms']:.3f} ms, bound {total['bound_ms']:.3f} ms "
        f"({total['bound_by']})")
    return results


def _kernel_ms(run, iters: int) -> dict[str, float]:
    """Device ms per call of ``run`` by kernel name, from torch.profiler over
    ``iters`` calls after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    ms: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            ms[e.key] = ms.get(e.key, 0.0) + e.self_device_time_total / 1e3 / iters
    return ms


# csrc/window_block.cu's product kernels by their profiler names: with the
# LayerNorm prologue (qkv, fc1) and with the residual epilogue (proj, fc2)
LN_PRODUCT = r"ln_gemm_kernel"
RESIDUAL_PRODUCT = r"residual_gemm_kernel"


def _window_products(what: str, run, products, iters: int = 10) -> dict[str, dict]:
    """Each product of a window-block kernel on its own: device ms (the
    kernels whose names match the product's pattern), TFLOP/s and bound.
    ``products``: (name, kernel-name pattern, bytes, flops)."""
    by_kernel = _kernel_ms(run, iters)
    out = {}
    for name, pattern, n_bytes, flops in products:
        ms = sum(v for k, v in by_kernel.items() if re.search(pattern, k))
        if not ms:
            raise AssertionError(f"{what}: no kernel matches {pattern} in {sorted(by_kernel)}")
        row = with_bound({"ms": ms}, n_bytes, flops)
        out[name] = {"ms": ms, "tflops": flops / ms / 1e9 if ms else None,
                     "bound_ms": row["bound_ms"], "bound_by": row["bound_by"]}
        log("kernels", f"{what} product {name}: {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"bound {row['bound_ms']:.3f} ms ({row['bound_by']})")
    return out


def window_kernel_rows(dev: torch.device, randn) -> dict[str, dict]:
    """The three Hiera kernels against their plain versions at Hiera-L's
    stage-3 shapes for a 64-slice batch at 512²; for the two window blocks
    also each product's own time (profiler) and the time of a library
    composition of the same function (``F.layer_norm``, cuBLAS ``F.linear``,
    SDPA or ``F.gelu``, the residual add: timed, never used by the port)."""
    from cryovit_tpu_torch.ops import window_attention as wa

    def block_params(c, f, c_out):
        inner = c if f == 3 * c else f
        return (1.0 + randn(c, scale=0.1).float(), randn(c, scale=0.1).float(),
                randn(f, c, scale=c**-0.5), randn(f, scale=0.1),
                randn(c_out, inner, scale=inner**-0.5), randn(c_out, scale=0.1))

    def composition(name, fn, plain):
        got, want = fn().float(), plain().float()
        err = (got - want).abs().max().item()
        del got, want
        ms = time_ms(fn, 10)
        log("kernels", f"{name} library composition: {ms:.3f} ms (max|diff| from plain "
            f"{err:.3g}; timed only)")
        return ms

    results = {}
    n, t, c, heads, hidden = WINDOW_SHAPE
    rows, d = n * t, c // heads
    x = randn(n, t, c)
    ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj = block_params(c, 3 * c, c)
    w_qkv, b_qkv = wa.fold_q_scale(w_qkv, b_qkv, heads)
    p = (ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj)
    ln_w16, ln_b16 = ln_w.bfloat16(), ln_b.bfloat16()

    def library_attention():
        y = F.layer_norm(x, (c,), ln_w16, ln_b16, 1e-6)
        q, k, v = F.linear(y, w_qkv, b_qkv).view(n, t, 3, heads, d).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, scale=1.0 / wa.LOG2E)  # q pre-scaled
        return x + F.linear(o.transpose(1, 2).reshape(n, t, c), w_proj, b_proj)

    row = compare(
        "window_block_attention",
        lambda: wa.window_block_attention(x, *p, heads),
        lambda: wa.window_block_attention_reference(x, *p, heads),
        None, iters=10,
    )
    attn_flops = 4 * n * heads * t * t * d
    flops = 2 * rows * c * 3 * c + attn_flops + 2 * rows * c * c
    n_bytes = 2 * 2 * rows * c + 2 * (4 * c * c + 4 * c) + 4 * 2 * c
    results["window_block_attention"] = row = with_bound(row, n_bytes, flops)
    row["library_composition_ms"] = composition(
        "window_block_attention", library_attention,
        lambda: wa.window_block_attention_reference(x, *p, heads))
    row["products"] = _window_products(
        "window_block_attention", lambda: wa.window_block_attention(x, *p, heads), [
            ("LN1 -> qkv + bias", LN_PRODUCT,
             2 * rows * (c + 3 * c) + 2 * 3 * c * (c + 1) + 4 * 2 * c, 2 * rows * c * 3 * c),
            ("attention", "attention_sm90", 2 * rows * (3 * c + c), attn_flops),
            ("proj + bias + x", RESIDUAL_PRODUCT, 2 * rows * 3 * c + 2 * c * (c + 1),
             2 * rows * c * c),
        ])
    log("kernels", f"window_block_attention N={n} T={t} C={c} ({heads}x{d}): max|err| "
        f"{row['max_abs_err']:.3g}, kernel {row['ms']:.3f} ms ({flops / row['ms'] / 1e9:.1f} "
        f"TFLOP/s), plain {row['plain_ms']:.3f} ms, library: none (no single PyTorch call "
        f"computes LN + qkv + attention + proj + residual; the composition "
        f"{row['library_composition_ms']:.3f} ms), bound {row['bound_ms']:.3f} ms "
        f"({row['bound_by']})")

    ln_w, ln_b, w1, b1, w2, b2 = p = block_params(c, hidden, c)
    ln_w16, ln_b16 = ln_w.bfloat16(), ln_b.bfloat16()

    def library_mlp():
        y = F.layer_norm(x, (c,), ln_w16, ln_b16, 1e-6)
        return x + F.linear(F.gelu(F.linear(y, w1, b1)), w2, b2)

    row = compare(
        "window_block_mlp",
        lambda: wa.window_block_mlp(x, *p), lambda: wa.window_block_mlp_reference(x, *p),
        None, iters=10,
    )
    flops = 2 * 2 * rows * c * hidden
    n_bytes = 2 * 2 * rows * c + 2 * (2 * c * hidden + hidden + c) + 4 * 2 * c
    results["window_block_mlp"] = row = with_bound(row, n_bytes, flops)
    row["library_composition_ms"] = composition(
        "window_block_mlp", library_mlp, lambda: wa.window_block_mlp_reference(x, *p))
    row["products"] = _window_products(
        "window_block_mlp", lambda: wa.window_block_mlp(x, *p), [
            ("LN2 -> fc1 + bias -> GELU", LN_PRODUCT, 2 * rows * (c + hidden)
             + 2 * hidden * (c + 1) + 4 * 2 * c, 2 * rows * c * hidden),
            ("fc2 + bias + x", RESIDUAL_PRODUCT, 2 * rows * (hidden + 2 * c)
             + 2 * c * (hidden + 1), 2 * rows * hidden * c),
        ])
    log("kernels", f"window_block_mlp {rows} tokens x {c} -> {hidden} -> {c}: max|err| "
        f"{row['max_abs_err']:.3g}, kernel {row['ms']:.3f} ms ({flops / row['ms'] / 1e9:.1f} "
        f"TFLOP/s), plain {row['plain_ms']:.3f} ms, library: none (no single PyTorch call "
        f"computes LN + fc1 + GELU + fc2 + residual; the composition "
        f"{row['library_composition_ms']:.3f} ms), bound {row['bound_ms']:.3f} ms "
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


def _per_tensor_weight(weight):
    """Fault: one int8 scale for the whole weight."""
    wf = weight.float()
    scale = wf.abs().max().clamp_min(1e-12) * (1.0 / 127.0)
    wq = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return wq.contiguous(), scale.expand(weight.shape[0]).contiguous()


@contextlib.contextmanager
def w8a8_fault(fault: str):
    """The w8a8 mode with one of ``W8A8_FAULTS`` planted: the models'
    weight quantization, or the activation quantization of
    ``ops/quant.py:int8_linear``."""
    from cryovit_tpu_torch.models import dinov2
    from cryovit_tpu_torch.models.sam2 import hiera
    from cryovit_tpu_torch.ops import quant

    if fault == W8A8_FAULTS[0]:
        targets = [(dinov2, "quantize_weight", _per_tensor_weight),
                   (hiera, "quantize_weight", _per_tensor_weight)]
    else:
        honest = quant.int8_quant

        def swapped(x, dim):
            q, s = honest(x, dim)
            return q, (s.transpose(-2, -3).reshape(s.shape) if dim == -1 else s)

        targets = [(quant, "int8_quant", swapped)]
    saved = [(module, attr, getattr(module, attr)) for module, attr, _ in targets]
    for module, attr, fn in targets:
        setattr(module, attr, fn)
    try:
        yield
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)


def _outlier_channels(state: dict, rows: dict, seed: int) -> None:
    """Scale a random ``W8A8_OUTLIER_ROWS`` of the given output rows of each
    named weight by ``W8A8_OUTLIER_SCALE``, in place."""
    g = torch.Generator().manual_seed(seed)
    for key, sl in rows.items():
        w = state[key][sl]
        picked = torch.rand(w.shape[0], generator=g) < W8A8_OUTLIER_ROWS
        w[picked] *= W8A8_OUTLIER_SCALE


def int8_attention_rows(dev: torch.device) -> dict[str, dict]:
    """The int8 attention (each of ``INT8_MODES``) and its two pre-pass
    launches (the scales; K and V as the body's operands) against their
    plain versions at ViT-g's 512² and 1024² shapes, on outlier inputs (q ×4
    with rows ≡ 3 mod 64 ×16, key 7 and value row 11 ×16): plain random
    inputs cannot tell int8 from bf16. The attention is held to max|err| ≤
    2^-6·max|plain| and to ``INT8_ROW_RMS``, and each of ``INT8_FAULTS`` its
    mode touches must read above that limit; the pre-pass outputs must
    equal their plain versions bit for bit. The attention body's time is
    split between its passes by the SM clocks it counts
    (``int8_pass_clocks``). The plain version runs a few slices a call
    (memory); the kernel takes the whole batch. The JSON rows are qkpv at
    1024² (the DINOv2 int8 phase's shape)."""
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
            attention = row
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
            results[f"flash_attention_int8_scales {quant} {where}"] = scales_row = row
            sc = fa.attention_int8_scales(q, k, v, bias, h, quant=quant)
            row = compare(
                "flash_attention_int8_operands",
                lambda: fa.attention_int8_operands(q, k, v, bias, h, quant=quant, scales=sc),
                lambda: plain(fa.attention_int8_operands_reference, bias, h, quant=quant),
                None, iters=5, rel_tols=(0.0, 0.0),
            )
            n_pad = -(-n // fa.KEY_TILE) * fa.KEY_TILE
            out_bytes = b * h * n_pad * d * ((2 - ("qk" in quant)) + (2 - ("pv" in quant)))
            row = with_bound(row, 2 * 2 * b * n * c + out_bytes, 0.0)  # k, v read; K, V written
            log("kernels", f"flash_attention_int8_operands quant={quant} {where}: max|err| "
                f"{row['max_abs_err']:.3g} (bit-exact required), kernel {row['ms']:.3f} ms, plain "
                f"{row['plain_ms']:.3f} ms, library: none, bound {row['bound_ms']:.3f} ms "
                f"({row['bound_by']})")
            results[f"flash_attention_int8_operands {quant} {where}"] = row
            del sc
            # the attention body alone, and its time split between its passes
            body_ms = attention["ms"] - scales_row["ms"] - row["ms"]
            p1, p2 = fa.int8_pass_clocks(q, k, v, bias, h, quant)
            attention = dict(attention, body_ms=body_ms, pass1_share=p1 / (p1 + p2))
            log("kernels", f"flash_attention_int8 quant={quant} {where} B={b} N={n} H={h}x{d}: "
                f"max|err| {attention['max_abs_err']:.3g} (limit "
                f"{attention['max_abs_limit']:.4g}), row RMS relative error "
                f"{attention['row_rms']:.4g} (limit {INT8_ROW_RMS:.4g}; planted faults in the "
                f"plain version: {readings}), kernel {attention['ms']:.3f} ms (with the pre-pass; "
                f"{2 * products / attention['ms'] / 1e9:.1f} TOP/s; the attention body "
                f"{body_ms:.3f} ms = total − scales − operands, pass 1 "
                f"{100 * p1 / (p1 + p2):.1f} % of its SM clocks = {body_ms * p1 / (p1 + p2):.3f} "
                f"ms, pass 2 {body_ms * p2 / (p1 + p2):.3f} ms), plain "
                f"{attention['plain_ms']:.3f} ms ({per_call} slices a call), library: "
                f"none (no PyTorch call computes int8 attention; scaled_dot_product_attention "
                f"bf16 on the same shape {sdpa_ms:.3f} ms), bound {attention['bound_ms']:.3f} ms "
                f"({attention['bound_by']})")
            results[f"flash_attention_int8 {quant} {where}"] = attention
        del qkv, q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    for name in ("flash_attention_int8", "flash_attention_int8_scales",
                 "flash_attention_int8_operands"):
        results[name] = results[f"{name} qkpv 1024^2"]
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
    one int8 attention and one of each pre-pass launch per block under a mode, none
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
        want = (dict.fromkeys(("flash_attention_int8", "flash_attention_int8_scales",
                               "flash_attention_int8_operands"), cfg.depth)
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
    worst, worst_name = _worst_gradient(g_gpu, g_cpu)
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


def _gradient_errors(got: dict, want: dict) -> dict[str, float]:
    """Each parameter's relative L2 gradient error: against the reference
    gradient's norm, or against the largest gradient norm for a tensor
    whose reference norm is below 1e-3 of it (a conv bias before a norm,
    whose gradient is zero up to rounding)."""
    largest = max(g.norm().item() for g in want.values())
    out = {}
    for name, w in want.items():
        norm = w.norm().item()
        out[name] = (got[name] - w).norm().item() / (norm if norm >= 1e-3 * largest else largest)
    return out


def _worst_gradient(got: dict, want: dict) -> tuple[float, str]:
    """The largest relative L2 error of a parameter's gradient
    (_gradient_errors), and its name."""
    worst, worst_name = 0.0, ""
    for name, rel in _gradient_errors(got, want).items():
        if rel > worst:
            worst, worst_name = rel, name
    return worst, worst_name


def unet3d_reference_phase(dev: torch.device) -> None:
    """One UNet3D train step at full width on 1x32x64x64 voxels (the first 2
    slices unlabeled), seeded weights: GPU bf16 through the kernels against
    CPU f32 through the plain versions, and the CPU's bf16 plain path
    against the same f32 run as the yardstick. Limits: the train reference's
    (probabilities 2e-2, Dice loss 2e-4, each gradient 5e-2 by
    _worst_gradient's rule) or twice the yardstick's reading, whichever is
    larger: bf16 through three levels of InstanceNorm moves the
    probabilities by up to 0.028 and the pool norms' gradients by 0.11 at
    this shape on the CPU, kernels or not. The GPU step must launch
    UNET_STEP_LAUNCHES."""
    from cryovit_tpu_torch import kernels
    from cryovit_tpu_torch.models.losses import dice_loss
    from cryovit_tpu_torch.models.unet3d import make_unet3d, random_unet3d_state_dict

    sd = random_unet3d_state_dict(torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(10)
    x = torch.rand(1, 32, 64, 64, 1, generator=gen)
    label = (torch.rand(1, 32, 64, 64, generator=gen) > 0.5).to(torch.int8)
    label[:, :2] = -1
    cpu = torch.device("cpu")
    out = {}
    for what, device, dtype in (("GPU bf16", dev, torch.bfloat16),
                                ("CPU bf16", cpu, torch.bfloat16), ("CPU f32", cpu, torch.float32)):
        model = make_unet3d(sd, device=device, dtype=dtype, trainable=True)
        y = label.to(device)
        kernels.reset_launch_counts()
        probs = model(x.to(device))
        loss = dice_loss(probs, y, y > -1)
        loss.backward()
        if what == "GPU bf16":
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
        out[what] = (probs.detach().float().cpu(), loss.item(),
                     {n: p.grad.float().cpu() for n, p in model.named_parameters()})
    p_ref, loss_ref, g_ref = out["CPU f32"]
    readings = {}
    for what in ("GPU bf16", "CPU bf16"):
        probs, loss, grads = out[what]
        readings[what] = ((probs - p_ref).abs().max().item(), abs(loss - loss_ref),
                          *_worst_gradient(grads, g_ref))
        log("unet-ref", f"{what} vs CPU f32, 1x32x64x64 voxels, full UNet3D, one step: max|dprob| "
            f"{readings[what][0]:.4g}, Dice loss {loss:.6f} vs {loss_ref:.6f} (|diff| "
            f"{readings[what][1]:.3g}), worst gradient relative L2 error {readings[what][2]:.4g} "
            f"at {readings[what][3]} over {len(g_ref)} tensors (prob std {p_ref.std().item():.3f})")
    limits = [max(tol, 2 * r) for tol, r in zip((2e-2, 2e-4, 5e-2), readings["CPU bf16"][:3])]
    log("unet-ref", f"limits max|dprob| {limits[0]:.4g}, loss {limits[1]:.3g}, gradient "
        f"{limits[2]:.4g}; GPU launches {counts}")
    gpu = readings["GPU bf16"]
    _report_checks({
        "GPU bf16 probabilities, loss and gradients within the limits":
            all(r <= lim for r, lim in zip(gpu[:3], limits)),
        f"one step launches {UNET_STEP_NONZERO} and nothing else": counts == UNET_STEP_LAUNCHES,
    }, "UNet3D train reference")


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


def w8a8_reference_phase(dev: torch.device) -> None:
    """The w8a8 mode on small inputs, GPU bf16 against CPU f32, both int8,
    the same seeded weights with outlier rows in the v third of qkv, w12 and
    fc1 (``W8A8_OUTLIER_ROWS``): the DINOv2 pair path (``reference_phase``'s
    small backbone, LayerScale 0.5, and the full decoder: the features'
    relative L2 and max|dprob|) and the Hiera of ``sam_reference_phase`` at
    widths 72 and 96, which open both kernel gates (relative L2 per FPN
    level). Each limit is ``W8A8_REF_LIMIT``, or twice the CPU's own
    bf16-int8 reading against f32-int8 where that is larger; the GPU runs
    launch the kernels and the int8 products their gates give, and each of
    ``W8A8_FAULTS``, planted in the GPU run, must read above a limit."""
    import numpy as np

    from cryovit_tpu_torch import kernels
    from cryovit_tpu_torch.models.cryovit import make_cryovit, random_cryovit_state_dict
    from cryovit_tpu_torch.models.dinov2 import DinoV2Config, make_dinov2
    from cryovit_tpu_torch.models.fused import FusedDinoCryoVIT
    from cryovit_tpu_torch.models.sam2.config import HieraConfig, SAM2Config
    from cryovit_tpu_torch.models.sam2.encoder import make_image_encoder
    from cryovit_tpu_torch.ops import quant
    from cryovit_tpu_torch.run.dino_features import load_dinov2_variables
    from cryovit_tpu_torch.run.sam_features import SamFeatureExtractor, make_sam_encoder_state

    cpu, bf16 = torch.device("cpu"), torch.bfloat16
    checks = {}
    cfg = DinoV2Config(embed_dim=128, depth=2, num_heads=2, ffn_hidden=256, pos_grid=8)
    dino_sd, _ = load_dinov2_variables(random_init=True, cfg=cfg, device="cpu", seed=2)
    for name, t in dino_sd.items():
        if name.endswith(".gamma"):
            t.fill_(0.5)
    c = cfg.embed_dim
    _outlier_channels(dino_sd, {**{f"blocks.{i}.attn.qkv.weight": slice(2 * c, 3 * c)
                                  for i in range(cfg.depth)},
                               **{f"blocks.{i}.mlp.w12.weight": slice(None)
                                  for i in range(cfg.depth)}}, seed=7)
    dec_sd = random_cryovit_state_dict(torch.Generator().manual_seed(3), in_channels=128)
    dec_sd["output_layer.2.weight"] *= 40.0
    stack = torch.rand(4, 128, 160, generator=torch.Generator().manual_seed(4))

    def segment(device, dtype):
        """(features, probabilities) of fused inference, on the CPU."""
        fused = FusedDinoCryoVIT(make_dinov2(dino_sd, cfg, device=device, dtype=dtype,
                                             quant_int8=True),
                                 make_cryovit(dec_sd, device=device, dtype=dtype))
        seen = []
        hook = fused.backbone.register_forward_hook(lambda m, a, out: seen.append(out))
        probs = fused.segment(stack).float().cpu()
        hook.remove()
        return torch.cat(seen).float().cpu(), probs

    def readings(got, want):
        """(relative L2 of the features, max|dprob|)."""
        return (((got[0] - want[0]).norm() / want[0].norm()).item(),
                (got[1] - want[1]).abs().max().item())

    want = segment(cpu, torch.float32)
    limits = [max(W8A8_REF_LIMIT, 2 * r) for r in readings(segment(cpu, bf16), want)]
    kernels.reset_launch_counts()
    quant.reset_launch_count()
    got = segment(dev, bf16)
    torch.cuda.synchronize()
    counts = {k: n for k, n in kernels.launch_counts().items() if n}
    products = quant.launch_count()
    rel, err = readings(got, want)
    log("w8a8-ref", f"DINOv2 pair path int8: 4x128x160 tomogram, small backbone + full decoder: "
        f"GPU bf16 vs CPU f32: features relative L2 {rel:.4g} (limit {limits[0]:.4g}), "
        f"max|dprob| {err:.4g} (limit {limits[1]:.4g}), masks agree on "
        f"{100 * ((got[1] >= 0.5) == (want[1] >= 0.5)).float().mean().item():.3f}% of voxels; "
        f"GPU launches {counts}, int8 products {products}")
    want_counts = {"flash_attention": 2, "conv3d_dm": 6, "convt2x_dm": 2}
    checks.update({
        "DINOv2: GPU bf16 int8 within the limits of CPU f32 int8":
            rel <= limits[0] and err <= limits[1],
        f"DINOv2: launches {want_counts} and {W8A8_DINO_PER_BLOCK * cfg.depth} int8 products":
            counts == want_counts and products == W8A8_DINO_PER_BLOCK * cfg.depth,
    })
    for fault in W8A8_FAULTS:
        with w8a8_fault(fault):
            bad = readings(segment(dev, bf16), want)
        log("w8a8-ref", f"DINOv2 with a planted fault ({fault}): features relative L2 "
            f"{bad[0]:.4g}, max|dprob| {bad[1]:.4g}")
        checks[f"DINOv2: the planted fault ({fault}) reads above a limit"] = (
            bad[0] > limits[0] or bad[1] > limits[1])

    images = np.random.default_rng(5).random((2, 512, 512)).astype(np.float32)
    for width in (72, 96):
        scfg = SAM2Config(hiera=HieraConfig(embed_dim=width, num_heads=1, stages=(1, 1, 3, 1),
                                            window_spec=(8, 4, 16, 8), global_att_blocks=(4,)))
        sd = make_sam_encoder_state(cfg=scfg, random_init=True, device="cpu", seed=3)
        dims = [width] + [2 * width] * 1 + [4 * width] * 3 + [8 * width]  # dim_out per block
        _outlier_channels(sd, {**{f"trunk.blocks.{i}.attn.qkv.weight": slice(2 * d, 3 * d)
                                 for i, d in enumerate(dims)},
                              **{f"trunk.blocks.{i}.mlp.layers.0.weight": slice(None)
                                 for i in range(len(dims))}}, seed=8)

        def pyramids(device, dtype):
            encoder = make_image_encoder(sd, scfg, device=device, dtype=dtype, quant_int8=True)
            return SamFeatureExtractor(encoder, batch_size=2).extract(images)["backbone_fpn"]

        want = pyramids(cpu, torch.float32)
        limits = [max(W8A8_REF_LIMIT, 2 * r) for _, r in _pyramid_agreement(pyramids(cpu, bf16),
                                                                            want)]
        kernels.reset_launch_counts()
        quant.reset_launch_count()
        agree = _pyramid_agreement(pyramids(dev, bf16), want)
        counts = {k: n for k, n in kernels.launch_counts().items() if n}
        products = quant.launch_count()
        log("w8a8-ref", f"Hiera {width}-wide int8, 2x512x512 slices, GPU bf16 vs CPU f32 per FPN "
            "level: " + ", ".join(f"level {i} cos {c:.6f} rel L2 {r:.4g} (limit {lim:.4g})"
                                  for i, ((c, r), lim) in enumerate(zip(agree, limits)))
            + f"; launches {counts}, int8 products {products}")
        checks.update({
            f"Hiera {width}: every level within its limit":
                all(r <= lim for (_, r), lim in zip(agree, limits)),
            f"Hiera {width}: each kernel once and {W8A8_SAM_REF_PRODUCTS} int8 products":
                counts == dict.fromkeys(SAM_BATCH_LAUNCHES, 1)
                and products == W8A8_SAM_REF_PRODUCTS,
        })
        for fault in W8A8_FAULTS:
            with w8a8_fault(fault):
                bad = _pyramid_agreement(pyramids(dev, bf16), want)
            log("w8a8-ref", f"Hiera {width} with a planted fault ({fault}): rel L2 per level "
                + " ".join(f"{r:.4g}" for _, r in bad))
            checks[f"Hiera {width}: the planted fault ({fault}) reads above a limit"] = any(
                r > lim for (_, r), lim in zip(bad, limits))
    _report_checks(checks, "w8a8 reference")


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
    if not tiny:
        w8a8 = sam_w8a8_phase(dev, cfg, encoder, files, volume, fpn)
        counts = {k: counts[k] + w8a8[k] for k in counts}
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


def sam_w8a8_phase(dev: torch.device, cfg, encoder, files, volume, default_fpn) -> dict[str, int]:
    """``features --use-sam --int8``'s extractor: Hiera-L built by
    ``load_sam_encoder(quant_int8=True)`` from the same seed as the bf16
    encoder, on the same 64×512×512 tomogram: launches (exactly 32/32/3 of
    rows 9/10/11 and ``W8A8_SAM_PER_BATCH`` int8 products a batch), the
    pyramids against the bf16 ones (cosine and relative L2 per level),
    slices/s with host I/O, peak memory, and device ms of one encoder batch
    beside the bf16 encoder's, in turns. Returns the launches."""
    import numpy as np

    from cryovit_tpu_torch import kernels
    from cryovit_tpu_torch.ops import quant
    from cryovit_tpu_torch.run.sam_features import (
        SamFeatureExtractor,
        extract_sam_features,
        load_sam_encoder,
    )

    name = torch.cuda.get_device_name(0)
    encoder8 = load_sam_encoder(random_init=True, cfg=cfg, device=dev, quant_int8=True)
    extractor = SamFeatureExtractor(encoder8, batch_size=SLICE_BATCH)
    extractor.extract(np.zeros((8, SIDE, SIDE), np.float32))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    quant.reset_launch_count()
    t0 = time.perf_counter()
    _, _, feats = next(iter(extract_sam_features(files, extractor)))
    torch.cuda.synchronize()
    t_feat = time.perf_counter() - t0
    counts, products = kernels.launch_counts(), quant.launch_count()
    peak = torch.cuda.max_memory_allocated()
    batches = -(-DEPTH // SLICE_BATCH)
    want = {**dict.fromkeys(kernels.KERNELS, 0),
            **{k: n * batches for k, n in SAM_BATCH_LAUNCHES.items()}}
    fpn = feats["backbone_fpn"]
    agree = _pyramid_agreement(fpn, default_fpn)
    log("sam-w8a8", f"features --use-sam --int8 (Hiera-L): {DEPTH} slices in {t_feat:.3f} s = "
        f"{DEPTH / t_feat:.2f} slices/s, MRC read and fp16 pyramids back on the host included, "
        f"peak device memory {peak / 2**30:.2f} GiB ({name})")
    log("sam-w8a8", "pyramids against the bf16 ones: " + ", ".join(
        f"level {i} cos {c:.6f} rel L2 {r:.4g}" for i, (c, r) in enumerate(agree))
        + f"; launches { {k: n for k, n in counts.items() if n} }, int8 products {products}")
    x = torch.from_numpy(np.ascontiguousarray(volume[:SLICE_BATCH], np.float32)).to(dev)
    x = x[..., None].expand(-1, -1, -1, encoder.trunk.patch_embed.proj.in_channels)
    encoders = {"bf16": encoder, "w8a8": encoder8}
    device_ms = {k: [] for k in encoders}
    with torch.inference_mode():
        for what in ("bf16", "w8a8", "w8a8", "bf16"):
            encoders[what](x)  # warm-up
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            encoders[what](x)
            stop.record()
            torch.cuda.synchronize()
            device_ms[what].append(start.elapsed_time(stop))
    log("sam-w8a8", f"one {SLICE_BATCH}-slice Hiera-L + FPN batch, device ms in turns (bf16, "
        "w8a8, w8a8, bf16): " + "; ".join(
            f"{k} {' '.join(f'{v:.3f}' for v in ms)} (mean {statistics.mean(ms):.3f})"
            for k, ms in device_ms.items()) + f" ({name})")
    shapes = [f.shape for f in default_fpn]
    _report_checks({
        f"SAM w8a8: backbone_fpn {shapes} fp16 finite": [f.shape for f in fpn] == shapes
        and all(f.dtype == np.float16 and np.isfinite(f).all() for f in fpn),
        f"SAM w8a8: launches {want} and {W8A8_SAM_PER_BATCH * batches} int8 products":
            counts == want and products == W8A8_SAM_PER_BATCH * batches,
        "SAM w8a8: cosine >= 0.99 per level against the bf16 pyramids (layout; the reference "
        "phase holds the arithmetic)": all(c >= 0.99 for c, _ in agree),
    }, "SAM w8a8 serving path")
    del encoder8, extractor, x
    torch.cuda.empty_cache()
    return counts


SAM_PROFILE_GROUPS = (
    ("port kernels (window blocks, attention)",
     ("attention_sm90", "ln_gemm", "residual_gemm")),
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
    viz_counts = visualization_phase(dev, workdir, segmenter.backbone, files, extracted[0])
    variant_counts = dino_variants_phase(dev, segmenter.backbone, files, feats, DEPTH / t_feat)
    int8_counts = int8_attention_phase(dev, segmenter.backbone)
    w8a8_counts = w8a8_serving_phase(dev, segmenter, files, feats, masks,
                                     {"extraction": DEPTH / t_feat, "fused": DEPTH / t_infer})
    del segmenter
    torch.cuda.empty_cache()
    return {k: counts[k] + viz_counts[k] + variant_counts[k] + int8_counts[k] + w8a8_counts[k]
            for k in counts}


def visualization_phase(dev: torch.device, workdir: Path, backbone, files, extracted
                        ) -> dict[str, int]:
    """``features -v``: ``run_dino(..., visualize=True)`` on the serving
    tomogram with the same seeded ViT-g/14 weights (built again by
    ``run_dino``, as the verb does). Checks: exactly 40 row-1 launches (one
    64-slice batch) and nothing else; the features bit for bit the serving
    path's; seven PNGs (slices 0, 10, ..., 60), each SIDE x 2·SIDE RGB, read
    back by the port's reader, the raw half the flipped 8-bit slice and the
    map half not flat. Then the device's PCA (``fit_pca``, float64 on the
    card) against a float64 numpy reference on the host on the same fp16
    features: the top four eigenvalues, the largest principal angle between
    the two top-3 subspaces (limit PCA_ANGLE_LIMIT), and per component with
    its sign the embedding (limit PCA_EMB_LIMIT of its max) where its
    eigen-gap is wider than PCA_GAP. Times of the PCA stage, of the
    colouring and PNG writes, and of the 64-slice extraction beside them."""
    import importlib.util

    import numpy as np

    from cryovit_tpu_torch import kernels
    from cryovit_tpu_torch.data.transforms import pad_slices_to_multiple
    from cryovit_tpu_torch.io.hdf import read_hdf
    from cryovit_tpu_torch.run import dino_features
    from cryovit_tpu_torch.visualization import dino_pca
    from cryovit_tpu_torch.visualization._image import read_png

    name = torch.cuda.get_device_name(0)
    path, volume, feats = extracted
    store = _HDF5Store() if importlib.util.find_spec("h5py") is None else None
    patches = [(dino_features, "save_feature_hdf", store.save_feature_hdf)] if store else []
    out_dir = workdir / "viz_features"
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with _patched(patches):
        (written,) = dino_features.run_dino(files, out_dir, batch_size=SLICE_BATCH,
                                            random_init=True, device=dev, visualize=True)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    counts = kernels.launch_counts()
    written_feats = (store.read(written, "dino_features") if store is not None
                     else read_hdf(written, key="dino_features")[1])
    image_dir = out_dir / "dino_images" / path.stem / path.stem
    pngs = sorted(image_dir.glob("*.png"), key=lambda p: int(p.stem))
    images = [read_png(p) for p in pngs]
    lo, span = volume.min(), volume.max() - volume.min()
    raw = [((volume[z] - lo) / span * 255.0).astype(np.uint8)[::-1] for z in VIZ_SLICES]
    log("viz", f"features -v (run_dino, visualize=True): {DEPTH} slices in {t_run:.3f} s wall, "
        f"weights built included; {len(pngs)} PNGs {[p.name for p in pngs]} in "
        f"{image_dir.relative_to(workdir)}; launches {counts} ({name})")

    # the device's PCA against float64 numpy on the host, same fp16 features
    sel = torch.from_numpy(feats[:, VIZ_SLICES]).to(dev)
    x = dino_pca._tokens(sel.float())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, comps_d, var_d = dino_pca.fit_pca(x)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    emb_d = dino_pca._calculate_pca(sel)
    torch.cuda.synchronize()
    t_pca = time.perf_counter() - t0
    xh = x.cpu().double().numpy()
    mean_h = xh.mean(0)
    t0 = time.perf_counter()
    w, v = np.linalg.eigh((xh - mean_h).T @ (xh - mean_h))
    t_host = time.perf_counter() - t0
    var_h, comps_h = w[::-1] / (len(xh) - 1), v[:, ::-1][:, :3].T
    comps_h = comps_h * np.sign(comps_h[np.arange(3), np.abs(comps_h).argmax(1)])[:, None]
    comps_d, var_d = comps_d.cpu().numpy(), var_d.cpu().numpy()
    # sine of the largest principal angle: the part of the device's basis
    # outside the host's subspace
    sin_max = np.linalg.norm(comps_d - (comps_d @ comps_h.T) @ comps_h, 2)
    angle = float(np.arcsin(min(sin_max, 1.0)))
    up = dino_pca.resize_bicubic_2d(sel.float().cpu(), 2 * sel.shape[2], 2 * sel.shape[3])
    emb_h = (dino_pca._tokens(up).double().numpy() - mean_h) @ comps_h.T
    emb_d = emb_d.cpu().double().numpy().reshape(-1, 3)
    lam = np.concatenate([[np.inf], var_h[:4]])
    gaps = [min(lam[i] - lam[i + 1], lam[i + 1] - lam[i + 2]) / var_h[0] for i in range(3)]
    emb_err = [float(np.abs(emb_d[:, i] - emb_h[:, i]).max() / np.abs(emb_h[:, i]).max())
               for i in range(3)]
    log("viz", f"PCA of {x.shape[0]} tokens x {x.shape[1]} channels (slices {VIZ_SLICES}): top "
        f"four eigenvalues device {' '.join(f'{e:.6g}' for e in var_d[:4])}, host float64 "
        f"{' '.join(f'{e:.6g}' for e in var_h[:4])}; largest principal angle {angle:.3g} rad "
        f"(limit {PCA_ANGLE_LIMIT:g}); per component relative eigen-gap "
        f"{' '.join(f'{g:.3g}' for g in gaps)}, embedding max|diff|/max "
        f"{' '.join(f'{e:.3g}' for e in emb_err)} (limit {PCA_EMB_LIMIT:g} where the gap "
        f"> {PCA_GAP:g})")

    # times: the batch's extraction, the PCA stage, the colours and PNG writes
    extractor = dino_features.DinoExtractor(backbone, batch_size=SLICE_BATCH)
    stack = pad_slices_to_multiple(volume)
    extractor.extract_device(stack)
    t_batch = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fd = extractor.extract_device(stack)
        torch.cuda.synchronize()
        t_batch.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    dino_pca.export_pca(volume, fd, "timed", workdir / "viz_timed")
    t_export = time.perf_counter() - t0
    del extractor, fd
    log("viz", f"times: the {SLICE_BATCH}-slice extraction {1e3 * min(t_batch):.1f} ms (best of "
        f"3, to fp16 on the device); the PCA stage {1e3 * t_pca:.1f} ms (fit alone "
        f"{1e3 * t_fit:.1f} ms; numpy float64 eigh on the host {1e3 * t_host:.1f} ms); "
        f"export_pca {1e3 * t_export:.1f} ms, of which colours + {len(VIZ_SLICES)} PNG writes "
        f"{1e3 * (t_export - t_pca):.1f} ms ({name})")
    want_counts = {k: 40 if k == "flash_attention" else 0 for k in counts}
    _report_checks({
        f"features -v launches exactly 40 flash_attention and nothing else": counts == want_counts,
        "features -v's features bit for bit the serving path's": np.array_equal(written_feats, feats),
        f"{len(VIZ_SLICES)} PNGs {[f'{z}.png' for z in VIZ_SLICES]}":
            [p.name for p in pngs] == [f"{z}.png" for z in VIZ_SLICES],
        f"each PNG {SIDE}x{2 * SIDE} RGB": all(im.shape == (SIDE, 2 * SIDE, 3) for im in images),
        "raw halves the flipped 8-bit slices": all(
            np.array_equal(im[:, :SIDE], np.repeat(r[..., None], 3, -1))
            for im, r in zip(images, raw)),
        "map halves not flat": all(float(im[:, SIDE:].std()) > 1.0 for im in images),
        f"largest principal angle <= {PCA_ANGLE_LIMIT:g} rad": angle <= PCA_ANGLE_LIMIT,
        "embedding per component within its limit where its eigen-gap is wide": all(
            e <= PCA_EMB_LIMIT for e, g in zip(emb_err, gaps) if g > PCA_GAP),
    }, "visualization path")
    return counts


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
    ("int8 operand pre-pass", ("attention_int8_operands",)),
    ("port attention kernel", ("flash_attention", "attention_sm90", "attention_int8_sm90")),
    *DINO_PROFILE_GROUPS[:3],
    DINO_PROFILE_GROUPS[4],
)


def w8a8_serving_phase(dev: torch.device, segmenter, files, default_feats, default_masks,
                       default_rates: dict[str, float]) -> dict[str, int]:
    """``features --int8`` and ``infer --fused --int8`` on the serving
    phase's ViT-g/14 weights (shared, not copied: only the int8 qkv and w12
    copies are new) and tomogram: the extractor's launches (exactly 40
    ``flash_attention`` and 80 int8 products a batch), features against the
    bf16 default's (and, for one batch, at LayerScale
    ``AGREEMENT_LAYERSCALE``), slices/s with host I/O, peak memory, device ms
    of one batch beside the bf16 default's (in turns), a profile split into
    the int8 products, the quantize and dequantize passes, the attention
    kernel, bf16 cuBLAS and the rest; fused inference's masks against the
    bf16 fused masks and its slices/s; then the two products alone at their
    block shapes (:func:`w8a8_product_rows`). Returns the launches."""
    import numpy as np

    from cryovit_tpu_torch import kernels
    from cryovit_tpu_torch.callbacks import threshold_masks
    from cryovit_tpu_torch.data.transforms import dino_device_preprocess
    from cryovit_tpu_torch.models.dinov2 import make_dinov2
    from cryovit_tpu_torch.models.fused import FusedDinoCryoVIT
    from cryovit_tpu_torch.ops import quant
    from cryovit_tpu_torch.run.dino_features import DinoExtractor, extract_features
    from cryovit_tpu_torch.run.infer_model import fused_predictions

    name = torch.cuda.get_device_name(0)
    backbone = segmenter.backbone
    cfg, dtype = backbone.cfg, backbone.pos_embed.dtype
    state = backbone.state_dict()
    batches = -(-DEPTH // SLICE_BATCH)
    model = make_dinov2(state, cfg, device=dev, dtype=dtype, quant_int8=True)
    int8_bytes = sum(b.numel() * b.element_size() for n, b in model.named_buffers() if "int8" in n)
    extractor = DinoExtractor(model, batch_size=SLICE_BATCH)
    extractor.extract(np.zeros((8, SIDE, SIDE), np.float32))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    quant.reset_launch_count()
    t0 = time.perf_counter()
    _, volume, feats = next(iter(extract_features(files, extractor)))
    torch.cuda.synchronize()
    t_feat = time.perf_counter() - t0
    counts, products = kernels.launch_counts(), quant.launch_count()
    peak = torch.cuda.max_memory_allocated()
    want = {**dict.fromkeys(kernels.KERNELS, 0), "flash_attention": cfg.depth * batches}
    n_products = W8A8_DINO_PER_BLOCK * cfg.depth * batches
    got, ref = (f.astype(np.float64).ravel() for f in (feats, default_feats))
    cos = float(got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref)))
    rel = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
    log("w8a8", f"features --int8: {DEPTH} slices in {t_feat:.3f} s = {DEPTH / t_feat:.2f} "
        f"slices/s (bf16 default, same run: {default_rates['extraction']:.2f}), peak device "
        f"memory {peak / 2**30:.2f} GiB, int8 weight copies {int8_bytes / 2**30:.3f} GiB ({name})")
    log("w8a8", f"features --int8: {feats.shape} {feats.dtype}; against the bf16 default's: "
        f"cosine {cos:.6f}, relative L2 {rel:.4g}; launches "
        f"{ {k: n for k, n in counts.items() if n} }, int8 products {products}")
    shape = (cfg.embed_dim, DEPTH, SIDE // 16, SIDE // 16)
    checks = {
        "w8a8 backbone shares the default's weights": (
            model.pos_embed.data_ptr() == backbone.pos_embed.data_ptr()
            and model.blocks[0].mlp.w12.weight.data_ptr()
            == backbone.blocks[0].mlp.w12.weight.data_ptr()),
        f"features --int8: {shape} fp16 finite": feats.shape == shape
        and feats.dtype == np.float16 and bool(np.isfinite(feats).all()),
        f"features --int8: launches {want} and {n_products} int8 products":
            counts == want and products == n_products,
        "features --int8, LayerScale 1e-5 (layout only): cosine >= 0.999 against the default":
            cos >= 0.999,
    }
    total = counts

    x = dino_device_preprocess(torch.as_tensor(volume[:SLICE_BATCH]).to(dev))
    models = {"bf16 default": backbone, "w8a8": model}
    device_ms = {k: [] for k in models}
    with torch.inference_mode():
        for what in ("bf16 default", "w8a8", "w8a8", "bf16 default"):
            models[what](x)  # warm-up
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            models[what](x)
            stop.record()
            torch.cuda.synchronize()
            device_ms[what].append(start.elapsed_time(stop))
    log("w8a8", f"one {SLICE_BATCH}-slice ViT-g/14 batch at {SIDE}^2, device ms in turns "
        f"(bf16, w8a8, w8a8, bf16): " + "; ".join(
            f"{k} {' '.join(f'{v:.3f}' for v in ms)} (mean {statistics.mean(ms):.3f})"
            for k, ms in device_ms.items()) + f" ({name})")
    scaled = {k: torch.full_like(t, AGREEMENT_LAYERSCALE) if k.endswith(".gamma") else t
              for k, t in state.items()}
    with torch.inference_mode():
        ref_ls = make_dinov2(scaled, cfg, device=dev, dtype=dtype)(x).float()
        got_ls = make_dinov2(scaled, cfg, device=dev, dtype=dtype, quant_int8=True)(x).float()
    cos_ls = F.cosine_similarity(got_ls.flatten(), ref_ls.flatten(), dim=0).item()
    rel_ls = ((got_ls - ref_ls).norm() / ref_ls.norm()).item()
    log("w8a8", f"LayerScale {AGREEMENT_LAYERSCALE}, one batch: w8a8 features against the bf16 "
        f"default's: cosine {cos_ls:.6f}, relative L2 {rel_ls:.4g}")
    checks[f"w8a8, LayerScale {AGREEMENT_LAYERSCALE}: finite, relative L2 <= {INT8_AGREEMENT} "
           "against the bf16 default (layout; the reference phase holds the arithmetic)"] = (
        bool(torch.isfinite(got_ls).all()) and rel_ls <= INT8_AGREEMENT)
    del scaled, ref_ls, got_ls
    with torch.inference_mode():
        _w8a8_profile(lambda: model(x), f"one {SLICE_BATCH}-slice ViT-g/14 batch, w8a8", name)

    fused = FusedDinoCryoVIT(model, segmenter.decoder, slice_batch=SLICE_BATCH)
    fused.segment(torch.zeros(8, SIDE, SIDE))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    quant.reset_launch_count()
    t0 = time.perf_counter()
    predictions = list(fused_predictions(files, fused))
    torch.cuda.synchronize()
    t_infer = time.perf_counter() - t0
    counts, products = kernels.launch_counts(), quant.launch_count()
    peak = torch.cuda.max_memory_allocated()
    probs = predictions[0].preds[0]
    masks = threshold_masks(probs, 0.5)
    agree = float((masks == default_masks).mean())
    log("w8a8", f"infer --fused --int8: {DEPTH} slices in {t_infer:.3f} s = {DEPTH / t_infer:.2f} "
        f"slices/s (bf16 default, same run: {default_rates['fused']:.2f}), peak device memory "
        f"{peak / 2**30:.2f} GiB ({name}); masks agree with the bf16 fused masks on "
        f"{100 * agree:.3f}% of voxels (mask fraction {masks.mean():.4f} vs "
        f"{default_masks.mean():.4f}); launches {({k: n for k, n in counts.items() if n})}, "
        f"int8 products {products}")
    checks.update({
        "infer --fused --int8: probabilities finite, in [0, 1]":
            probs.shape == (DEPTH, SIDE, SIDE) and bool(np.isfinite(probs).all())
            and bool(probs.min() >= 0.0 and probs.max() <= 1.0),
        f"infer --fused --int8: {cfg.depth * batches} flash_attention launches, the decoder's "
        f"kernels, {n_products} int8 products":
            counts["flash_attention"] == cfg.depth * batches and counts["conv3d_dm"] > 0
            and counts["convt2x_dm"] > 0 and products == n_products,
    })
    total = {k: total[k] + counts[k] for k in total}
    del fused, extractor, model, x
    torch.cuda.empty_cache()
    w8a8_product_rows(dev)
    _report_checks(checks, "w8a8 serving path")
    return total


def w8a8_product_rows(dev: torch.device) -> None:
    """The w8a8 mode's two products alone at ViT-g's block shapes
    (``W8A8_PRODUCT_SHAPES``): ``torch._int_mm`` beside the bf16
    ``F.linear`` and each one's bound, then the whole w8a8 projection
    (``int8_linear``: quantize, product, dequantize) and its quantize pass,
    CUDA events. The int8 product's bytes count its int32 output."""
    from cryovit_tpu_torch.ops import quant

    name = torch.cuda.get_device_name(0)
    g = torch.Generator(device=dev).manual_seed(8)
    for what, (m, k, n) in W8A8_PRODUCT_SHAPES.items():
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn(n, k, generator=g, device=dev) * k**-0.5).to(torch.bfloat16)
        xq, sx = quant.int8_quant(x, -1)
        wq, sw = quant.quantize_weight(w)
        ms = {
            "_int_mm": time_ms(lambda: torch._int_mm(xq, wq.t()), 10),
            "bf16 F.linear": time_ms(lambda: F.linear(x, w), 10),
            "int8_linear": time_ms(lambda: quant.int8_linear(x, wq, sw, None, torch.bfloat16), 10),
            "quantize": time_ms(lambda: quant.int8_quant(x, -1), 10),
        }
        ops = 2 * m * k * n
        int8_bound = with_bound({}, m * k + n * k + 4 * m * n, 0, ops)
        bf16_bound = with_bound({}, 2 * (m * k + n * k + m * n), ops)
        ref = F.linear(x.float(), w.float())
        err = ((quant.int8_linear(x, wq, sw, None, torch.bfloat16).float() - ref).norm()
               / ref.norm()).item()
        log("w8a8", f"{what} product {m}x{k}x{n}: _int_mm {ms['_int_mm']:.3f} ms "
            f"({ops / ms['_int_mm'] / 1e9:.1f} TOP/s; bound {int8_bound['bound_ms']:.3f} ms, "
            f"{int8_bound['bound_by']}), bf16 F.linear {ms['bf16 F.linear']:.3f} ms "
            f"({ops / ms['bf16 F.linear'] / 1e9:.1f} TFLOP/s; bound {bf16_bound['bound_ms']:.3f} "
            f"ms, {bf16_bound['bound_by']}); whole int8_linear {ms['int8_linear']:.3f} ms, of "
            f"which quantize {ms['quantize']:.3f}, dequantize (the rest) "
            f"{ms['int8_linear'] - ms['quantize'] - ms['_int_mm']:.3f}; relative L2 against "
            f"the f32 product {err:.4g} ({name})")
        del x, w, xq, wq, ref
        torch.cuda.empty_cache()


# kernel-name fragments of cuBLAS's / CUTLASS's int8 GEMMs (torch._int_mm)
INT8_GEMM_NAMES = ("gemm_s8", "s8s8", "i8i8", "imma", "igemm")
W8A8_SPANS = ("w8a8 quantize", "w8a8 product and dequantize")


def _w8a8_profile(run, what: str, name: str) -> None:
    """Device time of one call of ``run`` split into the int8 products
    (kernels named as ``INT8_GEMM_NAMES``), the quantize passes and the
    dequantize passes (the device spans of profiler annotations wrapped
    around ``int8_quant`` and ``int8_matmul`` for this call only, the
    latter less the int8 products), the attention kernel and bf16 cuBLAS
    (by kernel name), and the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from cryovit_tpu_torch.ops import quant

    honest_quant, honest_matmul = quant.int8_quant, quant.int8_matmul

    def quantize(*args, **kw):
        with record_function(W8A8_SPANS[0]):
            return honest_quant(*args, **kw)

    def matmul(*args, **kw):
        with record_function(W8A8_SPANS[1]):
            return honest_matmul(*args, **kw)

    quant.int8_quant, quant.int8_matmul = quantize, matmul
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        quant.int8_quant, quant.int8_matmul = honest_quant, honest_matmul
    device = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    spans = {e.key: e.self_device_time_total / 1e3 for e in device if e.key in W8A8_SPANS}
    rows = sorted((e for e in device if e.key not in W8A8_SPANS),
                  key=lambda e: e.self_device_time_total, reverse=True)
    total = sum(e.self_device_time_total for e in rows) / 1e3
    if total == 0:
        log("profile", f"{what}: the profiler saw no device time; not measured")
        return

    def named(keys, skip=()):
        return sum(e.self_device_time_total for e in rows if any(k in e.key for k in keys)
                   and not any(k in e.key for k in skip)) / 1e3

    products = named(INT8_GEMM_NAMES)
    split = {
        "int8 products (torch._int_mm's GEMM)": products,
        "quantize passes": spans.get(W8A8_SPANS[0], 0.0),
        "dequantize passes": spans.get(W8A8_SPANS[1], 0.0) - products,
        "port attention kernel": named(("attention_sm90", "flash_attention")),
        "bf16 cuBLAS": named(("xmma", "cutlass", "nvjet", "gemm", "sm90_"),
                             INT8_GEMM_NAMES + ("attention",)),
    }
    split["the rest (LayerNorms, LayerScale adds, SwiGLU, casts, patch embed)"] = (
        total - sum(split.values()))
    log("profile", f"{what}: device busy {total:.2f} ms of {wall:.2f} ms wall (profiled), "
        f"{sum(e.count for e in rows)} kernel launches ({name})")
    if len(spans) < 2 or products == 0:
        log("profile", f"the annotations' device spans ({spans}) or the int8 GEMM's kernels were "
            "not seen: the split below is not measured; the kernels follow")
    for group, ms in split.items():
        log("profile", f"{ms:9.3f} ms ({100 * ms / total:4.1f} %)  {group}")
    for e in rows[:12]:
        log("profile", f"{e.self_device_time_total / 1e3:9.3f} ms {e.count:4d}x  {e.key[:100]}")


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


def blob_tomogram(rng, depth: int, side: int, unlabeled: int = 16):
    """Bright ellipsoid blobs (~+120) on noise (60 ± 20) as uint8, and the
    blob mask as int8 labels with the first ``unlabeled`` slices unlabeled
    (−1)."""
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
    label[:unlabeled] = -1
    return np.clip(vol, 0, 255).astype(np.uint8), label


def _array_dataset(data, label, raw, paths):
    """A FileDataset one step below its HDF5 reader, returning the arrays a
    training-ready file would hold (``data`` (C, D, H, W) f32, the label
    unless a file has no label file, the raw volume); the card's machine has
    no h5py. Touches ``paths``: FileDataModule skips files that do not
    exist."""
    from cryovit_tpu_torch.data import FileDataset

    class ArrayDataset(FileDataset):
        def _load(self, fd):
            return data, (label if fd.label_path is not None else None)

        def _load_raw(self, fd):
            return raw

    for path in paths:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.touch()
    return ArrayDataset


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
        dataset_cls = _array_dataset(feats.astype(np.float32), label, volume,
                                     (feature_path, label_path))
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
    del data, target, batch, trainer, module
    torch.cuda.empty_cache()
    eval_counts = evaluation_phase(dev, workdir, model_path, feature_path, label_path,
                                   dataset_cls, probs)
    return {k: counts[k] + eval_counts[k] for k in counts}


def _dice_f1(preds, label) -> tuple[float, float]:
    """The Dice and F1 metrics of ``models/metrics.py`` recomputed in numpy
    on the host, over the labelled voxels (label > -1)."""
    import numpy as np

    mask = label > -1
    y = np.where(mask, label, 0).astype(np.float64)
    hard = ((preds >= 0.5) & mask).astype(np.float64)
    dice = 2.0 * (y * hard).sum() / (y.sum() + hard.sum() + 1e-3)
    h = ((preds > 0.5) & mask).astype(np.float64)
    tp, fp, fn = (y * h).sum(), ((1 - y) * h * mask).sum(), (y * (1 - h)).sum()
    precision, recall = tp / (tp + fp + 1e-6), tp / (tp + fn + 1e-6)
    return dice, 2.0 * precision * recall / (precision + recall + 1e-6)


def evaluation_phase(dev, workdir, model_path, feature_path, label_path, dataset_cls,
                     fused_probs) -> dict[str, int]:
    """``cryovit-torch evaluate`` and file-based ``infer`` one step below
    their file readers: the training phase's ``.model`` reloaded from disk,
    ``Trainer.test`` with ``CsvWriter`` over the training tomogram (its one
    row's metrics against the Dice and F1 recomputed in numpy from the
    returned predictions and labels, within 1e-3), then ``Trainer.predict``
    on the stored fp16 features against the fused path's probabilities on
    the same tomogram and weights (PREDICT_VS_FUSED). Device ms of one test
    step and one predict step (CUDA events), host seconds of each call."""
    import csv

    import numpy as np

    from cryovit_tpu_torch import kernels
    from cryovit_tpu_torch.callbacks import CsvWriter
    from cryovit_tpu_torch.run.eval_model import load_for_eval
    from cryovit_tpu_torch.run.train_model import build_file_datamodule, build_model
    from cryovit_tpu_torch.train.loop import Trainer

    name = torch.cuda.get_device_name(0)
    module, cfg = load_for_eval(model_path, dev)
    csv_dir = cfg.csv_dir(workdir / "eval")
    trainer = Trainer(**dataclasses.asdict(cfg.trainer), callbacks=[CsvWriter(csv_dir)],
                      seed=cfg.random_seed, device=dev)
    model = build_model(cfg)
    test_dm = build_file_datamodule(cfg, [feature_path], [label_path], labels=["mito"],
                                    dataset_cls=dataset_cls)
    predict_dm = build_file_datamodule(cfg, [feature_path], dataset_cls=dataset_cls)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    (result,) = trainer.test(model, test_dm, module)
    t_test = time.perf_counter() - t0
    t0 = time.perf_counter()
    (prediction,) = trainer.predict(predict_dm, module, model)
    t_predict = time.perf_counter() - t0
    counts = kernels.launch_counts()

    batch, _ = next(iter(test_dm.test_loader()))
    data, target = trainer.to_device(batch)
    test_ms = time_ms(lambda: trainer.eval_step(module, model, data, target), 3)
    predict_ms = time_ms(lambda: trainer.predict_step(module, data, model), 3)
    del data, target

    with open(csv_dir / f"{result.samples[0]}.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    dice, f1 = _dice_f1(result.preds[0], result.label[0])
    probs = prediction.preds[0]
    dprob = float(np.abs(probs - fused_probs).max())
    agree = float(((probs >= 0.5) == (fused_probs >= 0.5)).mean())
    log("eval", f"Trainer.test ({TRAIN_DEPTH}x{SIDE}x{SIDE}, the .model reloaded in bf16): "
        f"{t_test:.2f} s host, one test step {test_ms:.2f} ms device (CUDA events) ({name}); "
        f"CSV {csv_dir.name}/{result.samples[0]}.csv rows {rows}")
    log("eval", f"metrics recomputed in numpy from the returned predictions and labels: dice "
        f"{dice:.6f}, f1 {f1:.6f} (limit 1e-3 from the CSV's)")
    log("eval", f"Trainer.predict on the stored fp16 features: {t_predict:.2f} s host, one "
        f"predict step {predict_ms:.2f} ms device ({name}); against the fused path: max|dprob| "
        f"{dprob:.4g} (limit {PREDICT_VS_FUSED}), masks agree on {100 * agree:.4f} % of voxels")
    log("eval", f"launches during test and predict: {counts}")
    row = rows[0] if len(rows) == 1 else {}
    _report_checks({
        "one CSV row, columns sample, tomo_name, dice_metric, f1_metric":
            list(row) == ["sample", "tomo_name", "dice_metric", "f1_metric"],
        "CSV metrics equal the numpy recomputation within 1e-3":
            bool(row) and abs(float(row["dice_metric"]) - dice) <= 1e-3
            and abs(float(row["f1_metric"]) - f1) <= 1e-3,
        f"predictions {(TRAIN_DEPTH, SIDE, SIDE)} finite": probs.shape == (TRAIN_DEPTH, SIDE, SIDE)
            and bool(np.isfinite(probs).all()),
        "predict agrees with the fused path": dprob <= PREDICT_VS_FUSED,
        "the decoder's forward kernels launched, no backward kernel":
            counts["conv3d_dm"] > 0 and counts["convt2x_dm"] > 0
            and counts["conv3d_dm_dw"] == counts["convt2x_dm_bwd"] == 0,
    }, "evaluation path")
    return counts


class _HDF5Store:
    """The HDF5 file layer of the experiment mode, in memory and keyed by
    path, for a machine without h5py: stand-ins for the functions that open
    HDF5 files (the phase's own source writer ``write_hdf``, the sweeps'
    ``_read_source`` and ``save_feature_hdf``, ``TomoDataset._read`` and
    ``TestPredictionWriter._write``), each keeping its original's layout
    (``data``, ``labels/<key>``, ``dino_features``,
    ``sam_features/<key>/<level>``). Every other step runs unreplaced; the
    files are touched on disk, where the sweeps and loaders look for them."""

    REPLACED = ("cryovit_tpu_torch.io.write_hdf (the phase's source tomograms)",
                "cryovit_tpu_torch.run.dino_features._read_source",
                "cryovit_tpu_torch.run.dino_features.save_feature_hdf",
                "cryovit_tpu_torch.run.sam_features.save_feature_hdf",
                "cryovit_tpu_torch.data.datasets.TomoDataset._read",
                "cryovit_tpu_torch.callbacks.TestPredictionWriter._write")

    def __init__(self):
        self.files: dict[Path, dict] = {}

    def write_hdf(self, path, arrays):
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.touch()
        self.files[path] = dict(arrays)
        return path

    def read(self, path, key):
        return self.files[Path(path)][key]

    def read_source(self, path):
        out = {}
        for key, arr in self.files[Path(path)].items():
            parts = key.split("/")
            if len(parts) <= 2:  # datasets and one level of groups, flattened
                out[parts[-1]] = arr
        return out

    def save_feature_hdf(self, source, features, tomo_name, dst_dir):
        out = {}
        for key, arr in source.items():
            if key == "data":
                out["data"] = arr
            elif key != "dino_features":
                out[f"labels/{key}"] = arr
        if isinstance(features, dict):
            if "dino_features" in source:
                out["dino_features"] = source["dino_features"]
            for key, levels in features.items():
                for i, level in enumerate(levels):
                    out[f"sam_features/{key}/{i}"] = level
        else:
            out["dino_features"] = features
        return self.write_hdf(Path(dst_dir) / tomo_name, out)

    def patches(self):
        import numpy as np

        from cryovit_tpu_torch.callbacks import TestPredictionWriter
        from cryovit_tpu_torch.data.datasets import TomoDataset
        from cryovit_tpu_torch.run import dino_features, sam_features

        store = self

        def tomo_read(ds, tomo_path):
            arrays = store.files[Path(tomo_path)]
            if ds.input_key not in arrays:
                raise KeyError(f"{tomo_path}: missing input key {ds.input_key!r}")
            if f"labels/{ds.label_key}" not in arrays:
                raise KeyError(f"{tomo_path}: missing label key labels/{ds.label_key!r}")
            aux = {}
            for key in ds.aux_keys:
                if key == "sam_features":
                    names = sorted({k.split("/")[1] for k in arrays if k.startswith(key + "/")})
                    aux[key] = {n: [arrays[f"{key}/{n}/{i}"] for i in range(
                        sum(k.startswith(f"{key}/{n}/") for k in arrays))] for n in names}
                elif key in arrays:
                    aux[key] = arrays[key]
            return (np.asarray(arrays[ds.input_key]),
                    np.asarray(arrays[f"labels/{ds.label_key}"]).astype(np.int8), aux)

        def pred_write(writer, path, data, label, preds):
            store.write_hdf(path, {"data": data, writer.label_key: label,
                                   f"{writer.label_key}_preds": preds})

        return [(dino_features, "_read_source", self.read_source),
                (dino_features, "save_feature_hdf", self.save_feature_hdf),
                (sam_features, "save_feature_hdf", self.save_feature_hdf),
                (TomoDataset, "_read", tomo_read),
                (TestPredictionWriter, "_write", pred_write)]


@contextlib.contextmanager
def _patched(patches):
    """Set each ``(owner, name, value)`` for the block; restore after."""
    saved = [(owner, name, owner.__dict__[name]) for owner, name, _ in patches]
    try:
        for owner, name, value in patches:
            setattr(owner, name, value)
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


def experiment_phase(dev: torch.device, workdir: Path) -> dict[str, int]:
    """The experiment mode (``python -m cryovit_tpu_torch.training.*``)
    through ``sweep_main``, on a synthetic data tree of EXP_SAMPLES, each
    EXP_TOMOGRAMS blob tomograms of EXP_DEPTH x SIDE² uint8 with labels, and
    its ``csv/splits.csv`` (split_id i % 2): the ``dino_features`` sweep
    (full-width ViT-g/14, seeded weights, ``+random_init=true``) writes the
    training-ready files; the ``sam_features`` sweep (Hiera-L, seeded,
    ``sample=Young``, batch 64) writes Young's pyramids to a tree of their
    own; ``train_model`` (``model=cryovit datamodule=single
    datamodule.sample=AD datamodule.split_id=1 datamodule.test_sample=Young
    trainer.max_epochs=EXP_EPOCHS logger={}``: the full-width decoder in
    bf16) and ``eval_model`` on the same overrides. Checks: each stage's
    launches, worked out from its steps; the composed recipe in the trainer
    (AdamW lr 1e-4 from ``model/cryovit.yaml``, SWA from 0.8, the composed
    max_epochs); the sweep's features bit for bit ``DinoExtractor.extract``'s
    of the same tomogram with the same weights; ``weights.pt`` under
    ``<name>/AD/split_1`` and eval's module holding it; one metrics row per
    Young tomogram, each metric in [0, 1]. Without h5py only the HDF5 file
    layer is replaced (``_HDF5Store``). Wall time, peak device memory and
    launches per stage."""
    import csv
    import importlib.util

    import numpy as np

    from cryovit_tpu_torch import kernels
    from cryovit_tpu_torch.config import validate_dino_config, validate_experiment_config
    from cryovit_tpu_torch.io import write_hdf
    from cryovit_tpu_torch.io.hdf import read_hdf
    from cryovit_tpu_torch.run import common, dino_features, eval_model, sam_features, train_model
    from cryovit_tpu_torch.train.swa import StochasticWeightAveraging
    from cryovit_tpu_torch.training import sweep_main

    name = torch.cuda.get_device_name(0)
    data_dir, exp_dir = workdir / "exp_data", workdir / "exp_results"
    store = _HDF5Store() if importlib.util.find_spec("h5py") is None else None
    patches = store.patches() if store is not None else []
    if store is not None:
        log("exp", "h5py is not installed here: the HDF5 file layer is replaced by an in-memory "
            "store keyed by path, only these functions: " + ", ".join(_HDF5Store.REPLACED)
            + "; the composer, validators, split records, datasets above their read, "
            "DataLoader, Trainer, CsvWriter and weights.pt are the port's own")
    write_source = store.write_hdf if store is not None else write_hdf

    def read_back(path, key):
        return store.read(path, key) if store is not None else read_hdf(path, key=key)[1]

    t0 = time.perf_counter()
    rng = np.random.default_rng(21)
    rows, volumes = [], {}
    for sample in EXP_SAMPLES:
        for i in range(EXP_TOMOGRAMS):
            vol, label = blob_tomogram(rng, EXP_DEPTH, SIDE)
            tomo = f"blobs_{i}.hdf"
            write_source(data_dir / "dino_features" / sample / tomo,
                         {"data": vol, "labels/mito": label})
            rows.append({"sample": sample, "tomo_name": tomo, "split_id": i % 2})
            volumes[sample, tomo] = vol
    (data_dir / "csv").mkdir(parents=True)
    with open(data_dir / "csv" / "splits.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["sample", "tomo_name", "split_id"])
        writer.writeheader()
        writer.writerows(rows)
    log("exp", f"data tree: {len(rows)} blob tomograms {EXP_DEPTH}x{SIDE}x{SIDE} uint8 with "
        f"labels in {', '.join(EXP_SAMPLES)}, csv/splits.csv; {time.perf_counter() - t0:.1f} s")

    paths = [f"paths.data_dir={data_dir}", f"paths.exp_dir={exp_dir}",
             f"paths.model_dir={workdir / 'exp_models'}"]
    built, tested, stages = [], [], {}
    build_trainer = common.build_trainer

    def recording_build_trainer(cfg, device=None, extra_callbacks=None):
        trainer = build_trainer(cfg, device, extra_callbacks)
        test = trainer.test

        def recording_test(model, datamodule, module=None):
            tested.append(module)
            return test(model, datamodule, module)

        trainer.test = recording_test
        built.append(trainer)
        return trainer

    def stage(label, config_name, run_fn, validate_fn, overrides, want):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with _patched(patches + [(common, "build_trainer", recording_build_trainer)]):
            rc = sweep_main(config_name, run_fn, validate_fn,
                            paths + overrides + ["--device", dev.type])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        stages[label] = counts
        log("exp", f"{label}: {time.perf_counter() - t0:.2f} s wall, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({name}); launches "
            f"{ {k: n for k, n in counts.items() if n} }")
        if rc != 0:
            raise AssertionError(f"experiment phase: {label} exited {rc}")
        want = {k: want.get(k, 0) for k in kernels.KERNELS}
        return {f"{label}: launches { {k: n for k, n in want.items() if n} }": counts == want}

    checks = {}
    n_tomos = len(rows)
    checks.update(stage("dino_features sweep", "dino_features", dino_features.run_trainer,
                        validate_dino_config, ["+random_init=true", "export_features=true"],
                        {"flash_attention": 40 * n_tomos * -(-EXP_DEPTH // 128)}))
    # export_features=true: each tomogram's PCA maps under exp_dir/dino_images
    from cryovit_tpu_torch.visualization._image import read_png

    pngs = sorted((exp_dir / "dino_images").rglob("*.png"))
    want_pngs = sorted(exp_dir / "dino_images" / r["sample"] / Path(r["tomo_name"]).stem / f"{z}.png"
                       for r in rows for z in range(0, EXP_DEPTH, 10))
    checks[f"export_features wrote {len(want_pngs)} PCA maps, {SIDE}x{2 * SIDE} RGB"] = (
        pngs == want_pngs and read_png(pngs[0]).shape == (SIDE, 2 * SIDE, 3))
    log("exp", f"export_features: {len(pngs)} PNGs under {(exp_dir / 'dino_images').name}/"
        f"<sample>/<stem>/ (e.g. {pngs[0].relative_to(exp_dir) if pngs else None})")
    # the sweep's features against DinoExtractor's on the same weights
    ad0 = data_dir / "tomograms" / "AD" / "blobs_0.hdf"
    feats = read_back(ad0, "dino_features")
    with torch.no_grad():
        extractor = dino_features.DinoExtractor(
            dino_features.load_extractor(random_init=True, device=dev), batch_size=128)
        want_feats = extractor.extract(volumes["AD", "blobs_0.hdf"])
    del extractor
    torch.cuda.empty_cache()
    gh = SIDE // 16
    checks[f"sweep features (1536, {EXP_DEPTH}, {gh}, {gh}) fp16 bit for bit DinoExtractor's"] = (
        feats.shape == (1536, EXP_DEPTH, gh, gh) and feats.dtype == np.float16
        and np.array_equal(feats, want_feats))
    checks["training-ready files keep data and labels"] = all(
        np.array_equal(read_back(data_dir / "tomograms" / s / t, "data"), v)
        for (s, t), v in volumes.items())
    log("exp", f"sweep features AD/blobs_0: std {feats.astype(np.float32).std():.4f}; "
        f"equal to DinoExtractor.extract's: {np.array_equal(feats, want_feats)}")

    young = [r for r in rows if r["sample"] == "Young"]
    checks.update(stage("sam_features sweep", "sam_features", sam_features.run_trainer,
                        validate_dino_config,
                        ["sample=Young", "+random_init=true", "batch_size=64",
                         "paths.tomo_name=sam_tomograms"],
                        {k: n * len(young) * -(-EXP_DEPTH // 64)
                         for k, n in SAM_BATCH_LAUNCHES.items()}))
    shapes = [(EXP_DEPTH, 256, SIDE // s, SIDE // s) for s in (4, 8, 16)]
    pyramids = [[read_back(data_dir / "sam_tomograms" / "Young" / r["tomo_name"],
                           f"sam_features/{key}/{i}") for i in range(3)]
                for r in young for key in ("backbone_fpn", "vision_pos_enc")]
    checks[f"Young's pyramids {shapes} fp16, finite"] = all(
        [p.shape for p in levels] == shapes and all(p.dtype == np.float16 for p in levels)
        and all(bool(np.isfinite(p).all()) for p in levels) for levels in pyramids)

    train_rows = [r for r in rows if r["sample"] == "AD" and r["split_id"] != 1]
    val_rows = [r for r in rows if r["sample"] == "AD" and r["split_id"] == 1]
    steps, vals = EXP_EPOCHS * len(train_rows), EXP_EPOCHS * len(val_rows)
    exp_ov = ["model=cryovit", "datamodule=single", "label_key=mito", "datamodule.sample=AD",
              "datamodule.split_id=1", "datamodule.test_sample=Young"]
    checks.update(stage("train_model", "train_model", train_model.run_trainer,
                        validate_experiment_config,
                        exp_ov + [f"trainer.max_epochs={EXP_EPOCHS}", "logger={}"],
                        {k: steps * TRAIN_STEP_LAUNCHES[k] + vals * DECODER_FORWARD_LAUNCHES[k]
                         for k in KERNELS}))
    trainer = built[-1]
    swa = next(c for c in trainer.callbacks if isinstance(c, StochasticWeightAveraging))
    lr = trainer.optimizer.param_groups[0]["lr"]
    checks["the composed recipe in the trainer: lr 1e-4, SWA from 0.8 (swa_lrs 1e-4), "
           f"max_epochs {EXP_EPOCHS}, bf16"] = (
        lr == 1e-4 and swa.swa_epoch_start == 0.8 and swa.swa_lrs == 1e-4
        and trainer.max_epochs == EXP_EPOCHS and trainer.precision == "bf16"
        and trainer.step == steps)
    log("exp", f"trainer: AdamW lr {lr}, SWA from {swa.swa_epoch_start} of {trainer.max_epochs} "
        f"epochs, precision {trainer.precision}, {trainer.step} steps; last logs "
        f"{ {k: round(v, 4) for k, v in trainer.logged.items()} }")
    run_name = "single_any_cryovit_mito"
    weights = exp_dir / run_name / "AD" / "split_1" / "weights.pt"
    checks[f"{weights.relative_to(exp_dir)} written"] = weights.exists()
    del trainer, built[:]
    torch.cuda.empty_cache()

    checks.update(stage("eval_model", "eval_model", eval_model.run_trainer,
                        validate_experiment_config, exp_ov,
                        {k: len(young) * n for k, n in DECODER_FORWARD_LAUNCHES.items()}))
    saved = torch.load(weights, map_location="cpu", weights_only=True)
    module = tested[-1]
    checks["eval's module holds weights.pt bit for bit"] = all(
        torch.equal(v.detach().cpu(), saved[k]) for k, v in module.state_dict().items()
    ) and set(module.state_dict()) == set(saved)
    with open(exp_dir / "results" / run_name / "Young.csv", newline="") as f:
        metrics = list(csv.DictReader(f))
    log("exp", f"metrics CSV results/{run_name}/Young.csv: {metrics}")
    checks[f"one metrics row per Young tomogram ({len(young)}), each metric in [0, 1]"] = (
        sorted(r["tomo_name"] for r in metrics) == sorted(r["tomo_name"] for r in young)
        and all(0.0 <= float(r[k]) <= 1.0 for r in metrics for k in ("dice_metric", "f1_metric")))
    predictions = exp_dir / "predictions" / run_name / "Young"
    checks["TestPredictionWriter wrote each Young tomogram"] = all(
        (predictions / r["tomo_name"]).exists() for r in young)
    del module, tested[:]
    torch.cuda.empty_cache()
    _report_checks(checks, "experiment mode")
    return {k: sum(c[k] for c in stages.values()) for k in kernels.KERNELS}


def unet3d_training_phase(dev: torch.device, workdir: Path) -> dict[str, int]:
    """``cryovit-torch train --model unet3d`` one step below its file
    readers, at full width and the reference crop: a synthetic TRAIN_DEPTH x
    SIDE² blob tomogram's raw voxels, ``Trainer.fit`` for UNET_EPOCHS epochs
    (bf16 on f32 master weights, AdamW at lr 3e-3, SWA from 80 %, a
    validation epoch each), the ``.model`` reloaded and scored by
    ``Trainer.test``. One isolated step's launches (UNET_STEP_LAUNCHES),
    the median of 5 train steps, voxels/s, epoch_time_s, peak device memory
    and a profile of one step."""
    import numpy as np

    from cryovit_tpu_torch import kernels
    from cryovit_tpu_torch.callbacks import CsvWriter
    from cryovit_tpu_torch.config import MODELS, TrainConfig
    from cryovit_tpu_torch.run.eval_model import load_for_eval
    from cryovit_tpu_torch.run.train_model import build_file_datamodule, build_model, build_trainer
    from cryovit_tpu_torch.train.checkpoint import save_model
    from cryovit_tpu_torch.train.loop import Trainer

    name = torch.cuda.get_device_name(0)
    tomo, label = blob_tomogram(np.random.default_rng(17), TRAIN_DEPTH, SIDE)
    volume = tomo.astype(np.float32) / 255.0
    data_path, label_path = workdir / "unet_tomos" / "blobs.hdf", workdir / "unet_labels" / "blobs.hdf"
    dataset_cls = _array_dataset(volume[None], label, volume, (data_path, label_path))
    cfg = TrainConfig(label_key="mito", name="smoke_unet3d", model=MODELS["unet3d"])
    cfg = dataclasses.replace(cfg, trainer=dataclasses.replace(cfg.trainer, max_epochs=UNET_EPOCHS))
    datamodule = build_file_datamodule(cfg, [data_path], [label_path], labels=["mito"],
                                       dataset_cls=dataset_cls)
    trainer = build_trainer(cfg, device=dev, root_dir=workdir)
    rec = _Recorder(trainer)
    trainer.loggers.append(rec)
    log("unet3d", f"synthetic {TRAIN_DEPTH}x{SIDE}x{SIDE} blob tomogram as raw voxels (the "
        "dataset returns the arrays of its HDF5, as in the training phase); UNet3D at full width "
        f"(1->16->64->256, bottom 384), bf16 on f32 masters, {UNET_EPOCHS} epochs")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    module = trainer.fit(build_model(cfg), datamodule)
    model_path = save_model("smoke_unet3d", "mito", module, workdir / "smoke_unet3d.model")
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    peak_fit = torch.cuda.max_memory_allocated()
    eval_module, ecfg = load_for_eval(model_path, dev)
    csv_dir = ecfg.csv_dir(workdir / "unet_eval")
    tester = Trainer(**dataclasses.asdict(ecfg.trainer), callbacks=[CsvWriter(csv_dir)],
                     device=dev)
    (result,) = tester.test(build_model(ecfg), datamodule, eval_module)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    del eval_module

    losses = rec.series("train_dice_loss")
    log("unet3d", f"Trainer.fit: {UNET_EPOCHS} epochs of one {TRAIN_DEPTH}x{SIDE}x{SIDE} crop in "
        f"{t_fit:.1f} s; train_dice_loss {' '.join(f'{v:.4f}' for v in losses)}; "
        f"val_dice_metric {' '.join(f'{v:.4f}' for v in rec.series('val_dice_metric'))}")
    log("unet3d", f"epoch_time_s {' '.join(f'{v:.3f}' for v in rec.series('epoch_time_s'))} "
        f"({name})")
    log("unet3d", f"peak device memory during fit {peak_fit / 2**30:.2f} GiB ({name})")
    log("unet3d", f"Trainer.test on the reloaded .model: metrics {result.metrics}, losses "
        f"{result.losses}; launches during fit, .model and test: {counts}")

    batch, _ = next(iter(datamodule.train_loader()))
    data, target = trainer.to_device(batch)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(data, target)
    torch.cuda.synchronize()
    step_counts = kernels.launch_counts()
    peak_step = torch.cuda.max_memory_allocated()
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
    log("unet3d", f"train step at {TRAIN_DEPTH}x{SIDE}x{SIDE} voxels (batch 1, bf16): median of 5 "
        f"{step_ms:.2f} ms (all {' '.join(f'{t:.2f}' for t in times)}) = "
        f"{voxels / step_ms * 1e3 / 1e6:.1f} M voxels/s; peak device memory of one step "
        f"{peak_step / 2**30:.2f} GiB ({name})")
    log("unet3d", f"launches in one train step: {step_counts}")
    _profile(lambda: trainer.train_step(data, target), "one UNet3D train step",
             UNET_PROFILE_GROUPS, "the rest (optimizer, losses, reductions)", name)
    _report_checks({
        "every logged value finite": all(np.isfinite(v) for h in rec.history for v in h.values()),
        f"{len(losses)} train steps logged": len(losses) == UNET_EPOCHS,
        "last train_dice_loss below the first": losses[-1] < losses[0],
        "test metrics finite": all(np.isfinite(v) for v in result.metrics.values()),
        f"test predictions {(TRAIN_DEPTH, SIDE, SIDE)} in [0, 1]":
            result.preds[0].shape == (TRAIN_DEPTH, SIDE, SIDE)
            and bool(result.preds[0].min() >= 0.0 and result.preds[0].max() <= 1.0),
        f"one train step launches {UNET_STEP_NONZERO} and nothing else":
            step_counts == UNET_STEP_LAUNCHES,
        "every kernel of the path launched": counts["conv3d_dm"] > 0 and counts["conv3d_dm_dw"] > 0,
    }, "UNet3D training path")
    return counts


def _sam2_family(dtype, **custom):
    """The SAM2 family at ``default_sam.yaml``'s settings (lr 5e-5,
    prompt_lr 1e-4, cond slices [1, 1] / [True, False]), Dice loss and
    metric, computing in ``dtype``; ``custom`` overrides custom_kwargs."""
    from cryovit_tpu_torch.models import SAM2
    from cryovit_tpu_torch.models.losses import DiceLoss
    from cryovit_tpu_torch.models.metrics import DiceMetric

    return SAM2(name="SAM2", input_key="data", lr=5e-5, losses={"dice_loss": DiceLoss()},
                metrics={"dice_metric": DiceMetric(0.5)}, dtype=dtype,
                custom_kwargs={"prompt_lr": 1e-4, "num_init_cond_slices": (1, 1),
                               "rand_init_cond_slices": (True, False), **custom})


SAM2_REF_SIDE, SAM2_REF_DEPTH = 256, 32


def _sam2_group(name: str) -> str:
    """The group of a trained SAM2 leaf whose gradient is held as one vector."""
    if name.endswith((".w_a.weight", ".w_b.weight")):
        return "LoRA factors"
    if name == "model.no_mem_embed":
        return "no-memory embedding"
    return "prompt predictor" if name.startswith("prompt_predictor.") else "SAM2 embeddings"


def _group_agreement(got: dict, want: dict, names: list[str]) -> tuple[float, float]:
    """(1 − cosine, |ln(norm ratio)|) of the gradient of ``names`` taken as
    one vector: its direction and its size against the reference's. A zero
    gradient reads (1, inf), a sign-flipped one (2, 0)."""
    a = torch.cat([got[n].double().flatten() for n in names])
    b = torch.cat([want[n].double().flatten() for n in names])
    na, nb = a.norm().item(), b.norm().item()
    if na == 0.0:
        return 1.0, math.inf
    return 1.0 - (a @ b).item() / (na * nb), abs(math.log(na / nb))


def sam2_reference_phase(dev: torch.device) -> None:
    """One SAM2 train step at ``SAM2Config.tiny_test()``'s widths and
    SAM2_REF_SIDE² (a 64² stride-4 level: the prompt predictor's U-Net keeps
    2×4×4 voxels at its bottom) on SAM2_REF_DEPTH slices of a blob
    tomogram's raw voxels (the first slice unlabeled; LoRA rank 128; two
    cond slices, 0 and 3, first), seeded weights with the LoRA B factors
    and the object-score bias moved off their initial values so both factors
    and the masks carry signal: GPU bf16 against CPU f32, with two
    yardsticks against the same f32 run: the CPU's bf16 plain path, and CPU
    f32 on the input plus seeded noise of 1e-3 (a quarter of a grey level),
    which reads how far the step itself moves under a change that small.

    Readings: max|dprob|, |dloss| (Dice + mask_loss) and, per group of
    trained leaves (LoRA factors, prompt predictor, the no-memory embedding,
    the other SAM2 embeddings), the group gradient's direction (1 − cosine)
    and size (|ln norm ratio|) against f32 (_group_agreement). Limits: the
    train reference's (2e-2, 2e-4, 5e-2, 5e-2) or twice the larger
    yardstick reading, whichever is larger. Groups, not single tensors, are
    held: bf16 moves single prompt-predictor and embedding gradients by
    about 1 relative L2 or more (ten conv + instance-norm layers in the
    backward), as far as a zero gradient, while each group's direction
    stays within 0.03 of f32's. The no-memory embedding stands alone: it
    feeds only the two cond slices, and under the input noise its gradient
    moves in f32 alone (on an H100's host: norm 1.22×, 1 − cos 0.30, every
    other group under 0.014), which would widen the limits of the
    embeddings around it. The limits must reject a
    planted zero gradient and a sign-flipped GPU gradient in every group. A
    gradient a yardstick blew up (not finite, or beyond 1e3 × its group's
    largest f32 value) is named and left out of its readings; the GPU's
    must have none."""
    import numpy as np

    from cryovit_tpu_torch.models.base import prediction_mask
    from cryovit_tpu_torch.models.sam2.model import random_sam2_state_dict

    def family(dtype):
        fam = _sam2_family(dtype, test_config=True, num_init_cond_slices=(2, 1))
        fam.sam_cfg = dataclasses.replace(fam.sam_cfg, image_size=SAM2_REF_SIDE)
        return fam

    sd = random_sam2_state_dict(family(torch.float32).sam_cfg, torch.Generator().manual_seed(31))
    gen = torch.Generator().manual_seed(32)
    for k in sd:
        if k.endswith(".w_b.weight"):
            sd[k] = 0.02 * torch.randn(sd[k].shape, generator=gen)
    sd["model.sam_mask_decoder.pred_obj_score_head.layers.2.bias"].fill_(3.0)
    tomo, label = blob_tomogram(np.random.default_rng(33), SAM2_REF_DEPTH, SAM2_REF_SIDE,
                                unlabeled=1)
    x = torch.from_numpy(tomo.astype(np.float32) / 255.0)[None, ..., None]
    noisy = x + 1e-3 * torch.randn(x.shape, generator=torch.Generator().manual_seed(34))
    label = torch.from_numpy(label)[None]
    inputs = {"order": [0, 3] + [i for i in range(SAM2_REF_DEPTH) if i not in (0, 3)],
              "num_cond": 2}
    cpu = torch.device("cpu")
    out = {}
    yardsticks = ("CPU bf16", "CPU f32, input + 1e-3 noise")
    for what, device, dtype, vox in (("GPU bf16", dev, torch.bfloat16, x),
                                     ("CPU bf16", cpu, torch.bfloat16, x),
                                     ("CPU f32", cpu, torch.float32, x),
                                     (yardsticks[1], cpu, torch.float32, noisy)):
        fam = family(dtype)
        module = fam.build_module(sd, device)
        y = label.to(device)
        preds, aux = fam.apply_with_aux(module, {"slices": vox.to(device), **inputs})
        losses = fam.compute_losses(preds, y, prediction_mask(y), aux=aux)
        losses["total"].backward()
        out[what] = (preds.detach().float().cpu(), losses["total"].item(),
                     {n: p.grad.float().cpu() for n, p in module.named_parameters()
                      if p.grad is not None})
    p_ref, loss_ref, g_ref = out["CPU f32"]

    group = _sam2_group
    groups = sorted({group(n) for n in g_ref})
    largest = {g: max(g_ref[n].abs().max().item() for n in g_ref if group(n) == g) for g in groups}

    def kept(grads):
        return [n for n in g_ref if bool(torch.isfinite(grads[n]).all())
                and grads[n].abs().max().item() <= 1e3 * largest[group(n)]]

    def readings(probs, loss, grads, names):
        r = [(probs - p_ref).abs().max().item(), abs(loss - loss_ref)]
        for g in groups:
            r += _group_agreement(grads, g_ref, [n for n in names if group(n) == g])
        return r

    shape = f"1x{SAM2_REF_DEPTH}x{SAM2_REF_SIDE}x{SAM2_REF_SIDE}"
    kept_names, read = {}, {}
    for what in ("GPU bf16", *yardsticks):
        probs, loss, grads = out[what]
        kept_names[what] = kept(grads)
        if len(kept_names[what]) < len(g_ref):
            log("sam2-ref", f"{what}: gradients blown up (left out of its readings): "
                f"{sorted(set(g_ref) - set(kept_names[what]))}")
        read[what] = readings(probs, loss, grads, kept_names[what])
        log("sam2-ref", f"{what} vs CPU f32, SAM2 tiny_test widths at {SAM2_REF_SIDE}² on {shape} "
            f"blob voxels, one train step: max|dprob| {read[what][0]:.4g}, loss {loss:.6f} vs "
            f"{loss_ref:.6f} (|diff| {read[what][1]:.3g}), gradient per group (1 - cos, "
            "|ln norm ratio|): " + ", ".join(
                f"{g} {read[what][2 + 2 * i]:.4g} {read[what][3 + 2 * i]:.4g}"
                for i, g in enumerate(groups)) + f" (prob std {p_ref.std().item():.3f})")
    tols = (2e-2, 2e-4) + (5e-2, 5e-2) * len(groups)
    limits = [max(tol, 2 * r, 2 * q) for tol, r, q in zip(tols, *(read[y] for y in yardsticks))]
    log("sam2-ref", f"limits (the train reference's, or twice the larger yardstick): max|dprob| "
        f"{limits[0]:.4g}, loss {limits[1]:.3g}, gradients " + ", ".join(
            f"{g} {limits[2 + 2 * i]:.4g} {limits[3 + 2 * i]:.4g}" for i, g in enumerate(groups)))

    # the limits' power: a zero and a sign-flipped GPU gradient, one group at
    # a time, must each read beyond a limit of that group
    g_gpu = out["GPU bf16"][2]
    caught = {}
    for fault, change in (("zero", torch.zeros_like), ("sign-flipped", torch.neg)):
        for i, g in enumerate(groups):
            planted = {n: change(v) if group(n) == g else v for n, v in g_gpu.items()}
            r = readings(*out["GPU bf16"][:2], planted, list(g_ref))[2 + 2 * i: 4 + 2 * i]
            caught[f"{fault} {g}"] = any(v > lim for v, lim in zip(r, limits[2 + 2 * i: 4 + 2 * i]))
    log("sam2-ref", "planted faults read beyond a limit: "
        + ", ".join(f"{k} {v}" for k, v in caught.items()))
    _report_checks({
        "GPU bf16 probabilities, loss and trained gradients within the limits":
            all(r <= lim for r, lim in zip(read["GPU bf16"], limits)),
        "the limits reject a zero and a sign-flipped gradient in every group": all(caught.values()),
        "probabilities vary (the gate passes masks)": float(p_ref.std()) > 1e-3,
        "LoRA A and B factors both get gradients": all(
            float(g_ref[n].norm()) > 0 for n in g_ref if n.endswith((".w_a.weight", ".w_b.weight"))),
        "GPU probabilities finite and no gradient blown up":
            bool(np.isfinite(out["GPU bf16"][0].numpy()).all())
            and len(kept_names["GPU bf16"]) == len(g_ref),
    }, "SAM2 train reference")


def sam2_training_phase(dev: torch.device, workdir: Path) -> dict[str, int]:
    """``cryovit-torch train --model sam2`` one step below its file readers,
    at full width and the reference crop: a synthetic TRAIN_DEPTH x SIDE²
    blob tomogram's raw voxels; ``Trainer.fit`` of SAM2Config.large()
    (sam2.1_hiera_l at 512², d_model 256, LoRA r = α = 128) for SAM2_EPOCHS
    epochs, bf16 on f32 masters, AdamW lr 5e-5 and prompt_lr 1e-4, batch 1,
    cond slices [1, 1] / [True, False], the frozen encoder run live on every
    step (no cached pyramids), seeded weights (the object-score bias at +3);
    the ``.model`` saved, reloaded and run by one
    ``Trainer.test`` and one ``Trainer.predict``. Then one isolated step's
    launches (SAM2_STEP_LAUNCHES), the median of 5 train steps, a step split
    into encoder forward / heads forward / heads backward / optimizer (CUDA
    events, and host wall with a sync at each boundary), a profile of the
    encoder forward and of a whole step (device busy share), peak memory,
    epoch times, and device ms of one test and one predict step."""
    import numpy as np

    from cryovit_tpu_torch import kernels
    from cryovit_tpu_torch.callbacks import CsvWriter
    from cryovit_tpu_torch.config import MODELS, TrainConfig
    from cryovit_tpu_torch.models.sam2.family import LORA_RANK
    from cryovit_tpu_torch.models.sam2.model import random_sam2_state_dict
    from cryovit_tpu_torch.run.eval_model import load_for_eval
    from cryovit_tpu_torch.run.train_model import build_file_datamodule, build_model, build_trainer
    from cryovit_tpu_torch.train.checkpoint import save_model
    from cryovit_tpu_torch.train.loop import Trainer

    name = torch.cuda.get_device_name(0)
    tomo, label = blob_tomogram(np.random.default_rng(19), TRAIN_DEPTH, SIDE)
    volume = tomo.astype(np.float32) / 255.0
    data_path, label_path = workdir / "sam2_tomos" / "blobs.hdf", workdir / "sam2_labels" / "blobs.hdf"
    dataset_cls = _array_dataset(volume[None], label, volume, (data_path, label_path))
    # the live encoder (default_sam.yaml caches pyramids where a file has them;
    # these arrays have none)
    model_cfg = dataclasses.replace(MODELS["sam2"], custom_kwargs=tuple(
        (k, False if k == "use_cache_features" else v) for k, v in MODELS["sam2"].custom_kwargs))
    # train --model sam2's recipe (its trainer clips the gradients' norm at 1,
    # trainer_model/sam2.yaml) with the live encoder
    cfg = dataclasses.replace(TrainConfig.for_model("sam2", "mito", name="smoke_sam2"),
                              model=model_cfg)
    cfg = dataclasses.replace(cfg, trainer=dataclasses.replace(cfg.trainer, max_epochs=SAM2_EPOCHS))
    datamodule = build_file_datamodule(cfg, [data_path], [label_path], labels=["mito"],
                                       dataset_cls=dataset_cls)
    trainer = build_trainer(cfg, device=dev, root_dir=workdir)
    rec = _Recorder(trainer)
    trainer.loggers.append(rec)
    model = build_model(cfg)
    # seeded random weights drawn on the card; the object-score head's last
    # bias at +3 so the masks pass the gate (with random weights it closes on
    # every slice: the probabilities are all 0 and the Dice term has no
    # gradient, leaving only the prompt loss)
    variables = random_sam2_state_dict(model.sam_cfg, torch.Generator(device=dev).manual_seed(18))
    variables["model.sam_mask_decoder.pred_obj_score_head.layers.2.bias"].fill_(3.0)
    log("sam2", f"synthetic {TRAIN_DEPTH}x{SIDE}x{SIDE} blob tomogram as raw voxels; SAM2 "
        f"{model.sam_cfg.image_size}² Hiera-L + heads at full width (d_model "
        f"{model.sam_cfg.d_model}, LoRA r {LORA_RANK}), bf16 on f32 masters, lr "
        f"{model.lr} / prompt_lr {model.prompt_lr}, {SAM2_EPOCHS} epochs, live encoder")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    module = trainer.fit(model, datamodule, variables=variables)
    del variables
    model_path = save_model("smoke_sam2", "mito", module, workdir / "smoke_sam2.model")
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    peak_fit = torch.cuda.max_memory_allocated()
    eval_module, ecfg = load_for_eval(model_path, dev)
    emodel = build_model(ecfg)
    tester = Trainer(**dataclasses.asdict(ecfg.trainer), callbacks=[CsvWriter(ecfg.csv_dir(workdir))],
                     device=dev)
    (result,) = tester.test(emodel, datamodule, eval_module)
    (predicted,) = tester.predict(datamodule, eval_module, emodel)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    same_weights = all(torch.equal(a, b) for a, b in zip(module.state_dict().values(),
                                                         eval_module.state_dict().values()))

    losses = rec.series("train_dice_loss")
    log("sam2", f"Trainer.fit: {SAM2_EPOCHS} epochs of one crop in {t_fit:.1f} s; train_dice_loss "
        f"{' '.join(f'{v:.4f}' for v in losses)}; train_mask_loss "
        f"{' '.join(f'{v:.4f}' for v in rec.series('train_mask_loss'))}; val_dice_metric "
        f"{' '.join(f'{v:.4f}' for v in rec.series('val_dice_metric'))}")
    log("sam2", f"epoch_time_s {' '.join(f'{v:.3f}' for v in rec.series('epoch_time_s'))} ({name})")
    log("sam2", f"peak device memory during fit {peak_fit / 2**30:.2f} GiB ({name})")
    log("sam2", f"Trainer.test on the reloaded .model: metrics {result.metrics}, losses "
        f"{result.losses}; launches during fit, .model, test and predict: {counts}")

    # one test and one predict step on the device
    batch, items = next(iter(datamodule.test_loader()))
    data, target = tester.to_device(batch)
    inputs = tester.prepare(emodel, data, items)
    step_ms = {}
    for what, run in (("test", lambda: tester.eval_step(eval_module, emodel, inputs, target)),
                      ("predict", lambda: tester.predict_step(eval_module, inputs, emodel))):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        torch.cuda.synchronize()
        step_ms[what] = start.elapsed_time(stop)
    log("sam2", f"device ms of one Trainer step on the {TRAIN_DEPTH}-slice tomogram: test "
        f"{step_ms['test']:.2f}, predict {step_ms['predict']:.2f} ({name})")
    del eval_module

    batch, items = next(iter(datamodule.train_loader()))
    data, target = trainer.to_device(batch)
    model.train_mode = True
    inputs = trainer.prepare(model, data, items)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(inputs, target)
    torch.cuda.synchronize()
    step_counts = kernels.launch_counts()
    peak_step = torch.cuda.max_memory_allocated()
    times = []
    for _ in range(5):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.train_step(inputs, target)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    median = statistics.median(times)
    log("sam2", f"train step at {TRAIN_DEPTH}x{SIDE}x{SIDE} voxels (batch 1, bf16, live encoder): "
        f"median of 5 {median:.2f} ms (all {' '.join(f'{t:.2f}' for t in times)}) = "
        f"{TRAIN_DEPTH / median * 1e3:.1f} slices/s; peak device memory of one step "
        f"{peak_step / 2**30:.2f} GiB ({name})")
    log("sam2", f"launches in one train step: {step_counts}")

    # the step split: the train step's own calls, one phase at a time
    from cryovit_tpu_torch.models.base import prediction_mask

    optimizer = trainer.optimizer
    events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    walls = []
    torch.cuda.synchronize()
    walls.append(time.perf_counter())
    events[0].record()
    backbone = module.encode_images(data[..., 0].reshape(-1, SIDE, SIDE))
    events[1].record()
    torch.cuda.synchronize()
    walls.append(time.perf_counter())
    optimizer.zero_grad(set_to_none=True)
    preds, aux = model.apply_with_aux(module.train(), {"slices": data, "backbone": backbone})
    loss = model.compute_losses(preds, target, prediction_mask(target), aux=aux)["total"]
    events[2].record()
    torch.cuda.synchronize()
    walls.append(time.perf_counter())
    loss.backward()
    events[3].record()
    torch.cuda.synchronize()
    walls.append(time.perf_counter())
    optimizer.step()
    events[4].record()
    torch.cuda.synchronize()
    walls.append(time.perf_counter())
    parts = ("encoder forward (no_grad)", "heads forward + losses", "heads backward",
             "AdamW (2 groups)")
    log("sam2", "train step split, device ms (CUDA events) / host ms (wall, synced): " + "; ".join(
        f"{part} {events[i].elapsed_time(events[i + 1]):.2f} / {(walls[i + 1] - walls[i]) * 1e3:.2f}"
        for i, part in enumerate(parts)) + f" ({name})")
    del backbone, preds, aux, loss
    _profile(lambda: module.encode_images(data[..., 0].reshape(-1, SIDE, SIDE)),
             f"the frozen encoder's forward in a SAM2 train step ({TRAIN_DEPTH} slices, 2 chunks)",
             SAM_PROFILE_GROUPS, "plain PyTorch (elementwise, norms, softmax, copies)", name)
    busy = _profile(lambda: trainer.train_step(inputs, target), "one SAM2 train step",
                    SAM2_PROFILE_GROUPS, "the rest (elementwise, norms, reductions, copies)", name,
                    top=15, host_ops=False)
    log("sam2", f"device busy share of a train step: {busy:.2f} ms of the {median:.2f} ms median "
        f"step = {100 * busy / median:.1f} % ({name})")
    probs = result.preds[0]
    _report_checks({
        "every logged value finite": all(np.isfinite(v) for h in rec.history for v in h.values()),
        f"{len(losses)} train steps logged": len(losses) == SAM2_EPOCHS,
        "the reloaded .model holds the trained weights bit for bit": same_weights,
        "test metrics finite": all(np.isfinite(v) for v in result.metrics.values()),
        f"test predictions {(TRAIN_DEPTH, SIDE, SIDE)} in [0, 1]":
            probs.shape == (TRAIN_DEPTH, SIDE, SIDE) and bool(probs.min() >= 0 and probs.max() <= 1),
        "predict agrees with test within 1e-3":
            float(np.abs(predicted.preds[0] - probs).max()) <= 1e-3,
        f"one train step launches {SAM2_STEP_NONZERO} and nothing else":
            step_counts == SAM2_STEP_LAUNCHES,
        "every kernel of the path launched": all(counts[k] > 0 for k in SAM2_STEP_NONZERO),
    }, "SAM2 training path")
    del trainer
    torch.cuda.empty_cache()
    kv_counts = sam2_kv_cache_check(dev, module, volume)
    del module
    torch.cuda.empty_cache()
    return counts, kv_counts


def _tracking_agreement(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max|dprob|, share of voxels whose 0.5-mask differs)."""
    return ((got - want).abs().max().item(),
            ((got > 0.5) != (want > 0.5)).float().mean().item())


def sam2_kv_cache_check(dev: torch.device, module, volume) -> dict[str, int]:
    """``kv_cache``: the tracking pass of the trained SAM2 module with the
    live Hiera-L encoder on KV_SLICES slices of the phase's tomogram, under
    ``torch.no_grad``, uncached and then cached (``kv_cache=True``), with
    the same weights, prompts, natural order and one cond slice. Readings:
    max|dprob| and the share of voxels whose 0.5-mask differs between the
    two. Limits: twice the CPU's bf16 reading (bf16 against f32, uncached)
    of the same pass at ``SAM2Config.tiny_test()``'s widths at
    SAM2_REF_SIDE² on KV_SLICES blob slices, or 2e-2 and 1e-3 where those
    are larger; on the CPU in f32 the two paths must agree within 1e-4.
    Cost: a warm-up pass of each path, then two timed passes of each in
    turns (uncached, cached, cached, uncached): device ms (CUDA events) and
    host wall of each, per slice, and each pass's launches per slice
    (exactly 32/32/3 of rows 9-11 a pass, one 64-slice encoder chunk)."""
    import numpy as np

    from cryovit_tpu_torch import kernels
    from cryovit_tpu_torch.models.sam2.model import random_sam2_state_dict

    name = torch.cuda.get_device_name(0)
    x = torch.from_numpy(volume[:KV_SLICES]).to(dev)[None, ..., None]
    module.eval()
    runs, launches, total = {}, [], None
    # a warm-up pass of each path, then the timed passes in turns
    for turn, cached in enumerate((False, True, False, True, True, False)):
        module.kv_cache = cached
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        with torch.no_grad():
            preds = module(x)["preds"].float()
        stop.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        launches.append(counts)
        total = counts if total is None else {k: total[k] + n for k, n in counts.items()}
        runs[cached] = preds
        per = {k: n / KV_SLICES for k, n in counts.items() if n}
        log("sam2-kv", f"tracking pass {turn} ({'warm-up, ' if turn < 2 else ''}"
            f"{'cached, kv_cache=True' if cached else 'uncached'}), 1x{KV_SLICES}x{SIDE}x{SIDE}, "
            f"live Hiera-L, bf16: device {start.elapsed_time(stop):.2f} ms = "
            f"{start.elapsed_time(stop) / KV_SLICES:.3f} ms/slice, host wall {wall * 1e3:.2f} ms "
            f"= {wall * 1e3 / KV_SLICES:.3f} ms/slice; launches "
            f"{ {k: n for k, n in counts.items() if n} } = {per} per slice ({name})")
    module.kv_cache = False
    gpu = _tracking_agreement(runs[True], runs[False])

    # the yardstick: what bf16 moves the same pass on the CPU, at tiny widths
    def family(dtype):
        fam = _sam2_family(dtype, test_config=True)
        fam.sam_cfg = dataclasses.replace(fam.sam_cfg, image_size=SAM2_REF_SIDE)
        return fam

    sd = random_sam2_state_dict(family(torch.float32).sam_cfg, torch.Generator().manual_seed(41))
    gen = torch.Generator().manual_seed(42)
    for k in sd:
        if k.endswith(".w_b.weight"):
            sd[k] = 0.02 * torch.randn(sd[k].shape, generator=gen)
    sd["model.sam_mask_decoder.pred_obj_score_head.layers.2.bias"].fill_(3.0)
    tomo, _ = blob_tomogram(np.random.default_rng(43), KV_SLICES, SAM2_REF_SIDE, unlabeled=1)
    xc = torch.from_numpy(tomo.astype(np.float32) / 255.0)[None, ..., None]
    cpu_runs = {}
    for dtype in (torch.float32, torch.bfloat16):
        small = family(dtype).build_module(sd, torch.device("cpu"))
        for cached in (False, True):
            small.kv_cache = cached
            with torch.no_grad():
                cpu_runs[dtype, cached] = small(xc)["preds"].float()
    ref = cpu_runs[torch.float32, False]
    bf16 = _tracking_agreement(cpu_runs[torch.bfloat16, False], ref)
    f32_cached = _tracking_agreement(cpu_runs[torch.float32, True], ref)
    cpu_cached = _tracking_agreement(cpu_runs[torch.bfloat16, True], cpu_runs[torch.bfloat16, False])
    limits = (max(2e-2, 2 * bf16[0]), max(1e-3, 2 * bf16[1]))
    log("sam2-kv", f"cached vs uncached on the GPU: max|dprob| {gpu[0]:.4g}, mask agreement "
        f"{100 * (1 - gpu[1]):.4f} % (prob std {runs[False].std().item():.3f}); limits "
        f"{limits[0]:.4g} and {100 * limits[1]:.4f} % disagreement, from the CPU's bf16 vs f32 "
        f"reading of the uncached pass at tiny_test widths, {KV_SLICES}x{SAM2_REF_SIDE}²: "
        f"max|dprob| {bf16[0]:.4g}, {100 * bf16[1]:.4f} % of voxels; on the CPU cached vs "
        f"uncached: f32 {f32_cached[0]:.3g}, bf16 {cpu_cached[0]:.4g} / {100 * cpu_cached[1]:.4f} %")
    _report_checks({
        f"cached vs uncached on the GPU: max|dprob| <= {limits[0]:.4g}": gpu[0] <= limits[0],
        f"cached vs uncached on the GPU: mask disagreement <= {100 * limits[1]:.4f} %":
            gpu[1] <= limits[1],
        "cached vs uncached on the CPU in f32 within 1e-4": f32_cached[0] <= 1e-4,
        f"each run launches {SAM_BATCH_LAUNCHES} and nothing else": all(
            c == {k: SAM_BATCH_LAUNCHES.get(k, 0) for k in c} for c in launches),
        "GPU probabilities finite": all(bool(torch.isfinite(p).all()) for p in runs.values()),
    }, "SAM2 kv_cache")
    return total


# kernel-name fragments → the layer a device kernel belongs to
# ---- parallelism: ranks on the one card -----------------------------------------

# the parallel phase: PARALLEL_WORLD ranks on the one card, joined by a gloo
# group (NCCL refuses two ranks on one device); the crops of the training
# cell drawn from PARALLEL_SEED on the card, the decoder's weights from it
# on the host (mask head scaled as in the train reference)
PARALLEL_WORLD = 2
PARALLEL_SEED = 23
PARALLEL_TIMED = 3
# limits against the single process on the card, each the geometric mean
# of the largest sound reading and the smallest reading of the planted
# faults it separates, over PARALLEL_LIMIT_SEEDS (`--parallel-limits`; NVIDIA
# H100 80GB HBM3, 700.00 W): |Δ Dice loss| 2.62e-6 vs zero halos 1.17e-4;
# the worst gradient by _worst_gradient's rule 0.0398 vs averaged 0.5003;
# the median gradient by the same rule 2.21e-3 vs local norms 9.00e-3 (the
# worst leaf, bf16 noise of the 1536->1024 projection, cannot tell that
# fault, 0.096, from sound); the worst update (_update_error) 1.45e-3 vs
# zero halos 0.832. The features' relative L2: the serving reference's
# bf16 limit (the sharded extraction reads 0, bit for bit)
PARALLEL_LOSS, PARALLEL_GRAD, PARALLEL_GRAD_MEDIAN, PARALLEL_UPDATE = 1.7e-5, 0.14, 4.5e-3, 0.035
PARALLEL_FEATURES = 2e-2
PARALLEL_FAULTS = {
    "averaged": "gradients averaged over the ranks instead of summed",
    "zero halos": "every halo of the depth-dilated convs zero",
    "local norms": "GroupNorm's statistics over each rank's own slab",
    "swapped slots": "each rank's features gathered into the other rank's slot",
    "level-2 zero halos": "the halos of UNet3D's second level-2 analysis conv zero",
    "local instance norms": "UNet3D's InstanceNorm statistics over each rank's own slab",
    "wrong slab": "rank 0's encoder fed rank 1's slab of the slices",
    "summed": "the encoder-split step's gradients summed over the ranks (each rank's are "
              "already the whole batch's)",
}
# `chip_smoke.py --parallel-limits`: the seeds whose sound and faulty
# readings the limits above are set between
PARALLEL_LIMIT_SEEDS = (23, 24, 25, 26, 27)
# UNet3D's depth-sharded step: its gradients held level by level, each
# level's leaves as one vector (_group_agreement), and its faults
UNET_PARALLEL = "unet3d depth-sharded"
UNET_LEVELS = {"level 1": ("analysis_layers.0.", "synthesis_layers.2.", "output_layer."),
               "level 2": ("analysis_layers.1.", "synthesis_layers.1."),
               "level 3": ("analysis_layers.2.", "synthesis_layers.0."),
               "bottom": ("bottom_layer.",)}
# limits against the single process on the card, each the geometric mean of
# the largest sound reading and the smallest reading of the planted faults
# it separates, over PARALLEL_LIMIT_SEEDS (`--parallel-limits "unet3d
# depth-sharded"`; NVIDIA H100 80GB HBM3, 700.00 W): |Δ Dice loss| 3.58e-7
# vs level-2 zero halos 8.29e-6; max|Δ probability| of the starting weights
# 0.0351 vs zero halos 0.667 (local instance norms, 0.122, lie 3.5× above
# sound: the other readings separate them); the worst level's 1 − cosine
# 4.57e-4 vs local norms 3.10e-3, its |ln norm ratio| 5.25e-4 vs 4.02e-3
UNET_PARALLEL_LOSS, UNET_PARALLEL_PROBS, UNET_PARALLEL_COS, UNET_PARALLEL_SIZE = (
    1.7e-6, 0.15, 1.2e-3, 1.45e-3)
# SAM2 under the mesh (SAM2Config.large() at full width, live encoder, the
# training cell's 128x512x512 blob crop): at batch 1 the frozen encoder split
# over the ranks (TRAIN_DEPTH / PARALLEL_WORLD slices a rank, the pyramids
# gathered), the rest whole on every rank; at batch PARALLEL_WORLD the
# data-parallel step (one crop a rank). Held against the single process on
# the card: |Δ total loss| (Dice + mask_loss) and each gradient group of
# sam2_reference_phase (_sam2_group) before the norm clip (1 − cosine,
# |ln norm ratio|), each limit the geometric mean of the largest sound and the
# smallest fault reading that lies >= 4x above it, or 4x the largest sound
# reading where no fault moves it, over PARALLEL_LIMIT_SEEDS
# (`--parallel-limits "sam2 encoder-split" "sam2 data-parallel"`, run twice;
# NVIDIA H100 80GB HBM3, 700.00 W; worst group): encoder split |Δ loss|
# 1.32e-4 vs wrong slab 1.03e-3, 1 − cos 1.72e-3 vs 0.239, |ln ratio| 0.0367
# vs wrong slab 0.517 (summed 0.692); data-parallel |Δ loss| 1.39e-4 and
# 1 − cos 0.0110 (averaged moves neither), |ln ratio| 0.0723 vs averaged
# 0.691. The split step itself is exact: its sound |Δ loss| is cuDNN's
# attention (PyTorch's SDPA pick on the H100 for the heads), which gives one
# of two results per process, so a rank may land apart from the single
# process (PERF.md PR 20)
SAM2_SPLIT, SAM2_DP = "sam2 encoder-split", "sam2 data-parallel"
SAM2_PARALLEL_LIMITS = {  # (loss, 1 − cos, |ln norm ratio|)
    SAM2_SPLIT: (3.7e-4, 0.020, 0.14),
    SAM2_DP: (5.6e-4, 0.044, 0.22),
}
# rows 9-11 a rank: one 64-slice chunk of the encoder-split step, one
# tomogram's two chunks of the data-parallel one (the single process's step)
SAM2_SPLIT_LAUNCHES = {**dict.fromkeys(KERNELS, 0), **SAM_BATCH_LAUNCHES}


def _parallel_crops(dev: torch.device, seed: int = PARALLEL_SEED):
    """Two crops of the training cell, as host arrays: TRAIN_DEPTH slices of
    32x32 patches of 1536 features (fp16 values, f32 as the loader gives
    them) and their TRAIN_DEPTH x SIDE² labels (p 0.3, the first 16 slices
    unlabeled), drawn from ``seed`` on the card."""
    import numpy as np

    from cryovit_tpu_torch.types import TomogramBatch

    g = torch.Generator(device=dev).manual_seed(seed)
    grid = SIDE // 16
    feats = torch.randn((2, TRAIN_DEPTH, grid, grid, 1536), generator=g, device=dev)
    label = (torch.rand((2, TRAIN_DEPTH, SIDE, SIDE), generator=g, device=dev) < 0.3)
    label = label.to(torch.int8)
    label[:, :16] = -1
    batch = TomogramBatch(feats.half().float().cpu().numpy(), label.cpu().numpy(),
                          np.full((2,), TRAIN_DEPTH))
    del feats, label
    return batch


def _parallel_stack():
    """The serving phase's 64x512x512 uint8 tomogram (the same seed)."""
    import numpy as np

    return np.random.default_rng(0).integers(0, 256, size=(DEPTH, SIDE, SIDE), dtype=np.uint8)


@contextlib.contextmanager
def _planted(fault: str | None):
    """One of PARALLEL_FAULTS planted into the port for the block's extent."""
    from cryovit_tpu_torch.models import cryovit, unet3d
    from cryovit_tpu_torch.models.sam2.model import SAM2Model
    from cryovit_tpu_torch.parallel.mesh import Mesh, Sharding
    from cryovit_tpu_torch.train.loop import Trainer

    saved = (Trainer._reduce_gradients, cryovit.halo_exchange, Mesh.gather, cryovit._group_norm,
             unet3d._inorm, SAM2Model.encode_images)
    if fault == "averaged":
        def averaged(self, sharding):
            saved[0](self, sharding)
            for p in self.module.parameters():
                if p.grad is not None:
                    p.grad.div_(sharding.mesh.size)
        Trainer._reduce_gradients = averaged
    elif fault == "zero halos":
        def zero_halos(x, mesh, dim, d):
            shape = list(x.shape)
            shape[dim] = d
            return torch.cat([x.new_zeros(shape), x, x.new_zeros(shape)], dim)
        cryovit.halo_exchange = zero_halos
    elif fault == "local norms":
        def local_norms(x, gn, channel_dim, mesh=None):
            return saved[3](x, gn, channel_dim)
        cryovit._group_norm = local_norms
    elif fault == "swapped slots":
        def swapped(self, local, dim=0):
            other = dataclasses.replace(self, rank=self.size - 1 - self.rank)
            return saved[2](other, local, dim)
        Mesh.gather = swapped
    elif fault == "level-2 zero halos":
        def zero_level2(x, mesh, dim, d):
            # the only channels-first exchange of 64 channels at half width
            if dim == 2 and x.shape[1] == 64 and x.shape[-1] == SIDE // 2:
                shape = list(x.shape)
                shape[dim] = d
                return torch.cat([x.new_zeros(shape), x, x.new_zeros(shape)], dim)
            return saved[1](x, mesh, dim, d)
        cryovit.halo_exchange = zero_level2
    elif fault == "local instance norms":
        def local_inorm(x, norm, channel_dim=1, mesh=None):
            return saved[4](x, norm, channel_dim)
        unet3d._inorm = local_inorm
    elif fault == "wrong slab":
        def wrong_slab(self, slices, mesh=None):
            if mesh is not None and mesh.rank == 0:
                k = slices.shape[0] // mesh.size
                slices = torch.cat([slices[k : 2 * k], slices[k:]])
            return saved[5](self, slices, mesh)
        SAM2Model.encode_images = wrong_slab
    elif fault == "summed":
        def summed(self, sharding):
            saved[0](self, Sharding(sharding.mesh, 0) if sharding.encoder else sharding)
        Trainer._reduce_gradients = summed
    try:
        yield
    finally:
        (Trainer._reduce_gradients, cryovit.halo_exchange, Mesh.gather, cryovit._group_norm,
         unet3d._inorm, SAM2Model.encode_images) = saved


def _parallel_step(dev, batch, mesh_shape, fault=None, timed=0, seed=PARALLEL_SEED) -> dict:
    """One train step of the full-width decoder (bf16 on f32 masters, the
    weights drawn from ``seed``) on ``batch`` as ``Trainer.place`` lays it out over the
    mesh of ``mesh_shape`` (None: the single process): its logs, gradients,
    parameter updates, launches and peak memory (above what the process
    held before: weights, optimizer state, inputs and the step's own); with
    ``timed`` the device ms (CUDA events) of that many more steps."""
    from cryovit_tpu_torch import kernels
    from cryovit_tpu_torch.config import TrainConfig
    from cryovit_tpu_torch.models.cryovit import random_cryovit_state_dict
    from cryovit_tpu_torch.run.train_model import build_model
    from cryovit_tpu_torch.train.loop import Trainer

    held = torch.cuda.memory_allocated()
    model = build_model(TrainConfig(label_key="mito"))
    trainer = Trainer(precision="bf16", device=dev, mesh_shape=mesh_shape,
                      enable_model_summary=False)
    sd = random_cryovit_state_dict(torch.Generator().manual_seed(seed))
    sd["output_layer.2.weight"] *= 100.0  # probabilities' std 0.1, as the train reference
    module = model.build_module(sd, trainer.device)
    trainer.model, trainer.module, trainer.optimizer = model, module, model.make_optimizer(module)
    with _planted(fault):
        data, label, sharding = trainer.place(model, batch, None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        logs = trainer.train_step(data, label, sharding)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        out = {
            "logs": {k: float(v) for k, v in logs.items()},
            "grads": {n: p.grad.float().cpu() for n, p in module.named_parameters()},
            "updates": {n: (p.detach() - sd[n].to(p.device)).float().cpu()
                        for n, p in module.named_parameters()},
            "launches": counts, "peak_gib": (torch.cuda.max_memory_allocated() - held) / 2**30,
            "slab": tuple(data.shape), "dim": None if sharding is None else sharding.dim,
        }
        if trainer.mesh is not None:  # rank 0's parameters, bit for bit
            out["identical"] = all(
                torch.equal(p, trainer.mesh.broadcast_(p.detach().clone()))
                for p in module.parameters())
        times = []
        for _ in range(timed):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            trainer.train_step(data, label, sharding)
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        out["ms"] = times
    return out


def _parallel_unet_step(dev, batch, mesh_shape, fault=None, timed=0, seed=PARALLEL_SEED) -> dict:
    """One UNet3D train step at full width (bf16 on f32 masters, the weights
    drawn from ``seed``) on ``batch`` as ``Trainer.place`` lays it out over
    the mesh of ``mesh_shape`` (None: the single process), after the
    probabilities of the starting weights as ``Trainer.predict`` places and
    gathers them: the probabilities, the step's logs, gradients, launches
    and peak memory (above what the process held before), with ``timed``
    the device ms (CUDA events) of that many more steps."""
    from cryovit_tpu_torch import kernels
    from cryovit_tpu_torch.config import MODELS, TrainConfig
    from cryovit_tpu_torch.models.unet3d import random_unet3d_state_dict
    from cryovit_tpu_torch.run.train_model import build_model
    from cryovit_tpu_torch.train.loop import Trainer

    held = torch.cuda.memory_allocated()
    model = build_model(TrainConfig(label_key="mito", model=MODELS["unet3d"]))
    trainer = Trainer(precision="bf16", device=dev, mesh_shape=mesh_shape,
                      enable_model_summary=False)
    module = model.build_module(random_unet3d_state_dict(torch.Generator().manual_seed(seed)),
                                trainer.device)
    trainer.model, trainer.module, trainer.optimizer = model, module, model.make_optimizer(module)
    with _planted(fault):
        data, label, sharding = trainer.place(model, batch, None)
        probs = trainer._gather(trainer.predict_step(module, data, model, sharding), sharding)
        probs = probs.cpu()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        logs = trainer.train_step(data, label, sharding)
        torch.cuda.synchronize()
        out = {
            "probs": probs, "logs": {k: float(v) for k, v in logs.items()},
            "grads": {n: p.grad.float().cpu() for n, p in module.named_parameters()},
            "launches": kernels.launch_counts(),
            "peak_gib": (torch.cuda.max_memory_allocated() - held) / 2**30,
            "slab": tuple(data.shape), "dim": None if sharding is None else sharding.dim,
        }
        if trainer.mesh is not None:  # rank 0's parameters, bit for bit
            out["identical"] = all(
                torch.equal(p, trainer.mesh.broadcast_(p.detach().clone()))
                for p in module.parameters())
        times = []
        for _ in range(timed):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            trainer.train_step(data, label, sharding)
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        out["ms"] = times
    return out


def _parallel_blob_batch(seed: int = PARALLEL_SEED, crops: int = 1):
    """``crops`` crops of the UNet3D / SAM2 training cell as the loader
    gives them: a TRAIN_DEPTH x SIDE² blob tomogram's raw voxels (uint8 /
    255, f32) and its labels (the first 16 slices unlabeled) each, the first
    drawn from ``seed``, the next from ``seed + 1000``."""
    import numpy as np

    from cryovit_tpu_torch.types import TomogramBatch

    tomos = [blob_tomogram(np.random.default_rng(seed + 1000 * i), TRAIN_DEPTH, SIDE)
             for i in range(crops)]
    return TomogramBatch(np.stack([t.astype(np.float32) / 255.0 for t, _ in tomos])[..., None],
                         np.stack([lab for _, lab in tomos]), np.full((crops,), TRAIN_DEPTH))


def _parallel_sam2_step(dev, batch, mesh_shape, fault=None, seed=PARALLEL_SEED) -> dict:
    """One SAM2 train step at full width (``SAM2Config.large()``, live
    encoder, bf16 on f32 masters, ``train --model sam2``'s recipe with its
    norm clip at 1; the weights drawn from ``seed`` on the card, the
    object-score bias at +3) on ``batch`` as ``Trainer.place`` lays it out
    over the mesh of ``mesh_shape`` (None: the single process): its logs,
    the trained gradients before the clip (the clipped ones times the pre-
    over the post-clip norm: the norm clip scales every gradient alike),
    launches, peak memory (above what the process held before), the bytes
    of the pyramids' gathers and their host seconds (synced), and the
    step's device ms (CUDA events; the encoder's compute copy made before
    it; the allocator is cold in a process's first SAM2 step after
    ``empty_cache``, warm in the next, a planted fault's on a fresh
    module)."""
    from cryovit_tpu_torch import kernels
    from cryovit_tpu_torch.config import TrainConfig
    from cryovit_tpu_torch.models.sam2.model import random_sam2_state_dict
    from cryovit_tpu_torch.parallel.mesh import Mesh
    from cryovit_tpu_torch.run.train_model import build_model
    from cryovit_tpu_torch.train.loop import Trainer

    held = torch.cuda.memory_allocated()
    cfg = TrainConfig.for_model("sam2", "mito")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, custom_kwargs=tuple(
        (k, False if k == "use_cache_features" else v) for k, v in cfg.model.custom_kwargs)))
    model = build_model(cfg)
    trainer = Trainer(precision="bf16", device=dev, mesh_shape=mesh_shape,
                      gradient_clip_val=cfg.trainer.gradient_clip_val,
                      gradient_clip_algorithm=cfg.trainer.gradient_clip_algorithm,
                      enable_model_summary=False)
    sd = random_sam2_state_dict(model.sam_cfg, torch.Generator(device=trainer.device).manual_seed(seed))
    sd["model.sam_mask_decoder.pred_obj_score_head.layers.2.bias"].fill_(3.0)
    module = model.build_module(sd, trainer.device)
    del sd
    trainer.model, trainer.module, trainer.optimizer = model, module, model.make_optimizer(module)
    model.train_mode = True
    module.compute_encoder()
    gathered = []
    gather = Mesh.gather

    def counted(self, local, dim=0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gather(self, local, dim)
        torch.cuda.synchronize()
        gathered.append((out.nbytes, time.perf_counter() - t0))
        return out

    with _planted(fault):
        Mesh.gather = counted
        try:
            data, label, sharding = trainer.place(model, batch, None)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            logs = trainer.train_step(data, label, sharding)
            stop.record()
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            logs = {k: float(v) for k, v in logs.items()}
            scale = logs["grad_norm_preclip"] / logs["grad_norm"]
            trained = {n: p for n, p in module.named_parameters() if p.requires_grad}
            out = {
                "logs": logs, "grads": {n: (p.grad.float() * scale).cpu() for n, p in trained.items()},
                "launches": counts, "peak_gib": (torch.cuda.max_memory_allocated() - held) / 2**30,
                "gather_gb": sum(b for b, _ in gathered) / 1e9,
                "gather_s": sum(t for _, t in gathered), "ms": [start.elapsed_time(stop)],
                "slab": tuple(data.shape), "dim": None if sharding is None else sharding.dim,
                "encoder": sharding is not None and sharding.encoder,
            }
            if trainer.mesh is not None:  # rank 0's trained parameters, bit for bit (the
                # frozen ones never change)
                out["identical"] = all(
                    torch.equal(p, trainer.mesh.broadcast_(p.detach().clone()))
                    for p in trained.values())
        finally:
            Mesh.gather = gather
    return out


def _sam2_agreement(got: dict, want: dict) -> dict:
    """A SAM2 step against the single process's: |Δ total loss| (Dice +
    mask_loss) and the two losses, each gradient group before the clip
    (_sam2_group, _group_agreement: 1 − cosine, |ln norm ratio|) with the
    worst of each, |Δ| of the pre-clip gradient norm over its size."""
    names = sorted({_sam2_group(n) for n in want["grads"]})
    groups = {g: _group_agreement(got["grads"], want["grads"],
                                  [n for n in want["grads"] if _sam2_group(n) == g]) for g in names}
    cos_at = max(groups, key=lambda k: groups[k][0])
    size_at = max(groups, key=lambda k: groups[k][1])
    g, w = got["logs"]["grad_norm_preclip"], want["logs"]["grad_norm_preclip"]
    return {"loss": abs(got["logs"]["train_total"] - want["logs"]["train_total"]),
            "losses": (got["logs"]["train_total"], want["logs"]["train_total"]),
            "cos": groups[cos_at][0], "cos_at": cos_at, "size": groups[size_at][1],
            "size_at": size_at, "grad_norm": abs(g - w) / w, "groups": groups}


def _sam2_within(what: str, agreement: dict) -> bool:
    loss, cos, size = SAM2_PARALLEL_LIMITS[what]
    return agreement["loss"] <= loss and agreement["cos"] <= cos and agreement["size"] <= size


def _unet_agreement(got: dict, want: dict) -> dict:
    """A UNet3D step against the single process's: |Δ Dice loss|, max|Δ
    probability| of the starting weights, and each level's gradient as one
    vector (_group_agreement: 1 − cosine, |ln norm ratio|), with the worst
    level of each."""
    levels = {level: _group_agreement(got["grads"], want["grads"],
                                      [n for n in want["grads"] if n.startswith(prefixes)])
              for level, prefixes in UNET_LEVELS.items()}
    cos_at = max(levels, key=lambda k: levels[k][0])
    size_at = max(levels, key=lambda k: levels[k][1])
    return {"loss": abs(got["logs"]["train_dice_loss"] - want["logs"]["train_dice_loss"]),
            "probs": (got["probs"] - want["probs"]).abs().max().item(),
            "cos": levels[cos_at][0], "cos_at": cos_at,
            "size": levels[size_at][1], "size_at": size_at, "levels": levels}


def _unet_within(agreement: dict) -> bool:
    return (agreement["loss"] <= UNET_PARALLEL_LOSS and agreement["probs"] <= UNET_PARALLEL_PROBS
            and agreement["cos"] <= UNET_PARALLEL_COS and agreement["size"] <= UNET_PARALLEL_SIZE)


def _parallel_extract(dev, mesh, fault=None, timed=False) -> dict:
    """The serving tomogram through ``DinoExtractor`` (ViT-g/14, seeded
    weights, batch SLICE_BATCH) on ``mesh`` (None: the single process):
    features on the host, launches, peak memory (above what the process
    held before the weights), with ``timed`` the device ms of a second
    extraction."""
    from cryovit_tpu_torch import kernels
    from cryovit_tpu_torch.run.dino_features import DinoExtractor, load_extractor

    held = torch.cuda.memory_allocated()
    extractor = DinoExtractor(load_extractor(random_init=True, device=dev),
                              batch_size=SLICE_BATCH, mesh=mesh)
    stack = _parallel_stack()
    with _planted(fault):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        feats = extractor.extract_device(stack)
        torch.cuda.synchronize()
        out = {"feats": feats.cpu(), "launches": kernels.launch_counts(),
               "peak_gib": (torch.cuda.max_memory_allocated() - held) / 2**30}
        if timed:
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            extractor.extract_device(stack)
            stop.record()
            torch.cuda.synchronize()
            out["ms"] = start.elapsed_time(stop)
    return out


def _update_error(got: torch.Tensor, want: torch.Tensor, grad: torch.Tensor) -> float:
    """How far a parameter's update after the step is from the single
    process's, each element weighted by the size of its single-process
    gradient: Σ|g|·|Δu| / Σ|g|·|u|. AdamW's first step moves each element
    by about the learning rate times the sign of its gradient, so a
    gradient at rounding level (a conv bias before a norm) may flip its
    update whole; weighted by |g| it counts as little as it matters."""
    weight = grad.abs()
    return ((weight * (got - want).abs()).sum() / (weight * want.abs()).sum()).item()


def _step_agreement(got: dict, want: dict) -> dict:
    """A step against the single process's: |Δ loss|, the worst gradient
    (_worst_gradient) and the median one by the same rule, the worst
    parameter update (_update_error), |Δ| of the pre-clip gradient norm
    over its size."""
    grad, grad_name = _worst_gradient(got["grads"], want["grads"])
    per_leaf = sorted(_gradient_errors(got["grads"], want["grads"]).values())
    update, update_name = max(
        (_update_error(got["updates"][n], w, want["grads"][n]), n)
        for n, w in want["updates"].items() if want["grads"][n].abs().sum().item() > 0)
    g, w = got["logs"]["grad_norm_preclip"], want["logs"]["grad_norm_preclip"]
    return {"loss": abs(got["logs"]["train_dice_loss"] - want["logs"]["train_dice_loss"]),
            "grad": grad, "grad_at": grad_name, "grad_median": per_leaf[len(per_leaf) // 2],
            "update": update, "update_at": update_name, "grad_norm": abs(g - w) / w}


def _within(agreement: dict) -> bool:
    return (agreement["loss"] <= PARALLEL_LOSS and agreement["grad"] <= PARALLEL_GRAD
            and agreement["grad_median"] <= PARALLEL_GRAD_MEDIAN
            and agreement["update"] <= PARALLEL_UPDATE)


def _feature_agreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    got, want = got.float(), want.float()
    return {"rel_l2": ((got - want).norm() / want.norm()).item(),
            "max_abs": (got - want).abs().max().item()}


# the train steps of the parallel phase and the faults planted into each
PARALLEL_STEPS = (("data-parallel", ("averaged",)),
                  ("depth-sharded", ("averaged", "zero halos", "local norms")),
                  (UNET_PARALLEL, ("level-2 zero halos", "local instance norms")),
                  (SAM2_SPLIT, ("wrong slab", "summed")),
                  (SAM2_DP, ("averaged",)))
# what of a step's run the single process's reference keeps
REFERENCE_KEYS = {"data-parallel": ("logs", "grads", "updates"),
                  "depth-sharded": ("logs", "grads", "updates"),
                  UNET_PARALLEL: ("logs", "grads", "probs"),
                  SAM2_SPLIT: ("logs", "grads"), SAM2_DP: ("logs", "grads")}
SAM2_STEPS = (SAM2_SPLIT, SAM2_DP)


def _parallel_batches(dev: torch.device, seed: int = PARALLEL_SEED, steps=None) -> dict:
    """The batches of PARALLEL_STEPS (those named in ``steps``, all when
    None): the decoder's two crops and the first alone; the blob tomogram's
    two crops (SAM2's data-parallel batch) and the first alone (UNet3D's and
    SAM2's batch of one)."""
    steps = steps or [what for what, _ in PARALLEL_STEPS]
    out = {}
    if "data-parallel" in steps or "depth-sharded" in steps:
        crops = _parallel_crops(dev, seed)
        out["data-parallel"] = crops
        out["depth-sharded"] = dataclasses.replace(
            crops, data=crops.data[:1], label=crops.label[:1], num_slices=crops.num_slices[:1])
    if {UNET_PARALLEL, SAM2_SPLIT, SAM2_DP} & set(steps):
        # UNet3D's crop is the first of SAM2's two
        crops = _parallel_blob_batch(seed, PARALLEL_WORLD if SAM2_DP in steps else 1)
        out[SAM2_DP] = crops
        out[UNET_PARALLEL] = out[SAM2_SPLIT] = dataclasses.replace(
            crops, data=crops.data[:1], label=crops.label[:1], num_slices=crops.num_slices[:1])
    return {what: out[what] for what in steps}


def _run_step(what: str, dev, batch, mesh_shape, fault=None, timed=0, seed=PARALLEL_SEED) -> dict:
    if what in SAM2_STEPS:  # a SAM2 step takes ~10 s: its own step is timed
        return _parallel_sam2_step(dev, batch, mesh_shape, fault, seed)
    step = _parallel_unet_step if what == UNET_PARALLEL else _parallel_step
    return step(dev, batch, mesh_shape, fault, timed, seed)


def _agreement(what: str, got: dict, want: dict) -> dict:
    if what in SAM2_STEPS:
        return _sam2_agreement(got, want)
    return (_unet_agreement if what == UNET_PARALLEL else _step_agreement)(got, want)



def _limit_readings(dev: torch.device, tmp: str, seeds, steps) -> dict:
    """A rank's readings for ``--parallel-limits``: for each seed and step
    of PARALLEL_STEPS named in ``steps``, two sound runs and each planted
    fault against the single process's first run in
    ``tmp/single<seed>.pt``."""
    out = {}
    for seed in seeds:
        ref = torch.load(f"{tmp}/single{seed}.pt", weights_only=False)
        batches = _parallel_batches(dev, seed, steps)
        out[seed] = {}
        for what, faults in PARALLEL_STEPS:
            if what not in steps:
                continue

            def step(fault=None):
                return _agreement(what, _run_step(what, dev, batches[what], {"data": -1}, fault,
                                                  seed=seed), ref[what][0])
            out[seed][what] = {"sound": [step(), step()], "faults": {f: step(f) for f in faults}}
            torch.cuda.empty_cache()
    return out


def _parallel_rank(rank: int, world: int, tmp: str, device: str, seeds=(), steps=()) -> None:
    """One rank of the parallel phase: a gloo group on the one card, the
    train steps of PARALLEL_STEPS and the sharded extraction, each against
    the single process's results in ``tmp``, and the planted faults; the
    summary to ``tmp/rank<rank>.pt``. With ``seeds``, the readings of
    ``--parallel-limits`` (_limit_readings) for ``steps`` instead."""
    import torch.distributed as dist

    from cryovit_tpu_torch import kernels
    from cryovit_tpu_torch.parallel import make_mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init", rank=rank,
                            world_size=world)
    try:
        kernels.load_library()  # built by the parent: this loads it
        if seeds:
            torch.save(_limit_readings(dev, tmp, seeds, steps), f"{tmp}/rank{rank}.pt")
            return
        ref = torch.load(f"{tmp}/single.pt", weights_only=False)
        batches = _parallel_batches(dev)
        out = {}
        for what, faults in PARALLEL_STEPS:
            batch = batches[what]
            run = _run_step(what, dev, batch, {"data": -1}, timed=PARALLEL_TIMED)
            keys = ("launches", "peak_gib", "ms", "slab", "dim", "identical")
            if what in SAM2_STEPS:
                keys += ("gather_gb", "gather_s", "encoder")
            out[what] = {"agreement": _agreement(what, run, ref[what]), "faults": {},
                         **{k: run[k] for k in keys}}
            del run
            for f in faults:
                faulty = _run_step(what, dev, batch, {"data": -1}, f)
                out[what]["faults"][f] = _agreement(what, faulty, ref[what])
                if what in SAM2_STEPS:  # the same work on a fresh module: more readings
                    out[what]["ms"] += faulty["ms"]
                del faulty
            torch.cuda.empty_cache()
        mesh = make_mesh({"data": -1}, device=dev)
        run = _parallel_extract(dev, mesh, timed=True)
        out["extraction"] = {
            "agreement": _feature_agreement(run["feats"], ref["extraction"]["feats"]),
            "faults": {"swapped slots": _feature_agreement(
                _parallel_extract(dev, mesh, "swapped slots")["feats"],
                ref["extraction"]["feats"])},
            **{k: run[k] for k in ("launches", "peak_gib", "ms")},
        }
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def parallel_phase(dev: torch.device, workdir: Path) -> list[dict[str, int]]:
    """``cryovit_tpu_torch.parallel`` on the card: PARALLEL_WORLD ranks
    spawned on the one card, joined by an explicit gloo group (NCCL refuses
    two ranks on one device; gloo's ``all_reduce`` and ``broadcast`` take
    CUDA tensors through the host). Against the single process on the same
    card (run first, here): the data-parallel CryoVIT train step (two
    crops of the training cell, one a rank), the depth-sharded step (one
    crop, TRAIN_DEPTH / PARALLEL_WORLD slices a rank) and the sharded DINOv2
    extraction of the serving tomogram (SLICE_BATCH / PARALLEL_WORLD slices
    a rank) and UNet3D's depth-sharded step (the UNet3D training cell's
    crop, TRAIN_DEPTH / PARALLEL_WORLD slices a rank) and SAM2's two steps
    (SAM2Config.large() at full width on that crop: the frozen encoder split
    over the ranks at batch 1, TRAIN_DEPTH / PARALLEL_WORLD slices a rank,
    and the data-parallel step on two crops, one a rank), with planted
    faults that must read above the limits; launches, ms and peak memory
    per rank. Returns each rank's launches."""
    from cryovit_tpu_torch import kernels

    name = gpu_name_and_power()
    tmp = workdir / "parallel"
    tmp.mkdir()
    batches = _parallel_batches(dev)
    ref = {}
    for what, batch in batches.items():
        ref[what] = _run_step(what, dev, batch, None, timed=PARALLEL_TIMED)
        torch.cuda.empty_cache()
    ref["extraction"] = _parallel_extract(dev, None, timed=True)
    torch.save(ref, tmp / "single.pt")
    del batches
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dev_name = f"{dev.type}:0" if dev.type == "cuda" else dev.type
    torch.multiprocessing.start_processes(_parallel_rank,
                                          args=(PARALLEL_WORLD, str(tmp), dev_name),
                                          nprocs=PARALLEL_WORLD, start_method="spawn")
    log("parallel", f"{PARALLEL_WORLD} ranks spawned on the one card (gloo group), "
        f"done in {time.perf_counter() - t0:.1f} s")
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(PARALLEL_WORLD)]
    log("parallel", f"gloo stages every collective through the host: the times below say "
        f"nothing of NCCL scaling, and the ranks share one card ({name})")

    checks = {}
    for what in ("data-parallel", "depth-sharded"):
        single = ref[what]
        log("parallel", f"{what}: single process slab {single['slab']}, launches "
            f"{ {k: n for k, n in single['launches'].items() if n} }, peak "
            f"{single['peak_gib']:.2f} GiB, ms {' '.join(f'{t:.2f}' for t in single['ms'])} "
            f"({name})")
        for r, rank in enumerate(ranks):
            run = rank[what]
            a = run["agreement"]
            log("parallel", f"{what} rank {r}: slab {run['slab']} (split dim {run['dim']}), "
                f"launches { {k: n for k, n in run['launches'].items() if n} }, peak "
                f"{run['peak_gib']:.2f} GiB ({run['peak_gib'] / single['peak_gib']:.3f} of the "
                f"single process's), ms {' '.join(f'{t:.2f}' for t in run['ms'])} ({name}); "
                f"|dloss| {a['loss']:.3g} (limit {PARALLEL_LOSS}), worst gradient "
                f"{a['grad']:.4g} at {a['grad_at']} (limit {PARALLEL_GRAD}), median gradient "
                f"{a['grad_median']:.4g} (limit {PARALLEL_GRAD_MEDIAN}), worst update "
                f"{a['update']:.4g} at {a['update_at']} (limit {PARALLEL_UPDATE}), grad norm "
                f"{a['grad_norm']:.3g}")
            checks[f"{what} rank {r} agrees with the single process"] = _within(a)
            checks[f"{what} rank {r} launches {TRAIN_STEP_LAUNCHES}"] = (
                run["launches"] == TRAIN_STEP_LAUNCHES)
            for fault, f in run["faults"].items():
                log("parallel", f"{what} rank {r}, planted fault ({PARALLEL_FAULTS[fault]}): "
                    f"|dloss| {f['loss']:.3g}, worst gradient {f['grad']:.4g} at {f['grad_at']}, "
                    f"median gradient {f['grad_median']:.4g}, worst update {f['update']:.4g}, "
                    f"grad norm {f['grad_norm']:.3g}")
                checks[f"{what} rank {r}: the planted fault '{fault}' reads above the limits"] = (
                    not _within(f))
        checks[f"{what}: every rank's parameters equal rank 0's after the step"] = all(
            rank[what]["identical"] for rank in ranks)
    depth_ratio = (max(r["depth-sharded"]["peak_gib"] for r in ranks)
                   / ref["depth-sharded"]["peak_gib"])
    log("parallel", f"depth-sharded peak per rank / single process: {depth_ratio:.3f} ({name})")
    _unet_parallel_report(ref, ranks, name, checks)
    _sam2_parallel_report(ref, ranks, name, checks)
    _extraction_report(ref, ranks, name, checks)
    _report_checks(checks, "parallel phase")
    per_rank = [{k: sum(run["launches"][k] for run in rank.values()) for k in kernels.KERNELS}
                for rank in ranks]
    return per_rank


def _unet_parallel_report(ref: dict, ranks: list[dict], name: str, checks: dict) -> None:
    """UNet3D's depth-sharded step in the parallel phase: each rank's
    readings against the single process, its faults, the checks."""
    single = ref[UNET_PARALLEL]
    log("parallel", f"{UNET_PARALLEL}: single process slab {single['slab']}, launches "
        f"{ {k: n for k, n in single['launches'].items() if n} }, peak "
        f"{single['peak_gib']:.2f} GiB, ms {' '.join(f'{t:.2f}' for t in single['ms'])} "
        f"({name})")

    def unet_line(a):
        levels = ", ".join(f"{k} {c:.3g}/{z:.3g}" for k, (c, z) in a["levels"].items())
        return (f"|dloss| {a['loss']:.3g} (limit {UNET_PARALLEL_LOSS}), max|dprob| "
                f"{a['probs']:.3g} (limit {UNET_PARALLEL_PROBS}), gradients by level (1 - cos / "
                f"|ln norm ratio|) {levels} (limits {UNET_PARALLEL_COS} / {UNET_PARALLEL_SIZE})")

    for r, rank in enumerate(ranks):
        run = rank[UNET_PARALLEL]
        a = run["agreement"]
        log("parallel", f"{UNET_PARALLEL} rank {r}: slab {run['slab']} (split dim {run['dim']}), "
            f"launches { {k: n for k, n in run['launches'].items() if n} }, step ms "
            f"{' '.join(f'{t:.2f}' for t in run['ms'])}, peak {run['peak_gib']:.2f} GiB "
            f"({run['peak_gib'] / single['peak_gib']:.3f} of the single process's) ({name})")
        log("parallel", f"{UNET_PARALLEL} rank {r} against the single process: {unet_line(a)}")
        checks[f"{UNET_PARALLEL} rank {r} takes the depth-sharded step"] = run["dim"] == 1
        checks[f"{UNET_PARALLEL} rank {r} agrees with the single process"] = _unet_within(a)
        checks[f"{UNET_PARALLEL} rank {r} launches {UNET_STEP_NONZERO} and nothing else"] = (
            run["launches"] == UNET_STEP_LAUNCHES)
        for fault, f in run["faults"].items():
            log("parallel", f"{UNET_PARALLEL} rank {r}, planted fault ({PARALLEL_FAULTS[fault]}): "
                f"{unet_line(f)}")
            checks[f"{UNET_PARALLEL} rank {r}: the planted fault '{fault}' reads above the "
                   "limits"] = not _unet_within(f)
    checks[f"{UNET_PARALLEL}: every rank's parameters equal rank 0's after the step"] = all(
        rank[UNET_PARALLEL]["identical"] for rank in ranks)


def _sam2_parallel_report(ref: dict, ranks: list[dict], name: str, checks: dict) -> None:
    """SAM2's two steps in the parallel phase: each rank's readings (ms,
    peak against the single process, the pyramids' gather) and agreement,
    its faults, the checks."""
    want_dim = {SAM2_SPLIT: (None, True), SAM2_DP: (0, False)}
    want_launches = {SAM2_SPLIT: SAM2_SPLIT_LAUNCHES, SAM2_DP: SAM2_STEP_LAUNCHES}

    def line(what, a):
        groups = ", ".join(f"{g} {c:.3g}/{z:.3g}" for g, (c, z) in a["groups"].items())
        loss, cos, size = SAM2_PARALLEL_LIMITS[what]
        return (f"|dloss| {a['loss']:.3g} (limit {loss}), gradient groups before the clip "
                f"(1 - cos / |ln norm ratio|) {groups} (limits {cos} / {size}), grad norm "
                f"{a['grad_norm']:.3g}")

    for what in SAM2_STEPS:
        single = ref[what]
        log("parallel", f"{what}: single process batch {single['slab'][:2]}, launches "
            f"{ {k: n for k, n in single['launches'].items() if n} }, peak "
            f"{single['peak_gib']:.2f} GiB, step ms {' '.join(f'{t:.2f}' for t in single['ms'])} "
            f"(the allocator cold; the warm batch-1 step: the SAM2 training phase's median) "
            f"({name})")
        for r, rank in enumerate(ranks):
            run = rank[what]
            log("parallel", f"{what} rank {r}: batch {run['slab'][:2]} (split dim {run['dim']}, "
                f"encoder split {run['encoder']}), launches "
                f"{ {k: n for k, n in run['launches'].items() if n} }, step ms "
                f"{' '.join(f'{t:.2f}' for t in run['ms'])}, peak {run['peak_gib']:.2f} GiB "
                f"({run['peak_gib'] / single['peak_gib']:.3f} of the single process's), pyramid "
                f"gathers {run['gather_gb']:.3f} GB in {run['gather_s']:.3f} s (host, synced) "
                f"({name}); step ms: the sound step (allocator cold), then each planted fault's "
                f"(the same work, the allocator warm)")
            log("parallel", f"{what} rank {r} against the single process: "
                f"{line(what, run['agreement'])}")
            checks[f"{what} rank {r} takes its step"] = (run["dim"], run["encoder"]) == want_dim[what]
            checks[f"{what} rank {r} agrees with the single process"] = _sam2_within(
                what, run["agreement"])
            nonzero = {k: n for k, n in want_launches[what].items() if n}
            checks[f"{what} rank {r} launches {nonzero} and nothing else"] = (
                run["launches"] == want_launches[what])
            for fault, f in run["faults"].items():
                log("parallel", f"{what} rank {r}, planted fault ({PARALLEL_FAULTS[fault]}): "
                    f"{line(what, f)}")
                checks[f"{what} rank {r}: the planted fault '{fault}' reads above the limits"] = (
                    not _sam2_within(what, f))
        checks[f"{what}: every rank's trained parameters equal rank 0's after the step"] = all(
            rank[what]["identical"] for rank in ranks)


def _extraction_report(ref: dict, ranks: list[dict], name: str, checks: dict) -> None:
    """The sharded DINOv2 extraction in the parallel phase: each rank's
    readings against the single process, its fault, the checks."""
    single = ref["extraction"]
    log("parallel", f"extraction single process: launches "
        f"{ {k: n for k, n in single['launches'].items() if n} }, peak {single['peak_gib']:.2f} "
        f"GiB, {single['ms']:.2f} ms ({name})")
    for r, rank in enumerate(ranks):
        run = rank["extraction"]
        a, f = run["agreement"], run["faults"]["swapped slots"]
        log("parallel", f"extraction rank {r}: {SLICE_BATCH // PARALLEL_WORLD} slices, launches "
            f"{ {k: n for k, n in run['launches'].items() if n} }, peak {run['peak_gib']:.2f} GiB, "
            f"{run['ms']:.2f} ms ({name}); features rel L2 {a['rel_l2']:.3g} (limit "
            f"{PARALLEL_FEATURES}), max|diff| {a['max_abs']:.3g}; planted fault "
            f"({PARALLEL_FAULTS['swapped slots']}): rel L2 {f['rel_l2']:.3g}")
        checks[f"extraction rank {r} agrees with the single process"] = (
            a["rel_l2"] <= PARALLEL_FEATURES)
        checks[f"extraction rank {r}: the planted fault reads above the limit"] = (
            f["rel_l2"] > PARALLEL_FEATURES)
        checks[f"extraction rank {r} launches 40 flash_attention"] = (
            {k: n for k, n in run["launches"].items() if n} == {"flash_attention": 40})


LIMIT_KEYS = ("loss", "grad", "grad_median", "update", "grad_norm")
UNET_LIMIT_KEYS = ("loss", "probs", "cos", "size")
SAM2_LIMIT_KEYS = ("loss", "cos", "size", "grad_norm")


def parallel_limits(dev: torch.device, workdir: Path, steps=None) -> dict:
    """``chip_smoke.py --parallel-limits [step ...]``: the readings the
    parallel phase's limits are set between. For each of
    PARALLEL_LIMIT_SEEDS (crops and weights), the single process twice (its
    second run against its first: the card's own run-to-run spread), then
    PARALLEL_WORLD ranks on the one card as in ``parallel_phase``: each step
    of PARALLEL_STEPS (those named in ``steps``, all when None) twice sound
    and once with each planted fault, against the single process's first
    run. Prints every reading and, for each step and reading (LIMIT_KEYS,
    UNET_LIMIT_KEYS for UNet3D's, SAM2_LIMIT_KEYS for SAM2's), the largest
    sound value and each fault's smallest; returns that summary."""
    name = gpu_name_and_power()
    steps = list(steps or [what for what, _ in PARALLEL_STEPS])
    tmp = workdir / "parallel_limits"
    tmp.mkdir()
    spread = {}
    for seed in PARALLEL_LIMIT_SEEDS:
        batches = _parallel_batches(dev, seed, steps)
        ref = {}
        for what, batch in batches.items():
            first = _run_step(what, dev, batch, None, seed=seed)
            spread[seed, what] = _agreement(what, _run_step(what, dev, batch, None, seed=seed),
                                            first)
            ref[what] = [{k: first[k] for k in REFERENCE_KEYS[what]}]
            del first
            torch.cuda.empty_cache()
        torch.save(ref, tmp / f"single{seed}.pt")
        del ref, batches
    dev_name = f"{dev.type}:0" if dev.type == "cuda" else dev.type
    torch.multiprocessing.start_processes(
        _parallel_rank, args=(PARALLEL_WORLD, str(tmp), dev_name, PARALLEL_LIMIT_SEEDS, steps),
        nprocs=PARALLEL_WORLD, start_method="spawn")
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(PARALLEL_WORLD)]

    def keys(what):
        if what in SAM2_STEPS:
            return SAM2_LIMIT_KEYS
        return UNET_LIMIT_KEYS if what == UNET_PARALLEL else LIMIT_KEYS

    def line(what, a):
        worst = (f"(worst at {a['cos_at']} / {a['size_at']})" if "cos_at" in a
                 else f"(worst at {a['grad_at']})")
        if "losses" in a:
            worst += f" (total loss {a['losses'][0]!r}, the reference's {a['losses'][1]!r})"
        return " ".join(f"{k} {a[k]:.4g}" for k in keys(what)) + " " + worst

    summary = {}
    for what, faults in PARALLEL_STEPS:
        if what not in steps:
            continue
        sound, bad = [], {f: [] for f in faults}
        for seed in PARALLEL_LIMIT_SEEDS:
            log("limits", f"{what} seed {seed} single process run 2 vs run 1: "
                f"{line(what, spread[seed, what])} ({name})")
            for r, rank in enumerate(ranks):
                got = rank[seed][what]
                for i, a in enumerate(got["sound"]):
                    log("limits", f"{what} seed {seed} rank {r} sound run {i + 1}: "
                        f"{line(what, a)}")
                    sound.append(a)
                for f, a in got["faults"].items():
                    log("limits", f"{what} seed {seed} rank {r} fault '{f}': {line(what, a)}")
                    bad[f].append(a)
        summary[what] = {
            "single_spread_max": {k: max(spread[s_, what][k] for s_ in PARALLEL_LIMIT_SEEDS)
                                  for k in keys(what)},
            "sound_max": {k: max(a[k] for a in sound) for k in keys(what)},
            **{f"fault_min {f}": {k: min(a[k] for a in v) for k in keys(what)}
               for f, v in bad.items()},
        }
    log("limits", json.dumps({"card": name, "seeds": list(PARALLEL_LIMIT_SEEDS),
                              "summary": summary}))
    return summary


PROFILE_GROUPS = (
    ("port kernels (decoder tail)", ("conv3d_dm", "convt2x_dm", "sum_partials")),
    ("cuDNN / cuBLAS (projection, front convs)",
     ("convolve", "wgrad", "dgrad", "xmma", "cutlass", "nvjet", "gemm", "cudnn", "implicit")),
)


# the same for a UNet3D train step: level 1's port kernels, cuDNN's levels 2-3
# (and the pool, ConvTranspose and 1x1 convs), copies (casts, the level-1
# layout changes, the skip concat), then the norm and GELU glue
UNET_PROFILE_GROUPS = (
    ("port kernels (level-1 3^3 convs)", ("conv3d_dm", "sum_partials")),
    ("cuDNN / cuBLAS (levels 2-3, bottom, pools, ConvTransposes, 1x1 convs)",
     ("convolve", "wgrad", "dgrad", "xmma", "cutlass", "nvjet", "gemm", "cudnn", "implicit",
      "conv")),
    ("copies, casts, layout changes, concat", ("copy", "Copy", "Cat", "cat_")),
    ("InstanceNorm / GELU glue", ("elementwise", "reduce", "Reduce", "Welford", "gelu", "Gelu")),
)


# a SAM2 train step: the encoder's kernels and products, then the heads'
# attention (SDPA's flash / efficient kernels), products and convolutions
SAM2_PROFILE_GROUPS = (
    ("port kernels (encoder window blocks, attention)", ("attention_sm90", "ln_gemm", "residual_gemm")),
    ("SDPA (heads' attention)", ("flash", "fmha", "efficient_attention", "attention")),
    ("cuBLAS / cuDNN (encoder products, heads' linears and convs)",
     ("xmma", "cutlass", "nvjet", "gemm", "cudnn", "implicit", "conv", "wgrad", "dgrad")),
    ("host <-> device copies", ("Memcpy",)),
)


def _profile(run, what: str, groups, rest: str, name: str, top: int = 12,
             host_ops: bool = True) -> float:
    """Device time of one call of ``run`` by kernel and by layer (the first
    of ``groups`` whose name fragments a kernel's name holds, else ``rest``),
    from torch.profiler: device activity only, not the host ops that launch
    it (``host_ops=False`` leaves them out of the trace as well, which a
    step of a few hundred thousand launches needs: the profiler's summary of
    the host ops takes minutes). Returns the device busy ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if host_ops else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
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
    launches = sum(e.count for e in rows)
    log("profile", f"{what}: device busy {total:.2f} ms of {wall:.2f} ms wall (profiled), "
        f"{launches} kernel launches ({name})")
    for group, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        log("profile", f"{ms:9.3f} ms ({100 * ms / total:4.1f} %)  {group}")
    for e in rows[:top]:
        log("profile", f"{e.self_device_time_total / 1e3:9.3f} ms {e.count:4d}x  {e.key[:100]}")
    return total


def _kernel_names(build_log: str):
    """(kernel<template args>, ptxas usage) lines of the nvcc -Xptxas -v report."""
    kernel = ""
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"((?:attention_int8_scales|attention_int8_operands"
                          r"|attention_int8_sm90|attention_sm90|flash_attention"
                          r"|conv3d_dm_dw|conv3d_dm|convt2x_dm_bwd|convt2x_dm"
                          r"|sum_partials|window_attention|ln_gemm|residual_gemm"
                          r"|residual_layernorm)_kernel)"
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

    if sys.argv[1:2] == ["--parallel-limits"]:
        steps = sys.argv[2:]
        unknown = set(steps) - {what for what, _ in PARALLEL_STEPS}
        if unknown:
            print(f"chip_smoke: no parallel step {sorted(unknown)}; the steps are "
                  f"{[what for what, _ in PARALLEL_STEPS]}", file=sys.stderr)
            return 2
        log("device", gpu_name_and_power())
        kernels.load_library()
        with tempfile.TemporaryDirectory(prefix="cryovit_smoke_") as tmp:
            parallel_limits(torch.device("cuda"), Path(tmp), steps)
        return 0

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
    unet3d_reference_phase(dev)
    sam_reference_phase(dev)
    w8a8_reference_phase(dev)
    sam2_reference_phase(dev)
    with tempfile.TemporaryDirectory(prefix="cryovit_smoke_") as tmp:
        serving = serving_phase(dev, Path(tmp))
        training = training_phase(dev, Path(tmp))
        torch.cuda.empty_cache()
        experiment = experiment_phase(dev, Path(tmp))
        torch.cuda.empty_cache()
        sam = sam_serving_phase(dev, Path(tmp))
        sam_t = sam_serving_phase(dev, Path(tmp), tiny=True)
        torch.cuda.empty_cache()
        unet = unet3d_training_phase(dev, Path(tmp))
        torch.cuda.empty_cache()
        sam2, sam2_kv = sam2_training_phase(dev, Path(tmp))
        torch.cuda.empty_cache()
        parallel = parallel_phase(dev, Path(tmp))

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": (serving[name] + training[name] + experiment[name] + sam[name]
                      + sam_t[name] + unet[name] + sam2[name] + sam2_kv[name]
                      + sum(rank[name] for rank in parallel)),
         **{k: results[name][k] for k in keys}}
        for name, (source, replaces) in KERNELS.items()
    ]}
    # the same kernel at Hiera-T's global shape (4 heads of 96), its launches
    # those of the Hiera-T batch
    row_t = results["window_attention hiera_t"]
    next(r for r in report["kernels"] if r["name"] == "window_attention")["hiera_t"] = {
        "launches": sam_t["window_attention"], **{k: row_t[k] for k in keys}}
    # the window blocks' products one by one, and their library composition
    for name in ("window_block_attention", "window_block_mlp"):
        row = next(r for r in report["kernels"] if r["name"] == name)
        row["products"] = results[name]["products"]
        row["library_composition_ms"] = results[name]["library_composition_ms"]
    # the conv's six calls of a serving pass and twelve of a train step, and
    # the weight gradient's six, one by one
    row4 = next(r for r in report["kernels"] if r["name"] == "conv3d_dm")
    row4["shapes"] = results["conv3d_dm"]["shapes"]
    row4["train_step"] = {k: results["conv3d_dm_train_step"][k] for k in (*keys, "shapes")}
    row5 = next(r for r in report["kernels"] if r["name"] == "conv3d_dm_dw")
    row5["shapes"] = results["conv3d_dm_dw"]["shapes"]
    # rows 4 and 5 at UNet3D's level 1: a train step's calls, one by one, and
    # the launches of the UNet3D path
    for row, key in ((row4, "conv3d_dm_unet3d"), (row5, "conv3d_dm_dw_unet3d")):
        row["unet3d_step"] = {"launches": unet[row["name"]],
                              **{k: results[key][k] for k in (*keys, "shapes")}}
        row["max_abs_err"] = max(row["max_abs_err"], results[key]["max_abs_err"])
    # the ConvTranspose's two calls of a serving pass and of a train step,
    # and its backward's two
    row6 = next(r for r in report["kernels"] if r["name"] == "convt2x_dm")
    row6["shapes"] = results["convt2x_dm"]["shapes"]
    row6["train_step"] = {k: results["convt2x_dm_train_step"][k] for k in (*keys, "shapes")}
    next(r for r in report["kernels"] if r["name"] == "convt2x_dm_bwd")["shapes"] = (
        results["convt2x_dm_bwd"]["shapes"])
    # rows 9-11 on the SAM2 training path (the live encoder, two chunks a step)
    for name in SAM2_STEP_NONZERO:
        next(r for r in report["kernels"] if r["name"] == name)["sam2_train"] = {
            "launches": sam2[name], "per_step": SAM2_STEP_NONZERO[name]}
        # the kv_cache check's two tracking passes (uncached, cached)
        next(r for r in report["kernels"] if r["name"] == name)["sam2_kv_cache"] = {
            "launches": sam2_kv[name], "per_pass": SAM_BATCH_LAUNCHES[name], "passes": 6}
    # rows 1, 4-7 and 9-11 on the parallel phase's ranks (one data-parallel
    # and one depth-sharded CryoVIT step, UNet3D's depth-sharded step, SAM2's
    # encoder-split and data-parallel steps, one sharded extraction each)
    for row in report["kernels"]:
        if any(rank[row["name"]] for rank in parallel):
            row["parallel"] = {"launches_per_rank": [rank[row["name"]] for rank in parallel],
                               "ranks": PARALLEL_WORLD, "backend": "gloo on one card"}
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
