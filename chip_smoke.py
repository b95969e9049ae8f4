"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device  — a CUDA device is required (there is no CPU path); prints the
   card's name and power limit from nvidia-smi.
2. build   — builds the hand-written kernels from ``cryovit_tpu_torch/csrc``.
3. kernels — each kernel against its plain PyTorch version, in bf16, at the
   shapes the serving path gives it for a 64×512×512 tomogram, with kernel
   and plain times from CUDA events.
4. reference — the serving path on the GPU (bf16, kernels) against the same
   path on the CPU (f32, plain versions) on a small input.
5. main path — a synthetic 64×512×512 uint8 tomogram written as MRC; the
   full-width DINOv2 ViT-g/14 with seeded random weights and a seeded CryoVIT
   decoder saved as a ``.model``; fused inference (raw tomogram → masks) and
   feature extraction on it. Launch counters are zeroed just before and read
   just after; every kernel must have run.

The next-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

# f32 products in the plain versions and the CPU reference run in full f32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEPTH, SIDE = 64, 512  # the main path's tomogram
SLICE_BATCH = 64
ATTN_SHAPE = (64, 1029, 24)  # (slices per chunk, tokens at 512², heads of 64)
# (Ci, Co, H = W, depth dilation) of every conv3d_dm call for a 512² tomogram
CONV_SHAPES = [(32, 32, 128, 8), (32, 32, 128, 4), (32, 16, 256, 2), (16, 16, 256, 1),
               (8, 8, 512, 1), (8, 1, 512, 1)]
# (Ci, Co, H = W) of every convt2x_dm call
CONVT_SHAPES = [(32, 32, 128), (16, 8, 256)]
KERNELS = {
    "flash_attention": ("cryovit_tpu_torch/csrc/flash_attention.cu",
                        "cryovit_tpu/ops/flash_attention.py:226"),
    "conv3d_dm": ("cryovit_tpu_torch/csrc/conv3d_dm.cu", "cryovit_tpu/ops/conv3d_dm.py:162"),
    "convt2x_dm": ("cryovit_tpu_torch/csrc/convt_dm.cu", "cryovit_tpu/ops/convt_dm.py:74"),
}


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


def compare(name: str, kernel_fn, plain_fn, iters: int) -> tuple[float, float, float]:
    """Kernel vs plain version on the same inputs: max |error| (checked at
    four bf16 ulps of the largest output, 2^-6·max|plain|), kernel ms,
    plain ms."""
    got, want = kernel_fn().float(), plain_fn().float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = 2.0**-6 * want.abs().max().item()
    if not (err <= tol and torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel vs plain max |err| {err} > tol {tol}")
    del got, want
    k_ms, p_ms = time_ms(kernel_fn, iters), time_ms(plain_fn, max(1, iters // 4))
    return err, k_ms, p_ms


def kernel_phase(dev: torch.device) -> dict[str, dict]:
    from cryovit_tpu_torch.ops import conv3d_dm as cd
    from cryovit_tpu_torch.ops import convt_dm as ct
    from cryovit_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    results = {}
    b, n, h = ATTN_SHAPE
    c = h * fa.HEAD_DIM
    qkv = randn(b, n, 3 * c)  # q, k, v as column views, as the model passes them
    q, k, v = qkv[..., :c], qkv[..., c : 2 * c], qkv[..., 2 * c :]
    bias = randn(3, c, scale=0.5)
    err, k_ms, p_ms = compare(
        "flash_attention",
        lambda: fa.flash_attention(q, k, v, bias, h),
        lambda: fa.flash_attention_reference(q, k, v, bias, h),
        iters=10,
    )
    flops = 4 * b * h * n * n * fa.HEAD_DIM
    log("kernels", f"flash_attention B={b} N={n} H={h}x64: max|err| {err:.3g}, "
        f"kernel {k_ms:.3f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s), plain {p_ms:.3f} ms")
    results["flash_attention"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms)
    del qkv, q, k, v

    total = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
    for ci, co, side, dil in CONV_SHAPES:
        x = randn(1, DEPTH, ci, side, side)
        w = randn(3, 3, 3, ci, co, scale=(27 * ci) ** -0.5)
        err, k_ms, p_ms = compare(
            "conv3d_dm",
            lambda: cd.conv3d_dm(x, w, (dil, 1, 1)),
            lambda: cd.conv3d_dm_reference(x, w, (dil, 1, 1)),
            iters=8,
        )
        log("kernels", f"conv3d_dm {ci}->{co} at {DEPTH}x{side}^2 dil {dil}: max|err| "
            f"{err:.3g}, kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
        total = dict(max_abs_err=max(total["max_abs_err"], err), ms=total["ms"] + k_ms,
                     plain_ms=total["plain_ms"] + p_ms)
    results["conv3d_dm"] = total

    total = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
    for ci, co, side in CONVT_SHAPES:
        x = randn(1, DEPTH, ci, side, side)
        w = randn(1, 2, 2, ci, co, scale=ci**-0.5)
        err, k_ms, p_ms = compare(
            "convt2x_dm", lambda: ct.convt2x_dm(x, w), lambda: ct.convt2x_dm_reference(x, w),
            iters=8,
        )
        log("kernels", f"convt2x_dm {ci}->{co} at {DEPTH}x{side}^2 -> {2 * side}^2: max|err| "
            f"{err:.3g}, kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
        total = dict(max_abs_err=max(total["max_abs_err"], err), ms=total["ms"] + k_ms,
                     plain_ms=total["plain_ms"] + p_ms)
    results["convt2x_dm"] = total
    log("kernels", "conv3d_dm and convt2x_dm ms are sums over the shapes above "
        "(one decoder tail pass); flash_attention ms is one call (one block, one chunk)")
    return results


def reference_phase(dev: torch.device) -> None:
    """Small input: GPU bf16 through the kernels vs CPU f32 through the plain
    versions, same seeded weights; probabilities within 2e-2 (bf16)."""
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
    probs = {}
    for device, dtype in ((dev, torch.bfloat16), (torch.device("cpu"), torch.float32)):
        fused = FusedDinoCryoVIT(
            make_dinov2(dino_sd, cfg, device=device, dtype=dtype),
            make_cryovit(dec_sd, device=device, dtype=dtype),
        )
        probs[device.type] = fused.segment(stack).float().cpu()
    err = (probs["cuda"] - probs["cpu"]).abs().max().item()
    agree = ((probs["cuda"] >= 0.5) == (probs["cpu"] >= 0.5)).float().mean().item()
    log("reference", f"4x128x160 tomogram, small backbone + full decoder: GPU bf16 vs CPU f32 "
        f"max|dprob| {err:.3g} (tol 2e-2), masks agree on {100 * agree:.3f}% of voxels, "
        f"prob std {probs['cpu'].std().item():.3f}")
    if not err <= 2e-2:
        raise AssertionError(f"GPU path disagrees with the CPU reference: {err}")


def main_path_phase(dev: torch.device, workdir: Path) -> dict[str, int]:
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
    log("main", f"ViT-g/14 ({n_params / 1e9:.3f} B params, "
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
    log("main", f"fused inference: {DEPTH} slices in {t_infer:.3f} s = "
        f"{DEPTH / t_infer:.2f} slices/s ({name})")
    log("main", f"feature extraction: {DEPTH} slices in {t_feat:.3f} s = "
        f"{DEPTH / t_feat:.2f} slices/s ({name})")
    log("main", f"peak device memory {peak / 2**30:.2f} GiB ({name})")
    log("main", f"launches during the main path: {counts}")
    checks = {
        f"probabilities {(DEPTH, SIDE, SIDE)}": probs.shape == (DEPTH, SIDE, SIDE),
        "probabilities finite": bool(np.isfinite(probs).all()),
        "probabilities in [0, 1]": bool(probs.min() >= 0.0 and probs.max() <= 1.0),
        "masks uint8 0/1": masks.dtype == np.uint8 and set(np.unique(masks)) <= {0, 1},
        f"features {(1536, DEPTH, SIDE // 16, SIDE // 16)} fp16":
            feats.shape == (1536, DEPTH, SIDE // 16, SIDE // 16) and feats.dtype == np.float16,
        "features finite": bool(np.isfinite(feats).all()),
        "every kernel launched": all(n > 0 for n in counts.values()),
    }
    log("main", f"probabilities mean {probs.mean():.4f} std {probs.std():.4f}, "
        f"mask fraction {masks.mean():.4f}")
    for what, ok in checks.items():
        log("check", f"{what}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError("main path checks failed")

    if importlib.util.find_spec("h5py") is None:
        log("main", "h5py is not installed here: the HDF5 writers (PredictionWriter, "
            "save_feature_hdf) are not run; the results above come from "
            "fused_predictions and extract_features, the steps right below them")
    else:
        writer = PredictionWriter(workdir / "masks", label_key)
        writer.on_predict_batch_end(predictions[0])
        path, volume, feats = extracted[0]
        save_feature_hdf({"data": volume}, feats, f"{path.stem}.hdf", workdir / "features")
        log("main", f"wrote {writer.result_paths[0].name} and features/{path.stem}.hdf")
    return counts


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
    kernel = ""
    for line in kernels.build_log().splitlines():  # nvcc -Xptxas -v report
        if "Compiling entry function" in line:
            m = re.search(r"((?:flash_attention|conv3d_dm|convt2x_dm)_kernel)(?:ILi(\d+)E)?", line)
            kernel = f"{m[1]}<{m[2]}>" if m and m[2] else (m[1] if m else line)
        elif "Used" in line:
            log("build", f"{kernel}: {line.split(':', 1)[1].strip()}")

    results = kernel_phase(dev)
    reference_phase(dev)
    with tempfile.TemporaryDirectory(prefix="cryovit_smoke_") as tmp:
        counts = main_path_phase(dev, Path(tmp))

    report = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": counts[name], **results[name]}
        for name, (source, replaces) in KERNELS.items()
    ]}
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
