"""Build-and-load for the hand-written Hopper kernels in ``csrc/``.

The CUDA sources are compiled on first use with ``nvcc``, one process per
source started together, and linked into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds) under
``build/cryovit_tpu_torch/`` at the root of the checkout, and loaded with
``ctypes``. The library's file name carries a hash of the
sources and flags, so a changed source rebuilds and an unchanged one loads
the library already built.

Every kernel wrapper (``ops/``) counts its launches in :data:`LAUNCHES`, so a
run can show that its main path went through the kernels: reset with
:func:`reset_launch_counts`, read with :func:`launch_counts`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = [
    "KERNELS",
    "LAUNCHES",
    "build_log",
    "check",
    "count_launch",
    "grid_blocks",
    "launch_counts",
    "load_library",
    "reset_launch_counts",
]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cryovit_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

KERNELS = (  # launch-counter names
    "flash_attention", "conv3d_dm", "convt2x_dm", "conv3d_dm_dw", "convt2x_dm_bwd",
    "window_block_attention", "window_block_mlp", "window_attention",
    "flash_attention_bhnd", "flash_attention_bnhd", "residual_layernorm",
    "flash_attention_int8", "flash_attention_int8_scales", "flash_attention_int8_operands",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_ARGTYPES = {
    # q, k, v, bias, out, batch, seq, heads, row_stride, batch_stride,
    # kv_len, scale_log2, stream
    "cryovit_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _I, _F, _P],
    # q, k, v, bias, sq, sk, sv, batch, seq, heads, row_stride, batch_stride,
    # kv_len, chunk_rows, chunks, mode, stream
    "cryovit_attention_int8_scales": [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _I, _I, _I, _I, _P,
    ],
    # k, v, bias, sk, sv, k_op, v_op, batch, heads, row_stride, batch_stride,
    # kv_len, n_pad, mode, stream
    "cryovit_attention_int8_operands": [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _LL, _LL, _I, _I, _I, _P,
    ],
    # q, bias, sq, sk, sv, k_op, v_op, out, clocks, batch, seq, heads,
    # row_stride, batch_stride, kv_len, chunk_rows, chunks, n_pad,
    # scale_log2, mode, stream
    "cryovit_flash_attention_int8": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _I, _I, _I, _I, _F, _I, _P,
    ],
    # q, k, v, out, batch, seq, heads, strides (12: (batch, head, token) of
    # q, k, v, out), scale_log2, stream
    "cryovit_flash_attention_strided": [
        _P, _P, _P, _P, _I, _I, _I, ctypes.POINTER(_LL), _F, _P,
    ],
    # x, h, gamma (or null), scale, bias, x_out, y_out, rows, channels, x_f32,
    # h_f32, eps, stream
    "cryovit_residual_layernorm": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # x, w (packed), y, batch, depth, ci, co, height, width, dilation,
    # nblocks, stream
    "cryovit_conv3d_dm": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, w, y, batch, depth, ci, co, height, width, nblocks, stream
    "cryovit_convt2x_dm": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, g, partial, dw, batch, depth, ci, co, height, width, dilation,
    # nblocks, stream
    "cryovit_conv3d_dm_dw": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # g, x, w, dx, partial, dw, batch, depth, ci, co, height, width, nblocks,
    # stream
    "cryovit_convt2x_dm_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, out, batch, seq, heads, head_dim, row_stride, batch_stride,
    # stream
    "cryovit_window_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _P],
    # x, ln_w, ln_b, w_qkv, b_qkv, w_proj, b_proj, qkv, attn, out, windows,
    # tokens, channels, heads, eps, stream
    "cryovit_window_block_attention": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P,
    ],
    # x, ln_w, ln_b, w1, b1, w2, b2, hidden, out, rows, channels, hidden_dim,
    # eps, stream
    "cryovit_window_block_mlp": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
}


LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def grid_blocks(device, n_items: int, per_sm: int = 2) -> int:
    """Blocks for a kernel that strides its blocks over ``n_items`` work
    items and reduces their partial results afterwards: ``per_sm`` per SM,
    at most one per item."""
    import torch

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(per_sm * sms, n_items))


def _find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if root:
            candidates.append(str(Path(root) / "bin" / "nvcc"))
    for cand in candidates:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError(
        "cannot build the CUDA kernels: nvcc was not found on PATH, in "
        "$CUDA_HOME/bin or in /usr/local/cuda/bin. The kernels need the CUDA "
        "toolkit (nvcc, sm_90a) and an NVIDIA Hopper GPU; CPU tensors use the "
        "plain PyTorch versions in cryovit_tpu_torch.ops instead."
    )


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libcryovit_kernels_{digest.hexdigest()[:16]}.so"


def build_log() -> str:
    """The compiler's output (``-Xptxas -v`` register and shared-memory
    report) for the library :func:`load_library` loads, or "" if it was not
    built yet."""
    log = _library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    return proc.stdout + proc.stderr


def _build(target: Path) -> None:
    """One ``nvcc -c`` per source, all at once, then one link into the
    shared library."""
    from concurrent.futures import ThreadPoolExecutor

    nvcc = _find_nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{target.stem}.{os.getpid()}"
    sources = _sources()
    objects = [target.with_name(f"{tag}.{src.stem}.o") for src in sources]
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        logs = list(pool.map(
            lambda so: _run([nvcc, *NVCC_FLAGS, "-c", str(so[0]), "-o", str(so[1])]),
            zip(sources, objects),
        ))
    tmp = target.with_name(f"{tag}.so.tmp")
    _run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objects)])
    for obj in objects:
        obj.unlink()
    target.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, target)


def load_library() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library.

    Raises ``RuntimeError`` naming nvcc when the CUDA toolkit is missing:
    a caller that asked for a kernel never gets the plain version instead.
    """
    global _lib
    with _lock:
        if _lib is None:
            path = _library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for fn_name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
