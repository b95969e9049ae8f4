"""Shared arithmetic of the per-layer readers (not a metric: the harness
skips files whose name starts with ``_``)."""

from __future__ import annotations

from harness.peaks import PEAK_BF16_FLOPS

GEMM_FRAGMENTS = ("gemm", "nvjet", "cutlass", "cublas")
CONV_FRAGMENTS = ("conv", "fprop", "dgrad", "wgrad", "cudnn", "implicit_convolve")


def idle_pct(t) -> float:
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu_pct(t) -> float:
    return 100.0 * t.work["model_flops"] / t.window_s / PEAK_BF16_FLOPS


def is_conv(name: str) -> bool:
    low = name.lower()
    return any(f in low for f in CONV_FRAGMENTS)


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(f in low for f in GEMM_FRAGMENTS) and not is_conv(name)


def roofline_pct(t, group: str, bases: set[str], counters: tuple[str, ...]):
    """Summed bound time over summed kernel time of the port kernels
    ``bases`` (those the build reports), or None where the window ran none
    of them, or ran other launches than the work counted (then the count,
    not the kernel, would be measured)."""
    names = bases & t.port_kernels
    kernels = [k for k in t.kernels if k.base in names]
    bound = t.work.get("bounds_s", {}).get(group)
    if not kernels or not bound:
        return None
    expected = t.work.get("launches", {})
    if any(t.launches.get(c, 0) != expected.get(c, 0) for c in counters):
        import sys

        print(f"{group}: launches {[(c, t.launches.get(c)) for c in counters]} are not the "
              f"counted {[(c, expected.get(c)) for c in counters]}", file=sys.stderr)
        return None
    return 100.0 * bound / (sum(k.dur for k in kernels) / 1e6)
