"""The traced window: ``torch.profiler`` over whole units, read back from its
Chrome trace into what the per-layer readers (``metrics/``) take.

- **Busy** is the union of the device's activity (kernels, copies, sets)
  inside the window, not a sum of kernel times (``chip_smoke.py:4996``
  ``_profile`` summed them over one call; here the window is many units).
- A kernel is the program's own when its name is one the kernel build
  reports (``kernels.build_log()``, read as ``chip_smoke.py:5031``
  ``_kernel_names`` reads it).
- Each kernel keeps the host time of its launch, so that a reader can
  tell which of the benchmark's spans (``torch.profiler.record_function``
  around the calls into a layer) launched it.
- Idle gaps are named by what the host was doing at their middle: the
  innermost torch op or span running then, or host code outside any.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re
import tempfile
import time

WINDOW = "benchmark.window"
BACKBONE_SPAN = "dinov2.forward"  # the benchmark's span around the backbone's forward


@dataclasses.dataclass
class Kernel:
    name: str
    base: str  # the function's name without template arguments or parameters
    start: float  # µs, the trace's clock
    dur: float  # µs
    launch: float | None  # µs, host time of the launch call


@dataclasses.dataclass
class Reading:
    """What one traced window gives the metric readers."""

    entry: str
    window_s: float
    busy_s: float
    kernels: list[Kernel]
    spans: dict[str, list[tuple[float, float]]]  # the benchmark's own, µs
    port_kernels: set[str]
    launches: dict[str, int]  # the program's launch counters over the window
    work: dict  # the entry's counts for the traced units
    breakdown: dict

    def launched_in(self, span: str) -> list[Kernel]:
        """The kernels launched while the host was inside ``span``."""
        ranges = sorted(self.spans.get(span, []))
        starts = [a for a, _ in ranges]
        out = []
        for k in self.kernels:
            if k.launch is None:
                continue
            i = bisect.bisect_right(starts, k.launch) - 1
            if i >= 0 and ranges[i][0] <= k.launch <= ranges[i][1]:
                out.append(k)
        return out


def base_name(name: str) -> str:
    """A kernel's function name without return type, namespaces, template
    arguments or parameters."""
    name = re.sub(r"^(void|__global__)\s+", "", name.strip()).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1].strip()


def _unmangled(symbol: str) -> str | None:
    """The function's own name in an Itanium-mangled symbol (``_Z<len><name>``
    or nested ``_ZN<len><ns>...<len><name>[I...]E``)."""
    s = symbol[2:].lstrip("L")
    nested = s.startswith("N")
    s = s[1:] if nested else s
    last = None
    while (m := re.match(r"\d+", s)):
        n = int(m[0])
        last, s = s[len(m[0]):len(m[0]) + n], s[len(m[0]) + n:]
        if not nested:
            break
    return last


def port_kernel_names(build_log: str) -> set[str]:
    """The entry functions of the program's kernel build, from ``ptxas``'
    "Compiling entry function '<symbol>'" lines."""
    names = {_unmangled(m[1]) for m in re.finditer(r"Compiling entry function '(_Z\w+)'", build_log)}
    return names - {None}


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _host_at(ops: list[tuple[float, float, str]], times: list[float]) -> list[str]:
    """For each of the sorted ``times``, the innermost op (latest start)
    running then."""
    out, active, i = [], [], 0
    for t in times:
        while i < len(ops) and ops[i][0] <= t:
            active.append(ops[i])
            i += 1
        active = [op for op in active if op[1] >= t]
        out.append(max(active)[2] if active else "host code outside any torch op")
    return out


def parse(trace: dict, entry: str, port_kernels: set[str], launches: dict, work: dict) -> Reading:
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    window = next(e for e in events if e.get("cat") == "user_annotation" and e["name"] == WINDOW)
    w0, w1 = float(window["ts"]), float(window["ts"]) + float(window["dur"])
    launch_at = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_at[corr] = float(e["ts"])
    kernels, activity, spans, ops = [], [], {}, []
    for e in events:
        cat, ts, dur = e.get("cat"), float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "kernel":
            corr = (e.get("args") or {}).get("correlation")
            kernels.append(Kernel(e["name"], base_name(e["name"]), ts, dur, launch_at.get(corr)))
            activity.append((ts, ts + dur))
        elif cat in ("gpu_memcpy", "gpu_memset"):
            activity.append((ts, ts + dur))
        elif cat == "user_annotation" and e["name"] != WINDOW:
            spans.setdefault(e["name"], []).append((ts, ts + dur))
            ops.append((ts, ts + dur, e["name"]))
        elif cat == "cpu_op":
            ops.append((ts, ts + dur, e["name"]))
    busy = _union([(max(a, w0), min(b, w1)) for a, b in activity if b > w0 and a < w1])
    busy_us = sum(b - a for a, b in busy)
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    names = _host_at(sorted(ops), [(a + b) / 2 for a, b in gaps])
    idle: dict[str, float] = {}
    for (a, b), name in zip(gaps, names):
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    by_kernel: dict[str, float] = {}
    for k in kernels:
        if w0 <= k.start <= w1:
            by_kernel[k.name[:160]] = by_kernel.get(k.name[:160], 0.0) + k.dur / 1e6
    top = lambda d: [[n, s] for n, s in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return Reading(
        entry=entry, window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
        kernels=[k for k in kernels if w0 <= k.start <= w1], spans=spans,
        port_kernels=port_kernels, launches=launches, work=work,
        breakdown={"device_ops": top(by_kernel), "idle_gaps": top(idle)},
    )


def traced(run_window, entry: str, work_of):
    """Run ``run_window()`` (whole units, ending in a synchronize) under the
    profiler; returns (its result, the :class:`Reading`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from cryovit_tpu_torch import kernels as port_kernels

    on_card = torch.cuda.is_available()
    port_kernels.reset_launch_counts()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            result = run_window()
            if on_card:
                torch.cuda.synchronize()
    launches = port_kernels.launch_counts()
    t0 = time.perf_counter()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    reading = parse(trace, entry, port_kernel_names(port_kernels.build_log()), launches,
                    work_of(result))
    reading.parse_s = time.perf_counter() - t0
    return result, reading
