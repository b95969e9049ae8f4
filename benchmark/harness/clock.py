"""The set-up's clock: seconds since the process started, and a mark of
each set-up stage on standard error, so that a run shows where its set-up
went."""

from __future__ import annotations

import os
import sys
import time

_LOADED = time.perf_counter()


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), or since this
    module was loaded where ``/proc`` has no answer."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _LOADED


def mark(stage: str) -> None:
    print(f"set-up: {stage} at {process_age_s():.2f} s", file=sys.stderr, flush=True)
