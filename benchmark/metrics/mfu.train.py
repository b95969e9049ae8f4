"""The whole train step's share of the bf16 peak: model FLOPs of the
traced steps (forward and both gradients, no recomputation counted,
``flops/<config>.py``) over the window."""

from metrics._common import mfu_pct

UNIT, LAYER, MOVES = "%", "whole step", "train_step_ms"


def read(t):
    return mfu_pct(t) if t.entry == "train_step" else None
