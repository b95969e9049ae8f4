"""The whole fused pass's share of the bf16 peak: model FLOPs of the traced
tomograms (backbone and decoder, ``flops/<config>.py``) over the window."""

from metrics._common import mfu_pct

UNIT, LAYER, MOVES = "%", "whole step", "slices_per_s"


def read(t):
    return mfu_pct(t) if t.entry == "fused_infer" else None
