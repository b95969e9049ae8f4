"""Share of the traced window in which the device ran nothing, in fused
inference: one minus the union of its activity over the window."""

from metrics._common import idle_pct

UNIT, LAYER, MOVES = "%", "device", "slices_per_s"


def read(t):
    return idle_pct(t) if t.entry == "fused_infer" else None
