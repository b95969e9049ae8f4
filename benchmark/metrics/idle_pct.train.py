"""Share of the traced window in which the device ran nothing, in train
steps: one minus the union of its activity over the window."""

from metrics._common import idle_pct

UNIT, LAYER, MOVES = "%", "device", "train_step_ms"


def read(t):
    return idle_pct(t) if t.entry == "train_step" else None
