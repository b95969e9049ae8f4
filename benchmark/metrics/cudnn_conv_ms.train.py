"""Device ms per train step in the library's convolution kernels (cuDNN's
forward, data- and weight-gradient kernels): the channels-first convs,
such as ``models/cryovit.py`` ``_conv_cf`` (the decoder's front)."""

from metrics._common import is_conv

UNIT, LAYER, MOVES = "ms", "library convs", "train_step_ms"


def read(t):
    if t.entry != "train_step":
        return None
    convs = [k for k in t.kernels if k.base not in t.port_kernels and is_conv(k.name)]
    if not convs:
        return None
    return sum(k.dur for k in convs) / 1e3 / t.work["steps"]
