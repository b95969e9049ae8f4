"""The depth-major conv kernels (``ops/conv3d_dm.py``, ``ops/convt_dm.py`` →
``csrc/conv3d_dm*.cu``, ``csrc/convt_dm*.cu``, with their partial-sum
reduction) in train steps: their bound time over their kernel time."""

from metrics._common import roofline_pct

UNIT, LAYER, MOVES = "%", "kernels", "train_step_ms"

BASES = {"conv3d_dm_kernel", "conv3d_dm_dw_kernel", "convt2x_dm_kernel",
         "convt2x_dm_bwd_kernel", "sum_partials_kernel"}


def read(t):
    if t.entry != "train_step":
        return None
    return roofline_pct(t, "conv_dm", BASES,
                        ("conv3d_dm", "conv3d_dm_dw", "convt2x_dm", "convt2x_dm_bwd"))
