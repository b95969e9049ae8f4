"""The paired-heads attention kernel (``ops/flash_attention.py`` →
``csrc/attention_sm90.cu``) in fused inference: its bound time over its
kernel time in the traced window."""

from metrics._common import roofline_pct

UNIT, LAYER, MOVES = "%", "kernels", "slices_per_s"


def read(t):
    if t.entry != "fused_infer":
        return None
    return roofline_pct(t, "flash_attention", {"attention_sm90_kernel"}, ("flash_attention",))
