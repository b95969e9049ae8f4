"""Device ms per 64 slices of the backbone's (``models/dinov2.py``) kernels
that are neither products (cuBLAS) nor attention: norms, elementwise glue,
copies. A kernel is the backbone's when the host launched it inside the
benchmark's span around the backbone's forward."""

from harness.trace import BACKBONE_SPAN
from metrics._common import is_gemm

UNIT, LAYER, MOVES = "ms", "backbone", "slices_per_s"
ATTENTION = {"attention_sm90_kernel"}


def read(t):
    if t.entry != "fused_infer":
        return None
    glue = [k for k in t.launched_in(BACKBONE_SPAN)
            if not is_gemm(k.name) and k.base not in ATTENTION]
    if not glue:
        return None
    return sum(k.dur for k in glue) / 1e3 * 64 / t.work["slices"]
