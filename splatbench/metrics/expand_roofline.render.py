"""K1 in frames (`csrc/expand.cu`): the least time the traced frames' instance expansion
needs (`sb_counts.expand`: bytes of the visible Gaussians' tables and of their rect
instances) over the device time of the kernels below, in percent."""

import sb_counts
from sb_trace import kernel_seconds

KERNELS = ("expand_kernel",)


def read(rec, cell):
    work, trace = rec.get("work"), rec.get("trace")
    if rec["kind"] != "render" or not work or not trace:
        return None
    return sb_counts.roofline_pct(*sb_counts.expand(work), kernel_seconds(trace, KERNELS))
