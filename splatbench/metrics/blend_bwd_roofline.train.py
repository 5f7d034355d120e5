"""K3 in train steps (`csrc/blend_bwd.cu`): the least time the traced steps' blend
backward needs (`sb_counts.blend_bwd`) over the device time of the kernels below, in
percent."""

import sb_counts
from sb_trace import kernel_seconds

KERNELS = ("blend_bwd_kernel",)


def read(rec, cell):
    work, trace = rec.get("work"), rec.get("trace")
    if rec["kind"] != "train" or not work or work.get("gut") or not trace:
        return None
    return sb_counts.roofline_pct(*sb_counts.blend_bwd(work, cell["features"]),
                                  kernel_seconds(trace, KERNELS))
