"""K6 in GUT train steps (`csrc/gut_bwd.cu`): the least time the traced steps' ray blend
backward needs (`sb_counts.gut_bwd`) over the device time of the kernels below, in
percent."""

import sb_counts
from sb_trace import kernel_seconds

KERNELS = ("gut_bwd_kernel",)


def read(rec, cell):
    work, trace = rec.get("work"), rec.get("trace")
    if rec["kind"] != "train" or not work or not work.get("gut") or not trace:
        return None
    return sb_counts.roofline_pct(*sb_counts.gut_bwd(work), kernel_seconds(trace, KERNELS))
