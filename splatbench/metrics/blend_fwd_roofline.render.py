"""K2 in frames (`csrc/blend_fwd.cu`, float32 features): the least time the traced
frames' blend needs (`sb_counts.blend_fwd`) over the device time of the kernels below,
in percent."""

import sb_counts
from sb_trace import kernel_seconds

KERNELS = ("blend_fwd_kernel",)


def read(rec, cell):
    work, trace = rec.get("work"), rec.get("trace")
    if rec["kind"] != "render" or not work or not trace:
        return None
    return sb_counts.roofline_pct(*sb_counts.blend_fwd(work, cell["features"]),
                                  kernel_seconds(trace, KERNELS))
