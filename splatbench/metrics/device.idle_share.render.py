"""1 - the union of the device's kernel intervals over the profiled stretch of frames
(torch.profiler, after the window), in percent."""


def read(rec, cell):
    trace = rec.get("trace")
    if rec["kind"] != "render" or not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
