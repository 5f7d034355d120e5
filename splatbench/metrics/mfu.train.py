"""FP32 operations a train step needs (the benchmark's count, `sb_counts.train_step_ops`,
over the traced steps' views) at the window's rate (host clock, before the profiler
starts), as a share of the card's 67 TFLOP/s, in percent. Train cells, traced runs."""

import sb_counts


def read(rec, cell):
    work = rec.get("work")
    if rec["kind"] != "train" or not work:
        return None
    per_step = sb_counts.train_step_ops(work) / work["steps"]
    return 100.0 * per_step * rec["iterations"] / rec["window_s"] / sb_counts.PEAK_F32_S
