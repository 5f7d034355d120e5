"""FP32 operations a frame needs (`sb_counts.frame_ops` over the traced frames'
poses) at the window's frame rate (host clock), as a share of the card's 67 TFLOP/s,
in percent. Render cells, traced runs."""

import sb_counts


def read(rec, cell):
    work = rec.get("work")
    if rec["kind"] != "render" or not work:
        return None
    per_frame = sb_counts.frame_ops(work) / work["steps"]
    return 100.0 * per_frame * rec["frames"] / rec["window_s"] / sb_counts.PEAK_F32_S
