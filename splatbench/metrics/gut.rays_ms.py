"""The GUT path's host span `timings["gut_rays"]` (host seconds inside
`ops/gut.py::pixel_world_rays`, the per-pixel world rays, a part of `timings["dispatch"]`) over the window's
iterations, in ms an iteration. Train cells; None where the program keeps no such span."""


def read(rec, cell):
    if rec["kind"] != "train" or not rec["iterations"]:
        return None
    seconds = rec["timings"].get("gut_rays")
    return None if seconds is None else 1e3 * seconds / rec["iterations"]
