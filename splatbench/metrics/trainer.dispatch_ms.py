"""The Trainer's `timings["dispatch"]` (host seconds spent handing chunks of steps to
the device) over the window's iterations, in ms an iteration. Train cells."""


def read(rec, cell):
    if rec["kind"] != "train" or not rec["iterations"]:
        return None
    return 1e3 * rec["timings"]["dispatch"] / rec["iterations"]
