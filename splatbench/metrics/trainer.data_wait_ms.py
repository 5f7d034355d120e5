"""The Trainer's `timings["data_wait"]` (host seconds waiting for the loader's next
sample) over the window's iterations, in ms an iteration. Train cells."""


def read(rec, cell):
    if rec["kind"] != "train" or not rec["iterations"]:
        return None
    return 1e3 * rec["timings"]["data_wait"] / rec["iterations"]
