"""Trainer iterations completed in the window over its seconds (host clock; the window
opens and closes behind a device synchronisation). Train cells."""


def read(rec, cell):
    if rec["kind"] != "train":
        return None
    return rec["iterations"] / rec["window_s"]
