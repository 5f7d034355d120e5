"""Process start to the first timed iteration or frame, in seconds (host clock): the
inputs, the kernels' load (and build, on a checkout's first run), the Trainer or scene,
and the warm-up."""


def read(rec, cell):
    return rec["setup_s"]
