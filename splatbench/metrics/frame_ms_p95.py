"""The 95th percentile of every window frame's latency, request to image in host
memory, in ms (host clock). Render cells."""

import numpy as np


def read(rec, cell):
    if rec["kind"] != "render":
        return None
    return 1e3 * float(np.percentile(np.asarray(rec["latencies_s"]), 95))
