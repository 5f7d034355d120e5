"""The window's seconds over the frames whose image reached host memory in it, in ms
(host clock). Render cells."""


def read(rec, cell):
    if rec["kind"] != "render":
        return None
    return 1e3 * rec["window_s"] / rec["frames"]
