"""Chunks returned to the source within the window, over the window."""


def read(rec):
    if rec.kind != "drain":
        return None
    return rec.done / rec.window_s
