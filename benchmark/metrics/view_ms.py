"""The window over the views completed in it: milliseconds per view,
command to PNG on disk (the window ends with its last view)."""


def read(rec):
    if rec.kind != "views" or not rec.done:
        return None
    return rec.window_s / rec.done * 1e3
