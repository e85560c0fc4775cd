"""Set-up: from the process's start to the window's, imports, the card's
context, the kernels' library (built on the first run in a checkout),
the native library, the warm-up and the cell's own preparation."""


def read(rec):
    return rec.setup_s
