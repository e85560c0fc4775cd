"""Share of the window in which no kernel, copy or fill ran on the card
(1 - the union of the trace's device intervals over the window)."""


def read(rec):
    if rec.kind != "views" or rec.trace is None:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
