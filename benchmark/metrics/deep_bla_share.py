"""The share of the window's views that took BLA (the program's count
``deep.bla_views``: 1 for each view that took it, 0 for each that did
not) over the views done, in percent.  Nothing where the program keeps
no such count."""

KEY = "deep.bla_views"


def read(rec):
    if rec.kind != "views" or not rec.done:
        return None
    try:
        from distributedmandelbrot_tpu_torch.obs import phases
    except ImportError:
        return None
    views = phases.phase_seconds().get(KEY)
    return None if views is None else 100.0 * views / rec.done
