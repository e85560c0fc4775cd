"""The backend's dispatch and materialize seconds
(``worker_backend_phase_seconds``) in the window, per chunk completed,
in milliseconds."""


def read(rec):
    if rec.kind != "drain" or not rec.done:
        return None
    total, count = rec.hists["worker_backend_phase_seconds"]
    return total / rec.done * 1e3 if count else None
