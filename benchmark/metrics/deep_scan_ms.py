"""The deep route's scans (``perturbation.phase_seconds()["scan"]``, each
row chunk to its fetch) per view, in milliseconds."""


def read(rec):
    if rec.kind != "views" or not rec.done:
        return None
    return rec.phases["scan"] / rec.done * 1e3
