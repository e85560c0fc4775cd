"""The deep route's reference search, BLA probe and tables, and glitch
repairs (secondary reference, exact fixed point) per view, from
``perturbation.phase_seconds()``, in milliseconds.  A BLA table that the
secondary pass builds is counted in both of its phases."""


def read(rec):
    if rec.kind != "views" or not rec.done:
        return None
    return sum(rec.phases[name] for name in (
        "reference", "bla_probe", "bla_table", "repair_secondary",
        "repair_exact")) / rec.done * 1e3
