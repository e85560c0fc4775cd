"""The fixed-point orbits the deep route computed per view (the entries
of its phase ``deep.orbit``: each orbit computed on the host, in the
reference search or the secondary repair; cached orbits are not
counted).  With ``deep_orbit_ms`` it tells more orbits from slower
ones."""

from benchmark.harness.phases import per_view_entries


def read(rec):
    return per_view_entries(rec, "deep.orbit")
