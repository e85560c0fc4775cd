"""The deep route's fixed-point orbits (its phase ``deep.orbit``: each
orbit computed on the host, in the reference search or the secondary
repair; cached orbits cost nothing) per view, host clock, in
milliseconds."""

from benchmark.harness.phases import per_view_ms


def read(rec):
    return per_view_ms(rec, "deep.orbit")
