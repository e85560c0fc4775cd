"""The deep route's probe scans (its phase ``deep.probe``: each probe
lattice of the reference search, from its upload through the scan on the
card to its read-back) per view, host clock, in milliseconds."""

from benchmark.harness.phases import per_view_ms


def read(rec):
    return per_view_ms(rec, "deep.probe")
