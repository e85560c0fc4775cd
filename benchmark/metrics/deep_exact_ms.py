"""The deep route's exact repair (its phase ``repair_exact``: the
fixed-point recompute of the pixels glitched against both references,
on the host) per view, host clock, in milliseconds."""

from benchmark.harness.phases import per_view_ms


def read(rec):
    return per_view_ms(rec, "repair_exact")
