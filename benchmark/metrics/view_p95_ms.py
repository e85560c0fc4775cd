"""95th percentile of the views' latencies, command to PNG."""

from benchmark.harness.common import percentile


def read(rec):
    if rec.kind != "views" or not rec.latencies_s:
        return None
    return percentile(rec.latencies_s, 95) * 1e3
