"""95th percentile over the chunks completed in the window of the time
from a chunk's grant reaching the worker to its acknowledgement."""

from benchmark.harness.common import percentile


def read(rec):
    if rec.kind != "drain" or not rec.latencies_s:
        return None
    return percentile(rec.latencies_s, 95) * 1e3
