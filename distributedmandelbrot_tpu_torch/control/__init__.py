"""Sharded control plane: consistent-hash ring + shard launcher.

One coordinator process owning the whole tile keyspace (the reference
architecture, kept through PR 12) caps the control plane at one event
loop's worth of grant throughput and makes that process a single point
of failure.  This package splits the keyspace across N coordinator
shards with a consistent-hash ring (``ring.py``) and launches each
shard as the existing Distributer/scheduler/recovery stack restricted
to its slice (``sharded.py``), all against one shared object store
with per-shard index/checkpoint namespacing.
"""

from distributedmandelbrot_tpu_torch.control.ring import (HashRing,
                                                    RingConfigError,
                                                    RingSlice, ShardInfo)
from distributedmandelbrot_tpu_torch.control.sharded import ShardedCoordinator

__all__ = ["HashRing", "RingConfigError", "RingSlice", "ShardInfo",
           "ShardedCoordinator"]
