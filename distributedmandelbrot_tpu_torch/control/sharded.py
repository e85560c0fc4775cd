"""One shard of the sharded control plane.

:class:`ShardedCoordinator` is the launcher behind ``dmtpu coord
--shard K/N --ring ring.json``: it resolves the shard's
:class:`~distributedmandelbrot_tpu_torch.control.ring.RingSlice` and runs the
existing Distributer / scheduler / recovery stack
(:class:`~distributedmandelbrot_tpu_torch.coordinator.app.Coordinator`) over
that slice against ONE shared data directory.  Nothing about the inner
stack is shard-aware beyond the slice it is handed: the scheduler's
frontier is filtered to owned keys, the store's index log / checkpoint
blob / level claims carry the ``-sKofN`` namespace, and the distributer
answers misrouted uploads with the authoritative owner.

The ownership function needs only ``K/N`` (ring.py: endpoints never
feed the hash), so a fleet launcher may start all N shards on ephemeral
ports first, then collect the bound ports into ``ring.json`` for the
workers — :meth:`ShardedCoordinator.bound_info` is the per-shard entry
of that table.
"""

from __future__ import annotations

from typing import Optional, Sequence

from distributedmandelbrot_tpu_torch.control.ring import (DEFAULT_REPLICAS,
                                                    RingSlice, ShardInfo,
                                                    load_ring_for_shard,
                                                    parse_shard_spec)
from distributedmandelbrot_tpu_torch.coordinator.app import Coordinator
from distributedmandelbrot_tpu_torch.core.workload import LevelSetting


class ShardedCoordinator:
    """Coordinator shard ``K/N``: the full stack over one ring slice.

    ``ring_path=None`` launches endpoint-blind (ownership from ``K/N``
    alone); every extra keyword argument flows to
    :class:`Coordinator` unchanged, so shards support the whole single-
    coordinator surface (gateway, exporter, checkpoints, fault clocks).
    """

    def __init__(self, level_settings: Sequence[LevelSetting],
                 shard: int, n_shards: int, *,
                 ring_path: Optional[str] = None,
                 ring_version: int = 1,
                 replicas: int = DEFAULT_REPLICAS,
                 **coordinator_kwargs) -> None:
        self.ring_slice: RingSlice = load_ring_for_shard(
            ring_path, shard, n_shards,
            version=ring_version, replicas=replicas)
        self.coordinator = Coordinator(level_settings,
                                       ring_slice=self.ring_slice,
                                       **coordinator_kwargs)

    @classmethod
    def from_spec(cls, level_settings: Sequence[LevelSetting], spec: str,
                  **kwargs) -> "ShardedCoordinator":
        """``"K/N"`` spec form (the CLI's ``--shard`` argument)."""
        shard, n_shards = parse_shard_spec(spec)
        return cls(level_settings, shard, n_shards, **kwargs)

    # -- identity ----------------------------------------------------------

    @property
    def shard(self) -> int:
        return self.ring_slice.shard

    @property
    def n_shards(self) -> int:
        return self.ring_slice.n_shards

    @property
    def namespace(self) -> str:
        return self.ring_slice.namespace

    def bound_info(self, host: str = "127.0.0.1") -> ShardInfo:
        """This shard's row of a post-launch ring table: the ports the
        services actually bound (ephemeral-port launches report real
        ports here after ``start()``)."""
        return ShardInfo(host,
                         distributer_port=self.coordinator.distributer_port,
                         dataserver_port=self.coordinator.dataserver_port,
                         gateway_port=self.coordinator.gateway_port or 0,
                         exporter_port=self.coordinator.exporter_port or 0)

    # -- delegated lifecycle ----------------------------------------------

    async def start(self) -> None:
        await self.coordinator.start()

    async def stop(self) -> None:
        await self.coordinator.stop()

    async def run_forever(self) -> None:
        await self.coordinator.run_forever()

    # -- delegated surface the tests/benches poke --------------------------

    @property
    def scheduler(self):
        return self.coordinator.scheduler

    @property
    def counters(self):
        return self.coordinator.counters

    @property
    def store(self):
        return self.coordinator.store

    @property
    def distributer_port(self) -> int:
        return self.coordinator.distributer_port

    @property
    def dataserver_port(self) -> int:
        return self.coordinator.dataserver_port

    @property
    def gateway_port(self) -> Optional[int]:
        return self.coordinator.gateway_port

    @property
    def exporter_port(self) -> Optional[int]:
        return self.coordinator.exporter_port
