"""Device meshes: the port of the JAX package's ``parallel/mesh.py``.

A worker process drives every local GPU through one :class:`Mesh`, and
the multi-process worker (:mod:`.multihost`) extends it over the ranks
of a ``torch.distributed`` group.  Two shapes cover the parallelism:

- 1-D ``(tiles,)``: data parallelism over a batch of tiles (the
  throughput shape);
- 2-D ``(tiles, rows)``: batch sharding with each tile's rows split
  over devices (the latency shape).

:class:`Mesh` is a small frozen value of its own: ``torch.distributed``'s
``DeviceMesh`` needs a process group, which a one-process worker does
not have.  A mesh may name one card more than once (``[cuda:0,
cuda:0]``): each position is a shard with its own stream, which is how a
one-GPU machine, and the CPU tests, exercise the split.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

TILE_AXIS = "tiles"
ROW_AXIS = "rows"


@dataclass(frozen=True, eq=False)
class Mesh:
    """An array of ``torch.device`` with one name per axis.  ``devices``
    and ``shape`` read as ``jax.sharding.Mesh``'s do; ``process_ids``
    (same shape) names the rank owning each device in a multi-process
    mesh, None in a one-process one."""

    devices: np.ndarray
    axis_names: tuple
    process_ids: Optional[np.ndarray] = None

    def __post_init__(self) -> None:
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D devices for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    def local_devices(self, process_id: int = 0) -> list:
        """The devices of this mesh owned by ``process_id``, in mesh
        order (every device, in a one-process mesh)."""
        flat = list(self.devices.flat)
        if self.process_ids is None:
            return flat
        return [d for d, p in zip(flat, self.process_ids.flat)
                if p == process_id]


def _device_array(devices: Sequence) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = torch.device(d)
    return arr


def make_mesh(devices: Sequence, axis_names=(TILE_AXIS,)) -> Mesh:
    """A 1-D mesh over ``devices`` (torch devices or their names, in
    shard order; repeats allowed)."""
    return Mesh(_device_array(devices), tuple(axis_names))


def local_devices() -> list[torch.device]:
    """This process's CUDA devices.  Raises without a GPU: a CPU mesh is
    built only by a caller that names CPU devices (:func:`make_mesh`)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available for a device mesh; build one from "
            "CPU devices explicitly (make_mesh(['cpu'])) to run the "
            "plain versions")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_ring(n_devices: Optional[int] = None) -> list[torch.device]:
    """Local devices in canonical placement order: the one ordering
    shared by the mesh route and the pipelined executor's round-robin
    dispatch, so tile ``i`` of a batch lands on the same card either
    way."""
    devices = local_devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return devices


def tile_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over the local GPUs for tile-batch data parallelism."""
    return make_mesh(device_ring(n_devices))


def tile_row_mesh(tiles: int, rows: int,
                  devices: Optional[Sequence] = None) -> Mesh:
    """2-D mesh: ``tiles x rows`` devices; rows shard within each tile."""
    devs = list(devices) if devices is not None else local_devices()
    if tiles * rows > len(devs):
        raise ValueError(
            f"mesh {tiles}x{rows} needs {tiles * rows} devices, "
            f"have {len(devs)}")
    grid = _device_array(devs[:tiles * rows]).reshape(tiles, rows)
    return Mesh(grid, (TILE_AXIS, ROW_AXIS))
