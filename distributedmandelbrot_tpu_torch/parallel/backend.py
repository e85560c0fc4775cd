"""The mesh compute backend: the port of the JAX package's
``parallel/backend.py``.

One worker leases a batch of tiles and computes it in one sharded
dispatch over every device of a :class:`~.mesh.Mesh` — the replacement
for N independent one-GPU worker processes.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np

from distributedmandelbrot_tpu_torch.core.geometry import CHUNK_WIDTH, TileSpec
from distributedmandelbrot_tpu_torch.core.workload import Workload
from distributedmandelbrot_tpu_torch.obs import events as obs_events
from distributedmandelbrot_tpu_torch.obs import flight
from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.obs.metrics import Registry
from distributedmandelbrot_tpu_torch.ops.cuda_escape import KernelUnsupported
from distributedmandelbrot_tpu_torch.parallel.mesh import Mesh, tile_mesh
from distributedmandelbrot_tpu_torch.parallel.sharding import (
    batched_escape_pixels, batched_escape_pixels_cuda)

logger = logging.getLogger("dmtpu.parallel.backend")


def batch_params(workloads: Sequence[Workload], definition: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """A lease batch as the sharded paths' ``(starts_steps, mrds)``:
    (k, 3) f64 ``(start_real, start_imag, step)`` and (k,) int64."""
    params = np.empty((len(workloads), 3), dtype=np.float64)
    mrds = np.empty(len(workloads), dtype=np.int64)
    for i, w in enumerate(workloads):
        spec = TileSpec.for_chunk(w.level, w.index_real, w.index_imag,
                                  definition=definition)
        params[i] = (spec.start_real, spec.start_imag,
                     spec.range_real / (definition - 1))
        mrds[i] = w.max_iter
    return params, mrds


class MeshBackend:
    """Computes tile batches sharded over a device mesh.

    ``kernel``: ``"auto"`` takes the CUDA kernels when the mesh's devices
    are CUDA devices and the dtype is f32, the torch loop otherwise;
    ``"cuda"`` forces the kernels (their plain versions on a CPU mesh)
    and ``"torch"`` the loop.  The kernels' int32-budget decline routes a
    batch to the torch loop, counted in ``worker_kernel_demotions``
    (route ``batch_to_torch``) and noted in the flight recorder; with
    ``kernel="cuda"`` it raises instead.  f32 tiles whose pitch f32
    cannot resolve are recomputed in f64.  Without a mesh, the local
    GPUs form one (raises without a GPU)."""

    def __init__(self, definition: int = CHUNK_WIDTH,
                 dtype: np.dtype = np.float32,
                 mesh: Optional[Mesh] = None,
                 kernel: str = "auto",
                 registry: Optional[Registry] = None) -> None:
        if kernel not in ("auto", "cuda", "torch"):
            raise ValueError(f"unknown kernel {kernel!r}")
        if kernel == "cuda" and np.dtype(dtype) != np.float32:
            # Fail at construction, not after a tile has been leased.
            raise ValueError("kernel='cuda' is f32-only")
        self.definition = definition
        self.dtype = dtype
        self.mesh = mesh if mesh is not None else tile_mesh()
        self.kernel = kernel
        self.registry = registry if registry is not None else Registry()

    def bind_registry(self, registry: Registry) -> None:
        """Adopt the worker's registry (called at worker construction)."""
        self.registry = registry

    def devices(self) -> list:
        return list(self.mesh.devices.flat)

    def _use_kernel(self) -> bool:
        if self.kernel == "cuda":
            return True  # dtype validated at construction
        if self.kernel == "torch" or np.dtype(self.dtype) != np.float32:
            return False
        return all(d.type == "cuda" for d in self.devices())

    def demotions(self) -> int:
        """Batches the kernels declined to the torch loop so far."""
        return self.registry.counter_value(
            obs_names.WORKER_KERNEL_DEMOTIONS,
            {"route": obs_names.ROUTE_BATCH_TO_TORCH}) or 0

    def compute_batch(self, workloads: Sequence[Workload]) -> list[np.ndarray]:
        if not workloads:
            return []
        params, mrds = batch_params(workloads, self.definition)
        pixels = None
        if self._use_kernel():
            try:
                pixels = batched_escape_pixels_cuda(
                    self.mesh, params, mrds, definition=self.definition)
            except KernelUnsupported as e:
                # The intentional int32-budget decline -> the torch loop;
                # real kernel errors propagate.
                if self.kernel == "cuda":
                    raise
                logger.info("kernel path declined a batch: %s", e)
                self.registry.inc(obs_names.WORKER_KERNEL_DEMOTIONS,
                                  labels={"route":
                                          obs_names.ROUTE_BATCH_TO_TORCH})
                flight.note(obs_events.WKR_DEMOTE, key=workloads[0].key,
                            route=obs_names.ROUTE_BATCH_TO_TORCH,
                            tiles=len(workloads))
        if pixels is None:
            pixels = batched_escape_pixels(self.mesh, params, mrds,
                                           definition=self.definition,
                                           dtype=self.dtype)
        out = [pixels[i].ravel() for i in range(len(workloads))]
        if np.dtype(self.dtype) == np.float32:
            # Tiles whose pixel pitch aliases in f32 would persist banded
            # from the mesh path; recompute those few in f64 so tile
            # content never depends on which backend leased it.
            from distributedmandelbrot_tpu_torch.worker.backends import (
                recompute_unresolvable_f32)
            recompute_unresolvable_f32(workloads, out, self.definition,
                                       device=self.devices()[0])
        return out
