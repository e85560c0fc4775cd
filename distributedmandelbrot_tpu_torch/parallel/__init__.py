"""Device-mesh parallelism: tile batching, within-tile sharding, multi-process."""

from distributedmandelbrot_tpu_torch.parallel.backend import MeshBackend
from distributedmandelbrot_tpu_torch.parallel.mesh import (ROW_AXIS, TILE_AXIS,
                                                           local_devices,
                                                           tile_mesh,
                                                           tile_row_mesh)
from distributedmandelbrot_tpu_torch.parallel.sharding import (
    batched_escape_pixels, batched_escape_pixels_cuda,
    compute_tile_row_sharded)

__all__ = ["MeshBackend", "ROW_AXIS", "TILE_AXIS", "local_devices",
           "tile_mesh", "tile_row_mesh", "batched_escape_pixels",
           "batched_escape_pixels_cuda", "compute_tile_row_sharded"]
