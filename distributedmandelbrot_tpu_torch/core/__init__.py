"""Pure domain model: tile geometry, workload identity, chunk data."""

from distributedmandelbrot_tpu_torch.core.chunk import Chunk
from distributedmandelbrot_tpu_torch.core.geometry import (CHUNK_PIXELS,
                                                           CHUNK_WIDTH,
                                                           MAX_AXIS, MIN_AXIS,
                                                           TileSpec,
                                                           chunk_origin,
                                                           level_chunk_range,
                                                           spec_f32_resolvable,
                                                           validate_indices)
from distributedmandelbrot_tpu_torch.core.workload import (
    WORKLOAD_WIRE_SIZE, LevelSetting, Workload, parse_level_settings)

__all__ = [
    "CHUNK_PIXELS", "CHUNK_WIDTH", "MAX_AXIS", "MIN_AXIS", "TileSpec",
    "chunk_origin", "level_chunk_range", "spec_f32_resolvable",
    "validate_indices", "Chunk", "WORKLOAD_WIRE_SIZE", "LevelSetting",
    "Workload", "parse_level_settings",
]
