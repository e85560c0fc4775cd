"""The chunk data model: a computed tile's pixels plus its grid identity.

Pixel value semantics (uint8), matching the reference
(``DistributedMandelbrotWorkerCUDA.py:96-98`` and ``DataChunk.cs:82-87``):

- ``0``  — the point never escaped within ``max_iter`` (treated as in-set;
  rendered black by the viewer)
- otherwise ``ceil(escape_iteration * 256 / max_iter)`` cast to uint8.

Chunks whose pixels are *all 0* (:attr:`Chunk.is_never`) or *all 1*
(:attr:`Chunk.is_immediate`) are classified specially so storage can record
them as a tag instead of a 16 MiB file (``DataChunk.cs:82-87,126-142``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from distributedmandelbrot_tpu_torch import codecs
from distributedmandelbrot_tpu_torch.core.geometry import (CHUNK_PIXELS, CHUNK_WIDTH,
                                                     validate_indices)


@dataclass(frozen=True)
class Chunk:
    """An immutable computed tile: grid identity + flat uint8 pixel data."""

    level: int
    index_real: int
    index_imag: int
    data: np.ndarray = field(repr=False)

    def __post_init__(self) -> None:
        validate_indices(self.level, self.index_real, self.index_imag)
        # Always copy: a view would alias the caller's buffer, and freezing a
        # view does not freeze its base — the caller could mutate "immutable"
        # chunk data (e.g. a worker reusing its pixel buffer).
        data = np.array(self.data, dtype=np.uint8, copy=True).ravel()
        if data.size != CHUNK_PIXELS:
            raise ValueError(
                f"chunk data must have {CHUNK_PIXELS} elements, got {data.size}")
        data.setflags(write=False)
        object.__setattr__(self, "data", data)

    @property
    def key(self) -> tuple[int, int, int]:
        return (self.level, self.index_real, self.index_imag)

    @property
    def is_never(self) -> bool:
        """All pixels 0: nothing in the tile escaped (tile entirely in-set)."""
        return bool((self.data == 0).all())

    @property
    def is_immediate(self) -> bool:
        """All pixels 1: everything escaped in the first scaled bucket."""
        return bool((self.data == 1).all())

    @staticmethod
    def filled(level: int, index_real: int, index_imag: int, value: int) -> "Chunk":
        return Chunk(level, index_real, index_imag,
                     np.full(CHUNK_PIXELS, value, dtype=np.uint8))

    @staticmethod
    def never(level: int, index_real: int, index_imag: int) -> "Chunk":
        return Chunk.filled(level, index_real, index_imag, 0)

    @staticmethod
    def immediate(level: int, index_real: int, index_imag: int) -> "Chunk":
        return Chunk.filled(level, index_real, index_imag, 1)

    def serialize(self) -> bytes:
        """Full codec payload (code byte + body), smallest codec wins."""
        return codecs.serialize(self.data)

    @staticmethod
    def deserialize_data(payload: bytes) -> np.ndarray:
        """Decode a codec payload into flat uint8 pixels of chunk size."""
        return codecs.deserialize(payload, CHUNK_PIXELS)

    def as_image(self) -> np.ndarray:
        """Pixels as a ``(4096, 4096)`` array; row = imag index, col = real."""
        return self.data.reshape((CHUNK_WIDTH, CHUNK_WIDTH))
