"""Raw (verbatim) chunk codec — code 0x00.

Body is the pixel bytes as-is (reference:
``DistributedMandelbrot/DataChunkSerializer.cs:29-49``).
"""

from __future__ import annotations

import numpy as np


class RawCodec:
    code = 0x00

    def encode(self, data: np.ndarray) -> bytes:
        return np.ascontiguousarray(data, dtype=np.uint8).tobytes()

    def decode(self, body: bytes, expected_size: int) -> np.ndarray:
        if len(body) != expected_size:
            raise ValueError(
                f"raw body must be exactly {expected_size} bytes, "
                f"got {len(body)}")
        return np.frombuffer(body, dtype=np.uint8).copy()

    def encoded_size(self, data: np.ndarray) -> int:
        return data.size
