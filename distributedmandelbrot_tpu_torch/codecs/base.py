"""Codec interface and registry for chunk pixel payloads.

A serialized chunk payload is one codec-code byte followed by the codec's
body (reference: ``DistributedMandelbrot/DataChunkSerializer.cs:8-27``).
The registry mirrors the reference's two-codec table
(``DataChunk.cs:163-167``): 0x00 Raw, 0x01 RLE.  Serialization picks the
codec with the smallest encoded size (``DataChunk.cs:173-206``) — done here
by costing each codec directly rather than via a counting stream.
"""

from __future__ import annotations

from typing import Protocol

import numpy as np


class Codec(Protocol):
    """Encodes/decodes a flat uint8 pixel array (codec body only, no code byte)."""

    code: int

    def encode(self, data: np.ndarray) -> bytes: ...

    def decode(self, body: bytes, expected_size: int) -> np.ndarray: ...

    def encoded_size(self, data: np.ndarray) -> int: ...


_REGISTRY: dict[int, Codec] = {}


def register(codec: Codec) -> Codec:
    if codec.code in _REGISTRY:
        raise ValueError(f"codec code {codec.code:#x} already registered")
    _REGISTRY[codec.code] = codec
    return codec


def get(code: int) -> Codec:
    try:
        return _REGISTRY[code]
    except KeyError:
        raise ValueError(f"unknown codec code {code:#x}") from None


def all_codecs() -> tuple[Codec, ...]:
    return tuple(_REGISTRY.values())


RAW_CODE = 0x00


def serialize(data: np.ndarray) -> bytes:
    """Encode ``data`` with whichever registered codec yields the fewest bytes.

    Returns the full payload: 1 code byte + body.  Raw (identity) is costed
    by ``data.size`` without materializing its 16 MiB body; every other
    codec is encoded exactly once and compared by actual body length, so the
    winning encoding is never computed twice.
    """
    data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
    best_code, best_body = RAW_CODE, None
    best_size = data.size
    for codec in all_codecs():
        if codec.code == RAW_CODE:
            continue
        body = codec.encode(data)
        if len(body) < best_size:
            best_code, best_body, best_size = codec.code, body, len(body)
    if best_body is None:
        best_body = get(RAW_CODE).encode(data)
    return bytes([best_code]) + best_body


def deserialize(payload: bytes, expected_size: int) -> np.ndarray:
    """Decode a full payload (code byte + body) into a flat uint8 array."""
    if len(payload) < 1:
        raise ValueError("empty chunk payload")
    codec = get(payload[0])
    return codec.decode(payload[1:], expected_size)
