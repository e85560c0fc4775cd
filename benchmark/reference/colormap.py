"""Plain reference for a smooth view's colours and for reading its PNG.

It imports nothing of the program.  The colours are matplotlib's: the
``jet`` segment data (``matplotlib._cm._jet_data``), its 256-row table
built as ``LinearSegmentedColormap`` builds it, floats mapped to rows as
``Colormap.__call__`` maps them, and float RGBA stored as ``plt.imsave``
stores it (``x * 255`` truncated).  A smooth view maps ``nu`` to
``1 - log1p(nu) / log1p(max_iter)`` (clipped to [0, 1]) through the
table, and paints pixels with ``nu <= 0`` (in the set) opaque black.
"""

from __future__ import annotations

import zlib

import numpy as np

JET = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1),
              (0.91, 0, 0), (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.0, 0, 0)),
}
N = 256


def _channel(rows) -> np.ndarray:
    data = np.array(rows)
    x = data[:, 0] * (N - 1)
    xind = (N - 1) * np.linspace(0, 1, N)
    ind = np.searchsorted(x, xind)[1:-1]
    frac = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[data[0, 2]],
                          frac * (data[ind, 1] - data[ind - 1, 2])
                          + data[ind - 1, 2],
                          [data[-1, 1]]])
    return np.clip(lut, 0.0, 1.0)


def jet_table() -> np.ndarray:
    """(N, 4) float RGBA rows."""
    table = np.ones((N, 4))
    for ch, name in enumerate(("red", "green", "blue")):
        table[:, ch] = _channel(JET[name])
    return table


def smooth_rgba8(nu: np.ndarray, max_iter: int) -> np.ndarray:
    """(..., 4) uint8 colours of smooth values ``nu``."""
    nu = np.asarray(nu, dtype=np.float64)
    v = 1.0 - np.clip(np.log1p(np.maximum(nu, 0.0))
                      / np.log1p(float(max_iter)), 0.0, 1.0)
    x = v * N
    x[x == N] = N - 1
    bad = np.isnan(x)
    rgba = jet_table()[np.where(bad, 0, x).astype(int)]
    rgba[bad] = 0.0
    rgba[nu <= 0.0] = (0.0, 0.0, 0.0, 1.0)
    return (rgba * 255).astype(np.uint8)


def read_png_rgba8(data: bytes) -> np.ndarray:
    """(height, width, 4) uint8 of an 8-bit RGBA PNG with filter 0 on
    every scanline (what the program writes); anything else raises."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, ihdr = 8, bytearray(), None
    while pos < len(data):
        length = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if zlib.crc32(tag + body) != int.from_bytes(
                data[pos + 8 + length:pos + 12 + length], "big"):
            raise ValueError(f"bad CRC in the {tag!r} chunk")
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = body
        elif tag == b"IDAT":
            idat += body
    if ihdr is None or ihdr[8:13] != b"\x08\x06\x00\x00\x00":
        raise ValueError("not an 8-bit RGBA PNG without interlace")
    width, height = (int.from_bytes(ihdr[i:i + 4], "big") for i in (0, 4))
    raw = np.frombuffer(zlib.decompress(bytes(idat)), np.uint8).reshape(
        height, width * 4 + 1)
    if raw[:, 0].any():
        raise ValueError("a scanline filter other than 0")
    return raw[:, 1:].reshape(height, width, 4)
