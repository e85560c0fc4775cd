"""The colormap core: escape values -> RGBA, and RGBA -> PNG bytes.

The port of the colormap functions of the JAX package's
``serve/render.py`` (``_masked_colormap``, ``value_to_rgba``,
``smooth_to_rgba``, ``to_rgba8``), without matplotlib: the machines the
port runs on need not have it.  The port carries matplotlib's ``jet``
segment data and builds its 256-entry lookup table the way
``LinearSegmentedColormap`` does, and maps floats to table rows the way
``Colormap.__call__`` does, so the colors are matplotlib's, bit for bit.
The pipeline is the reference viewer's: normalise, invert, apply the
colormap, paint in-set pixels black.

:func:`encode_png` writes RGBA8 PNGs with the stdlib's ``zlib``; its
float-to-byte step, :func:`imsave_bytes`, is the one ``plt.imsave``
applies to a float RGBA image (truncation, not rounding).
"""

from __future__ import annotations

import struct
import threading
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# matplotlib's ``jet`` (``matplotlib._cm._jet_data``): per channel, rows
# of (x, y below x, y above x).
JET_SEGMENTS = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1),
              (0.91, 0, 0), (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.0, 0, 0)),
}
# The colormaps the port carries, by name.
SEGMENTS = {"jet": JET_SEGMENTS}
# Table rows of a colormap (matplotlib's default N).
LUT_SIZE = 256

_LOCK = threading.Lock()
_TABLES: dict[str, np.ndarray] = {}
_VALUE_TABLES: dict[str, np.ndarray] = {}


def _segment_lut(n: int, data) -> np.ndarray:
    """One channel's ``n``-entry table from its segment rows:
    matplotlib's ``_create_lookup_table`` at gamma 1."""
    adata = np.array(data)
    x = adata[:, 0] * (n - 1)
    y0 = adata[:, 1]
    y1 = adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]],
                          distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def colormap_table(colormap: str) -> np.ndarray:
    """(LUT_SIZE + 3, 4) float RGBA rows: the table, then the colors for
    values under the range, over it, and NaN (matplotlib's defaults: the
    end colors, and transparent black)."""
    with _LOCK:
        table = _TABLES.get(colormap)
        if table is None:
            try:
                seg = SEGMENTS[colormap]
            except KeyError:
                raise ValueError(
                    f"colormap {colormap!r} is not carried by the port; "
                    f"it has {sorted(SEGMENTS)}") from None
            table = np.ones((LUT_SIZE + 3, 4), float)
            for ch, name in enumerate(("red", "green", "blue")):
                table[:-3, ch] = _segment_lut(LUT_SIZE, seg[name])
            table[LUT_SIZE] = table[0]
            table[LUT_SIZE + 1] = table[LUT_SIZE - 1]
            table[LUT_SIZE + 2] = (0.0, 0.0, 0.0, 0.0)
            table.setflags(write=False)
            _TABLES[colormap] = table
        return table


def apply_colormap(x: np.ndarray, colormap: str = "jet") -> np.ndarray:
    """Float values in [0, 1] -> float RGBA, as ``Colormap.__call__``
    maps floats: ``x*N`` truncated to a row, ``x == 1`` to the last row,
    values under or over the range to the end colors, NaN to the "bad"
    color."""
    table = colormap_table(colormap)
    xa = np.array(x, dtype=float, copy=True)
    xa *= LUT_SIZE
    xa[xa == LUT_SIZE] = LUT_SIZE - 1
    under = xa < 0
    over = xa >= LUT_SIZE
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under] = LUT_SIZE
    idx[over] = LUT_SIZE + 1
    idx[bad] = LUT_SIZE + 2
    return table.take(idx, axis=0, mode="clip")


def _masked_colormap(vs: np.ndarray, in_set: np.ndarray,
                     colormap: str) -> np.ndarray:
    """Shared tail of both render paths: colormap ``vs``, paint in-set
    pixels black."""
    mapped = apply_colormap(vs, colormap)
    black = np.array((0.0, 0.0, 0.0, 1.0))
    return np.where(in_set[..., None], black, mapped)


def _value_table(colormap: str) -> np.ndarray:
    """(256, 4) float RGBA of every uint8 value under
    :func:`value_to_rgba`: the pipeline is pointwise, so indexing this
    table gives the same floats as mapping a whole plane."""
    with _LOCK:
        table = _VALUE_TABLES.get(colormap)
    if table is None:
        vs = 1.0 - np.arange(256, dtype=float) / 256.0
        table = _masked_colormap(vs, vs == 1.0, colormap)
        table.setflags(write=False)
        with _LOCK:
            _VALUE_TABLES[colormap] = table
    return table


def value_to_rgba(values: np.ndarray, colormap: str = "jet") -> np.ndarray:
    """Flat (square) or 2-D uint8 values -> float RGBA array (reference
    pipeline: ``1 - v/256`` through the colormap, value 0 black)."""
    values = np.asarray(values)
    if values.ndim == 1:
        side = int(round(values.size ** 0.5))
        if side * side != values.size:
            raise ValueError(f"cannot square-reshape {values.size} pixels")
        values = values.reshape((side, side))
    if values.dtype == np.uint8:
        return _value_table(colormap)[values]
    vs = 1.0 - values.astype(float) / 256.0
    return _masked_colormap(vs, vs == 1.0, colormap)


def smooth_to_rgba(nu: np.ndarray, max_iter: int, colormap: str = "jet",
                   normalize: bool = False) -> np.ndarray:
    """Continuous escape values -> RGBA: in-set (0) pixels black, others
    through the inverted colormap on a log scale (``log1p(nu) /
    log1p(max_iter)``).  ``normalize`` stretches the view's own escaped
    range over the whole colormap instead."""
    nu = np.asarray(nu, float)
    logs = np.log1p(np.maximum(nu, 0.0))
    escaped = nu > 0.0
    if normalize and escaped.any():
        sel = logs[escaped]
        lo, hi = float(sel.min()), float(sel.max())
        vs = (logs - lo) / max(hi - lo, 1e-12)
    else:
        vs = logs / np.log1p(float(max_iter))
    return _masked_colormap(1.0 - np.clip(vs, 0.0, 1.0), nu <= 0.0, colormap)


def to_rgba8(rgba: np.ndarray) -> np.ndarray:
    """Float RGBA in [0, 1] -> uint8 by rounding: the quantisation of
    the gateway's palette build."""
    return (np.clip(np.asarray(rgba, float), 0.0, 1.0) * 255.0
            + 0.5).astype(np.uint8)


def imsave_bytes(rgba: np.ndarray) -> np.ndarray:
    """Float (H, W, 4) RGBA in [0, 1] -> uint8 as ``plt.imsave`` stores
    it: a pixel with any NaN channel becomes 0, then each channel is
    ``x * 255`` truncated.  Values outside [0, 1] raise, as there.
    uint8 input passes through."""
    rgba = np.asarray(rgba)
    if rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError(f"expected (H, W, 4) RGBA, got {rgba.shape}")
    if rgba.dtype == np.uint8:
        return rgba
    nans = np.isnan(rgba)
    if nans.any():
        rgba = rgba.copy()
        rgba[nans.any(axis=2), :] = 0
    if rgba.max() > 1 or rgba.min() < 0:
        raise ValueError("floating point RGBA values must be in [0, 1]")
    return (rgba * 255).astype(np.uint8)


def _png_chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body)))


def encode_png(rgba8: np.ndarray, *, compress_level: int = 6) -> bytes:
    """(H, W, 4) uint8 -> an 8-bit RGBA PNG (color type 6, filter 0 on
    every scanline, no ancillary chunks)."""
    rgba8 = np.ascontiguousarray(rgba8, dtype=np.uint8)
    height, width, _ = rgba8.shape
    scanlines = np.zeros((height, width * 4 + 1), dtype=np.uint8)
    scanlines[:, 1:] = rgba8.reshape(height, width * 4)
    ihdr = struct.pack(">IIBBBBB", width, height, 8, 6, 0, 0, 0)
    return (PNG_SIGNATURE
            + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(scanlines.tobytes(),
                                                compress_level))
            + _png_chunk(b"IEND", b""))
