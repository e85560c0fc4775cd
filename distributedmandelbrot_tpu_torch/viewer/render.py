"""Rendering: uint8 pixel values -> RGBA images, plus multi-chunk stitching.

The colormap core (``value_to_rgba`` / ``smooth_to_rgba`` and their
shared ``_masked_colormap`` tail) lives in
:mod:`distributedmandelbrot_tpu_torch.serve.render`; this module
re-exports it, as the JAX package's viewer does.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from distributedmandelbrot_tpu_torch.core.geometry import CHUNK_WIDTH
# Canonical re-exports of the shared colormap core (see module docstring).
from distributedmandelbrot_tpu_torch.serve.render import (  # noqa: F401
    _masked_colormap, smooth_to_rgba, value_to_rgba)


def stitch_level(fetch: Callable[[int, int], Optional[np.ndarray]],
                 level: int, *, chunk_width: int = CHUNK_WIDTH,
                 fill_value: int = 0) -> np.ndarray:
    """Assemble a full level image from per-chunk fetches.

    ``fetch(index_real, index_imag)`` returns flat uint8 pixels or None for
    missing chunks (filled with ``fill_value``).  Output axis order follows
    the chunk-local convention — row = imaginary axis, column = real axis —
    so chunk (i, j) lands at rows ``j*W:(j+1)*W``, cols ``i*W:(i+1)*W``.
    """
    out = np.full((level * chunk_width, level * chunk_width), fill_value,
                  dtype=np.uint8)
    for i in range(level):
        for j in range(level):
            pixels = fetch(i, j)
            if pixels is None:
                continue
            tile = np.asarray(pixels, dtype=np.uint8).reshape(
                (chunk_width, chunk_width))
            out[j * chunk_width:(j + 1) * chunk_width,
                i * chunk_width:(i + 1) * chunk_width] = tile
    return out


def show(rgba: np.ndarray) -> None:  # pragma: no cover - needs a display
    from matplotlib import pyplot as plt

    plt.imshow(rgba)
    plt.show()
