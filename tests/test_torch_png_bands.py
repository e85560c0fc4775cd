"""The CLI's PNG writer deflates in bands of rows on a thread pool
(``serve/render.py`` ``encode_png``): one zlib stream that inflates to
the exact scanlines, whose bytes follow the image and the level alone,
and which an image of one band writes as ``zlib.compress`` does.

- The scanlines come back exactly, over shapes, levels and band sizes.
- The bytes do not depend on the pool's threads.
- One band: ``zlib.compress``'s stream, the writer's bytes before bands.
- A smooth 1024^2 view: within 0.5% of the single stream's size.
- The benchmark's reader, Pillow and the gateway's decoder read or
  refuse the PNG as before.
- The count ``render.deflate_bands``.
"""

from __future__ import annotations

import importlib.util
import io
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from distributedmandelbrot_tpu_torch.core import TileSpec
from distributedmandelbrot_tpu_torch.obs import names, phases
from distributedmandelbrot_tpu_torch.ops import escape_time
from distributedmandelbrot_tpu_torch.serve import render as srender

SHAPES = [(1, 1), (8, 8), (3, 1000), (1000, 3), (257, 129), (1024, 1024)]
LEVELS = [0, 1, 6, 9]


def _reference_colormap():
    path = (Path(__file__).resolve().parents[1] / "benchmark" / "reference"
            / "colormap.py")
    spec = importlib.util.spec_from_file_location("_bench_colormap", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _image(height: int, width: int, seed: int = 0) -> np.ndarray:
    """RGBA8 with smooth stretches (matches across band seams) and a
    noisy stripe (literals)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width]
    img = np.empty((height, width, 4), np.uint8)
    img[..., 0] = (x * 3 + y) % 256
    img[..., 1] = (y // 7) % 256
    img[..., 2] = ((x // 5) ^ (y // 3)) % 256
    img[..., 3] = 255
    stripe = slice(height // 3, height // 3 + max(1, height // 8))
    img[stripe] = rng.integers(0, 256, img[stripe].shape, dtype=np.uint8)
    return img


def _scanlines(rgba8: np.ndarray) -> bytes:
    height, width, _ = rgba8.shape
    lines = np.zeros((height, width * 4 + 1), np.uint8)
    lines[:, 1:] = rgba8.reshape(height, width * 4)
    return lines.tobytes()


def _chunks(png: bytes) -> list[tuple[bytes, bytes]]:
    pos, out = 8, []
    while pos < len(png):
        (length,) = struct.unpack_from(">I", png, pos)
        out.append((png[pos + 4:pos + 8], png[pos + 8:pos + 8 + length]))
        pos += 12 + length
    return out


def _idat(png: bytes) -> bytes:
    (body,) = [body for tag, body in _chunks(png) if tag == b"IDAT"]
    return body


def _single_stream_png(rgba8: np.ndarray, level: int) -> bytes:
    """The writer's bytes with one ``zlib.compress`` of the scanlines."""
    height, width, _ = rgba8.shape
    ihdr = struct.pack(">IIBBBBB", width, height, 8, 6, 0, 0, 0)
    return (srender.PNG_SIGNATURE + srender._png_chunk(b"IHDR", ihdr)
            + srender._png_chunk(b"IDAT",
                                 zlib.compress(_scanlines(rgba8), level))
            + srender._png_chunk(b"IEND", b""))


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_the_stream_inflates_to_the_exact_scanlines(shape, level):
    rgba8 = _image(*shape)
    png = srender.encode_png(rgba8, compress_level=level)
    assert [tag for tag, _ in _chunks(png)] == [b"IHDR", b"IDAT", b"IEND"]
    idat = _idat(png)
    assert idat[:2] == zlib.compress(b"", level)[:2]
    assert zlib.decompress(idat) == _scanlines(rgba8)


@pytest.mark.parametrize("band_bytes", [1, 4000, 20000, 40000],
                         ids=lambda b: f"band{b}")
@pytest.mark.parametrize("shape", [(257, 129), (300, 50), (64, 1024)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_bands_under_and_over_the_window_inflate_exactly(
        monkeypatch, shape, band_bytes):
    """Bands of one row, and bands shorter and longer than deflate's
    32 KiB window: a band is primed with the window before it, across
    as many bands as that takes."""
    monkeypatch.setattr(srender, "BAND_BYTES", band_bytes)
    rgba8 = _image(*shape, seed=1)
    for level in (1, 6):
        idat = _idat(srender.encode_png(rgba8, compress_level=level))
        assert zlib.decompress(idat) == _scanlines(rgba8)


@pytest.mark.parametrize("level", [1, 6, 9])
def test_the_bytes_do_not_depend_on_the_pools_threads(monkeypatch, level):
    rgba8 = _image(1024, 1024, seed=2)
    pngs = []
    for workers in (1, 3, 16):
        with ThreadPoolExecutor(workers) as pool:
            monkeypatch.setattr(srender, "_pool", pool)
            pngs.append(srender.encode_png(rgba8, compress_level=level))
    assert pngs[0] == pngs[1] == pngs[2]
    monkeypatch.setattr(srender, "_pool", None)
    assert srender.encode_png(rgba8, compress_level=level) == pngs[0]


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("shape", [(1, 1), (8, 8), (3, 1000), (1000, 3),
                                   (63, 1024)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_an_image_of_one_band_is_one_zlib_compress(shape, level):
    rgba8 = _image(*shape, seed=3)
    assert srender.encode_png(rgba8, compress_level=level) == \
        _single_stream_png(rgba8, level)


def test_a_smooth_view_stays_within_half_a_percent_of_one_stream():
    """A 1024^2 smooth jet view of the seahorse valley (the deep cells'
    colouring of an escape-time view)."""
    spec = TileSpec(-0.7469, 0.1, 0.008, 0.008, 1024, 1024)
    nu = escape_time.compute_tile_smooth(spec, 300, device="cpu")
    rgba8 = srender.smooth_to_rgba(nu, 300, rgba8_on="cpu")
    banded = len(_idat(srender.encode_png(rgba8)))
    single = len(zlib.compress(_scanlines(rgba8), 6))
    assert banded != single
    assert abs(banded - single) <= 0.005 * single


def test_readers_read_the_banded_png_as_before():
    rgba8 = _image(1024, 1024, seed=4)
    png = srender.encode_png(rgba8)
    assert np.array_equal(_reference_colormap().read_png_rgba8(png), rgba8)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(png))), rgba8)


@pytest.mark.parametrize("shape", [(8, 8), (1024, 1024)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_readers_refuse_what_they_refused(shape):
    png = srender.encode_png(_image(*shape, seed=5))
    # The gateway's decoder reads palette PNGs only: no PLTE here.
    with pytest.raises(ValueError, match="missing IHDR/PLTE/IDAT"):
        srender.decode_rendered_png(png)
    reader = _reference_colormap().read_png_rgba8
    with pytest.raises(ValueError, match="bad CRC"):
        reader(png[:-5] + bytes([png[-5] ^ 1]) + png[-4:])
    with pytest.raises(zlib.error):
        # The stream cut short of its end.
        idat = _idat(png)[:-6]
        tail = srender._png_chunk(b"IDAT", idat) + srender._png_chunk(
            b"IEND", b"")
        reader(png[:33] + tail)


def test_the_gateways_palette_png_keeps_one_zlib_compress():
    values = np.arange(1024 * 1024, dtype=np.int64).reshape(1024, 1024)
    values = (values * 7 % 256).astype(np.uint8)
    png = srender.render_tile_png(values)
    lines = np.zeros((1024, 1025), np.uint8)
    lines[:, 1:] = values
    assert _idat(png) == zlib.compress(lines.tobytes(), 6)
    assert np.array_equal(srender.decode_rendered_png(png),
                          srender.render_tile_rgba8(values))


@pytest.mark.parametrize("shape, bands", [((1024, 1024), 16), ((8, 8), 1),
                                          ((4096, 64), 4)],
                         ids=["1024x1024", "8x8", "4096x64"])
def test_the_count_of_bands_deflated(shape, bands):
    phases.reset_phase_seconds()
    srender.encode_png(_image(*shape))
    assert phases.phase_seconds()[names.COUNT_RENDER_DEFLATE_BANDS] == bands
    srender.encode_png(_image(*shape))
    assert phases.phase_seconds()[names.COUNT_RENDER_DEFLATE_BANDS] == \
        2 * bands


def test_adler32_combine_is_zlibs():
    rng = np.random.default_rng(6)
    for n1, n2 in [(0, 5), (1, 1), (5552, 70000), (100000, 3)]:
        a = rng.integers(0, 256, n1, dtype=np.uint8).tobytes()
        b = rng.integers(0, 256, n2, dtype=np.uint8).tobytes()
        assert srender._adler32_combine(zlib.adler32(a), zlib.adler32(b),
                                        n2) == zlib.adler32(a + b)
