"""numpy-facing wrappers over the native library (None-safe: callers check
:func:`distributedmandelbrot_tpu_torch.native.build.available` or catch
``RuntimeError`` and fall back to the Python paths)."""

from __future__ import annotations

import ctypes
import sys

import numpy as np

from distributedmandelbrot_tpu_torch.native import build

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F64P = ctypes.POINTER(ctypes.c_double)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _lib():
    lib = build.load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_U8P)


def native_supported() -> bool:
    # The record format is little-endian; the C++ writes host-endian.
    return sys.byteorder == "little" and build.available()


def rle_encoded_size(data: np.ndarray) -> int:
    data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
    return int(_lib().dmtpu_rle_encoded_size(_u8ptr(data), data.size))


def rle_encode(data: np.ndarray) -> bytes:
    lib = _lib()
    data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
    size = int(lib.dmtpu_rle_encoded_size(_u8ptr(data), data.size))
    out = np.empty(size, dtype=np.uint8)
    written = int(lib.dmtpu_rle_encode(_u8ptr(data), data.size,
                                       _u8ptr(out), out.size))
    if written != size:
        raise RuntimeError(f"native RLE encode wrote {written}, "
                           f"expected {size}")
    return out.tobytes()


def rle_decode(body: bytes, expected_size: int) -> np.ndarray:
    lib = _lib()
    src = np.frombuffer(body, dtype=np.uint8)
    out = np.empty(expected_size, dtype=np.uint8)
    rc = int(lib.dmtpu_rle_decode(_u8ptr(src), src.size, _u8ptr(out),
                                  out.size))
    if rc == -1:
        raise ValueError(
            f"RLE body length {len(body)} is not a multiple of 5")
    if rc == -2:
        raise ValueError("encountered RLE run of length 0")
    if rc in (-3, -4):
        raise ValueError(f"RLE decodes to the wrong total "
                         f"(expected {expected_size})")
    if rc != 0:
        raise RuntimeError(f"native RLE decode failed: {rc}")
    return out


def escape_pixels(c_real: np.ndarray, c_imag: np.ndarray, max_iter: int, *,
                  clamp: bool = False, n_threads: int = 0) -> np.ndarray:
    """uint8 pixels, bit-identical to the numpy golden path, multithreaded."""
    lib = _lib()
    c_real = np.ascontiguousarray(c_real, dtype=np.float64).ravel()
    c_imag = np.ascontiguousarray(c_imag, dtype=np.float64).ravel()
    if c_real.size != c_imag.size:
        raise ValueError("coordinate arrays must have equal size")
    out = np.empty(c_real.size, dtype=np.uint8)
    lib.dmtpu_escape_pixels_f64(
        c_real.ctypes.data_as(_F64P), c_imag.ctypes.data_as(_F64P),
        c_real.size, max_iter, int(clamp), _u8ptr(out), n_threads)
    return out


def escape_counts(c_real: np.ndarray, c_imag: np.ndarray, max_iter: int, *,
                  n_threads: int = 0) -> np.ndarray:
    """Raw int32 escape counts (for smooth coloring / analysis)."""
    lib = _lib()
    c_real = np.ascontiguousarray(c_real, dtype=np.float64).ravel()
    c_imag = np.ascontiguousarray(c_imag, dtype=np.float64).ravel()
    if c_real.size != c_imag.size:
        raise ValueError("coordinate arrays must have equal size")
    out = np.empty(c_real.size, dtype=np.int32)
    lib.dmtpu_escape_counts_f64(
        c_real.ctypes.data_as(_F64P), c_imag.ctypes.data_as(_F64P),
        c_real.size, max_iter, out.ctypes.data_as(_I32P), n_threads)
    return out


# -- arbitrary-precision fixed-point kernels (fixed.cc) --------------------

_U64P = ctypes.POINTER(ctypes.c_uint64)


def _limbs(value: int, n_limbs: int) -> np.ndarray:
    """|value| as n_limbs little-endian uint64 magnitudes."""
    return np.frombuffer(abs(value).to_bytes(n_limbs * 8, "little"),
                         dtype="<u8")


def _u64ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_U64P)


def fixed_escape(za: int, zb: int, ca: int, cb: int, max_iter: int,
                 bits: int) -> int:
    """Exact-parity native replacement for the Python-bigint escape loop
    (ops/perturbation.py:_escape_count_fixed)."""
    lib = _lib()
    # Pre-escape magnitudes stay under 2^(bits+4); one guard limb
    # suffices (see fixed.cc bound analysis).
    n = (bits + 63) // 64 + 1
    four = _limbs(4 << (2 * bits), 2 * n + 1)
    args = [_limbs(za, n), 1 if za < 0 else 0,
            _limbs(zb, n), 1 if zb < 0 else 0,
            _limbs(ca, n), 1 if ca < 0 else 0,
            _limbs(cb, n), 1 if cb < 0 else 0]
    return int(lib.dmtpu_fixed_escape(
        _u64ptr(args[0]), args[1], _u64ptr(args[2]), args[3],
        _u64ptr(args[4]), args[5], _u64ptr(args[6]), args[7],
        _u64ptr(four), n, bits, max_iter))


def fixed_orbit(za: int, zb: int, ca: int, cb: int, max_iter: int,
                bits: int, extra: int
                ) -> tuple[np.ndarray, np.ndarray, int]:
    """Exact-parity native replacement for the Python-bigint orbit loop
    (ops/perturbation.py:_orbit_fixed): float64 orbit arrays plus the
    tested-orbit length."""
    lib = _lib()
    # The post-escape extension runs values up to ~10^100 * 2^bits
    # before the huge-threshold stop; six guard limbs (384 bits) cover
    # the ~333-bit growth with headroom (see fixed.cc).
    n = (bits + 63) // 64 + 6
    four = _limbs(4 << (2 * bits), 2 * n + 1)
    huge = _limbs((10 ** 100) << (2 * bits), 2 * n + 1)
    steps = max(1, max_iter)
    z_re = np.empty(steps + extra, np.float64)
    z_im = np.empty(steps + extra, np.float64)
    valid = ctypes.c_int32(0)
    args = [_limbs(za, n), 1 if za < 0 else 0,
            _limbs(zb, n), 1 if zb < 0 else 0,
            _limbs(ca, n), 1 if ca < 0 else 0,
            _limbs(cb, n), 1 if cb < 0 else 0]
    written = int(lib.dmtpu_fixed_orbit(
        _u64ptr(args[0]), args[1], _u64ptr(args[2]), args[3],
        _u64ptr(args[4]), args[5], _u64ptr(args[6]), args[7],
        _u64ptr(four), _u64ptr(huge), n, bits, max_iter, extra,
        z_re.ctypes.data_as(_F64P), z_im.ctypes.data_as(_F64P),
        ctypes.byref(valid)))
    return z_re[:written], z_im[:written], int(valid.value)


def fixed_escape_batch(points: list[tuple[int, int]], max_iter: int,
                       bits: int, julia_c: tuple[int, int] | None = None,
                       n_threads: int = 0) -> np.ndarray:
    """Escape counts for a batch of fixed-point points (the glitch-
    repair exact loop): parallelized in C++ over all cores.  ``points``
    are (za, zb) fixed-point ints; ``julia_c`` switches every point to
    the shared Julia constant."""
    lib = _lib()
    n = (bits + 63) // 64 + 1
    k = len(points)
    za = np.empty(k * n, dtype="<u8")
    zb = np.empty(k * n, dtype="<u8")
    za_neg = np.empty(k, dtype=np.uint8)
    zb_neg = np.empty(k, dtype=np.uint8)
    for i, (a, b) in enumerate(points):
        za[i * n:(i + 1) * n] = _limbs(a, n)
        zb[i * n:(i + 1) * n] = _limbs(b, n)
        za_neg[i] = 1 if a < 0 else 0
        zb_neg[i] = 1 if b < 0 else 0
    four = _limbs(4 << (2 * bits), 2 * n + 1)
    if julia_c is not None:
        ca, cb = julia_c
        ca_l, cb_l = _limbs(ca, n), _limbs(cb, n)
        ca_neg, cb_neg, julia = 1 if ca < 0 else 0, 1 if cb < 0 else 0, 1
    else:
        ca_l, cb_l = np.zeros(n, dtype="<u8"), np.zeros(n, dtype="<u8")
        ca_neg = cb_neg = julia = 0
    out = np.empty(k, dtype=np.int32)
    lib.dmtpu_fixed_escape_batch(
        _u64ptr(za), _u8ptr(za_neg), _u64ptr(zb), _u8ptr(zb_neg),
        _u64ptr(ca_l), ca_neg, _u64ptr(cb_l), cb_neg, julia,
        _u64ptr(four), n, bits, max_iter, k,
        out.ctypes.data_as(_I32P), n_threads)
    return out
