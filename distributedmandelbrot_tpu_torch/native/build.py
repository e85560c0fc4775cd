"""Lazy native build: compile the C++ sources into one shared library.

Built on first use with g++ (cached; rebuilt when sources change), loaded
via ctypes.  Everything native is optional — callers fall back to the pure
numpy paths when the toolchain or library is unavailable, and
``DMTPU_NATIVE=0`` disables it outright.

``-ffp-contract=off`` is load-bearing: it keeps the escape kernel's float64
arithmetic bit-identical to the numpy golden.

Safe for concurrent first use by several processes (test workers, a
worker per card): the check, the build and the rename run under an
``fcntl.flock`` on a lock file in the build directory, and each process
compiles to a temporary of its own, so no process sees another's
half-written library or loses a rename race.
"""

from __future__ import annotations

import ctypes
import fcntl
import logging
import os
import subprocess
import threading
from typing import Optional

logger = logging.getLogger("dmtpu.native")

_SRC_DIR = os.path.join(os.path.dirname(__file__), "src")
# The port's build directory (git-ignored), shared with the CUDA kernels'
# libraries.  Module state, read at build time: a caller may point it
# elsewhere before the first load().
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "_build")
_LIB_NAME = "libdmtpu_native.so"
_SOURCES = ("rle.cc", "escape.cc", "fixed.cc")

_CXXFLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off",
             "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> str:
    return os.path.join(BUILD_DIR, _LIB_NAME)


def _needs_build(path: str) -> bool:
    if not os.path.exists(path):
        return True
    lib_mtime = os.path.getmtime(path)
    return any(os.path.getmtime(os.path.join(_SRC_DIR, s)) > lib_mtime
               for s in _SOURCES)


def _build_locked() -> str:
    """Build the library unless an up-to-date one exists, holding the
    build directory's file lock across the check, the compile and the
    rename; returns its path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = lib_path()
    with open(os.path.join(BUILD_DIR, _LIB_NAME + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if _needs_build(path):
                tmp = f"{path}.{os.getpid()}.tmp"
                sources = [os.path.join(_SRC_DIR, s) for s in _SOURCES]
                cmd = ["g++", *_CXXFLAGS, "-o", tmp, *sources]
                logger.info("building native library: %s", " ".join(cmd))
                try:
                    subprocess.run(cmd, check=True, capture_output=True,
                                   text=True)
                    os.replace(tmp, path)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it on demand; None when unavailable.

    Thread-safe for concurrent FIRST use: ``_tried`` is set only after
    the build/load attempt fully concludes, so a caller racing the
    build blocks on the lock and gets the finished library."""
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        try:
            if os.environ.get("DMTPU_NATIVE", "1") == "0":
                logger.info("native library disabled via DMTPU_NATIVE=0")
                return None
            try:
                lib = ctypes.CDLL(_build_locked())
            except (OSError, subprocess.CalledProcessError) as e:
                detail = getattr(e, "stderr", "") or str(e)
                logger.warning("native library unavailable, using "
                               "pure-Python paths: %s",
                               detail.strip()[:500])
                return None
            _configure(lib)
            _lib = lib
            return _lib
        finally:
            _tried = True


def _configure(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.dmtpu_rle_encoded_size.restype = ctypes.c_size_t
    lib.dmtpu_rle_encoded_size.argtypes = [u8p, ctypes.c_size_t]
    lib.dmtpu_rle_encode.restype = ctypes.c_size_t
    lib.dmtpu_rle_encode.argtypes = [u8p, ctypes.c_size_t, u8p,
                                     ctypes.c_size_t]
    lib.dmtpu_rle_decode.restype = ctypes.c_int
    lib.dmtpu_rle_decode.argtypes = [u8p, ctypes.c_size_t, u8p,
                                     ctypes.c_size_t]
    lib.dmtpu_escape_pixels_f64.restype = None
    lib.dmtpu_escape_pixels_f64.argtypes = [f64p, f64p, ctypes.c_size_t,
                                            ctypes.c_int32, ctypes.c_int,
                                            u8p, ctypes.c_int]
    lib.dmtpu_escape_counts_f64.restype = None
    lib.dmtpu_escape_counts_f64.argtypes = [f64p, f64p, ctypes.c_size_t,
                                            ctypes.c_int32, i32p,
                                            ctypes.c_int]


def available() -> bool:
    return load() is not None
