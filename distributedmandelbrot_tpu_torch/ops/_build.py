"""Build and load the CUDA kernels of ``ops/csrc`` on first use.

``nvcc`` compiles the sources into a shared library with a plain C
interface, which ``ctypes`` loads: no PyTorch headers are compiled, so a
build takes seconds.  The library lands in the package's ``_build/``
directory (git-ignored) under a name that carries the hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused.  A failed build raises; nothing falls back to the plain version.

``-Xptxas -v`` is on: its report (registers, spills per kernel) is kept
beside the library and parsed by :func:`ptxas_report`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("escape_kernels.cu", "perturb_kernels.cu",
           "colormap_kernels.cu")
HEADERS = ("escape.cuh", "perturb.cuh")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

# --fmad=false keeps nvcc from contracting any mul+add the sources did
# not already pin with the _rn intrinsics (belt and braces: the f32
# recurrence must round like the uncontracted plain PyTorch version).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
_build_seconds: float | None = None


def nvcc_path() -> str:
    """The nvcc to build with: ``$CUDA_HOME/bin/nvcc``, then PATH, then
    the toolkit's default location."""
    cands = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libdm_escape_{_digest()}.so"


def build() -> Path:
    """Compile the library unless an up-to-date one exists; returns its
    path.  Concurrent builders write to private temporaries and rename,
    so a reader never sees a half-written library."""
    global _build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    _build_seconds = time.monotonic() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_seconds() -> float | None:
    """Seconds the last build in this process took (None: reused)."""
    return _build_seconds


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with its C
    entry points typed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.dm_escape_tile.argtypes = [vp, i, i, vp, i, i, i, i, f, i, i,
                                           i, i, vp, vp, vp]
            lib.dm_escape_tile.restype = i
            lib.dm_escape_mega.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i,
                                           f, i, i, i, i, i, vp, vp, vp]
            lib.dm_escape_mega.restype = i
            lib.dm_mxu_probe.argtypes = [vp, vp, vp, i, i, vp]
            lib.dm_mxu_probe.restype = i
            lib.dm_escape_pack.argtypes = [vp, i, i, i, vp, vp, i, i, i, f,
                                           i, i, i, vp, vp, vp]
            lib.dm_escape_pack.restype = i
            lib.dm_escape_smooth.argtypes = [vp, i, i, vp, i, i, i, f, f, f,
                                             i, f, i, i, i, vp, vp, vp]
            lib.dm_escape_smooth.restype = i
            lib.dm_escape_batch.argtypes = [vp, vp, vp, vp, i, i, i, i, i,
                                            i, f, i, i, i, vp, vp, vp]
            lib.dm_escape_batch.restype = i
            lib.dm_escape_state.argtypes = [vp] * 8 + [i, i, i, i, i, f, i,
                                                       i, i, vp, vp]
            lib.dm_escape_state.restype = i
            ll = ctypes.c_longlong
            lib.dm_escape_resume.argtypes = [vp] * 8 + [i, ll, i, ll, i, i,
                                                        vp, vp]
            lib.dm_escape_resume.restype = i
            d = ctypes.c_double
            dc = [vp, ll, ll, vp, ll, ll]
            lib.dm_perturb_scan.argtypes = [i, i, vp, vp, *dc, i, i, vp, vp,
                                            vp, vp, ll, ll, i, i, vp, vp]
            lib.dm_perturb_scan.restype = i
            lib.dm_perturb_scan_smooth.argtypes = [i, i, vp, vp, *dc, i, i, d,
                                                   d, vp, vp, vp, vp, vp, vp,
                                                   vp, ll, ll, i, ll, vp, vp]
            lib.dm_perturb_scan_smooth.restype = i
            lib.dm_perturb_smooth_ring_bytes.argtypes = [i, ll, ll]
            lib.dm_perturb_smooth_ring_bytes.restype = ll
            lib.dm_colormap_rgba8.argtypes = [vp, ll, vp, i, vp, i, vp, vp]
            lib.dm_colormap_rgba8.restype = i
            lib.dm_persistent_blocks_per_sm.argtypes = [i, i, i, i]
            lib.dm_persistent_blocks_per_sm.restype = i
            lib.dm_persistent_block_threads.argtypes = []
            lib.dm_persistent_block_threads.restype = i
            lib.dm_mega_max_tiles.argtypes = []
            lib.dm_mega_max_tiles.restype = i
            lib.dm_error_string.argtypes = [i]
            lib.dm_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


_PTXAS_FN = re.compile(r"Compiling entry function '(\w+)'")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_report() -> list[dict]:
    """Registers and spill bytes per kernel from the build's ``-Xptxas
    -v`` log (mangled kernel names are kept as ptxas prints them)."""
    log = library_path().with_suffix(".ptxas.txt")
    rows: list[dict] = []
    cur = None
    for line in log.read_text().splitlines():
        m = _PTXAS_FN.search(line)
        if m:
            cur = {"kernel": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        m = _PTXAS_REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
    return rows
