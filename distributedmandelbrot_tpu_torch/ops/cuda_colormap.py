"""Host side of the smooth colormap's kernel (``ops/csrc/
colormap_kernels.cu``): its wrapper, its plain PyTorch version and its
launch counter.  The JAX package colours on the host
(``serve/render.py``: ``smooth_to_rgba``, then ``imsave_bytes``); it has
no kernel here.

``colormap_rgba8(nu, boundaries, table)`` maps float64 smooth values to
RGBA8 rows of ``table``: NaN to its second-to-last row, ``nu <= 0`` (in
the set) to its last, and any other value to row ``n`` less the number
of the ``n`` ascending ``boundaries`` at or below it.
``serve/render.py`` builds both tables from the float route's own
arithmetic (``smooth_boundaries``, ``smooth_table8``), so the bytes
equal the float route's by construction.

A wrapper given CUDA tensors launches the kernel (or raises); it takes
the plain version only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import threading

import torch

KERNEL_COLORMAP = "colormap_rgba8"
# What the kernel stages in shared memory: the most boundaries its 8
# halving steps count, and the most table rows.
MAX_BOUNDARIES = 255
MAX_ROWS = 512

_counts_lock = threading.Lock()
_launches = {KERNEL_COLORMAP: 0}


def launch_counts() -> dict[str, int]:
    """Kernel launches so far in this process, by kernel."""
    with _counts_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _counts_lock:
        for name in _launches:
            _launches[name] = 0


def _check(nu: torch.Tensor, boundaries: torch.Tensor,
           table: torch.Tensor) -> None:
    if nu.dtype != torch.float64 or not nu.is_contiguous():
        raise ValueError("nu must be a contiguous float64 tensor")
    n = boundaries.numel()
    if boundaries.dim() != 1 or not 1 <= n <= MAX_BOUNDARIES or \
            boundaries.dtype != torch.float64 or \
            not boundaries.is_contiguous():
        raise ValueError(f"boundaries must be 1 to {MAX_BOUNDARIES} "
                         "contiguous float64 values")
    if table.dim() != 2 or table.shape[1] != 4 or \
            not n + 3 <= table.shape[0] <= MAX_ROWS or \
            table.dtype != torch.uint8 or not table.is_contiguous():
        raise ValueError(f"table must be (n + 3 to {MAX_ROWS}, 4) "
                         "contiguous uint8, n the boundaries")
    if len({nu.device, boundaries.device, table.device}) != 1:
        raise ValueError("nu and the tables must share a device")


def colormap_rgba8_plain(nu: torch.Tensor, boundaries: torch.Tensor,
                         table: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: ``nu``'s shape plus a last axis of 4,
    uint8."""
    rows = boundaries.numel() - torch.searchsorted(boundaries, nu,
                                                   right=True)
    rows = torch.where(nu <= 0.0, table.shape[0] - 1, rows)
    rows = torch.where(torch.isnan(nu), table.shape[0] - 2, rows)
    return table[rows]


def colormap_rgba8_cuda(nu: torch.Tensor, boundaries: torch.Tensor,
                        table: torch.Tensor) -> torch.Tensor:
    """The kernel on the tensors' CUDA device (one launch on its current
    stream, no sync)."""
    from distributedmandelbrot_tpu_torch.ops import _build
    lib = _build.load()
    out = torch.empty((*nu.shape, 4), dtype=torch.uint8, device=nu.device)
    with torch.cuda.device(nu.device):
        stream = torch.cuda.current_stream(nu.device).cuda_stream
        rc = lib.dm_colormap_rgba8(
            ctypes.c_void_p(nu.data_ptr()), nu.numel(),
            ctypes.c_void_p(boundaries.data_ptr()), boundaries.numel(),
            ctypes.c_void_p(table.data_ptr()), table.shape[0],
            ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{KERNEL_COLORMAP} launch failed: "
                           f"{lib.dm_error_string(rc).decode()}")
    with _counts_lock:
        _launches[KERNEL_COLORMAP] += 1
    return out


def colormap_rgba8(nu: torch.Tensor, boundaries: torch.Tensor,
                   table: torch.Tensor) -> torch.Tensor:
    """The wrapper: the kernel for CUDA tensors, the plain version for
    tensors on the CPU -> uint8 of ``nu``'s shape plus a last axis of
    4."""
    _check(nu, boundaries, table)
    fn = (colormap_rgba8_cuda if nu.device.type == "cuda" else
          colormap_rgba8_plain)
    return fn(nu, boundaries, table)
