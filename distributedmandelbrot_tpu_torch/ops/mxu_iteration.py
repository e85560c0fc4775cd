"""The matrix form of the escape iteration (opt-in, parity-gated): the
port of the JAX package's ``ops/mxu_iteration.py``, kernel K8.

Embed ``z = zr + i*zi`` as the 2x2 rotation-scaling matrix
``[[zr, -zi], [zi, zr]]``; complex multiplication is multiplication of
these matrices, so one step ``z <- z^2 + c`` is a 2x2 product plus a
vector add:

    [zr']   [zr  -zi] [zr]   [cr]
    [zi'] = [zi   zr] [zi] + [ci]

:func:`mxu_step` writes that product out elementwise, every product and
sum a separate, correctly rounded op: ``sr = zr*zr + (-zi)*zi``,
``si = zi*zr + zr*zi``, then ``+ c``.  It is K8's plain version; the
kernels run the same operations with the ``_rn`` intrinsics
(``escape.cuh``, ``update<kQuadratic, true>``).  ``torch.matmul`` is not
used for it: its CPU and cuBLAS paths may fuse or reorder the two
products, and on the card may round through TF32.

On the H100 the form runs on the CUDA cores, not the tensor cores: an
f32 operand reaches the tensor cores only as TF32 or a 3xTF32 split,
whose partial sums round differently from ``rn(rn(zr*zr) - rn(zi*zi))``,
so a tensor-core full form could never pass the probe below.

The gate (``DMTPU_MXU``), as in the reference:

- **off** (default; unset or ``0``): nothing changes.
- **full** — ``DMTPU_MXU=1`` and :func:`mxu_parity_proven` for the
  device: the fused and single-tile kernels run the matrix form.  Escape
  counts are a bit-exact contract, so full mode is admitted only where
  the probe shows the matrix form rounds exactly as the cached-squares
  form does.
- **census** — ``DMTPU_MXU=1`` but parity unproven: the recurrence keeps
  the cached-squares form and the matrix form runs only as an advisory
  bf16 shadow (:func:`mxu_census_counts`) that never feeds a pixel, the
  contract of :mod:`.mixed_precision`.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np
import torch

from distributedmandelbrot_tpu_torch.ops.mixed_precision import (scout_cast,
                                                                 scout_const)

# The opt-in env gate (unset/0 = off); see the module docstring.
MXU_ENV = "DMTPU_MXU"

# Probe geometry: a fixed panel over the escape-relevant range, iterated
# long enough for one ulp of divergence to surface (divergence compounds
# on boundary orbits, so 32 steps expose any rounding difference the
# first step introduces).
PROBE_N = 64
PROBE_STEPS = 32

# Census panel edge: the advisory shadow samples each tile on a coarse
# sub-grid, so a whole batch costs a fraction of one real segment.
CENSUS_PANEL = 32

_cache_lock = threading.Lock()
_parity_cache: dict[tuple[str, int | None], bool] = {}


def mxu_step(zr: torch.Tensor, zi: torch.Tensor, c_real: torch.Tensor,
             c_imag: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One ``z <- z^2 + c`` step in the 2x2 rotation-matrix form, every
    product and sum a separate op (no contraction, no reordering).
    Mathematically the cached-squares step; bitwise equal to it unless
    ``zr + zr`` overflows or ``zr*zi`` is subnormal, which is what
    :func:`mxu_parity_proven` probes."""
    sr = zr * zr + (-zi) * zi
    si = zi * zr + zr * zi
    return sr + c_real, si + c_imag


def _device_key(device) -> tuple[str, int | None]:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev.type, dev.index


def _probe_grid(device) -> tuple[torch.Tensor, torch.Tensor]:
    xs = np.linspace(-2.0, 1.0, PROBE_N, dtype=np.float32)
    ys = np.linspace(-1.5, 1.5, PROBE_N, dtype=np.float32)
    return (torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device))


def _probe_cached(zr, zi, c_real, c_imag):
    """The kernels' cached-squares recurrence, PROBE_STEPS times, with no
    escape test (orbits that overflow must do so alike in both forms)."""
    zr2 = zr * zr
    zi2 = zi * zi
    for _ in range(PROBE_STEPS):
        cross = (zr + zr) * zi
        zi = cross + c_imag
        zr = (zr2 - zi2) + c_real
        zr2 = zr * zr
        zi2 = zi * zi
    return zr, zi


def _probe_matrix(zr, zi, c_real, c_imag):
    for _ in range(PROBE_STEPS):
        zr, zi = mxu_step(zr, zi, c_real, c_imag)
    return zr, zi


def probe_planes(device) -> torch.Tensor:
    """The probe's four (PROBE_N, PROBE_N) f32 planes on ``device``: z
    after PROBE_STEPS steps from z0 = c in the cached-squares form (real,
    imaginary), then in the matrix form.  On a CUDA device the kernel
    library's ``dm_mxu_probe`` computes them with the kernels' own
    ``update`` (so the verdict is about the code the kernels run); on
    the CPU the plain versions above do."""
    dev = torch.device(device)
    xs, ys = _probe_grid(dev)
    if dev.type != "cuda":
        cr = xs[None, :].expand(PROBE_N, PROBE_N)
        ci = ys[:, None].expand(PROBE_N, PROBE_N)
        return torch.stack([*_probe_cached(cr, ci, cr, ci),
                            *_probe_matrix(cr, ci, cr, ci)])
    from distributedmandelbrot_tpu_torch.ops import _build
    lib = _build.load()
    with torch.cuda.device(dev):
        out = torch.empty((4, PROBE_N, PROBE_N), dtype=torch.float32,
                          device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dm_mxu_probe(ctypes.c_void_p(out.data_ptr()),
                              ctypes.c_void_p(xs.data_ptr()),
                              ctypes.c_void_p(ys.data_ptr()), PROBE_N,
                              PROBE_STEPS, ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError("dm_mxu_probe launch failed: "
                               f"{lib.dm_error_string(rc).decode()}")
        # The probe runs once per device, off the launch path, and its
        # verdict needs the planes.
        # dmtpu: ignore[torch-host-sync] — a deliberate wait, see above
        torch.cuda.current_stream(dev).synchronize()
    return out


def probe_differences(device) -> int:
    """Lanes of the probe panel where the two forms differ in either
    component, compared as int32 bit patterns (NaN lanes included: an
    orbit that overflows must do so identically).  Uncached."""
    planes = probe_planes(device).cpu().contiguous().view(torch.int32)
    differ = (planes[0] != planes[2]) | (planes[1] != planes[3])
    return int(differ.sum())


def mxu_parity_proven(device="cuda") -> bool:
    """True when the matrix form rounds bit-identically to the
    cached-squares form on ``device``; the verdict is cached per device
    (type and index)."""
    key = _device_key(device)
    with _cache_lock:
        hit = _parity_cache.get(key)
    if hit is not None:
        return hit
    proven = probe_differences(device) == 0
    with _cache_lock:
        _parity_cache[key] = proven
    return proven


def mxu_mode(device="cuda") -> str:
    """Resolve the gate for ``device``: ``"off"`` / ``"census"`` /
    ``"full"`` (see the module docstring)."""
    if os.environ.get(MXU_ENV, "0") == "0":
        return "off"
    return "full" if mxu_parity_proven(device) else "census"


def mxu_mode_for(devices) -> str:
    """The gate for a launch spanning ``devices`` (a mesh): full only if
    every device proves parity."""
    modes = {mxu_mode(d) for d in devices}
    if modes == {"off"}:
        return "off"
    return "full" if modes == {"full"} else "census"


def reset_mxu_cache() -> None:
    """Drop the cached parity verdicts (tests that force one)."""
    with _cache_lock:
        _parity_cache.clear()


def _census_step(zr, zi, c_real, c_imag):
    """The census's bf16 matrix step: the two products of a row are
    exact in f32 (8-bit significands), summed in f32 and rounded once to
    bf16, as a bf16 matrix unit with f32 accumulation rounds; then the
    bf16 add of c."""
    f = torch.float32
    r, i = zr.to(f), zi.to(f)
    sr = scout_cast(r * r + (-i) * i)
    si = scout_cast(i * r + r * i)
    return sr + c_real, si + c_imag


def census_panel(params: torch.Tensor, mrds: torch.Tensor, *, panel: int,
                 steps: int) -> torch.Tensor:
    """The bf16 matrix-form shadow over a ``panel x panel`` grid per tile
    -> (k,) int64: panel pixels that leave the radius-2 disk within
    ``steps`` steps and within their tile's budget.  ``params`` is
    (k, 4) f32 (the pitch already stretched to the panel), ``mrds`` (k,)
    int32, both on the census's device."""
    k = params.shape[0]
    dev = params.device
    idx = torch.arange(panel, dtype=torch.float32, device=dev)
    c_real = scout_cast((params[:, 0, None, None]
                         + idx[None, None, :] * params[:, 2, None, None])
                        .expand(k, panel, panel))
    c_imag = scout_cast((params[:, 1, None, None]
                         + idx[None, :, None] * params[:, 3, None, None])
                        .expand(k, panel, panel))
    four = scout_const(4.0, dev)
    zr, zi = c_real, c_imag
    act = torch.ones((k, panel, panel), dtype=torch.bool, device=dev)
    esc = torch.zeros((k,), dtype=torch.int64, device=dev)
    budget = mrds.to(torch.int64).reshape(k, 1, 1)
    for it in range(steps):
        zr, zi = _census_step(zr, zi, c_real, c_imag)
        hit = act & (zr * zr + zi * zi >= four) & (it + 1 <= budget)
        esc += hit.sum(dim=(1, 2))
        act &= ~hit
    return esc


def mxu_census_counts(params, max_iters, *, height: int, width: int,
                      steps: int = 64, panel: int = CENSUS_PANEL,
                      device="cuda") -> np.ndarray:
    """The census-mode shadow: per tile, the panel pixels the bf16
    matrix form predicts escape within ``min(steps, budget)`` steps, as
    an int32 numpy array.  ``params`` are the kernel's (k, 4) rows; the
    pitch is stretched by ``(extent - 1) / (panel - 1)`` so the panel
    spans the tile's window.  Advisory only."""
    params = np.array(params, dtype=np.float32, copy=True)
    k = params.shape[0]
    if k == 0:
        return np.zeros((0,), np.int32)
    params = params[:, :4]
    if panel > 1:
        params[:, 2] *= (width - 1) / (panel - 1)
        params[:, 3] *= (height - 1) / (panel - 1)
    dev = torch.device(device)
    mrds = torch.tensor([int(m) for m in max_iters], dtype=torch.int32)
    out = census_panel(torch.from_numpy(params).to(dev), mrds.to(dev),
                       panel=int(panel), steps=int(steps))
    return out.cpu().numpy().astype(np.int32)
