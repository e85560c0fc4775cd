"""Host side of the perturbation scans' kernels (``ops/csrc/
perturb_kernels.cu``), each with a wrapper, a plain PyTorch version and a
launch counter.  The JAX package computes these scans with XLA
(``ops/perturbation.py``: ``_perturb_scan`` and ``_perturb_scan_smooth``
under ``_segmented_orbit_scan``); it has no Pallas kernel for them.

- K9, ``perturb_scan``: :func:`perturb_state` -> ``(n, active, glitched,
  suspect)`` per pixel, the integer scan's state after the JAX package's
  segment loop with its stagnation stop (``suspect``: lanes still live
  when the stop fired).
- K10, ``perturb_scan_smooth``: :func:`perturb_smooth_state` -> ``(n,
  n2, fzr, fzi, act_b, act2, glitched)``, the smooth scan's state.

The epilogues that turn the state into counts or the smooth value are
torch functions of ``ops/perturbation.py``, shared by both routes, so
the kernels are held bit for bit against the plain versions on their
raw state.

A wrapper given CUDA tensors launches its kernel (or raises); it takes
the plain version only for tensors on the CPU.  K9's host loop reads
the live count after each 256-step segment from the launch's counters
and hands them to the segment loop's rule
(``perturbation._stagnation_loop``, which the plain version runs too);
one launch runs as many segments as can pass before a stop could fire,
so no lane runs past it.  Without the stop (K9 for the probes and the
repair, K10 always), one launch runs the whole orbit: a lane's state
then equals the segment loop's, which only ever stops once no lane is
live.  The kernels read the orbit as a table (:func:`orbit_table`):
each entry with its doublings, and the glitch test's tolerance times
its squared modulus, computed once per entry.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from distributedmandelbrot_tpu_torch.ops.perturbation import (
    GLITCH_TOL, PERTURB_SEGMENT, STAGNATION_MAX_LIVE, _segmented_orbit_scan,
    _stagnation_loop)

KERNEL_SCAN = "perturb_scan"
KERNEL_SMOOTH = "perturb_scan_smooth"

# K10's orbit tile (perturb.cuh ``kSmoothTile``): the table's rows come in
# whole tiles.
ORBIT_TILE = 256

# Flag bits of the state byte (perturb.cuh).
_ACTIVE, _GLITCHED = 1, 2
_ACT_B, _ACT2, _S_GLITCHED = 1, 2, 4

_counts_lock = threading.Lock()
_launches = {KERNEL_SCAN: 0, KERNEL_SMOOTH: 0}


def launch_counts() -> dict[str, int]:
    """Kernel launches so far in this process, by kernel."""
    with _counts_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _counts_lock:
        for name in _launches:
            _launches[name] = 0


def _count_launch(name: str) -> None:
    with _counts_lock:
        _launches[name] += 1


def _plane(dc_re: torch.Tensor, dc_im: torch.Tensor):
    """The deltas as broadcast 2-D views of one shape (a 1-D operand is
    one row)."""
    dc_re, dc_im = torch.broadcast_tensors(dc_re, dc_im)
    if dc_re.dim() == 1:
        dc_re, dc_im = dc_re[None, :], dc_im[None, :]
    if dc_re.dim() != 2 or dc_re.dtype != dc_im.dtype or \
            dc_re.dtype not in (torch.float32, torch.float64):
        raise ValueError("the deltas must be f32 or f64 of one or two "
                         "dimensions")
    return dc_re, dc_im


def _shape_of(dc_re: torch.Tensor, dc_im: torch.Tensor) -> torch.Size:
    """The deltas' broadcast shape.  (``torch.broadcast_shapes`` imports
    sympy on its first call: seconds of a process's first deep render.)"""
    return torch.broadcast_tensors(dc_re, dc_im)[0].shape


# --- plain versions -------------------------------------------------------


def _tol(dtype, device) -> torch.Tensor:
    return torch.tensor(GLITCH_TOL, dtype=dtype, device=device)


def _step_terms(zr, zi, dzr, dzi):
    """The tested value z = Z + dz, |z|^2 and |Z|^2 (shared with the BLA
    scans' exact steps)."""
    fr = zr + dzr
    fi = zi + dzi
    return fr, fi, fr * fr + fi * fi, zr * zr + zi * zi


def _delta_step(dzr, dzi, zr, zi, dc_re, dc_im, add_dc: bool):
    """The delta after one step from z = Z + dz (shared with the BLA
    scans' exact steps)."""
    ndzr = (zr + zr) * dzr - (zi + zi) * dzi + (dzr * dzr - dzi * dzi)
    ndzi = (zr + zr) * dzi + (zi + zi) * dzr + 2 * dzr * dzi
    if add_dc:
        ndzr = ndzr + dc_re
        ndzi = ndzi + dc_im
    return ndzr, ndzi


def perturb_state_plain(z_re, z_im, dc_re, dc_im, *, add_dc: bool = True,
                        stagnation: bool = True):
    """K9's plain version: the JAX package's ``_perturb_scan`` step under
    ``_segmented_orbit_scan``, in torch on the tensors' device ->
    ``(n, active, glitched, suspect)``."""
    dc_re, dc_im = _plane(dc_re, dc_im)
    dtype, dev = dc_re.dtype, dc_re.device
    tol = _tol(dtype, dev)

    def step(carry, zs):
        dzr, dzi, active, n, glitched = carry
        zr, zi = zs
        _, _, mag2, zmag2 = _step_terms(zr, zi, dzr, dzi)
        glitched = glitched | (active & (mag2 < tol * zmag2))
        active = active & (mag2 < 4.0)
        n = n + active.to(torch.int32)
        dzr, dzi = _delta_step(dzr, dzi, zr, zi, dc_re, dc_im, add_dc)
        return dzr, dzi, active, n, glitched

    shape = dc_re.shape
    init = (dc_re, dc_im, torch.ones(shape, dtype=torch.bool, device=dev),
            torch.zeros(shape, dtype=torch.int32, device=dev),
            torch.zeros(shape, dtype=torch.bool, device=dev))
    zr, zi = z_re.to(dtype), z_im.to(dtype)
    live = lambda c: bool(c[2].any())  # noqa: E731
    if stagnation:
        (_, _, active, n, glitched), suspect = _segmented_orbit_scan(
            step, init, zr, zi, live,
            stagnation=(lambda c: int(c[2].sum()), lambda c: c[2],
                        STAGNATION_MAX_LIVE))
    else:
        _, _, active, n, glitched = _segmented_orbit_scan(step, init, zr, zi,
                                                          live)
        suspect = torch.zeros(shape, dtype=torch.bool, device=dev)
    return n, active, glitched, suspect


def perturb_smooth_state_plain(z_re, z_im, dc_re, dc_im, *, bailout: float,
                               add_dc: bool = True):
    """K10's plain version: the JAX package's ``_perturb_scan_smooth`` step
    under ``_segmented_orbit_scan`` (live: either mask; no stagnation
    stop) -> ``(n, n2, fzr, fzi, act_b, act2, glitched)``."""
    dc_re, dc_im = _plane(dc_re, dc_im)
    dtype, dev = dc_re.dtype, dc_re.device
    tol = _tol(dtype, dev)
    b2 = torch.tensor(bailout * bailout, dtype=dtype, device=dev)

    def step(carry, zs):
        dzr, dzi, act_b, n, act2, n2, fzr, fzi, glitched = carry
        zr, zi = zs
        fr, fi, mag2, zmag2 = _step_terms(zr, zi, dzr, dzi)
        glitched = glitched | (act2 & (mag2 < tol * zmag2))
        newly = act_b & (mag2 >= b2)
        fzr = torch.where(newly, fr, fzr)
        fzi = torch.where(newly, fi, fzi)
        act_b = act_b & (mag2 < b2)
        n = n + act_b.to(torch.int32)
        act2 = act2 & (mag2 < 4.0)
        n2 = n2 + act2.to(torch.int32)
        dzr, dzi = _delta_step(dzr, dzi, zr, zi, dc_re, dc_im, add_dc)
        return dzr, dzi, act_b, n, act2, n2, fzr, fzi, glitched

    shape = dc_re.shape
    ones = torch.ones(shape, dtype=torch.bool, device=dev)
    zeros_i = torch.zeros(shape, dtype=torch.int32, device=dev)
    init = (dc_re, dc_im, ones, zeros_i, ones, zeros_i,
            torch.full(shape, bailout, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=torch.bool, device=dev))
    _, _, act_b, n, act2, n2, fzr, fzi, glitched = _segmented_orbit_scan(
        step, init, z_re.to(dtype), z_im.to(dtype),
        lambda c: bool((c[2] | c[4]).any()))
    return n, n2, fzr, fzi, act_b, act2, glitched


# --- the kernels' host loops ------------------------------------------------


def orbit_table(z_re, z_im, dtype):
    """The kernels' orbit operands: a contiguous (K, 4) table of (Zr, Zi,
    Zr + Zr, Zi + Zi) and tol * (Zr*Zr + Zi*Zi), in ``dtype`` on the
    orbit's device.  Each term is the plain scan's own operation on the
    same values, once per entry instead of once per lane.  K is the
    orbit's length padded with zero rows to whole tiles of
    :data:`ORBIT_TILE` (K10 copies whole tiles; no padded row is
    stepped)."""
    zr, zi = z_re.to(dtype), z_im.to(dtype)
    steps = torch.stack([zr, zi, zr + zr, zi + zi], dim=1)
    ztol = _tol(dtype, zr.device) * (zr * zr + zi * zi)
    pad = -steps.shape[0] % ORBIT_TILE
    return (torch.nn.functional.pad(steps, (0, 0, 0, pad)).contiguous(),
            torch.nn.functional.pad(ztol, (0, pad)).contiguous())


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _dc_args(dc_re: torch.Tensor, dc_im: torch.Tensor) -> list:
    return [_ptr(dc_re), dc_re.stride(0), dc_re.stride(1),
            _ptr(dc_im), dc_im.stride(0), dc_im.stride(1)]


def _stream(dev: torch.device) -> ctypes.c_void_p:
    if dev.type != "cuda":
        return ctypes.c_void_p(None)
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _check_rc(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.dm_error_string(rc).decode()}")


def scan_state_with(lib, z_re, z_im, dc_re, dc_im, *, add_dc: bool,
                    stagnation: bool, on_launch=None):
    """K9's host loop over ``lib.dm_perturb_scan`` (the card's library, or
    the host build of the same per-pixel loop in the CPU tests), on the
    tensors' device -> ``(n, active, glitched, suspect)``."""
    dc_re, dc_im = _plane(dc_re, dc_im)
    dtype, dev = dc_re.dtype, dc_re.device
    h, w = dc_re.shape
    steps, ztol = orbit_table(z_re, z_im, dtype)
    orbit_len = z_re.shape[0]
    dzr = torch.empty((h, w), dtype=dtype, device=dev)
    dzi = torch.empty_like(dzr)
    n = torch.empty((h, w), dtype=torch.int32, device=dev)
    flags = torch.empty((h, w), dtype=torch.uint8, device=dev)
    fixed = [int(dtype == torch.float64), int(add_dc), _ptr(steps),
             _ptr(ztol), *_dc_args(dc_re, dc_im), h, w, _ptr(dzr), _ptr(dzi),
             _ptr(n), _ptr(flags)]
    started = False

    def launch(k0: int, k1: int, counts: torch.Tensor | None) -> None:
        nonlocal started
        rc = lib.dm_perturb_scan(*fixed, k0, k1, int(not started),
                                 PERTURB_SEGMENT, _ptr(counts), _stream(dev))
        _check_rc(lib, rc, KERNEL_SCAN)
        started = True
        if on_launch is not None:
            on_launch()

    full = orbit_len // PERTURB_SEGMENT
    if not stagnation:
        launch(0, orbit_len, None)
        suspect = torch.zeros((h, w), dtype=torch.bool, device=dev)
    else:
        def segments(seg: int, k: int) -> list[int]:
            counts = torch.zeros(k, dtype=torch.int32, device=dev)
            launch(seg * PERTURB_SEGMENT, (seg + k) * PERTURB_SEGMENT,
                   counts)
            # The stagnation census picks the next stop on the host, as
            # the JAX package's scan does.
            return counts.tolist()  # dmtpu: ignore[torch-host-sync]

        seg = _stagnation_loop(segments, h * w, full,
                               cap=STAGNATION_MAX_LIVE)
        # Lanes live at a stop before the orbit's last whole segment are
        # suspect; the ragged tail then runs on the carry of the stop, as
        # the segment loop's does (it may move them: they are flagged).
        suspect = ((flags & _ACTIVE) != 0 if seg < full else
                   torch.zeros((h, w), dtype=torch.bool, device=dev))
        if not started or orbit_len > full * PERTURB_SEGMENT:
            launch(full * PERTURB_SEGMENT, orbit_len, None)
    active = (flags & _ACTIVE) != 0
    glitched = (flags & _GLITCHED) != 0
    return n, active, glitched, suspect


def smooth_state_with(lib, z_re, z_im, dc_re, dc_im, *, bailout: float,
                      add_dc: bool, tiles: torch.Tensor | None = None,
                      on_launch=None):
    """K10's host loop (one launch over the whole orbit) -> ``(n, n2,
    fzr, fzi, act_b, act2, glitched)``.  ``tiles``, one int64 on the
    deltas' device, gains the orbit tiles the kernel's blocks staged."""
    dc_re, dc_im = _plane(dc_re, dc_im)
    dtype, dev = dc_re.dtype, dc_re.device
    h, w = dc_re.shape
    steps, ztol = orbit_table(z_re, z_im, dtype)
    dzr = torch.empty((h, w), dtype=dtype, device=dev)
    dzi, fzr, fzi = (torch.empty_like(dzr) for _ in range(3))
    n = torch.empty((h, w), dtype=torch.int32, device=dev)
    n2 = torch.empty_like(n)
    flags = torch.empty((h, w), dtype=torch.uint8, device=dev)
    rc = lib.dm_perturb_scan_smooth(
        int(dtype == torch.float64), int(add_dc), _ptr(steps), _ptr(ztol),
        *_dc_args(dc_re, dc_im), h, w, bailout * bailout, bailout,
        _ptr(dzr), _ptr(dzi), _ptr(n), _ptr(n2), _ptr(fzr), _ptr(fzi),
        _ptr(flags), 0, z_re.shape[0], 1, steps.shape[0], _ptr(tiles),
        _stream(dev))
    _check_rc(lib, rc, KERNEL_SMOOTH)
    if on_launch is not None:
        on_launch()
    return (n, n2, fzr, fzi, (flags & _ACT_B) != 0, (flags & _ACT2) != 0,
            (flags & _S_GLITCHED) != 0)


def _cuda_lib(*tensors: torch.Tensor):
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the orbit and the deltas must share a device")
    from distributedmandelbrot_tpu_torch.ops import _build
    return _build.load()


def perturb_state_cuda(z_re, z_im, dc_re, dc_im, *, add_dc: bool = True,
                       stagnation: bool = True):
    """K9 on the tensors' CUDA device (launches enqueued on its current
    stream; with the stagnation stop armed, the host reads each launch's
    segment counts)."""
    lib = _cuda_lib(z_re, z_im, dc_re, dc_im)
    with torch.cuda.device(dc_re.device):
        return scan_state_with(lib, z_re, z_im, dc_re, dc_im, add_dc=add_dc,
                               stagnation=stagnation,
                               on_launch=lambda: _count_launch(KERNEL_SCAN))


def perturb_smooth_state_cuda(z_re, z_im, dc_re, dc_im, *, bailout: float,
                              add_dc: bool = True,
                              tiles: torch.Tensor | None = None):
    """K10 on the tensors' CUDA device (one launch, no sync; ``tiles`` as
    for :func:`smooth_state_with`)."""
    lib = _cuda_lib(z_re, z_im, dc_re, dc_im)
    with torch.cuda.device(dc_re.device):
        return smooth_state_with(
            lib, z_re, z_im, dc_re, dc_im, bailout=bailout, add_dc=add_dc,
            tiles=tiles, on_launch=lambda: _count_launch(KERNEL_SMOOTH))


def perturb_state(z_re, z_im, dc_re, dc_im, *, add_dc: bool = True,
                  stagnation: bool = True):
    """K9's wrapper: the kernel for CUDA tensors, the plain version for
    tensors on the CPU.  The state has the deltas' broadcast shape."""
    fn = (perturb_state_cuda if dc_re.device.type == "cuda" else
          perturb_state_plain)
    shape = _shape_of(dc_re, dc_im)
    return tuple(t.reshape(shape) for t in fn(
        z_re, z_im, dc_re, dc_im, add_dc=add_dc, stagnation=stagnation))


def perturb_smooth_state(z_re, z_im, dc_re, dc_im, *, bailout: float,
                         add_dc: bool = True,
                         tiles: torch.Tensor | None = None):
    """K10's wrapper: the kernel for CUDA tensors (``tiles`` as for
    :func:`smooth_state_with`), the plain version for tensors on the CPU.
    The state has the deltas' broadcast shape."""
    shape = _shape_of(dc_re, dc_im)
    if dc_re.device.type == "cuda":
        state = perturb_smooth_state_cuda(z_re, z_im, dc_re, dc_im,
                                          bailout=bailout, add_dc=add_dc,
                                          tiles=tiles)
    else:
        state = perturb_smooth_state_plain(z_re, z_im, dc_re, dc_im,
                                           bailout=bailout, add_dc=add_dc)
    return tuple(t.reshape(shape) for t in state)
