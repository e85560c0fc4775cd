"""Host side of the escape-time kernels: the port of the host half of the
JAX package's ``ops/pallas_escape.py``.

Five kernels (``ops/csrc/escape_kernels.cu``), each with a wrapper, a
plain PyTorch version and a launch counter:

- K1, ``escape_tile`` (replaces ``_escape_block_kernel``):
  :func:`compute_tile_cuda_device`, one tile -> (height, width) uint8,
  for Mandelbrot, Julia (``julia_c``), Multibrot (``power``) and the
  Burning Ship (``burning``); :func:`compute_tile_cuda`,
  :func:`compute_tile_julia_cuda` and :func:`compute_tile_family_cuda`
  return it as a flat numpy array.
- K2, ``escape_mega`` (replaces ``_escape_mega_kernel``):
  :func:`compute_tiles_mega_cuda`, k same-shaped tiles of one mode fused
  -> (k, height, width) uint8 plus the (k, 1) int32 bf16 scout census,
  every mode of K1, each plane equal to K1 on its tile.  k is unbounded:
  a batch of more than :data:`MEGA_MAX_TILES` tiles runs as several
  launches of one plan.
- K8 (replaces ``ops/mxu_iteration.py``'s ``mxu_step``, which rides
  inside the Pallas K1 and K2): ``use_mxu`` of K1 and K2, the
  rotation-matrix form of z^2 + c (degree 2 without the Burning Ship's
  fold), admitted by the ``DMTPU_MXU`` gate of
  :mod:`~distributedmandelbrot_tpu_torch.ops.mxu_iteration`.
- K4, ``escape_smooth`` (replaces ``_smooth_block_kernel``):
  :func:`compute_tile_smooth_cuda`, one tile -> (height, width) f32
  smooth values, every mode of K1.
- K5, ``escape_pack`` (replaces ``_escape_pack_kernel``):
  :func:`compute_tiles_packed_cuda`, n <= 4 same-shaped tiles in one
  launch -> (n, height, width) uint8, every mode of K1.
- K3, ``escape_batch`` (replaces ``_escape_batch_kernel``):
  :func:`compute_tiles_batch_cuda`, k same-shaped tiles from raw params
  rows in one launch -> (k, height, width) uint8, every mode of K1, each
  plane equal to K1 on its row; :func:`prefer_batch_grid` is the
  reference's policy for when a mesh shard takes it.

K6 and K7, the compacted pipeline's kernels, have their host side in
``ops/compact_escape.py``; their launches are counted here too.
K1 in the matrix form (K8), and K2 in the matrix form and in each mode
other than Mandelbrot, are counted under names of their own
(``escape_tile_mxu``, ``escape_mega_mxu``, ``escape_mega_julia``, ...),
so ``escape_tile`` and ``escape_mega`` count the cached-squares form and,
for K2, Mandelbrot only.

K1-K5 run persistent warps that refill retired lanes, stepping in
groups of 8 (``escape_kernels.cu``): each launch takes its own run
counter, zeroed on its stream, and its grid from the occupancy API; each
has an instrumented form (``lane_steps``) that counts the lane steps its
warps issue, as K6 (one thread a pixel) has.

A wrapper given CUDA tensors' device launches its kernel (or raises); it
takes the plain version only for the CPU, the counterpart of the
reference's interpret mode.  The guards that decline a tile raise
:class:`KernelUnsupported`, the cue for callers to take the torch path.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from distributedmandelbrot_tpu_torch.core.geometry import (TileSpec,
                                                           spec_f32_resolvable)
from distributedmandelbrot_tpu_torch.ops import escape_time

# The reference's escape-loop segment length.  Here it only sizes the
# census window: scout_segments * min(DEFAULT_UNROLL, cap - 1) steps.
DEFAULT_UNROLL = 64

# bf16 scout census: one segment, armed when the deepest budget of a
# fused batch reaches SCOUT_MIN_ITER (the reference's defaults).
SCOUT_SEGMENTS_DEFAULT = 1
SCOUT_MIN_ITER = 256

# Fused tiles per K2 launch (their params ride the launch's parameter
# block; see escape_kernels.cu).  A larger batch runs as launches of at
# most this many tiles.
MEGA_MAX_TILES = 128

# Same-shaped tiles per K5 launch (the reference's PACK_MAX).
PACK_MAX = 4

KERNEL_TILE = "escape_tile"
KERNEL_MEGA = "escape_mega"
KERNEL_SMOOTH = "escape_smooth"
KERNEL_PACK = "escape_pack"
KERNEL_BATCH = "escape_batch"
KERNEL_STATE = "escape_state"
KERNEL_RESUME = "escape_resume"
# K1 and K2 in K8's matrix form, and K2 in its modes beyond Mandelbrot.
KERNEL_TILE_MXU = "escape_tile_mxu"
KERNEL_MEGA_MXU = "escape_mega_mxu"
KERNEL_MEGA_JULIA = "escape_mega_julia"
KERNEL_MEGA_MULTIBROT = "escape_mega_multibrot"
KERNEL_MEGA_SHIP = "escape_mega_ship"

_counts_lock = threading.Lock()
_launches = {KERNEL_TILE: 0, KERNEL_MEGA: 0, KERNEL_SMOOTH: 0,
             KERNEL_PACK: 0, KERNEL_BATCH: 0, KERNEL_STATE: 0,
             KERNEL_RESUME: 0, KERNEL_TILE_MXU: 0, KERNEL_MEGA_MXU: 0,
             KERNEL_MEGA_JULIA: 0, KERNEL_MEGA_MULTIBROT: 0,
             KERNEL_MEGA_SHIP: 0}

# The batch-grid policy (pallas_escape.prefer_batch_grid): one K3 launch
# per shard when the deepest budget reaches BATCH_GRID_MIN_ITER, or when
# a tile has fewer than BATCH_GRID_MIN_PROGRAMS blocks of the
# reference's (64, 128) block shape; a chain of K1 launches otherwise.
# The port has no blocks: the shape only counts programs, so the
# decision equals the reference's wherever the reference accepts the
# tile, and no extent is refused.
BATCH_GRID_MIN_ITER = 4096
BATCH_GRID_MIN_PROGRAMS = 64
REF_BLOCK_H, REF_BLOCK_W = 64, 128

# The kernels' family and interior-test codes (escape.cuh: dm::Family,
# dm::Interior).
_QUADRATIC, _SHIP, _MULTIBROT = 0, 1, 2
_NO_INTERIOR, _CARDIOID_BULB, _DISK = 0, 1, 2


def launch_counts() -> dict[str, int]:
    """Kernel launches so far in this process, by kernel and variant."""
    with _counts_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _counts_lock:
        for name in _launches:
            _launches[name] = 0


def _count_launch(name: str) -> None:
    with _counts_lock:
        _launches[name] += 1


class KernelUnsupported(ValueError):
    """The intentional declines of the kernel path (pitch below f32
    resolution, a budget needing int64 scaling, tiles of different
    shapes in one fused or packed batch, more than PACK_MAX tiles in a
    pack, the MXU form): the cue for callers to fall back.  A ValueError
    subclass, but fall-back sites catch THIS type, so a real bug still
    propagates."""


def _check_dispatch_mode(power: int, burning: bool, julia: bool) -> None:
    """Family and mode validation shared by every wrapper (a plain
    ValueError: a user error on every path, not a fall-back cue)."""
    from distributedmandelbrot_tpu_torch.ops.families import _check_family
    _check_family(power, burning)
    if julia and (power != 2 or burning):
        raise ValueError("julia mode supports the degree-2 recurrence only")


def _check_f32_resolvable(spec: TileSpec) -> None:
    """Decline views whose pixel pitch aliases in f32: the kernel
    generates ``start + i*step`` in f32, and below a few ulps per pixel
    adjacent columns collapse.  Those need the f64 path."""
    if not spec_f32_resolvable(spec):
        raise KernelUnsupported(
            f"pixel pitch of {spec!r} is below f32 resolution "
            "(adjacent pixels alias); use the f64 path")


def _guard_budget(max_iter: int) -> None:
    """The kernels' epilogue is int32; deeper budgets take the torch
    path, which scales in int64."""
    if max_iter - 1 >= escape_time.INT32_SCALE_LIMIT:
        raise KernelUnsupported(
            f"max_iter {max_iter} too deep for the kernel path")


def _guard_mxu(use_mxu: bool, power: int, burning: bool) -> None:
    """The matrix form (K8) embeds z^2 only: Multibrot degrees and the
    Burning Ship's fold decline it, as in the reference."""
    if use_mxu and (power != 2 or burning):
        raise KernelUnsupported(
            "mxu iteration form supports the degree-2 non-burning "
            "recurrence only")


def _params_row(spec: TileSpec, julia_c: complex | None = None) -> list:
    """One tile's params row ``(start_r, start_i, step_r, step_i)``,
    computed in f64 on the host (per-axis pitch), with the
    f32-resolvability guard applied; Julia mode appends the constant
    ``(c_r, c_i)``.  Callers cast it to f32 once."""
    _check_f32_resolvable(spec)
    row = [spec.start_real, spec.start_imag,
           spec.range_real / (spec.width - 1),
           spec.range_imag / (spec.height - 1)]
    if julia_c is not None:
        jc = complex(julia_c)
        row += [jc.real, jc.imag]
    return row


def _mode_args(power: int, burning: bool, julia: bool,
               interior_check: bool) -> tuple[int, int, float]:
    """The kernels' ``(family, interior_mode, disk_lim)`` for a mode:
    escape_time.family_interior's policy (none for Julia or the ship),
    with the disk limit rounded once to f32."""
    family = _SHIP if burning else (_MULTIBROT if power > 2 else _QUADRATIC)
    if not interior_check or julia or burning:
        return family, _NO_INTERIOR, 0.0
    if power == 2:
        return family, _CARDIOID_BULB, 0.0
    r = escape_time.multibrot_interior_radius(power)
    lim = np.float32(r * r - escape_time.INTERIOR_MARGIN[torch.float32])
    return family, _DISK, float(lim)


def _row6(row) -> np.ndarray:
    """A params row as the kernels' 6 f32 (the Julia slots zero when the
    row has 4)."""
    out = np.zeros(6, dtype=np.float32)
    r = np.asarray(row, dtype=np.float32)
    out[:r.size] = r
    return out


def bucket_cap(max_iter: int) -> int:
    """The reference's static compile cap of a budget (a power of two,
    at least 256).  The CUDA kernels need no cap; it survives because
    the census window and the degenerate-batch rule are defined by it."""
    return 1 << max(8, (max_iter - 1).bit_length()) if max_iter > 1 else 1


def prefer_batch_grid(budget: int, height: int, width: int) -> bool:
    """Whether a mesh shard runs as one K3 launch: the deepest budget
    (the TRUE one, not the bucketed cap) reaches
    :data:`BATCH_GRID_MIN_ITER`, or a tile holds fewer than
    :data:`BATCH_GRID_MIN_PROGRAMS` reference blocks."""
    programs = (height // REF_BLOCK_H) * (width // REF_BLOCK_W)
    return (budget >= BATCH_GRID_MIN_ITER
            or programs < BATCH_GRID_MIN_PROGRAMS)


def mega_dispatch_plan(specs, max_iters, *, clamp: bool = False,
                       interior_check: bool = True,
                       cycle_check: bool | None = None,
                       scout_segments: int | None = None, power: int = 2,
                       burning: bool = False, julia_cs=None,
                       use_mxu: bool | None = None, device="cuda"):
    """Validate a fused batch and resolve its launch decisions, the
    reference's policy: returns ``(rows, mrd_rows, kwargs)`` with
    ``rows`` (k, 4) f32, or (k, 6) with the Julia constants of
    ``julia_cs`` (one per tile), ``mrd_rows`` (k, 1) int32, and the
    launch keywords (shape, clamp, the interior check — off in Julia
    mode — the probe resolved from the deepest REQUESTED budget, the
    census window in steps, the family, and the matrix form).

    ``use_mxu=None`` resolves the ``DMTPU_MXU`` gate for ``device`` (a
    device, or the devices of a mesh): the matrix form only in full
    mode.  ``use_mxu`` with a Multibrot degree or the Burning Ship
    raises :class:`KernelUnsupported`."""
    k = len(specs)
    julia = julia_cs is not None
    _check_dispatch_mode(power, burning, julia)
    if use_mxu is None:
        from distributedmandelbrot_tpu_torch.ops.mxu_iteration import (
            mxu_mode_for)
        devices = (device if isinstance(device, (list, tuple))
                   else [device])
        use_mxu = mxu_mode_for(devices) == "full"
    _guard_mxu(use_mxu, power, burning)
    if k < 1:
        raise ValueError("empty tile batch")
    if len(max_iters) != k:
        raise ValueError("specs and max_iters length mismatch")
    if julia and (len(julia_cs) != k or any(c is None for c in julia_cs)):
        raise ValueError("julia_cs must give a constant per tile")
    h, w = specs[0].height, specs[0].width
    for spec in specs:
        if (spec.height, spec.width) != (h, w):
            raise KernelUnsupported("fused tiles must share height/width")
    cap_req = max(int(m) for m in max_iters)
    _guard_budget(cap_req)
    rows = np.asarray([_params_row(spec, julia_cs[t] if julia else None)
                       for t, spec in enumerate(specs)], dtype=np.float32)
    mrd_rows = np.asarray([[int(m)] for m in max_iters], dtype=np.int32)
    if scout_segments is None:
        scout_segments = (SCOUT_SEGMENTS_DEFAULT
                          if cap_req >= SCOUT_MIN_ITER else 0)
    cap = bucket_cap(cap_req)
    unroll_eff = max(1, min(DEFAULT_UNROLL, max(1, cap - 1)))
    kwargs = dict(
        height=h, width=w, clamp=clamp,
        interior_check=interior_check and not julia,
        cycle_check=escape_time.resolve_cycle_check(cycle_check, cap_req),
        # A batch whose cap leaves no iteration is all zeros, census 0.
        scout_steps=int(scout_segments) * unroll_eff if cap > 1 else 0,
        power=power, burning=burning, use_mxu=bool(use_mxu))
    return rows, mrd_rows, kwargs


# --- plain PyTorch versions ----------------------------------------------


def kernel_grid(row, height: int, width: int, device) -> tuple[torch.Tensor,
                                                               torch.Tensor]:
    """The kernels' own grid: ``start + index * step`` in f32 from an
    f32 params row — differs from the host linspace by up to one ulp."""
    r = torch.as_tensor(np.asarray(row, dtype=np.float32), device=device)
    col = torch.arange(width, dtype=torch.float32, device=device)
    lin = torch.arange(height, dtype=torch.float32, device=device)
    g_real = r[0] + col * r[2]
    g_imag = r[1] + lin * r[3]
    return (g_real[None, :].expand(height, width),
            g_imag[:, None].expand(height, width))


def _kernel_orbit_inputs(row, height: int, width: int, device):
    """``(z0 real, z0 imag, c real, c imag, julia)`` of a params row: z0
    is the kernel grid; c is the grid, or the f32 Julia constant of a
    6-wide row."""
    g_real, g_imag = kernel_grid(row, height, width, device)
    r = np.asarray(row, dtype=np.float32)
    if r.size != 6:
        return g_real, g_imag, g_real, g_imag, False
    return (g_real, g_imag,
            torch.full((height, width), float(r[4]), dtype=torch.float32,
                       device=device),
            torch.full((height, width), float(r[5]), dtype=torch.float32,
                       device=device), True)


def escape_tile_plain(row, mrd: int, height: int, width: int, *,
                      clamp: bool = False, interior_check: bool = True,
                      cycle_check: bool = False, power: int = 2,
                      burning: bool = False, use_mxu: bool = False,
                      device="cpu", return_steps: bool = False):
    """K1's plain version: one tile from its f32 params row (4 wide, or
    6 with a Julia constant) and budget -> (height, width) uint8 on
    ``device`` (and, with ``return_steps``, the steps each pixel ran).
    ``use_mxu`` steps with K8's plain version, the matrix form."""
    zr0, zi0, c_real, c_imag, julia = _kernel_orbit_inputs(row, height,
                                                           width, device)
    dyn = int(mrd) - 1
    if dyn <= 0:
        out = torch.zeros((height, width), dtype=torch.uint8, device=device)
        steps = torch.zeros((height, width), dtype=torch.int32,
                            device=device)
        return (out, steps) if return_steps else out
    interior = (escape_time.family_interior(c_real, c_imag, power, burning)
                if interior_check and not julia else None)
    n, steps = escape_time.escape_loop(
        zr0, zi0, c_real, c_imag, total_steps=dyn, interior=interior,
        cycle_check=cycle_check, power=power, burning=burning,
        use_mxu=use_mxu, return_steps=True)
    counts = escape_time.counts_from_survival(n, dyn)
    out = escape_time.scale_counts_to_uint8(counts, max_iter=int(mrd),
                                            clamp=clamp)
    return (out, steps) if return_steps else out


def scout_census_plain(g_real: torch.Tensor, g_imag: torch.Tensor,
                       live0: torch.Tensor, steps: int, *,
                       c_real: torch.Tensor | None = None,
                       c_imag: torch.Tensor | None = None, power: int = 2,
                       burning: bool = False, return_steps: bool = False):
    """The bf16 scout census: of the initially-live pixels ``live0``,
    how many a bf16 shadow of the orbit from z0 = the grid (every op
    rounded to bf16, |z|^2 included) sees leave the radius-2 disk within
    ``steps``.  c is the grid, or the Julia constant ``c_real, c_imag``;
    the update is the family's (the Burning Ship's ``|cross|``, degree
    ``power`` through :func:`~.escape_time.family_step`).
    ``return_steps`` also returns the shadow steps the kernel runs for
    them (each live pixel until it leaves or the window ends)."""
    from distributedmandelbrot_tpu_torch.ops.mixed_precision import (
        scout_cast, scout_const)
    zr, zi = scout_cast(g_real), scout_cast(g_imag)
    cr = zr if c_real is None else scout_cast(c_real)
    ci = zi if c_imag is None else scout_cast(c_imag)
    zr2 = zr * zr
    zi2 = zi * zi
    four = scout_const(4.0, g_real.device)
    act = live0.clone()
    ran = torch.zeros((), dtype=torch.int64, device=g_real.device)
    for _ in range(steps):
        ran += act.sum()
        if power == 2:
            cross = (zr + zr) * zi
            zi = (cross.abs() if burning else cross) + ci
            zr = (zr2 - zi2) + cr
        else:
            zr, zi = escape_time.family_step(zr, zi, cr, ci, power=power,
                                             burning=False)
        zr2 = zr * zr
        zi2 = zi * zi
        act = act & (zr2 + zi2 < four)
    census = int(live0.sum()) - int(act.sum())
    return (census, int(ran)) if return_steps else census


def escape_mega_plain(rows, mrd_rows, *, height: int, width: int,
                      clamp: bool = False, interior_check: bool = True,
                      cycle_check: bool = False, scout_steps: int = 0,
                      power: int = 2, burning: bool = False,
                      use_mxu: bool = False, device="cpu",
                      return_steps: bool = False):
    """K2's plain version: per tile, K1's plain version and the census
    -> ((k, height, width) uint8, (k, 1) int32) on ``device``.  Rows are
    (k, 4), or (k, 6) with Julia constants (no interior shortcut then).
    ``return_steps`` adds the f32 steps each pixel ran, (k, height,
    width), and the bf16 scout steps per tile, a list of k ints."""
    rows = np.asarray(rows, dtype=np.float32)
    mrds = np.asarray(mrd_rows, dtype=np.int32).reshape(-1)
    julia = rows.shape[1] == 6
    interior = interior_check and not julia
    tiles, census, steps, scout_ran = [], [], [], []
    for row, mrd in zip(rows, mrds):
        out, st = escape_tile_plain(row, int(mrd), height, width,
                                    clamp=clamp, interior_check=interior,
                                    cycle_check=cycle_check, power=power,
                                    burning=burning, use_mxu=use_mxu,
                                    device=device, return_steps=True)
        tiles.append(out)
        steps.append(st)
        hits, ran = 0, 0
        if scout_steps > 0:
            g_real, g_imag, c_real, c_imag, _ = _kernel_orbit_inputs(
                row, height, width, device)
            inside = (escape_time.family_interior(c_real, c_imag, power,
                                                  burning)
                      if interior else None)
            live0 = (torch.ones((height, width), dtype=torch.bool,
                                device=device)
                     if inside is None else ~inside)
            hits, ran = scout_census_plain(
                g_real, g_imag, live0, scout_steps, c_real=c_real,
                c_imag=c_imag, power=power, burning=burning,
                return_steps=True)
        census.append(hits)
        scout_ran.append(ran)
    out = (torch.stack(tiles),
           torch.tensor(census, dtype=torch.int32,
                        device=device).reshape(-1, 1))
    return out + (torch.stack(steps), scout_ran) if return_steps else out


def escape_pack_plain(rows, mrd_rows, *, height: int, width: int,
                      clamp: bool = False, interior_check: bool = True,
                      cycle_check: bool = False, power: int = 2,
                      burning: bool = False, device="cpu",
                      return_steps: bool = False):
    """K5's plain version: K1's plain version per state -> (n, height,
    width) uint8 on ``device`` (the packed kernel steps each state
    exactly as K1 does; ``return_steps`` adds the steps, (n, height,
    width))."""
    rows = np.asarray(rows, dtype=np.float32)
    mrds = np.asarray(mrd_rows, dtype=np.int32).reshape(-1)
    planes = [escape_tile_plain(row, int(mrd), height, width, clamp=clamp,
                                interior_check=interior_check,
                                cycle_check=cycle_check, power=power,
                                burning=burning, device=device,
                                return_steps=True)
              for row, mrd in zip(rows, mrds)]
    out = torch.stack([p for p, _ in planes])
    if return_steps:
        return out, torch.stack([st for _, st in planes])
    return out


def escape_batch_plain(rows, mrd_rows, *, height: int, width: int,
                       clamp: bool = False, interior_check: bool = True,
                       cycle_check: bool = False, power: int = 2,
                       burning: bool = False, device="cpu",
                       return_steps: bool = False):
    """K3's plain version: K1's plain version per params row (4 wide, or
    6 with a Julia constant) -> (k, height, width) uint8 on ``device``
    (``return_steps`` adds the steps, (k, height, width)).  Same as K5's
    plain version: both kernels step every tile exactly as K1 does."""
    return escape_pack_plain(rows, mrd_rows, height=height, width=width,
                             clamp=clamp, interior_check=interior_check,
                             cycle_check=cycle_check, power=power,
                             burning=burning, device=device,
                             return_steps=return_steps)


def smooth_step_limit(max_iter: int, bailout: float) -> int:
    """Steps a pixel still live at the end of K4 has run: the Pallas
    kernel runs whole segments of ``u = min(DEFAULT_UNROLL,
    bucket_cap(max_iter) - 1)`` steps while within ``max_iter - 1 +
    extra`` (escape_time.segment_steps).  For a budget that steps
    (max_iter > 1) the cap is at least 256, so u is 64 and the limit a
    multiple of K4's 8-step group."""
    u = max(1, min(DEFAULT_UNROLL, max(1, bucket_cap(max_iter) - 1)))
    return escape_time.segment_steps(
        max_iter - 1 + escape_time.smooth_extra_steps(bailout), u)


def escape_smooth_plain(row, mrd: int, height: int, width: int, *,
                        bailout: float = 256.0, interior_check: bool = True,
                        cycle_check: bool = False, power: int = 2,
                        burning: bool = False, device="cpu",
                        return_steps: bool = False):
    """K4's plain version: one tile from its f32 params row and budget
    -> (height, width) f32 smooth values on ``device`` (and, with
    ``return_steps``, the steps each pixel ran)."""
    zr0, zi0, c_real, c_imag, julia = _kernel_orbit_inputs(row, height,
                                                           width, device)
    dyn = int(mrd) - 1
    if dyn <= 0:
        out = torch.zeros((height, width), dtype=torch.float32,
                          device=device)
        steps = torch.zeros((height, width), dtype=torch.int32,
                            device=device)
        return (out, steps) if return_steps else out
    interior = (escape_time.family_interior(c_real, c_imag, power, burning)
                if interior_check and not julia else None)
    n, n2, zr, zi, steps = escape_time.escape_smooth_loop(
        zr0, zi0, c_real, c_imag, total_steps=dyn,
        step_limit=smooth_step_limit(int(mrd), bailout), bailout=bailout,
        interior=interior, cycle_check=cycle_check, power=power,
        burning=burning, return_steps=True)
    nu = escape_time.smooth_nu(n, n2, zr, zi, total_steps=dyn,
                               bailout=bailout, power=power)
    return (nu, steps) if return_steps else nu


# --- wrappers ------------------------------------------------------------


def _cuda_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _work_counter(dev: torch.device) -> torch.Tensor:
    """A persistent launch's own run counter, zeroed on the current
    stream: two launches in flight, as the two shards of the ring
    ``[cuda:0, cuda:0]`` are, never share one, and no host sync."""
    return torch.zeros((1,), dtype=torch.int64, device=dev)


def _lane_steps_ptr(lane_steps: torch.Tensor | None,
                    dev: torch.device) -> ctypes.c_void_p:
    if lane_steps is None:
        return ctypes.c_void_p(None)
    if (lane_steps.device != dev or lane_steps.dtype != torch.int64
            or lane_steps.numel() != 1):
        raise ValueError("lane_steps must be one int64 on the launch's "
                         "device")
    return ctypes.c_void_p(lane_steps.data_ptr())


# The persistent kernels, as dm_persistent_blocks_per_sm numbers them.
_PERSISTENT = {KERNEL_TILE: 0, KERNEL_MEGA: 1, KERNEL_BATCH: 2,
               KERNEL_PACK: 3, KERNEL_SMOOTH: 4}


def persistent_occupancy(kernel: str, *, power: int = 2,
                         burning: bool = False, use_mxu: bool = False,
                         julia: bool = False, device="cuda") -> dict:
    """A persistent kernel's grid on ``device`` (``kernel``: K1
    ``escape_tile``, K2 ``escape_mega``, K3 ``escape_batch``, K5
    ``escape_pack`` or K4 ``escape_smooth``; ``use_mxu`` for K1 and K2
    only): blocks and warps per
    SM (the occupancy API, as the launches size their grids) and the
    threads per block."""
    from distributedmandelbrot_tpu_torch.ops import _build
    lib = _build.load()
    family, _, _ = _mode_args(power, burning, julia, False)
    with torch.cuda.device(_cuda_device(device)):
        blocks = lib.dm_persistent_blocks_per_sm(_PERSISTENT[kernel], family,
                                                 int(use_mxu), int(julia))
    threads = lib.dm_persistent_block_threads()
    return {"blocks_per_sm": blocks, "threads_per_block": threads,
            "warps_per_sm": blocks * threads // 32}


def _check_rc(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.dm_error_string(rc).decode()}")


def compute_tile_cuda_device(spec: TileSpec, max_iter: int, *,
                             clamp: bool = False,
                             interior_check: bool = True,
                             cycle_check: bool | None = None,
                             use_mxu: bool = False, power: int = 2,
                             burning: bool = False,
                             julia_c: complex | None = None,
                             device="cuda") -> torch.Tensor:
    """K1: one tile -> (height, width) uint8 tensor on ``device``, the
    launch enqueued on the device's current stream (no sync).  Mandelbrot
    by default; the Julia set of ``julia_c`` (z from the grid, no
    interior shortcut), the degree-``power`` Multibrot, or the Burning
    Ship (``burning``).  ``use_mxu`` runs K8's matrix form (degree 2
    without the fold).  The probe policy follows the tile's requested
    budget."""
    _check_dispatch_mode(power, burning, julia_c is not None)
    _guard_mxu(use_mxu, power, burning)
    _guard_budget(max_iter)
    return compute_tile_row_cuda(
        _params_row(spec, julia_c), max_iter, spec.height, spec.width,
        clamp=clamp, interior_check=interior_check,
        cycle_check=cycle_check, power=power, burning=burning,
        use_mxu=use_mxu, device=device)


def compute_tile_row_cuda(row, max_iter: int, height: int, width: int, *,
                          clamp: bool = False, interior_check: bool = True,
                          cycle_check: bool | None = None, power: int = 2,
                          burning: bool = False, use_mxu: bool = False,
                          device="cuda",
                          lane_steps: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """K1 from a raw params row (4 wide, or 6 with a Julia constant; no
    resolvability guard, as the reference's mesh rows have none) ->
    (height, width) uint8 on ``device``, enqueued on its current
    stream.  ``lane_steps``, a (1,) int64 tensor on the card, launches
    the instrumented form instead, which adds to it the lane steps its
    warps issue (a measurement; no path of the port passes it)."""
    row = np.asarray(row, dtype=np.float32)
    julia = row.size == 6
    _check_dispatch_mode(power, burning, julia)
    _guard_mxu(use_mxu, power, burning)
    _guard_budget(max_iter)
    cycle = escape_time.resolve_cycle_check(cycle_check, max_iter)
    dev = _cuda_device(device)
    if dev.type != "cuda":
        return escape_tile_plain(row, max_iter, height, width, clamp=clamp,
                                 interior_check=interior_check,
                                 cycle_check=cycle, power=power,
                                 burning=burning, use_mxu=use_mxu,
                                 device=dev)
    from distributedmandelbrot_tpu_torch.ops import _build
    lib = _build.load()
    family, interior_mode, disk_lim = _mode_args(power, burning, julia,
                                                 interior_check)
    row6 = _row6(row)
    with torch.cuda.device(dev):
        out = torch.empty((height, width), dtype=torch.uint8, device=dev)
        work = _work_counter(dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dm_escape_tile(
            ctypes.c_void_p(out.data_ptr()), height, width,
            ctypes.c_void_p(row6.ctypes.data), int(julia), int(max_iter),
            int(clamp), interior_mode, disk_lim, int(cycle), family,
            int(power), int(use_mxu), ctypes.c_void_p(work.data_ptr()),
            _lane_steps_ptr(lane_steps, dev), ctypes.c_void_p(stream))
    _check_rc(lib, rc, KERNEL_TILE)
    _count_launch(KERNEL_TILE_MXU if use_mxu else KERNEL_TILE)
    return out


def compute_tile_cuda(spec: TileSpec, max_iter: int, *, clamp: bool = False,
                      interior_check: bool = True,
                      cycle_check: bool | None = None,
                      device="cuda") -> np.ndarray:
    """K1, Mandelbrot: one tile -> flat uint8 numpy array, real-fastest."""
    return compute_tile_cuda_device(
        spec, max_iter, clamp=clamp, interior_check=interior_check,
        cycle_check=cycle_check, device=device).cpu().numpy().reshape(-1)


def compute_tile_julia_cuda(spec: TileSpec, c: complex, max_iter: int, *,
                            clamp: bool = False,
                            cycle_check: bool | None = None,
                            device="cuda") -> np.ndarray:
    """K1, Julia set of ``c``: one tile -> flat uint8 numpy array."""
    return compute_tile_cuda_device(
        spec, max_iter, clamp=clamp, cycle_check=cycle_check, julia_c=c,
        device=device).cpu().numpy().reshape(-1)


def compute_tile_family_cuda(spec: TileSpec, max_iter: int, *,
                             power: int = 2, burning: bool = False,
                             clamp: bool = False,
                             cycle_check: bool | None = None,
                             device="cuda") -> np.ndarray:
    """K1, Multibrot / Burning Ship: one tile -> flat uint8 numpy
    array."""
    return compute_tile_cuda_device(
        spec, max_iter, clamp=clamp, cycle_check=cycle_check, power=power,
        burning=burning, device=device).cpu().numpy().reshape(-1)


def compute_tiles_mega_cuda(specs, max_iters, *, clamp: bool = False,
                            interior_check: bool = True,
                            cycle_check: bool | None = None,
                            scout_segments: int | None = None,
                            power: int = 2, burning: bool = False,
                            julia_cs=None, use_mxu: bool | None = None,
                            rows=None, mrd_rows=None, device="cuda",
                            lane_steps: torch.Tensor | None = None):
    """K2: fuse k same-shaped tiles of one mode into one launch ->
    ``(tiles, census)`` on ``device``: (k, height, width) uint8 and
    (k, 1) int32.  Mandelbrot by default; the degree-``power``
    Multibrot, the Burning Ship (``burning``), or Julia sets with one
    constant per tile (``julia_cs``).  ``use_mxu=None`` resolves the
    ``DMTPU_MXU`` gate for ``device`` (:func:`mega_dispatch_plan`).
    ``rows``/``mrd_rows`` override the plan's params and budget rows
    (the same (k, 4|6) f32 and (k, 1) int32 arrays the reference's plan
    yields), so two implementations can be fed identical rows.
    ``lane_steps`` launches the instrumented form
    (:func:`compute_tile_row_cuda`)."""
    plan_rows, plan_mrds, kw = mega_dispatch_plan(
        specs, max_iters, clamp=clamp, interior_check=interior_check,
        cycle_check=cycle_check, scout_segments=scout_segments, power=power,
        burning=burning, julia_cs=julia_cs, use_mxu=use_mxu, device=device)
    k = len(specs)
    rows = np.ascontiguousarray(
        plan_rows if rows is None else rows, dtype=np.float32)
    mrds = np.ascontiguousarray(
        plan_mrds if mrd_rows is None else mrd_rows, dtype=np.int32)
    if rows.shape != plan_rows.shape or mrds.shape != (k, 1):
        raise ValueError(f"rows must be {plan_rows.shape} and mrd_rows "
                         f"({k}, 1), got {rows.shape} and {mrds.shape}")
    return launch_mega(rows, mrds, kw, device, lane_steps=lane_steps)


def _mega_counter(rows: np.ndarray, kw: dict) -> str:
    if kw["use_mxu"]:
        return KERNEL_MEGA_MXU
    if rows.shape[1] == 6:
        return KERNEL_MEGA_JULIA
    if kw["burning"]:
        return KERNEL_MEGA_SHIP
    return KERNEL_MEGA_MULTIBROT if kw["power"] > 2 else KERNEL_MEGA


def mega_launch_slices(k: int) -> list[tuple[int, int]]:
    """The ``[t0, t1)`` tile ranges of a k-tile fused batch's launches, in
    order: at most :data:`MEGA_MAX_TILES` tiles each."""
    return [(t0, min(k, t0 + MEGA_MAX_TILES))
            for t0 in range(0, k, MEGA_MAX_TILES)]


def launch_mega(rows: np.ndarray, mrds: np.ndarray, kw: dict, device, *,
                lane_steps: torch.Tensor | None = None):
    """K2 on a resolved plan: ``rows`` (k, 4|6) f32 and ``mrds`` (k, 1)
    int32 C-contiguous numpy arrays and the plan's launch keywords ->
    ``(tiles, census)`` on ``device``, enqueued on its current stream
    (the plain version on the CPU).  The mesh route launches each shard
    of one plan through here.

    A plan of more than :data:`MEGA_MAX_TILES` tiles (one launch's
    parameter block) runs as launches of at most that many
    (:func:`mega_launch_slices`), in order on the same stream, each with
    its own run counter and each writing its slice of the one output and
    census by pointer offset.  Every launch decision (probe, census
    window, matrix form) is the one plan's, so the pixels and the census
    equal one launch of the whole batch; each launch is counted."""
    k = rows.shape[0]
    dev = _cuda_device(device)
    if dev.type != "cuda":
        return escape_mega_plain(rows, mrds, device=dev, **kw)
    from distributedmandelbrot_tpu_torch.ops import _build
    lib = _build.load()
    h, w = kw["height"], kw["width"]
    julia = rows.shape[1] == 6
    family, interior_mode, disk_lim = _mode_args(
        kw["power"], kw["burning"], julia, kw["interior_check"])
    rows6, budgets = batch_rows(rows, mrds)
    with torch.cuda.device(dev):
        tiles = torch.empty((k, h, w), dtype=torch.uint8, device=dev)
        census = torch.zeros((k, 1), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for t0, t1 in mega_launch_slices(k):
            work = _work_counter(dev)
            rc = lib.dm_escape_mega(
                ctypes.c_void_p(tiles.data_ptr() + t0 * h * w),
                ctypes.c_void_p(census.data_ptr()
                                + t0 * census.element_size()),
                ctypes.c_void_p(rows6[t0:t1].ctypes.data),
                ctypes.c_void_p(budgets[t0:t1].ctypes.data), t1 - t0, h, w,
                int(julia), int(kw["clamp"]), interior_mode, disk_lim,
                int(kw["cycle_check"]), int(kw["scout_steps"]), family,
                int(kw["power"]), int(kw["use_mxu"]),
                ctypes.c_void_p(work.data_ptr()),
                _lane_steps_ptr(lane_steps, dev), ctypes.c_void_p(stream))
            _check_rc(lib, rc, KERNEL_MEGA)
            _count_launch(_mega_counter(rows, kw))
    return tiles, census


def compute_tile_smooth_cuda(spec: TileSpec, max_iter: int, *,
                             bailout: float = 256.0,
                             interior_check: bool = True,
                             cycle_check: bool | None = None,
                             julia_c: complex | None = None, power: int = 2,
                             burning: bool = False, device="cuda",
                             lane_steps: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """K4: one tile -> (height, width) f32 smooth values on ``device``
    (0 = in the set), every mode of K1; the launch is enqueued on the
    device's current stream (no sync).  ``lane_steps`` launches the
    instrumented form (:func:`compute_tile_row_cuda`)."""
    julia = julia_c is not None
    _check_dispatch_mode(power, burning, julia)
    _guard_budget(max_iter)
    if bailout < 2.0:
        raise ValueError(f"bailout must be >= 2 (the escape radius), got "
                         f"{bailout}")
    row = np.asarray(_params_row(spec, julia_c), dtype=np.float32)
    cycle = escape_time.resolve_cycle_check(cycle_check, max_iter)
    dev = _cuda_device(device)
    if dev.type != "cuda":
        return escape_smooth_plain(row, max_iter, spec.height, spec.width,
                                   bailout=bailout,
                                   interior_check=interior_check,
                                   cycle_check=cycle, power=power,
                                   burning=burning, device=dev)
    from distributedmandelbrot_tpu_torch.ops import _build
    lib = _build.load()
    family, interior_mode, disk_lim = _mode_args(power, burning, julia,
                                                 interior_check)
    row6 = _row6(row)
    # Each constant rounded once to f32, as the plain version's 0-d
    # tensors are.
    b2 = float(np.float32(bailout * bailout))
    two_ln_b = float(np.float32(2.0 * np.log(bailout)))
    log2_power = float(np.float32(np.log2(power))) if power != 2 else 0.0
    with torch.cuda.device(dev):
        out = torch.empty((spec.height, spec.width), dtype=torch.float32,
                          device=dev)
        work = _work_counter(dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dm_escape_smooth(
            ctypes.c_void_p(out.data_ptr()), spec.height, spec.width,
            ctypes.c_void_p(row6.ctypes.data), int(julia), int(max_iter),
            smooth_step_limit(max_iter, bailout), b2, two_ln_b, log2_power,
            interior_mode, disk_lim, int(cycle), family, int(power),
            ctypes.c_void_p(work.data_ptr()),
            _lane_steps_ptr(lane_steps, dev), ctypes.c_void_p(stream))
    _check_rc(lib, rc, KERNEL_SMOOTH)
    _count_launch(KERNEL_SMOOTH)
    return out


def compute_tiles_packed_cuda(specs, max_iters, *, clamp: bool = False,
                              interior_check: bool = True,
                              cycle_check: bool | None = None,
                              power: int = 2, burning: bool = False,
                              julia_cs=None, device="cuda",
                              lane_steps: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """K5: up to :data:`PACK_MAX` same-shaped tiles in one launch ->
    (n, height, width) uint8 on ``device``, each plane equal to K1 on
    that tile.  One family per pack; ``julia_cs`` gives a Julia constant
    per tile (all set) or is None.  The probe policy follows the deepest
    requested budget.  ``lane_steps`` launches the instrumented form
    (:func:`compute_tile_row_cuda`)."""
    n = len(specs)
    julia = julia_cs is not None
    _check_dispatch_mode(power, burning, julia)
    if not 1 <= n <= PACK_MAX:
        raise KernelUnsupported(f"pack of {n} tiles unsupported "
                                f"(1..{PACK_MAX})")
    if len(max_iters) != n:
        raise ValueError("specs and max_iters length mismatch")
    if julia and (len(julia_cs) != n or any(c is None for c in julia_cs)):
        raise ValueError("julia_cs must give a constant per tile")
    h, w = specs[0].height, specs[0].width
    for spec in specs:
        if (spec.height, spec.width) != (h, w):
            raise KernelUnsupported("packed tiles must share height/width")
    cap_req = max(int(m) for m in max_iters)
    _guard_budget(cap_req)
    rows = np.asarray([_params_row(spec, julia_cs[t] if julia else None)
                       for t, spec in enumerate(specs)], dtype=np.float32)
    mrds = np.asarray([int(m) for m in max_iters], dtype=np.int32)
    cycle = escape_time.resolve_cycle_check(cycle_check, cap_req)
    interior = interior_check and not julia
    dev = _cuda_device(device)
    if dev.type != "cuda":
        return escape_pack_plain(rows, mrds, height=h, width=w, clamp=clamp,
                                 interior_check=interior, cycle_check=cycle,
                                 power=power, burning=burning, device=dev)
    from distributedmandelbrot_tpu_torch.ops import _build
    lib = _build.load()
    family, interior_mode, disk_lim = _mode_args(power, burning, julia,
                                                 interior)
    rows6 = np.ascontiguousarray(np.stack([_row6(r) for r in rows]))
    with torch.cuda.device(dev):
        out = torch.empty((n, h, w), dtype=torch.uint8, device=dev)
        work = _work_counter(dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dm_escape_pack(
            ctypes.c_void_p(out.data_ptr()), n, h, w,
            ctypes.c_void_p(rows6.ctypes.data),
            ctypes.c_void_p(mrds.ctypes.data), int(julia), int(clamp),
            interior_mode, disk_lim, int(cycle), family, int(power),
            ctypes.c_void_p(work.data_ptr()),
            _lane_steps_ptr(lane_steps, dev), ctypes.c_void_p(stream))
    _check_rc(lib, rc, KERNEL_PACK)
    _count_launch(KERNEL_PACK)
    return out


def batch_rows(rows, mrd_rows) -> tuple[np.ndarray, np.ndarray]:
    """A batch's params rows as (k, 6) f32 (the Julia slots zero for
    4-wide rows) and its budgets as (k,) int32, both C-contiguous."""
    rows = np.asarray(rows, dtype=np.float32)
    rows6 = np.zeros((rows.shape[0], 6), dtype=np.float32)
    rows6[:, :rows.shape[1]] = rows
    return rows6, np.ascontiguousarray(
        np.asarray(mrd_rows, dtype=np.int32).reshape(-1))


def device_rows(rows, mrd_rows, dev: torch.device):
    """:func:`batch_rows` uploaded to ``dev`` on its current stream: the
    kernels that take a whole shard read them from device memory."""
    rows6, mrds = batch_rows(rows, mrd_rows)
    return (torch.from_numpy(rows6).to(dev), torch.from_numpy(mrds).to(dev))


def epilogue_multipliers(mrds) -> np.ndarray:
    """Each budget's epilogue multiplier as K3 reads it from device
    memory: floor((2^64 - 1) / max(mrd, 2)) + 1, the kernels' ``fast_div``
    (a budget of 1 or less never reaches the epilogue), as uint64."""
    d = np.maximum(np.asarray(mrds, dtype=np.int64).reshape(-1),
                   2).astype(np.uint64)
    return np.uint64(np.iinfo(np.uint64).max) // d + np.uint64(1)


def compute_tiles_batch_cuda(rows, mrd_rows, *, height: int, width: int,
                             clamp: bool = False, interior_check: bool = True,
                             cycle_check: bool | None = None, power: int = 2,
                             burning: bool = False, device="cuda",
                             lane_steps: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """K3: k same-shaped tiles from their params rows ((k, 4) f32, or
    (k, 6) with Julia constants) and budgets ((k,) or (k, 1) int32) in
    one launch -> (k, height, width) uint8 on ``device``, enqueued on
    its current stream; each plane equals K1 on its row.  The rows,
    budgets and epilogue multipliers travel to the card as tensors, so k
    has no limit (a mesh shard's size).  The probe policy follows the
    deepest budget.  ``lane_steps`` launches the instrumented form
    (:func:`compute_tile_row_cuda`)."""
    rows = np.asarray(rows, dtype=np.float32)
    if rows.ndim != 2 or rows.shape[1] not in (4, 6):
        raise ValueError(f"rows must be (k, 4) or (k, 6), got {rows.shape}")
    k = rows.shape[0]
    julia = rows.shape[1] == 6
    _check_dispatch_mode(power, burning, julia)
    mrds = np.asarray(mrd_rows, dtype=np.int32).reshape(-1)
    if mrds.shape != (k,):
        raise ValueError(f"{k} rows but {mrds.size} budgets")
    cap = int(mrds.max()) if k else 1
    _guard_budget(cap)
    cycle = escape_time.resolve_cycle_check(cycle_check, cap)
    dev = _cuda_device(device)
    if k == 0:
        return torch.zeros((0, height, width), dtype=torch.uint8, device=dev)
    if dev.type != "cuda":
        return escape_batch_plain(rows, mrds, height=height, width=width,
                                  clamp=clamp, interior_check=interior_check,
                                  cycle_check=cycle, power=power,
                                  burning=burning, device=dev)
    from distributedmandelbrot_tpu_torch.ops import _build
    lib = _build.load()
    family, interior_mode, disk_lim = _mode_args(power, burning, julia,
                                                 interior_check)
    divs = torch.from_numpy(epilogue_multipliers(mrds).view(np.int64))
    with torch.cuda.device(dev):
        rows_d, mrds_d = device_rows(rows, mrds, dev)
        divs_d = divs.to(dev)
        out = torch.empty((k, height, width), dtype=torch.uint8, device=dev)
        work = _work_counter(dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dm_escape_batch(
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(rows_d.data_ptr()),
            ctypes.c_void_p(mrds_d.data_ptr()),
            ctypes.c_void_p(divs_d.data_ptr()), k, height, width,
            int(julia), int(clamp), interior_mode, disk_lim, int(cycle),
            family, int(power), ctypes.c_void_p(work.data_ptr()),
            _lane_steps_ptr(lane_steps, dev), ctypes.c_void_p(stream))
    _check_rc(lib, rc, KERNEL_BATCH)
    _count_launch(KERNEL_BATCH)
    return out
