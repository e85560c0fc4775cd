"""The compacted two-phase escape pipeline: the port of the JAX package's
``ops/compact_escape.py``, opt-in with ``DMTPU_COMPACT=1`` as there.

Per-pixel exit already keeps a retired pixel from iterating, but a warp
runs until its slowest lane retires: on a boundary view most of a
deep-budget warp's lanes sit idle behind a few stragglers.  The pipeline
gathers the stragglers of a whole batch into dense lanes:

1. **Phase 1** (K6, ``escape_state``; replaces ``_state_batch_kernel``):
   K3's pixel, capped at ``phase_budget`` steps, writes the raw state
   ``(c, z, n, act)`` instead of bytes.  ``act`` is 1 for a pixel still
   live with budget left.
2. **Resume** (K7, ``escape_resume``; replaces ``_resume_block_kernel``):
   one launch over the indices of the live lanes (``torch.nonzero`` of
   ``act``) runs each lane from step ``phase_budget + 1`` to its own
   budget, with its own c, reading and writing its state where it lies
   in K6's planes.  The reference packs the survivors into a buffer of
   the compact capacity, resumes them in rounds of ``RESUME_SEG`` steps
   re-compacted between rounds, and resumes the lanes past capacity in
   place: a TPU lane cannot leave its block early.  K7 runs one thread a
   lane with per-thread exit, and the live lanes of a warp are
   neighbours whose orbits run alike, so the list needs no buffer, no
   capacity and no shrinking between rounds.
3. **Epilogue**: the uint8 bytes from the counts, per lane.

The glue (nonzero, epilogue) is torch on the batch's device: the
reference did it in XLA, outside any Pallas kernel.  The live count is
read on the host once, after phase 1 (``torch.nonzero``).

**Identity.**  K6 then K7 equal K3 bitwise, and K7 in rounds of any
length equals K7 in one: a resumed lane recomputes its squares from z
with the same correctly rounded multiply that cached them and continues
the same step sequence, and per-pixel exit makes every seam exact.
The reference's TPU-layout guards (unroll-aligned phases, a 128-lane
width, block-divisible extents) have no counterpart here.

On the CPU the same glue runs K6's and K7's plain versions
(:func:`escape_state_plain`, :func:`escape_resume_plain`).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from distributedmandelbrot_tpu_torch.ops import cuda_escape as ce
from distributedmandelbrot_tpu_torch.ops import escape_time

# Steps the whole grid runs before the survivors compact (the
# reference's PHASE1_BUDGET).
PHASE1_BUDGET = 256

# The reference's policy constants, held equal to its own by the tests:
# steps per resume round (RESUME_SEG), and the compact buffer's capacity
# as a fraction of the batch's pixels (the denominator), aligned up to
# its (32, 128) block grid.  The port's pipeline has no buffer and runs
# no rounds.
RESUME_SEG = 256
COMPACT_CAPACITY_FRAC = 4

# The reference's compact-buffer geometry, kept as numbers: they size
# the capacity granule and the policy's pixel floor.
_LANE = 128
_RESUME_BLOCK_H = 32

# Steps between compactions of the plain versions' working set.
_PLAIN_COMPACT_EVERY = 16


def compact_capacity(n_pixels: int) -> int:
    """The reference's compact-buffer capacity for a batch: ``n_pixels /
    4``, aligned up to a whole (32, 128) block grid."""
    granule = _RESUME_BLOCK_H * _LANE
    want = max(granule, n_pixels // COMPACT_CAPACITY_FRAC)
    return -(-want // granule) * granule


def compaction_opted_in() -> bool:
    """``DMTPU_COMPACT=1``, read at each call (the reference reads it
    once, at import)."""
    return bool(int(os.environ.get("DMTPU_COMPACT", "0") or "0"))


def prefer_compaction(budget: int, n_pixels: int) -> bool:
    """The reference's dispatch policy: opted in, a budget deep enough
    that phase 1 strands a straggler tail (>= 2x the phase-1 budget) but
    below the cycle-probe class (the resume kernel carries no probe),
    and a batch of at least 64 reference blocks of pixels."""
    return (compaction_opted_in()
            and 2 * PHASE1_BUDGET <= budget - 1
            and budget < escape_time.CYCLE_CHECK_MIN_ITER
            and n_pixels >= 64 * _RESUME_BLOCK_H * _LANE)


# --- plain PyTorch versions ----------------------------------------------


def _advance(zr, zi, cr, ci, n, dyn, live, first: int, last: int, *,
             power: int, burning: bool) -> None:
    """Steps ``first .. min(last, dyn)`` of the live lanes of flat state
    tensors, in place, the probe off: per step K1's update, the radius-2
    test, and ``n`` counting the survivors.  A lane that leaves the disk
    keeps its z and clears ``live``; a lane whose budget ends stays
    live."""
    idx = torch.nonzero(live & (dyn >= first)).squeeze(1)
    wzr, wzi, wcr, wci = zr[idx], zi[idx], cr[idx], ci[idx]
    wn, wdyn = n[idx], dyn[idx]
    wzr2, wzi2 = wzr * wzr, wzi * wzi
    run = torch.ones(idx.shape, dtype=torch.bool, device=zr.device)
    out = torch.zeros_like(run)
    four = torch.tensor(4.0, dtype=zr.dtype, device=zr.device)

    def flush():
        zr[idx], zi[idx], n[idx] = wzr, wzi, wn
        live[idx] = ~out

    for s in range(first, last + 1):
        if idx.numel() == 0:
            break
        run &= wdyn >= s
        if power == 2:
            cross = (wzr + wzr) * wzi
            if burning:
                cross = cross.abs()
            nzi = cross + wci
            nzr = (wzr2 - wzi2) + wcr
        else:
            nzr, nzi = escape_time.family_step(wzr, wzi, wcr, wci,
                                               power=power, burning=False)
        wzr = torch.where(run, nzr, wzr)
        wzi = torch.where(run, nzi, wzi)
        wzr2, wzi2 = wzr * wzr, wzi * wzi
        left = run & ~(wzr2 + wzi2 < four)
        out |= left
        run &= ~left
        wn += run
        if (s - first + 1) % _PLAIN_COMPACT_EVERY == 0:
            flush()
            keep = torch.nonzero(run).squeeze(1)
            idx, run, out = idx[keep], run[keep], out[keep]
            wzr, wzi, wzr2, wzi2 = wzr[keep], wzi[keep], wzr2[keep], wzi2[keep]
            wcr, wci, wn, wdyn = wcr[keep], wci[keep], wn[keep], wdyn[keep]
    flush()


def escape_state_plain(rows, mrd_rows, *, height: int, width: int,
                       phase_budget: int = PHASE1_BUDGET,
                       interior_check: bool = True, power: int = 2,
                       burning: bool = False, device="cpu"):
    """K6's plain version: the six (k, height, width) state planes
    ``(c_re, c_im, z_re, z_im, n, act)`` (f32, f32, f32, f32, int32,
    int32) of a batch of params rows (4 wide, or 6 with Julia
    constants) after at most ``min(dyn, phase_budget)`` steps."""
    rows6, mrds = ce.batch_rows(rows, mrd_rows)
    julia = np.asarray(rows).shape[1] == 6
    k = rows6.shape[0]
    planes = [ce._kernel_orbit_inputs(r if julia else r[:4], height, width,
                                      device)[:4] for r in rows6]
    zr, zi, cr, ci = (torch.stack([p[i] for p in planes]).reshape(-1)
                      .contiguous() for i in range(4))
    dyn = torch.from_numpy(mrds - 1).to(device).repeat_interleave(
        height * width)
    n = torch.zeros(dyn.shape, dtype=torch.int32, device=device)
    live = dyn > 0
    if interior_check and not julia:
        inside = escape_time.family_interior(cr, ci, power, burning)
        if inside is not None:
            inside &= live
            n = torch.where(inside, dyn, n)
            live &= ~inside
    zr, zi = zr.clone(), zi.clone()
    _advance(zr, zi, cr, ci, n, dyn, live, 1, phase_budget, power=power,
             burning=burning)
    act = (live & (dyn > phase_budget)).to(torch.int32)
    shape = (k, height, width)
    return tuple(t.reshape(shape) for t in (cr, ci, zr, zi, n, act))


def escape_resume_plain(it0: int, seg: int, dyn, cr, ci, zr, zi, n, act, *,
                        idx: torch.Tensor | None = None, power: int = 2,
                        burning: bool = False):
    """K7's plain version: one resume round -> new ``(z_re, z_im, n,
    act)``: each live lane runs steps ``it0 .. min(it0 + seg - 1, dyn)``,
    and keeps ``act`` = 1 only if still live with budget left.  The lanes
    are the flat tensors' elements, or with ``idx`` (unique indices) the
    elements it lists; the others are returned as they were."""
    if idx is not None:
        sel = idx.to(torch.int64)
        round_ = escape_resume_plain(
            it0, seg, dyn[sel], cr[sel], ci[sel], zr[sel], zi[sel], n[sel],
            act[sel], power=power, burning=burning)
        out = [t.clone() for t in (zr, zi, n, act)]
        for t, v in zip(out, round_):
            t[sel] = v
        return tuple(out)
    zr, zi, n = zr.clone(), zi.clone(), n.clone()
    live = act != 0
    _advance(zr, zi, cr, ci, n, dyn, live, it0, it0 + seg - 1, power=power,
             burning=burning)
    act = (live & (dyn > it0 + seg - 1)).to(torch.int32)
    return zr, zi, n, act


# --- wrappers ------------------------------------------------------------


def escape_state_cuda(rows, mrd_rows, *, height: int, width: int,
                      phase_budget: int = PHASE1_BUDGET,
                      interior_check: bool = True, power: int = 2,
                      burning: bool = False, device="cuda",
                      lane_steps: torch.Tensor | None = None):
    """K6: the six state planes of :func:`escape_state_plain`, on
    ``device``, enqueued on its current stream (the plain version on the
    CPU).  ``lane_steps`` launches the instrumented form, which adds the
    lane steps its warps issue (32 per step of a warp's slowest lane)."""
    rows = np.asarray(rows, dtype=np.float32)
    julia = rows.shape[1] == 6
    ce._check_dispatch_mode(power, burning, julia)
    dev = ce._cuda_device(device)
    if dev.type != "cuda":
        return escape_state_plain(rows, mrd_rows, height=height, width=width,
                                  phase_budget=phase_budget,
                                  interior_check=interior_check, power=power,
                                  burning=burning, device=dev)
    from distributedmandelbrot_tpu_torch.ops import _build
    lib = _build.load()
    family, interior_mode, disk_lim = ce._mode_args(power, burning, julia,
                                                    interior_check)
    k = rows.shape[0]
    shape = (k, height, width)
    with torch.cuda.device(dev):
        rows_d, mrds_d = ce.device_rows(rows, mrd_rows, dev)
        planes = [torch.empty(shape, dtype=torch.float32, device=dev)
                  for _ in range(4)]
        planes += [torch.empty(shape, dtype=torch.int32, device=dev)
                   for _ in range(2)]
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dm_escape_state(
            *(ctypes.c_void_p(p.data_ptr()) for p in planes),
            ctypes.c_void_p(rows_d.data_ptr()),
            ctypes.c_void_p(mrds_d.data_ptr()), k, height, width, int(julia),
            interior_mode, disk_lim, family, int(power), int(phase_budget),
            ce._lane_steps_ptr(lane_steps, dev), ctypes.c_void_p(stream))
    ce._check_rc(lib, rc, ce.KERNEL_STATE)
    ce._count_launch(ce.KERNEL_STATE)
    return tuple(planes)


def escape_resume_cuda(it0: int, seg: int, dyn, cr, ci, zr, zi, n, act, *,
                       idx: torch.Tensor | None = None, power: int = 2,
                       burning: bool = False,
                       lane_steps: torch.Tensor | None = None):
    """K7: one resume round over flat lane tensors (f32 ``cr, ci, zr,
    zi``; int32 ``dyn, n, act``, all on one device) -> ``(zr, zi, n,
    act)``.  ``idx`` (int64 or int32, unique) lists the lanes by their
    place in those tensors, which are read and written there; without
    it every element is a lane.  On the card the kernel updates the four
    in place (the compacted pipeline owns them) on the device's current
    stream; on the CPU the plain version returns new tensors.
    ``lane_steps`` launches the instrumented form, which adds the lane
    steps its warps issue."""
    dev = zr.device
    if dev.type != "cuda":
        return escape_resume_plain(it0, seg, dyn, cr, ci, zr, zi, n, act,
                                   idx=idx, power=power, burning=burning)
    for t, dt in ((zr, torch.float32), (zi, torch.float32),
                  (cr, torch.float32), (ci, torch.float32),
                  (n, torch.int32), (act, torch.int32), (dyn, torch.int32)):
        if (t.dtype != dt or t.device != dev or not t.is_contiguous()
                or t.numel() != zr.numel()):
            raise ValueError("resume lanes must be contiguous, equal-length "
                             "f32 (c, z) and int32 (n, act, dyn) tensors on "
                             "one device")
    if idx is not None and (idx.dtype not in (torch.int64, torch.int32)
                            or idx.device != dev or idx.dim() != 1
                            or not idx.is_contiguous()):
        raise ValueError("idx must be a contiguous 1-D int64 or int32 tensor "
                         "on the lanes' device")
    lanes = zr.numel() if idx is None else idx.numel()
    if lanes == 0:
        return zr, zi, n, act
    from distributedmandelbrot_tpu_torch.ops import _build
    lib = _build.load()
    family = ce._mode_args(power, burning, False, False)[0]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dm_escape_resume(
            *(ctypes.c_void_p(t.data_ptr()) for t in (zr, zi, n, act, cr, ci,
                                                       dyn)),
            ctypes.c_void_p(None if idx is None else idx.data_ptr()),
            0 if idx is None else idx.element_size(), lanes, int(it0),
            int(seg), family, int(power),
            ce._lane_steps_ptr(lane_steps, dev), ctypes.c_void_p(stream))
    ce._check_rc(lib, rc, ce.KERNEL_RESUME)
    ce._count_launch(ce.KERNEL_RESUME)
    return zr, zi, n, act


# --- the pipeline --------------------------------------------------------


def compact_escape_batch(rows, mrd_rows, *, k: int, height: int, width: int,
                         max_iter: int, clamp: bool = False,
                         interior_check: bool = True,
                         cycle_check: bool | None = None, power: int = 2,
                         burning: bool = False,
                         phase_budget: int = PHASE1_BUDGET,
                         device="cuda") -> torch.Tensor:
    """k tiles (params rows (k, 4|6) f32, budgets (k,) int) -> (k,
    height, width) uint8 on ``device`` through the compacted pipeline,
    bitwise equal to K3 on the same rows.  ``max_iter`` is the batch's
    deepest budget.  After K6, one K7 launch over the live lanes'
    indices runs them to their budgets.

    Callers gate on :func:`prefer_compaction`.  The reference's policy
    declines raise :class:`~.cuda_escape.KernelUnsupported`: a
    probe-class budget (the resume kernel carries no probe) and a budget
    that completes inside phase 1."""
    if escape_time.resolve_cycle_check(cycle_check, max_iter):
        raise ce.KernelUnsupported(
            "compacted dispatch does not carry the cycle probe; use the "
            "plain kernel for probe-class budgets")
    if max_iter - 1 <= phase_budget:
        raise ce.KernelUnsupported(
            f"budget {max_iter} completes inside phase 1 ({phase_budget}); "
            "use the plain kernel")
    ce._guard_budget(max_iter)
    rows = np.asarray(rows, dtype=np.float32)
    if rows.shape[0] != k:
        raise ValueError(f"k={k} but {rows.shape[0]} params rows")
    dev = ce._cuda_device(device)
    total = max_iter - 1
    cr, ci, zr, zi, n, act = (t.reshape(-1) for t in escape_state_cuda(
        rows, mrd_rows, height=height, width=width,
        phase_budget=phase_budget, interior_check=interior_check,
        power=power, burning=burning, device=dev))
    mrds = ce.batch_rows(rows, mrd_rows)[1]
    dyn = torch.from_numpy(mrds - 1).to(dev).repeat_interleave(
        height * width)
    # The live lanes' indices (the one host read: their count), then K7
    # over them, each lane read and written where it lies, run from
    # phase 1 to its budget.
    zr, zi, n, act = escape_resume_cuda(
        phase_budget + 1, total - phase_budget, dyn, cr, ci, zr, zi, n, act,
        idx=torch.nonzero(act).squeeze(1), power=power, burning=burning)
    counts = torch.where(n >= dyn, 0, n + 1)
    mrd = dyn + 1
    vals = (counts * 256 + (mrd - 1)) // mrd
    if clamp:
        vals = torch.clamp(vals, max=255)
    return (vals & 255).to(torch.uint8).reshape(k, height, width)
