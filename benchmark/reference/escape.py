"""Plain reference for the canonical farm's chunks, in PyTorch.

It imports nothing of the program.  The pixel contract is the upstream
worker's (``DistributedMandelbrotWorkerCUDA.py``) as the port serves it:

- the rendered square is [-2, 2] x [-2, 2]; a level ``l`` tiles it into
  l x l chunks of 4096 x 4096 pixels, chunk (i, j) starting at
  ``-2 + (4 / l) * i`` (real) and ``-2 + (4 / l) * j`` (imaginary), the
  pitch ``(4 / l) / 4095`` on both axes (inclusive end points);
- the coordinates of pixel (row, col) are ``start + index * pitch`` in
  float32, from the float32 start and pitch (two roundings: the product,
  then the sum);
- z starts at c; each step updates ``cross = (zr + zr) * zi;
  zi = cross + ci; zr = (zr * zr - zi * zi) + cr`` with the squares of
  the previous step, every operation rounded alone (no fused
  multiply-add), then tests ``zr * zr + zi * zi < 4``; steps run
  1 .. max_iter - 1;
- a pixel escaping at step ``e`` has the count ``e``; one that never
  escapes, 0; the byte is ``ceil(count * 256 / max_iter)``, wrapped to
  eight bits;
- pixels inside the main cardioid or the period-2 bulb by the closed
  form, strict by a margin of 1e-5, never escape and are 0 without a step.

The loop drops retired pixels from its working set every 16 steps, and
with budgets of 1024 or more stops a pixel whose z repeats a snapshot
exactly (a cycle in float32 never escapes).  Both change the work and
never the bytes.  ``steps`` counts the steps each pixel needs under
that rule: the work the inputs need, which the roofline of the escape
kernels counts.
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK_WIDTH = 4096
INTERIOR_MARGIN = 1e-5
CYCLE_CHECK_MIN_ITER = 1024
CYCLE_STRIDE = 8
COMPACT_EVERY = 16


def chunk_row(level: int, index_real: int, index_imag: int,
              width: int = CHUNK_WIDTH) -> np.ndarray:
    """(start real, start imag, pitch real, pitch imag) of a chunk in
    float64, rounded once to float32."""
    span = (2.0 - -2.0) / level
    return np.asarray([-2.0 + span * index_real, -2.0 + span * index_imag,
                       span / (width - 1), span / (width - 1)],
                      dtype=np.float32)


def _interior(cr: torch.Tensor, ci: torch.Tensor) -> torch.Tensor:
    """Main cardioid or period-2 bulb, strict by the margin, every
    operation in the grid's dtype."""
    def const(v):
        return torch.tensor(v, dtype=cr.dtype, device=cr.device)
    quarter = const(0.25)
    y2 = ci * ci
    xm = cr - quarter
    q = xm * xm + y2
    cardioid = q * (q + xm) < quarter * y2 - const(INTERIOR_MARGIN)
    xp = cr + const(1.0)
    bulb = xp * xp + y2 < const(0.0625) - const(INTERIOR_MARGIN)
    return cardioid | bulb


def escape_counts(level: int, max_iter: int, index_real: int,
                  index_imag: int, *, device, dtype=torch.float32,
                  width: int = CHUNK_WIDTH, want_steps: bool = False):
    """(counts int32 (width, width), steps int64 or None) of one chunk,
    computed in ``dtype`` on ``device``."""
    row = torch.as_tensor(chunk_row(level, index_real, index_imag, width),
                          device=device).to(dtype)
    idx = torch.arange(width, device=device).to(dtype)
    g_real = (row[0] + idx * row[2])[None, :].expand(width, width)
    g_imag = (row[1] + idx * row[3])[:, None].expand(width, width)
    total = max_iter - 1
    n_out = torch.full((width * width,), total, dtype=torch.int32,
                       device=device)
    steps_out = (torch.zeros(width * width, dtype=torch.int64,
                             device=device) if want_steps else None)
    if total <= 0:
        counts = torch.zeros((width, width), dtype=torch.int32,
                             device=device)
        return counts, steps_out
    live = torch.nonzero(~_interior(g_real, g_imag).reshape(-1)).squeeze(1)
    cr = g_real.reshape(-1)[live]
    ci = g_imag.reshape(-1)[live]
    zr, zi = cr.clone(), ci.clone()
    zr2, zi2 = zr * zr, zi * zi
    four = torch.tensor(4.0, dtype=dtype, device=device)
    cycle = max_iter >= CYCLE_CHECK_MIN_ITER
    szr, szi = zr.clone(), zi.clone()
    act = torch.ones(live.shape, dtype=torch.bool, device=device)
    n = torch.zeros(live.shape, dtype=torch.int32, device=device)
    left_at = torch.full(live.shape, total, dtype=torch.int64,
                         device=device)
    for step in range(1, total + 1):
        if live.numel() == 0:
            break
        cross = (zr + zr) * zi
        zi = cross + ci
        zr = (zr2 - zi2) + cr
        zr2 = zr * zr
        zi2 = zi * zi
        was = act
        act = act & ((zr2 + zi2) < four)
        if cycle and step % CYCLE_STRIDE == 0:
            cyc = act & (zr == szr) & (zi == szi)
            act = act & ~cyc
            n = torch.where(cyc, total, n)
        n = n + act.to(torch.int32)
        left_at = torch.where(was & ~act, step, left_at)
        if cycle and step >= 2 and step & (step - 1) == 0:
            szr, szi = zr.clone(), zi.clone()
        if step % COMPACT_EVERY == 0 or step == total:
            n_out[live] = n
            if want_steps:
                steps_out[live] = left_at
            keep = torch.nonzero(act).squeeze(1)
            live, act, n, left_at = (live[keep], act[keep], n[keep],
                                     left_at[keep])
            zr, zi, zr2, zi2 = zr[keep], zi[keep], zr2[keep], zi2[keep]
            cr, ci, szr, szi = cr[keep], ci[keep], szr[keep], szi[keep]
    if live.numel():
        n_out[live] = n
        if want_steps:
            steps_out[live] = left_at
    counts = torch.where(n_out >= total, 0, n_out + 1).to(torch.int32)
    return counts.reshape(width, width), steps_out


def chunk_bytes(level: int, max_iter: int, index_real: int,
                index_imag: int, *, device, dtype=torch.float32,
                width: int = CHUNK_WIDTH) -> np.ndarray:
    """The chunk's flat uint8 pixels (row = imaginary index), on the
    host."""
    counts, _ = escape_counts(level, max_iter, index_real, index_imag,
                              device=device, dtype=dtype, width=width)
    vals = (counts.to(torch.int64) * 256 + (max_iter - 1)) // max_iter
    return (vals & 255).to(torch.uint8).reshape(-1).cpu().numpy()


def chunk_steps(level: int, max_iter: int, index_real: int,
                index_imag: int, *, device,
                width: int = CHUNK_WIDTH) -> int:
    """Steps the chunk's pixels need, summed (interior pixels none)."""
    _, steps = escape_counts(level, max_iter, index_real, index_imag,
                             device=device, width=width, want_steps=True)
    return int(steps.sum())
