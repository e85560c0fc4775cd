"""Trajectory predictor: extrapolate pan/zoom velocity in (level, i, j).

Pure and deterministic — no clocks, no randomness — so the virtual-time
session tests pin exact predictions.

The extrapolation is *step-scaled*: velocities are estimated per mean
inter-arrival gap of the observation window, and predictions are emitted
at 1..horizon such steps ahead.  That makes the output depend on the
direction and per-step magnitude of motion, not on the absolute clock
rate, so a storm replayed under the loadgen virtual timebase (where
consecutive queries land microseconds apart in wall time) predicts the
same tiles a human panning once a second would get.

Pan is extrapolated in fractional viewport coordinates — the tile-center
fraction ``(i + 0.5) / level`` — so a simultaneous zoom rescales the pan
component onto the target grid instead of carrying level-``n`` indices
onto a level-``m`` grid.  Zoom is a per-step level delta, rounded.  The
caller range-checks the emitted keys (``query_in_range``); this module
just does the math.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence

from distributedmandelbrot_tpu_torch.sessions.table import Key, ViewportObs


def predict_tiles(trajectory: Sequence[ViewportObs], *,
                  horizon: int = 3) -> list[Key]:
    """Predicted next tile keys, nearest first.

    Returns ``[]`` without a usable fix: fewer than two observations, a
    non-advancing clock, or a stationary viewport (every prediction
    collapses onto the current tile).
    """
    if len(trajectory) < 2 or horizon <= 0:
        return []
    first, last = trajectory[0], trajectory[-1]
    steps = len(trajectory) - 1
    if last.t <= first.t:
        return []
    # Per-step velocities over the window endpoints: level delta (zoom)
    # and tile-center fraction delta (pan).
    d_level = (last.level - first.level) / steps
    fx_first = (first.index_real + 0.5) / first.level
    fy_first = (first.index_imag + 0.5) / first.level
    fx_last = (last.index_real + 0.5) / last.level
    fy_last = (last.index_imag + 0.5) / last.level
    d_fx = (fx_last - fx_first) / steps
    d_fy = (fy_last - fy_first) / steps
    predicted: list[Key] = []
    seen = {last.key}
    for k in range(1, horizon + 1):
        level = int(round(last.level + d_level * k))
        if level < 1:
            continue
        index_real = math.floor((fx_last + d_fx * k) * level)
        index_imag = math.floor((fy_last + d_fy * k) * level)
        key = (level, index_real, index_imag)
        if key in seen:
            continue
        seen.add(key)
        predicted.append(key)
    return predicted


class TrajectoryPredictor:
    """Configured wrapper around :func:`predict_tiles`."""

    def __init__(self, *, horizon: int = 3) -> None:
        self.horizon = horizon

    def predict(self, trajectory: Iterable[ViewportObs]) -> list[Key]:
        return predict_tiles(tuple(trajectory), horizon=self.horizon)
