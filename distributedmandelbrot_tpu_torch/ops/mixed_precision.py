"""The sanctioned gateway for half-precision arithmetic: the port of the
JAX package's ``ops/mixed_precision.py``.

The parity-guard contract every caller keeps: half precision may only
ever feed *advisory* products — the bf16 scout census of the fused
kernel (``cuda_escape.scout_census_plain``, ``dm::scout_escapes``) and
the MXU-form panel census (``mxu_iteration.mxu_census_counts``) — never
the iteration state or anything derived into tile output.  The f32
recurrence always runs from z0 and alone decides escape counts, so
census-on and census-off are bit-identical by construction.  A bf16
orbit diverges from the f32 orbit within a few steps on boundary pixels,
so no margin can hand a *count* across the precision boundary, only a
prediction.
"""

from __future__ import annotations

import torch

# The scouting dtype: bf16 keeps f32's exponent range, so an escape-radius
# test never overflows out of range, only out of precision.
SCOUT_DTYPE = torch.bfloat16


def scout_cast(x: torch.Tensor) -> torch.Tensor:
    """Demote an f32 operand into the scouting precision (advisory lanes
    only)."""
    return x.to(SCOUT_DTYPE)


def scout_const(value: float, device=None) -> torch.Tensor:
    """A scalar constant in the scouting precision (e.g. the escape
    radius squared) on ``device``."""
    return torch.tensor(value, dtype=SCOUT_DTYPE, device=device)
