"""Peaks of the card and the least time an escape-time chunk could take.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W): 67 TFLOP/s in float32 outside the tensor cores, which
counts a fused multiply-add as two operations, and 3.35 TB/s of HBM.  The
escape loop issues no fused multiply-add (its bytes are defined by
separately rounded operations), so its operations run at most at one
per instruction: half of the published rate.
"""

from __future__ import annotations

F32_OPS_PER_S = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12

# float32 operations per escape step: three multiplies (the cross term
# and the two squares) and five additions (zr + zr, + ci, zr2 - zi2,
# + cr, |z|^2).
OPS_PER_STEP = 8
CHUNK_BYTES = 4096 * 4096


def chunk_bound_s(steps: int, out_bytes: int = CHUNK_BYTES) -> float:
    """The larger of the chunk's operations over the float32 rate and
    its output bytes (each written once) over the memory rate."""
    return max(steps * OPS_PER_STEP / F32_OPS_PER_S,
               out_bytes / HBM_BYTES_PER_S)
