"""K10's share of its roofline: the least time the card could take for
the smooth delta scans of the window's views over the device time of
K10 (``perturb_smooth_kernel``) in the window's trace.

The least time is the operations over the float64 rate: the steps the
lanes needed (the program's count ``deep.lane_steps``: each lane to its
bailout crossing or the orbit's end, summed over every K10 scan of the
window's views, the secondary references' included) times 20 float64
operations a step, at 17 T op/s.  K10 writes about 27 bytes a pixel once,
so at 50,000 steps the operations bound it.  Nothing where the program
keeps no such count, or the trace holds no K10 launch."""

# A Mandelbrot lane-step of K10, as ops/csrc/perturb.cuh counts it: the
# tested value Z + dz, its squared modulus and the two tests, and the
# delta's update 2 Z dz + dz^2 + dc (the orbit's own terms come from a
# table computed once an entry).
OPS_PER_STEP = 20
# One H100 SXM's float64 rate outside the tensor cores, at 700 W: its
# published 34 TFLOP/s counts a fused multiply-add as two; K10 issues
# none.
F64_OPS_PER_S = 34e12 / 2
KEY = "deep.lane_steps"


def read(rec):
    if rec.kind != "views" or rec.trace is None or not rec.done:
        return None
    try:
        from distributedmandelbrot_tpu_torch.obs import phases
    except ImportError:
        return None
    steps = phases.phase_seconds().get(KEY)
    busy = rec.trace.device_seconds(lambda name:
                                    "perturb_smooth_kernel" in name)
    if steps is None or not busy:
        return None
    return 100.0 * steps * OPS_PER_STEP / F64_OPS_PER_S / busy
