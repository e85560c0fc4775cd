"""Live interactive sessions: viewport tracking, predictive prefetch,
progressive refinement, per-session fairness.

The stateful layer behind the gateway's ``GATEWAY_SESSION_MAGIC``
framing.  :class:`SessionTable` issues ids and tracks each session's
viewport trajectory; :class:`TrajectoryPredictor` extrapolates pan/zoom
velocity in ``(level, i, j)`` space; :class:`PrefetchPlanner` warms the
cache tiers (or queues compute-on-read) for the predicted tiles before
the user asks; :class:`RefinementTracker` schedules the full-depth
workload behind a cheap low-``max_iter`` first paint; and
:class:`SessionService` is the facade the gateway drives.

The package depends on :mod:`~distributedmandelbrot_tpu_torch.serve` (caches,
token bucket) and optionally a coordinator scheduler — never the other
way round: the gateway takes its ``SessionService`` duck-typed, so a
read-only replica (loadgen's ``GatewayFleet``) runs sessions with
prefetch-by-cache-warming and no farm at all.
"""

from distributedmandelbrot_tpu_torch.sessions.predict import (TrajectoryPredictor,
                                                        predict_tiles)
from distributedmandelbrot_tpu_torch.sessions.prefetch import PrefetchPlanner
from distributedmandelbrot_tpu_torch.sessions.refine import RefinementTracker
from distributedmandelbrot_tpu_torch.sessions.service import (SessionService,
                                                        build_session_service)
from distributedmandelbrot_tpu_torch.sessions.table import (SessionState,
                                                      SessionTable,
                                                      ViewportObs)

__all__ = [
    "PrefetchPlanner",
    "RefinementTracker",
    "SessionService",
    "SessionState",
    "SessionTable",
    "TrajectoryPredictor",
    "ViewportObs",
    "build_session_service",
    "predict_tiles",
]
