"""Open-loop load generation for the gateway read path.

The viewer client is a *closed-loop* load source: it waits for each
response before sending the next query, so when the server slows down the
client automatically offers less — queue collapse is invisible.  A
million independent viewers don't behave that way: arrivals keep coming
at the population's rate no matter how slow responses get.  This package
models that: an **open-loop** runner issues requests on a precomputed
Poisson schedule regardless of in-flight count, tile choice follows a
Zipf popularity law over a level's keyspace, and flash crowds are
scripted as phases (``steady`` / ``spike`` / ``ramp``).

Layout:

- :mod:`.schedule` — phase spec parsing, Poisson arrival generation
  (inversion for constant-rate phases, thinning for ramps), the Zipf
  tile sampler, and :func:`build_schedule` tying them together;
- :mod:`.recorder` — latency/outcome recording into an
  :class:`~distributedmandelbrot_tpu_torch.obs.metrics.Registry` (phase-labeled
  histogram + ``loadgen_*`` counters) and the end-of-run report
  (p50/p99/p999, goodput vs offered, shed fraction);
- :mod:`.runner` — the open-loop runner plus the real/virtual timebases
  (the virtual one makes schedule tests deterministic and instant);
- :mod:`.driver` — the asyncio gateway client (connection per request,
  round-robin across replicas, raw or rendered queries);
- :mod:`.replicas` — :class:`GatewayFleet`: N threaded gateway replicas
  over one shared object store, for horizontal read-scaling runs;
- :mod:`.trajectory` — the interactive-session workload model: panning
  trajectories dealt onto a Poisson arrival process, plus the sticky
  :class:`SessionDriver`/:class:`SessionRunner` pair speaking the
  session framing (prefetch hit ratio and fairness-spread runs).

Everything above imports without jax or matplotlib (``driver`` speaks
only the wire protocol; ``replicas`` rides the jax-free serve stack), so
``dmtpu loadgen --smoke`` runs in the lint-only CI environment.
"""

from distributedmandelbrot_tpu_torch.loadgen.recorder import StormRecorder
from distributedmandelbrot_tpu_torch.loadgen.runner import (OpenLoopRunner,
                                                      RealTimebase,
                                                      VirtualTimebase)
from distributedmandelbrot_tpu_torch.loadgen.schedule import (Phase, Request,
                                                        ZipfTiles,
                                                        build_schedule,
                                                        parse_phases,
                                                        poisson_arrivals)
from distributedmandelbrot_tpu_torch.loadgen.trajectory import (
    SessionDriver, SessionRequest, SessionRunner, build_session_schedule,
    ok_spread)

__all__ = [
    "Phase",
    "Request",
    "ZipfTiles",
    "build_schedule",
    "parse_phases",
    "poisson_arrivals",
    "StormRecorder",
    "OpenLoopRunner",
    "RealTimebase",
    "VirtualTimebase",
    "SessionDriver",
    "SessionRequest",
    "SessionRunner",
    "build_session_schedule",
    "ok_spread",
]
