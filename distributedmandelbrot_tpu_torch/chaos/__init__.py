"""Continuous chaos suite for the sharded control plane.

A scenario runner (:mod:`.runner`) drives a live sharded farm — N
coordinator shard subprocesses over one shared data directory, M
multi-homed numpy worker subprocesses — while killing processes on
spot-preemption-style schedules (SIGKILL and ``utils/faults.py``
hard-exit crashpoints), injecting slow persists (``DMTPU_SLOWPOINTS``)
and dropped sessions, then asserts the invariants the control plane
sells: every tile completed exactly once on disk, payloads
numpy-golden, every index entry owned by the shard that wrote it, and
a bounded restart-to-first-grant blip.

Exposed as ``dmtpu chaos`` (cli.py) and reused by the CI smoke.
"""

from distributedmandelbrot_tpu_torch.chaos.runner import (SCENARIOS, ChaosReport,
                                                    ChaosRunner, KillEvent,
                                                    Scenario)

__all__ = ["ChaosReport", "ChaosRunner", "KillEvent", "Scenario",
           "SCENARIOS"]
