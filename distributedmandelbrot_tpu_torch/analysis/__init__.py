"""Project-native static analysis (``dmtpu check``) of the port.

Stdlib-``ast`` checkers for the farm's hand-enforced invariants: lock
discipline in the threaded layers (interprocedural, over
``analysis/callgraph.py``), async hygiene in the event-loop layers,
wire-format parity between every speaker of the protocol, protocol
conversation conformance (dispatch arms, frame sequences, exact-length
reads), resource lifecycles (threads, sockets, queues, servers),
instrumentation-name registration, the kernel-launch wrappers'
asynchrony and precision (the ``torch`` family, ``rules_torch.py``),
taint tracking over ``analysis/dataflow.py`` from network reads to
allocation/index/loop/struct sinks (``taint-*``), exception-path
resource-leak and silent-swallow checks (``exc-*``), and the protocol
state machines' exploration (``fsm-*``).  Importing this package never
imports torch, jax or the modules under analysis — the gate runs it in
a bare subprocess.
"""

from distributedmandelbrot_tpu_torch.analysis.engine import (Finding, Project,
                                                       Report, Rule,
                                                       SourceFile, all_rules,
                                                       check_project,
                                                       default_root,
                                                       expand_rule_ids,
                                                       fingerprints_at_ref,
                                                       load_baseline,
                                                       project_at_ref,
                                                       render_json,
                                                       render_text, run_check,
                                                       save_baseline)

__all__ = [
    "Finding", "Project", "Report", "Rule", "SourceFile",
    "all_rules", "check_project", "default_root", "expand_rule_ids",
    "fingerprints_at_ref", "project_at_ref",
    "load_baseline", "save_baseline",
    "render_json", "render_text", "run_check",
]
