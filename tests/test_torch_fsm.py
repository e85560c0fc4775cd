"""The port's automaton extraction + product exploration (``fsm-*``,
``analysis/fsm.py`` and ``explore.py``, carried from the JAX package),
under the JAX package's own tests.

Fixture pairs go through ``Project.from_sources`` with the real
endpoint qualnames (the pair extraction keys on them), so it lifts
exactly the code under test; the real-tree cases (the port's tree) then
pin every capability product explored clean, the one audited dead arm,
and crash-seam coverage.  No disk fixtures, no torch.
"""

from __future__ import annotations

import pytest

from distributedmandelbrot_tpu_torch.analysis import Project, check_project
from distributedmandelbrot_tpu_torch.analysis import engine, explore, fsm

P = "distributedmandelbrot_tpu_torch"

CLIENT_REL = f"{P}/viewer/client.py"
SERVER_REL = f"{P}/coordinator/dataserver.py"

QUERY_CLIENT = f'''
from distributedmandelbrot_tpu_torch.net import framing
from distributedmandelbrot_tpu_torch.net import protocol as proto


class DataClient:
    def _fetch_once(self, sock, level, ir, ii):
        framing.send_all(sock, proto.QUERY.pack(level, ir, ii))
        status = framing.recv_byte(sock)
        if status == proto.QUERY_REJECT:
            return None
        if status != proto.QUERY_ACCEPT:
            raise framing.ProtocolError("bad status")
        return b"tile"
'''

QUERY_SERVER = f'''
from distributedmandelbrot_tpu_torch.net import framing
from distributedmandelbrot_tpu_torch.net import protocol as proto


class DataServer:
    def _handle_connection(self, conn):
        level, ir, ii = proto.QUERY.unpack(
            framing.recv_exact(conn, proto.QUERY.size))
        if self._have(level, ir, ii):
            framing.send_byte(conn, proto.QUERY_ACCEPT)
        else:
            framing.send_byte(conn, proto.QUERY_REJECT)

    def _have(self, level, ir, ii):
        return True
'''

# Reads the query struct TWICE for the client's single send: the
# product must wedge with the client waiting on the status byte and
# the server waiting on the second struct.
QUERY_SERVER_DESYNCED = f'''
from distributedmandelbrot_tpu_torch.net import framing
from distributedmandelbrot_tpu_torch.net import protocol as proto


class DataServer:
    def _handle_connection(self, conn):
        first = proto.QUERY.unpack(
            framing.recv_exact(conn, proto.QUERY.size))
        second = proto.QUERY.unpack(
            framing.recv_exact(conn, proto.QUERY.size))
        framing.send_byte(conn, proto.QUERY_ACCEPT)
'''

QUERY_SERVER_LOOP = f'''
from distributedmandelbrot_tpu_torch.net import framing
from distributedmandelbrot_tpu_torch.net import protocol as proto


class DataServer:
    def _handle_connection(self, conn):
        while True:
            try:
                level, ir, ii = proto.QUERY.unpack(
                    framing.recv_exact(conn, proto.QUERY.size))
            except ConnectionError:
                return
            framing.send_byte(conn, proto.QUERY_ACCEPT)
'''

# An unbounded sender: termination must come from the exploration's
# queue bound, not from the fixture being well-behaved.
QUERY_SERVER_FLOOD = f'''
from distributedmandelbrot_tpu_torch.net import framing
from distributedmandelbrot_tpu_torch.net import protocol as proto


class DataServer:
    def _handle_connection(self, conn):
        level, ir, ii = proto.QUERY.unpack(
            framing.recv_exact(conn, proto.QUERY.size))
        while True:
            framing.send_byte(conn, proto.QUERY_ACCEPT)
'''


def query_pair(server_src: str, client_src: str = QUERY_CLIENT):
    project = Project.from_sources({CLIENT_REL: client_src,
                                    SERVER_REL: server_src})
    pairs = fsm.build_pairs(project)
    assert len(pairs) == 1 and pairs[0].kind == "query"
    return project, pairs[0]


# -- extraction -------------------------------------------------------------

def test_branch_extraction_query_pair():
    _, pair = query_pair(QUERY_SERVER)
    csends = {e.label for e in pair.client.edges if e.kind == "send"}
    crecvs = {e.label for e in pair.client.edges if e.kind == "recv"}
    assert "QUERY" in csends
    # both status branches became receive arms
    assert {"QUERY_ACCEPT", "QUERY_REJECT"} <= crecvs
    srecvs = {e.label for e in pair.server.edges if e.kind == "recv"}
    ssends = {e.label for e in pair.server.edges if e.kind == "send"}
    assert "QUERY" in srecvs
    assert {"QUERY_ACCEPT", "QUERY_REJECT"} <= ssends


def test_loop_extraction_gets_eos_fault_arm():
    _, pair = query_pair(QUERY_SERVER_LOOP)
    # the recv inside try/except ConnectionError grew the fault arm
    # that lets the loop observe the client hanging up
    assert any(e.kind == "recv" and e.label == "EOS" and e.fault
               for e in pair.server.edges)
    rep = explore.explore_pair(pair)
    assert not rep.violations
    for cfg in rep.configs:
        assert cfg.complete and cfg.terminal_reached


def test_clean_pair_explores_clean():
    _, pair = query_pair(QUERY_SERVER)
    rep = explore.explore_pair(pair)
    assert not rep.violations
    assert rep.visited_caps == {frozenset(), frozenset({"SHARDED"})}
    for cfg in rep.configs:
        assert cfg.complete and cfg.terminal_reached
        assert cfg.n_states < 200  # tiny exchange, tiny product


def test_exploration_terminates_on_unbounded_sender():
    _, pair = query_pair(QUERY_SERVER_FLOOD)
    rep = explore.explore_pair(pair)  # returning at all IS the point
    for cfg in rep.configs:
        assert cfg.complete
        assert cfg.truncations > 0  # the queue bound did the cutting


# -- the rules on fixture trees ---------------------------------------------

def fsm_findings(sources: dict, rule: str) -> list:
    return [f for f in check_project(Project.from_sources(sources),
                                     ["fsm"])
            if f.rule == rule]


def test_desynced_pair_reports_deadlock_with_both_states():
    findings = fsm_findings({CLIENT_REL: QUERY_CLIENT,
                             SERVER_REL: QUERY_SERVER_DESYNCED},
                            "fsm-deadlock")
    assert findings, "desynced fixture must deadlock"
    msg = findings[0].message
    # the finding names the stuck client/server state pair
    assert "client@" in msg and "server@" in msg
    assert "wait forever" in msg


def test_clean_pair_has_no_fsm_findings():
    project = Project.from_sources({CLIENT_REL: QUERY_CLIENT,
                                    SERVER_REL: QUERY_SERVER})
    assert [f for f in check_project(project, ["fsm"])] == []


def test_fixture_without_endpoints_is_skipped():
    project = Project.from_sources(
        {f"{P}/serve/other.py": "class X:\n    def f(self):\n        pass\n"})
    assert fsm.build_pairs(project) == []
    assert check_project(project, ["fsm"]) == []


# -- real tree --------------------------------------------------------------

@pytest.fixture(scope="module")
def real_report():
    project = engine.Project.from_root(engine.default_root())
    pairs = fsm.build_pairs(project)
    return project, pairs, explore.explore_all(pairs)


def test_real_tree_extracts_all_exchanges(real_report):
    _, pairs, _ = real_report
    assert {p.name for p in pairs} == {
        "session", "query", "render_query", "session_query"}


def test_real_tree_visits_legacy_and_fully_negotiated(real_report):
    _, pairs, rep = real_report
    session = next(p for p in rep.pairs if p.pair.name == "session")
    visited = session.visited_caps
    assert frozenset() in visited                      # legacy product
    assert frozenset({"RLE", "GRANTN", "SHARD",       # fully negotiated
                      "SHARDED"}) in visited
    assert len(visited) == 12
    for cfg in session.configs:
        assert cfg.complete and cfg.terminal_reached
        assert cfg.truncations == 0


def test_real_tree_has_no_violations(real_report):
    _, _, rep = real_report
    assert rep.violations == []


def test_real_tree_session_has_cap_guarded_edges(real_report):
    _, pairs, _ = real_report
    session = next(p for p in pairs if p.name == "session")
    guards = {atom for auto in (session.client, session.server)
              for e in auto.edges for atom in e.pos}
    assert {"RLE", "GRANTN", "SHARD"} <= guards


def test_real_tree_only_audited_dead_arm(real_report):
    _, _, rep = real_report
    dead = rep.dead_arms()
    assert len(dead) == 1
    (origin, label), = dead
    assert label == "QUERY_OVERLOADED"
    assert origin[0].endswith("viewer/client.py")


# -- crash-interleaving model ----------------------------------------------

def test_crash_model_clean_and_covers_every_seam():
    rep = explore.explore_crash_model()
    assert rep.violations == []
    assert rep.seams_fired == set(explore.CRASH_SEAMS)
    assert rep.quiescent_ok > 0


def test_crash_model_claim_dedup_off_double_commits():
    rep = explore.explore_crash_model(
        explore.CrashSpec(claim_dedup=False))
    assert {v.kind for v in rep.violations} == {"crash-dual"}


def test_crash_model_pending_exclusion_off_loses_the_tile():
    rep = explore.explore_crash_model(
        explore.CrashSpec(pending_exclusion=False))
    assert {v.kind for v in rep.violations} == {"crash-lost"}


def test_crash_seams_match_registered_crashpoints(real_report):
    # exact two-way coverage: every faults.hit literal in the tree is
    # a modeled seam (the fsm-dead-arm rule enforces that direction)
    # AND every modeled seam exists in the code (the model must not
    # outgrow the crashpoints it claims to cover)
    import ast

    from distributedmandelbrot_tpu_torch.analysis.astutil import (attr_chain,
                                                            cached_walk)
    project, _, _ = real_report
    hits: set[str] = set()
    for sf in project.files.values():
        for node in cached_walk(sf.tree):
            if isinstance(node, ast.Call) and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                chain = attr_chain(node.func)
                if chain and chain[-1] == "hit" \
                        and "faults" in chain[:-1]:
                    hits.add(node.args[0].value)
    assert hits == set(explore.CRASH_SEAMS)


# -- DOT export -------------------------------------------------------------

def test_to_dot_renders_every_pair():
    _, pair = query_pair(QUERY_SERVER)
    dot = fsm.to_dot([pair])
    assert dot.startswith("digraph fsm {")
    assert "!QUERY" in dot and "?QUERY" in dot
    assert "doublecircle" in dot  # accepting states marked
    assert dot.count("subgraph") == 2
