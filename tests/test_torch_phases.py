"""The phases of a render (``obs/phases.py``): every phase of a deep
``render`` through ``cli.main`` on the CPU is timed and counted, the
host-only ones are marked in a ``torch.profiler`` trace (and only
those), no annotation is opened without a profiler, and ``render
--profile DIR`` writes the trace.  Under a real profiler the views are
small: each operation of the plain scans costs an event."""

import contextlib
import json
import os
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from distributedmandelbrot_tpu_torch import cli
from distributedmandelbrot_tpu_torch.obs import names, phases
from distributedmandelbrot_tpu_torch.ops import perturbation as P

# (centre re, centre im, span, max_iter), 32^2: config 4's view searches
# for its reference with probe scans; the seahorse valley's view takes
# the secondary and the exact repair.
CONFIG4 = ("-0.77568376995", "0.13646737005", "1e-10", "50000")
SEAHORSE = ("-0.743643887037158704752191506114774",
            "0.131825904205311970493132056385139", "1e-10", "20000")

NEW = [names.PHASE_RENDER_PARSE, names.PHASE_RENDER_COLORMAP,
       names.PHASE_RENDER_RGBA8, names.PHASE_RENDER_DEFLATE,
       names.PHASE_RENDER_WRITE, names.PHASE_DEEP_ORBIT,
       names.PHASE_DEEP_PROBE, names.PHASE_DEEP_REPAIR_EXACT]
# The phases that launch no device work.
ANNOTATED = [names.PHASE_RENDER_PARSE, names.PHASE_RENDER_COLORMAP,
             names.PHASE_RENDER_RGBA8, names.PHASE_RENDER_DEFLATE,
             names.PHASE_RENDER_WRITE, names.PHASE_DEEP_ORBIT,
             names.PHASE_DEEP_REPAIR_EXACT]
HOST_CLOCK_ONLY = [names.PHASE_DEEP_REFERENCE, names.PHASE_DEEP_BLA_PROBE,
                   names.PHASE_DEEP_SCAN, names.PHASE_DEEP_REPAIR_SECONDARY,
                   names.PHASE_DEEP_PROBE]


def _render(tmp_path, view, *flags):
    re, im, span, max_iter = view
    assert cli.main(["render", "--deep", "--smooth", f"--center={re},{im}",
                     "--span", span, "--max-iter", max_iter,
                     "--definition", "32", "--device", "cpu",
                     "--out", str(tmp_path / "view.png"), "-q",
                     *flags]) == 0


@pytest.fixture
def orbits(monkeypatch):
    """Empty phases and orbit store; the fixed-point orbits computed
    from here on."""
    P.ORBITS.clear()
    phases.reset_phase_seconds()
    calls = []
    real = P._orbit_fixed_impl

    def spy(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)
    monkeypatch.setattr(P, "_orbit_fixed_impl", spy)
    return calls


def test_a_phase_counts_its_entries_and_keeps_time_through_a_raise():
    phases.reset_phase_seconds()
    with phases.timed("t.block"):
        pass
    with pytest.raises(ValueError):
        with phases.timed("t.block", annotate=True):
            raise ValueError
    phases.tally("t.count", 3)
    assert phases.phase_entries() == {"t.block": 2}
    seconds = phases.phase_seconds()
    assert seconds["t.count"] == 3.0 and seconds["t.block"] >= 0.0
    phases.reset_phase_seconds()
    assert phases.phase_seconds() == {} and phases.phase_entries() == {}


def test_the_route_reads_and_resets_the_render_phases():
    assert P.phase_seconds is phases.phase_seconds
    assert P.reset_phase_seconds is phases.reset_phase_seconds


def test_deep_renders_time_and_count_every_phase(tmp_path, orbits):
    t0 = time.monotonic()
    _render(tmp_path, CONFIG4)
    _render(tmp_path, SEAHORSE)
    wall = time.monotonic() - t0
    seconds, entries = phases.phase_seconds(), phases.phase_entries()
    for key in NEW:
        assert seconds[key] > 0 and entries[key] >= 1, key
    assert seconds[names.COUNT_DEEP_GLITCHED] > 0
    assert seconds[names.COUNT_DEEP_EXACT_REPAIRED] > 0
    assert entries[names.PHASE_RENDER_PARSE] == 2
    # The annotated phases do not overlap one another: together they
    # fit in the two commands.
    assert sum(seconds[k] for k in ANNOTATED) <= wall
    assert entries[names.PHASE_DEEP_ORBIT] == len(orbits) > 1
    # The same views again: their orbits come from the caches.
    _render(tmp_path, SEAHORSE)
    _render(tmp_path, CONFIG4)
    entries = phases.phase_entries()
    assert entries[names.PHASE_RENDER_PARSE] == 4
    assert entries[names.PHASE_DEEP_ORBIT] == len(orbits)


def test_host_only_phases_mark_a_profilers_trace(tmp_path, orbits):
    # 16^2 and a shallower view: the plain scans' many small operations
    # each cost an event under the profiler.
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _render(tmp_path, ("-0.77568376995", "0.13646737005", "1e-13",
                           "1000"), "--definition", "16")
    assert phases.phase_entries()[names.PHASE_DEEP_PROBE] >= 1
    marked = {e.name for e in prof.events()
              if e.name.startswith(names.PHASE_ANNOTATION_PREFIX)}
    assert marked == {names.PHASE_ANNOTATION_PREFIX + k for k in ANNOTATED
                      if k != names.PHASE_DEEP_REPAIR_EXACT}


@pytest.mark.parametrize("recording", [False, True],
                         ids=["no_profiler", "profiler_recording"])
def test_only_host_only_phases_annotate_and_only_while_recording(
        tmp_path, orbits, monkeypatch, recording):
    entered = []

    def record_function(name):
        entered.append(name)
        return contextlib.nullcontext()
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    if recording:
        monkeypatch.setattr(phases, "_recording", lambda: True)
    _render(tmp_path, CONFIG4)
    _render(tmp_path, SEAHORSE)
    assert set(entered) == ({names.PHASE_ANNOTATION_PREFIX + k
                             for k in ANNOTATED} if recording else set())
    assert not set(entered) & {names.PHASE_ANNOTATION_PREFIX + k
                               for k in HOST_CLOCK_ONLY}


def test_render_profile_writes_the_render_phases(tmp_path, capsys):
    out = tmp_path / "prof"
    assert cli.main(["render", "--smooth", "--definition", "16",
                     "--max-iter", "64", "--device", "cpu",
                     "--out", str(tmp_path / "view.png"),
                     "--profile", str(out), "-q"]) == 0
    assert "profile trace written to" in capsys.readouterr().out
    (trace,) = out.iterdir()
    assert trace.name == f"render-{os.getpid()}.trace.json"
    events = {e.get("name") for e in
              json.loads(trace.read_text())["traceEvents"]}
    assert {names.PHASE_ANNOTATION_PREFIX + k for k in (
        names.PHASE_RENDER_COLORMAP, names.PHASE_RENDER_RGBA8,
        names.PHASE_RENDER_DEFLATE, names.PHASE_RENDER_WRITE)} <= events
