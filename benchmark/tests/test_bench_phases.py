"""The readers of the program's own phases (``obs/phases.py`` of the
port) on hand-built records and traces, and on a program without the
phases (nothing read)."""

from __future__ import annotations

import sys
import time

import pytest

from benchmark.harness.common import Record
from benchmark.harness.spec import Cell
from benchmark.harness.trace import Trace
from conftest import ROOT

SPANS = {"colormap_ms": "render.colormap", "rgba8_ms": "render.rgba8",
         "deflate_ms": "render.deflate", "deep_orbit_ms": "deep.orbit",
         "deep_probe_ms": "deep.probe", "deep_exact_ms": "repair_exact"}


def _reader(name):
    return Cell("deep-config4.views-1024", ROOT).reader(name)


@pytest.fixture
def tally():
    """The program's phase tally, empty, and emptied again after."""
    from distributedmandelbrot_tpu_torch.obs import phases
    phases.reset_phase_seconds()
    yield phases
    phases.reset_phase_seconds()


@pytest.mark.parametrize("name", sorted(SPANS))
def test_a_span_reader_gives_its_phase_per_view(name, tally):
    rec = Record(kind="views", done=4)
    # A phase no view entered in the window reads 0.
    assert _reader(name).read(rec) == 0.0
    for key in SPANS.values():
        with tally.timed(key):
            pass
    with tally.timed(SPANS[name]):
        time.sleep(0.02)
    assert _reader(name).read(rec) == pytest.approx(
        tally.phase_seconds()[SPANS[name]] / 4 * 1e3)
    assert _reader(name).read(rec) >= 5.0
    assert _reader(name).read(Record(kind="drain", done=4)) is None
    assert _reader(name).read(Record(kind="views", done=0)) is None


def test_orbits_per_view_counts_the_orbit_phases_entries(tally):
    read = _reader("deep_orbits_per_view").read
    rec = Record(kind="views", done=4)
    assert read(rec) == 0.0
    for _ in range(6):
        with tally.timed("deep.orbit"):
            pass
    with tally.timed("deep.probe"):
        pass
    assert read(rec) == 1.5
    assert read(Record(kind="drain", done=4)) is None
    assert read(Record(kind="views", done=0)) is None


def test_a_program_without_the_phases_reads_nothing(monkeypatch, tally):
    with tally.timed("deep.orbit"):
        pass
    rec = Record(kind="views", done=2)
    # The parent's program: no obs/phases.py.
    import distributedmandelbrot_tpu_torch.obs as obs
    monkeypatch.delattr(obs, "phases")
    monkeypatch.setitem(sys.modules,
                        "distributedmandelbrot_tpu_torch.obs.phases", None)
    assert all(_reader(name).read(rec) is None
               for name in [*SPANS, "deep_orbits_per_view"])


def test_idle_unnamed_is_the_idle_time_no_program_span_covers():
    read = _reader("idle_unnamed.deep").read
    device = [("k<1>", 1.0, 3.0), ("k2", 6.0, 7.0)]
    host = [("dmtpu.render.colormap", 0.5, 1.5),
            ("dmtpu.deep.orbit", 3.5, 5.0), ("dmtpu.repair_exact", 4.5, 5.5),
            ("benchmark.deep_route", 3.0, 6.0), ("aten::add", 6.5, 9.5),
            ("dmtpu.render.write", 8.0, 9.0)]
    # Gaps (0, 1), (3, 6), (7, 10): 7 s idle; the program's spans cover
    # 0.5, 2 and 1 of them, leaving 3.5 s over 2 views.
    rec = Record(kind="views", done=2, trace=Trace(10.0, device, host))
    assert read(rec) == pytest.approx(1750.0)
    no_spans = [h for h in host if not h[0].startswith("dmtpu.")]
    assert read(Record(kind="views", done=2,
                       trace=Trace(10.0, device, no_spans))) is None
    assert read(Record(kind="views", done=2, trace=None)) is None
    assert read(Record(kind="views", done=0,
                       trace=Trace(10.0, device, host))) is None
    assert read(Record(kind="drain", done=2,
                       trace=Trace(10.0, device, host))) is None
