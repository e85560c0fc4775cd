"""The harness on the CPU: files found by name, the contract's shape, the
result line, the whole-name JAX check, the plain reference against the
port's plain loop, the roofline arithmetic, and no run without a card."""

from __future__ import annotations

import json
import re
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import chip, roofline
from benchmark.harness.spec import Cell
from benchmark.reference import escape as reference
from conftest import ROOT, run_cpu, with_held

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_finds_its_files_by_name():
    bench = _bench()
    for w in bench["workloads"]:
        cell = Cell(w["name"], ROOT)
        assert callable(cell.driver().run)
        for trace in (False, True):
            for m in cell.metrics(trace):
                assert callable(cell.reader(m["name"]).read)
        assert cell.chips == 1


@pytest.mark.parametrize("held", [False, True],
                         ids=["committed", "held_out_cells_added"])
def test_benchmark_json_keeps_the_contract(held):
    bench = with_held(_bench()) if held else _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in bench[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m.get("workloads", cells)) <= cells
    for w in bench["workloads"]:
        reported = [m for m in bench["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in bench["per_layer"])
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] \
            == c["reduced"]


def test_a_new_cell_is_files_and_entries(tiny_root):
    # The tiny cells were added to a copy as new files and new entries.
    for name in ("tiny.drain-inproc", "tinydeep.views-48",
                 "tinyglitch.views-32"):
        cell = Cell(name, tiny_root)
        assert cell.metrics(False) and cell.metrics(True)
    for path in (ROOT / "benchmark").rglob("*"):
        if path.is_file() and "tests" not in path.parts \
                and "__pycache__" not in path.parts:
            rel = path.relative_to(ROOT)
            assert (tiny_root / rel).read_bytes() == path.read_bytes(), rel


def test_result_line_has_the_five_keys_and_the_checks_last(tiny_root):
    rec, result = run_cpu(tiny_root, "tiny.drain-inproc")
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True and result["attempted"] >= 1
    assert {"chunks_per_s", "setup_s"} \
        <= set(result["metrics"])
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"}
               for c in result["checks"].values())


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("jaxtyping_like", "distributedmandelbrot_tpu_torch.ops",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert not set(chip.forbidden_modules()) & {"jax", "flax",
                                                "distributedmandelbrot_tpu"}
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "distributedmandelbrot_tpu.ops",
                        object())
    assert {"jax", "distributedmandelbrot_tpu"} <= \
        set(chip.forbidden_modules())


@pytest.mark.parametrize("key", [(4, 256, 1, 2), (10, 1024, 3, 5),
                                 (10, 1024, 2, 4), (20, 1024, 5, 9),
                                 (20, 1024, 7, 10)])
def test_reference_loop_equals_the_ports_plain_loop(key):
    from distributedmandelbrot_tpu_torch.core.geometry import TileSpec
    from distributedmandelbrot_tpu_torch.ops import cuda_escape as ce
    level, max_iter, i, j = key
    width = 128
    spec = TileSpec.for_chunk(level, i, j, definition=width)
    want, steps = ce.escape_tile_plain(
        np.asarray(ce._params_row(spec), np.float32), max_iter, width,
        width, cycle_check=ce.escape_time.resolve_cycle_check(None,
                                                              max_iter),
        device="cpu", return_steps=True)
    got = reference.chunk_bytes(*key, device="cpu", width=width)
    assert np.array_equal(got, want.reshape(-1).numpy())
    assert reference.chunk_steps(*key, device="cpu", width=width) \
        == int(steps.sum())


def test_checked_chunks_need_real_work_and_follow_the_seed(tiny_root):
    from benchmark.drivers import drain
    from benchmark.harness.common import seeded
    cell = Cell("canonical.drain-inproc", tiny_root)
    keys = drain.profile_keys(cell.config["levels"])
    steps = drain._steps_table(cell)
    floor = cell.traffic["check_floor_steps"]

    def draw(seed):
        return drain.checked_keys(seeded(seed, "x"), keys,
                                  cell.traffic["check"], steps, floor)
    got = draw(2**31 + 5)
    assert got == draw(2**31 + 5) and got != draw(2**31 + 6)
    assert [k[0] for k in got] == [4, 4, 10, 10, 10, 20, 20, 20]
    assert all(steps[":".join(map(str, k))] >= floor * 4096 ** 2
               for k in got)
    assert len(set(got)) == len(got)


def test_grant_source_pairs_a_key_held_twice_in_order():
    from benchmark.drivers import drain
    from distributedmandelbrot_tpu_torch.core.workload import Workload
    keys = drain.profile_keys("1:12,1:16")
    source = drain.GrantSource(keys, 1, Workload, keep=[keys[0]])
    first = source.request_batch(3)
    second = source.request_batch(1)
    assert [drain._key4(w) for w in first + second] \
        == [keys[1], keys[0], keys[1], keys[0]]
    px = np.arange(4, dtype=np.uint8)
    source.submit_batch([(w, px + i) for i, w in enumerate(first)])
    source.submit(second[0], px + 9)
    granted = [t for _, t, _ in source.done]
    assert [k for k, _, _ in source.done] == [keys[1], keys[0], keys[1],
                                             keys[0]]
    assert granted[:3] == sorted(granted[:3]) and granted[3] >= granted[2]
    assert np.array_equal(source.kept[keys[0]], px + 1)
    assert source.request_batch(0) == []


def test_roofline_of_a_hand_counted_tile():
    # Level 1 at 3x3 pixels: c in {-2, 0, 2} x {-2, 0, 2}.  The centre is
    # in the cardioid (no step); every other point leaves the radius-2
    # disk at step 1 (c = -2 lands on |z| = 2 exactly, and the test is
    # |z|^2 < 4).  8 steps of 8 operations.
    assert reference.chunk_steps(1, 256, 0, 0, device="cpu", width=3) == 8
    counts, _ = reference.escape_counts(1, 256, 0, 0, device="cpu",
                                        width=3)
    assert counts.tolist() == [[1, 1, 1], [1, 0, 1], [1, 1, 1]]
    assert roofline.chunk_bound_s(8, 9) == pytest.approx(
        max(64 / 33.5e12, 9 / 3.35e12))
    # A full chunk at the canonical deepest budget is bound by its
    # operations: 16 Mi pixels x 1023 steps x 8 / 33.5 T.
    full = 4096 * 4096 * 1023
    assert roofline.chunk_bound_s(full) == pytest.approx(
        full * 8 / 33.5e12)
    assert roofline.chunk_bound_s(0) == pytest.approx(4096 ** 2 / 3.35e12)


def test_a_run_without_a_card_fails_and_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from benchmark import run
    rc = run.main(["--workload", "deep-config4.views-1024", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "no CUDA device" in out.err


def test_trace_busy_union_and_named_gaps():
    from benchmark.harness.trace import Trace
    trace = Trace(10.0, [("void k<1>(int*)", 1.0, 3.0),
                         ("Memcpy DtoH", 2.0, 4.0), ("k2", 6.0, 7.0)],
                  [("colormap", 4.0, 5.9), ("tiny", 7.5, 7.6)])
    assert trace.busy_s == pytest.approx(4.0)
    assert trace.gaps() == [(0.0, 1.0), (4.0, 6.0), (7.0, 10.0)]
    b = trace.breakdown()
    assert b["device_ops"][0] == ["k<1>", 2.0]
    assert b["idle_gaps"][0] == ["no traced host operation", 3.0]
    assert b["idle_gaps"][1] == ["colormap (95% of it)", 2.0]
