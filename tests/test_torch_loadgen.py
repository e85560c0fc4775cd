"""The port's open-loop storm harness (``loadgen/``, carried from the JAX
package), under the JAX package's deterministic (virtual-clock) tests.

Everything here runs on :class:`VirtualTimebase` — a "10 second" storm
finishes in milliseconds and issue instants are *exact*, so the open-loop
contract (arrivals follow the schedule, not the server) is asserted as
equality, not as a tolerance band.
"""

from __future__ import annotations

import asyncio

import pytest

from distributedmandelbrot_tpu_torch.loadgen import (OpenLoopRunner, Phase,
                                               StormRecorder,
                                               VirtualTimebase, ZipfTiles,
                                               build_schedule, parse_phases,
                                               poisson_arrivals)
from distributedmandelbrot_tpu_torch.loadgen import recorder as rec
from distributedmandelbrot_tpu_torch.loadgen.schedule import offered_rate
from distributedmandelbrot_tpu_torch.obs import names as obs_names


def _drive(runner: OpenLoopRunner, timebase: VirtualTimebase) -> float:
    async def main() -> float:
        task = asyncio.ensure_future(runner.run())
        await timebase.drain(until=task)
        return task.result()

    return asyncio.run(main())


# -- phase spec / arrival process -------------------------------------------

def test_parse_phases_grammar_and_errors():
    phases = parse_phases("steady:200x5, spike:2000x2 ,ramp:200-2000x5")
    assert [p.kind for p in phases] == ["steady", "spike", "ramp"]
    assert phases[0].rate == 200 and phases[0].duration == 5
    assert phases[2].rate == 200 and phases[2].rate_end == 2000
    assert [p.name for p in phases] == ["steady0", "spike1", "ramp2"]
    for bad in ("", "warble:10x5", "steady:x5", "steady:10", "ramp:10x5"):
        with pytest.raises(ValueError):
            parse_phases(bad)


def test_poisson_arrivals_deterministic_in_window_and_near_rate():
    phases = parse_phases("steady:500x4,spike:2000x2")
    a1 = poisson_arrivals(phases, seed=7)
    a2 = poisson_arrivals(phases, seed=7)
    assert a1 == a2  # same seed, same storm, byte for byte
    assert a1 != poisson_arrivals(phases, seed=8)
    times = [t for t, _ in a1]
    assert times == sorted(times)
    steady = [t for t, name in a1 if name == "steady0"]
    spike = [t for t, name in a1 if name == "spike1"]
    assert all(0 <= t < 4 for t in steady)
    assert all(4 <= t < 6 for t in spike)
    # A Poisson(n) count sits within ~5 sigma of its mean.
    assert 500 * 4 * 0.8 < len(steady) < 500 * 4 * 1.2
    assert 2000 * 2 * 0.8 < len(spike) < 2000 * 2 * 1.2


def test_ramp_arrival_density_actually_ramps():
    (phase,) = parse_phases("ramp:100-1900x10")
    arrivals = poisson_arrivals([phase], seed=3)
    first = sum(1 for t, _ in arrivals if t < 5)
    second = len(arrivals) - first
    # Mean rate 600/s in the first half vs 1400/s in the second.
    assert second > 1.5 * first


def test_zipf_sampler_head_heavy_and_in_range():
    sampler = ZipfTiles(8, s=1.2, seed=1)
    counts: dict[tuple[int, int, int], int] = {}
    for _ in range(4000):
        key = sampler.sample()
        level, i, j = key
        assert level == 8 and 0 <= i < 8 and 0 <= j < 8
        counts[key] = counts.get(key, 0) + 1
    ranked = sorted(counts.values(), reverse=True)
    # Zipf head: the hottest key dwarfs the median key.
    assert ranked[0] > 8 * ranked[len(ranked) // 2]
    # hottest() agrees with the empirical head.
    assert sampler.hottest(1)[0] == max(counts, key=counts.get)


# -- open-loop runner -------------------------------------------------------

def test_open_loop_issue_times_independent_of_server_latency():
    """The defining property: a server 100x slower than the schedule's
    inter-arrival gap must not delay a single issue instant."""
    phases = parse_phases("steady:100x3")
    sampler = ZipfTiles(4, seed=0)
    schedule = build_schedule(phases, sampler, seed=0)
    timebase = VirtualTimebase()
    recorder = StormRecorder()

    async def glacial(level, i, j):
        await timebase.sleep(10.0)  # way past the 3s schedule span
        return rec.OUTCOME_OK, 64

    runner = OpenLoopRunner(schedule, glacial, recorder, timebase=timebase)
    duration = _drive(runner, timebase)
    assert runner.issue_times == [item.time for item in schedule]
    assert recorder.registry.counter_value(
        obs_names.LOADGEN_REQUESTS) == len(schedule)
    assert recorder.registry.counter_value(
        obs_names.LOADGEN_COMPLETED) == len(schedule)
    # Run ends when the last straggler lands: last issue + service time.
    assert duration == pytest.approx(schedule[-1].time + 10.0)


def test_phase_labels_follow_transitions():
    phases = parse_phases("steady:200x2,spike:800x1")
    schedule = build_schedule(phases, ZipfTiles(4, seed=0), seed=0)
    for item in schedule:
        assert item.phase == ("steady0" if item.time < 2 else "spike1")
    timebase = VirtualTimebase()
    recorder = StormRecorder()

    async def instant(level, i, j):
        return rec.OUTCOME_OK, 1

    _drive(OpenLoopRunner(schedule, instant, recorder, timebase=timebase),
           timebase)
    report = recorder.report(duration=3.0, offered=offered_rate(schedule),
                             phases=[p.name for p in phases])
    assert set(report["phases"]) == {"steady0", "spike1"}
    assert report["p50"] is not None


def test_shed_accounting_against_stub_gateway():
    """A capacity-64 stub under a 5x-over-capacity spike: every arrival
    settles exactly once, sheds are counted, and the report's shed
    fraction is consistent with the counters."""
    phases = parse_phases("steady:100x2,spike:1000x2,steady:100x2")
    schedule = build_schedule(phases, ZipfTiles(4, seed=2), seed=2)
    timebase = VirtualTimebase()
    recorder = StormRecorder()
    inflight = 0

    async def stub(level, i, j):
        nonlocal inflight
        if inflight >= 64:
            return rec.OUTCOME_SHED, 0
        inflight += 1
        try:
            await timebase.sleep(0.2)  # capacity: 320/s
        finally:
            inflight -= 1
        return rec.OUTCOME_OK, 128

    runner = OpenLoopRunner(schedule, stub, recorder, timebase=timebase)
    duration = _drive(runner, timebase)
    reg = recorder.registry
    issued = reg.counter_value(obs_names.LOADGEN_REQUESTS)
    completed = reg.counter_value(obs_names.LOADGEN_COMPLETED)
    shed = reg.counter_value(obs_names.LOADGEN_SHED)
    assert issued == len(schedule)
    assert completed + shed == issued  # nothing lost, nothing double
    assert shed > 0  # the spike overran capacity
    # The steady phases fit within capacity; sheds belong to the spike.
    spike_issued = sum(1 for item in schedule if item.phase == "spike1")
    assert shed < spike_issued
    report = recorder.report(duration=duration,
                             offered=offered_rate(schedule))
    assert report["shed_fraction"] == pytest.approx(shed / issued,
                                                    abs=1e-4)
    assert report["goodput"] == pytest.approx(completed / duration,
                                              abs=1e-2)
    assert report["bytes"] == 128 * completed


def test_errors_are_recorded_not_raised():
    schedule = build_schedule(parse_phases("steady:50x1"),
                              ZipfTiles(2, seed=0), seed=0)
    timebase = VirtualTimebase()
    recorder = StormRecorder()

    async def broken(level, i, j):
        raise ConnectionError("synthetic transport failure")

    _drive(OpenLoopRunner(schedule, broken, recorder, timebase=timebase),
           timebase)
    assert recorder.registry.counter_value(
        obs_names.LOADGEN_ERRORS) == len(schedule)


def test_virtual_timebase_wakes_in_deadline_order():
    timebase = VirtualTimebase()
    woke: list[tuple[str, float]] = []

    async def sleeper(name: str, dt: float) -> None:
        await timebase.sleep(dt)
        woke.append((name, timebase.now()))

    async def main() -> None:
        task = asyncio.ensure_future(asyncio.gather(
            sleeper("c", 3.0), sleeper("a", 1.0), sleeper("b", 2.0)))
        await timebase.drain(until=task)

    asyncio.run(main())
    assert woke == [("a", 1.0), ("b", 2.0), ("c", 3.0)]
