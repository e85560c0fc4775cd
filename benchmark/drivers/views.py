"""View traffic: one user stepping from view to view in a closed loop,
each view ``render`` from command to PNG on disk (``cli.main``, in
this process), for the window.

Traffic keys:

- ``definition``: pixels on a side of every view;
- ``path``: the walk of views: ``views`` steps from the configuration's
  view, drawn once from ``path_seed``; each step zooms by a factor in
  [``zoom_min``, ``zoom_max``] (the span kept in [``span_min``,
  ``span_max``]) and pans by at most ``pan_max`` of the span, the centre
  kept within ``radius`` of the configuration's.  Every run walks it from
  its start, so every seed renders the same views (their costs differ
  twofold from view to view, and a window holds part of the walk).
  More views than a window holds and than the deep route's caches hold,
  so every view pays its own reference search;
- ``check``: ``views`` views drawn from the run's seed among the walk's
  first ``among_first`` (a window completes more; the last view where it
  completes none of them) have their PNG and ``pixels`` of their pixels
  (drawn from the seed), with their ``deepest`` deepest escaping pixels
  (where glitches gather and the route repairs) and one in-set pixel
  where there is one, checked;
- ``png_slots``: the PNG files the views rotate over.

The window ends with the view in flight at its close: every view in it
is whole.
"""

from __future__ import annotations

import contextlib
import io
import math
import random
import shutil
import sys
import tempfile
import time
import traceback
from decimal import Decimal
from pathlib import Path

import numpy as np

from benchmark.harness import chip
from benchmark.harness.common import Record, check, seeded
from benchmark.harness.trace import MARK_PREFIX, Profiler, mark
from benchmark.reference import colormap as ref_colormap
from benchmark.reference import deep as ref_deep

# The deep route's host-clock phases (perturbation.phase_seconds()).
PHASES = ("reference", "bla_probe", "bla_table", "scan", "repair_secondary",
          "repair_exact")
CENTER_UNIT = Decimal("1e-20")


def view_path(cfg: dict, path: dict) -> list[tuple[tuple[str, str], float]]:
    """The walk of views: ((centre re, centre im) as decimal strings,
    span)."""
    rng = random.Random(path["path_seed"])
    base = [Decimal(v) for v in cfg["center"]]
    span = float(cfg["span"])
    off = [0.0, 0.0]
    views = []
    for _ in range(path["views"]):
        span *= 2.0 ** rng.uniform(math.log2(path["zoom_min"]),
                                   math.log2(path["zoom_max"]))
        span = min(max(span, path["span_min"]), path["span_max"])
        angle = rng.uniform(0.0, 2.0 * math.pi)
        reach = rng.uniform(0.0, path["pan_max"]) * span
        off = [off[0] + reach * math.cos(angle),
               off[1] + reach * math.sin(angle)]
        dist = math.hypot(*off)
        if dist > path["radius"]:
            off = [v * path["radius"] / dist for v in off]
        center = tuple(str(b + Decimal(round(o / float(CENTER_UNIT)))
                           * CENTER_UNIT) for b, o in zip(base, off))
        views.append((center, span))
    return views


class Taps:
    """Wrappers around the colormap and the PNG encoder of the program
    (their host-clock seconds, and the smooth values of the last view),
    and around the deep route (a mark in the trace)."""

    def __init__(self, trace: bool) -> None:
        import distributedmandelbrot_tpu_torch.viewer as viewer
        from distributedmandelbrot_tpu_torch.ops import perturbation
        from distributedmandelbrot_tpu_torch.serve import render
        self._viewer, self._render = viewer, render
        self._route = perturbation
        self._real = (viewer.smooth_to_rgba, render.imsave_bytes,
                      render.encode_png, perturbation.compute_smooth_perturb)
        self._trace = trace
        self.colormap_png_s = 0.0
        self.last_nu = None

    def _timed(self, fn, name: str, keep_nu: bool = False):
        def call(*args, **kwargs):
            if keep_nu:
                self.last_nu = args[0]
            t = time.monotonic()
            with mark(name, self._trace):
                out = fn(*args, **kwargs)
            self.colormap_png_s += time.monotonic() - t
            return out
        return call

    def _marked(self, fn, name: str):
        def call(*args, **kwargs):
            with mark(name, self._trace):
                return fn(*args, **kwargs)
        return call

    def __enter__(self) -> "Taps":
        smooth, imsave, png, route = self._real
        self._viewer.smooth_to_rgba = self._timed(
            smooth, MARK_PREFIX + "colormap", True)
        self._render.imsave_bytes = self._timed(imsave, MARK_PREFIX + "png")
        self._render.encode_png = self._timed(png, MARK_PREFIX + "png")
        self._route.compute_smooth_perturb = self._marked(
            route, MARK_PREFIX + "deep_route")
        return self

    def __exit__(self, *exc) -> None:
        (self._viewer.smooth_to_rgba, self._render.imsave_bytes,
         self._render.encode_png, self._route.compute_smooth_perturb) = \
            self._real


def render_args(cfg: dict, traffic: dict, view, out: Path, device: str,
                dtype: str) -> list[str]:
    (re, im), span = view
    args = ["render", "--deep", f"--center={re},{im}", "--span", repr(span),
            "--max-iter", str(cfg["max_iter"]), "--definition",
            str(traffic["definition"]), "--dtype", dtype, "--device", device,
            "--out", str(out), "-q"]
    if cfg["smooth"]:
        args.append("--smooth")
    return args


def check_view(cfg: dict, traffic: dict, view, nu: np.ndarray, png: bytes,
               rng: random.Random) -> dict:
    """One view against the references: its PNG pixel for pixel against
    the colours of its own smooth values; sampled pixels' smooth values
    against the exact ones.  A pixel is patched where its value is a
    whole number (the route patches a pixel glitched against both
    references with its escape count, by design; ``patched`` counts them
    among the uniform draw), and right where its value lies within
    ``off_by`` of the exact smooth value or, patched, equals the exact
    escape count.  Off: float64 rounding beyond
    ``off_by``, a wrong escape or patch, a glitch missed or left
    unrepaired (the route's design misses a few)."""
    nu = np.asarray(nu, dtype=np.float64)
    side = traffic["definition"]
    png_bad = int(np.any(ref_colormap.read_png_rgba8(png)
                         != ref_colormap.smooth_rgba8(nu, cfg["max_iter"]),
                         axis=-1).sum())
    picks = rng.sample(range(side * side), traffic["check"]["pixels"])
    uniform = len(picks)
    flat = nu.reshape(-1)
    deep = np.argsort(flat, kind="stable")[-traffic["check"]["deepest"]:]
    picks += [int(p) for p in deep if flat[p] > 0 and p not in picks]
    inside = np.flatnonzero(flat <= 0.0)
    if inside.size:
        picks.append(int(inside[rng.randrange(inside.size)]))
    off, patched = [], 0
    for i, p in enumerate(picks):
        row, col = divmod(p, side)
        want, count = ref_deep.smooth_pixel(
            *ref_deep.pixel_c(view[0], view[1], side, row, col),
            cfg["max_iter"])
        got = float(nu[row, col])
        whole = got > 0 and got == round(got)
        patched += whole and i < uniform
        if abs(got - want) > cfg["off_by"] and not (whole and got == count):
            off.append((row, col, got, want))
    return {"png_bad": png_bad, "off": off, "patched": patched,
            "uniform": uniform, "pixels": len(picks)}


def run(cell, *, seed: int, seconds: float, trace: bool, t_process: float,
        device: str = "cuda", control: bool = False) -> Record:
    import torch

    from distributedmandelbrot_tpu_torch import cli
    from distributedmandelbrot_tpu_torch.ops import perturbation

    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    dtype = cfg["control_dtype"] if control else cfg["dtype"]
    path = view_path(cfg, traffic["path"])
    rng = seeded(seed, "views")
    drawn = set(rng.sample(range(min(traffic["check"]["among_first"],
                                     len(path))),
                           traffic["check"]["views"]))
    tmp = Path(tempfile.mkdtemp(prefix="bench-views-"))
    sink = io.StringIO()
    failed = png_bytes = 0
    latencies, kept = [], {}
    try:
        with Taps(trace) as taps:
            # Set-up: one view of the configuration itself (not on the
            # walk): the kernels, the native library, the route's first
            # use.
            warm = ((cfg["center"][0], cfg["center"][1]), float(cfg["span"]))
            with contextlib.redirect_stdout(sink):
                if cli.main(render_args(cfg, traffic, warm, tmp / "warm.png",
                                        device, dtype)) != 0:
                    raise RuntimeError("the set-up view failed")
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            perturbation.reset_phase_seconds()
            taps.colormap_png_s = 0.0
            prof = Profiler(trace)
            setup_s = time.monotonic() - t_process
            with prof:
                with prof.window():
                    t0 = time.monotonic()
                    deadline = t0 + seconds
                    k = 0
                    while True:
                        view = path[k % len(path)]
                        out = tmp / f"view-{k % traffic['png_slots']}.png"
                        ts = time.monotonic()
                        try:
                            with contextlib.redirect_stdout(sink):
                                rc = cli.main(render_args(cfg, traffic, view,
                                                          out, device, dtype))
                        except Exception:
                            traceback.print_exc(file=sys.stderr)
                            rc = -1
                        te = time.monotonic()
                        sink.seek(0)
                        sink.truncate()
                        if rc != 0:
                            failed += 1
                        else:
                            latencies.append(te - ts)
                            png_bytes += out.stat().st_size
                        if rc == 0 and (k in drawn or te >= deadline):
                            kept[k] = (view, taps.last_nu, out.read_bytes())
                        k += 1
                        if te >= deadline:
                            break
                    attempted = k
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    t_end = time.monotonic()
            phases = perturbation.phase_seconds()
            colormap_png_s = taps.colormap_png_s
    finally:
        print(f"benchmark: the views wrote {png_bytes} bytes of PNG",
              file=sys.stderr)
        shutil.rmtree(tmp, ignore_errors=True)
    device_rec = chip.device_record(cell.chips, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # The check, once the window has closed: the drawn views, or the
    # last one where the window completed none of them.
    chosen = sorted(k for k in kept if k in drawn) or sorted(kept)[-1:]
    results = [check_view(cfg, traffic, kept[k][0], kept[k][1], kept[k][2],
                          rng) for k in chosen]
    pixels = sum(r["pixels"] for r in results)
    for k, r in zip(chosen, results):
        for row, col, got, want in r["off"]:
            print(f"benchmark: view {k} pixel ({row}, {col}): {got!r}, "
                  f"exact {want!r}", file=sys.stderr)
    limits = cfg["limits"]
    checks = {
        "png_pixels_differing": check(sum(r["png_bad"] for r in results),
                                      limits["png_pixels_differing"]),
        "smooth_off_share": check(
            sum(len(r["off"]) for r in results) / pixels if pixels else None,
            limits["smooth_off_share"]),
        "patched_share": check(
            sum(r["patched"] for r in results)
            / sum(r["uniform"] for r in results) if results else None,
            limits["patched_share"]),
    }
    correct = bool(results) and failed == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    return Record(
        correct=correct, attempted=attempted, failed=failed,
        device=device_rec,
        checks=checks, setup_s=setup_s, window_s=t_end - t0,
        latencies_s=latencies, kind="views", done=len(latencies),
        phases={name: phases.get(name, 0.0) for name in PHASES},
        colormap_png_s=colormap_png_s, trace=prof.trace,
        checked_views=len(results))
