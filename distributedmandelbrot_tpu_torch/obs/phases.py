"""Where a render's host time goes: named phases, each summed in
host-clock (``time.monotonic``) seconds with the number of times it was
entered, and named counts, for the whole process.  The keys are in
:mod:`~distributedmandelbrot_tpu_torch.obs.names` (``PHASE_*``,
``COUNT_*``).

``timed(key)`` times a block.  ``timed(key, annotate=True)`` also marks
the block in a ``torch.profiler`` trace, as ``dmtpu.<key>`` beside the
kernels on the trace's own clock, while a profiler is recording (and
opens no annotation otherwise).  Annotate only a block that launches no
device work: the profiler stretches an annotation over every kernel
launched inside it on the device timeline, so an annotated block that
launched work would read as device time, and its host time in between
would no longer read as the card's idle time.  A block that launches
work is timed on the host clock alone; its kernels name themselves in
the trace.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time

from distributedmandelbrot_tpu_torch.obs.names import PHASE_ANNOTATION_PREFIX

_lock = threading.Lock()
_seconds: dict[str, float] = {}
_entered: dict[str, int] = {}
_counts: dict[str, int] = {}


def phase_seconds() -> dict[str, float]:
    """Host-clock seconds spent so far in this process by phase, and each
    count (as a float) under its own key; a key appears once its phase
    was entered or its count added to.

    The deep route's phases: ``reference`` (the reference search: its
    orbits, probe scans and the orbit's upload), ``bla_probe`` (the
    auto-BLA probe), ``bla_table`` (building BLA tables; within
    ``repair_secondary`` when the secondary pass builds one), ``scan``
    (the row chunks' scans, each to its fetch, which waits for the
    device), ``repair_secondary`` (the secondary reference: its orbits
    and re-scan), ``repair_exact`` (the fixed-point recompute),
    ``deep.orbit`` (each fixed-point orbit computed, within
    ``reference`` or ``repair_secondary``; cached orbits are not) and
    ``deep.probe`` (each probe lattice's scan to its read-back, within
    ``reference``); the counts ``glitched`` (pixels flagged),
    ``exact_repaired`` (pixels left to the exact repair),
    ``deep.lane_steps`` (the steps the smooth scans' lanes needed, each
    to its bailout crossing or the orbit's end, summed on the device and
    read once a view), ``deep.k10_tiles`` (the orbit tiles K10's blocks
    staged, read with it; only where K10 ran) and ``deep.bla_views`` (1
    for a view that took BLA, 0 for one that did not: present once a
    deep view ran).  A
    render's: ``render.parse`` (its arguments), ``render.colormap``,
    ``render.rgba8`` (float RGBA to uint8; a pass-through for a view
    coloured straight to uint8), ``render.deflate`` (the PNG's
    encoding) and ``render.write`` (the file); the count
    ``render.deflate_bands`` (the row bands the PNGs' deflate took, 1
    for an image of one band)."""
    with _lock:
        out = dict(_seconds)
        out.update({k: float(v) for k, v in _counts.items()})
        return out


def phase_entries() -> dict[str, int]:
    """The times each phase was entered so far in this process: for
    ``deep.orbit``, the fixed-point orbits computed (cache hits enter
    no phase)."""
    with _lock:
        return dict(_entered)


def reset_phase_seconds() -> None:
    """Set every phase's seconds and entries, and every count, to none."""
    with _lock:
        _seconds.clear()
        _entered.clear()
        _counts.clear()


def _recording() -> bool:
    # No profiler records in a process that has not imported torch.
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


@contextlib.contextmanager
def timed(key: str, annotate: bool = False):
    """Add the block's host-clock seconds and one entry to phase
    ``key``; with ``annotate``, mark it ``dmtpu.<key>`` in a recording
    ``torch.profiler`` trace (only for a block that launches no device
    work)."""
    mark = contextlib.nullcontext()
    t0 = time.monotonic()
    if annotate and _recording():
        from torch.profiler import record_function
        mark = record_function(PHASE_ANNOTATION_PREFIX + key)
    try:
        with mark:
            yield
    finally:
        dt = time.monotonic() - t0
        with _lock:
            _seconds[key] = _seconds.get(key, 0.0) + dt
            _entered[key] = _entered.get(key, 0) + 1


def tally(key: str, n: int) -> None:
    """Add ``n`` to count ``key``."""
    with _lock:
        _counts[key] = _counts.get(key, 0) + int(n)
