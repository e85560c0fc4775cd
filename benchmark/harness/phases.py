"""The program's own phase tally of a views window (the port's
``obs/phases.py``), for the readers of its spans.

The tally is the process's, read once the run has ended.  It is the
window's because ``benchmark/drivers/views.py`` resets it just before
the window (``perturbation.reset_phase_seconds()``, beside
``taps.colormap_png_s = 0.0``) and runs no code of the program after
the window: its check renders the drawn views with ``benchmark/
reference/`` alone.  A program without the facility has no such tally:
its readers report nothing.
"""

from __future__ import annotations


def _phases():
    try:
        from distributedmandelbrot_tpu_torch.obs import phases
    except ImportError:
        return None
    return phases


def per_view_ms(rec, key: str) -> float | None:
    """Milliseconds a view in phase ``key`` over the window (0 where no
    view entered it)."""
    phases = _phases()
    if rec.kind != "views" or not rec.done or phases is None:
        return None
    return phases.phase_seconds().get(key, 0.0) / rec.done * 1e3


def per_view_entries(rec, key: str) -> float | None:
    """The times a view entered phase ``key`` over the window (0 where
    no view entered it)."""
    phases = _phases()
    if rec.kind != "views" or not rec.done or phases is None:
        return None
    return phases.phase_entries().get(key, 0) / rec.done
