"""Each cell's check against the faults it can have: a run past the look
for a card, on the CPU at a tiny size, with the timed path broken
underneath, must come out not correct; the same run unbroken, correct.

The drains can leave half a fused batch out or alter a chunk where it is
produced; a deep view can alter its smooth values where the route
produces them, its PNG where it is encoded, or skip the glitch repairs.
The drain's control (the plain loop in bfloat16) runs here too, its
chunks kept by the program's rule.  A step that returns its
state unchanged and an exchange between cards are faults of training
and of several cards, which no cell here has.
"""

from __future__ import annotations

import numpy as np
import pytest

from conftest import run_cpu


@pytest.mark.parametrize("cell", ["tiny.drain-inproc", "tinydeep.views-48",
                                  "tinyglitch.views-32"])
def test_sound_run_is_correct(tiny_root, cell):
    rec, result = run_cpu(tiny_root, cell)
    assert result["correct"] is True, result["checks"]
    assert rec.done >= 1


def _altered_chunk(monkeypatch):
    from distributedmandelbrot_tpu_torch.worker import backends
    real = backends.CudaBackend.materialize_tile

    def materialize(self, handle):
        px = np.array(real(self, handle), copy=True)
        px[12345] ^= 0x40
        return px
    monkeypatch.setattr(backends.CudaBackend, "materialize_tile",
                        materialize)


def _half_batch_left_out(monkeypatch):
    from distributedmandelbrot_tpu_torch.worker import backends
    real = backends.CudaBackend.dispatch_many

    def dispatch_many(self, workloads, device=None):
        half = len(workloads) // 2 or 1
        handles = real(self, workloads[:half], device)
        # The rest: the first tile's pixels stand in for theirs.
        return handles + [real(self, workloads[:1], device)[0]
                          for _ in workloads[half:]]
    monkeypatch.setattr(backends.CudaBackend, "dispatch_many",
                        dispatch_many)


@pytest.mark.parametrize("fault", [_altered_chunk, _half_batch_left_out])
def test_drain_faults_fail_the_check(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    _, result = run_cpu(tiny_root, "tiny.drain-inproc")
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["bytes_differing"]["value"] > 0


def test_altered_smooth_values_fail_the_check(tiny_root, monkeypatch):
    from distributedmandelbrot_tpu_torch.ops import perturbation
    real = perturbation.compute_smooth_perturb

    def altered(*args, **kwargs):
        nu, glitched = real(*args, **kwargs)
        return np.where(nu > 0, nu + 0.01, nu), glitched
    monkeypatch.setattr(perturbation, "compute_smooth_perturb", altered)
    _, result = run_cpu(tiny_root, "tinydeep.views-48")
    assert result["correct"] is False
    assert result["checks"]["smooth_off_share"]["value"] > \
        result["checks"]["smooth_off_share"]["limit"]


def test_altered_png_fails_the_check(tiny_root, monkeypatch):
    from distributedmandelbrot_tpu_torch.serve import render
    real = render.imsave_bytes

    def altered(rgba):
        out = np.array(real(rgba), copy=True)
        out[3, 5, 1] ^= 0x10
        return out
    monkeypatch.setattr(render, "imsave_bytes", altered)
    _, result = run_cpu(tiny_root, "tinydeep.views-48")
    assert result["correct"] is False
    assert result["checks"]["png_pixels_differing"]["value"] > 0


def test_drain_control_under_the_programs_keep_rule_is_not_correct(
        tiny_root):
    # The plain loop in bfloat16 as the backend, its chunks kept by the
    # same rule as the program's.
    rec, result = run_cpu(tiny_root, "tiny.drain-inproc", control=True)
    assert rec.checked == 4
    assert result["checks"]["sampled_chunks_missing"]["value"] == 0
    assert result["correct"] is False
    assert result["checks"]["bytes_differing"]["value"] > 0


def test_skipped_glitch_repairs_fail_the_check(tiny_root, monkeypatch):
    # The scans' glitch flags dropped: no pixel is repaired, and the
    # view's deepest pixels keep the primary reference's values.
    from distributedmandelbrot_tpu_torch.ops import perturbation
    real = perturbation._fetch

    def unflagged(values, glitched):
        got, flags = real(values, glitched)
        return got, np.zeros_like(flags)
    monkeypatch.setattr(perturbation, "_fetch", unflagged)
    _, result = run_cpu(tiny_root, "tinyglitch.views-32")
    assert result["correct"] is False
    assert result["checks"]["smooth_off_share"]["value"] > \
        result["checks"]["smooth_off_share"]["limit"]


def test_integer_counts_for_smooth_values_fail_the_check(tiny_root,
                                                         monkeypatch):
    # The smooth route answering with the exact integer counts (the
    # repair's values) for every pixel.
    from distributedmandelbrot_tpu_torch.ops import perturbation

    def integer(spec, max_iter, **kwargs):
        kwargs.pop("bailout", None)
        counts, glitched = perturbation.compute_counts_perturb(
            spec, max_iter, **kwargs)
        return counts.astype(np.float64), glitched
    monkeypatch.setattr(perturbation, "compute_smooth_perturb", integer)
    _, result = run_cpu(tiny_root, "tinydeep.views-48")
    assert result["correct"] is False
    assert result["checks"]["patched_share"]["value"] > \
        result["checks"]["patched_share"]["limit"]
