"""``animate`` of the port against the JAX package's on the CPU: a zoom
from span 4 to 1e-14 at 64^2 in five frames, integer and smooth, each
frame held to the JAX package's frame at the bar of
``tests/test_torch_render.py``, the per-frame routes equal, and the
dtype the sweep resolves equal to the JAX package's."""

import argparse
import itertools
import re

import numpy as np
import pytest
from PIL import Image

from distributedmandelbrot_tpu import cli as ref_cli
from distributedmandelbrot_tpu.ops import pallas_escape as pe
from distributedmandelbrot_tpu_torch import cli
from distributedmandelbrot_tpu_torch.serve import render as srender

# The seahorse valley's Misiurewicz point: boundary at every depth.
CENTER = ("-0.743643887037158704752191506114774",
          "0.131825904205311970493132056385139")
SWEEP = ["--center", ",".join(CENTER), "--span-start", "4", "--span-end",
         "1e-14", "--frames", "5", "--definition", "64", "--max-iter", "300",
         "--max-iter-end", "4000"]
FRAME_LINE = re.compile(r"^frame (\d+)/(\d+) span (\S+) mi (\d+)( \(deep\))?")


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX package's direct frames on its Pallas kernels, forced on
    in interpret mode (``block_h=32``), as ``tests/test_torch_render.py``
    runs them."""
    monkeypatch.setattr(pe, "pallas_available", lambda: True)
    for name in ("compute_tile_pallas", "compute_tile_smooth_pallas"):
        real = getattr(pe, name)
        monkeypatch.setattr(pe, name, lambda *a, _real=real, **k: _real(
            *a, **{**k, "interpret": True, "block_h": 32}))


@pytest.fixture
def _jax_fixed_point_in_python(monkeypatch):
    """The JAX package's fixed-point functions on their Python path: its
    native build is left to its own tests."""
    from distributedmandelbrot_tpu.ops import perturbation as ref_pt
    monkeypatch.setattr(ref_pt, "_native_fixed", lambda *a, **k: False)


def _frames(out: str) -> list[tuple]:
    """(frame, span text, budget, deep) of each progress line."""
    return [(int(m[1]), m[3], int(m[4]), bool(m[5]))
            for m in map(FRAME_LINE.match, out.splitlines()) if m]


def _differ(a, b) -> float:
    return float((a != b).any(axis=-1).mean())


@pytest.mark.parametrize("smooth", [False, True], ids=["integer", "smooth"])
def test_animate_against_the_jax_animate(tmp_path, capsys, pallas_interpret,
                                         _jax_fixed_point_in_python, smooth):
    """Each frame of the port's animation (the kernels' plain versions,
    ``--device cpu``) against the JAX package's (its Pallas kernels in
    interpret mode), both held to the JAX package's f64 render of the
    frame's view on the same route: the share of pixels whose colour
    differs from it at most the JAX frame's own plus 0.5 percentage
    points.  Both take the same route per frame (three deep frames),
    with the same spans and budgets.  The integer run also writes the
    frames as a GIF."""
    flags = SWEEP + (["--smooth"] if smooth else [])
    gif = tmp_path / "zoom.gif"
    assert cli.main(["animate", *flags, "--device", "cpu", "--out-dir",
                     str(tmp_path / "port"), "-q"]
                    + ([] if smooth else ["--gif", str(gif)])) == 0
    port_lines = _frames(capsys.readouterr().out)
    assert ref_cli.cmd_animate([*flags, "--out-dir", str(tmp_path / "jax"),
                                "-q"]) == 0
    jax_lines = _frames(capsys.readouterr().out)
    assert port_lines == jax_lines
    assert [deep for *_, deep in port_lines] == [False, False, True, True,
                                                 True]
    np_dtype = cli._resolve_dtype(argparse.Namespace(
        dtype=None, smooth=smooth, span_start=4.0, span_end=1e-14,
        definition=64), center=(float(CENTER[0]), float(CENTER[1])),
        can_perturb=True)
    assert np_dtype == np.float32  # the sweep crosses 1e-12
    for f, span, mi, deep in port_lines:
        name = f"frame_{f - 1:04d}.png"
        got = np.asarray(Image.open(tmp_path / "port" / name))
        want = np.asarray(Image.open(tmp_path / "jax" / name))
        anchor = srender.imsave_bytes(np.asarray(ref_cli._render_view(
            *CENTER, 4.0 * ((1e-14 / 4.0) ** (1.0 / 4)) ** (f - 1), 64, mi,
            smooth=smooth, np_dtype=np.float64, colormap="jet", deep=deep,
            no_pallas=True)))
        assert got.shape == want.shape == anchor.shape == (64, 64, 4)
        ours, theirs = _differ(got, anchor), _differ(want, anchor)
        print(f"frame {f} span {span} mi {mi} deep {deep}: port "
              f"{ours:.4%}, JAX {theirs:.4%} off the f64 render; "
              f"{_differ(got, want):.4%} between them")
        assert ours <= theirs + 0.005, (f, ours, theirs)
        assert len(np.unique(got.reshape(-1, 4), axis=0)) > 4  # not flat
    if not smooth:
        with Image.open(gif) as img:
            assert img.n_frames == 5


def test_resolve_dtype_follows_the_reference_on_sweeps():
    """``_resolve_dtype`` equals the JAX package's on a table of sweeps,
    renders and flags: spans and sweep ends above, at and below the
    1e-12 threshold, at either end, sweeps whose finer end f32 cannot
    resolve, smooth or not, any ``--dtype``, with or without a
    perturbation route."""
    center = (float(CENTER[0]), float(CENTER[1]))
    ends = (4.0, 1e-5, 1e-12, 9.9e-13, 1e-14)
    cases = 0
    for start, end in itertools.product(ends, ends):
        for smooth, dtype, perturb, definition in itertools.product(
                (False, True), (None, "f32", "f64"), (False, True),
                (64, 1024)):
            args = argparse.Namespace(span_start=start, span_end=end,
                                      smooth=smooth, dtype=dtype,
                                      definition=definition)
            assert cli._resolve_dtype(args, center=center,
                                      can_perturb=perturb) == \
                ref_cli._resolve_dtype(args, center=center,
                                       can_perturb=perturb), vars(args)
            cases += 1
    for span, deep in itertools.product((3.0, 1e-7, 1e-13), (False, True)):
        args = argparse.Namespace(span=span, deep=deep, smooth=True,
                                  dtype=None, definition=1024)
        assert cli._resolve_dtype(args, center=center) == \
            ref_cli._resolve_dtype(args, center=center)
    assert cases == 600


def test_animate_refusals(tmp_path):
    out = ["--out-dir", str(tmp_path), "--device", "cpu"]
    with pytest.raises(SystemExit, match="frames"):
        cli.main(["animate", "--center=0,0", "--frames", "0", *out])
    with pytest.raises(SystemExit, match="positive"):
        cli.main(["animate", "--center=0,0", "--span-end", "0", *out])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli.main(["animate", "--center=0,0", "--bla", "--no-bla", *out])
    with pytest.raises(SystemExit, match="no perturbation"):
        cli.main(["animate", "--center=0,0", "--fractal", "ship",
                  "--span-start", "1e-13", *out])
    with pytest.raises(SystemExit, match="carries"):
        cli.main(["animate", "--center=0,0", "--colormap", "magma", *out])
    with pytest.raises(SystemExit) as exc:
        cli.main(["animate"])  # --center and --out-dir are required
    assert exc.value.code == 2
