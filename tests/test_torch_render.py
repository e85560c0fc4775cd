"""The render slice as a whole, against the JAX package on the CPU: the
torch Julia, family and smooth loops, the colormap core and PNG writer
(against matplotlib, which the port does not need), and ``render`` end
to end (``--device cpu``: the kernels' plain versions) against the JAX
package's ``_render_view`` with its Pallas kernels in interpret mode."""

import io

import numpy as np
import pytest
import torch
from PIL import Image

from distributedmandelbrot_tpu import cli as ref_cli
from distributedmandelbrot_tpu.core.geometry import TileSpec as RefSpec
from distributedmandelbrot_tpu.ops import escape_time as ref_et
from distributedmandelbrot_tpu.ops import families as ref_fam
from distributedmandelbrot_tpu.ops import pallas_escape as pe
from distributedmandelbrot_tpu.ops import reference as golden
from distributedmandelbrot_tpu.serve import render as ref_render
from distributedmandelbrot_tpu.viewer import render as ref_viewer
from distributedmandelbrot_tpu_torch import cli
from distributedmandelbrot_tpu_torch.core.geometry import TileSpec
from distributedmandelbrot_tpu_torch.ops import cuda_escape as ce
from distributedmandelbrot_tpu_torch.ops import escape_time as et
from distributedmandelbrot_tpu_torch.ops import families as fam
from distributedmandelbrot_tpu_torch.serve import render as srender
from distributedmandelbrot_tpu_torch.viewer import render as viewer

JULIA_C = complex(-0.8, 0.156)
FAMILIES = {"multibrot3": (3, False), "multibrot5": (5, False),
            "ship": (2, True)}
VIEWS = {"full": (-1.5, -1.5, 3.0), "edge": (-0.8, 0.05, 0.3),
         "ship_antenna": (-1.8, -0.08, 0.1)}


def _specs(view, width=128, height=128):
    x, y, s = VIEWS[view]
    return (TileSpec(x, y, s, s, width=width, height=height),
            RefSpec(x, y, s, s, width=width, height=height))


def _golden_counts(ref_spec, max_iter, julia_c=None, family=None):
    cr, ci = ref_spec.grid_2d()
    if julia_c is not None:
        return golden.escape_counts_julia(cr, ci, julia_c, max_iter)
    if family is not None:
        return golden.escape_counts_family(cr, ci, max_iter,
                                           power=family[0],
                                           burning=family[1])
    return golden.escape_counts(cr, ci, max_iter)


# --- the torch loops ---------------------------------------------------


@pytest.mark.parametrize("max_iter", [300, 1500])
@pytest.mark.parametrize("view", ["full", "edge"])
def test_julia_f64_is_bitwise_the_golden(view, max_iter):
    spec, ref_spec = _specs(view)
    got = et.compute_tile_julia(spec, JULIA_C, max_iter,
                                dtype=torch.float64, device="cpu")
    want = golden.scale_counts_to_uint8(
        _golden_counts(ref_spec, max_iter, julia_c=JULIA_C), max_iter)
    assert np.array_equal(got, want.ravel())


@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_f64_is_bitwise_the_golden(family, view):
    """The interior shortcut (cardioid/bulb, the Multibrot's disk) and
    the cycle probe (budget 1500) change no pixel."""
    spec, ref_spec = _specs(view)
    power, burning = FAMILIES[family]
    for max_iter in (300, 1500):
        got = fam.compute_tile_family(spec, max_iter, power=power,
                                      burning=burning, dtype=torch.float64,
                                      device="cpu")
        want = golden.scale_counts_to_uint8(
            _golden_counts(ref_spec, max_iter, family=(power, burning)),
            max_iter)
        assert np.array_equal(got, want.ravel()), max_iter


@pytest.mark.parametrize("mode", ["julia"] + sorted(FAMILIES))
def test_f32_loops_against_the_jax_loops(mode):
    """f32, where XLA:CPU contracts mul+add into FMAs and the port does
    not: the port's mismatch against the f64 golden at most the JAX
    loop's own plus 0.5 percentage points."""
    for view in ("full", "edge"):
        spec, ref_spec = _specs(view)
        if mode == "julia":
            got = et.compute_tile_julia(spec, JULIA_C, 300, device="cpu")
            ref = ref_et.compute_tile_julia(ref_spec, JULIA_C, 300)
            gold = _golden_counts(ref_spec, 300, julia_c=JULIA_C)
        else:
            power, burning = FAMILIES[mode]
            got = fam.compute_tile_family(spec, 300, power=power,
                                          burning=burning, device="cpu")
            ref = ref_fam.compute_tile_family(ref_spec, 300, power=power,
                                              burning=burning)
            gold = _golden_counts(ref_spec, 300, family=(power, burning))
        gold = golden.scale_counts_to_uint8(gold, 300).ravel()
        ours = float((got != gold).mean())
        theirs = float((ref != gold).mean())
        assert ours <= theirs + 0.005, (mode, view, ours, theirs)


def _numpy_smooth(zr, zi, cr, ci, max_iter, *, power=2, burning=False,
                  bailout=256.0, segment=32):
    """A plain numpy f64 smooth loop, written from the reference's
    semantics: z freezes at its first crossing of the bailout radius, a
    sticky radius-2 count decides what is in the set, and a live pixel
    runs whole ``segment``-step segments while within ``max_iter - 1 +
    extra`` steps."""
    dyn = max_iter - 1
    extra = 8 + int(np.ceil(np.log2(np.log2(max(bailout, 4.0)))))
    bound = dyn + extra
    seg = max(1, min(segment, bound))
    zr, zi = zr.astype(np.float64).copy(), zi.astype(np.float64).copy()
    live = np.ones(zr.shape, bool)
    in2 = np.ones(zr.shape, bool)
    n = np.zeros(zr.shape, np.int64)
    n2 = np.zeros(zr.shape, np.int64)
    for _ in range(seg * -(-bound // seg)):
        ar, ai = (np.abs(zr), np.abs(zi)) if burning else (zr, zi)
        wr, wi = ar, ai
        for _ in range(power - 1):
            wr, wi = wr * ar - wi * ai, wr * ai + wi * ar
        zr = np.where(live, wr + cr, zr)
        zi = np.where(live, wi + ci, zi)
        m2 = zr * zr + zi * zi
        live &= m2 < bailout * bailout
        n += live
        in2 &= m2 < 4.0
        n2 += in2
    with np.errstate(over="ignore", invalid="ignore"):
        mag2 = np.clip(np.nan_to_num(zr * zr + zi * zi, nan=np.inf),
                       bailout * bailout, np.finfo(np.float64).max)
    corr = np.log2(np.log(mag2) / (2.0 * np.log(bailout)))
    if power != 2:
        corr = corr / np.log2(power)
    return np.where(n2 >= dyn, 0.0, (n + 2) - corr)


@pytest.mark.parametrize("mode", ["mandelbrot", "julia", "multibrot3",
                                  "ship"])
def test_smooth_f64_against_a_numpy_golden(mode):
    """f64 smooth values: in-set exactly where the golden's count is 0,
    and nu within 1e-9 of a plain numpy loop (the two logarithms may
    differ in the last place)."""
    spec, ref_spec = _specs("full")
    cr, ci = ref_spec.grid_2d()
    if mode == "julia":
        got = et.compute_tile_smooth(spec, 300, julia_c=JULIA_C,
                                     device="cpu")
        want = _numpy_smooth(cr, ci, JULIA_C.real, JULIA_C.imag, 300)
        gold = _golden_counts(ref_spec, 300, julia_c=JULIA_C)
    elif mode == "mandelbrot":
        got = et.compute_tile_smooth(spec, 300, device="cpu")
        want = _numpy_smooth(cr, ci, cr, ci, 300)
        gold = _golden_counts(ref_spec, 300)
    else:
        power, burning = FAMILIES[mode]
        got = fam.compute_tile_smooth_family(spec, 300, power=power,
                                             burning=burning, device="cpu")
        want = _numpy_smooth(cr, ci, cr, ci, 300, power=power,
                             burning=burning)
        gold = _golden_counts(ref_spec, 300, family=(power, burning))
    assert got.dtype == np.float64 and got.shape == (128, 128)
    assert np.array_equal(got == 0, gold == 0)
    assert float(np.abs(got - want).max()) <= 1e-9


@pytest.mark.parametrize("mode", ["mandelbrot", "julia", "multibrot3",
                                  "ship"])
def test_smooth_f32_against_the_jax_loop(mode):
    """f32 smooth values against the JAX XLA smooth loop: in-set masks
    held to the golden (the port's mismatch at most the JAX loop's plus
    0.5 pp) and, against the f64 loop where both escape, the port's
    share within 2% at most 0.5 pp below the JAX loop's."""
    spec, ref_spec = _specs("edge")
    f32 = torch.float32
    if mode == "julia":
        got = et.compute_tile_smooth(spec, 300, dtype=f32, julia_c=JULIA_C,
                                     device="cpu")
        ref = ref_et.compute_tile_smooth(ref_spec, 300, dtype=np.float32,
                                         julia_c=JULIA_C)
        nu64 = ref_et.compute_tile_smooth(ref_spec, 300, julia_c=JULIA_C)
        gold = _golden_counts(ref_spec, 300, julia_c=JULIA_C)
    elif mode == "mandelbrot":
        got = et.compute_tile_smooth(spec, 300, dtype=f32, device="cpu")
        ref = ref_et.compute_tile_smooth(ref_spec, 300, dtype=np.float32)
        nu64 = ref_et.compute_tile_smooth(ref_spec, 300)
        gold = _golden_counts(ref_spec, 300)
    else:
        power, burning = FAMILIES[mode]
        got = fam.compute_tile_smooth_family(spec, 300, power=power,
                                             burning=burning, dtype=f32,
                                             device="cpu")
        ref = ref_fam.compute_tile_smooth_family(
            ref_spec, 300, power=power, burning=burning, dtype=np.float32)
        nu64 = ref_fam.compute_tile_smooth_family(ref_spec, 300, power=power,
                                                  burning=burning)
        gold = _golden_counts(ref_spec, 300, family=(power, burning))
    assert got.dtype == np.float32
    inset = gold == 0
    assert float(((got == 0) != inset).mean()) <= \
        float(((ref == 0) != inset).mean()) + 0.005

    def within_2pct(nu):
        both = (nu > 0) & (nu64 > 0)
        rel = np.abs(nu[both] - nu64[both]) / np.maximum(nu64[both], 1.0)
        return float((rel < 0.02).mean())

    assert within_2pct(got) >= within_2pct(ref) - 0.005


def test_smooth_cycle_probe_and_interior_change_no_value():
    spec, _ = _specs("edge")
    cr, ci = et.spec_grid(spec, torch.float64, "cpu")
    base = et.escape_smooth(cr, ci, max_iter=2000, interior_check=False,
                            cycle_check=False)
    for interior in (False, True):
        got = et.escape_smooth(cr, ci, max_iter=2000,
                               interior_check=interior, cycle_check=True)
        assert torch.equal(got, base)


def test_interior_tests_follow_the_reference():
    rng = np.random.default_rng(11)
    cr = rng.uniform(-1.2, 1.2, 100_000)
    ci = rng.uniform(-1.2, 1.2, 100_000)
    for dtype in (np.float32, np.float64):
        a, b = cr.astype(dtype), ci.astype(dtype)
        for power in (3, 4, 7):
            want = np.asarray(ref_et.multibrot_interior(a, b, power))
            got = et.family_interior(torch.from_numpy(a),
                                     torch.from_numpy(b), power=power)
            assert np.array_equal(got.numpy(), want), (dtype, power)
            assert want.any()
        assert et.family_interior(torch.from_numpy(a), torch.from_numpy(b),
                                  burning=True) is None
    for power in (2, 3, 6):
        assert et.multibrot_interior_radius(power) == \
            ref_et.multibrot_interior_radius(power)


# --- colormap core and PNG writer -------------------------------------


def test_jet_table_and_float_mapping_are_matplotlibs():
    """The carried jet LUT and ``Colormap.__call__``'s float mapping,
    bitwise: all 256 byte values through the viewer pipeline, a float
    sweep with the edges, out-of-range values and NaN."""
    import matplotlib
    cmap = matplotlib.colormaps["jet"]
    values = np.arange(256, dtype=np.uint8).reshape(16, 16)
    assert np.array_equal(srender.value_to_rgba(values),
                          ref_render.value_to_rgba(values))
    assert np.array_equal(srender.value_to_rgba(values.ravel()),
                          ref_render.value_to_rgba(values.ravel()))
    x = np.concatenate([np.linspace(-0.25, 1.25, 200_001),
                        [0.0, 1.0, np.nextafter(1.0, 0.0), 255 / 256,
                         1 / 256, np.nan, -np.inf, np.inf]])
    assert np.array_equal(srender.apply_colormap(x), cmap(x))
    rng = np.random.default_rng(5)
    nu = rng.uniform(-2.0, 600.0, (64, 64))
    nu[::5] = 0.0
    for normalize in (False, True):
        assert np.array_equal(
            srender.smooth_to_rgba(nu, 300, normalize=normalize),
            ref_render.smooth_to_rgba(nu, 300, normalize=normalize))
    rgba = srender.value_to_rgba(values)
    assert np.array_equal(srender.to_rgba8(rgba), ref_render.to_rgba8(rgba))
    with pytest.raises(ValueError, match="not carried"):
        srender.colormap_table("magma")


def test_png_writer_matches_plt_imsave(tmp_path):
    """Decode both PNGs: the same RGBA8 pixels as ``plt.imsave`` writes
    for a float RGBA image (truncation; a NaN pixel stored as 0)."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    rng = np.random.default_rng(3)
    values = rng.integers(0, 256, (40, 56)).astype(np.uint8)
    rgba = (srender.value_to_rgba(values)
            + srender.smooth_to_rgba(rng.uniform(0, 300, (40, 56)), 300)) / 2
    rgba[3, 4, 1] = np.nan
    rgba[0, 0] = (0.0, 1.0, 0.5, 1.0)
    ref_path = tmp_path / "ref.png"
    plt.imsave(ref_path, rgba)
    want = np.asarray(Image.open(ref_path))
    got = np.asarray(Image.open(io.BytesIO(
        srender.encode_png(srender.imsave_bytes(rgba)))))
    assert got.shape == (40, 56, 4) and got.dtype == np.uint8
    assert np.array_equal(got, want)
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        srender.imsave_bytes(rgba * 2)


def test_stitch_level_matches_the_reference():
    chunks = {(i, j): np.full(16, 10 * i + j, np.uint8)
              for i in range(3) for j in range(3) if (i, j) != (1, 2)}
    fetch = chunks.get
    got = viewer.stitch_level(lambda i, j: fetch((i, j)), 3, chunk_width=4,
                              fill_value=7)
    want = ref_viewer.stitch_level(lambda i, j: fetch((i, j)), 3,
                                   chunk_width=4, fill_value=7)
    assert np.array_equal(got, want)


# --- render end to end -------------------------------------------------


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX package's render with its Pallas kernels forced on, in
    interpret mode (``block_h=32``), counting the calls that returned."""
    calls = []
    monkeypatch.setattr(pe, "pallas_available", lambda: True)
    for name in ("compute_tile_pallas", "compute_tile_julia_pallas",
                 "compute_tile_family_pallas", "compute_tile_smooth_pallas",
                 "compute_tiles_packed_pallas"):
        real = getattr(pe, name)

        def forced(*a, _real=real, _name=name, **k):
            out = _real(*a, **{**k, "interpret": True, "block_h": 32})
            calls.append(_name)
            return out

        monkeypatch.setattr(pe, name, forced)
    return calls


# (name, flags, JAX _render_view keywords, reference kernel).
RENDERS = [
    ("mandelbrot", [], dict(), "compute_tile_pallas"),
    ("julia", ["--fractal", "julia"], dict(julia_c=("-0.8", "0.156")),
     "compute_tile_julia_pallas"),
    ("multibrot3", ["--fractal", "multibrot"], dict(family=(3, False)),
     "compute_tile_family_pallas"),
    ("ship", ["--fractal", "ship"], dict(family=(2, True)),
     "compute_tile_family_pallas"),
    ("mandelbrot_smooth", ["--smooth", "--dtype", "f32"], dict(smooth=True),
     "compute_tile_smooth_pallas"),
    ("julia_smooth", ["--fractal", "julia", "--smooth", "--dtype", "f32"],
     dict(smooth=True, julia_c=("-0.8", "0.156")),
     "compute_tile_smooth_pallas"),
    ("multibrot3_smooth", ["--fractal", "multibrot", "--smooth", "--dtype",
                           "f32"], dict(smooth=True, family=(3, False)),
     "compute_tile_smooth_pallas"),
    ("ship_smooth", ["--fractal", "ship", "--smooth", "--dtype", "f32"],
     dict(smooth=True, family=(2, True)), "compute_tile_smooth_pallas"),
    ("mandelbrot_ss4", ["--supersample", "4"], dict(supersample=4),
     "compute_tiles_packed_pallas"),
    ("ship_ss2", ["--fractal", "ship", "--supersample", "2"],
     dict(supersample=2, family=(2, True)), "compute_tiles_packed_pallas"),
]
# A view with structure (boundary, interior and escaping pixels) per
# fractal: (center real, center imag, span); budget 400, 128^2.
FRACTAL_VIEWS = {"mandelbrot": ("-0.745", "0.11", 0.05),
                 "julia": ("-0.3", "0.2", 0.5),
                 "multibrot": ("-0.45", "0.55", 0.2),
                 "ship": ("-1.76", "-0.02", 0.05)}


def _fractal(flags):
    return flags[flags.index("--fractal") + 1] if "--fractal" in flags \
        else "mandelbrot"


def _port_render(tmp_path, flags, name="out.png"):
    cx, cy, span = FRACTAL_VIEWS[_fractal(flags)]
    out = tmp_path / name
    assert cli.main(["render", f"--center={cx},{cy}", "--span", str(span),
                     "--max-iter", "400", *flags, "--definition", "128",
                     "--device", "cpu", "--out", str(out), "-q"]) == 0
    return np.asarray(Image.open(out))


def _ref_render(flags, **kw):
    cx, cy, span = FRACTAL_VIEWS[_fractal(flags)]
    ref_kw = dict(smooth=False, np_dtype=np.float32, colormap="jet",
                  deep=None, julia_c=None, family=None, no_pallas=False,
                  normalize=False, supersample=1)
    ref_kw.update(kw)
    return srender.imsave_bytes(np.asarray(
        ref_cli._render_view(cx, cy, span, 128, 400, **ref_kw)))


def _differ(a, b) -> float:
    """Share of pixels whose RGBA8 color differs."""
    return float((a != b).any(axis=-1).mean())


@pytest.mark.parametrize("name,flags,kw,kernel", RENDERS,
                         ids=[r[0] for r in RENDERS])
def test_render_against_the_jax_render(tmp_path, pallas_interpret, name,
                                       flags, kw, kernel):
    """The port's render on the kernels' plain versions against the JAX
    package's on its interpret-mode Pallas kernels, both held to the
    reference's f64 render (its XLA loops at f64): the share of pixels
    whose color differs from it at most the reference's own plus 0.5
    percentage points per sample (the slice's golden bar; the FMA
    contraction of the reference's CPU run moves chaotic boundary
    pixels, most on the Burning Ship's folds).  The port launches
    nothing on the CPU and declines nothing."""
    cli.reset_kernel_declines()
    got = _port_render(tmp_path, flags)
    assert cli.kernel_declines() == {}
    want = _ref_render(flags, **kw)
    assert kernel in pallas_interpret, "the reference declined its kernel"
    anchor = _ref_render(flags, **{**kw, "np_dtype": np.float64,
                                   "no_pallas": True})
    assert got.shape == want.shape == anchor.shape == (128, 128, 4)
    ours, theirs = _differ(got, anchor), _differ(want, anchor)
    print(f"{name}: port {ours:.4%}, reference {theirs:.4%} off the f64 "
          f"render; {_differ(got, want):.4%} between them")
    assert ours <= theirs + 0.005 * kw.get("supersample", 1), \
        (name, ours, theirs)


@pytest.mark.parametrize("flags,kw", [
    ([], dict()),
    (["--fractal", "multibrot"], dict(family=(3, False))),
    (["--fractal", "julia", "--smooth"],
     dict(smooth=True, np_dtype=np.float64, julia_c=("-0.8", "0.156"))),
    (["--smooth", "--supersample", "2"],
     dict(smooth=True, np_dtype=np.float64, supersample=2)),
], ids=["mandelbrot", "multibrot3", "julia_smooth_f64", "smooth_f64_ss2"])
def test_no_kernel_against_no_pallas(tmp_path, flags, kw):
    """``--no-kernel`` takes the torch loops on the host grid, as
    ``no_pallas`` takes the XLA loops: f32 integer renders within the
    2% golden bar, f64 smooth renders within 0.1% (f64 leaves only the
    contraction of the reference's XLA:CPU loop)."""
    got = _port_render(tmp_path, [*flags, "--no-kernel"])
    want = _ref_render(flags, no_pallas=True, **kw)
    differ = float((got != want).any(axis=-1).mean())
    print(f"{flags}: {differ:.4%} of pixels differ")
    tol = 0.001 if kw.get("np_dtype") == np.float64 else 0.02
    assert differ <= tol * kw.get("supersample", 1), differ


def test_supersample_packed_equals_sequential(tmp_path, monkeypatch):
    """The packed route (one K5 call for all samples) writes exactly the
    image of the sequential per-sample route (K1 per sample)."""
    packed = _port_render(tmp_path, ["--fractal", "julia", "--supersample",
                                     "4"], "packed.png")

    def declined(*a, **k):
        raise ce.KernelUnsupported("forced sequential for the test")

    monkeypatch.setattr(ce, "compute_tiles_packed_cuda", declined)
    cli.reset_kernel_declines()
    seq = _port_render(tmp_path, ["--fractal", "julia", "--supersample",
                                  "4"], "seq.png")
    assert cli.kernel_declines() == {"compute_tiles_packed_cuda": 1}
    assert np.array_equal(packed, seq)


def test_every_mode_renders_on_the_cpu(tmp_path):
    """Every fractal x {integer, smooth f32} x {1, 2, 4} samples."""
    for fractal in ("mandelbrot", "julia", "multibrot", "ship"):
        for smooth in ([], ["--smooth", "--dtype", "f32"]):
            for ss in ([], ["--supersample", "2"], ["--supersample", "4"]):
                img = _port_render(tmp_path, ["--fractal", fractal, *smooth,
                                              *ss])
                assert img.shape == (128, 128, 4)
                assert len(np.unique(img.reshape(-1, 4), axis=0)) > 8


def test_a_declined_view_is_counted_and_takes_the_torch_loop(tmp_path):
    """An f32 family view finer than f32 resolves: the kernel declines
    (counted), the torch loop renders it."""
    cli.reset_kernel_declines()
    out = tmp_path / "fine.png"
    assert cli.main(["render", "--fractal", "multibrot", "--center=0.3,0.5",
                     "--span", "1e-7", "--definition", "128", "--dtype",
                     "f32", "--device", "cpu", "--out", str(out),
                     "-q"]) == 0
    assert cli.kernel_declines() == {"compute_tile_family_cuda": 1}


# Views the direct route cannot draw, each as render flags and the JAX
# package's _render_view arguments: (center, span, max_iter, keywords).
# SH is the seahorse valley's Misiurewicz point, boundary at every depth
# (there f32 deltas at a span of 1e-13 miss the exact count on about a
# fifth of the pixels, in both packages; the sub-threshold view is f64).
SH_RE = "-0.743643887037158704752191506114774"
SH_IM = "0.131825904205311970493132056385139"
DEEP_RENDERS = {
    "deep": (["--deep"], ("-0.5", "0.0"), 3.0, 256, dict(deep=True)),
    "bla": (["--deep", "--bla", "--max-iter", "400"], ("-0.5", "0.0"), 3.0,
            400, dict(deep=True, bla=True)),
    "sub_threshold_span": (
        [f"--center={SH_RE},{SH_IM}", "--span", "1e-13", "--max-iter",
         "6000", "--dtype", "f64"], (SH_RE, SH_IM), 1e-13, 6000,
        dict(np_dtype=np.float64)),
    "f32_unresolvable": (
        [f"--center={SH_RE},{SH_IM}", "--span", "1e-8", "--max-iter",
         "3000"], (SH_RE, SH_IM), 1e-8, 3000, dict()),
    "f32_unresolvable_smooth": (
        [f"--center={SH_RE},{SH_IM}", "--span", "1e-8", "--max-iter",
         "3000", "--dtype", "f32", "--smooth"], (SH_RE, SH_IM), 1e-8, 3000,
        dict(smooth=True)),
}


@pytest.fixture
def _jax_fixed_point_in_python(monkeypatch):
    """The JAX package's fixed-point functions on their pure-Python path
    (exact, the same results): its native build is left to its own
    tests."""
    from distributedmandelbrot_tpu.ops import perturbation as ref_pt
    monkeypatch.setattr(ref_pt, "_native_fixed", lambda *a, **k: False)


@pytest.mark.parametrize("case", list(DEEP_RENDERS))
def test_deep_routing_is_refused(tmp_path, _jax_fixed_point_in_python, case):
    """Views the direct route would refuse or band (``--deep``, ``--bla``,
    a span below 1e-12, f32 views too fine for f32 coordinates) render
    by perturbation at 64^2, held to the JAX package's ``_render_view``
    on the same view.  Integer views: the share of pixels whose color
    differs from the exact fixed-point counts' colors is at most the JAX
    render's own plus 0.5 percentage points, and at most 1 of 12 sampled
    pixels differs from it.  The smooth view: against the JAX package's
    f64 deep render, the port's share of differing colors at most the
    JAX f32 render's plus 0.5 percentage points."""
    from distributedmandelbrot_tpu_torch.ops import perturbation as pt
    flags, center, span, mi, kw = DEEP_RENDERS[case]
    out = tmp_path / "deep.png"
    assert cli.main(["render", *flags, "--definition", "64", "--device",
                     "cpu", "--out", str(out), "-q"]) == 0
    got = np.asarray(Image.open(out))
    ref_kw = dict(smooth=False, np_dtype=np.float32, colormap="jet",
                  deep=None, julia_c=None, family=None, no_pallas=False,
                  normalize=False, supersample=1, bla=None)
    ref_kw.update(kw)

    def ref(**over):
        return srender.imsave_bytes(np.asarray(ref_cli._render_view(
            *center, span, 64, mi, **{**ref_kw, **over})))

    want = ref()
    assert got.shape == want.shape == (64, 64, 4)
    if kw.get("smooth"):
        anchor = ref(np_dtype=np.float64)
    else:
        spec = pt.DeepTileSpec(*center, span, width=64, height=64)
        need = int(-np.log2(spec.step)) + 64
        bits = max(pt.DEFAULT_PREC_BITS, -(-need // 128) * 128)
        za, zb = pt._to_fixed(center[0], bits), pt._to_fixed(center[1], bits)
        pts = [(za + pt._to_fixed(float((c - 31.5) * spec.step), bits),
                zb + pt._to_fixed(float((r - 31.5) * spec.step), bits))
               for r in range(64) for c in range(64)]
        exact = pt._escape_counts_exact_batch(pts, mi, bits, None)
        values = et.scale_counts_to_uint8(torch.from_numpy(exact),
                                          max_iter=mi).numpy()
        anchor = srender.imsave_bytes(srender.value_to_rgba(
            values.reshape(64, 64)))
        rng = np.random.default_rng(1)
        off = sum(bool((got[r, c] != anchor[r, c]).any())
                  for r, c in zip(rng.integers(64, size=12),
                                  rng.integers(64, size=12)))
        assert off <= 1, off
    ours, theirs = _differ(got, anchor), _differ(want, anchor)
    print(f"{case}: port {ours:.4%}, JAX {theirs:.4%} off the anchor; "
          f"{_differ(got, want):.4%} between them")
    assert ours <= theirs + 0.005, (case, ours, theirs)


def test_bla_flags_are_validated(tmp_path):
    """``--bla`` applies to deep views only and excludes ``--no-bla``;
    the tri-state reaches the route as the reference resolves it."""
    out = str(tmp_path / "x.png")
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli.main(["render", "--deep", "--bla", "--no-bla", "--device", "cpu",
                  "--out", out])
    with pytest.raises(SystemExit, match="perturbation deep renders"):
        cli.main(["render", "--bla", "--device", "cpu", "--out", out])
    import argparse
    for bla, no_bla in ((False, False), (True, False), (False, True)):
        args = argparse.Namespace(bla=bla, no_bla=no_bla)
        assert cli._resolve_bla(args) == ref_cli._resolve_bla(args)


def test_refusals_and_validation(tmp_path, monkeypatch):
    out = str(tmp_path / "x.png")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        cli.main(["render", "--definition", "64", "--out", out])
    with pytest.raises(SystemExit, match="carries"):
        cli.main(["render", "--colormap", "magma", "--device", "cpu",
                  "--out", out])
    with pytest.raises(SystemExit, match="no perturbation"):
        cli.main(["render", "--fractal", "ship", "--deep", "--device", "cpu",
                  "--out", out])
    with pytest.raises(SystemExit, match="--power"):
        cli.main(["render", "--power", "3", "--device", "cpu", "--out", out])
    with pytest.raises(SystemExit, match="smooth"):
        cli.main(["render", "--normalize", "--device", "cpu", "--out", out])
    assert cli._join_negative_values(["--c", "-0.8,0.1", "--span", "2"],
                                     ("--c",)) == ["--c=-0.8,0.1", "--span",
                                                   "2"]


def test_dtype_defaults_follow_the_reference():
    """``_resolve_dtype``'s policy: f64 for --smooth, f32 otherwise; an
    f32-unresolvable view goes to f64 for --smooth and the families."""
    import argparse
    for span in (3.0, 1e-7):
        for smooth in (False, True):
            for dtype in (None, "f32", "f64"):
                for perturb in (False, True):
                    args = argparse.Namespace(span=span, smooth=smooth,
                                              dtype=dtype, definition=1024,
                                              deep=False)
                    assert cli._resolve_dtype(
                        args, center=(-0.74, 0.13), can_perturb=perturb) \
                        == ref_cli._resolve_dtype(args, center=(-0.74, 0.13),
                                                  can_perturb=perturb)


@pytest.mark.parametrize("deep", [False, True])
@pytest.mark.parametrize("span", [3.0, 1e-7, 1e-13])
def test_deep_routing_and_dtype_follow_the_reference(deep, span):
    """``_resolve_deep`` and ``_resolve_dtype`` decide as the JAX
    package's do for deep flags, sub-threshold spans and f32-unresolvable
    views, for the core fractals and a family."""
    import argparse
    for smooth in (False, True):
        for dtype in (None, "f32", "f64"):
            args = argparse.Namespace(span=span, smooth=smooth, dtype=dtype,
                                      definition=1024, deep=deep)
            for perturb in (False, True):
                got = cli._resolve_dtype(args, center=(-0.74, 0.13),
                                         can_perturb=perturb)
                assert got == ref_cli._resolve_dtype(
                    args, center=(-0.74, 0.13), can_perturb=perturb)
                for family in (None, (3, False)):
                    assert cli._resolve_deep(
                        True if deep else None, span, -0.74, 0.13, 1024,
                        got, family) == ref_cli._resolve_deep(
                        True if deep else None, span, -0.74, 0.13, 1024,
                        got, family)
