"""A smooth view coloured straight to RGBA8 (``serve/render.py``
``smooth_to_rgba(..., rgba8_on=device)``, ``ops/cuda_colormap.py``):
the same bytes as the float route's ``imsave_bytes(smooth_to_rgba(nu,
max_iter, colormap))`` for every colormap the port carries, NaN, signed
zeros, negatives, infinities, denormals, values past the budget and
every boundary's neighbourhood included; the boundaries themselves; the
render's route (which views ask for RGBA8, what the colormap tap sees,
where the colour phase is annotated).  The ``gpu`` tests hold the kernel
to its plain version on the card and count its launches; they skip
without a CUDA device and run with

    python -m pytest -q -m gpu tests/test_torch_colormap8.py

(the file imports nothing of JAX)."""

import contextlib
from decimal import Decimal

import numpy as np
import pytest
import torch

import distributedmandelbrot_tpu_torch.viewer as viewer
from distributedmandelbrot_tpu_torch import cli
from distributedmandelbrot_tpu_torch.obs import names, phases
from distributedmandelbrot_tpu_torch.ops import cuda_colormap as cc
from distributedmandelbrot_tpu_torch.ops import perturbation
from distributedmandelbrot_tpu_torch.serve import render as srender

MAX_ITERS = [300, 50_000]
# The seahorse valley's deep view takes the secondary reference and the
# exact repair: its smooth values are repaired on the host.
SEAHORSE = ("-0.743643887037158704752191506114774",
            "0.131825904205311970493132056385139", "1e-10", "20000")


def _plane(max_iter, shape, seed=0):
    """Random smooth values (most low, a tail past the budget) with NaN,
    +-0, negatives, +-inf, denormals and 2 * max_iter planted."""
    rng = np.random.default_rng(seed)
    nu = rng.uniform(0.0, 2.0 * max_iter, shape) * rng.random(shape) ** 4
    flat = nu.reshape(-1)
    planted = [np.nan, 0.0, -0.0, -1.0, -np.inf, np.inf, 5e-324, 1e-310,
               2.0 * max_iter, float(max_iter)]
    picks = rng.choice(flat.size, 6 * len(planted), replace=False)
    flat[picks] = np.resize(planted, picks.size)
    return nu


def _sweep(max_iter):
    """Every boundary and 64 float64 steps either side of it."""
    bits = srender.smooth_boundaries(max_iter).view(np.int64)
    return (bits[:, None] + np.arange(-64, 65)).view(np.float64)


def _float_route(nu, max_iter, colormap="jet"):
    return srender.imsave_bytes(srender.smooth_to_rgba(nu, max_iter,
                                                       colormap))


def _tables(max_iter, colormap="jet", device="cpu"):
    return (torch.tensor(srender.smooth_boundaries(max_iter), device=device),
            torch.tensor(srender.smooth_table8(colormap), device=device))


@pytest.mark.parametrize("max_iter", MAX_ITERS)
@pytest.mark.parametrize("colormap", srender.COLORMAPS)
def test_rgba8_route_gives_the_float_routes_bytes(colormap, max_iter):
    for nu in (_plane(max_iter, (96, 80)), _sweep(max_iter)):
        want = _float_route(nu, max_iter, colormap)
        got = srender.smooth_to_rgba(nu, max_iter, colormap, rgba8_on="cpu")
        assert got.dtype == np.uint8 and got.shape == nu.shape + (4,)
        assert np.array_equal(got, want)
        plain = cc.colormap_rgba8_plain(torch.from_numpy(nu),
                                        *_tables(max_iter, colormap))
        assert np.array_equal(plain.numpy(), want)


@pytest.mark.parametrize("max_iter", [1, *MAX_ITERS])
def test_boundaries_are_sorted_finite_and_each_changes_the_row(max_iter):
    bounds = srender.smooth_boundaries(max_iter)
    assert bounds.shape == (srender.LUT_SIZE - 1,)
    assert np.all(np.isfinite(bounds)) and np.all(bounds > 0)
    assert np.all(np.diff(bounds) > 0)
    rows = srender.LUT_SIZE - 2 - np.arange(srender.LUT_SIZE - 1)
    assert np.array_equal(srender._smooth_rows(bounds, max_iter), rows)
    below = np.nextafter(bounds, 0.0)
    assert np.array_equal(srender._smooth_rows(below, max_iter), rows + 1)
    assert srender.smooth_boundaries(max_iter) is bounds
    with pytest.raises(ValueError, match="max_iter"):
        srender.smooth_boundaries(0)


def test_table8_is_imsave_bytes_of_the_float_table_then_the_set():
    for colormap in srender.COLORMAPS:
        table = srender.smooth_table8(colormap)
        assert table.shape == (srender.LUT_SIZE + 4, 4)
        assert np.array_equal(table[:-1], srender.imsave_bytes(
            srender.colormap_table(colormap)[None])[0])
        assert table[-2].tolist() == [0, 0, 0, 0]
        assert table[-1].tolist() == [0, 0, 0, 255]


def test_the_wrapper_checks_its_operands():
    bounds, table = _tables(300)
    nu = torch.zeros((4, 4), dtype=torch.float64)
    for bad in (nu.float(), nu.t()[:, :3]):
        with pytest.raises(ValueError, match="nu"):
            cc.colormap_rgba8(bad, bounds, table)
    for bad in (bounds.float(), torch.ones(cc.MAX_BOUNDARIES + 1,
                                           dtype=torch.float64)):
        with pytest.raises(ValueError, match="boundaries"):
            cc.colormap_rgba8(nu, bad, table)
    for bad in (table.to(torch.int32), table[:bounds.numel() + 2]):
        with pytest.raises(ValueError, match="table"):
            cc.colormap_rgba8(nu, bounds, bad)
    with pytest.raises(ValueError, match="normalised"):
        srender.smooth_to_rgba(nu.numpy(), 300, normalize=True,
                               rgba8_on="cpu")


# A small table: 3 boundaries, colours 0..3, an unused row, NaN, the set.
SMALL_BOUNDS = torch.tensor([1.0, 2.0, 4.0], dtype=torch.float64)
SMALL_TABLE = torch.arange(28, dtype=torch.uint8).reshape(7, 4)
SMALL_NU = torch.tensor([0.5, 1.0, 1.5, 2.0, 3.9, 4.0, 1e300, np.inf,
                         np.nan, 0.0, -0.0, -2.0], dtype=torch.float64)
SMALL_ROWS = [3, 2, 2, 1, 1, 0, 0, 0, 5, 6, 6, 6]


def test_the_wrapper_takes_its_geometry_from_its_operands():
    got = cc.colormap_rgba8(SMALL_NU, SMALL_BOUNDS, SMALL_TABLE)
    assert torch.equal(got, SMALL_TABLE[SMALL_ROWS])


def test_a_tensor_is_coloured_as_its_float64_values():
    nu = torch.from_numpy(_plane(300, (40, 24))).float()
    got = srender.smooth_to_rgba(nu, 300, "viridis", rgba8_on="cpu")
    assert np.array_equal(got, _float_route(nu.numpy(), 300, "viridis"))


@pytest.fixture
def taps(monkeypatch):
    """Wrappers on ``viewer.smooth_to_rgba`` and the deep route, patched
    in as the benchmark's taps patch them: each colormap call's
    arguments, and each smooth value plane the route returned."""
    seen = {"colour": [], "route": []}
    colour, route = viewer.smooth_to_rgba, perturbation.compute_smooth_perturb

    def colour_tap(*args, **kwargs):
        seen["colour"].append((args, kwargs))
        return colour(*args, **kwargs)

    def route_tap(*args, **kwargs):
        out = route(*args, **kwargs)
        seen["route"].append(out[0])
        return out
    monkeypatch.setattr(viewer, "smooth_to_rgba", colour_tap)
    monkeypatch.setattr(perturbation, "compute_smooth_perturb", route_tap)
    return seen


def _deep_render(tmp_path, *flags, view=SEAHORSE, device="cpu"):
    re, im, span, max_iter = view
    out = tmp_path / "view.png"
    assert cli.main(["render", "--deep", "--smooth", "--dtype", "f64",
                     f"--center={re},{im}", "--span", span, "--max-iter",
                     max_iter, "--device", device, "--out", str(out), "-q",
                     *flags]) == 0
    return out.read_bytes()


def test_cpu_deep_render_writes_the_float_routes_png_and_taps_see_nu(
        tmp_path, taps):
    png = _deep_render(tmp_path, "--definition", "32")
    ((args, kwargs),) = taps["colour"]
    (nu,) = taps["route"]
    assert args[0] is nu and args[1] == 20000
    assert isinstance(nu, np.ndarray) and nu.shape == (32, 32)
    assert torch.device(kwargs["rgba8_on"]) == torch.device("cpu")
    assert png == srender.encode_png(_float_route(nu, 20000))


@pytest.mark.parametrize("flags", [["--supersample", "2"], ["--normalize"]],
                         ids=["supersample", "normalize"])
def test_supersampled_and_normalised_views_keep_the_float_route(
        tmp_path, taps, flags):
    _deep_render(tmp_path, "--definition", "16", *flags)
    assert taps["colour"] and all(
        kwargs.get("rgba8_on") is None for _, kwargs in taps["colour"])


def test_render_supersampled_still_returns_the_float_mean():
    re, im, span, max_iter = SEAHORSE
    kw = dict(smooth=True, np_dtype=np.float64, colormap="jet",
              device=torch.device("cpu"), deep=True)
    got = cli._render_view(re, im, float(span), 16, int(max_iter),
                           supersample=2, rgba8=True, **kw)
    pitch = float(span) / 15
    want = sum(cli._render_view(str(Decimal(re) + Decimal(repr(dx * pitch))),
                                str(Decimal(im) + Decimal(repr(dy * pitch))),
                                float(span), 16, int(max_iter), **kw)
               for dx, dy in cli._SS_OFFSETS[2]) / 2
    assert got.dtype == np.float64 and np.array_equal(got, want)


@pytest.mark.parametrize("device", [None, "cpu", "cuda"])
def test_colour_phase_is_annotated_only_on_the_host(monkeypatch, device):
    entered = []

    def record_function(name):
        entered.append(name)
        return contextlib.nullcontext()
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    monkeypatch.setattr(phases, "_recording", lambda: True)
    kwargs = {} if device is None else {"rgba8_on": torch.device(device)}
    assert cli._colormapped(lambda *a, **k: (a, k), 1.0, 300,
                            **kwargs) == ((1.0, 300), kwargs)
    mark = names.PHASE_ANNOTATION_PREFIX + names.PHASE_RENDER_COLORMAP
    assert entered == ([] if device == "cuda" else [mark])


# --- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1024, 1024), (4096, 4096), (999, 1001)])
def test_kernel_is_bytewise_its_plain_version(cuda, shape):
    for max_iter in MAX_ITERS:
        host = _tables(max_iter)
        card = _tables(max_iter, device=cuda)
        for nu in (_plane(max_iter, shape), _sweep(max_iter)):
            x = torch.from_numpy(nu).to(cuda)
            cc.reset_launch_counts()
            got = cc.colormap_rgba8(x, *card)
            assert cc.launch_counts() == {cc.KERNEL_COLORMAP: 1}
            torch.cuda.synchronize()
            assert torch.equal(got, cc.colormap_rgba8_plain(x, *card))
            assert torch.equal(got.cpu(), cc.colormap_rgba8_plain(
                torch.from_numpy(nu), *host))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_kernel_takes_its_geometry_from_its_operands(cuda):
    got = cc.colormap_rgba8(SMALL_NU.to(cuda), SMALL_BOUNDS.to(cuda),
                            SMALL_TABLE.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), SMALL_TABLE[SMALL_ROWS])


@pytest.mark.gpu
def test_card_kernel_render_colours_its_plane_where_it_is(cuda, tmp_path,
                                                         taps):
    out = tmp_path / "k4.png"
    cc.reset_launch_counts()
    assert cli.main(["render", "--smooth", "--dtype", "f32", "--definition",
                     "256", "--max-iter", "1024", "--device", "cuda",
                     "--out", str(out), "-q"]) == 0
    torch.cuda.synchronize()
    assert cc.launch_counts() == {cc.KERNEL_COLORMAP: 1}
    ((args, kwargs),) = taps["colour"]
    nu = args[0]
    assert isinstance(nu, torch.Tensor) and nu.device.type == "cuda"
    assert out.read_bytes() == srender.encode_png(
        _float_route(nu.cpu().numpy(), 1024))


@pytest.mark.gpu
def test_card_render_launches_the_colour_kernel_once_a_view(cuda, tmp_path,
                                                            taps):
    cc.reset_launch_counts()
    png = _deep_render(tmp_path, "--definition", "256", device="cuda")
    torch.cuda.synchronize()
    assert cc.launch_counts() == {cc.KERNEL_COLORMAP: 1}
    (nu,) = taps["route"]
    assert png == srender.encode_png(_float_route(nu, 20000))
    for flags in (["--supersample", "2"], ["--normalize"]):
        _deep_render(tmp_path, "--definition", "64", *flags, device="cuda")
    torch.cuda.synchronize()
    assert cc.launch_counts() == {cc.KERNEL_COLORMAP: 1}
