"""The render path's kernels, through their plain PyTorch versions,
against the JAX package's Pallas kernels in interpret mode (``block_h=32``
on the reference side), at 128^2 and 128x64:

- K1 ``escape_tile`` in its Julia, Multibrot and Burning-Ship modes
  (``compute_tile_pallas_device(julia_c=|power=|burning=)``);
- K4 ``escape_smooth`` (``compute_tile_smooth_pallas``);
- K5 ``escape_pack`` (``compute_tiles_packed_pallas``), and K5 == K1 per
  state, bitwise;
- the guards that decline or refuse a tile.

Here, on the CPU, the wrappers take the plain versions; the kernels
themselves are held bitwise against those on the card (test_torch_gpu.py
and chip_smoke.py)."""

import numpy as np
import pytest
import torch

from distributedmandelbrot_tpu.core.geometry import TileSpec as RefSpec
from distributedmandelbrot_tpu.ops import escape_time as ref_et
from distributedmandelbrot_tpu.ops import pallas_escape as pe
from distributedmandelbrot_tpu.ops import reference as golden
from distributedmandelbrot_tpu_torch.core.geometry import TileSpec
from distributedmandelbrot_tpu_torch.ops import cuda_escape as ce

JULIA_C = complex(-0.8, 0.156)
# (name, K1 keywords): the modes this slice adds to K1.
MODES = {"julia": {"julia_c": JULIA_C}, "multibrot3": {"power": 3},
         "ship": {"burning": True}}
# Fixed views per mode (start_r, start_i, span, height) plus two drawn
# from a numpy seed, all 128 wide.
FIXED = {"julia": [(-1.5, -1.5, 3.0, 128), (-0.3, -0.2, 0.4, 64)],
         "multibrot3": [(-1.2, -1.2, 2.4, 128), (-0.7, 0.35, 0.3, 64)],
         "ship": [(-2.2, -1.2, 2.4, 64), (-1.8, -0.08, 0.1, 128)]}


def _random_views(seed: int, n: int = 2):
    rng = np.random.default_rng(seed)
    return [(float(rng.uniform(-1.5, 0.3)), float(rng.uniform(-1.0, 0.6)),
             float(rng.uniform(0.05, 1.0)), int(rng.choice([64, 128])))
            for _ in range(n)]


VIEWS = {mode: FIXED[mode] + _random_views(seed)
         for seed, mode in enumerate(sorted(MODES), start=20261016)}
# Mismatch against the f64 golden allowed above the interpret-mode
# kernel's own: the slice-1 bar, 0.5 pp.  It holds for the Burning Ship
# too, whose folds turn a last-ulp difference into a diverged orbit
# (measured on these views: at most +0.46 pp, Julia view 1 at 300; the
# counts are in ROADMAP queue 3).
EXTRA = 0.005


def _specs(view):
    x, y, s, h = view
    return (TileSpec(x, y, s, s, width=128, height=h),
            RefSpec(x, y, s, s, width=128, height=h))


def _golden_counts(mode, ref_spec, max_iter):
    cr, ci = ref_spec.grid_2d()
    kw = MODES[mode]
    if "julia_c" in kw:
        counts = golden.escape_counts_julia(cr, ci, kw["julia_c"], max_iter)
    else:
        counts = golden.escape_counts_family(
            cr, ci, max_iter, power=kw.get("power", 2),
            burning=kw.get("burning", False))
    return counts


def _golden(mode, ref_spec, max_iter):
    return golden.scale_counts_to_uint8(
        _golden_counts(mode, ref_spec, max_iter), max_iter)


def _proven_interior(mode, ref_spec):
    """The f64 proven-interior mask (Multibrot only: Julia and the ship
    have no closed form)."""
    kw = MODES[mode]
    if "power" not in kw:
        return None
    cr, ci = ref_spec.grid_2d()
    return np.asarray(ref_et.multibrot_interior(cr, ci, kw["power"]))


@pytest.mark.parametrize("index,max_iter",
                         [(0, 300), (1, 300), (2, 300), (3, 300), (0, 1500),
                          (1, 1500)])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_k1_modes_plain_against_interpret_mode(mode, index, max_iter):
    """Proven-interior pixels bitwise; the port's mismatch against the
    f64 golden at most the interpret-mode kernel's own plus EXTRA
    (XLA:CPU contracts the interpret-mode recurrence into FMAs and the
    port does not).  The deep budget arms the cycle probe
    (on the fixed views)."""
    spec, ref_spec = _specs(VIEWS[mode][index])
    kw = MODES[mode]
    got = ce.compute_tile_cuda_device(spec, max_iter, device="cpu", **kw)
    assert got.shape == (spec.height, spec.width) and got.dtype == torch.uint8
    ref = np.asarray(pe.compute_tile_pallas_device(
        ref_spec, max_iter, block_h=32, interpret=True, **kw))
    got = got.numpy()
    mask = _proven_interior(mode, ref_spec)
    if mask is not None:
        assert mask.any() or index > 0
        assert np.array_equal(got[mask], ref[mask])
    gold = _golden(mode, ref_spec, max_iter)
    ours = float((got != gold).mean())
    theirs = float((ref != gold).mean())
    assert ours <= theirs + EXTRA, (mode, index, ours, theirs)


def test_k1_mandelbrot_row_is_unchanged_by_the_modes():
    """The degree-2 Mandelbrot call keeps its 4-wide params row and its
    plain version's pixels; an explicit ``power=2`` is the same call."""
    spec, _ = _specs((-0.8, 0.1, 0.2, 128))
    assert len(ce._params_row(spec)) == 4
    assert len(ce._params_row(spec, JULIA_C)) == 6
    a = ce.compute_tile_cuda_device(spec, 500, device="cpu")
    b = ce.compute_tile_cuda_device(spec, 500, power=2, burning=False,
                                    device="cpu")
    assert torch.equal(a, b)


def _kernel_grid(ref_spec):
    step_r = np.float32(ref_spec.range_real / (ref_spec.width - 1))
    step_i = np.float32(ref_spec.range_imag / (ref_spec.height - 1))
    cr = (np.float32(ref_spec.start_real) + np.arange(
        ref_spec.width, dtype=np.float32) * step_r)[None, :].repeat(
            ref_spec.height, 0)
    ci = (np.float32(ref_spec.start_imag) + np.arange(
        ref_spec.height, dtype=np.float32) * step_i)[:, None].repeat(
            ref_spec.width, 1)
    return cr, ci


def _inset_within_bar(got, ref, gold_counts, extra=0.005):
    """In-set masks (nu == 0) against the f64 golden's (count 0): the
    port's mismatch at most the interpret-mode kernel's own plus
    ``extra``.  (test_pallas.py holds the Pallas kernel to >= 99.9%
    agreement with the XLA loop, which contracts the same FMAs; the
    port contracts none, so it is held to the golden instead: on the
    seahorse-edge view below, the port's mask differs from the golden's
    on 139 pixels of 16384 and the interpret-mode kernel's on 118.)"""
    gold = gold_counts == 0
    ours = float(((got == 0) != gold).mean())
    theirs = float(((ref == 0) != gold).mean())
    assert ours <= theirs + extra, (ours, theirs)


def test_k4_plain_against_interpret_mode_mandelbrot():
    """nu against the reference's f64 smooth loop (XLA), where both
    escape: the port's median relative error below test_pallas.py's
    1e-5, and its share of pixels within 2% at most 0.5 pp below the
    interpret-mode kernel's.  (test_pallas.py asks > 99.5% within 2% of
    the XLA f32 loop, which contracts the same FMAs as the Pallas
    kernel; between the port and the interpret-mode kernel it is 98.6%
    on this view, and each is 98.1% against f64.)"""
    spec, ref_spec = _specs((-0.748, 0.09, 0.01, 128))
    got = ce.compute_tile_smooth_cuda(spec, 300, device="cpu").numpy()
    assert got.dtype == np.float32 and got.shape == (128, 128)
    ref = np.asarray(pe.compute_tile_smooth_pallas(ref_spec, 300, block_h=32,
                                                   interpret=True))
    cr, ci = ref_spec.grid_2d()
    _inset_within_bar(got, ref, golden.escape_counts(cr, ci, 300))
    nu64 = np.asarray(ref_et.compute_tile_smooth(ref_spec, 300))

    def within_2pct(nu):
        both = (nu > 0) & (nu64 > 0)
        rel = np.abs(nu[both] - nu64[both]) / np.maximum(nu64[both], 1.0)
        return float(np.median(rel)), float((rel < 0.02).mean())

    (med, ours), (_, theirs) = within_2pct(got), within_2pct(ref)
    assert med < 1e-5
    assert ours >= theirs - 0.005, (ours, theirs)


def test_k4_plain_against_interpret_mode_julia():
    """test_pallas.py's Julia smooth bar on nu: within 0.05 where both
    escape."""
    spec, ref_spec = _specs((-1.5, -1.5, 3.0, 64))
    c = -0.4 + 0.1j
    got = ce.compute_tile_smooth_cuda(spec, 100, julia_c=c,
                                      device="cpu").numpy()
    ref = np.asarray(pe.compute_tile_smooth_pallas(
        ref_spec, 100, block_h=32, interpret=True, julia_c=c))
    cr, ci = ref_spec.grid_2d()
    _inset_within_bar(got, ref, golden.escape_counts_julia(cr, ci, c, 100))
    both = (got != 0) & (ref != 0)
    assert float(np.abs(got[both] - ref[both]).max()) <= 0.05


@pytest.mark.parametrize("power,burning,extra,quantile,frac_tol,view", [
    (3, False, 0.005, 0.99, 0.005, (-1.2, -1.2, 2.4, 64)),
    (2, True, 0.03, 0.90, 0.08, (-2.2, -1.2, 2.4, 64)),
])
def test_k4_plain_against_interpret_mode_families(power, burning, extra,
                                                  quantile, frac_tol, view):
    """test_pallas.py's smooth-family bars on nu (the bulk within 0.05,
    few pixels more than 1 apart; wider for the ship), in-set masks held
    to the golden."""
    spec, ref_spec = _specs(view)
    got = ce.compute_tile_smooth_cuda(spec, 100, power=power,
                                      burning=burning, device="cpu").numpy()
    ref = np.asarray(pe.compute_tile_smooth_pallas(
        ref_spec, 100, power=power, burning=burning, block_h=32,
        interpret=True))
    cr, ci = ref_spec.grid_2d()
    _inset_within_bar(got, ref, golden.escape_counts_family(
        cr, ci, 100, power=power, burning=burning), extra)
    both = (got != 0) & (ref != 0)
    diff = np.abs(got[both] - ref[both])
    assert float(np.quantile(diff, quantile)) <= 0.05
    assert float((diff > 1.0).mean()) <= frac_tol


def test_k4_cycle_probe_is_output_identical():
    spec, _ = _specs((-0.2, 0.7, 0.15, 64))
    on = ce.compute_tile_smooth_cuda(spec, 2000, cycle_check=True,
                                     device="cpu")
    off = ce.compute_tile_smooth_cuda(spec, 2000, cycle_check=False,
                                      device="cpu")
    assert torch.equal(on, off)
    assert float((on == 0).float().mean()) > 0.3


def test_k4_stops_where_the_pallas_kernel_stops():
    """A pixel still live at the end runs whole 64-step segments past
    ``max_iter - 1 + extra``; the torch loop keeps the XLA loop's
    32-step segments."""
    assert ce.smooth_step_limit(300, 256.0) == 320   # 299 + 11 -> 5 x 64
    assert ce.smooth_step_limit(100, 256.0) == 128
    assert ce.smooth_step_limit(2, 256.0) == 64
    from distributedmandelbrot_tpu_torch.ops import escape_time as et
    assert et.segment_steps(310, 32) == 320
    assert et.smooth_extra_steps(256.0) == 11
    assert et.smooth_extra_steps(2.0) == 9   # 8 + log2(log2(4))


@pytest.mark.parametrize("cycle_check", [None, True, False])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_k5_plain_against_interpret_mode(n, cycle_check):
    """n same-shaped sample windows (the supersampled render's shape) at
    mixed budgets: each plane at the K1 bar against the interpret-mode
    packed kernel."""
    base = (-0.7436, 0.1317, 2e-3, 128)
    pitch = base[2] / 127
    offs = [(-0.25, -0.25), (0.25, -0.25), (-0.25, 0.25), (0.25, 0.25)][:n]
    specs = [_specs((base[0] + dx * pitch, base[1] + dy * pitch, base[2],
                     128)) for dx, dy in offs]
    mis = [300, 200, 1100, 50][:n]
    got = ce.compute_tiles_packed_cuda([s for s, _ in specs], mis,
                                       cycle_check=cycle_check, device="cpu")
    assert got.shape == (n, 128, 128) and got.dtype == torch.uint8
    ref = pe.compute_tiles_packed_pallas([r for _, r in specs], mis,
                                         block_h=32, interpret=True,
                                         cycle_check=cycle_check)
    for t, ((_, ref_spec), mi) in enumerate(zip(specs, mis)):
        cr, ci = ref_spec.grid_2d()
        gold = golden.scale_counts_to_uint8(
            golden.escape_counts(cr, ci, mi), mi)
        mask = np.asarray(ref_et.mandelbrot_interior(cr, ci))
        ours, theirs = got[t].numpy(), np.asarray(ref[t])
        assert np.array_equal(ours[mask], theirs[mask])
        assert float((ours != gold).mean()) <= \
            float((theirs != gold).mean()) + 0.005


@pytest.mark.parametrize("mode", ["mandelbrot"] + sorted(MODES))
def test_k5_plain_equals_k1_plain_per_state(mode):
    """Each state of a pack is K1 on its tile, bitwise, in every mode;
    the probe policy follows the deepest budget of the pack."""
    kw = dict(MODES.get(mode, {}))
    views = [(-1.5, -1.5, 3.0, 64), (-0.8, 0.1, 0.2, 64),
             (-0.2, 0.65, 0.2, 64), (0.3, -0.1, 0.5, 64)]
    specs = [_specs(v)[0] for v in views]
    mis = [300, 1500, 2, 90]
    jc = kw.pop("julia_c", None)
    planes = ce.compute_tiles_packed_cuda(
        specs, mis, julia_cs=[jc] * 4 if jc is not None else None,
        device="cpu", **kw)
    for t, (spec, mi) in enumerate(zip(specs, mis)):
        one = ce.compute_tile_cuda_device(spec, mi, julia_c=jc,
                                          cycle_check=True, device="cpu",
                                          **kw)
        assert torch.equal(planes[t], one), (mode, t)


def test_k5_julia_against_interpret_mode():
    specs = [_specs((-1.5 + 0.01 * k, -1.5, 3.0, 64)) for k in range(2)]
    got = ce.compute_tiles_packed_cuda([s for s, _ in specs], [300, 300],
                                       julia_cs=[JULIA_C] * 2, device="cpu")
    ref = pe.compute_tiles_packed_pallas([r for _, r in specs], [300, 300],
                                         julia_cs=[JULIA_C] * 2, block_h=32,
                                         interpret=True)
    for t, (_, ref_spec) in enumerate(specs):
        cr, ci = ref_spec.grid_2d()
        gold = golden.scale_counts_to_uint8(
            golden.escape_counts_julia(cr, ci, JULIA_C, 300), 300)
        ours, theirs = got[t].numpy(), np.asarray(ref[t])
        assert float((ours != gold).mean()) <= \
            float((theirs != gold).mean()) + 0.005


def test_guards_decline_and_refuse_as_the_reference_does():
    sky, sky_ref = _specs((1.5, 1.5, 0.1, 128))
    other, other_ref = _specs((1.5, 1.5, 0.1, 64))
    with pytest.raises(pe.PallasUnsupported, match="share"):
        pe.compute_tiles_packed_pallas([sky_ref, other_ref], [100, 100],
                                       interpret=True)
    with pytest.raises(ce.KernelUnsupported, match="share"):
        ce.compute_tiles_packed_cuda([sky, other], [100, 100], device="cpu")
    with pytest.raises(pe.PallasUnsupported, match="pack of 5"):
        pe.compute_tiles_packed_pallas([sky_ref] * 5, [100] * 5,
                                       interpret=True)
    with pytest.raises(ce.KernelUnsupported, match="pack of 5"):
        ce.compute_tiles_packed_cuda([sky] * 5, [100] * 5, device="cpu")
    with pytest.raises(ce.KernelUnsupported, match="pack of 0"):
        ce.compute_tiles_packed_cuda([], [], device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        ce.compute_tiles_packed_cuda([sky] * 2, [100], device="cpu")
    with pytest.raises(ValueError, match="constant per tile"):
        ce.compute_tiles_packed_cuda([sky] * 2, [100] * 2,
                                     julia_cs=[JULIA_C, None], device="cpu")
    for call in (
            lambda **k: ce.compute_tile_cuda_device(sky, 50, device="cpu",
                                                    **k),
            lambda **k: ce.compute_tile_smooth_cuda(sky, 50, device="cpu",
                                                    **k),
            lambda **k: ce.compute_tiles_packed_cuda([sky], [50],
                                                     device="cpu", **k)):
        with pytest.raises(ValueError, match="degree must be >= 2"):
            call(power=1)
        with pytest.raises(ValueError, match="degree 2 only"):
            call(power=3, burning=True)
    with pytest.raises(ValueError, match="degree-2"):
        ce.compute_tile_cuda_device(sky, 50, power=3, julia_c=JULIA_C,
                                    device="cpu")
    with pytest.raises(ValueError, match="degree-2"):
        ce.compute_tile_smooth_cuda(sky, 50, power=3, julia_c=JULIA_C,
                                    device="cpu")
    with pytest.raises(ValueError, match="degree-2"):
        ce.compute_tiles_packed_cuda([sky], [50], power=3,
                                     julia_cs=[JULIA_C], device="cpu")
    with pytest.raises(ValueError, match="degree-2"):
        pe.compute_tile_pallas_device(sky_ref, 50, power=3,
                                      julia_c=JULIA_C, interpret=True)
    fine, _ = _specs((-0.7436, 0.1317, 1e-9, 128))
    with pytest.raises(ce.KernelUnsupported, match="resolution"):
        ce.compute_tile_smooth_cuda(fine, 100, device="cpu")
    with pytest.raises(ce.KernelUnsupported, match="resolution"):
        ce.compute_tiles_packed_cuda([fine, fine], [100, 100], device="cpu")
    deep = ref_et.INT32_SCALE_LIMIT + 1
    with pytest.raises(ce.KernelUnsupported, match="too deep"):
        ce.compute_tile_smooth_cuda(sky, deep, device="cpu")
    with pytest.raises(ce.KernelUnsupported, match="too deep"):
        ce.compute_tiles_packed_cuda([sky, sky], [10, deep], device="cpu")
    with pytest.raises(ValueError, match="bailout"):
        ce.compute_tile_smooth_cuda(sky, 50, bailout=1.5, device="cpu")


def test_degenerate_budgets_give_zeros():
    sky, _ = _specs((1.5, 1.5, 0.1, 64))
    assert not ce.compute_tile_smooth_cuda(sky, 1, device="cpu").any()
    planes = ce.compute_tiles_packed_cuda([sky, sky], [1, 300],
                                          device="cpu")
    assert not planes[0].any() and planes[1].all()
    assert not ce.compute_tile_cuda_device(sky, 1, julia_c=JULIA_C,
                                           device="cpu").any()


def test_new_launch_counts_stay_zero_on_the_cpu():
    sky, _ = _specs((1.5, 1.5, 0.1, 64))
    ce.reset_launch_counts()
    ce.compute_tile_smooth_cuda(sky, 10, device="cpu")
    ce.compute_tiles_packed_cuda([sky, sky], [10, 10], device="cpu")
    ce.compute_tile_cuda_device(sky, 10, burning=True, device="cpu")
    assert ce.launch_counts() == {ce.KERNEL_TILE: 0, ce.KERNEL_MEGA: 0,
                                  ce.KERNEL_SMOOTH: 0, ce.KERNEL_PACK: 0,
                                  ce.KERNEL_BATCH: 0, ce.KERNEL_STATE: 0,
                                  ce.KERNEL_RESUME: 0,
                                  ce.KERNEL_TILE_MXU: 0,
                                  ce.KERNEL_MEGA_MXU: 0,
                                  ce.KERNEL_MEGA_JULIA: 0,
                                  ce.KERNEL_MEGA_MULTIBROT: 0,
                                  ce.KERNEL_MEGA_SHIP: 0}
