"""The host side of the port's two CUDA kernels, and their plain PyTorch
versions, against the JAX package's Pallas kernels run in interpret
mode (K1 ``compute_tile_pallas_device``, K2 ``compute_tiles_mega_pallas``)
on 128^2 views with ``block_h=32`` on the reference side.

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

TILE = 128
# The views of test_pallas.py's megakernel tests (plus the full view).
VIEWS = {"seahorse": (-0.7436, 0.1317, 2e-3), "valley": (-0.8, 0.1, 0.2),
         "full": (-2.0, -2.0, 4.0), "sky": (1.5, 1.5, 0.1),
         "bulb": (-0.2, -0.05, 0.1)}
# Pixels whose escape count is exact in f32 (all escape within a few
# steps, or are proven interior): bitwise against the reference.
EXACT = ("sky", "bulb")


def _spec(view, cls=TileSpec):
    x, y, s = VIEWS[view]
    return cls(x, y, s, s, width=TILE, height=TILE)


def _golden(view, max_iter):
    cr, ci = _spec(view, RefSpec).grid_2d()
    return golden.scale_counts_to_uint8(
        golden.escape_counts(cr, ci, max_iter), max_iter)


def _interior(view):
    cr, ci = _spec(view, RefSpec).grid_2d()
    return np.asarray(ref_et.mandelbrot_interior(cr, ci))


def _check_against_reference(view, max_iter, got, ref):
    """Sky/bulb bitwise; proven-interior pixels bitwise; elsewhere the
    port's mismatch against the f64 golden is at most the interpret-mode
    kernel's own plus 0.5 percentage points.  (XLA:CPU contracts the
    interpret-mode recurrence into FMAs and the port does not: measured
    941 / 153 / 20 pixels of 16384 differ on seahorse / valley / full at
    300, 1097 / 240 / 29 at 1500; ROADMAP queue 3.)"""
    if view in EXACT:
        assert np.array_equal(got, ref)
        return
    mask = _interior(view)
    assert np.array_equal(got[mask], ref[mask])
    gold = _golden(view, max_iter)
    ours = float((got != gold).mean())
    theirs = float((ref != gold).mean())
    assert ours <= theirs + 0.005, (view, max_iter, ours, theirs)


@pytest.mark.parametrize("max_iter", [300, 1500])
@pytest.mark.parametrize("view", sorted(VIEWS))
def test_k1_plain_against_interpret_mode(view, max_iter):
    got = ce.compute_tile_cuda_device(_spec(view), max_iter, device="cpu")
    assert got.shape == (TILE, TILE) and got.dtype == torch.uint8
    ref = np.asarray(pe.compute_tile_pallas_device(
        _spec(view, RefSpec), max_iter, block_h=32, interpret=True))
    _check_against_reference(view, max_iter, got.numpy(), ref)


@pytest.mark.parametrize("cycle_check", [None, True])
def test_k2_plain_against_interpret_mode(cycle_check):
    """The same params and budget rows (the reference's plan) through
    both megakernels: pixels by the K1 bar, the bf16 census within
    0.5% of a tile's pixels.  Measured: every census equal.  The margin
    is there because XLA:CPU may keep a fused bf16 chain in f32 where
    the port rounds every op, the census is advisory, and no pixel
    depends on it."""
    views = sorted(VIEWS)
    mis = [300, 150, 80, 260, 500]
    ref_specs = [_spec(v, RefSpec) for v in views]
    rows, mrd_rows, _ = pe.mega_dispatch_plan(ref_specs, mis, block_h=32,
                                              interpret=True,
                                              cycle_check=cycle_check)
    ref_tiles, ref_census = pe.compute_tiles_mega_pallas(
        ref_specs, mis, block_h=32, interpret=True, cycle_check=cycle_check)
    tiles, census = ce.compute_tiles_mega_cuda(
        [_spec(v) for v in views], mis, cycle_check=cycle_check,
        rows=np.asarray(rows, np.float32),
        mrd_rows=np.asarray(mrd_rows, np.int32), device="cpu")
    assert tiles.shape == (5, TILE, TILE) and census.shape == (5, 1)
    for t, view in enumerate(views):
        _check_against_reference(view, mis[t], tiles[t].numpy(),
                                 np.asarray(ref_tiles[t]))
    diff = np.abs(census.numpy() - np.asarray(ref_census))
    assert diff.max() <= 0.005 * TILE * TILE, (census, ref_census)


def _big_batch(k=128, seed=7):
    """k (view, budget) pairs from a numpy seed: every view, budgets
    1-2000."""
    rng = np.random.default_rng(seed)
    views = sorted(VIEWS)
    return [(views[int(v)], int(m)) for v, m in
            zip(rng.integers(0, len(views), k), rng.integers(1, 2001, k))]


@pytest.mark.parametrize("specs", [
    [("seahorse", 300), ("bulb", 150), ("sky", 80), ("valley", 260)],
    [("full", 2000), ("valley", 1024)],
    [("sky", 1)],
    _big_batch(),  # with the tile the test appends: 129, over one launch
])
def test_plan_rows_equal_the_reference(specs):
    """Params rows (k, 4) f32 and budget rows (k, 1) int32: the state the
    kernels consume, equal to the reference plan's."""
    ours = [_spec(v) for v, _ in specs] + [
        TileSpec(-0.75, 0.05, 0.3, 0.1, width=TILE, height=TILE)]
    theirs = [_spec(v, RefSpec) for v, _ in specs] + [
        RefSpec(-0.75, 0.05, 0.3, 0.1, width=TILE, height=TILE)]
    mis = [m for _, m in specs] + [700]
    rows, mrds, kw = ce.mega_dispatch_plan(ours, mis)
    ref_rows, ref_mrds, ref_kw = pe.mega_dispatch_plan(theirs, mis,
                                                       block_h=32)
    assert rows.dtype == np.float32 and mrds.dtype == np.int32
    assert np.array_equal(rows, np.asarray(ref_rows, np.float32))
    assert np.array_equal(mrds, np.asarray(ref_mrds, np.int32))
    assert kw["cycle_check"] == ref_kw["cycle_check"]
    unroll = max(1, min(ref_kw["unroll"], max(1, ref_kw["max_iter"] - 1)))
    assert kw["scout_steps"] == ref_kw["scout_segments"] * unroll
    assert (kw["height"], kw["width"]) == (TILE, TILE)


def test_guards_decline_as_the_reference_does():
    fine = RefSpec(-0.7436, 0.1317, 1e-9, 1e-9, width=TILE, height=TILE)
    with pytest.raises(pe.PallasUnsupported, match="resolution"):
        pe.compute_tile_pallas_device(fine, 100, interpret=True)
    ours = TileSpec(-0.7436, 0.1317, 1e-9, 1e-9, width=TILE, height=TILE)
    with pytest.raises(ce.KernelUnsupported, match="resolution"):
        ce.compute_tile_cuda_device(ours, 100, device="cpu")
    with pytest.raises(ce.KernelUnsupported, match="resolution"):
        ce.compute_tiles_mega_cuda([_spec("sky"), ours], [100, 100],
                                   device="cpu")
    deep = ref_et.INT32_SCALE_LIMIT + 1
    with pytest.raises(pe.PallasUnsupported, match="too deep"):
        pe.compute_tile_pallas_device(_spec("sky", RefSpec), deep,
                                      interpret=True)
    with pytest.raises(ce.KernelUnsupported, match="too deep"):
        ce.compute_tile_cuda_device(_spec("sky"), deep, device="cpu")
    with pytest.raises(ce.KernelUnsupported, match="too deep"):
        ce.mega_dispatch_plan([_spec("sky"), _spec("sky")], [10, deep])
    ce.mega_dispatch_plan([_spec("sky")], [deep - 1])  # the last budget in
    other = TileSpec(-1.5, -1.5, 3.0, 3.0, width=TILE, height=64)
    with pytest.raises(ce.KernelUnsupported, match="share"):
        ce.compute_tiles_mega_cuda([_spec("sky"), other], [100, 100],
                                   device="cpu")
    with pytest.raises(ValueError, match="empty"):
        ce.compute_tiles_mega_cuda([], [], device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        ce.mega_dispatch_plan([_spec("sky")], [100, 200])
    # The matrix form (K8) is the degree-2 recurrence without a fold.
    with pytest.raises(ce.KernelUnsupported, match="[Mm][Xx][Uu]"):
        ce.compute_tile_cuda_device(_spec("sky"), 100, use_mxu=True,
                                    burning=True, device="cpu")
    # No batch size is declined, as in the reference: past one launch's
    # MEGA_MAX_TILES the batch runs as several launches of one plan.
    over = ce.MEGA_MAX_TILES + 1
    rows, _, _ = ce.mega_dispatch_plan([_spec("sky")] * over, [100] * over)
    ref_rows, _, _ = pe.mega_dispatch_plan([_spec("sky", RefSpec)] * over,
                                           [100] * over, block_h=32)
    assert rows.shape == (over, 4) and len(ref_rows) == over
    with pytest.raises(ValueError, match=r"\(2, 4\)"):
        ce.compute_tiles_mega_cuda([_spec("sky")] * 2, [10, 10],
                                   rows=np.zeros((1, 4), np.float32),
                                   device="cpu")
    assert issubclass(ce.KernelUnsupported, ValueError)


def _small_batch(k, seed=3, height=16, width=32):
    """k small tiles on windows of every scale around the set's boundary,
    with budgets 1-300 (1 and 2 among them), from a numpy seed."""
    rng = np.random.default_rng(seed)
    anchors = np.array([(-0.745, 0.11), (-0.2, 0.7), (-1.25, 0.0),
                        (0.28, 0.01), (-0.5, -0.5), (1.5, 1.5)])
    specs = []
    for t in range(k):
        cx, cy = anchors[t % len(anchors)] + rng.normal(0, 0.02, 2)
        span = float(10 ** rng.uniform(-2, 0.5))
        specs.append(TileSpec(cx - span / 2, cy - span / 2, span, span,
                              width=width, height=height))
    mis = [int(m) for m in rng.integers(1, 301, k)]
    mis[:2] = [1, 2]
    return specs, mis


def test_a_batch_over_one_launch_fuses():
    """129 tiles of 16x32, one more than a launch takes: the plan accepts
    them, and the fused route equals K1's plain version per tile, each
    tile's census that of the tile alone under the batch's plan."""
    specs, mis = _small_batch(ce.MEGA_MAX_TILES + 1)
    rows, mrds, kw = ce.mega_dispatch_plan(specs, mis)
    assert rows.shape == (129, 4) and mrds.shape == (129, 1)
    assert kw["scout_steps"] > 0, "the deepest budget arms the census"
    tiles, census = ce.compute_tiles_mega_cuda(specs, mis, device="cpu")
    assert tiles.shape == (129, 16, 32) and census.shape == (129, 1)
    for t, (row, mi) in enumerate(zip(rows, mis)):
        one = ce.escape_tile_plain(row, mi, 16, 32,
                                   cycle_check=kw["cycle_check"])
        assert torch.equal(tiles[t], one), (t, mi)
        _, alone = ce.escape_mega_plain(rows[t:t + 1], mrds[t:t + 1], **kw)
        assert int(census[t, 0]) == int(alone[0, 0]), (t, mi)
    assert census.any()


@pytest.mark.parametrize("k", [1, 127, 128, 129, 256, 300])
def test_mega_launch_slices_cover_the_batch_in_order(k):
    slices = ce.mega_launch_slices(k)
    assert slices[0][0] == 0 and slices[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    assert all(0 < t1 - t0 <= ce.MEGA_MAX_TILES for t0, t1 in slices)
    assert len(slices) == -(-k // ce.MEGA_MAX_TILES)


@pytest.mark.parametrize("cycle_check", [None, True, False])
def test_fused_equals_per_tile(cycle_check):
    """K2 equals k launches of K1 bitwise, at mixed budgets under one
    launch (the deepest arming the census)."""
    views = ["seahorse", "bulb", "sky", "valley"]
    mis = [300, 150, 80, 1100]
    tiles, census = ce.compute_tiles_mega_cuda(
        [_spec(v) for v in views], mis, cycle_check=cycle_check,
        device="cpu")
    for t, (view, mi) in enumerate(zip(views, mis)):
        one = ce.compute_tile_cuda_device(_spec(view), mi,
                                          cycle_check=cycle_check,
                                          device="cpu")
        assert torch.equal(tiles[t], one), view
    assert census[views.index("sky"), 0] == TILE * TILE
    assert census[views.index("bulb"), 0] >= 0


def test_cycle_probe_on_and_off_give_the_same_pixels():
    """Deep budgets, where the probe retires the in-set orbits that the
    closed forms miss: output identical with the probe forced off."""
    views = ["seahorse", "valley", "full"]
    on = ce.compute_tiles_mega_cuda([_spec(v) for v in views], [2000] * 3,
                                    cycle_check=True, device="cpu")[0]
    off = ce.compute_tiles_mega_cuda([_spec(v) for v in views], [2000] * 3,
                                     cycle_check=False, device="cpu")[0]
    assert torch.equal(on, off)
    # The period-3 bulb, which no closed form proves: the probe retires it.
    row = ce._params_row(TileSpec(-0.2, 0.65, 0.2, 0.2, width=TILE,
                                  height=TILE))
    _, steps_on = ce.escape_tile_plain(row, 2000, TILE, TILE,
                                       cycle_check=True, return_steps=True)
    _, steps_off = ce.escape_tile_plain(row, 2000, TILE, TILE,
                                        cycle_check=False, return_steps=True)
    assert int(steps_on.sum()) < int(steps_off.sum())


def test_census_is_advisory_and_follows_the_scout_window():
    """The census never changes a pixel; it counts every pixel of the
    all-escaping sky, none of a disarmed scout, and nothing of the
    proven interior."""
    specs = [_spec("seahorse"), _spec("bulb"), _spec("sky")]
    mis = [500, 400, 300]
    on, census_on = ce.compute_tiles_mega_cuda(specs, mis, scout_segments=2,
                                               device="cpu")
    off, census_off = ce.compute_tiles_mega_cuda(specs, mis,
                                                 scout_segments=0,
                                                 device="cpu")
    assert torch.equal(on, off)
    assert int(census_on[2, 0]) == TILE * TILE
    assert int(census_on[0, 0]) > 0
    assert not census_off.any()
    live = int((~_interior("bulb")).sum())
    assert int(census_on[1, 0]) <= live
    shallow = ce.compute_tiles_mega_cuda(specs, [200, 200, 200],
                                         device="cpu")[1]
    assert not shallow.any(), "the census arms at a deepest budget of 256"


def test_degenerate_budget_gives_zeros_and_no_census():
    tiles, census = ce.compute_tiles_mega_cuda([_spec("sky"), _spec("bulb")],
                                               [1, 1], device="cpu")
    assert not tiles.any() and not census.any()
    assert not ce.compute_tile_cuda_device(_spec("sky"), 1,
                                           device="cpu").any()
    # A degenerate tile beside a deep one: zeros for it, its census kept.
    tiles, census = ce.compute_tiles_mega_cuda(
        [_spec("sky"), _spec("sky")], [1, 300], device="cpu")
    assert not tiles[0].any() and tiles[1].all()
    assert int(census[0, 0]) == int(census[1, 0]) == TILE * TILE


def test_clamp_matches_the_reference():
    ref = np.asarray(pe.compute_tile_pallas_device(
        _spec("sky", RefSpec), 300, block_h=32, clamp=True, interpret=True))
    got = ce.compute_tile_cuda_device(_spec("sky"), 300, clamp=True,
                                      device="cpu").numpy()
    assert np.array_equal(got, ref)
    assert got.max() <= 255


def test_launch_counts_count_only_kernel_launches():
    """On the CPU the wrappers take the plain versions: no launch."""
    ce.reset_launch_counts()
    ce.compute_tile_cuda_device(_spec("sky"), 10, device="cpu")
    ce.compute_tiles_mega_cuda([_spec("sky")] * 2, [10, 10], device="cpu")
    assert ce.launch_counts() == {ce.KERNEL_TILE: 0, ce.KERNEL_MEGA: 0,
                                  ce.KERNEL_SMOOTH: 0, ce.KERNEL_PACK: 0,
                                  ce.KERNEL_BATCH: 0, ce.KERNEL_STATE: 0,
                                  ce.KERNEL_RESUME: 0,
                                  ce.KERNEL_TILE_MXU: 0,
                                  ce.KERNEL_MEGA_MXU: 0,
                                  ce.KERNEL_MEGA_JULIA: 0,
                                  ce.KERNEL_MEGA_MULTIBROT: 0,
                                  ce.KERNEL_MEGA_SHIP: 0}
