"""K2 (``escape_mega``) in its Julia, Multibrot-3 and Burning-Ship modes,
through its plain PyTorch version, against K1 per tile, against the JAX
package's megakernel in interpret mode (``compute_tiles_mega_pallas(...,
block_h=32, interpret=True, julia_cs=|power=|burning=)``), and sharded
over a two-position CPU ring.

Here, on the CPU, the wrappers take the plain versions; the kernel's
modes are held bitwise against those on the card (test_torch_gpu.py and
chip_smoke.py)."""

import numpy as np
import pytest
import torch

from distributedmandelbrot_tpu.core.geometry import TileSpec as RefSpec
from distributedmandelbrot_tpu.ops import escape_time as ref_et
from distributedmandelbrot_tpu.ops import pallas_escape as pe
from distributedmandelbrot_tpu.ops import reference as golden
from distributedmandelbrot_tpu_torch.core.geometry import TileSpec
from distributedmandelbrot_tpu_torch.ops import cuda_escape as ce
from distributedmandelbrot_tpu_torch.ops import escape_time
from distributedmandelbrot_tpu_torch.parallel.mesh import make_mesh
from distributedmandelbrot_tpu_torch.parallel.sharding import (
    _pad_mega, compute_tiles_mega_sharded)

TILE = 128
JULIA_C = complex(-0.8, 0.156)
# Per mode: two boundary views of the render tests' fixed set (start_r,
# start_i, span) and the sky, whose pixels all escape in a few steps.
SKY = (1.5, 1.5, 0.1)
MODES = {
    "julia": ({"julia_c": JULIA_C}, [(-1.5, -1.5, 3.0), (-0.3, -0.2, 0.4),
                                     SKY]),
    "multibrot3": ({"power": 3}, [(-1.2, -1.2, 2.4), (-0.7, 0.35, 0.3),
                                  SKY]),
    "ship": ({"burning": True}, [(-2.2, -1.2, 2.4), (-1.8, -0.08, 0.1),
                                 SKY]),
}
# Mixed budgets: the deepest arms the cycle probe and the census.
MIS = [300, 1024, 80]
# Mismatch against the f64 golden allowed above the interpret-mode
# kernel's own: ROADMAP's 0.5 pp bar.
EXTRA = 0.005


def _specs(mode, cls=TileSpec):
    return [cls(x, y, s, s, width=TILE, height=TILE)
            for x, y, s in MODES[mode][1]]


def _mega_kw(mode, k):
    """compute_tiles_mega_* keywords of a mode for k tiles."""
    kw = dict(MODES[mode][0])
    jc = kw.pop("julia_c", None)
    if jc is not None:
        kw["julia_cs"] = [jc] * k
    return kw


def _k1_kw(mode):
    return dict(MODES[mode][0])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fused_modes_equal_per_tile(mode):
    """K2 equals k launches of K1 in the same mode, bitwise, the probe
    resolved from the deepest budget."""
    specs = _specs(mode)
    tiles, census = ce.compute_tiles_mega_cuda(
        specs, MIS, device="cpu", **_mega_kw(mode, len(specs)))
    assert tiles.shape == (3, TILE, TILE) and census.shape == (3, 1)
    cyc = escape_time.resolve_cycle_check(None, max(MIS))
    for t, (spec, mi) in enumerate(zip(specs, MIS)):
        one = ce.compute_tile_cuda_device(spec, mi, cycle_check=cyc,
                                          device="cpu", **_k1_kw(mode))
        assert torch.equal(tiles[t], one), (mode, t)
    assert int(census[2, 0]) == TILE * TILE, "the sky escapes entirely"


def _golden(mode, ref_spec, max_iter):
    cr, ci = ref_spec.grid_2d()
    kw = MODES[mode][0]
    if "julia_c" in kw:
        counts = golden.escape_counts_julia(cr, ci, kw["julia_c"], max_iter)
    else:
        counts = golden.escape_counts_family(
            cr, ci, max_iter, power=kw.get("power", 2),
            burning=kw.get("burning", False))
    return golden.scale_counts_to_uint8(counts, max_iter)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_fused_modes_against_interpret_mode(mode):
    """The reference plan's rows through both megakernels.  Pixels: the
    sky bitwise, the Multibrot's proven-interior disk bitwise, elsewhere
    the port's mismatch against the f64 golden at most the
    interpret-mode kernel's own plus EXTRA.  The bf16 census equals the
    interpret-mode census, tile for tile (measured so in every mode)."""
    ref_specs = _specs(mode, RefSpec)
    kw = _mega_kw(mode, len(ref_specs))
    rows, mrd_rows, _ = pe.mega_dispatch_plan(ref_specs, MIS, block_h=32,
                                              interpret=True, **kw)
    ref_tiles, ref_census = pe.compute_tiles_mega_pallas(
        ref_specs, MIS, block_h=32, interpret=True, **kw)
    tiles, census = ce.compute_tiles_mega_cuda(
        _specs(mode), MIS, rows=np.asarray(rows, np.float32),
        mrd_rows=np.asarray(mrd_rows, np.int32), device="cpu", **kw)
    assert np.array_equal(census.numpy(), np.asarray(ref_census))
    for t, (spec, mi) in enumerate(zip(ref_specs, MIS)):
        got, ref = tiles[t].numpy(), np.asarray(ref_tiles[t])
        if t == 2:
            assert np.array_equal(got, ref)
            continue
        if "power" in MODES[mode][0]:
            cr, ci = spec.grid_2d()
            mask = np.asarray(ref_et.multibrot_interior(cr, ci, 3))
            assert mask.any() or t == 1
            assert np.array_equal(got[mask], ref[mask])
        gold = _golden(mode, spec, mi)
        ours = float((got != gold).mean())
        theirs = float((ref != gold).mean())
        assert ours <= theirs + EXTRA, (mode, t, ours, theirs)


@pytest.mark.parametrize("mode", sorted(MODES) + ["mandelbrot_mxu"])
def test_sharded_odd_batch_equals_one_device(mode):
    """Three tiles over two ring positions (one padded with a trivial
    tile): the pixels and census of the one-device K2, bitwise."""
    if mode == "mandelbrot_mxu":
        specs = [TileSpec(x, y, s, s, width=TILE, height=TILE)
                 for x, y, s in ((-0.8, 0.1, 0.2), (-2.0, -2.0, 4.0), SKY)]
        kw = {"use_mxu": True}
    else:
        specs, kw = _specs(mode), _mega_kw(mode, 3)
    tiles, census = compute_tiles_mega_sharded(
        specs, MIS, mesh=make_mesh(["cpu", "cpu"]), **kw)
    one, one_census = ce.compute_tiles_mega_cuda(specs, MIS, device="cpu",
                                                 **kw)
    assert len(tiles) == len(census) == 3
    for t in range(3):
        assert torch.equal(tiles[t], one[t])
        assert torch.equal(census[t], one_census[t])


def test_pad_mega_follows_the_row_width():
    """The trivial padding row has the width of the batch's rows: 6 for
    Julia (z0 = 3+3i outside the set, c = 0, budget 1)."""
    rows, mrds = _pad_mega([[0.0] * 6] * 3, [[10]] * 3, 2)
    assert len(rows) == 4 and rows[-1] == [3.0, 3.0, 0.0, 0.0, 0.0, 0.0]
    assert mrds[-1] == [1]
    rows, _ = _pad_mega([[0.0] * 4] * 3, [[10]] * 3, 2)
    assert rows[-1] == [3.0, 3.0, 0.0, 0.0]


@pytest.mark.parametrize("bad", ["power", "length", "none"])
def test_julia_guards(bad):
    """Julia is the degree-2 recurrence without a fold, with one
    constant per tile (the reference's plain ValueErrors)."""
    specs = _specs("julia")
    kw = {"julia_cs": [JULIA_C] * 3}
    if bad == "power":
        kw["power"] = 3
        match = "julia mode"
    elif bad == "length":
        kw["julia_cs"] = [JULIA_C] * 2
        match = "constant per tile"
    else:
        kw["julia_cs"] = [JULIA_C, None, JULIA_C]
        match = "constant per tile"
    with pytest.raises(ValueError, match=match):
        ce.compute_tiles_mega_cuda(specs, MIS, device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        pe.mega_dispatch_plan(_specs("julia", RefSpec), MIS, block_h=32,
                              interpret=True, **kw)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_plan_for_modes_equals_the_reference(mode):
    """Rows (6 wide with the Julia constant), budgets, the probe, the
    census window, and the interior check (off in Julia mode)."""
    kw = _mega_kw(mode, 3)
    rows, mrds, plan = ce.mega_dispatch_plan(_specs(mode), MIS, **kw)
    ref_rows, ref_mrds, ref_kw = pe.mega_dispatch_plan(
        _specs(mode, RefSpec), MIS, block_h=32, interpret=True, **kw)
    assert rows.shape == (3, 6 if mode == "julia" else 4)
    assert np.array_equal(rows, np.asarray(ref_rows, np.float32))
    assert np.array_equal(mrds, np.asarray(ref_mrds, np.int32))
    assert plan["interior_check"] == ref_kw["interior_check"]
    assert plan["interior_check"] == (mode != "julia")
    assert plan["cycle_check"] == ref_kw["cycle_check"]
    assert (plan["power"], plan["burning"]) == (ref_kw["power"],
                                                ref_kw["burning"])
    unroll = max(1, min(ref_kw["unroll"], max(1, ref_kw["max_iter"] - 1)))
    assert plan["scout_steps"] == ref_kw["scout_segments"] * unroll


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_census_is_advisory(mode):
    """The census never changes a pixel: off, it is zero and the tiles
    are the same."""
    specs, kw = _specs(mode), _mega_kw(mode, 3)
    on, census_on = ce.compute_tiles_mega_cuda(specs, MIS, device="cpu",
                                               **kw)
    off, census_off = ce.compute_tiles_mega_cuda(specs, MIS,
                                                 scout_segments=0,
                                                 device="cpu", **kw)
    assert torch.equal(on, off)
    assert not census_off.any() and census_on.any()


def test_mode_launch_counts_stay_zero_on_the_cpu():
    ce.reset_launch_counts()
    for mode in MODES:
        ce.compute_tiles_mega_cuda(_specs(mode)[:2], [10, 10], device="cpu",
                                   **_mega_kw(mode, 2))
    counts = ce.launch_counts()
    assert not any(counts.values())
    assert {ce.KERNEL_MEGA_JULIA, ce.KERNEL_MEGA_MULTIBROT,
            ce.KERNEL_MEGA_SHIP} <= set(counts)


if __name__ == "__main__":
    # The counts behind ROADMAP queue 3 (run from the repo root:
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_mega_modes.py):
    # per mode and tile, pixels where K2's plain version and the
    # interpret-mode K2 differ, each one's mismatch against the f64
    # golden, and both censuses; then the matrix form (use_mxu=True) on
    # the seahorse and valley views at 300 against the interpret-mode
    # matrix form and the interpret-mode cached form.
    for mode in sorted(MODES):
        ref_specs = _specs(mode, RefSpec)
        kw = _mega_kw(mode, len(ref_specs))
        ref_tiles, ref_census = pe.compute_tiles_mega_pallas(
            ref_specs, MIS, block_h=32, interpret=True, **kw)
        tiles, census = ce.compute_tiles_mega_cuda(_specs(mode), MIS,
                                                   device="cpu", **kw)
        for t, (spec, mi) in enumerate(zip(ref_specs, MIS)):
            got, ref = tiles[t].numpy(), np.asarray(ref_tiles[t])
            gold = _golden(mode, spec, mi)
            print(f"{mode} tile {t} mi {mi}: port vs ref "
                  f"{int((got != ref).sum())}, port vs golden "
                  f"{int((got != gold).sum())}, ref vs golden "
                  f"{int((ref != gold).sum())} of {TILE * TILE}; census "
                  f"{int(census[t, 0])} / {int(np.asarray(ref_census)[t, 0])}")
    views = [(-0.7436, 0.1317, 2e-3), (-0.8, 0.1, 0.2)]
    ref_specs = [RefSpec(x, y, s, s, width=TILE, height=TILE)
                 for x, y, s in views]
    ref_mxu, _ = pe.compute_tiles_mega_pallas(ref_specs, [300, 300],
                                              block_h=32, interpret=True,
                                              use_mxu=True)
    ref_cached, _ = pe.compute_tiles_mega_pallas(ref_specs, [300, 300],
                                                 block_h=32, interpret=True)
    port, _ = ce.compute_tiles_mega_cuda(
        [TileSpec(x, y, s, s, width=TILE, height=TILE) for x, y, s in views],
        [300, 300], use_mxu=True, device="cpu")
    for t, spec in enumerate(ref_specs):
        cr, ci = spec.grid_2d()
        gold = golden.scale_counts_to_uint8(golden.escape_counts(cr, ci, 300),
                                            300)
        got, rm, rc = (port[t].numpy(), np.asarray(ref_mxu[t]),
                       np.asarray(ref_cached[t]))
        print(f"matrix form {views[t]} mi 300: ref matrix vs ref cached "
              f"{int((rm != rc).sum())}, port vs ref matrix "
              f"{int((got != rm).sum())}, port vs golden "
              f"{int((got != gold).sum())}, ref matrix vs golden "
              f"{int((rm != gold).sum())} of {TILE * TILE}")
