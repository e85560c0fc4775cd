"""The compacted two-phase pipeline (``ops/compact_escape.py``: K6, the
torch glue, one K7 launch over the live lanes' indices) on the CPU,
where it runs K6's and K7's plain versions through the same glue as on
the card:

- bitwise equal to K3's plain version on every case of the reference's
  ``tests/test_compact.py`` (boundary and mixed budgets, a shallow tile
  in a deep batch, the overflow, the Julia/ship/Multibrot/clamp
  matrix);
- the same cases against the JAX ``compact_escape_batch(interpret=
  True)`` at the golden bar (the FMA class of ROADMAP queue 3);
- K7 over an index list equal to K7 over the lanes it lists;
- the reference's policy declines, and the TPU-layout guards the port
  drops;
- ``prefer_compaction`` and ``compact_capacity`` equal to the
  reference's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedmandelbrot_tpu.ops import compact_escape as ref_cx
from distributedmandelbrot_tpu.ops import escape_time as ref_et
from distributedmandelbrot_tpu.ops import reference as golden
from distributedmandelbrot_tpu_torch.ops import compact_escape as cx
from distributedmandelbrot_tpu_torch.ops import cuda_escape as ce

N = 128
JULIA_C = (-0.8, 0.156)


def _params(cx_, cy, span, n, extra=()):
    s = span / (n - 1)
    return [cx_ - span / 2, cy - span / 2, s, s, *extra]


BOUNDARY = _params(-0.7436447, 0.1318252, 2e-3, N)  # no provable interior
FULLVIEW = _params(-0.5, 0.0, 3.0, N)               # interior + sky mix

# name -> (rows, budgets, reference keywords): tests/test_compact.py's.
CASES = {
    "boundary_and_mixed_budgets": ([BOUNDARY, FULLVIEW], [700, 650], {}),
    "shallow_tile_in_deep_batch": ([BOUNDARY, FULLVIEW], [700, 200], {}),
    "julia": ([_params(0.0, 0.0, 3.0, N, JULIA_C)], [700], {"julia": True}),
    "ship": ([_params(-1.7443, -0.0356, 0.01, N)], [700], {"burning": True}),
    "multibrot": ([BOUNDARY], [700], {"power": 3}),
    "clamp": ([BOUNDARY], [700], {"clamp": True}),
}
# The reference's overflow case: one compact block of capacity, rounds
# of 64 steps.  The port has no buffer and no rounds: it takes the same
# phase, and its one K7 launch runs more live lanes than that capacity.
OVERFLOW = dict(cap_lanes=4096, phase_budget=64, seg_steps=64)
PORT_OVERFLOW = dict(phase_budget=OVERFLOW["phase_budget"])
# The Mandelbrot cases whose live lanes after that phase exceed it.
OVER_CAPACITY = ("boundary_and_mixed_budgets", "clamp",
                 "shallow_tile_in_deep_batch")


def _port_kw(kw):
    """The port infers Julia mode from 6-wide rows."""
    return {k: v for k, v in kw.items() if k != "julia"}


def _k3_plain(rows, mrds, kw):
    return ce.compute_tiles_batch_cuda(
        np.asarray(rows, np.float32), mrds, height=N, width=N,
        cycle_check=False, device="cpu", **_port_kw(kw))


def _compacted(rows, mrds, kw, **extra):
    return cx.compact_escape_batch(
        np.asarray(rows, np.float32), mrds, k=len(rows), height=N, width=N,
        max_iter=max(mrds), device="cpu", **_port_kw(kw), **extra)


@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_compacted_pipeline_is_bitwise_k3(case, overflow):
    rows, mrds, kw = CASES[case]
    got = _compacted(rows, mrds, kw, **(PORT_OVERFLOW if overflow else {}))
    assert got.shape == (len(rows), N, N) and got.dtype == torch.uint8
    assert torch.equal(got, _k3_plain(rows, mrds, kw))
    if overflow and case in OVER_CAPACITY:
        # More live lanes than the reference's capacity: its overflow
        # path, one launch here.
        state = cx.escape_state_plain(
            np.asarray(rows, np.float32), mrds, height=N, width=N,
            phase_budget=OVERFLOW["phase_budget"])
        assert int((state[5] != 0).sum()) > OVERFLOW["cap_lanes"]


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_resume_over_an_index_list(dtype):
    """K7 over an index list updates the listed lanes where they lie as
    a round over those lanes gathered would, and leaves the others as
    they were (their act included)."""
    rows = np.asarray([BOUNDARY, FULLVIEW], np.float32)
    planes = [t.reshape(-1).contiguous() for t in cx.escape_state_plain(
        rows, [700, 650], height=N, width=N)]
    cr, ci, zr, zi, n, act = planes
    dyn = torch.full_like(n, 699)
    dyn[N * N:] = 649
    idx = torch.nonzero(act).squeeze(1)[::3].to(dtype)
    got = cx.escape_resume_cuda(257, 300, dyn, cr, ci, zr, zi, n, act,
                                idx=idx)
    sel = idx.to(torch.int64)
    want = cx.escape_resume_plain(257, 300, dyn[sel], cr[sel], ci[sel],
                                  zr[sel], zi[sel], n[sel], act[sel])
    rest = torch.ones_like(act, dtype=torch.bool)
    rest[sel] = False
    for g, w, before in zip(got, want, (zr, zi, n, act)):
        assert torch.equal(g[sel], w)
        assert torch.equal(g[rest], before[rest])
    assert (got[3][sel] == 0).any() and (got[3][rest] != 0).any()


def _golden(row, mrd, kw):
    """The f64 golden on the host linspace grid of a params row."""
    start_r, start_i, step = row[0], row[1], row[2]
    re = np.linspace(start_r, start_r + step * (N - 1), N)
    im = np.linspace(start_i, start_i + step * (N - 1), N)
    cr, ci = np.meshgrid(re, im)
    if kw.get("julia"):
        counts = golden.escape_counts_julia(cr, ci, complex(*row[4:6]), mrd)
    elif kw.get("power", 2) != 2 or kw.get("burning"):
        counts = golden.escape_counts_family(
            cr, ci, mrd, power=kw.get("power", 2),
            burning=kw.get("burning", False))
    else:
        counts = golden.escape_counts(cr, ci, mrd)
    return golden.scale_counts_to_uint8(counts, mrd,
                                        clamp=kw.get("clamp", False))


def _reference(rows, mrds, kw, overflow):
    params = jnp.asarray(rows, jnp.float32)
    budgets = jnp.asarray([[m] for m in mrds], jnp.int32)
    if not overflow:
        return np.asarray(ref_cx.compact_escape_batch(
            params, budgets, k=len(rows), height=N, width=N,
            max_iter=max(mrds), interpret=True, **kw))
    return np.asarray(ref_cx._compact_escape(
        params, budgets, k=len(rows), height=N, width=N,
        max_iter=max(mrds), block_h=64, block_w=128, unroll=64,
        clamp=kw.get("clamp", False), interior_check=True,
        julia=kw.get("julia", False), power=kw.get("power", 2),
        burning=kw.get("burning", False), interpret=True, **OVERFLOW))


@pytest.mark.parametrize("case", sorted(CASES) + ["overflow"])
def test_against_the_jax_pipeline_at_the_bar(case):
    """Per tile, the port's mismatch against the f64 golden is at most
    the interpret-mode pipeline's own plus 0.5 pp (XLA:CPU contracts
    the reference's recurrence into FMAs, the port does not)."""
    overflow = case == "overflow"
    rows, mrds, kw = CASES["boundary_and_mixed_budgets" if overflow
                           else case]
    got = _compacted(rows, mrds, kw, **(PORT_OVERFLOW if overflow else {}))
    ref = _reference(rows, mrds, kw, overflow)
    assert ref.shape == tuple(got.shape)
    for t, (row, mrd) in enumerate(zip(rows, mrds)):
        gold = _golden(row, mrd, kw)
        ours = float((got[t].numpy() != gold).mean())
        theirs = float((ref[t] != gold).mean())
        assert ours <= theirs + 0.005, (case, t, ours, theirs)


def test_policy_declines_and_dropped_layout_guards():
    """The reference's policy declines raise KernelUnsupported with its
    wording; its TPU-layout guards (unroll-aligned phases, a 128-lane
    width, block-divisible extents) are gone: such batches run, bitwise
    K3."""
    rows = np.asarray([BOUNDARY], np.float32)
    with pytest.raises(ce.KernelUnsupported, match="cycle probe"):
        cx.compact_escape_batch(rows, [8192], k=1, height=N, width=N,
                                max_iter=8192, device="cpu")
    with pytest.raises(ce.KernelUnsupported, match="phase 1"):
        cx.compact_escape_batch(rows, [200], k=1, height=N, width=N,
                                max_iter=200, device="cpu")
    odd = np.asarray([_params(-0.7436447, 0.1318252, 2e-3, 100)],
                     np.float32)
    got = cx.compact_escape_batch(odd, [700], k=1, height=100, width=100,
                                  max_iter=700, phase_budget=100,
                                  device="cpu")
    want = ce.compute_tiles_batch_cuda(odd, [700], height=100, width=100,
                                       cycle_check=False, device="cpu")
    assert torch.equal(got, want)
    ce.reset_launch_counts()
    _compacted([BOUNDARY], [700], {})
    counts = ce.launch_counts()
    assert counts[ce.KERNEL_STATE] == counts[ce.KERNEL_RESUME] == 0


def test_state_and_resume_plain_versions():
    """K6's planes: c is the grid, interior pixels start at n = dyn with
    act 0, a tile whose budget fits in phase 1 has no live lane; one K7
    round moves n forward only on live lanes."""
    rows = np.asarray([FULLVIEW, BOUNDARY], np.float32)
    cr, ci, zr, zi, n, act = cx.escape_state_plain(rows, [200, 700],
                                                   height=N, width=N)
    assert cr.dtype == zr.dtype == torch.float32
    assert n.dtype == act.dtype == torch.int32
    assert not act[0].any() and act[1].any()
    inside = ce.escape_time.mandelbrot_interior(cr[0], ci[0])
    assert (n[0][inside] == 199).all()
    assert int(n[1].max()) == cx.PHASE1_BUDGET
    flat = [t[1].reshape(-1).contiguous() for t in (cr, ci, zr, zi, n, act)]
    dyn = torch.full_like(flat[4], 699)
    zr2, zi2, n2, act2 = cx.escape_resume_plain(257, 256, dyn, *flat)
    live = flat[5] != 0
    assert torch.equal(n2[~live], flat[4][~live])
    assert (n2[live] >= flat[4][live]).all() and (n2 <= 512).all()
    assert not (act2.bool() & ~live).any()


def test_capacity_and_policy_equal_the_reference(monkeypatch):
    for n_pixels in (1, 4095, 4096, 100_000, 128 * 128 * 3,
                     4 * 4096 * 4096):
        assert cx.compact_capacity(n_pixels) == ref_cx.compact_capacity(
            n_pixels)
    budgets = (256, 257, 512, 513, 514, 700, 1000, 1023, 1024, 5000)
    sizes = (128 * 128, 512 * 512 - 1, 512 * 512, 4096 * 4096)
    for opted in (False, True):
        monkeypatch.setattr(ref_cx, "_COMPACT_OPTED_IN", opted)
        monkeypatch.setenv("DMTPU_COMPACT", "1" if opted else "0")
        for b in budgets:
            for size in sizes:
                assert cx.prefer_compaction(b, size) == \
                    ref_cx.prefer_compaction(b, size), (opted, b, size)
    assert cx.PHASE1_BUDGET == ref_cx.PHASE1_BUDGET
    assert cx.RESUME_SEG == ref_cx.RESUME_SEG
    assert cx.COMPACT_CAPACITY_FRAC == ref_cx.COMPACT_CAPACITY_FRAC
    assert ref_et.CYCLE_CHECK_MIN_ITER == ce.escape_time.CYCLE_CHECK_MIN_ITER


if __name__ == "__main__":
    # The counts behind ROADMAP queue 3 (run from the repo root:
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_compact.py):
    # per case and tile, pixels where the port's pipeline and the
    # interpret-mode one differ, and each one's mismatch against the
    # f64 golden, of N*N.
    for case in sorted(CASES) + ["overflow"]:
        overflow = case == "overflow"
        rows, mrds, kw = CASES["boundary_and_mixed_budgets" if overflow
                               else case]
        got = _compacted(rows, mrds, kw, **(PORT_OVERFLOW if overflow else {}))
        ref = _reference(rows, mrds, kw, overflow)
        for t, (row, mrd) in enumerate(zip(rows, mrds)):
            gold = _golden(row, mrd, kw)
            ours = got[t].numpy()
            print(f"{case} tile {t} mi {mrd}: port vs ref "
                  f"{int((ours != ref[t]).sum())}, port vs golden "
                  f"{int((ours != gold).sum())}, ref vs golden "
                  f"{int((ref[t] != gold).sum())} of {N * N}")
