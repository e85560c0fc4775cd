"""The port's mesh routes (``parallel/``) and the batch kernel K3, through
its plain PyTorch version, against the JAX package on the CPU:

- K3's plain version against ``_pallas_escape_batch(..., block_h=32,
  interpret=True)`` at the golden bar, and bitwise K1's plain version
  per tile in every mode;
- the split of a batch over CPU rings of 2 and 3 devices (one device
  named more than once) bitwise equal to one device;
- ``batched_escape_pixels`` and ``compute_tile_row_sharded`` against
  the JAX functions on a one-device CPU mesh;
- ``kernel_batch_config``/``prefer_batch_grid`` field by field against
  ``pallas_batch_config``/``prefer_batch_grid``;
- ``MeshBackend(kernel="cuda")`` on a CPU ring against the JAX
  ``MeshBackend(kernel="xla")``, with the f64 recompute of an
  unresolvable pitch;
- a fused batch past one launch's 128 tiles split over a CPU ring, K3's
  epilogue multipliers, and ``CudaBackend``'s fallback placed as the
  reference's ``PallasBackend`` places it.

The kernels themselves are held bitwise against their plain versions on
the card (test_torch_gpu.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedmandelbrot_tpu.core.geometry import TileSpec as RefSpec
from distributedmandelbrot_tpu.ops import compact_escape as ref_cx
from distributedmandelbrot_tpu.ops import escape_time as ref_et
from distributedmandelbrot_tpu.ops import pallas_escape as pe
from distributedmandelbrot_tpu.ops import reference as golden
from distributedmandelbrot_tpu.parallel import MeshBackend as RefMeshBackend
from distributedmandelbrot_tpu.parallel import mesh as ref_mesh
from distributedmandelbrot_tpu.parallel import sharding as ref_sh
from distributedmandelbrot_tpu.worker import backends as ref_backends
from distributedmandelbrot_tpu_torch.core.geometry import (TileSpec,
                                                           spec_f32_resolvable)
from distributedmandelbrot_tpu_torch.core.workload import Workload
from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.ops import cuda_escape as ce
from distributedmandelbrot_tpu_torch.parallel import MeshBackend
from distributedmandelbrot_tpu_torch.parallel import sharding as sh
from distributedmandelbrot_tpu_torch.parallel.backend import batch_params
from distributedmandelbrot_tpu_torch.parallel.mesh import (make_mesh,
                                                           tile_row_mesh)
from distributedmandelbrot_tpu_torch.worker import CudaBackend

TILE = 128
# The 128^2 views of test_torch_kernels.py.
VIEWS = {"seahorse": (-0.7436, 0.1317, 2e-3), "valley": (-0.8, 0.1, 0.2),
         "full": (-2.0, -2.0, 4.0), "sky": (1.5, 1.5, 0.1),
         "bulb": (-0.2, -0.05, 0.1)}
EXACT = ("sky", "bulb")
DEF = 64


def _ring(n):
    return make_mesh(["cpu"] * n)


def _golden_view(view, max_iter):
    x, y, s = VIEWS[view]
    cr, ci = RefSpec(x, y, s, s, width=TILE, height=TILE).grid_2d()
    return golden.scale_counts_to_uint8(
        golden.escape_counts(cr, ci, max_iter), max_iter), \
        np.asarray(ref_et.mandelbrot_interior(cr, ci))


@pytest.mark.parametrize("max_iter", [300, 1500])
def test_k3_plain_against_interpret_mode(max_iter):
    """Sky/bulb bitwise, proven-interior pixels bitwise, and elsewhere
    the port's mismatch against the f64 golden at most the
    interpret-mode kernel's own plus 0.5 pp (the FMA class of ROADMAP
    queue 3)."""
    specs = [TileSpec(x, y, s, s, width=TILE, height=TILE)
             for x, y, s in VIEWS.values()]
    rows = np.asarray([ce._params_row(s) for s in specs], np.float32)
    mrds = [max_iter] * len(specs)
    got = ce.compute_tiles_batch_cuda(rows, mrds, height=TILE, width=TILE,
                                      device="cpu")
    assert got.shape == (len(specs), TILE, TILE) and got.dtype == torch.uint8
    ref = np.asarray(pe._pallas_escape_batch(
        jnp.asarray(rows), jnp.asarray([[m] for m in mrds], jnp.int32),
        k=len(specs), height=TILE, width=TILE,
        max_iter=pe.bucket_cap(max_iter), block_h=32, interpret=True,
        cycle_check=ref_et.resolve_cycle_check(None, max_iter)))
    for t, view in enumerate(VIEWS):
        ours_px, ref_px = got[t].numpy(), ref[t]
        if view in EXACT:
            assert np.array_equal(ours_px, ref_px), view
            continue
        gold, mask = _golden_view(view, max_iter)
        assert np.array_equal(ours_px[mask], ref_px[mask]), view
        ours = float((ours_px != gold).mean())
        theirs = float((ref_px != gold).mean())
        assert ours <= theirs + 0.005, (view, max_iter, ours, theirs)


MODE_KW = {"mandelbrot": {}, "julia": {"julia_c": complex(-0.8, 0.156)},
           "multibrot3": {"power": 3}, "ship": {"burning": True}}


@pytest.mark.parametrize("mode", sorted(MODE_KW))
def test_k3_plain_is_k1_plain_per_tile(mode):
    kw = dict(MODE_KW[mode])
    jc = kw.pop("julia_c", None)
    specs = [TileSpec(x, y, s, s, width=DEF, height=DEF)
             for x, y, s in VIEWS.values()]
    rows = np.asarray([ce._params_row(s, jc) for s in specs], np.float32)
    mrds = [300, 5000, 2, 1100, 90]
    got = ce.compute_tiles_batch_cuda(rows, mrds, height=DEF, width=DEF,
                                      clamp=True, device="cpu", **kw)
    cyc = ce.escape_time.resolve_cycle_check(None, max(mrds))
    for t, (row, mi) in enumerate(zip(rows, mrds)):
        one = ce.compute_tile_row_cuda(row, mi, DEF, DEF, clamp=True,
                                       cycle_check=cyc, device="cpu", **kw)
        assert torch.equal(got[t], one), (mode, t)


def test_k3_wrapper_checks_and_counts():
    """On the CPU the wrapper takes the plain version (no launch); the
    int32 budget declines; shapes are checked."""
    rows = np.zeros((2, 4), np.float32)
    ce.reset_launch_counts()
    out = ce.compute_tiles_batch_cuda(rows, [1, 1], height=8, width=8,
                                      device="cpu")
    assert out.shape == (2, 8, 8) and not out.any()
    assert ce.launch_counts()[ce.KERNEL_BATCH] == 0
    with pytest.raises(ce.KernelUnsupported):
        ce.compute_tiles_batch_cuda(rows, [2, 10**7], height=8, width=8,
                                    device="cpu")
    with pytest.raises(ValueError):
        ce.compute_tiles_batch_cuda(np.zeros((2, 5), np.float32), [1, 1],
                                    height=8, width=8, device="cpu")
    assert ce.compute_tiles_batch_cuda(
        np.zeros((0, 4), np.float32), [], height=8, width=8,
        device="cpu").shape == (0, 8, 8)


def _mixed_batch(definition=DEF):
    ws = [Workload(4, mi, i, j) for (i, j), mi in zip(
        [(0, 0), (1, 1), (1, 2), (2, 1), (3, 3)], [300, 50, 5000, 1, 120])]
    return ws, batch_params(ws, definition)


@pytest.mark.parametrize("n_dev", [2, 3])
def test_split_over_a_ring_equals_one_device(n_dev):
    """5 tiles with mixed budgets over 2 and 3 shards (padded with
    trivial tiles): the kernels' route, the torch loop and the fused
    route each equal their one-device result, bitwise."""
    ws, (params, mrds) = _mixed_batch()
    one = sh.batched_escape_pixels_cuda(_ring(1), params, mrds,
                                        definition=DEF)
    got = sh.batched_escape_pixels_cuda(_ring(n_dev), params, mrds,
                                        definition=DEF)
    assert got.shape == (5, DEF, DEF) and np.array_equal(got, one)
    loop1 = sh.batched_escape_pixels(_ring(1), params, mrds, definition=DEF)
    loop = sh.batched_escape_pixels(_ring(n_dev), params, mrds,
                                    definition=DEF)
    assert np.array_equal(loop, loop1)
    specs = [TileSpec.for_chunk(w.level, w.index_real, w.index_imag,
                                definition=DEF) for w in ws]
    mis = [max(2, w.max_iter) for w in ws]
    tiles, scout = sh.compute_tiles_mega_sharded(specs, mis,
                                                 mesh=_ring(n_dev))
    ftiles, fscout = ce.compute_tiles_mega_cuda(specs, mis, device="cpu")
    assert len(tiles) == len(scout) == 5
    assert torch.equal(torch.stack(tiles), ftiles)
    assert torch.equal(torch.stack(scout), fscout)


def test_a_129_tile_batch_splits_over_a_ring():
    """129 small tiles (one more than a launch takes) on a two-entry
    ring: two shards of 65 (one trivial padding tile), pixels and census
    equal to the one-device fused route, bitwise."""
    rng = np.random.default_rng(17)
    specs = []
    for _ in range(129):
        cx, cy = rng.uniform(-2.0, 0.5), rng.uniform(-1.2, 1.2)
        span = float(10 ** rng.uniform(-2, 0))
        specs.append(TileSpec(cx, cy, span, span, width=32, height=8))
    mis = [int(m) for m in rng.integers(1, 301, 129)]
    tiles, scout = sh.compute_tiles_mega_sharded(specs, mis, mesh=_ring(2))
    ftiles, fscout = ce.compute_tiles_mega_cuda(specs, mis, device="cpu")
    assert len(tiles) == len(scout) == 129
    assert torch.equal(torch.stack(tiles), ftiles)
    assert torch.equal(torch.stack(scout), fscout)
    assert fscout.any()


def test_k3_epilogue_multipliers_divide_exactly():
    """K3 reads each budget's epilogue multiplier from device memory: a
    high multiply by it equals the int32 ceil-division of the plain
    version's epilogue for every dividend a count gives, at edge budgets
    and budgets from a numpy seed."""
    rng = np.random.default_rng(23)
    budgets = [-3, 0, 1, 2, 3, 255, 256, 257, 1000, 4096, 5000,
               ce.escape_time.INT32_SCALE_LIMIT]
    budgets += [int(b) for b in rng.integers(2, 10**6, 40)]
    mult = ce.epilogue_multipliers(np.asarray(budgets, np.int32))
    assert mult.dtype == np.uint64 and mult.shape == (len(budgets),)
    for mrd, m in zip(budgets, mult.tolist()):
        d = max(mrd, 2)
        assert m == (2**64 - 1) // d + 1
        if mrd <= 1:
            continue
        counts = {0, 1, 2, mrd - 2, mrd - 1, *rng.integers(0, mrd, 20)}
        for count in counts:
            x = int(count) * 256 + mrd - 1
            assert (x * m) >> 64 == x // mrd, (mrd, count)


def test_cuda_backend_fallback_stays_where_the_reference_puts_it(
        monkeypatch):
    """A ring batch holding an f32-unresolvable pitch: the mesh route and
    the fused route decline (one demotion each), and every tile goes to
    ``dispatch_tile`` with the device the caller gave (None: the
    backend's own), as the reference's ``PallasBackend.dispatch_many``
    hands its fallback ``device``; the pixels equal the per-tile
    route's."""
    deep = Workload(200000, 40, 0, 0)  # pitch below f32 at |c| ~ 2
    assert not spec_f32_resolvable(TileSpec.for_chunk(
        deep.level, 0, 0, definition=DEF))
    ws = [Workload(4, 40, 3, 3), deep, Workload(4, 300, 1, 1)]
    ring = CudaBackend(definition=DEF, device="cpu", mesh=_ring(2))
    calls = []
    per_tile = ring.dispatch_tile

    def spy(w, device=None):
        calls.append((w.key, device))
        return per_tile(w, device)

    monkeypatch.setattr(ring, "dispatch_tile", spy)
    got = [ring.materialize_tile(h) for h in ring.dispatch_many(ws)]
    assert calls == [(w.key, None) for w in ws]
    assert ring.demotions(obs_names.ROUTE_MESH_TO_FUSED) == 1
    assert ring.demotions(obs_names.ROUTE_FUSED_TO_PER_TILE) == 1
    assert ring.demotions(obs_names.ROUTE_PER_TILE_TO_TORCH) == 1
    want = [per_tile(w) for w in ws]
    assert all(np.array_equal(a, ring.materialize_tile(b))
               for a, b in zip(got, want))
    calls.clear()
    ring.dispatch_many(ws, device="cpu")
    assert calls == [(w.key, "cpu") for w in ws]


def test_padding_rows_equal_the_reference():
    params = np.asarray([[-2.0, -2.0, 0.01], [0.5, 0.25, 0.02]])
    mrds = np.asarray([100, 7])
    for n_dev in (1, 2, 3, 4):
        got = sh.pad_to_mesh(params, mrds, n_dev)
        want = ref_sh.pad_to_mesh(params, mrds, n_dev)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        rows = [[1.0, 2.0, 0.1, 0.1], [3.0, 4.0, 0.2, 0.2]]
        assert sh._pad_mega(rows, [[5], [6]], n_dev) == ref_sh._pad_mega(
            rows, [[5], [6]], n_dev)
    assert np.array_equal(sh.widen_square_pitch(params),
                          ref_sh.widen_square_pitch(params))


def _route_spy(monkeypatch):
    calls = []
    for name in ("compute_tiles_batch_cuda", "compute_tile_row_cuda"):
        real = getattr(ce, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(ce, name, spy)
    real_compact = sh.compact_escape_batch

    def compact(*a, **k):
        calls.append("compact_escape_batch")
        return real_compact(*a, **k)
    monkeypatch.setattr(sh, "compact_escape_batch", compact)
    return calls


def test_each_shard_takes_the_reference_route(monkeypatch):
    """K3 for a deep budget (or a small grid) when a shard holds more
    than one tile, a K1 chain otherwise, the compacted pipeline under
    DMTPU_COMPACT=1 in its band — the same decisions as the
    reference's ``_batched_pallas_sharded``."""
    calls = _route_spy(monkeypatch)
    sky = np.asarray([[1.5, 1.5, 1e-4]] * 2)
    sh.batched_escape_pixels_cuda(_ring(1), sky, np.asarray([4096, 10]),
                                  definition=1024)
    assert calls == ["compute_tiles_batch_cuda"]
    calls.clear()
    sh.batched_escape_pixels_cuda(_ring(2), sky, np.asarray([4096, 10]),
                                  definition=1024)
    assert calls == ["compute_tile_row_cuda"] * 2  # one tile per shard
    calls.clear()
    sh.batched_escape_pixels_cuda(_ring(1), sky, np.asarray([600, 10]),
                                  definition=1024)
    assert calls == ["compute_tile_row_cuda"] * 2
    calls.clear()
    monkeypatch.setenv("DMTPU_COMPACT", "1")
    got = sh.batched_escape_pixels_cuda(_ring(1), sky,
                                        np.asarray([600, 10]),
                                        definition=512)
    assert calls == ["compact_escape_batch"]
    monkeypatch.delenv("DMTPU_COMPACT")
    calls.clear()
    want = sh.batched_escape_pixels_cuda(_ring(1), sky,
                                         np.asarray([600, 10]),
                                         definition=512)
    assert calls == ["compute_tiles_batch_cuda"]
    assert np.array_equal(got, want)


DEFINITIONS = [128, 256, 384, 512, 1024, 4096]
CAPS = [2, 256, 257, 513, 600, 1000, 1023, 1024, 2049, 4095, 4096, 5000,
        9000]


@pytest.mark.parametrize("opted_in", [False, True])
def test_batch_config_equals_the_reference(monkeypatch, opted_in):
    """Every field the port keeps (bucketed cap, probe, batch grid,
    compaction) equals ``pallas_batch_config``'s over a grid of
    (definition, cap), with and without the compaction opt-in."""
    monkeypatch.setattr(ref_cx, "_COMPACT_OPTED_IN", opted_in)
    monkeypatch.setenv("DMTPU_COMPACT", "1" if opted_in else "0")
    for d in DEFINITIONS:
        for cap in CAPS:
            want = ref_sh.pallas_batch_config(d, cap, interpret=True)
            got = sh.kernel_batch_config(d, cap)
            assert got == {k: want[k] for k in got}, (d, cap)
            bh, bw = pe.fit_blocks(d, d)
            assert ce.prefer_batch_grid(cap, d, d) == pe.prefer_batch_grid(
                cap, d, d, bh, bw)
    with pytest.raises(ce.KernelUnsupported):
        sh.kernel_batch_config(4096, ref_et.INT32_SCALE_LIMIT + 1)
    with pytest.raises(pe.PallasUnsupported):
        ref_sh.pallas_batch_config(4096, ref_et.INT32_SCALE_LIMIT + 1)
    # No extent is refused for the reference's granule: a 64-wide tile
    # has no (64, 128) block, so it always batches.
    assert sh.kernel_batch_config(64, 300)["batch_grid"]


def _bar(got, want, gold):
    """The FMA-class bar between the port and the JAX package's XLA path
    on the same device grid: at most 2% of pixels differ (the
    reference's own budget between two XLA compiles), and the port is
    no further from the f64 golden than the reference plus 0.5 pp."""
    got, want, gold = (np.asarray(a).ravel() for a in (got, want, gold))
    assert float((got != want).mean()) <= 0.02
    assert float((got != gold).mean()) <= float((want != gold).mean()) + 0.005


def _golden_tile(w, definition=DEF):
    spec = RefSpec.for_chunk(w.level, w.index_real, w.index_imag,
                             definition=definition)
    cr, ci = spec.grid_2d()
    return golden.scale_counts_to_uint8(
        golden.escape_counts(cr, ci, w.max_iter), w.max_iter)


def test_torch_loop_against_the_jax_batch_on_one_device():
    ws, (params, mrds) = _mixed_batch()
    got = sh.batched_escape_pixels(_ring(1), params, mrds, definition=DEF)
    want = np.asarray(ref_sh.batched_escape_pixels(
        ref_mesh.tile_mesh(1), params, mrds, definition=DEF))
    assert got.shape == want.shape == (5, DEF, DEF)
    for t, w in enumerate(ws):
        _bar(got[t], want[t], _golden_tile(w))


def test_row_sharded_tile_against_the_jax_one():
    spec = TileSpec(-0.8, 0.1, 0.2, 0.2, width=DEF, height=DEF)
    ref_spec = RefSpec(-0.8, 0.1, 0.2, 0.2, width=DEF, height=DEF)
    got = sh.compute_tile_row_sharded(tile_row_mesh(1, 4, ["cpu"] * 4),
                                      spec, 200)
    one = sh.compute_tile_row_sharded(tile_row_mesh(1, 1, ["cpu"]), spec,
                                      200)
    assert got.shape == (DEF, DEF) and np.array_equal(got, one)
    want = np.asarray(ref_sh.compute_tile_row_sharded(
        ref_mesh.tile_row_mesh(1, 1), ref_spec, 200))
    cr, ci = ref_spec.grid_2d()
    gold = golden.scale_counts_to_uint8(golden.escape_counts(cr, ci, 200),
                                        200)
    _bar(got, want, gold)
    with pytest.raises(ValueError):
        sh.compute_tile_row_sharded(tile_row_mesh(1, 4, ["cpu"] * 4),
                                    TileSpec(0, 0, 1, 1, width=62,
                                             height=62), 10)


def test_mesh_backend_against_the_jax_mesh_backend():
    """``kernel="cuda"`` on a 2-device CPU ring (the kernels' plain
    versions) against the JAX backend's XLA route on two devices: the
    FMA-class bar per tile; the unresolvable-pitch tile, recomputed in
    f64 by both, is the golden bitwise on the port's side."""
    deep = Workload(40000, 40, 0, 0)  # pitch 7.9e-7 at |c| ~ 2
    ws = [Workload(4, 64, i, j) for i in range(2) for j in range(2)] + [deep]
    got = MeshBackend(definition=DEF, mesh=_ring(2),
                      kernel="cuda").compute_batch(ws)
    want = RefMeshBackend(definition=DEF, mesh=ref_mesh.tile_mesh(2),
                          kernel="xla").compute_batch(ws)
    assert len(got) == len(ws)
    for w, a, b in zip(ws, got, want):
        assert a.shape == (DEF * DEF,) and a.dtype == np.uint8
        gold = ref_backends.NumpyBackend(definition=DEF).compute_batch(
            [w])[0]
        if w is deep:
            assert np.array_equal(a, gold)
        _bar(a, b, gold)
    assert MeshBackend(definition=DEF, mesh=_ring(2)).compute_batch([]) == []


def test_mesh_backend_routes_and_declines(monkeypatch):
    """``auto`` on a CPU ring takes the torch loop; ``torch`` too; the
    int32-budget decline raises under ``cuda`` and, where ``auto``
    picks the kernels, demotes the batch to the torch loop, counted."""
    sky = [Workload(4, 9_000_000, 3, 3)]
    loop = MeshBackend(definition=DEF, mesh=_ring(1), kernel="torch")
    assert not MeshBackend(definition=DEF, mesh=_ring(1))._use_kernel()
    with pytest.raises(ce.KernelUnsupported):
        MeshBackend(definition=DEF, mesh=_ring(1),
                    kernel="cuda").compute_batch(sky)
    auto = MeshBackend(definition=DEF, mesh=_ring(1))
    monkeypatch.setattr(auto, "_use_kernel", lambda: True)
    got = auto.compute_batch(sky)
    assert np.array_equal(got[0], loop.compute_batch(sky)[0])
    assert auto.demotions() == 1
    assert auto.registry.counter_value(
        obs_names.WORKER_KERNEL_DEMOTIONS,
        {"route": obs_names.ROUTE_BATCH_TO_TORCH}) == 1
    with pytest.raises(ValueError):
        MeshBackend(definition=DEF, mesh=_ring(1), kernel="xla")
    with pytest.raises(ValueError):
        MeshBackend(definition=DEF, mesh=_ring(1), dtype=np.float64,
                    kernel="cuda")


def test_cuda_backend_mesh_route_on_a_ring(monkeypatch):
    """``dispatch_many`` on a 2-device ring splits the batch (one fused
    launch per device, counted as a mesh launch) and equals the
    one-device fused route; ``DMTPU_MESH=0`` and a pinned device keep
    one launch; a declined batch demotes to the fused route."""
    ws = [Workload(4, 300, i, j) for i in range(2) for j in range(2)]
    ws.append(Workload(4, 300, 3, 3))
    one = CudaBackend(definition=DEF, device="cpu")
    assert one.mesh_width == 1 and len(one.devices()) == 1
    want = [one.materialize_tile(h) for h in one.dispatch_many(ws)]
    ring = CudaBackend(definition=DEF, device="cpu", mesh=_ring(2))
    assert ring.mesh_width == 2 and len(ring.devices()) == 2
    got = [ring.materialize_tile(h) for h in ring.dispatch_many(ws)]
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    reg = ring.registry
    assert reg.counter_value(obs_names.WORKER_MESH_LAUNCHES) == 1
    assert reg.counter_value(obs_names.WORKER_MESH_DEVICES) == 2
    ring.dispatch_many(ws, device="cpu")
    assert reg.counter_value(obs_names.WORKER_MESH_LAUNCHES) == 1
    assert reg.counter_value(obs_names.WORKER_KERNEL_FUSED_LAUNCHES) == 2
    monkeypatch.setenv("DMTPU_MESH", "0")
    assert CudaBackend(definition=DEF, device="cpu",
                       mesh=_ring(2)).mesh_width == 1
    monkeypatch.delenv("DMTPU_MESH")

    def decline(*a, **k):
        raise ce.KernelUnsupported("declined")
    monkeypatch.setattr(sh, "compute_tiles_mega_sharded", decline)
    got = [ring.materialize_tile(h) for h in ring.dispatch_many(ws)]
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert ring.demotions(obs_names.ROUTE_MESH_TO_FUSED) == 1


def test_tile_mesh_needs_a_gpu(monkeypatch):
    from distributedmandelbrot_tpu_torch.parallel import mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.tile_mesh()
    with pytest.raises(RuntimeError):
        MeshBackend(definition=DEF)
    ring = make_mesh(["cpu", "cpu"])
    assert ring.shape == {"tiles": 2} and ring.devices.size == 2
    grid = tile_row_mesh(2, 2, ["cpu"] * 4)
    assert grid.shape == {"tiles": 2, "rows": 2}
    with pytest.raises(ValueError):
        tile_row_mesh(2, 3, ["cpu"] * 4)


if __name__ == "__main__":
    # The counts behind ROADMAP queue 3 (run from the repo root:
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_sharding.py):
    # per view, pixels where K3's plain version and the interpret-mode
    # K3 differ, and each one's mismatch against the f64 golden.
    specs = [TileSpec(x, y, s, s, width=TILE, height=TILE)
             for x, y, s in VIEWS.values()]
    rows = np.asarray([ce._params_row(s) for s in specs], np.float32)
    for mi in (300, 1500):
        got = ce.compute_tiles_batch_cuda(rows, [mi] * len(specs),
                                          height=TILE, width=TILE,
                                          device="cpu").numpy()
        ref = np.asarray(pe._pallas_escape_batch(
            jnp.asarray(rows), jnp.asarray([[mi]] * len(specs), jnp.int32),
            k=len(specs), height=TILE, width=TILE,
            max_iter=pe.bucket_cap(mi), block_h=32, interpret=True,
            cycle_check=ref_et.resolve_cycle_check(None, mi)))
        for t, view in enumerate(VIEWS):
            gold, _ = _golden_view(view, mi)
            print(f"{view} mi {mi}: port vs ref "
                  f"{int((got[t] != ref[t]).sum())}, port vs golden "
                  f"{int((got[t] != gold).sum())}, ref vs golden "
                  f"{int((ref[t] != gold).sum())} of {TILE * TILE}")
