"""The port's CUDA kernels on the card, bitwise against their plain
PyTorch versions on CUDA tensors.  Marked ``gpu``: they skip without a
CUDA device and run on an H100 with

    python -m pytest -q -m gpu tests/test_torch_gpu.py

(the file imports nothing of JAX, so it runs where JAX is absent)."""

import ctypes
import threading

import numpy as np
import pytest
import torch

from distributedmandelbrot_tpu_torch.core.geometry import TileSpec
from distributedmandelbrot_tpu_torch.core.workload import Workload
from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.ops import cuda_escape as ce
from distributedmandelbrot_tpu_torch.worker import backends as bk

pytestmark = pytest.mark.gpu

VIEWS = [(-0.7436, 0.1317, 2e-3), (-0.8, 0.1, 0.2), (-2.0, -2.0, 4.0),
         (1.5, 1.5, 0.1), (-0.2, -0.05, 0.1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _views(size=128):
    return [TileSpec(x, y, s, s, width=size, height=size)
            for x, y, s in VIEWS]


def _plain_tile(spec, mi, dev):
    return ce.escape_tile_plain(
        ce._params_row(spec), mi, spec.height, spec.width,
        cycle_check=ce.escape_time.resolve_cycle_check(None, mi), device=dev)


@pytest.mark.parametrize("max_iter", [2, 256, 1024, 2000])
def test_k1_is_bitwise_its_plain_version(cuda, max_iter):
    specs = _views() + [TileSpec(-0.75, 0.05, 0.3, 0.1, width=200,
                                 height=77),
                        TileSpec.for_chunk(4, 1, 2)]
    for spec in specs:
        got = ce.compute_tile_cuda_device(spec, max_iter, device=cuda)
        assert got.device == cuda and got.shape == (spec.height, spec.width)
        assert torch.equal(got, _plain_tile(spec, max_iter, cuda)), spec


@pytest.mark.parametrize("mis", [[300, 150, 80, 260, 2000],
                                 [2000, 2000, 2000, 2000, 2000],
                                 [1, 1, 1, 1, 1]])
def test_k2_is_bitwise_its_plain_version_and_k1(cuda, mis):
    specs = _views()
    tiles, census = ce.compute_tiles_mega_cuda(specs, mis, device=cuda)
    rows, mrds, kw = ce.mega_dispatch_plan(specs, mis)
    ptiles, pcensus = ce.escape_mega_plain(rows, mrds, device=cuda, **kw)
    assert torch.equal(tiles, ptiles)
    assert torch.equal(census, pcensus)
    for t, (spec, mi) in enumerate(zip(specs, mis)):
        one = ce.compute_tile_cuda_device(spec, mi, device=cuda)
        assert torch.equal(tiles[t], one)


def test_launch_counts_count_card_launches_only(cuda):
    ce.reset_launch_counts()
    spec = _views()[3]
    ce.compute_tile_cuda_device(spec, 100, device=cuda)
    ce.compute_tiles_mega_cuda([spec, spec], [100, 300], device=cuda)
    ce.compute_tile_cuda_device(spec, 100, device="cpu")
    assert ce.launch_counts() == {ce.KERNEL_TILE: 1, ce.KERNEL_MEGA: 1,
                                  ce.KERNEL_SMOOTH: 0, ce.KERNEL_PACK: 0,
                                  ce.KERNEL_BATCH: 0, ce.KERNEL_STATE: 0,
                                  ce.KERNEL_RESUME: 0,
                                  ce.KERNEL_TILE_MXU: 0,
                                  ce.KERNEL_MEGA_MXU: 0,
                                  ce.KERNEL_MEGA_JULIA: 0,
                                  ce.KERNEL_MEGA_MULTIBROT: 0,
                                  ce.KERNEL_MEGA_SHIP: 0}


def test_a_refused_launch_raises(cuda):
    from distributedmandelbrot_tpu_torch.ops import _build
    lib = _build.load()
    out = torch.empty((1, 8, 8), dtype=torch.uint8, device=cuda)
    census = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    rows = np.zeros((1, 6), np.float32)
    mrds = np.ones((1, 1), np.int32)
    rc = lib.dm_escape_mega(
        ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(census.data_ptr()),
        ctypes.c_void_p(rows.ctypes.data), ctypes.c_void_p(mrds.ctypes.data),
        ce.MEGA_MAX_TILES + 1, 8, 8, 0, 0, 1, 0.0, 0, 0, 0, 2, 0,
        ctypes.c_void_p(None), ctypes.c_void_p(None),
        ctypes.c_void_p(torch.cuda.current_stream(cuda).cuda_stream))
    assert rc != 0
    with pytest.raises(RuntimeError, match="launch failed"):
        ce._check_rc(lib, rc, ce.KERNEL_MEGA)


def test_backend_dispatches_and_materializes_across_threads(cuda):
    """The pipeline's shape: launches from one thread, copies and waits
    from another; the fused route's pixels and census arrive intact."""
    ws = [Workload(4, 256, i, j) for i in range(4) for j in range(4)]
    backend = bk.CudaBackend(definition=512, device=cuda)
    handles = []

    def dispatch():
        for k in range(0, len(ws), 2):
            handles.extend(backend.dispatch_many(ws[k:k + 2]))

    t = threading.Thread(target=dispatch)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    for h in handles:
        h.copy_to_host_async()
    got = [backend.materialize_tile(h) for h in handles]
    for w, px in zip(ws, got):
        spec = TileSpec.for_chunk(w.level, w.index_real, w.index_imag,
                                  definition=512)
        want = _plain_tile(spec, w.max_iter, cuda).cpu().numpy().ravel()
        assert np.array_equal(px, want), w
    reg = backend.registry
    assert reg.counter_value(obs_names.WORKER_KERNEL_FUSED_LAUNCHES) == 8
    assert reg.counter_value(obs_names.WORKER_KERNEL_BF16_PRUNED) > 0
    assert bk.auto_backend().devices()[0].type == "cuda"


# --- the render path's kernels ------------------------------------------

JULIA_C = complex(-0.8, 0.156)
MODES = {"mandelbrot": {}, "julia": {"julia_c": JULIA_C},
         "multibrot3": {"power": 3}, "multibrot5": {"power": 5},
         "ship": {"burning": True}}


def _mode_args(kw):
    return dict(power=kw.get("power", 2), burning=kw.get("burning", False))


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("max_iter", [2, 256, 2000])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_k1_modes_and_k4_are_bitwise_their_plain_versions(cuda, mode,
                                                          max_iter):
    """K1 in every mode and K4 (smooth values compared as bits) against
    their plain versions on the same device."""
    kw = MODES[mode]
    cyc = ce.escape_time.resolve_cycle_check(None, max_iter)
    specs = _views() + [TileSpec(-0.75, 0.05, 0.3, 0.1, width=200,
                                 height=77)]
    for spec in specs:
        row = ce._params_row(spec, kw.get("julia_c"))
        got = ce.compute_tile_cuda_device(spec, max_iter, device=cuda, **kw)
        want = ce.escape_tile_plain(row, max_iter, spec.height, spec.width,
                                    cycle_check=cyc, device=cuda,
                                    **_mode_args(kw))
        assert torch.equal(got, want), (mode, spec)
        got = ce.compute_tile_smooth_cuda(spec, max_iter, device=cuda, **kw)
        want = ce.escape_smooth_plain(row, max_iter, spec.height, spec.width,
                                      cycle_check=cyc, device=cuda,
                                      **_mode_args(kw))
        assert got.dtype == torch.float32
        assert torch.equal(_bits(got), _bits(want)), (mode, spec)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_k5_is_bitwise_its_plain_version_and_k1(cuda, mode, n):
    kw = dict(MODES[mode])
    jc = kw.pop("julia_c", None)
    specs = _views()[:n]
    mis = [300, 2000, 90, 1100][:n]
    got = ce.compute_tiles_packed_cuda(
        specs, mis, julia_cs=[jc] * n if jc is not None else None,
        device=cuda, **kw)
    assert got.shape == (n, 128, 128) and got.device == cuda
    rows = np.asarray([ce._params_row(s, jc) for s in specs], np.float32)
    cyc = ce.escape_time.resolve_cycle_check(None, max(mis))
    want = ce.escape_pack_plain(rows, mis, height=128, width=128,
                                cycle_check=cyc, device=cuda,
                                **_mode_args(kw))
    assert torch.equal(got, want)
    for t, (spec, mi) in enumerate(zip(specs, mis)):
        one = ce.compute_tile_cuda_device(spec, mi, julia_c=jc,
                                          cycle_check=cyc, device=cuda, **kw)
        assert torch.equal(got[t], one), t


@pytest.mark.parametrize("flags,kernel", [
    ([], ce.KERNEL_TILE),
    (["--fractal", "julia"], ce.KERNEL_TILE),
    (["--fractal", "ship"], ce.KERNEL_TILE),
    (["--fractal", "multibrot", "--smooth", "--dtype", "f32"],
     ce.KERNEL_SMOOTH),
    (["--supersample", "4"], ce.KERNEL_PACK),
])
def test_render_launches_its_kernel_once(cuda, tmp_path, flags, kernel):
    from distributedmandelbrot_tpu_torch import cli
    ce.reset_launch_counts()
    cli.reset_kernel_declines()
    out = tmp_path / "view.png"
    assert cli.main(["render", *flags, "--definition", "512", "--out",
                     str(out), "-q"]) == 0
    torch.cuda.synchronize()
    counts = ce.launch_counts()
    assert counts == {k: int(k == kernel) for k in counts}
    assert cli.kernel_declines() == {}
    assert out.read_bytes().startswith(b"\x89PNG")


# --- the mesh routes' kernels ---------------------------------------------


def _bits_equal(a, b):
    return torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_k3_is_bitwise_its_plain_version_and_k1(cuda, mode):
    kw = dict(MODES[mode])
    jc = kw.pop("julia_c", None)
    rows = np.asarray([ce._params_row(s, jc) for s in _views()], np.float32)
    for mis in ([300, 5000, 2, 1100, 90], [700] * 5, [1] * 5):
        got = ce.compute_tiles_batch_cuda(rows, mis, height=128, width=128,
                                          device=cuda, **kw)
        want = ce.compute_tiles_batch_cuda(rows, mis, height=128, width=128,
                                           device="cpu", **kw)
        assert torch.equal(got.cpu(), want), (mode, mis)
        cyc = ce.escape_time.resolve_cycle_check(None, max(mis))
        for t, (row, mi) in enumerate(zip(rows, mis)):
            one = ce.compute_tile_row_cuda(row, mi, 128, 128,
                                           cycle_check=cyc, device=cuda,
                                           **kw)
            assert torch.equal(got[t], one), (mode, mis, t)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_k6_k7_and_the_pipeline_are_bitwise(cuda, mode):
    """K6's six planes (floats as bits) and K7 against their plain
    versions: one round over the flat lanes, over an index list (int64
    and int32) into K6's planes, and a round to the end; the compacted
    pipeline, one K7 launch, equal to K3 (also at the reference's
    overflow phase of 64 steps)."""
    from distributedmandelbrot_tpu_torch.ops import compact_escape as cx
    kw = dict(MODES[mode])
    jc = kw.pop("julia_c", None)
    rows = np.asarray([ce._params_row(s, jc) for s in _views()], np.float32)
    mis = [700, 650, 200, 1000, 513]
    planes = cx.escape_state_cuda(rows, mis, height=128, width=128,
                                  device=cuda, **kw)
    plain = cx.escape_state_plain(rows, mis, height=128, width=128,
                                  device=cuda, **kw)
    assert all(_bits_equal(a, b) for a, b in zip(planes, plain))
    lanes = [t.reshape(-1).contiguous() for t in plain]
    dyn = torch.from_numpy(np.repeat(np.asarray(mis, np.int32) - 1,
                                     128 * 128)).to(cuda)
    want = cx.escape_resume_plain(257, 256, dyn, *lanes, **kw)
    cr, ci, zr, zi, n, act = (t.clone() for t in lanes)
    got = cx.escape_resume_cuda(257, 256, dyn, cr, ci, zr, zi, n, act, **kw)
    assert all(_bits_equal(a, b) for a, b in zip(got, want))
    live = torch.nonzero(lanes[5]).squeeze(1)
    for seg in (256, max(mis) - 257):
        for idx in (live, live.to(torch.int32)):
            want = cx.escape_resume_plain(257, seg, dyn, *lanes, idx=idx,
                                          **kw)
            fresh = [t.clone() for t in lanes]
            got = cx.escape_resume_cuda(257, seg, dyn, *fresh, idx=idx, **kw)
            assert all(_bits_equal(a, b) for a, b in zip(got, want)), seg
    k3 = ce.compute_tiles_batch_cuda(rows, mis, height=128, width=128,
                                     device=cuda, **kw)
    for phase in (256, 64):
        ce.reset_launch_counts()
        out = cx.compact_escape_batch(rows, mis, k=5, height=128, width=128,
                                      max_iter=max(mis), phase_budget=phase,
                                      device=cuda, **kw)
        assert torch.equal(out, k3), phase
        # One K7 launch where a lane is live after phase 1.
        live = int((cx.escape_state_plain(
            rows, mis, height=128, width=128, phase_budget=phase,
            device=cuda, **kw)[5] != 0).sum())
        assert ce.launch_counts()[ce.KERNEL_RESUME] == (live > 0), phase


def test_a_ring_naming_one_card_twice_equals_one_device(cuda):
    """Two shards on ``[cuda:0, cuda:0]`` (two streams): the kernels'
    batch route, the fused route, ``MeshBackend`` and
    ``CudaBackend.dispatch_many`` each equal their one-device result;
    row shards equal the unsharded loop."""
    from distributedmandelbrot_tpu_torch.parallel import MeshBackend
    from distributedmandelbrot_tpu_torch.parallel import sharding as sh
    from distributedmandelbrot_tpu_torch.parallel.backend import batch_params
    from distributedmandelbrot_tpu_torch.parallel.mesh import (make_mesh,
                                                               tile_row_mesh)
    one, two = make_mesh([cuda]), make_mesh([cuda, cuda])
    ws = [Workload(4, mi, i, j) for (i, j), mi in zip(
        [(0, 0), (1, 1), (1, 2), (2, 1), (3, 3)], [300, 50, 5000, 1, 120])]
    params, mrds = batch_params(ws, 512)
    a = sh.batched_escape_pixels_cuda(two, params, mrds, definition=512)
    assert np.array_equal(a, sh.batched_escape_pixels_cuda(
        one, params, mrds, definition=512))
    specs = [TileSpec.for_chunk(w.level, w.index_real, w.index_imag,
                                definition=512) for w in ws]
    mis = [max(2, w.max_iter) for w in ws]
    tiles, scout = sh.compute_tiles_mega_sharded(specs, mis, mesh=two)
    ftiles, fscout = ce.compute_tiles_mega_cuda(specs, mis, device=cuda)
    assert torch.equal(torch.stack(tiles), ftiles)
    assert torch.equal(torch.stack(scout), fscout)
    got = MeshBackend(definition=512, mesh=two).compute_batch(ws)
    assert all(np.array_equal(g, a[i].ravel()) for i, g in enumerate(got))
    ring = bk.CudaBackend(definition=512, mesh=two)
    assert ring.mesh_width == 2
    got = [ring.materialize_tile(h) for h in ring.dispatch_many(ws)]
    want = [ring.materialize_tile(h)
            for h in ring.dispatch_many(ws, device=cuda)]
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    spec = TileSpec(-0.8, 0.1, 0.2, 0.2, width=512, height=512)
    assert np.array_equal(
        sh.compute_tile_row_sharded(tile_row_mesh(1, 2, [cuda, cuda]),
                                    spec, 300),
        sh.compute_tile_row_sharded(tile_row_mesh(1, 1, [cuda]), spec, 300))


# --- K8 (the matrix form) and K2's modes --------------------------------

MEGA_MODES = {"julia": {"julia_c": JULIA_C}, "multibrot3": {"power": 3},
              "multibrot5": {"power": 5}, "ship": {"burning": True}}


def _mega_kw(kw, k):
    kw = dict(kw)
    jc = kw.pop("julia_c", None)
    if jc is not None:
        kw["julia_cs"] = [jc] * k
    return kw


def test_probe_runs_the_kernels_update(cuda):
    """The card's probe planes (the kernels' own update, both forms)
    equal the plain forms computed by torch on the same card, bit for
    bit; the verdict is the differing-lane count being zero."""
    from distributedmandelbrot_tpu_torch.ops import mxu_iteration as mxu
    got = mxu.probe_planes(cuda)
    xs, ys = mxu._probe_grid(cuda)
    cr = xs[None, :].expand(mxu.PROBE_N, mxu.PROBE_N)
    ci = ys[:, None].expand(mxu.PROBE_N, mxu.PROBE_N)
    want = torch.stack([*mxu._probe_cached(cr, ci, cr, ci),
                        *mxu._probe_matrix(cr, ci, cr, ci)])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    mxu.reset_mxu_cache()
    assert mxu.mxu_parity_proven(cuda) == (mxu.probe_differences(cuda) == 0)


@pytest.mark.parametrize("julia", [False, True])
@pytest.mark.parametrize("mis", [[256, 1024, 2000, 300], [2000] * 4])
def test_k8_in_k1_and_k2_is_bitwise(cuda, julia, mis):
    """K2 and K1 in the matrix form against their plain versions and K2
    against K1 per tile; where the probe admits full mode, also against
    the cached form."""
    from distributedmandelbrot_tpu_torch.ops import mxu_iteration as mxu
    specs = _views()[:4]
    jc = JULIA_C if julia else None
    kw = {"julia_cs": [jc] * 4} if julia else {}
    tiles, census = ce.compute_tiles_mega_cuda(specs, mis, use_mxu=True,
                                               device=cuda, **kw)
    rows, mrds, pkw = ce.mega_dispatch_plan(specs, mis, use_mxu=True, **kw)
    assert pkw["use_mxu"]
    ptiles, pcensus = ce.escape_mega_plain(rows, mrds, device=cuda, **pkw)
    assert torch.equal(tiles, ptiles) and torch.equal(census, pcensus)
    cyc = ce.escape_time.resolve_cycle_check(None, max(mis))
    for t, (spec, mi) in enumerate(zip(specs, mis)):
        one = ce.compute_tile_cuda_device(spec, mi, use_mxu=True, julia_c=jc,
                                          cycle_check=cyc, device=cuda)
        assert torch.equal(tiles[t], one), t
    if mxu.mxu_parity_proven(cuda):
        cached, _ = ce.compute_tiles_mega_cuda(specs, mis, use_mxu=False,
                                               device=cuda, **kw)
        assert torch.equal(tiles, cached)


@pytest.mark.parametrize("mis", [[300, 150, 80, 2000], [256, 256, 256, 256]])
@pytest.mark.parametrize("mode", sorted(MEGA_MODES))
def test_k2_modes_are_bitwise_their_plain_version_and_k1(cuda, mode, mis):
    """K2 in each mode, pixels and census, against its plain version;
    each plane against K1 in the same mode."""
    specs = _views()[:4]
    kw = _mega_kw(MEGA_MODES[mode], 4)
    tiles, census = ce.compute_tiles_mega_cuda(specs, mis, device=cuda, **kw)
    rows, mrds, pkw = ce.mega_dispatch_plan(specs, mis, **kw)
    ptiles, pcensus = ce.escape_mega_plain(rows, mrds, device=cuda, **pkw)
    assert torch.equal(tiles, ptiles)
    assert torch.equal(census, pcensus)
    cyc = ce.escape_time.resolve_cycle_check(None, max(mis))
    for t, (spec, mi) in enumerate(zip(specs, mis)):
        one = ce.compute_tile_cuda_device(spec, mi, cycle_check=cyc,
                                          device=cuda, **MEGA_MODES[mode])
        assert torch.equal(tiles[t], one), t


def test_variant_launches_have_counters_of_their_own(cuda):
    ce.reset_launch_counts()
    spec = _views()[3]
    ce.compute_tile_cuda_device(spec, 100, use_mxu=True, device=cuda)
    ce.compute_tiles_mega_cuda([spec, spec], [100, 300], use_mxu=True,
                               device=cuda)
    for mode, kw in MEGA_MODES.items():
        ce.compute_tiles_mega_cuda([spec, spec], [100, 300], device=cuda,
                                   **_mega_kw(kw, 2))
    counts = ce.launch_counts()
    assert counts == {k: 0 for k in counts} | {
        ce.KERNEL_TILE_MXU: 1, ce.KERNEL_MEGA_MXU: 1,
        ce.KERNEL_MEGA_JULIA: 1, ce.KERNEL_MEGA_MULTIBROT: 2,
        ce.KERNEL_MEGA_SHIP: 1}


@pytest.mark.parametrize("verdict", [True, False])
def test_backend_under_the_mxu_gate(cuda, monkeypatch, verdict):
    """DMTPU_MXU=1 with each verdict forced on the card: the chunks of
    DMTPU_MXU=0, bitwise, and the counters of the verdict's route."""
    from distributedmandelbrot_tpu_torch.ops import mxu_iteration as mxu
    ws = [Workload(4, 300, 3, 3), Workload(4, 1024, 1, 1),
          Workload(4, 300, 1, 2)]
    base = bk.CudaBackend(definition=256, device=cuda)
    want = [base.materialize_tile(h) for h in base.dispatch_many(ws)]
    monkeypatch.setenv(mxu.MXU_ENV, "1")
    mxu._parity_cache[("cuda", cuda.index)] = verdict
    try:
        backend = bk.CudaBackend(definition=256, device=cuda)
        got = [backend.materialize_tile(h) for h in backend.dispatch_many(ws)]
    finally:
        mxu.reset_mxu_cache()
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    cv = backend.registry.counter_value
    if verdict:
        assert cv(obs_names.WORKER_KERNEL_MXU_LAUNCHES) == 1
        assert cv(obs_names.WORKER_KERNEL_MXU_DEMOTIONS) is None
    else:
        assert cv(obs_names.WORKER_KERNEL_MXU_DEMOTIONS) == 1
        assert cv(obs_names.WORKER_KERNEL_MXU_CENSUS) > 0
    assert cv(obs_names.WORKER_MXU_CENSUS_FAILURES) is None


# --- the persistent loop of K1 and K2: refill stress ---------------------

STRESS_MODES = {"mandelbrot": {}, "julia": {"julia_c": JULIA_C},
                "multibrot3": {"power": 3}, "ship": {"burning": True},
                "mxu": {"use_mxu": True},
                "mxu_julia": {"use_mxu": True, "julia_c": JULIA_C}}


def stress_batch(seed=5, k=128, side=64, top=2000):
    """k views of side^2 on boundary windows of every scale, and their
    budgets from 1-``top``, 1 through 9 among them (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    anchors = np.array([(-0.745, 0.11), (-0.2, 0.7), (-1.25, 0.0),
                        (0.28, 0.01), (-0.5, -0.5), (0.0, 0.0),
                        (-1.75, -0.03), (0.35, 0.35)])
    specs = []
    for t in range(k):
        cx, cy = anchors[t % len(anchors)] + rng.normal(0, 0.02, 2)
        span = float(10 ** rng.uniform(-3, 0.5))
        specs.append(TileSpec(cx - span / 2, cy - span / 2, span, span,
                              width=side, height=side))
    mis = [int(m) for m in rng.integers(1, top + 1, k)]
    mis[:9] = list(range(1, 10))
    return specs, mis


def _k1(spec, mi, kw, cyc, dev):
    return ce.compute_tile_cuda_device(spec, mi, cycle_check=cyc, device=dev,
                                       **kw)


def _mega_vs_plain_and_k1(specs, mis, kw, dev):
    mkw = _mega_kw(kw, len(specs))
    tiles, census = ce.compute_tiles_mega_cuda(specs, mis, device=dev,
                                               **mkw)
    rows, mrds, pkw = ce.mega_dispatch_plan(specs, mis, **mkw)
    ptiles, pcensus = ce.escape_mega_plain(rows, mrds, device=dev, **pkw)
    assert torch.equal(tiles, ptiles)
    assert torch.equal(census, pcensus)
    cyc = ce.escape_time.resolve_cycle_check(None, max(mis))
    for t, (spec, mi) in enumerate(zip(specs, mis)):
        assert torch.equal(tiles[t], _k1(spec, mi, kw, cyc, dev)), (t, mi)


@pytest.mark.parametrize("mode", sorted(STRESS_MODES))
def test_k2_refill_stress_128_tiles(cuda, mode):
    """K2 at k = 128 tiles of 64^2 with budgets from 1-2000 (1-9
    included), pixels and census against the plain version and each
    tile against K1."""
    specs, mis = stress_batch()
    _mega_vs_plain_and_k1(specs, mis, STRESS_MODES[mode], cuda)


@pytest.mark.parametrize("mi", [1, 2, 3, 8, 9, 17, 1500])
@pytest.mark.parametrize("mode", sorted(STRESS_MODES))
def test_k1_and_k2_on_a_7x3_tile(cuda, mode, mi):
    """A tile smaller than one warp's run: K1 against its plain version,
    K2 (two such tiles) against its plain version and K1."""
    kw = STRESS_MODES[mode]
    spec = TileSpec(-0.8, 0.1, 0.2, 0.1, width=7, height=3)
    fam = {k: v for k, v in kw.items() if k != "julia_c"}
    got = ce.compute_tile_cuda_device(spec, mi, device=cuda, **kw)
    want = ce.escape_tile_plain(
        ce._params_row(spec, kw.get("julia_c")), mi, 3, 7,
        cycle_check=ce.escape_time.resolve_cycle_check(None, mi),
        device=cuda, **fam)
    assert torch.equal(got, want)
    other = TileSpec(-0.745, 0.11, 0.01, 0.01, width=7, height=3)
    _mega_vs_plain_and_k1([spec, other], [mi, 300], kw, cuda)


def test_two_k2_launches_at_once_on_two_streams(cuda):
    """Two K2 launches in flight on two streams of one card, each with
    its own run counters: each equals its plain version."""
    specs, mis = stress_batch(seed=11, k=64)
    halves = [(specs[:32], mis[:32]), (specs[32:], mis[32:])]
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    torch.cuda.synchronize()
    got = []
    for (sp, mi), st in zip(halves, streams):
        with torch.cuda.stream(st):
            got.append(ce.compute_tiles_mega_cuda(sp, mi, device=cuda))
    torch.cuda.synchronize()
    for (sp, mi), (tiles, census) in zip(halves, got):
        rows, mrds, kw = ce.mega_dispatch_plan(sp, mi)
        ptiles, pcensus = ce.escape_mega_plain(rows, mrds, device=cuda, **kw)
        assert torch.equal(tiles, ptiles)
        assert torch.equal(census, pcensus)


@pytest.mark.parametrize("shape", [(2, 2), (3, 7), (2, 33)])
def test_a_persistent_launch_writes_every_byte(cuda, shape):
    """K1 on tiles smaller than (or ragged against) one warp's run of 32
    pixels, into buffers filled with two different sentinels: every byte
    is written, and equals the plain version."""
    from distributedmandelbrot_tpu_torch.ops import _build
    lib = _build.load()
    h, w = shape
    spec = TileSpec(-0.9, 0.05, 0.3, 0.2, width=w, height=h)
    row = ce._row6(ce._params_row(spec))
    want = _plain_tile(spec, 300, cuda)
    for fill in (0xAB, 0x55):
        out = torch.full((h, w), fill, dtype=torch.uint8, device=cuda)
        work = torch.zeros((1,), dtype=torch.int64, device=cuda)
        rc = lib.dm_escape_tile(
            ctypes.c_void_p(out.data_ptr()), h, w,
            ctypes.c_void_p(row.ctypes.data), 0, 300, 0, 1, 0.0, 0, 0, 2, 0,
            ctypes.c_void_p(work.data_ptr()), ctypes.c_void_p(None),
            ctypes.c_void_p(torch.cuda.current_stream(cuda).cuda_stream))
        assert rc == 0
        torch.cuda.synchronize()
        assert torch.equal(out, want), fill


def test_the_instrumented_form_counts_lane_steps(cuda):
    """K1's and K2's instrumented forms: the same bytes, and at least the
    lane steps the pixels need, in whole groups of 8 steps x 32 lanes."""
    spec = TileSpec.for_chunk(4, 1, 2, definition=256)
    steps = torch.zeros((1,), dtype=torch.int64, device=cuda)
    got = ce.compute_tile_row_cuda(ce._params_row(spec), 1024, 256, 256,
                                   device=cuda, lane_steps=steps)
    want, need = ce.escape_tile_plain(
        ce._params_row(spec), 1024, 256, 256, cycle_check=True, device=cuda,
        return_steps=True)
    assert torch.equal(got, want)
    issued = int(steps.item())
    assert issued >= int(need.sum()) and issued % 256 == 0
    mega = torch.zeros((1,), dtype=torch.int64, device=cuda)
    tiles, _ = ce.compute_tiles_mega_cuda([spec, spec], [1024, 1024],
                                          device=cuda, lane_steps=mega)
    assert torch.equal(tiles[0], want) and torch.equal(tiles[1], want)
    assert int(mega.item()) >= 2 * int(need.sum())


# --- K3 and K5 on the persistent loop; fused batches over 128 tiles -----

K3_MODES = {"mandelbrot": {}, "julia": {"julia_c": JULIA_C},
            "multibrot3": {"power": 3}, "ship": {"burning": True}}


def _batch_rows(specs, kw):
    return np.asarray([ce._params_row(s, kw.get("julia_c")) for s in specs],
                      np.float32)


def _k3_vs_plain_and_k1(specs, mis, kw, dev, per_tile=True):
    rows = _batch_rows(specs, kw)
    h, w = specs[0].height, specs[0].width
    got = ce.compute_tiles_batch_cuda(rows, mis, height=h, width=w,
                                      device=dev, **_mode_args(kw))
    cyc = ce.escape_time.resolve_cycle_check(None, max(mis))
    want = ce.escape_batch_plain(rows, mis, height=h, width=w,
                                 cycle_check=cyc, device=dev,
                                 **_mode_args(kw))
    assert torch.equal(got, want)
    if per_tile:
        for t, (row, mi) in enumerate(zip(rows, mis)):
            one = ce.compute_tile_row_cuda(row, mi, h, w, cycle_check=cyc,
                                           device=dev, **_mode_args(kw))
            assert torch.equal(got[t], one), (t, mi)
    return got


@pytest.mark.parametrize("mode", sorted(K3_MODES))
def test_k3_refill_stress_300_tiles(cuda, mode):
    """K3 at k = 300 tiles of 64^2 (past one K2 launch's 128) with budgets
    1-5000 (1-9 included): against its plain version and each tile
    against K1."""
    specs, mis = stress_batch(k=300, top=5000)
    _k3_vs_plain_and_k1(specs, mis, K3_MODES[mode], cuda)


def test_k3_past_the_old_grid_z_slice(cuda):
    """K3 at k = 65,537 tiles of 4x32, past the 65,535 tiles of a grid's
    z extent the old kernel sliced at: tile t repeats distinct tile t % 7
    (budgets 1-5000), so the plain version of the 7 gives every plane."""
    base = [TileSpec(-0.75 + 0.01 * i, 0.1 - 0.003 * i, 0.02 * (i + 1),
                     0.01, width=32, height=4) for i in range(7)]
    base_mis = [1, 2, 9, 17, 300, 1500, 5000]
    k = 65_537
    rows = _batch_rows(base, {})
    idx = np.arange(k) % 7
    mis = [base_mis[i] for i in idx]
    got = ce.compute_tiles_batch_cuda(rows[idx], mis, height=4, width=32,
                                      device=cuda)
    cyc = ce.escape_time.resolve_cycle_check(None, 5000)
    want = ce.escape_batch_plain(rows, base_mis, height=4, width=32,
                                 cycle_check=cyc, device=cuda)
    assert torch.equal(got, want[torch.from_numpy(idx).to(cuda)])


def test_two_k3_launches_at_once_on_two_streams(cuda):
    specs, mis = stress_batch(seed=11, k=64, top=5000)
    halves = [(specs[:32], mis[:32]), (specs[32:], mis[32:])]
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    torch.cuda.synchronize()
    got = []
    for (sp, mi), st in zip(halves, streams):
        with torch.cuda.stream(st):
            got.append(ce.compute_tiles_batch_cuda(
                _batch_rows(sp, {}), mi, height=64, width=64, device=cuda))
    torch.cuda.synchronize()
    for (sp, mi), out in zip(halves, got):
        want = ce.escape_batch_plain(
            _batch_rows(sp, {}), mi, height=64, width=64, device=cuda,
            cycle_check=ce.escape_time.resolve_cycle_check(None, max(mi)))
        assert torch.equal(out, want)


PACK_BUDGETS = [*range(1, 10), 17, 1500]


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_k5_small_and_ragged_tiles_every_budget(cuda, mode, n):
    """K5 at n states on 7x3 and 64^2 tiles, the budgets 1-9, 17 and 1500
    each in every position of a pack: against its plain version and
    each plane against K1."""
    kw = dict(MODES[mode])
    jc = kw.pop("julia_c", None)
    for w, h in ((7, 3), (64, 64)):
        base = TileSpec(-0.8, 0.1, 0.2, 0.1, width=w, height=h)
        specs = [TileSpec(base.start_real + 0.25 * dx * base.range_real / w,
                          base.start_imag + 0.25 * dy * base.range_imag / h,
                          base.range_real, base.range_imag, width=w,
                          height=h)
                 for dx, dy in ((-1, -1), (1, -1), (-1, 1), (1, 1))[:n]]
        for i in range(len(PACK_BUDGETS)):
            mis = [PACK_BUDGETS[(i + j) % len(PACK_BUDGETS)]
                   for j in range(n)]
            got = ce.compute_tiles_packed_cuda(
                specs, mis, julia_cs=[jc] * n if jc is not None else None,
                device=cuda, **kw)
            rows = np.asarray([ce._params_row(s, jc) for s in specs],
                              np.float32)
            cyc = ce.escape_time.resolve_cycle_check(None, max(mis))
            want = ce.escape_pack_plain(rows, mis, height=h, width=w,
                                        cycle_check=cyc, device=cuda,
                                        **_mode_args(kw))
            assert torch.equal(got, want), (w, mis)
            for t, (spec, mi) in enumerate(zip(specs, mis)):
                one = ce.compute_tile_cuda_device(
                    spec, mi, julia_c=jc, cycle_check=cyc, device=cuda, **kw)
                assert torch.equal(got[t], one), (w, mis, t)


def test_k3_and_k5_instrumented_forms(cuda):
    """K3's and K5's instrumented forms: the same bytes, and at least the
    lane steps the pixels need, in whole groups of 8 steps x 32 lanes."""
    specs = [TileSpec.for_chunk(4, 1, 2, definition=256),
             TileSpec.for_chunk(4, 1, 1, definition=256)]
    rows = _batch_rows(specs, {})
    want, need = ce.escape_batch_plain(rows, [1024, 1024], height=256,
                                       width=256, cycle_check=True,
                                       device=cuda, return_steps=True)
    for launch in (
            lambda c: ce.compute_tiles_batch_cuda(
                rows, [1024, 1024], height=256, width=256, device=cuda,
                lane_steps=c),
            lambda c: ce.compute_tiles_packed_cuda(
                specs, [1024, 1024], device=cuda, lane_steps=c)):
        steps = torch.zeros((1,), dtype=torch.int64, device=cuda)
        assert torch.equal(launch(steps), want)
        issued = int(steps.item())
        assert issued >= int(need.sum()) and issued % 256 == 0


@pytest.mark.parametrize("ring", [False, True])
def test_a_129_tile_fused_batch_splits_without_demotion(cuda, ring):
    """129 tiles through CudaBackend.dispatch_many, on cuda:0 (two K2
    launches: 128 + 1) and on the ring [cuda:0, cuda:0] (one launch per
    shard of 65): no demotion, each tile equal to K1; 300 tiles through
    compute_tiles_mega_sharded on the ring: shards of 150, each split in
    two."""
    from distributedmandelbrot_tpu_torch.parallel import sharding as sh
    from distributedmandelbrot_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh([cuda, cuda]) if ring else None
    rng = np.random.default_rng(29)
    ws = [Workload(12, int(m), i % 12, i // 12)
          for i, m in enumerate(rng.integers(1, 301, 129))]
    cyc = ce.escape_time.resolve_cycle_check(
        None, max(w.max_iter for w in ws))
    backend = bk.CudaBackend(definition=64, device=cuda, mesh=mesh)
    torch.cuda.synchronize()
    ce.reset_launch_counts()
    handles = backend.dispatch_many(ws)
    torch.cuda.synchronize()
    assert ce.launch_counts()[ce.KERNEL_MEGA] == 2
    assert all(isinstance(h, bk.MegaTileHandle) for h in handles)
    for route in (obs_names.ROUTE_MESH_TO_FUSED,
                  obs_names.ROUTE_FUSED_TO_PER_TILE):
        assert backend.demotions(route) == 0
    for w, h in zip(ws, handles):
        spec = TileSpec.for_chunk(w.level, w.index_real, w.index_imag,
                                  definition=64)
        one = ce.compute_tile_cuda_device(spec, w.max_iter, device=cuda,
                                          cycle_check=cyc)
        assert np.array_equal(backend.materialize_tile(h),
                              one.cpu().numpy().ravel()), w
    if ring:
        specs, mis = stress_batch(seed=13, k=300, side=16, top=300)
        ce.reset_launch_counts()
        tiles, scout = sh.compute_tiles_mega_sharded(specs, mis, mesh=mesh)
        torch.cuda.synchronize()
        assert ce.launch_counts()[ce.KERNEL_MEGA] == 4
        ftiles, fscout = ce.compute_tiles_mega_cuda(specs, mis, device=cuda)
        assert torch.equal(torch.stack(tiles), ftiles)
        assert torch.equal(torch.stack(scout), fscout)
        rows, mrds, kw = ce.mega_dispatch_plan(specs, mis)
        ptiles, pcensus = ce.escape_mega_plain(rows, mrds, device=cuda, **kw)
        assert torch.equal(ftiles, ptiles) and torch.equal(fscout, pcensus)


# --- K4 on the persistent loop, and K6 ------------------------------------

SMOOTH_BUDGETS = [*range(1, 10), 17, 1500]


def _smooth_windows():
    """7x3 and 64^2 boundary windows, and a 64^2 window whose pixel (0, 0)
    is c = -2 (an orbit on the radius-2 circle: it stops at the step
    limit)."""
    return [TileSpec(-0.8, 0.1, 0.2, 0.1, width=7, height=3),
            TileSpec(-0.8, 0.1, 0.2, 0.1, width=64, height=64),
            TileSpec(-2.0, 0.0, 0.5, 0.5, width=64, height=64)]


@pytest.mark.parametrize("mode", sorted(K3_MODES))
def test_k4_small_and_ragged_tiles_every_budget(cuda, mode):
    """K4 in every mode on the smooth windows at budgets 1-9, 17 and
    1500, the probe as the budget's policy says and armed, the two
    launches of each budget in flight at once on two streams: bit for
    bit its plain version."""
    kw = K3_MODES[mode]
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    for spec in _smooth_windows():
        row = ce._params_row(spec, kw.get("julia_c"))
        for mi in SMOOTH_BUDGETS:
            cycles = (ce.escape_time.resolve_cycle_check(None, mi), True)
            torch.cuda.synchronize()
            got = []
            for st, cyc in zip(streams, cycles):
                with torch.cuda.stream(st):
                    got.append(ce.compute_tile_smooth_cuda(
                        spec, mi, cycle_check=cyc, device=cuda, **kw))
            torch.cuda.synchronize()
            for g, cyc in zip(got, cycles):
                want = ce.escape_smooth_plain(
                    row, mi, spec.height, spec.width, cycle_check=cyc,
                    device=cuda, **_mode_args(kw))
                assert torch.equal(_bits(g), _bits(want)), (spec, mi, cyc)


def _state_vs_plain(rows, mis, h, w, kw, dev, phase):
    from distributedmandelbrot_tpu_torch.ops import compact_escape as cx
    got = cx.escape_state_cuda(rows, mis, height=h, width=w, device=dev,
                               phase_budget=phase, **_mode_args(kw))
    want = cx.escape_state_plain(rows, mis, height=h, width=w, device=dev,
                                 phase_budget=phase, **_mode_args(kw))
    for g, w_ in zip(got, want):
        assert _bits_equal(g, w_), phase
    return got


@pytest.mark.parametrize("mode", sorted(K3_MODES))
def test_k6_stress_300_tiles(cuda, mode):
    """K6 at k = 300 tiles of 64^2 with budgets 1-1000 (1-9 included),
    at the pipeline's phase of 256 steps and at 61: its six planes bit
    for bit its plain version's."""
    specs, mis = stress_batch(k=300, top=1000)
    rows = _batch_rows(specs, K3_MODES[mode])
    for phase in (256, 61):
        _state_vs_plain(rows, mis, 64, 64, K3_MODES[mode], cuda, phase)


def test_k6_past_one_grid_z_slice(cuda):
    """K6 at k = 65,537 tiles of 4x32 in one call, which launches its
    grid in slices of 65,535 tiles: tile t repeats distinct tile t % 7
    (budgets 1-1000)."""
    from distributedmandelbrot_tpu_torch.ops import compact_escape as cx
    base = [TileSpec(-0.75 + 0.01 * i, 0.1 - 0.003 * i, 0.02 * (i + 1),
                     0.01, width=32, height=4) for i in range(7)]
    base_mis = [1, 2, 9, 17, 257, 300, 1000]
    rows = _batch_rows(base, {})
    idx = np.arange(65_537) % 7
    ce.reset_launch_counts()
    got = cx.escape_state_cuda(rows[idx], [base_mis[i] for i in idx],
                               height=4, width=32, device=cuda)
    assert ce.launch_counts()[ce.KERNEL_STATE] == 1
    want = cx.escape_state_plain(rows, base_mis, height=4, width=32,
                                 device=cuda)
    pick = torch.from_numpy(idx).to(cuda)
    for g, w in zip(got, want):
        assert _bits_equal(g, w[pick])


def test_k4_and_k6_instrumented_forms(cuda):
    """K4's and K6's instrumented forms: the same values, and at least
    the lane steps the pixels need (K4's in-set pixels need at most the
    budget), K4's in whole groups of 8 steps x 32 lanes, K6's in steps of
    32 lanes."""
    from distributedmandelbrot_tpu_torch.ops import compact_escape as cx
    spec = TileSpec.for_chunk(4, 1, 2, definition=256)
    steps = torch.zeros((1,), dtype=torch.int64, device=cuda)
    got = ce.compute_tile_smooth_cuda(spec, 1024, device=cuda,
                                      lane_steps=steps)
    want, need = ce.escape_smooth_plain(
        ce._params_row(spec), 1024, 256, 256, cycle_check=True, device=cuda,
        return_steps=True)
    assert torch.equal(_bits(got), _bits(want))
    need = torch.where(want == 0, need.clamp(max=1023), need)
    issued = int(steps.item())
    assert issued >= int(need.sum()) and issued % 256 == 0
    specs = [spec, TileSpec.for_chunk(4, 1, 1, definition=256)]
    rows = _batch_rows(specs, {})
    steps.zero_()
    got = cx.escape_state_cuda(rows, [1000, 1000], height=256, width=256,
                               device=cuda, lane_steps=steps)
    want = cx.escape_state_plain(rows, [1000, 1000], height=256, width=256,
                                 device=cuda)
    assert all(_bits_equal(g, w) for g, w in zip(got, want))
    _, k3_steps = ce.escape_batch_plain(rows, [1000, 1000], height=256,
                                        width=256, device=cuda,
                                        return_steps=True)
    issued = int(steps.item())
    assert issued >= int(k3_steps.clamp(max=256).sum())
    assert issued % 32 == 0


@pytest.mark.parametrize("mode", sorted(K3_MODES))
def test_k7_stress_rounds_lists_and_streams(cuda, mode):
    """K7 on the packed live lanes of 300 tiles of 32^2 (budgets 1-1000)
    from it0 62 and 257, rounds of 1, 7 and 256 steps and to the end,
    in the flat form and over an index list into K6's planes; and the
    list's halves as two launches at once on two streams."""
    from distributedmandelbrot_tpu_torch.ops import compact_escape as cx
    specs, mis = stress_batch(k=300, side=32, top=1000)
    rows = _batch_rows(specs, K3_MODES[mode])
    fam = _mode_args(K3_MODES[mode])
    dyn = torch.from_numpy(np.repeat(np.asarray(mis, np.int32) - 1,
                                     32 * 32)).to(cuda)
    for it0 in (62, 257):
        planes = [t.reshape(-1).contiguous() for t in cx.escape_state_plain(
            rows, mis, height=32, width=32, phase_budget=it0 - 1,
            device=cuda, **fam)]
        live = torch.nonzero(planes[5]).squeeze(1)
        packed = [t[live].contiguous() for t in planes]
        for seg in (1, 7, 256, max(mis) - it0):
            want = cx.escape_resume_plain(it0, seg, dyn[live], *packed,
                                          **fam)
            got = cx.escape_resume_cuda(it0, seg, dyn[live],
                                        *(t.clone() for t in packed), **fam)
            assert all(_bits_equal(a, b) for a, b in zip(got, want)), seg
            fresh = [t.clone() for t in planes]
            got = cx.escape_resume_cuda(it0, seg, dyn, *fresh, idx=live,
                                        **fam)
            assert all(_bits_equal(a[live], b)
                       for a, b in zip(got, want)), seg
        fresh = [t.clone() for t in planes]
        half = live.numel() // 2
        streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
        torch.cuda.synchronize()
        for part, st in zip((live[:half], live[half:]), streams):
            with torch.cuda.stream(st):
                cx.escape_resume_cuda(it0, max(mis), dyn, *fresh, idx=part,
                                      **fam)
        torch.cuda.synchronize()
        want = cx.escape_resume_plain(it0, max(mis), dyn, *planes, idx=live,
                                      **fam)
        assert all(_bits_equal(a, b) for a, b in zip(fresh[2:], want))


def test_k7_instrumented_form(cuda):
    """K7's instrumented form: the same lanes, and at least the lane steps
    they need, in steps of 32 lanes."""
    from distributedmandelbrot_tpu_torch.ops import compact_escape as cx
    specs = [TileSpec.for_chunk(10, 3, 5, definition=256)]
    rows = _batch_rows(specs, {})
    planes = [t.reshape(-1).contiguous() for t in cx.escape_state_plain(
        rows, [1000], height=256, width=256, device=cuda)]
    dyn = torch.full_like(planes[4], 999)
    live = torch.nonzero(planes[5]).squeeze(1)
    steps = torch.zeros((1,), dtype=torch.int64, device=cuda)
    fresh = [t.clone() for t in planes]
    got = cx.escape_resume_cuda(257, 743, dyn, *fresh, idx=live,
                                lane_steps=steps)
    want = cx.escape_resume_plain(257, 743, dyn, *planes, idx=live)
    assert all(_bits_equal(a, b) for a, b in zip(got, want))
    need = int((want[2][live] - planes[4][live]).sum()) + int(
        (want[2][live] < 999).sum())
    issued = int(steps.item())
    assert issued >= need and issued % 32 == 0


# --- K9, K10: the perturbation scans ---------------------------------------

DEEP_VIEWS = {
    "config4": (("-0.77568376995", "0.13646737005"), 1e-10, 50000, None),
    "minibrot": (("-1.7548776662466927", "0.0"), 5e-2, 20000, None),
    "stagnation": (("-1.7548776662466927", "0.0"), 5e-2, 20000, None),
    "julia": (("0.1", "0.2"), 1e-6, 3000, ("-0.8", "0.156")),
}


def _deep_inputs(name, side, dtype, cuda):
    from distributedmandelbrot_tpu_torch.ops import perturbation as pt
    center, span, mi, jc = DEEP_VIEWS[name]
    if name == "stagnation":
        side = 16  # few enough in-set lanes for the stop to fire
    spec = pt.DeepTileSpec(*center, span, width=side, height=side)
    need = int(-np.log2(spec.step)) + 64
    bits = max(pt.DEFAULT_PREC_BITS, -(-need // 128) * 128)
    za, zb = pt._to_fixed(center[0], bits), pt._to_fixed(center[1], bits)
    ca, cb = ((za, zb) if jc is None else
              (pt._to_fixed(jc[0], bits), pt._to_fixed(jc[1], bits)))
    orbit, o_re, o_im = pt._find_reference(
        za, zb, ca, cb, span, mi, bits, add_dc=jc is None,
        device=str(cuda))
    dre, dim = spec.delta_grids(np.float64)
    row = torch.as_tensor((dre[0] - o_re).astype(dtype), device=cuda)
    col = torch.as_tensor((dim[:, 0] - o_im).astype(dtype), device=cuda)
    return (*orbit.on(cuda),
            row[None, :].expand(side, side), col[:, None].expand(side, side),
            jc is None)


@pytest.mark.parametrize("stagnation", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(DEEP_VIEWS))
def test_k9_k10_are_bitwise_their_plain_versions(cuda, name, dtype,
                                                 stagnation):
    from distributedmandelbrot_tpu_torch.ops import cuda_perturb as cp
    zr, zi, dre, dim, add_dc = _deep_inputs(name, 256, dtype, cuda)
    cp.reset_launch_counts()
    got = cp.perturb_state_cuda(zr, zi, dre, dim, add_dc=add_dc,
                                stagnation=stagnation)
    want = cp.perturb_state_plain(zr, zi, dre, dim, add_dc=add_dc,
                                  stagnation=stagnation)
    for label, g, w in zip(("n", "active", "glitched", "suspect"), got,
                           want):
        assert torch.equal(g, w), label
    if name == "stagnation" and stagnation:
        assert int(want[3].sum()) > 0
    assert cp.launch_counts()["perturb_scan"] >= 1
    got = cp.perturb_smooth_state_cuda(zr, zi, dre, dim, bailout=256.0,
                                       add_dc=add_dc)
    want = cp.perturb_smooth_state_plain(zr, zi, dre, dim, bailout=256.0,
                                         add_dc=add_dc)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert cp.launch_counts()["perturb_scan_smooth"] == 1


# K10's ring at its edges: (centre, span, budget, Julia c, height, width,
# orbit entries kept).  Orbits of 300 (a ragged last tile), 100 (shorter
# than a tile) and 1 entry; planes of 7 x 9 (smaller than a block) and 37 x
# 29 (not a multiple of 256 pixels); a view whose lanes all escape in the
# first tile; the period-349 minibrot at 64^2, whose in-set lanes run the
# whole orbit (its Julia twin about the critical point: every lane does).
NUCLEUS_349 = ("-0.7756837700816288677685612253565279731949",
               "0.1364673698317589362266084123703078253727")
RING_CASES = {
    "orbit_of_300": ("config4", 64, 64, 300),
    "orbit_of_100": ("config4", 64, 64, 100),
    "orbit_of_1": ("config4", 64, 64, 1),
    "plane_7x9": ("config4", 7, 9, None),
    "plane_37x29": ("config4", 37, 29, None),
    "escape_in_first_tile": ("exterior", 40, 40, None),
    "minibrot349_64": ("minibrot349", 64, 64, None),
}
RING_VIEWS = {
    # name: (Mandelbrot (centre, span, budget), Julia (centre, span,
    # budget, c), the deltas' shift off the centre).  "exterior": the
    # reference stays in the set for the whole budget (12 tiles), its
    # shifted lanes escape within a few steps.
    "config4": ((DEEP_VIEWS["config4"][0], 1e-10, 50000),
                (*DEEP_VIEWS["julia"][:3], DEEP_VIEWS["julia"][3]), 0.0),
    "exterior": ((("0", "0"), 1e-3, 3000),
                 (("0", "0"), 1e-3, 3000, ("-0.123", "0.745")), 1.5),
    "minibrot349": ((NUCLEUS_349, 1.5e-17, 50000),
                    (("0", "0"), 1.5e-17, 50000, NUCLEUS_349), 0.0),
}
# perturb_kernels.cu: kSmoothMaxStages, the ring's deepest.
RING_DEPTH = 4


def _ring_inputs(view, julia, h, w, keep, dtype, cuda):
    from distributedmandelbrot_tpu_torch.ops import perturbation as pt
    if julia:
        center, span, mi, jc = RING_VIEWS[view][1]
    else:
        (center, span, mi), jc = RING_VIEWS[view][0], None
    spec = pt.DeepTileSpec(*center, span, width=w, height=h)
    need = int(-np.log2(spec.step)) + 64
    bits = max(pt.DEFAULT_PREC_BITS, -(-need // 128) * 128)
    za, zb = pt._to_fixed(center[0], bits), pt._to_fixed(center[1], bits)
    ca, cb = ((za, zb) if jc is None else
              (pt._to_fixed(jc[0], bits), pt._to_fixed(jc[1], bits)))
    orbit, o_re, o_im = pt._find_reference(
        za, zb, ca, cb, span, mi, bits, add_dc=jc is None,
        device=str(cuda))
    zr, zi = orbit.on(cuda)
    dre, dim = spec.delta_grids(np.float64)
    shift = RING_VIEWS[view][2]
    row = torch.as_tensor((dre[0] - o_re + shift).astype(dtype), device=cuda)
    col = torch.as_tensor((dim[:, 0] - o_im + shift).astype(dtype),
                          device=cuda)
    return (zr[:keep], zi[:keep], row[None, :].expand(h, w),
            col[:, None].expand(h, w), jc is None)


def _tiles_bounds(n, act_b, orbit_len):
    """The tiles K10's blocks may stage for these lanes: a block stages
    every tile up to its last live lane's, at least the ring's first
    fill, and at most the ring's depth less one beyond that tile."""
    from distributedmandelbrot_tpu_torch.ops import cuda_perturb as cp
    tile = cp.ORBIT_TILE
    tiles = -(-orbit_len // tile)
    depth = min(RING_DEPTH, tiles)
    need = torch.where(act_b, orbit_len, n + 1).reshape(-1).to(torch.int64)
    pad = -need.numel() % 256
    last = torch.nn.functional.pad(need, (0, pad)).reshape(-1, 256).amax(1)
    used = (last + tile - 1) // tile
    lo = torch.clamp(used, min=depth)
    hi = torch.clamp(used + depth - 1, max=tiles)
    return int(lo.sum()), int(hi.sum()), int(last.max()), len(last), tiles


@pytest.mark.parametrize("julia", [False, True], ids=["mandelbrot", "julia"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_k10_ring_edges_are_bitwise_and_count_their_tiles(cuda, case, dtype,
                                                          julia):
    """K10 bitwise to its plain version at the ring's edges, and its
    ``tiles`` count within what these lanes need: exactly every tile of
    every block where a lane of each block runs the whole orbit, at most
    the ring's depth a block where every lane escapes in the first
    tile."""
    from distributedmandelbrot_tpu_torch.ops import cuda_perturb as cp
    view, h, w, keep = RING_CASES[case]
    zr, zi, dre, dim, add_dc = _ring_inputs(view, julia, h, w, keep, dtype,
                                            cuda)
    tiles = torch.zeros(1, dtype=torch.int64, device=cuda)
    got = cp.perturb_smooth_state_cuda(zr, zi, dre, dim, bailout=256.0,
                                       add_dc=add_dc, tiles=tiles)
    want = cp.perturb_smooth_state_plain(zr, zi, dre, dim, bailout=256.0,
                                         add_dc=add_dc)
    for name, g, wnt in zip(("n", "n2", "fzr", "fzi", "act_b", "act2",
                             "glitched"), got, want):
        assert torch.equal(g, wnt), name
    lo, hi, last, blocks, orbit_tiles = _tiles_bounds(want[0], want[4],
                                                      zr.shape[0])
    staged = int(tiles.item())
    assert lo <= staged <= hi
    if case == "escape_in_first_tile":
        assert last <= cp.ORBIT_TILE and staged <= blocks * RING_DEPTH
    if case == "minibrot349_64" and julia:
        assert bool(want[4].all())
        assert staged == blocks * orbit_tiles


def test_deep_render_runs_on_k9_and_k10(cuda, tmp_path):
    """``render`` of the config-4 view, integer and smooth, launches K9
    and K10 (the route never takes the plain scans on the card)."""
    from distributedmandelbrot_tpu_torch import cli
    from distributedmandelbrot_tpu_torch.ops import cuda_perturb as cp
    base = ["render", "--deep", "--center=-0.77568376995,0.13646737005",
            "--span", "1e-10", "--max-iter", "50000", "--definition", "256",
            "--out", str(tmp_path / "d.png"), "-q"]
    cp.reset_launch_counts()
    assert cli.main(base) == 0
    assert cp.launch_counts()["perturb_scan"] > 0
    assert cli.main([*base, "--smooth", "--dtype", "f64"]) == 0
    assert cp.launch_counts()["perturb_scan_smooth"] > 0
