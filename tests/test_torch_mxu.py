"""The port's matrix form of the iteration (K8, ``ops/mxu_iteration.py``)
and its ``DMTPU_MXU`` gate, against the JAX package's
``ops/mxu_iteration.py`` and its fused route.

Here, on the CPU, the wrappers take the plain versions; the kernels'
matrix form and the probe's device functions are held bitwise against
those on the card (test_torch_gpu.py and chip_smoke.py)."""

import numpy as np
import pytest
import torch

from distributedmandelbrot_tpu.core.geometry import TileSpec as RefSpec
from distributedmandelbrot_tpu.ops import escape_time as ref_et
from distributedmandelbrot_tpu.ops import mxu_iteration as ref_mxu
from distributedmandelbrot_tpu.ops import pallas_escape as pe
from distributedmandelbrot_tpu.ops import reference as golden
from distributedmandelbrot_tpu_torch.core.workload import Workload
from distributedmandelbrot_tpu_torch.core.geometry import TileSpec
from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.ops import cuda_escape as ce
from distributedmandelbrot_tpu_torch.ops import escape_time
from distributedmandelbrot_tpu_torch.ops import mxu_iteration as mxu
from distributedmandelbrot_tpu_torch.parallel.mesh import make_mesh
from distributedmandelbrot_tpu_torch.parallel.sharding import (
    compute_tiles_mega_sharded)
from distributedmandelbrot_tpu_torch.worker.backends import CudaBackend

TILE = 128
VIEWS = {"seahorse": (-0.7436, 0.1317, 2e-3), "valley": (-0.8, 0.1, 0.2),
         "full": (-2.0, -2.0, 4.0), "sky": (1.5, 1.5, 0.1),
         "bulb": (-0.2, -0.05, 0.1)}
CPU = ("cpu", None)


def _spec(view, cls=TileSpec):
    x, y, s = VIEWS[view]
    return cls(x, y, s, s, width=TILE, height=TILE)


@pytest.fixture(autouse=True)
def _fresh_gate(monkeypatch):
    """Every test starts with the gate off and no cached verdict."""
    monkeypatch.delenv(mxu.MXU_ENV, raising=False)
    mxu.reset_mxu_cache()
    yield
    mxu.reset_mxu_cache()


def _seed7():
    """The inputs of test_pallas.py's test_mxu_step_is_the_complex_square."""
    rng = np.random.default_rng(7)
    zr = rng.uniform(-1.5, 1.5, (8, 16)).astype(np.float32)
    zi = rng.uniform(-1.5, 1.5, (8, 16)).astype(np.float32)
    cr = rng.uniform(-2.0, 1.0, (8, 16)).astype(np.float32)
    ci = rng.uniform(-1.5, 1.5, (8, 16)).astype(np.float32)
    return zr, zi, cr, ci


def test_mxu_step_against_the_jax_step_and_complex64():
    """z^2 + c, against the JAX ``mxu_step`` (XLA's 2-term dot) and the
    complex64 square, rtol 1e-5 (atol 1e-5 near zero), the reference's
    own tolerance."""
    import jax.numpy as jnp
    zr, zi, cr, ci = _seed7()
    got = mxu.mxu_step(*(torch.from_numpy(a) for a in (zr, zi, cr, ci)))
    ref = ref_mxu.mxu_step(*(jnp.asarray(a) for a in (zr, zi, cr, ci)))
    z = (zr + 1j * zi).astype(np.complex64)
    want = z * z + (cr + 1j * ci)
    for g, r, w in zip(got, ref, (want.real, want.imag)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e3])
def test_mxu_step_is_the_cached_squares_step_bitwise(scale):
    """On torch's CPU ops (no contraction) one matrix step equals one
    cached-squares step, bit for bit, at three magnitudes."""
    zr, zi, cr, ci = (torch.from_numpy(a * np.float32(scale))
                      for a in _seed7())
    got_r, got_i = mxu.mxu_step(zr, zi, cr, ci)
    want_i = (zr + zr) * zi + ci
    want_r = (zr * zr - zi * zi) + cr
    assert torch.equal(got_r.view(torch.int32), want_r.view(torch.int32))
    assert torch.equal(got_i.view(torch.int32), want_i.view(torch.int32))


def test_cpu_probe_admits_the_matrix_form():
    """The port's CPU probe (the plain versions) finds no differing lane
    of the 64x64 panel after 32 steps, so full mode is proven here —
    where the reference's XLA:CPU probe is not (it contracts the dot)."""
    assert mxu.probe_differences("cpu") == 0
    assert mxu.mxu_parity_proven("cpu") is True
    assert mxu._parity_cache[CPU] is True


def test_cpu_probe_cached_form_is_the_numpy_recurrence():
    """The probe's cached-squares planes are the f32 recurrence as numpy
    computes it (NaN lanes, where the orbit overflowed, compared as
    NaN)."""
    planes = mxu.probe_planes("cpu").numpy()
    xs = np.linspace(-2.0, 1.0, mxu.PROBE_N, dtype=np.float32)
    ys = np.linspace(-1.5, 1.5, mxu.PROBE_N, dtype=np.float32)
    cr, ci = np.meshgrid(xs, ys)
    zr, zi = cr.copy(), ci.copy()
    with np.errstate(all="ignore"):
        zr2, zi2 = zr * zr, zi * zi
        for _ in range(mxu.PROBE_STEPS):
            zi = (zr + zr) * zi + ci
            zr = (zr2 - zi2) + cr
            zr2, zi2 = zr * zr, zi * zi
    assert np.array_equal(planes[0], zr, equal_nan=True)
    assert np.array_equal(planes[1], zi, equal_nan=True)


@pytest.mark.parametrize("env,forced,want", [
    (None, None, "off"), ("0", True, "off"), ("1", True, "full"),
    ("1", False, "census")])
def test_gate_mapping(monkeypatch, env, forced, want):
    """Off by default and for ``0``; with ``1``, full or census by the
    cached verdict of the device."""
    if env is not None:
        monkeypatch.setenv(mxu.MXU_ENV, env)
    if forced is not None:
        mxu._parity_cache[CPU] = forced
    assert mxu.mxu_mode("cpu") == want
    assert mxu.mxu_mode_for(["cpu", "cpu"]) == want


def test_gate_verdicts_are_per_device(monkeypatch):
    """The verdict is cached per device (type and index); a mesh is full
    only if every device is."""
    monkeypatch.setenv(mxu.MXU_ENV, "1")
    mxu._parity_cache[CPU] = True
    mxu._parity_cache[("cuda", 0)] = False
    mxu._parity_cache[("cuda", 1)] = True
    assert mxu.mxu_mode("cpu") == "full"
    assert mxu.mxu_mode(torch.device("cuda", 0)) == "census"
    assert mxu.mxu_mode("cuda:1") == "full"
    assert mxu.mxu_mode_for(["cuda:1", "cpu"]) == "full"
    assert mxu.mxu_mode_for(["cuda:1", "cuda:0"]) == "census"
    mxu.reset_mxu_cache()
    assert mxu._parity_cache == {}


def test_gate_reaches_the_plan(monkeypatch):
    """``use_mxu=None`` resolves the gate for the plan's device(s)."""
    specs = [_spec("sky"), _spec("bulb")]
    assert not ce.mega_dispatch_plan(specs, [300, 300],
                                     device="cpu")[2]["use_mxu"]
    monkeypatch.setenv(mxu.MXU_ENV, "1")
    mxu._parity_cache[CPU] = True
    assert ce.mega_dispatch_plan(specs, [300, 300],
                                 device="cpu")[2]["use_mxu"]
    assert ce.mega_dispatch_plan(specs, [300, 300],
                                 device=["cpu", "cpu"])[2]["use_mxu"]
    mxu._parity_cache[CPU] = False
    assert not ce.mega_dispatch_plan(specs, [300, 300],
                                     device="cpu")[2]["use_mxu"]


def _mega_mxu(kind, power, burning):
    spec = _spec("sky")
    if kind == "k1":
        return ce.compute_tile_cuda_device(spec, 100, use_mxu=True,
                                           power=power, burning=burning,
                                           interior_check=False,
                                           device="cpu")
    if kind == "k2":
        return ce.compute_tiles_mega_cuda([spec, spec], [100, 100],
                                          use_mxu=True, power=power,
                                          burning=burning, device="cpu")
    return compute_tiles_mega_sharded([spec, spec], [100, 100],
                                      mesh=make_mesh(["cpu", "cpu"]),
                                      use_mxu=True, power=power,
                                      burning=burning)


@pytest.mark.parametrize("kind", ["k1", "k2", "sharded"])
@pytest.mark.parametrize("power,burning", [(2, True), (3, False)])
def test_mxu_guards_for_ship_and_multibrot(kind, power, burning):
    """The matrix form embeds z^2 only: the ship's fold and degree 3
    decline it, as the reference's plan does."""
    with pytest.raises(ce.KernelUnsupported, match="[Mm][Xx][Uu]"):
        _mega_mxu(kind, power, burning)
    sky = _spec("sky", RefSpec)
    with pytest.raises(pe.PallasUnsupported, match="[Mm][Xx][Uu]"):
        pe.mega_dispatch_plan([sky, sky], [100, 100], block_h=32,
                              interpret=True, use_mxu=True, power=power,
                              burning=burning)


def test_escape_loop_refuses_the_matrix_form_off_degree_two():
    z = torch.zeros(4)
    with pytest.raises(ValueError, match="matrix form"):
        escape_time.escape_loop(z, z, z, z, total_steps=5, power=3,
                                use_mxu=True)


def test_census_counts_equal_the_reference():
    """The reference's sky and bulb rows (test_pallas.py's
    test_mxu_guards_and_census): the whole 32x32 panel escapes on the
    sky, at most a row of it on the bulb.  Every view here, boundary
    views included, gives the JAX counts exactly."""
    specs = [_spec(v, RefSpec) for v in VIEWS] + [
        RefSpec(-0.1, -0.05, 0.02, 0.02, width=TILE, height=TILE)]
    rows = [pe._params_row(s) for s in specs]
    mis = [300, 300, 40, 300, 300, 300]
    got = mxu.mxu_census_counts(rows, mis, height=TILE, width=TILE,
                                device="cpu")
    want = ref_mxu.mxu_census_counts(rows, mis, height=TILE, width=TILE)
    assert got.dtype == np.int32 and got.shape == (len(rows),)
    assert np.array_equal(got, want), (got, want)
    names = list(VIEWS)
    assert int(got[names.index("sky")]) == mxu.CENSUS_PANEL ** 2
    assert int(got[-1]) <= mxu.CENSUS_PANEL
    assert int(got[names.index("bulb")]) <= mxu.CENSUS_PANEL


@pytest.mark.parametrize("julia", [False, True])
def test_matrix_form_kernels_equal_the_cached_form(julia):
    """K8's plain version inside K1 and K2 (mixed budgets, the probe
    armed by the deepest) gives the cached-squares pixels and census,
    bitwise, Mandelbrot and Julia."""
    views = ["seahorse", "valley", "full", "bulb"]
    specs = [_spec(v) for v in views]
    mis = [300, 1024, 2000, 256]
    jc = [complex(-0.8, 0.156)] * len(specs) if julia else None
    on = ce.compute_tiles_mega_cuda(specs, mis, julia_cs=jc, use_mxu=True,
                                    device="cpu")
    off = ce.compute_tiles_mega_cuda(specs, mis, julia_cs=jc, use_mxu=False,
                                     device="cpu")
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    for t, (spec, mi) in enumerate(zip(specs, mis)):
        one = ce.compute_tile_cuda_device(
            spec, mi, use_mxu=True, julia_c=jc[t] if julia else None,
            cycle_check=escape_time.resolve_cycle_check(None, max(mis)),
            device="cpu")
        assert torch.equal(on[0][t], one)


def test_matrix_form_against_interpret_mode():
    """The same rows through the reference's interpret-mode megakernel
    with ``use_mxu=True``: XLA:CPU contracts its 2-term dot (927 and 144
    pixels of 16384 differ from its own cached form on seahorse and
    valley at 300), the port does not, so the bar is the golden bar:
    interior pixels bitwise, the port's mismatch against the f64 golden
    at most the reference's plus 0.5 percentage points."""
    views = ["seahorse", "valley"]
    ref_specs = [_spec(v, RefSpec) for v in views]
    mis = [300, 300]
    ref_tiles, _ = pe.compute_tiles_mega_pallas(
        ref_specs, mis, block_h=32, interpret=True, use_mxu=True)
    tiles, _ = ce.compute_tiles_mega_cuda([_spec(v) for v in views], mis,
                                          use_mxu=True, device="cpu")
    for t, spec in enumerate(ref_specs):
        cr, ci = spec.grid_2d()
        gold = golden.scale_counts_to_uint8(
            golden.escape_counts(cr, ci, mis[t]), mis[t])
        mask = np.asarray(ref_et.mandelbrot_interior(cr, ci))
        got, ref = tiles[t].numpy(), np.asarray(ref_tiles[t])
        assert np.array_equal(got[mask], ref[mask])
        ours = float((got != gold).mean())
        theirs = float((ref != gold).mean())
        assert ours <= theirs + 0.005, (views[t], ours, theirs)


WORKLOADS = [Workload(4, 300, 3, 3), Workload(4, 300, 1, 1),
             Workload(4, 1024, 1, 2)]


def _drain(backend):
    return [backend.materialize_tile(h)
            for h in backend.dispatch_many(WORKLOADS)]


@pytest.mark.parametrize("ring", [["cpu"], ["cpu", "cpu"]])
@pytest.mark.parametrize("verdict", [True, False])
def test_backend_under_the_gate(monkeypatch, ring, verdict):
    """``CudaBackend(device="cpu")`` on one position and on the two-shard
    ring, DMTPU_MXU=1 with each verdict forced: the chunks are the
    DMTPU_MXU=0 chunks, bitwise; full counts a matrix-form launch per
    fused batch, census a demotion and the shadow's pixels
    (test_pallas.py's test_backend_mxu_census_mode_counters)."""
    mesh = make_mesh(ring)
    want = _drain(CudaBackend(definition=TILE, device="cpu", mesh=mesh))
    monkeypatch.setenv(mxu.MXU_ENV, "1")
    mxu._parity_cache[CPU] = verdict
    backend = CudaBackend(definition=TILE, device="cpu", mesh=mesh)
    got = _drain(backend)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    cv = backend.registry.counter_value
    assert cv(obs_names.WORKER_KERNEL_FUSED_LAUNCHES) == 1
    assert (cv(obs_names.WORKER_MESH_LAUNCHES) or 0) == (len(ring) > 1)
    if verdict:
        assert cv(obs_names.WORKER_KERNEL_MXU_LAUNCHES) == 1
        assert cv(obs_names.WORKER_KERNEL_MXU_DEMOTIONS) is None
        assert cv(obs_names.WORKER_KERNEL_MXU_CENSUS) is None
    else:
        assert cv(obs_names.WORKER_KERNEL_MXU_DEMOTIONS) == 1
        assert cv(obs_names.WORKER_KERNEL_MXU_LAUNCHES) is None
        # The sky chunk's panel escapes entirely.
        assert (cv(obs_names.WORKER_KERNEL_MXU_CENSUS) or 0) >= (
            mxu.CENSUS_PANEL ** 2)
    assert cv(obs_names.WORKER_MXU_CENSUS_FAILURES) is None


def test_backend_gate_off_counts_nothing():
    backend = CudaBackend(definition=TILE, device="cpu")
    _drain(backend)
    cv = backend.registry.counter_value
    for name in (obs_names.WORKER_KERNEL_MXU_LAUNCHES,
                 obs_names.WORKER_KERNEL_MXU_DEMOTIONS,
                 obs_names.WORKER_KERNEL_MXU_CENSUS,
                 obs_names.WORKER_MXU_CENSUS_FAILURES):
        assert cv(name) is None


def test_census_failure_is_counted_not_raised(monkeypatch):
    """The shadow is advisory: a census that raises leaves the chunks as
    they are and is counted."""
    want = _drain(CudaBackend(definition=TILE, device="cpu"))
    monkeypatch.setenv(mxu.MXU_ENV, "1")
    mxu._parity_cache[CPU] = False

    def broken(*args, **kwargs):
        raise RuntimeError("census down")

    monkeypatch.setattr(mxu, "mxu_census_counts", broken)
    backend = CudaBackend(definition=TILE, device="cpu")
    got = _drain(backend)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    cv = backend.registry.counter_value
    assert cv(obs_names.WORKER_MXU_CENSUS_FAILURES) == 1
    assert cv(obs_names.WORKER_KERNEL_MXU_DEMOTIONS) == 1
    assert cv(obs_names.WORKER_KERNEL_MXU_CENSUS) is None


def test_matrix_form_launch_counts_stay_zero_on_the_cpu():
    ce.reset_launch_counts()
    ce.compute_tile_cuda_device(_spec("sky"), 10, use_mxu=True,
                                device="cpu")
    ce.compute_tiles_mega_cuda([_spec("sky")] * 2, [10, 10], use_mxu=True,
                               device="cpu")
    assert not any(ce.launch_counts().values())
    assert ce.KERNEL_TILE_MXU in ce.launch_counts()
    assert ce.KERNEL_MEGA_MXU in ce.launch_counts()
