"""The port's pipelined worker drains the JAX package's coordinator over
TCP: grant -> TileSpec -> launch (here the plain versions, on the CPU)
-> device-to-host -> flat uint8 chunk -> upload, then the stored bytes
are fetched back and held against the golden.  Chunks are full 4096^2
(the wire requires it), budgets tiny."""

import numpy as np
import pytest
import torch

from distributedmandelbrot_tpu.coordinator import EmbeddedCoordinator
from distributedmandelbrot_tpu.core.workload import (Workload as RefWorkload,
                                                     parse_level_settings)
from distributedmandelbrot_tpu.viewer import DataClient, FetchStatus
from distributedmandelbrot_tpu.worker import backends as ref_backends
from distributedmandelbrot_tpu_torch import cli
from distributedmandelbrot_tpu_torch.core.geometry import TileSpec
from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.ops import escape_time
from distributedmandelbrot_tpu_torch.worker import (CudaBackend,
                                                    DistributerClient,
                                                    TorchBackend, Worker)


def _golden(level, max_iter, i, j):
    """The bit-exact C++ golden where it builds (the numpy golden takes
    seconds per 4096^2 chunk), else the numpy golden."""
    from distributedmandelbrot_tpu import native
    backend = (ref_backends.NativeBackend() if native.native_supported()
               else ref_backends.NumpyBackend())
    return backend.compute_batch([RefWorkload(level, max_iter, i, j)])[0]


def _drain(tmp_path, levels, backend):
    settings = parse_level_settings(levels)
    chunks = [(s.level, s.max_iter, i, j) for s in settings
              for i in range(s.level) for j in range(s.level)]
    with EmbeddedCoordinator(str(tmp_path), settings) as co:
        worker = Worker(DistributerClient("127.0.0.1", co.distributer_port),
                        backend, window=4, depth=2)
        worker.run_until_drained()
        co.wait_saves_settled(expected_accepted=len(chunks))
        assert co.scheduler.is_complete()
        data = DataClient("127.0.0.1", co.dataserver_port)
        stored = {}
        for level, mi, i, j in chunks:
            pixels, status = data.fetch(level, i, j)
            assert status is FetchStatus.OK
            stored[(level, mi, i, j)] = np.asarray(pixels)
        data.close()
    return worker, stored


def test_f64_worker_stores_golden_bytes(tmp_path):
    """TorchBackend in f64 on the CPU: every stored chunk byte-identical
    to the golden."""
    worker, stored = _drain(tmp_path, "2:12",
                            TorchBackend(dtype=np.float64, device="cpu"))
    assert len(stored) == 4
    for key, pixels in stored.items():
        assert pixels.shape == (4096 * 4096,)
        assert np.array_equal(pixels, _golden(*key)), key
    assert worker.counters.get(obs_names.WORKER_TILES_COMPUTED) == 4
    assert worker.pipeline.stage_stats()["fusion"]["tiles"] == 4


def test_cuda_backend_worker_fuses_and_meets_the_golden_bar(tmp_path):
    """CudaBackend on the CPU (the kernels' plain versions) through the
    pipelined worker: batches fuse into K2 launches, nothing demotes,
    and each chunk meets the golden bar of the fused route (the f64
    proven interior bitwise, at most 2% off it).  Level 2 rides beside
    level 1, whose single chunk has nothing to fuse with."""
    backend = CudaBackend(device="cpu")
    worker, stored = _drain(tmp_path, "1:12,2:12", backend)
    assert len(stored) == 5
    reg = worker.registry
    assert reg.counter_value(obs_names.WORKER_KERNEL_FUSED_LAUNCHES) >= 1
    assert backend.demotions(obs_names.ROUTE_PER_TILE_TO_TORCH) == 0
    assert backend.demotions(obs_names.ROUTE_FUSED_TO_PER_TILE) == 0
    for (level, mi, i, j), pixels in stored.items():
        golden = _golden(level, mi, i, j)
        cr, ci = TileSpec.for_chunk(level, i, j).grid_2d()
        mask = escape_time.mandelbrot_interior(
            torch.from_numpy(cr), torch.from_numpy(ci)).numpy().ravel()
        assert np.array_equal(pixels[mask], golden[mask])
        assert float((pixels[~mask] != golden[~mask]).mean()) <= 0.02


def test_cli_worker_flags(tmp_path, capsys):
    """``python -m distributedmandelbrot_tpu_torch worker`` with the numpy
    backend drains a coordinator and writes its stats."""
    out = tmp_path / "stats.json"
    with EmbeddedCoordinator(str(tmp_path),
                             parse_level_settings("1:6")) as co:
        rc = cli.main(["worker", "--port", str(co.distributer_port),
                       "--backend", "numpy", "--window", "2", "--depth",
                       "1", "--stats-json", str(out), "-q"])
        assert rc == 0
        co.wait_saves_settled(expected_accepted=1)
    assert "drained" in capsys.readouterr().out
    assert out.exists()
    assert cli.main(["--help"]) == 0
    assert cli.main(["no-such-command"]) == 2  # unknown to both CLIs
    with pytest.raises(SystemExit) as exc:
        cli.main(["render"])  # --out is required
    assert exc.value.code == 2
    with pytest.raises(SystemExit):
        cli.main(["worker", "--backend", "cuda", "--dtype", "f64"])
