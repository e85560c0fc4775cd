"""The port's multi-process worker (``parallel/multihost.py``) on real
``torch.distributed`` ``gloo`` ranks, here on the CPU: each rank is a
subprocess whose mesh names the CPU twice (two shards per rank, four in
the group), with a timeout of its own.

- ``batched_escape_pixels_multihost`` over two ranks equals the
  one-process result on the same four-shard mesh, for the kernels'
  route (their plain versions) and the torch loop;
- a mismatched local batch raises on every rank, with no hang;
- ``run_spmd_worker`` drains the JAX package's coordinator at level 3,
  max_iter 12: 9 full 4096^2 chunks in three rounds of four (the last
  ragged), stored within 5e-4 of the golden, as
  ``tests/test_multihost.py`` holds the reference's."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent

_RANK = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

from distributedmandelbrot_tpu_torch.parallel import multihost

torch.set_num_threads(2)
mode, port, pid, n_proc, out = (sys.argv[1], sys.argv[2], int(sys.argv[3]),
                                int(sys.argv[4]), sys.argv[5])
multihost.initialize("127.0.0.1:" + port, num_processes=n_proc,
                     process_id=pid)
assert multihost.process_count() == n_proc
assert multihost.is_primary() == (pid == 0)
mesh = multihost.global_tile_mesh(["cpu", "cpu"])
assert mesh.devices.size == 2 * n_proc
assert mesh.local_devices(pid) == [torch.device("cpu")] * 2
if mode == "batch":
    data = np.load(out + ".in.npz")
    k_local = len(data["mrds"]) // n_proc
    lo = pid * k_local
    for kernel in ("cuda", "torch"):
        got = multihost.batched_escape_pixels_multihost(
            mesh, data["params"][lo:lo + k_local],
            data["mrds"][lo:lo + k_local], definition=64, kernel=kernel)
        np.save(f"{out}.{kernel}.{pid}.npy", got)
    print(f"proc {pid} batch OK")
elif mode == "mismatch":
    k_local = 2 if pid == 0 else 4
    params = np.tile([[1.5, 1.5, 0.01]], (k_local, 1))
    try:
        multihost.batched_escape_pixels_multihost(
            mesh, params, np.full(k_local, 20), definition=64)
        print(f"proc {pid} did not raise")
    except ValueError as e:
        print(f"proc {pid} raised: {e}")
elif mode == "farm":
    rounds = multihost.run_spmd_worker("127.0.0.1", int(out), mesh=mesh,
                                       kernel="cuda")
    print(f"proc {pid} farm OK rounds={rounds}")
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(mode: str, out: str, n_proc: int = 2,
               timeout: float = 180) -> list[str]:
    """Start ``n_proc`` ranks and wait for all; a rank that fails, or
    outlives ``timeout``, fails the test (every rank is killed)."""
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, mode, port, str(pid), str(n_proc),
         out], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(n_proc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text[-3000:]
    return outs


def test_two_ranks_equal_one_process(tmp_path):
    from distributedmandelbrot_tpu_torch.core.workload import Workload
    from distributedmandelbrot_tpu_torch.parallel.backend import batch_params
    from distributedmandelbrot_tpu_torch.parallel.mesh import make_mesh
    from distributedmandelbrot_tpu_torch.parallel.sharding import (
        batched_escape_pixels, batched_escape_pixels_cuda)

    rng = np.random.default_rng(20261016)
    ws = [Workload(4, int(mi), i, j) for (i, j), mi in zip(
        [(1, 1), (1, 2), (2, 1), (2, 2), (0, 1), (3, 2), (1, 0), (2, 3)],
        rng.choice([40, 300, 700, 5000], size=8))]
    params, mrds = batch_params(ws, 64)
    out = str(tmp_path / "batch")
    np.savez(out + ".in.npz", params=params, mrds=mrds)
    outs = _run_ranks("batch", out)
    for pid, text in enumerate(outs):
        assert f"proc {pid} batch OK" in text
    four = make_mesh(["cpu"] * 4)
    want = {"cuda": batched_escape_pixels_cuda(four, params, mrds,
                                               definition=64),
            "torch": batched_escape_pixels(four, params, mrds,
                                           definition=64)}
    for kernel, expect in want.items():
        got = np.concatenate([np.load(f"{out}.{kernel}.{pid}.npy")
                              for pid in range(2)])
        assert got.shape == (8, 64, 64)
        assert np.array_equal(got, expect), kernel


def test_mismatched_local_batches_raise_on_every_rank(tmp_path):
    outs = _run_ranks("mismatch", str(tmp_path / "unused"), timeout=120)
    for pid, text in enumerate(outs):
        assert f"proc {pid} raised" in text, text[-2000:]
        assert "local batches were [2, 4]" in text


def test_spmd_worker_drains_the_reference_coordinator(tmp_path):
    from distributedmandelbrot_tpu import native
    from distributedmandelbrot_tpu.coordinator import EmbeddedCoordinator
    from distributedmandelbrot_tpu.core.workload import LevelSetting
    from distributedmandelbrot_tpu.core.workload import Workload as RefWL
    from distributedmandelbrot_tpu.worker import backends as ref_backends

    with EmbeddedCoordinator(str(tmp_path), [LevelSetting(3, 12)]) as co:
        outs = _run_ranks("farm", str(co.distributer_port), timeout=240)
        for pid, text in enumerate(outs):
            assert f"proc {pid} farm OK rounds=3" in text, text[-2000:]
        co.wait_saves_settled(expected_accepted=9, timeout=120)
        assert co.scheduler.is_complete()
        if native.native_supported():
            gold_backend = ref_backends.NativeBackend()
            tiles = [(i, j) for i in range(3) for j in range(3)]
        else:  # the numpy golden takes seconds per 4096^2 chunk
            gold_backend = ref_backends.NumpyBackend()
            tiles = [(1, 0)]
        for i, j in tiles:
            got = np.asarray(co.coordinator.store.load(3, i, j).data,
                             np.uint8).ravel()
            want = gold_backend.compute_batch([RefWL(3, 12, i, j)])[0]
            mism = float((got != want).mean())
            assert mism <= 5e-4, f"tile ({i},{j}): {mism:.2%} vs golden"


def test_cli_multihost_and_mesh_worker_flags(tmp_path, capsys, monkeypatch):
    """``worker --multihost`` in one process (a group of one, CPU
    devices) and ``worker --backend mesh --device cpu`` each drain a
    chunk; ``--multihost`` refuses a ``--backend``; without a GPU
    neither starts unless CPU devices are asked for."""
    from distributedmandelbrot_tpu.coordinator import EmbeddedCoordinator
    from distributedmandelbrot_tpu.core.workload import parse_level_settings
    from distributedmandelbrot_tpu_torch import cli

    with EmbeddedCoordinator(str(tmp_path / "a"),
                             parse_level_settings("1:6")) as co:
        try:
            assert cli.main([
                "worker", "--port", str(co.distributer_port), "--multihost",
                "--mh-coordinator", f"127.0.0.1:{_free_port()}",
                "--mh-processes", "1", "--mh-process-id", "0", "--device",
                "cpu", "--batch-size", "3", "-q"]) == 0
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        co.wait_saves_settled(expected_accepted=1)
    assert "multihost worker: drained after 1 round(s)" in \
        capsys.readouterr().out
    with EmbeddedCoordinator(str(tmp_path / "b"),
                             parse_level_settings("1:6")) as co:
        assert cli.main(["worker", "--port", str(co.distributer_port),
                         "--backend", "mesh", "--device", "cpu",
                         "--kernel", "cuda", "-q"]) == 0
        co.wait_saves_settled(expected_accepted=1)
    assert "drained" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="ignores --backend"):
        cli.main(["worker", "--multihost", "--backend", "cuda"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["worker", "--backend", "mesh"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["worker", "--multihost"])
