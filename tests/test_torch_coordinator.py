"""The port's farm against the JAX package's, both ways, on the CPU: the
port's coordinator drained by the JAX package's worker and read by its
viewer client, the port's worker and viewer client against the JAX
package's coordinator, and the ``coordinator`` and ``viewer``
subcommands end to end.  Chunks are full 4096^2 (the wire requires it),
budgets tiny."""

import argparse
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from distributedmandelbrot_tpu import cli as ref_cli
from distributedmandelbrot_tpu.coordinator import \
    EmbeddedCoordinator as RefCoordinator
from distributedmandelbrot_tpu.core.workload import \
    parse_level_settings as ref_levels
from distributedmandelbrot_tpu.viewer import DataClient as RefDataClient
from distributedmandelbrot_tpu.viewer import FetchStatus as RefStatus
from distributedmandelbrot_tpu.viewer import stitch_level as ref_stitch
from distributedmandelbrot_tpu.worker import DistributerClient as RefClient
from distributedmandelbrot_tpu.worker import NumpyBackend as RefNumpy
from distributedmandelbrot_tpu.worker import Worker as RefWorker
from distributedmandelbrot_tpu_torch import cli
from distributedmandelbrot_tpu_torch.coordinator import EmbeddedCoordinator
from distributedmandelbrot_tpu_torch.core.workload import (
    Workload, parse_level_settings)
from distributedmandelbrot_tpu_torch.serve import render as srender
from distributedmandelbrot_tpu_torch.viewer import (DataClient, FetchStatus,
                                                    stitch_level)
from distributedmandelbrot_tpu_torch.worker import (DistributerClient,
                                                    NativeBackend,
                                                    TorchBackend, Worker)

REPO = Path(__file__).resolve().parent.parent


def _golden(level, max_iter, i, j):
    """The port's C++ loop, which its tests hold bitwise to the golden
    (the numpy golden takes seconds per 4096^2 chunk)."""
    return NativeBackend().compute_batch([Workload(level, max_iter, i,
                                                   j)])[0]


def test_port_coordinator_drained_by_the_jax_worker(tmp_path):
    """The JAX package's ``Worker`` with its ``NumpyBackend`` (the
    golden) drains the port's ``EmbeddedCoordinator``; the stored bytes
    are the golden's, and the JAX package's ``DataClient`` fetches them
    back from the port's data server and its gateway."""
    with EmbeddedCoordinator(str(tmp_path),
                             parse_level_settings("1:12")) as co:
        worker = RefWorker(RefClient("127.0.0.1", co.distributer_port),
                           RefNumpy())
        assert worker.run_until_drained() >= 1
        co.wait_saves_settled(expected_accepted=1)
        assert co.scheduler.is_complete()
        for port in (co.dataserver_port, co.gateway_port):
            with RefDataClient("127.0.0.1", port) as client:
                pixels, status = client.fetch(1, 0, 0)
                assert status is RefStatus.OK
                assert np.array_equal(pixels, _golden(1, 12, 0, 0))
                _, status = client.fetch(1, 0, 1)
                assert status is RefStatus.REJECTED
    # Stopped, the data directory holds the one chunk for a restart.
    with EmbeddedCoordinator(str(tmp_path),
                             parse_level_settings("1:12")) as co:
        assert co.scheduler.is_complete()


def test_jax_coordinator_port_worker_port_client(tmp_path):
    """The port's worker drains the JAX package's coordinator; the port's
    ``DataClient`` and ``stitch_level`` read the level back from the JAX
    data server, equal to the golden and to the JAX package's own
    client and stitch."""
    with RefCoordinator(str(tmp_path), ref_levels("2:12")) as co:
        worker = Worker(DistributerClient("127.0.0.1", co.distributer_port),
                        TorchBackend(dtype=np.float64, device="cpu"),
                        window=4, depth=2)
        worker.run_until_drained()
        co.wait_saves_settled(expected_accepted=4)
        with DataClient("127.0.0.1", co.dataserver_port) as client, \
                DataClient("127.0.0.1", co.gateway_port) as gateway, \
                RefDataClient("127.0.0.1", co.dataserver_port) as ref:
            golden = {(i, j): _golden(2, 12, i, j)
                      for i in range(2) for j in range(2)}
            for (i, j), want in golden.items():
                pixels, status = client.fetch(2, i, j)
                assert status is FetchStatus.OK
                assert np.array_equal(pixels, want), (i, j)
            many = gateway.fetch_many([(2, 0, 0), (2, 1, 1)])
            assert [s for _, s in many] == [FetchStatus.OK] * 2
            assert np.array_equal(many[1][0], golden[(1, 1)])
            _, status = client.fetch(3, 0, 0)
            assert status is FetchStatus.NOT_AVAILABLE

            def fetch(i, j):
                return client.fetch(2, i, j)[0]

            def ref_fetch(i, j):
                return ref.fetch(2, i, j)[0]

            level = stitch_level(fetch, 2)
            assert np.array_equal(level, ref_stitch(ref_fetch, 2))
    assert level.shape == (8192, 8192)
    assert np.array_equal(level[4096:, :4096].ravel(), golden[(0, 1)])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_listening(port: int, proc, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.communicate()
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            time.sleep(0.1)
    raise TimeoutError(f"nothing listens on port {port}")


def _wait_stored(port: int, chunks, proc, timeout: float = 60.0) -> None:
    """Poll the data server until every chunk fetches ``OK``: the
    coordinator accepts a chunk before its group-commit save lands."""
    deadline = time.monotonic() + timeout
    with DataClient("127.0.0.1", port) as client:
        while True:
            assert proc.poll() is None, proc.communicate()
            missing = [c for c in chunks
                       if client.fetch(*c)[1] is not FetchStatus.OK]
            if not missing:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(f"chunks never stored: {missing}")
            time.sleep(0.1)


def test_coordinator_worker_viewer_commands(tmp_path):
    """``coordinator`` as a process of its own, drained by the port's
    ``worker`` (``--backend native``); ``viewer`` writes a chunk and a
    stitched level as the PNGs the fetched values colour to, and
    reports a chunk out of the grid."""
    dist, data = _free_port(), _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributedmandelbrot_tpu_torch",
         "coordinator", "-l", "1:12,2:12", "-o", str(tmp_path), "--host",
         "127.0.0.1", "--distributer-port", str(dist), "--dataserver-port",
         str(data), "--exporter-port", "-1", "--stats-period", "0", "-q"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, text=True)
    try:
        _wait_listening(data, proc)
        assert cli.main(["worker", "--port", str(dist), "--backend",
                         "native", "-q"]) == 0
        _wait_stored(data, [(1, 0, 0)] + [(2, i, j) for i in range(2)
                                          for j in range(2)], proc)
        png = tmp_path / "chunk.png"
        assert cli.main(["viewer", "2", "1", "0", "--port", str(data),
                         "--out", str(png), "--colormap", "plasma"]) == 0
        stitched = tmp_path / "level.png"
        assert cli.main(["viewer", "1", "--stitch", "--port", str(data),
                         "--out", str(stitched)]) == 0
        assert cli.main(["viewer", "2", "2", "0", "--port",
                         str(data)]) == 2
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    assert "coordinator: 2 level(s), 5 tiles" in out

    def colours(values, colormap="jet"):
        lut = srender.imsave_bytes(srender.value_to_rgba(
            np.arange(256, dtype=np.uint8).reshape(16, 16),
            colormap)).reshape(256, 4)
        return lut[values.reshape(4096, 4096)]

    assert np.array_equal(np.asarray(Image.open(png)),
                          colours(_golden(2, 12, 1, 0), "plasma"))
    assert np.array_equal(np.asarray(Image.open(stitched)),
                          colours(_golden(1, 12, 0, 0)))


def test_viewer_prompts_and_refusals(monkeypatch, capsys):
    """Without a level the viewer prompts as the original does; closed
    input or a non-numeric answer is a usage error; an unreachable data
    server is exit 1."""
    answers = iter(["127.0.0.1", str(_free_port()), "2", "0", "1"])
    monkeypatch.setattr("builtins.input", lambda prompt: next(answers))
    assert cli.main(["viewer", "--out", "x.png"]) == 1
    assert "cannot reach data server" in capsys.readouterr().err

    def closed(prompt):
        raise EOFError

    monkeypatch.setattr("builtins.input", closed)
    with pytest.raises(SystemExit) as exc:
        cli.main(["viewer"])
    assert exc.value.code == 2
    monkeypatch.setattr("builtins.input", lambda prompt: "x")
    with pytest.raises(SystemExit) as exc:
        cli.main(["viewer"])
    assert exc.value.code == 2
    with pytest.raises(SystemExit) as exc:
        cli.main(["viewer", "--stitch"])
    assert exc.value.code == 2
    with pytest.raises(SystemExit, match="carries"):
        cli.main(["viewer", "1", "0", "0", "--colormap", "magma"])


class _Parsed(Exception):
    pass


def _parser_of(command, monkeypatch) -> argparse.ArgumentParser:
    """The argparse parser a subcommand builds, caught at its parse."""
    seen = []

    def catch(self, args=None, namespace=None):
        seen.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed):
        command([])
    monkeypatch.undo()
    return seen[0]


def _options(parser) -> dict:
    return {opt: (action.default, tuple(action.choices or ()),
                  action.nargs)
            for action in parser._actions for opt in action.option_strings
            or [action.dest]}


@pytest.mark.parametrize("name", ["coordinator", "serve", "viewer",
                                  "animate", "coord", "top", "postmortem",
                                  "compact", "stats", "trace", "admin",
                                  "loadgen", "chaos"])
def test_subcommands_take_the_jax_flags(name, monkeypatch):
    """Each new subcommand takes the JAX package's flags and positionals
    with its defaults and choices; ``animate`` has ``--no-kernel`` in
    place of ``--no-pallas`` and ``--device`` besides, as ``render``."""
    got = _options(_parser_of(getattr(cli, f"cmd_{name}"), monkeypatch))
    want = _options(_parser_of(getattr(ref_cli, f"cmd_{name}"),
                               monkeypatch))
    if name == "animate":
        want["--no-kernel"] = want.pop("--no-pallas")
        want["--device"] = ("cuda", (), None)
    assert got == want
