"""The port's serving plane on the CPU: its coordinator's gateway with its
worker attached (``TorchBackend``) computes a missing tile on read, then
serves it from the cache, and renders palette PNGs that are the JAX
package's bytes; the colormap tables against matplotlib."""

import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from distributedmandelbrot_tpu.core.geometry import CHUNK_PIXELS
from distributedmandelbrot_tpu.serve import render as ref_render
from distributedmandelbrot_tpu_torch import cli
from distributedmandelbrot_tpu_torch.coordinator import EmbeddedCoordinator
from distributedmandelbrot_tpu_torch.core.workload import (
    Workload, parse_level_settings)
from distributedmandelbrot_tpu_torch.net import framing
from distributedmandelbrot_tpu_torch.net import protocol as proto
from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.serve import render as srender
from distributedmandelbrot_tpu_torch.viewer import DataClient, FetchStatus
from distributedmandelbrot_tpu_torch.worker import (DistributerClient,
                                                    NativeBackend,
                                                    TorchBackend, Worker)

REPO = Path(__file__).resolve().parent.parent
COLORMAPS = ["jet", "viridis", "plasma"]


def _tile() -> np.ndarray:
    """Every escape value, an in-set band and noise, as a full chunk."""
    pixels = np.tile(np.arange(256, dtype=np.uint8), CHUNK_PIXELS // 256)
    pixels[:4096] = 0
    rng = np.random.default_rng(7)
    pixels[-65536:] = rng.integers(0, 256, 65536)
    return pixels


@pytest.mark.parametrize("colormap", COLORMAPS)
def test_colormap_tables_are_matplotlibs(colormap):
    """The port's tables and float mapping give matplotlib 3.10's colors
    bit for bit, edges, out-of-range values and NaN included."""
    matplotlib = pytest.importorskip("matplotlib")
    cmap = matplotlib.colormaps[colormap]
    assert np.array_equal(srender.colormap_table(colormap)[:256],
                          cmap(np.arange(256)))
    x = np.concatenate([np.linspace(-0.25, 1.25, 100_001),
                        [0.0, 1.0, np.nextafter(1.0, 0.0), 255 / 256,
                         1 / 256, np.nan, -np.inf, np.inf]])
    assert np.array_equal(srender.apply_colormap(x, colormap), cmap(x))


@pytest.mark.parametrize("colormap", COLORMAPS)
def test_render_tile_png_gives_the_jax_bytes(colormap):
    """``value_lut``, ``render_tile_rgba8`` and ``render_tile_png`` equal
    the JAX package's; ``decode_rendered_png`` reads back ``LUT[tile]``;
    the smooth and value pipelines equal the JAX package's floats."""
    tile = _tile()
    assert np.array_equal(srender.value_lut(colormap),
                          ref_render.value_lut(colormap))
    body = srender.render_tile_png(tile, colormap)
    assert body == ref_render.render_tile_png(tile, colormap)
    square = tile.reshape(4096, 4096)
    assert np.array_equal(srender.render_tile_rgba8(square, colormap),
                          ref_render.render_tile_rgba8(square, colormap))
    assert np.array_equal(srender.decode_rendered_png(body),
                          srender.value_lut(colormap)[square])
    small = tile[:4096].reshape(64, 64)
    assert np.array_equal(srender.value_to_rgba(small, colormap),
                          ref_render.value_to_rgba(small, colormap))
    nu = np.random.default_rng(3).uniform(-1.0, 500.0, (64, 64))
    assert np.array_equal(srender.smooth_to_rgba(nu, 300, colormap),
                          ref_render.smooth_to_rgba(nu, 300, colormap))


def test_decoder_refuses_what_it_does_not_write():
    body = srender.render_tile_png(np.zeros((8, 8), np.uint8))
    with pytest.raises(ValueError, match="not a PNG"):
        srender.decode_rendered_png(b"GIF89a" + body)
    with pytest.raises(ValueError, match="cannot square-reshape"):
        srender.render_tile_png(np.zeros(10, np.uint8))
    rgba = srender.encode_png(np.zeros((8, 8, 4), np.uint8))
    with pytest.raises(ValueError, match="PLTE"):
        srender.decode_rendered_png(rgba)


def _golden(level, max_iter, i, j):
    return NativeBackend().compute_batch([Workload(level, max_iter, i,
                                                   j)])[0]


def _attach_worker(co, stop):
    worker = Worker(DistributerClient("127.0.0.1", co.distributer_port),
                    TorchBackend(dtype=np.float64, device="cpu"),
                    window=2, depth=1)
    t = threading.Thread(target=worker.run_forever,
                         kwargs=dict(poll_interval=0.05, stop=stop),
                         daemon=True)
    t.start()
    return t


def test_gateway_computes_on_read_then_serves_from_cache(tmp_path):
    """An absent tile fetched through the port's gateway is computed by
    the attached port worker and is the golden; the second fetch is a
    cache hit with no second grant; rendered queries for the three
    colormaps are the JAX package's PNG bytes of the golden; an unknown
    colormap id is refused and counted."""
    with EmbeddedCoordinator(str(tmp_path), parse_level_settings("1:12"),
                             ondemand_deadline=120.0) as co:
        golden = _golden(1, 12, 0, 0)
        result = {}
        client = DataClient("127.0.0.1", co.gateway_port, timeout=120)
        fetcher = threading.Thread(
            target=lambda: result.update(first=client.fetch(1, 0, 0)))
        fetcher.start()
        # The worker attaches once the read is waiting: the tile is
        # computed on read, not by the background sweep.
        deadline = time.monotonic() + 30
        while co.counters.get("ondemand_requests") < 1:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        stop = threading.Event()
        wt = _attach_worker(co, stop)
        try:
            fetcher.join(timeout=120)
            pixels, status = result["first"]
            assert status is FetchStatus.OK
            assert np.array_equal(pixels, golden)
            assert co.counters.get("ondemand_served") == 1
            assert co.counters.get("workloads_granted") == 1

            hits = co.counters.get("tile_cache_hits")
            again, status = client.fetch(1, 0, 0)
            assert status is FetchStatus.OK
            assert np.array_equal(again, golden)
            assert co.counters.get("tile_cache_hits") == hits + 1
            assert co.counters.get("workloads_granted") == 1

            for cid, name in proto.COLORMAPS.items():
                body, status = client.fetch_render(1, 0, 0, cid)
                assert status is FetchStatus.OK
                assert body == ref_render.render_tile_png(golden, name)
            before = co.counters.get(
                obs_names.GATEWAY_RENDER_UNKNOWN_COLORMAP)
            with pytest.raises((ConnectionError, OSError,
                                framing.ProtocolError)):
                client.fetch_render(1, 0, 0, 0x7F)
            assert co.counters.get(
                obs_names.GATEWAY_RENDER_UNKNOWN_COLORMAP) > before
            client.close()
        finally:
            stop.set()
            wt.join(timeout=30)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_command(tmp_path):
    """``serve`` as a process of its own: its gateway answers a query for
    a tile no worker computed with NOT_AVAILABLE at the on-demand
    deadline, and ``--levels`` it cannot claim exits cleanly."""
    ports = {flag: _free_port() for flag in
             ("--distributer-port", "--dataserver-port", "--gateway-port")}
    env = dict(os.environ, PYTHONPATH=str(REPO))
    args = [sys.executable, "-m", "distributedmandelbrot_tpu_torch", "serve",
            "-l", "1:12", "-o", str(tmp_path), "--host", "127.0.0.1",
            "--exporter-port", "-1", "--ondemand-deadline", "0.3",
            "--stats-period", "0", "-q"]
    for flag, port in ports.items():
        args += [flag, str(port)]
    proc = subprocess.Popen(args, cwd=tmp_path, env=env,
                            stdout=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None
            try:
                client = DataClient("127.0.0.1", ports["--gateway-port"],
                                    timeout=30)
                pixels, status = client.fetch(1, 0, 0)
                break
            except OSError:
                assert time.monotonic() < deadline
                time.sleep(0.1)
        client.close()
        assert pixels is None and status is FetchStatus.NOT_AVAILABLE
        # A second coordinator cannot claim the same level's data dir.
        with pytest.raises(SystemExit, match="serve"):
            cli.main(["serve", "-l", "1:12", "-o", str(tmp_path),
                      "--distributer-port", "0", "--dataserver-port", "0",
                      "--gateway-port", "0", "--exporter-port", "-1",
                      "-q"])
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    assert "serve: 1 level(s), 1 tiles" in out
    assert f"gateway on port {ports['--gateway-port']}" in out
