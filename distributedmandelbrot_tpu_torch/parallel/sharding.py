"""Sharded escape-time compute over a device mesh: the port of the JAX
package's ``parallel/sharding.py``.

Two shardings, one per scaling axis:

- tile-batch data parallelism: a batch of k tiles (each with its own
  budget) is split contiguously over the mesh's devices, right-padded
  with trivial tiles to a multiple of the device count.
  :func:`batched_escape_pixels` runs the torch loop on each shard;
  :func:`batched_escape_pixels_cuda` runs the kernels: one K3 launch per
  shard for deep or small-grid batches, a chain of K1 launches
  otherwise, or the compacted pipeline (K6, K7) under
  ``DMTPU_COMPACT=1`` (:func:`kernel_batch_config`, the reference's
  policy).  :func:`compute_tiles_mega_sharded` runs K2 on each
  device's shard (one launch per 128 tiles).
- within-tile row sharding (:func:`compute_tile_row_sharded`): one
  tile's rows split over devices, the latency path.

Each mesh position is a shard with its own CUDA stream, ordered after
the device's current stream and joined back into it, so shards on
different cards (or two positions on one card) run side by side while
callers keep using the current stream.  Grids are generated on the
device from ``(start, step)`` scalars, ``start + index * step`` in the
working dtype, as the reference's device grid is.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import numpy as np
import torch

from distributedmandelbrot_tpu_torch.core.geometry import TileSpec
from distributedmandelbrot_tpu_torch.ops import cuda_escape as ce
from distributedmandelbrot_tpu_torch.ops import escape_time
from distributedmandelbrot_tpu_torch.ops.compact_escape import (
    compact_escape_batch, prefer_compaction)
from distributedmandelbrot_tpu_torch.ops.escape_time import INT32_SCALE_LIMIT
from distributedmandelbrot_tpu_torch.parallel.mesh import (ROW_AXIS, Mesh,
                                                           tile_mesh)

_streams_lock = threading.Lock()
_streams: dict = {}


@contextmanager
def on_shard(position: int, device: torch.device):
    """Run the body on mesh position ``position``'s own stream of
    ``device``: the stream first waits for the device's current stream,
    and the current stream waits for it afterwards.  On the CPU the
    body runs as it is."""
    dev = torch.device(device)
    if dev.type != "cuda":
        yield
        return
    with _streams_lock:
        stream = _streams.get((position, dev))
        if stream is None:
            stream = _streams[(position, dev)] = torch.cuda.Stream(dev)
    current = torch.cuda.current_stream(dev)
    stream.wait_stream(current)
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        yield
    current.wait_stream(stream)


def _shards(mesh: Mesh, k: int):
    """``(position, device, slice)`` of each shard of a k-tile batch
    (k a multiple of the device count), in mesh order."""
    devs = list(mesh.devices.flat)
    k_loc = k // len(devs)
    return [(p, dev, slice(p * k_loc, (p + 1) * k_loc))
            for p, dev in enumerate(devs)]


def widen_square_pitch(starts_steps: np.ndarray) -> np.ndarray:
    """(k, 3) square-pitch batch rows -> the kernels' (k, 4) per-axis
    pitch params layout (the step duplicated)."""
    return np.concatenate([starts_steps, starts_steps[:, 2:3]], axis=1)


def pad_to_mesh(starts_steps: np.ndarray, mrds: np.ndarray,
                n_dev: int) -> tuple[np.ndarray, np.ndarray]:
    """Right-pad a tile batch to a multiple of the mesh size with trivial
    tiles (far outside the set, budget 1 — they escape immediately)."""
    pad = (-starts_steps.shape[0]) % n_dev
    if pad:
        pad_params = np.tile(np.array([[3.0, 3.0, 0.0]]), (pad, 1))
        starts_steps = np.concatenate(
            [starts_steps, pad_params.astype(starts_steps.dtype)])
        mrds = np.concatenate([mrds, np.ones(pad, mrds.dtype)])
    return starts_steps, mrds


def _pad_mega(rows: list, mrd_rows: list, n_dev: int) -> tuple[list, list]:
    """Right-pad megakernel params/budget rows to a multiple of the mesh
    size with trivial tiles (z0 far outside the set, budget 1 — they
    escape immediately; same policy as :func:`pad_to_mesh`, in the mega
    kernel's per-axis-pitch row layout)."""
    pad = (-len(rows)) % n_dev
    if pad:
        trivial = [3.0, 3.0] + [0.0] * (len(rows[0]) - 2)
        rows = list(rows) + [list(trivial) for _ in range(pad)]
        mrd_rows = list(mrd_rows) + [[1] for _ in range(pad)]
    return rows, mrd_rows


def _device_grid(start_r: float, start_i: float, step: float, shape,
                 dtype: torch.dtype, device, row_offset: int = 0):
    """(c_real, c_imag) planes of ``shape`` from scalars: ``start +
    index * step``, each scalar rounded once to ``dtype``."""
    h, w = shape
    sr, si, st = (torch.tensor(v, dtype=dtype, device=device)
                  for v in (start_r, start_i, step))
    col = torch.arange(w, device=device).to(dtype)
    row = (torch.arange(h, device=device) + row_offset).to(dtype)
    return ((sr + col * st)[None, :].expand(h, w),
            (si + row * st)[:, None].expand(h, w))


def _loop_pixels(c_real, c_imag, mrd: int, *, cycle_check: bool,
                 clamp: bool, interior_check: bool = True) -> torch.Tensor:
    """The torch loop over one grid at budget ``mrd`` -> uint8 (the
    probe policy resolved by the caller, from the batch's cap)."""
    total = mrd - 1
    if total <= 0:
        return torch.zeros(c_real.shape, dtype=torch.uint8,
                           device=c_real.device)
    interior = (escape_time.mandelbrot_interior(c_real, c_imag)
                if interior_check else None)
    n = escape_time.escape_loop(c_real, c_imag, c_real, c_imag,
                                total_steps=total, interior=interior,
                                cycle_check=cycle_check)
    return escape_time.scale_counts_to_uint8(
        escape_time.counts_from_survival(n, total), max_iter=mrd,
        clamp=clamp)


def batched_escape_pixels(mesh: Mesh, starts_steps: np.ndarray,
                          mrds: np.ndarray, *, definition: int,
                          dtype=np.float32, clamp: bool = False,
                          cycle_check: bool | None = None,
                          interior_check: bool = True,
                          cap: int | None = None) -> np.ndarray:
    """A batch of tiles on the torch loop, sharded over ``mesh``.

    ``starts_steps``: float (k, 3) of ``(start_real, start_imag,
    step)``; ``mrds``: int (k,) per-tile budgets.  Returns uint8 ``(k,
    definition, definition)``.  Each tile runs at its own budget, which
    equals the reference's run at the batch cap followed by zeroing the
    counts past the tile's budget; the cycle probe follows the batch's
    cap (``cap`` overrides it: the multi-process batch's global one).
    The torch loop exits per pixel, so the reference's ``segment`` has
    no counterpart."""
    k = starts_steps.shape[0]
    if k == 0:
        return np.zeros((0, definition, definition), np.uint8)
    dt = escape_time.torch_dtype(dtype)
    cap = int(np.max(mrds)) if cap is None else cap
    cycle = escape_time.resolve_cycle_check(cycle_check, cap)
    starts_steps, mrds = pad_to_mesh(np.asarray(starts_steps),
                                     np.asarray(mrds), mesh.devices.size)
    outs = []
    for p, dev, sl in _shards(mesh, len(mrds)):
        with on_shard(p, dev):
            outs.append(torch.stack([
                _loop_pixels(*_device_grid(*row, (definition, definition),
                                           dt, dev), int(mrd),
                             cycle_check=cycle, clamp=clamp,
                             interior_check=interior_check)
                for row, mrd in zip(starts_steps[sl], mrds[sl])]))
    return np.concatenate([o.cpu().numpy() for o in outs])[:k]


def kernel_batch_config(definition: int, cap: int) -> dict:
    """The static dispatch policy of a kernel tile batch (the reference's
    ``pallas_batch_config``), shared by the one-process and the
    multi-process paths: the bucketed cap, the probe resolved from the
    TRUE deepest budget, whether shards take K3 (``batch_grid``), and
    whether they take the compacted pipeline (``compact``).  Raises
    :class:`~...ops.cuda_escape.KernelUnsupported` for caps that need
    int64 scaling."""
    if cap - 1 >= INT32_SCALE_LIMIT:
        raise ce.KernelUnsupported(
            "the kernel path is int32-only; cap needs the torch path")
    return {"max_iter_cap": ce.bucket_cap(cap),
            "cycle_check": escape_time.resolve_cycle_check(None, cap),
            "batch_grid": ce.prefer_batch_grid(cap, definition, definition),
            "compact": prefer_compaction(cap, definition * definition)}


def _shard_pixels(rows: np.ndarray, mrds: np.ndarray, dev, cfg: dict, *,
                  definition: int, cap: int, clamp: bool) -> torch.Tensor:
    """One shard's tiles on its device, by the batch's policy."""
    d = definition
    if cfg["compact"]:
        return compact_escape_batch(rows, mrds, k=len(rows), height=d,
                                    width=d, max_iter=cap, clamp=clamp,
                                    cycle_check=cfg["cycle_check"],
                                    device=dev)
    if cfg["batch_grid"] and len(rows) > 1:
        return ce.compute_tiles_batch_cuda(rows, mrds, height=d, width=d,
                                           clamp=clamp,
                                           cycle_check=cfg["cycle_check"],
                                           device=dev)
    return torch.stack([
        ce.compute_tile_row_cuda(row, int(mrd), d, d, clamp=clamp,
                                 cycle_check=cfg["cycle_check"], device=dev)
        for row, mrd in zip(rows, mrds)])


def batched_escape_pixels_cuda(mesh: Mesh, starts_steps: np.ndarray,
                               mrds: np.ndarray, *, definition: int,
                               clamp: bool = False,
                               cycle_check: bool | None = None,
                               cap: int | None = None) -> np.ndarray:
    """The kernels' twin of :func:`batched_escape_pixels` (f32 only;
    the reference's ``batched_escape_pixels_pallas``): the batch padded
    and split contiguously over the mesh, each shard on its device's
    own stream running K3, a K1 chain or the compacted pipeline
    (:func:`kernel_batch_config`, from the deepest budget or ``cap``).
    On CPU devices the kernels' plain versions run.

    Raises :class:`~...ops.cuda_escape.KernelUnsupported` when the cap
    needs int64 scaling; callers fall back to the torch loop
    (:meth:`~..backend.MeshBackend.compute_batch`)."""
    k = starts_steps.shape[0]
    if k == 0:
        return np.zeros((0, definition, definition), np.uint8)
    cap = int(np.max(mrds)) if cap is None else cap
    cfg = kernel_batch_config(definition, cap)
    if cycle_check is not None:
        cfg["cycle_check"] = cycle_check
        if cycle_check:
            # The compacted pipeline carries no probe.
            cfg["compact"] = False
    starts_steps, mrds = pad_to_mesh(np.asarray(starts_steps, np.float64),
                                     np.asarray(mrds), mesh.devices.size)
    rows = widen_square_pitch(starts_steps).astype(np.float32)
    outs = []
    for p, dev, sl in _shards(mesh, len(rows)):
        with on_shard(p, dev):
            outs.append(_shard_pixels(rows[sl], mrds[sl], dev, cfg,
                                      definition=definition, cap=cap,
                                      clamp=clamp))
    return np.concatenate([o.cpu().numpy() for o in outs])[:k]


def compute_tiles_mega_sharded(specs, max_iters, *, mesh: Mesh | None = None,
                               clamp: bool = False,
                               interior_check: bool = True,
                               cycle_check: bool | None = None,
                               scout_segments: int | None = None,
                               power: int = 2, burning: bool = False,
                               julia_cs=None, use_mxu: bool | None = None):
    """One fused K-tile batch split over ``mesh`` (default: every local
    GPU in :func:`~.mesh.device_ring` order), K2 on each device's
    shard (one launch per :data:`~...ops.cuda_escape.MEGA_MAX_TILES`
    tiles, any shard size), each on that position's own stream.  Returns
    ``(tiles, scout)`` in batch order with the padding stripped, as
    per-tile lists: ``tiles[i]`` the (h, w) uint8 plane and ``scout[i]``
    the (1,) int32 census of tile i, each on the device that computed
    it (so a tile is never copied between cards).  Every mode of K2:
    Mandelbrot, the degree-``power`` Multibrot, the Burning Ship, Julia
    sets (``julia_cs``, one constant per tile); ``use_mxu=None`` resolves
    the ``DMTPU_MXU`` gate over the mesh's devices (full only if every
    device proves parity).

    Every launch decision comes from one
    :func:`~...ops.cuda_escape.mega_dispatch_plan` of the whole batch,
    so the result equals the one-device K2 launch (and k K1 launches)
    bitwise, for any mesh.  Raises
    :class:`~...ops.cuda_escape.KernelUnsupported` on the plan's
    declines; callers fall back to the one-device route."""
    if mesh is None:
        mesh = tile_mesh()
    rows, mrd_rows, kw = ce.mega_dispatch_plan(
        specs, max_iters, clamp=clamp, interior_check=interior_check,
        cycle_check=cycle_check, scout_segments=scout_segments, power=power,
        burning=burning, julia_cs=julia_cs, use_mxu=use_mxu,
        device=list(mesh.devices.flat))
    k = len(rows)
    prow, pmrd = _pad_mega(rows.tolist(), mrd_rows.tolist(),
                           mesh.devices.size)
    prow = np.asarray(prow, dtype=np.float32)
    pmrd = np.asarray(pmrd, dtype=np.int32)
    tiles, scout = [], []
    for p, dev, sl in _shards(mesh, len(prow)):
        with on_shard(p, dev):
            t, c = ce.launch_mega(np.ascontiguousarray(prow[sl]),
                                  np.ascontiguousarray(pmrd[sl]), kw, dev)
        tiles.extend(t.unbind(0))
        scout.extend(c.unbind(0))
    return tiles[:k], scout[:k]


def compute_tile_row_sharded(mesh: Mesh, spec: TileSpec, max_iter: int, *,
                             dtype=np.float32, clamp: bool = False,
                             cycle_check: bool | None = None) -> np.ndarray:
    """One tile's rows split over the mesh's ``rows`` axis (the latency
    path), each shard on the torch loop on its device."""
    n_rows = mesh.shape[ROW_AXIS]
    if spec.height % n_rows:
        raise ValueError(
            f"tile height {spec.height} not divisible by {n_rows} row shards")
    if spec.width != spec.height:
        raise ValueError("row sharding currently requires square tiles")
    axis = mesh.axis_names.index(ROW_AXIS)
    devs = np.moveaxis(mesh.devices, axis, -1).reshape(-1, n_rows)[0]
    rows_per = spec.height // n_rows
    step = spec.range_real / (spec.width - 1)
    dt = escape_time.torch_dtype(dtype)
    cycle = escape_time.resolve_cycle_check(cycle_check, max_iter)
    outs = []
    for r, dev in enumerate(devs):
        with on_shard(r, dev):
            grid = _device_grid(spec.start_real, spec.start_imag, step,
                                (rows_per, spec.width), dt, dev,
                                row_offset=r * rows_per)
            outs.append(_loop_pixels(*grid, max_iter, cycle_check=cycle,
                                     clamp=clamp))
    return np.concatenate([o.cpu().numpy() for o in outs])
