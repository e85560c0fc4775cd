"""Compute backends: how a worker turns a workload into uint8 pixels.

The contract — ``Workload -> 16,777,216 uint8 pixels in real-fastest
order`` — has three implementations here, the port of the JAX package's
``worker/backends.py``:

- :class:`NumpyBackend` — the bit-exact golden path (slow; parity anchor),
  carried as it is;
- :class:`NativeBackend` — the same golden semantics in C++ on the CPU
  (``native/``), multithreaded, carried as it is;
- :class:`TorchBackend` — the torch escape loop on one device, f32 fast
  or f64 bit-exact (the counterpart of ``JaxBackend``);
- :class:`CudaBackend` — the throughput path: the fused megakernel (K2)
  for batches, split over every device of its ring when there are
  several (the mesh route), the single-tile kernel (K1) for singletons
  and demotions, the torch loop on the same device for tiles the
  kernels decline (the counterpart of ``PallasBackend``);
- the mesh backend lives in
  :mod:`distributedmandelbrot_tpu_torch.parallel`.

:func:`auto_backend` picks the CUDA path and raises when there is no
GPU: the CPU is used only when a caller asks for it.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional, Protocol, Sequence

import numpy as np
import torch

from distributedmandelbrot_tpu_torch.core.geometry import (CHUNK_WIDTH,
                                                           TileSpec,
                                                           spec_f32_resolvable)
from distributedmandelbrot_tpu_torch.core.workload import Workload
from distributedmandelbrot_tpu_torch.obs import events as obs_events
from distributedmandelbrot_tpu_torch.obs import flight
from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.obs.metrics import Registry
from distributedmandelbrot_tpu_torch.ops import cuda_escape, escape_time
from distributedmandelbrot_tpu_torch.ops import reference as ref_ops
from distributedmandelbrot_tpu_torch.parallel.mesh import (Mesh, device_ring,
                                                           make_mesh)

logger = logging.getLogger("dmtpu.worker.backends")


class ComputeBackend(Protocol):
    def compute_batch(self, workloads: Sequence[Workload]) -> list[np.ndarray]:
        """Flat uint8 pixel arrays, one per workload, real-fastest order."""
        ...


def _spec_for(workload: Workload, definition: int) -> TileSpec:
    return TileSpec.for_chunk(workload.level, workload.index_real,
                              workload.index_imag, definition=definition)


def _resolve_device(device) -> torch.device:
    """``device`` as a torch device with an explicit index; a CUDA
    device without a GPU raises (no silent move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class NumpyBackend:
    """Golden-reference compute: float64 numpy, bit-identical semantics."""

    def __init__(self, definition: int = CHUNK_WIDTH) -> None:
        self.definition = definition

    def compute_batch(self, workloads: Sequence[Workload]) -> list[np.ndarray]:
        out = []
        for w in workloads:
            spec = _spec_for(w, self.definition)
            cr, ci = spec.grid_2d()
            counts = ref_ops.escape_counts(cr, ci, w.max_iter)
            out.append(ref_ops.scale_counts_to_uint8(counts, w.max_iter)
                       .ravel())
        return out


class NativeBackend:
    """C++ CPU compute: bit-identical to the golden, with per-pixel early
    exit and multithreading — the fast parity-anchor path (the reference's
    'CPU Calc path' equivalent, BASELINE.md config 1)."""

    def __init__(self, definition: int = CHUNK_WIDTH,
                 n_threads: int = 0, clamp: bool = False) -> None:
        from distributedmandelbrot_tpu_torch import native as native_mod
        if not native_mod.native_supported():
            raise RuntimeError(
                "native library unavailable (no g++? DMTPU_NATIVE=0?)")
        self._native = native_mod
        self.definition = definition
        self.n_threads = n_threads
        self.clamp = clamp

    def compute_batch(self, workloads: Sequence[Workload]) -> list[np.ndarray]:
        out = []
        for w in workloads:
            cr, ci = _spec_for(w, self.definition).grid_flat()
            out.append(self._native.escape_pixels(
                cr, ci, w.max_iter, clamp=self.clamp,
                n_threads=self.n_threads))
        return out


class TorchBackend:
    """The torch escape loop on one device (f32, or f64 bit-identical to
    the golden)."""

    def __init__(self, definition: int = CHUNK_WIDTH,
                 dtype=np.float32, device="cuda",
                 clamp: bool = False) -> None:
        self.definition = definition
        self.dtype = escape_time.torch_dtype(dtype)
        self.device = _resolve_device(device)
        self.clamp = clamp

    def compute_batch(self, workloads: Sequence[Workload]) -> list[np.ndarray]:
        return [escape_time.compute_tile(_spec_for(w, self.definition),
                                         w.max_iter, dtype=self.dtype,
                                         clamp=self.clamp,
                                         device=self.device)
                for w in workloads]


class TileHandle:
    """One dispatched tile on its device: the (height, width) uint8
    plane and the event its launch recorded.  :meth:`copy_to_host_async`
    starts the device-to-host copy into a pinned buffer on the backend's
    copy stream (behind the launch's event, so the copy overlaps later
    launches on the compute stream) and records its own event;
    :meth:`wait` blocks on that event and returns the flat uint8 array.
    On the CPU both are plain reads."""

    __slots__ = ("pixels", "_done", "_copy_stream", "_host", "_copied")

    def __init__(self, pixels: torch.Tensor, done=None,
                 copy_stream=None) -> None:
        self.pixels = pixels
        self._done = done
        self._copy_stream = copy_stream
        self._host = None
        self._copied = None

    def _extra_copies(self) -> list:
        """Further (device tensor, pinned buffer) pairs to move along."""
        return []

    def copy_to_host_async(self) -> None:
        if self._host is not None:
            return
        if self.pixels.device.type != "cuda":
            self._host = self.pixels
            return
        with torch.cuda.device(self.pixels.device), \
                torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(self._done)
            host = torch.empty(self.pixels.shape, dtype=torch.uint8,
                               pin_memory=True)
            host.copy_(self.pixels, non_blocking=True)
            # The plane was allocated on the compute stream; keep the
            # allocator from reusing it before this copy has read it.
            self.pixels.record_stream(self._copy_stream)
            for src, dst in self._extra_copies():
                dst.copy_(src, non_blocking=True)
                src.record_stream(self._copy_stream)
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        self._host, self._copied = host, copied

    def wait(self) -> np.ndarray:
        self.copy_to_host_async()
        if self._copied is not None:
            self._copied.synchronize()
        return self._host.numpy().reshape(-1)


class MegaTileHandle(TileHandle):
    """One tile's slice of a fused launch: its plane plus its bf16 scout
    census (a 0-d int32 device scalar), copied to the host with the
    pixels so reading it never adds a device round trip."""

    __slots__ = ("scout", "_scout_host")

    def __init__(self, pixels: torch.Tensor, scout: torch.Tensor,
                 done=None, copy_stream=None) -> None:
        super().__init__(pixels, done, copy_stream)
        self.scout = scout
        self._scout_host = None

    def _extra_copies(self) -> list:
        self._scout_host = torch.empty((), dtype=torch.int32,
                                       pin_memory=True)
        return [(self.scout, self._scout_host)]

    def census(self) -> int:
        """The census scalar; call after :meth:`wait`."""
        if self._scout_host is None:
            return int(self.scout)
        return int(self._scout_host)


class CudaBackend:
    """The GPU throughput path: K2 (fused megakernel) for batches, K1 for
    single tiles, both f32 with coordinates generated in-kernel.  The
    demotion chain is the reference's — fused -> per-tile -> the torch
    loop on the same device, in f64 where the pitch is not
    f32-resolvable — and every demotion is counted
    (:data:`~distributedmandelbrot_tpu_torch.obs.names.WORKER_KERNEL_DEMOTIONS`)
    and noted in the flight recorder.

    ``device="cpu"`` runs the kernels' plain versions (the counterpart
    of the reference's interpret mode); a CUDA device without a GPU
    raises.  The device ring (:meth:`devices`) is ``mesh``'s devices
    when given, every local GPU for the default ``device="cuda"``, else
    ``device`` alone; with more than one device a fused batch splits
    over the ring, K2 on each device's shard (the mesh route;
    ``DMTPU_MESH=0`` opts out, and a batch the route declines takes the
    one-device fused launch, counted as ``mesh_to_fused``).  The
    ``DMTPU_MXU`` gate (:mod:`~distributedmandelbrot_tpu_torch.ops.mxu_iteration`)
    resolves once per fused batch: in full mode the fused launches run
    the matrix form (K8); in census mode they keep the cached-squares
    form and an advisory bf16 shadow runs beside them.  The
    pipeline dispatches from its own threads: every launch selects its
    device and runs on that device's current stream, and device-to-host
    copies ride one copy stream per device.  The phase split (dispatch
    vs materialize) lands in
    :data:`~distributedmandelbrot_tpu_torch.obs.names.HIST_BACKEND_PHASE_SECONDS`.
    """

    def __init__(self, definition: int = CHUNK_WIDTH, clamp: bool = False,
                 device="cuda", registry: Optional[Registry] = None,
                 mesh: Optional[Mesh] = None) -> None:
        self.definition = definition
        self.clamp = clamp
        self.device = _resolve_device(device)
        if mesh is None:
            default = torch.device(device)
            mesh = make_mesh(device_ring() if default == torch.device("cuda")
                             else [self.device])
        self.mesh = mesh
        # Escape hatch for the fused route (DMTPU_MEGA=0): dispatch_many
        # then degrades to a per-tile loop without touching callers.
        self._mega_enabled = os.environ.get("DMTPU_MEGA", "1") != "0"
        # Escape hatch for the mesh route (DMTPU_MESH=0): fused batches
        # then stay on one device per launch.
        self._mesh_enabled = os.environ.get("DMTPU_MESH", "1") != "0"
        self.registry = registry if registry is not None else Registry()
        self.spans = None  # SpanRecorder once the worker binds one
        self._streams_lock = threading.Lock()
        self._copy_streams: dict = {}
        self._census_streams: dict = {}

    def bind_registry(self, registry: Registry) -> None:
        """Adopt the worker's registry (called at worker construction,
        before any compute thread exists)."""
        self.registry = registry

    def bind_spans(self, recorder) -> None:
        """Adopt the worker's span recorder (same timing contract as
        :meth:`bind_registry`)."""
        self.spans = recorder

    def devices(self) -> list:
        """Dispatch targets, in the shared mesh placement order."""
        return list(self.mesh.devices.flat)

    @property
    def mesh_width(self) -> int:
        """Devices one fused launch spans on the mesh route (1 = the
        route is off: a one-device ring, ``DMTPU_MESH=0``, or the fused
        route itself disabled).  The pipelined executor reads this to
        account dispatch permits per device, not per launch."""
        if not (self._mega_enabled and self._mesh_enabled):
            return 1
        return max(1, self.mesh.devices.size)

    def _observe_phase(self, phase: str, seconds: float) -> None:
        self.registry.observe(obs_names.HIST_BACKEND_PHASE_SECONDS,
                              seconds, labels={"phase": phase})

    def _demoted(self, workload: Workload, route: str, tiles: int) -> None:
        self.registry.inc(obs_names.WORKER_KERNEL_DEMOTIONS,
                          labels={"route": route})
        flight.note(obs_events.WKR_DEMOTE, key=workload.key, route=route,
                    tiles=tiles)

    def demotions(self, route: str) -> int:
        """Demotions counted so far along ``route``."""
        return self.registry.counter_value(
            obs_names.WORKER_KERNEL_DEMOTIONS, {"route": route}) or 0

    def _side_stream(self, streams: dict, dev: torch.device):
        with self._streams_lock:
            s = streams.get(dev)
            if s is None:
                s = streams[dev] = torch.cuda.Stream(dev)
            return s

    def _copy_stream(self, dev: torch.device):
        return self._side_stream(self._copy_streams, dev)

    def _mxu_shadow(self, specs, max_iters, dev: torch.device) -> None:
        """Census mode: the advisory bf16 matrix-form census of one fused
        batch (a ``CENSUS_PANEL**2`` sub-grid per tile, at most 64
        steps), on a side stream of ``dev`` so that it waits for no
        kernel.  A failure never fails the batch it shadows; it is
        counted in ``worker_mxu_census_failures``."""
        from distributedmandelbrot_tpu_torch.ops.mxu_iteration import (
            mxu_census_counts)
        try:
            rows = [cuda_escape._params_row(s) for s in specs]
            kw = dict(height=specs[0].height, width=specs[0].width,
                      device=dev)
            if dev.type == "cuda":
                with torch.cuda.device(dev), torch.cuda.stream(
                        self._side_stream(self._census_streams, dev)):
                    counts = mxu_census_counts(rows, max_iters, **kw)
            else:
                counts = mxu_census_counts(rows, max_iters, **kw)
        except Exception:
            logger.debug("mxu census shadow failed", exc_info=True)
            self.registry.inc(obs_names.WORKER_MXU_CENSUS_FAILURES)
            return
        self.registry.inc(obs_names.WORKER_KERNEL_MXU_CENSUS,
                          by=int(counts.sum()))

    def _mxu_account(self, mode: str, workloads, specs, max_iters,
                     dev: torch.device) -> None:
        """Count a fused batch's MXU route: a matrix-form launch (full),
        or a demotion to the census with its shadow (census)."""
        if mode == "full":
            self.registry.inc(obs_names.WORKER_KERNEL_MXU_LAUNCHES)
        elif mode == "census":
            self.registry.inc(obs_names.WORKER_KERNEL_MXU_DEMOTIONS)
            flight.note(obs_events.WKR_DEMOTE, key=workloads[0].key,
                        route="mxu_census", tiles=len(workloads))
            self._mxu_shadow(specs, max_iters, dev)

    def _launched(self, dev: torch.device):
        """(done event, copy stream) for what was just enqueued on
        ``dev``'s current stream; (None, None) on the CPU."""
        if dev.type != "cuda":
            return None, None
        with torch.cuda.device(dev):
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
        return done, self._copy_stream(dev)

    def dispatch_tile(self, workload: Workload, device=None) -> TileHandle:
        """Enqueue one tile's K1 launch on ``device``; a tile the kernel
        declines runs the torch loop on the same device instead (f32,
        or f64 when the pitch is not f32-resolvable)."""
        dev = self.device if device is None else _resolve_device(device)
        spec = _spec_for(workload, self.definition)
        t0 = time.monotonic()
        try:
            pixels = cuda_escape.compute_tile_cuda_device(
                spec, workload.max_iter, clamp=self.clamp, device=dev)
        except cuda_escape.KernelUnsupported:
            self._demoted(workload, obs_names.ROUTE_PER_TILE_TO_TORCH, 1)
            dt = (torch.float32 if spec_f32_resolvable(spec)
                  else torch.float64)
            pixels = escape_time.compute_tile_device(
                spec, workload.max_iter, dtype=dt, clamp=self.clamp,
                device=dev)
        handle = TileHandle(pixels, *self._launched(dev))
        self._observe_phase(obs_names.PHASE_DISPATCH, time.monotonic() - t0)
        return handle

    def dispatch_many(self, workloads: Sequence[Workload],
                      device=None) -> list:
        """Fuse a same-shaped batch into K2 on ``device`` (one launch
        per :data:`~...ops.cuda_escape.MEGA_MAX_TILES` tiles, of any
        batch size); returns per-tile :class:`MegaTileHandle` slices in
        workload order.  With a ring of several devices and
        ``device=None`` (the caller did not pin the launch), the batch
        splits over the ring instead, K2 on each device's shard
        (:meth:`mesh_width`).  A singleton batch, ``DMTPU_MEGA=0``, or a
        batch the fused kernel declines goes through :meth:`dispatch_tile`
        per tile (one declined tile demotes the whole batch, as in the
        reference), on ``device``: the backend's own when None, as the
        reference's fallback runs on its default device.
        The MXU gate resolves once per batch, for every device the
        batch may run on (the ring's, or ``device``)."""
        from distributedmandelbrot_tpu_torch.ops.mxu_iteration import (
            mxu_mode_for)
        if len(workloads) == 1 or not self._mega_enabled:
            return [self.dispatch_tile(w, device) for w in workloads]
        specs = [_spec_for(w, self.definition) for w in workloads]
        max_iters = [w.max_iter for w in workloads]
        dev = self.device if device is None else _resolve_device(device)
        on_mesh = device is None and self.mesh_width > 1
        mode = mxu_mode_for(self.devices() if on_mesh else [dev])
        t0 = time.monotonic()
        if on_mesh:
            handles = self._dispatch_mesh(workloads, specs,
                                          use_mxu=mode == "full")
            if handles is not None:
                self._mxu_account(mode, workloads, specs, max_iters,
                                  handles[0].pixels.device)
                self._observe_phase(obs_names.PHASE_DISPATCH,
                                    time.monotonic() - t0)
                return handles
        try:
            tiles, scout = cuda_escape.compute_tiles_mega_cuda(
                specs, max_iters, clamp=self.clamp, use_mxu=mode == "full",
                device=dev)
        except cuda_escape.KernelUnsupported:
            self._demoted(workloads[0], obs_names.ROUTE_FUSED_TO_PER_TILE,
                          len(workloads))
            return [self.dispatch_tile(w, device) for w in workloads]
        done, copy_stream = self._launched(dev)
        self.registry.inc(obs_names.WORKER_KERNEL_FUSED_LAUNCHES)
        self.registry.inc(obs_names.WORKER_KERNEL_FUSED_TILES,
                          by=len(workloads))
        self._mxu_account(mode, workloads, specs, max_iters, dev)
        self._observe_phase(obs_names.PHASE_DISPATCH, time.monotonic() - t0)
        return [MegaTileHandle(tiles[i], scout[i, 0], done, copy_stream)
                for i in range(len(workloads))]

    def _dispatch_mesh(self, workloads: Sequence[Workload], specs: list, *,
                       use_mxu: bool = False) -> Optional[list]:
        """The mesh route: K2 on each ring device's shard;
        None (counted as ``mesh_to_fused``) when the route declines."""
        from distributedmandelbrot_tpu_torch.parallel.sharding import (
            compute_tiles_mega_sharded)
        try:
            tiles, scout = compute_tiles_mega_sharded(
                specs, [w.max_iter for w in workloads], mesh=self.mesh,
                clamp=self.clamp, use_mxu=use_mxu)
        except cuda_escape.KernelUnsupported:
            self._demoted(workloads[0], obs_names.ROUTE_MESH_TO_FUSED,
                          len(workloads))
            return None
        launched: dict = {}
        for t in tiles:  # every shard is enqueued: one event per device
            if t.device not in launched:
                launched[t.device] = self._launched(t.device)
        n_dev = self.mesh.devices.size
        self.registry.inc(obs_names.WORKER_KERNEL_FUSED_LAUNCHES)
        self.registry.inc(obs_names.WORKER_KERNEL_FUSED_TILES,
                          by=len(workloads))
        self.registry.inc(obs_names.WORKER_MESH_LAUNCHES)
        self.registry.inc(obs_names.WORKER_MESH_DEVICES, by=n_dev)
        return [MegaTileHandle(t, c[0], *launched[t.device])
                for t, c in zip(tiles, scout)]

    def materialize_tile(self, handle: TileHandle) -> np.ndarray:
        """Wait for one dispatched tile's device-to-host copy -> flat
        uint8.  The census of a fused tile is read only now, from the
        pinned copy that rode with the pixels."""
        t0 = time.monotonic()
        out = handle.wait()
        if isinstance(handle, MegaTileHandle):
            pruned = handle.census()
            if pruned:
                self.registry.inc(obs_names.WORKER_KERNEL_BF16_PRUNED,
                                  by=pruned)
        self._observe_phase(obs_names.PHASE_MATERIALIZE,
                            time.monotonic() - t0)
        return out

    def compute_batch(self, workloads: Sequence[Workload]) -> list[np.ndarray]:
        # Two-phase: enqueue every tile's launch, then materialize — the
        # copy of tile k overlaps the compute of tile k+1.
        if self.spans is None:
            pending = [self.dispatch_tile(w) for w in workloads]
            for h in pending:
                h.copy_to_host_async()
            return [self.materialize_tile(h) for h in pending]
        clock = self.spans.clock
        pending = []
        for w in workloads:
            t0 = clock()
            handle = self.dispatch_tile(w)
            pending.append((w, handle, t0, clock()))
        for _, handle, _, _ in pending:
            handle.copy_to_host_async()
        out = []
        for w, handle, t_disp, t_disp_end in pending:
            self.spans.record(obs_names.SPAN_DISPATCH, w.key,
                              t_disp, t_disp_end)
            t0 = clock()
            out.append(self.materialize_tile(handle))
            t1 = clock()
            # d2h = the materialize call (device wait + copy); compute =
            # dispatch start -> materialized, so d2h nests inside it.
            self.spans.record(obs_names.SPAN_D2H, w.key, t0, t1)
            self.spans.record(obs_names.SPAN_COMPUTE, w.key, t_disp, t1)
        return out


def recompute_unresolvable_f32(workloads: Sequence[Workload],
                               out: list, definition: int, *,
                               clamp: bool = False, device="cuda") -> list:
    """Replace (by list-slot assignment, never in-place buffer writes)
    the pixels of tiles whose pitch aliases in f32 with f64 recomputes
    on ``device``.  The single copy of the recompute action shared by
    the mesh backend and the multi-process worker; the threshold itself
    is ``geometry.spec_f32_resolvable``."""
    for i, w in enumerate(workloads):
        spec = _spec_for(w, definition)
        if not spec_f32_resolvable(spec):
            out[i] = escape_time.compute_tile(spec, w.max_iter, clamp=clamp,
                                              dtype=torch.float64,
                                              device=device)
    return out


def auto_backend(definition: int = CHUNK_WIDTH, dtype=None):
    """The GPU backend: :class:`CudaBackend` (f32 kernels) by default or
    for an explicit f32, :class:`TorchBackend` on the GPU for an explicit
    f64 (bit-exact).  Raises when no CUDA device is available: the CPU
    paths are for callers that ask for them by name."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "auto_backend needs a CUDA device and none is available; use "
            "CudaBackend(device='cpu'), TorchBackend(device='cpu') or "
            "NumpyBackend explicitly to compute on the CPU")
    if dtype is not None and np.dtype(dtype) == np.dtype(np.float64):
        return TorchBackend(definition=definition, dtype=np.float64)
    return CudaBackend(definition=definition)
