"""The multi-process worker: the port of the JAX package's
``parallel/multihost.py`` on ``torch.distributed``.

The farm's control plane stays the pull model — per group, not per
process: the primary rank leases a batch sized to the group's devices
and uploads the results over TCP, and every rank computes its share on
its own cards.  The collectives (``gloo``) carry host data only, as the
reference's ``process_allgather`` and ``broadcast_one_to_all`` do: the
batch's agreement row, the leased rows and the finished bytes.  Gloo
also lets two ranks share one card, which NCCL refuses.

Typical use, the same invocation on every process:

    from distributedmandelbrot_tpu_torch.parallel import multihost
    multihost.initialize("HOST:PORT", num_processes=2, process_id=rank)
    multihost.run_spmd_worker(coordinator_host, coordinator_port)
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from distributedmandelbrot_tpu_torch.obs import events as obs_events
from distributedmandelbrot_tpu_torch.obs import flight
from distributedmandelbrot_tpu_torch.ops.escape_time import INT32_SCALE_LIMIT
from distributedmandelbrot_tpu_torch.parallel.mesh import (TILE_AXIS, Mesh,
                                                           _device_array,
                                                           local_devices,
                                                           make_mesh)

logger = logging.getLogger("dmtpu.parallel.multihost")

# The route name of the group's agreed demotion to the torch loop.
ROUTE_SPMD_TO_TORCH = "spmd_to_torch"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the process group (``gloo``; a no-op when already joined).
    ``coordinator_address`` is ``HOST:PORT`` of rank 0's rendezvous;
    with no arguments the ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``
    /``RANK`` environment decides (``env://``, as ``torchrun`` sets)."""
    if dist.is_initialized():
        return
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group("gloo", init_method=init, **kw)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that owns coordinator-facing I/O."""
    return process_index() == 0


def global_tile_mesh(devices=None) -> Mesh:
    """1-D mesh over every device of every rank, in rank order; each
    entry carries its owner's rank.  ``devices`` are this rank's
    (default: its GPUs).  A collective: every rank calls it."""
    local = [str(torch.device(d))
             for d in (local_devices() if devices is None else devices)]
    per_rank = [None] * process_count()
    if dist.is_initialized():
        dist.all_gather_object(per_rank, local)
    else:
        per_rank = [local]
    flat = [d for names in per_rank for d in names]
    owners = np.asarray([r for r, names in enumerate(per_rank)
                         for _ in names])
    return Mesh(_device_array(flat), (TILE_AXIS,), process_ids=owners)


def _allgather(arr: np.ndarray) -> np.ndarray:
    """Every rank's ``arr`` (same shape and dtype everywhere), stacked
    in rank order."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if not dist.is_initialized():
        return t.numpy()[None]
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def _broadcast(arr: np.ndarray) -> np.ndarray:
    """Rank 0's ``arr`` on every rank."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dist.is_initialized():
        dist.broadcast(t, src=0)
    return t.numpy()


def batched_escape_pixels_multihost(mesh: Mesh,
                                    starts_steps_local: np.ndarray,
                                    mrds_local: np.ndarray, *,
                                    definition: int,
                                    dtype=np.float32,
                                    clamp: bool = False,
                                    kernel: str = "auto") -> np.ndarray:
    """A tile batch over a multi-process mesh.

    Every rank calls this with its own tiles (the global batch is their
    concatenation in rank order) and gets back its local results as
    uint8 ``(k_local, definition, definition)``, computed on its own
    devices of ``mesh``.  The local tile count must be the same on every
    rank and a multiple of the rank's device count.

    One allgather of ``[k_local, cap_local, ok_local, kernel_local]``
    comes before any branch that may raise, so a bad batch on one rank
    raises on every rank instead of stranding the others in a later
    collective; the policy (kernel or torch loop, probe, batch grid,
    compaction) follows the agreed global cap, so every rank takes the
    same branch.  ``kernel``: ``auto`` takes the kernels when every rank
    can (CUDA devices, f32, an int32 cap), ``cuda`` requires them (their
    plain versions on CPU devices), ``torch`` takes the loop."""
    from distributedmandelbrot_tpu_torch.parallel.sharding import (
        batched_escape_pixels, batched_escape_pixels_cuda)

    if kernel not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown kernel {kernel!r}")
    local = make_mesh(mesh.local_devices(process_index()))
    k_local = starts_steps_local.shape[0]
    n_local = local.devices.size
    cap_local = int(np.max(mrds_local)) if k_local else 0
    ok_local = int(n_local > 0 and k_local > 0 and k_local % n_local == 0)
    kernel_local = int(kernel != "torch"
                       and np.dtype(dtype) == np.float32
                       and (kernel == "cuda" or all(
                           d.type == "cuda" for d in local.devices.flat)))
    gathered = _allgather(np.asarray(
        [k_local, cap_local, ok_local, kernel_local], np.int64))
    ks = gathered[:, 0]
    cap = int(gathered[:, 1].max())
    if (ks != k_local).any() or not gathered[:, 2].all():
        raise ValueError(
            f"every process must contribute the same non-zero multiple of "
            f"its local device count; local batches were {ks.tolist()}, "
            f"alignment flags {gathered[:, 2].tolist()}")
    use_kernel = bool(gathered[:, 3].all()) and cap - 1 < INT32_SCALE_LIMIT
    if kernel == "cuda" and not use_kernel:
        raise ValueError("kernel='cuda' requested but not every rank can "
                         "run it (devices/dtype/cap)")
    if kernel == "auto" and not use_kernel and np.dtype(dtype) == np.float32:
        logger.info("multihost batch on the torch loop (agreed by every "
                    "rank: kernel flags %s, cap %d)",
                    gathered[:, 3].tolist(), cap)
        flight.note(obs_events.WKR_DEMOTE, route=ROUTE_SPMD_TO_TORCH,
                    tiles=k_local)
    if use_kernel:
        return batched_escape_pixels_cuda(
            local, np.asarray(starts_steps_local, np.float64),
            np.asarray(mrds_local), definition=definition, clamp=clamp,
            cap=cap)
    return batched_escape_pixels(local, np.asarray(starts_steps_local),
                                 np.asarray(mrds_local),
                                 definition=definition, dtype=dtype,
                                 clamp=clamp, cap=cap)


def run_spmd_worker(host: str, port: int, *, definition: int | None = None,
                    batch_per_device: int = 1, poll: float = 0.0,
                    dtype=np.float32, clamp: bool = False,
                    mesh: Optional[Mesh] = None,
                    kernel: str = "auto") -> int:
    """The multi-process farm worker: one group-spanning pull loop.

    Run the same invocation on every rank (after :func:`initialize`).
    The primary leases a batch of ``devices x batch_per_device`` tiles
    and uploads the results over TCP; every rank computes its share
    through :func:`batched_escape_pixels_multihost`.

    Every rank runs the same collectives in the same order: the leased
    rows are broadcast from the primary each round, padded to the fixed
    global batch (pad rows compute a level-1 tile at budget 1), and "no
    more work", like a failed lease or upload on the primary (an abort
    sentinel), rides the same broadcast, so every rank stops or raises
    together.  The results are allgathered and the primary alone
    uploads.  Returns the number of non-empty rounds (the same on every
    rank)."""
    from distributedmandelbrot_tpu_torch.core.geometry import (
        CHUNK_WIDTH, MIN_AXIS, level_chunk_range)
    from distributedmandelbrot_tpu_torch.core.workload import Workload

    if definition is None:
        definition = CHUNK_WIDTH
    if mesh is None:
        mesh = global_tile_mesh()
    primary = is_primary()
    n_proc = process_count()
    k_global = mesh.devices.size * batch_per_device
    k_local = k_global // n_proc
    if k_global % n_proc:
        raise ValueError(f"global batch {k_global} must divide evenly "
                         f"across {n_proc} processes")
    client = None
    if primary:
        from distributedmandelbrot_tpu_torch.worker.client import (
            DistributerClient)
        client = DistributerClient(host, port)

    rounds = 0
    pending_err: Optional[BaseException] = None
    while True:
        rows = np.zeros((k_global, 5), np.int64)  # level, mrd, i, j, real
        if primary:
            # A lease failure must not kill the primary before the
            # broadcast (the others would wait in it forever): it rides
            # the broadcast as a sentinel and every rank raises.
            if pending_err is None:
                try:
                    grants = client.request_batch(k_global)
                    for r, w in enumerate(grants):
                        rows[r] = (w.level, w.max_iter, w.index_real,
                                   w.index_imag, 1)
                except Exception as e:
                    pending_err = e
            if pending_err is not None:
                rows[:, 4] = -1  # abort sentinel
        rows = _broadcast(rows)
        if (rows[:, 4] < 0).any():
            if primary:
                raise RuntimeError(
                    "multihost worker aborting: coordinator I/O failed "
                    "on the primary") from pending_err
            raise RuntimeError(
                "multihost worker aborting: the primary reported a "
                "coordinator I/O failure")
        n_real = int(rows[:, 4].sum())
        if n_real == 0:
            if poll <= 0:
                return rounds
            time.sleep(poll)  # every rank saw the same empty broadcast
            continue
        rounds += 1
        params = np.empty((k_global, 3))
        for r in range(k_global):
            level, mrd, i, j, real = rows[r]
            if not real:  # trivial pad: level-1 tile at budget 1
                level, mrd, i, j = 1, 1, 0, 0
            rng = level_chunk_range(int(level))
            params[r] = (MIN_AXIS + rng * int(i), MIN_AXIS + rng * int(j),
                         rng / (definition - 1))
        lo = process_index() * k_local
        out_local = batched_escape_pixels_multihost(
            mesh, params[lo:lo + k_local],
            np.maximum(rows[lo:lo + k_local, 1], 1),
            definition=definition, dtype=dtype, clamp=clamp, kernel=kernel)
        gathered = _allgather(out_local)
        if primary:
            full = gathered.reshape(k_global, definition, definition)
            wls = [Workload(int(rows[r, 0]), int(rows[r, 1]),
                            int(rows[r, 2]), int(rows[r, 3]))
                   for r in range(k_global) if rows[r, 4]]
            pix = [full[r].ravel() for r in range(k_global) if rows[r, 4]]
            if np.dtype(dtype) == np.float32:
                # Sub-f32-resolution tiles would upload banded; the
                # primary recomputes those few in f64 (no collective, so
                # the ranks stay in lockstep).
                from distributedmandelbrot_tpu_torch.worker.backends import (
                    recompute_unresolvable_f32)
                recompute_unresolvable_f32(
                    wls, pix, definition, clamp=clamp,
                    device=mesh.local_devices(process_index())[0])
            try:
                client.submit_batch(list(zip(wls, pix)))
            except Exception as e:
                pending_err = e  # abort sentinel on the next broadcast
