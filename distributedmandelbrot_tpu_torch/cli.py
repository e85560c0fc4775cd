"""Command-line entry points of the port: the farm (``coordinator``,
``serve``, ``worker``, ``viewer``), the sharded control plane and its
operations tools (``coord``, ``top``, ``stats``, ``trace``, ``admin``,
``compact``, ``postmortem``, ``loadgen``, ``chaos``) and local rendering
(``render``, ``animate``).

    python -m distributedmandelbrot_tpu_torch coordinator -l 4:256,10:1024
    python -m distributedmandelbrot_tpu_torch worker --host H --port P
    python -m distributedmandelbrot_tpu_torch viewer 4 1 2 --out tile.png
    python -m distributedmandelbrot_tpu_torch serve -l 2:256
    python -m distributedmandelbrot_tpu_torch coord --shard 0/2 -l 4:256
    python -m distributedmandelbrot_tpu_torch worker --ring ring.json
    python -m distributedmandelbrot_tpu_torch top --ring ring.json --once
    python -m distributedmandelbrot_tpu_torch render --out view.png
    python -m distributedmandelbrot_tpu_torch animate --center=-0.75,0.1 \
        --out-dir frames

``coordinator``, ``serve`` and ``viewer`` take the flags of the JAX
package's subcommands of the same names and run its carried modules
(the store, scheduler, distributer, data server, gateway, sessions and
exporter), so either package's worker and viewer talk to either
package's coordinator, and either package's store reads the other's
data directory.  ``viewer --out`` writes the PNG ``plt.imsave`` would;
without ``--out`` it shows the view, which needs matplotlib and a
display.  ``coord``, ``top``, ``stats``, ``trace``, ``admin``,
``compact``, ``postmortem``, ``loadgen`` and ``chaos`` are the JAX
package's, with its flags, over the carried ``control/``, ``obs/``,
``loadgen/`` and ``chaos/`` modules; all of them run on the host
(``chaos`` and ``top --smoke`` start numpy workers).

``worker`` takes the flags of ``dmtpu worker`` of the JAX package, with
``--backend`` choosing among the port's backends (auto, cuda, torch,
numpy, native, mesh) and ``--device``/``--dtype`` beside it.
``--backend mesh`` computes each lease batch sharded over every local
GPU, ``--kernel auto|cuda|torch`` picking its compute (the reference's
``auto|pallas|xla``); ``--multihost`` runs the group-spanning worker
over ``torch.distributed`` ranks (``--mh-coordinator``,
``--mh-processes``, ``--mh-process-id``).  ``--device cpu`` runs either
on the CPU (the kernels' plain versions).  ``--ring`` drains every
shard of a sharded control plane, ``--exporter-port`` serves the
worker's own ``/varz``, and ``--profile DIR`` writes a
``torch.profiler`` Chrome trace of the run (CPU, and the CUDA kernels
on a CUDA backend).

``render`` is ``dmtpu render``: Mandelbrot, Julia, Multibrot and
Burning Ship views, integer or smooth, supersampled or not, on the CUDA
kernels (``--device cuda``, the default) or their plain versions
(``--device cpu``).  ``--no-kernel`` (``--no-pallas`` there) takes the
torch loops on the host-linspace grid for the direct route.  Mandelbrot
and Julia views below a span of 1e-12, f32 views too fine for f32
coordinates, and ``--deep`` render by perturbation
(``ops/perturbation.py``: the delta scans K9 and K10 on the card),
with the bilinear approximation (``--bla``, ``--no-bla``; by default
a probe decides).  ``animate`` is ``dmtpu animate``: a geometric span
sweep whose frames each render as ``render`` would, deep once the span
needs it; ``--gif`` needs PIL.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import logging
import os
import sys
import threading
import time
from decimal import Decimal
from typing import Optional, Sequence

import numpy as np

from distributedmandelbrot_tpu_torch.net import protocol as proto

logger = logging.getLogger("dmtpu.cli")

_NP_DTYPES = {"f32": np.float32, "f64": np.float64}


def _configure_logging(args: argparse.Namespace) -> None:
    level = logging.ERROR if args.quiet else (
        logging.DEBUG if args.verbose else logging.INFO)
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s")
    if getattr(args, "no_info_log", False):
        logging.getLogger("dmtpu").setLevel(logging.ERROR)


def _configure_channel_logging(args: argparse.Namespace) -> None:
    """Per-server info/error log enables (``-dli/-dle/-sli/-sle`` of the
    original coordinator): disabling info leaves errors; disabling
    errors silences the channel entirely."""
    for chan, info, err in (
            ("dmtpu.distributer", args.distributer_log_info,
             args.distributer_log_error),
            ("dmtpu.dataserver", args.data_server_log_info,
             args.data_server_log_error)):
        log = logging.getLogger(chan)
        if err == "false":
            log.setLevel(logging.CRITICAL + 1)
        elif info == "false":
            log.setLevel(logging.ERROR)


def _add_common(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="debug logging")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="errors only")


def _mesh_for(device: str):
    """The worker's mesh: every local GPU for the default ``cuda`` (None
    here, so the backend builds it and raises without a GPU), else the
    one named device."""
    from distributedmandelbrot_tpu_torch.parallel.mesh import make_mesh
    return None if device == "cuda" else make_mesh([device])


def _make_backend(name: str, dtype: str | None, device: str,
                  kernel: str = "auto"):
    from distributedmandelbrot_tpu_torch import worker as wk
    if name == "numpy":
        return wk.NumpyBackend()
    if name == "native":
        return wk.NativeBackend()
    if name == "torch":
        return wk.TorchBackend(dtype=_NP_DTYPES[dtype or "f32"],
                               device=device)
    if name == "cuda":
        if dtype not in (None, "f32"):
            raise SystemExit("--backend cuda is f32-only (the kernel "
                             "path); use --backend torch for f64")
        return wk.CudaBackend(device=device)
    if name == "auto":
        return wk.auto_backend(
            dtype=None if dtype is None else _NP_DTYPES[dtype])
    if name == "mesh":
        from distributedmandelbrot_tpu_torch.parallel import MeshBackend
        return MeshBackend(dtype=_NP_DTYPES[dtype or "f32"], kernel=kernel,
                           mesh=_mesh_for(device))
    raise ValueError(f"unknown backend {name!r}")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distributedmandelbrot_tpu_torch worker",
        description="Run a stateless pull-loop compute worker on a GPU.")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int,
                   default=proto.DEFAULT_DISTRIBUTER_PORT)
    p.add_argument("--backend",
                   choices=["auto", "cuda", "torch", "numpy", "native",
                            "mesh"],
                   default="auto",
                   help="auto = the CUDA kernels (raises without a GPU); "
                        "native = the C++ CPU loop (bit-exact, g++ builds "
                        "it on first use); mesh = each batch sharded over "
                        "every local GPU")
    p.add_argument("--device", default="cuda",
                   help="torch device of the cuda/torch/mesh backends and "
                        "--multihost (default cuda: every local GPU for "
                        "mesh; 'cpu' runs the plain versions)")
    p.add_argument("--dtype", choices=["f32", "f64"], default=None,
                   help="pin output precision (f32 kernels / f64 "
                        "bit-exact torch loop)")
    p.add_argument("--batch-size", type=int, default=0,
                   help="tiles leased per exchange (default: the device "
                        "count for mesh, else 1)")
    p.add_argument("--poll", type=float, default=0.0,
                   help="keep polling every N seconds after the "
                        "coordinator drains (default: exit)")
    p.add_argument("--window", type=int, default=-1,
                   help="pipelined executor: max tiles leased-but-"
                        "unsubmitted; 0 = classic two-stage overlap "
                        "(default: 2*depth per device for backends with "
                        "per-tile dispatch handles, else 0)")
    p.add_argument("--depth", type=int, default=2,
                   help="pipelined executor: kernels in flight per device")
    p.add_argument("--upload-lanes", type=int, default=0,
                   help="parallel upload threads (default 0 = one per "
                        "device, capped at 4)")
    p.add_argument("--batch-tiles", type=int, default=0,
                   help="queued leases fused into one megakernel launch "
                        "(capped at --depth; 0 = fuse up to depth)")
    p.add_argument("--grant-batch", type=int, default=0,
                   help="batched lease grants per session round trip "
                        "(0 = fill the whole --window)")
    p.add_argument("--no-session", action="store_true",
                   help="force the legacy connection-per-exchange wire "
                        "protocol")
    p.add_argument("--reconnect", type=int, default=0, metavar="N",
                   help="redial the coordinator up to N times per "
                        "exchange on connection failure (0 = fail fast)")
    p.add_argument("--stats-json", metavar="PATH", default="",
                   help="on a drained exit, dump the counter snapshot and "
                        "pipeline stage stats to PATH as JSON")
    p.add_argument("--exporter-port", type=int, default=-1,
                   help="HTTP metrics port for this worker (/varz, "
                        "/timeseries); 0 = ephemeral, -1 (default) "
                        "disables")
    p.add_argument("--ring", metavar="RING_JSON", default=None,
                   help="multi-home against a sharded control plane: one "
                        "session per shard from this ring config, leases "
                        "round-robined across shards, uploads routed by "
                        "key (overrides --host/--port; implies the "
                        "pipelined executor)")
    p.add_argument("--profile", metavar="DIR", default="",
                   help="capture a torch.profiler trace of the run (CPU, "
                        "and CUDA on a CUDA backend) into DIR as Chrome "
                        "trace JSON (view with Perfetto)")
    p.add_argument("--kernel", choices=["auto", "cuda", "torch"],
                   default="auto",
                   help="compute of the mesh backend and --multihost: "
                        "auto = the CUDA kernels on CUDA devices in f32, "
                        "the torch loop otherwise")
    p.add_argument("--multihost", action="store_true",
                   help="group-spanning worker: run the SAME invocation on "
                        "every process; the primary leases and uploads over "
                        "TCP, every process computes on its devices")
    p.add_argument("--mh-coordinator", default=None, metavar="HOST:PORT",
                   help="torch.distributed rendezvous address (default: "
                        "the MASTER_ADDR/MASTER_PORT environment)")
    p.add_argument("--mh-processes", type=int, default=None)
    p.add_argument("--mh-process-id", type=int, default=None)
    _add_common(p)
    return p


@contextlib.contextmanager
def _profiled(out_dir: str, devices):
    """``--profile DIR``: a ``torch.profiler`` trace of the block, CPU
    activity and, when any of ``devices`` is a CUDA device, the CUDA
    kernels too, written to ``DIR/worker-<pid>.trace.json`` (Chrome
    trace JSON) however the block ends.  An empty ``out_dir`` profiles
    nothing; a CUDA device without a GPU raises."""
    if not out_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if any(torch.device(d).type == "cuda" for d in devices):
        if not torch.cuda.is_available():
            raise SystemExit("--profile: a CUDA backend without a CUDA "
                             "device")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"worker-{os.getpid()}.trace.json")
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
        print(f"profile trace written to {path}", flush=True)


def _cmd_multihost(args: argparse.Namespace) -> int:
    """``worker --multihost``: every process computes on its devices
    (all local GPUs, or ``--device``) and the primary talks to the
    coordinator."""
    if args.backend != "auto":
        raise SystemExit("--multihost ignores --backend (it always "
                         "computes on the group's mesh); use --kernel to "
                         "pick the device compute")
    from distributedmandelbrot_tpu_torch.parallel import multihost
    from distributedmandelbrot_tpu_torch.parallel.mesh import local_devices
    # Resolved before joining the group: no GPU raises here, not after
    # the other ranks have started waiting.
    devices = local_devices() if args.device == "cuda" else [args.device]
    multihost.initialize(coordinator_address=args.mh_coordinator,
                         num_processes=args.mh_processes,
                         process_id=args.mh_process_id)
    mesh = multihost.global_tile_mesh(devices)
    n_dev = mesh.devices.size
    per_dev = max(1, -(-args.batch_size // n_dev)) \
        if args.batch_size > 0 else 1
    if args.batch_size > 0 and per_dev * n_dev != args.batch_size:
        logger.warning(
            "--batch-size %d rounded to %d (the SPMD batch must be a "
            "multiple of the %d global devices)", args.batch_size,
            per_dev * n_dev, n_dev)
    with _profiled(args.profile, devices):
        rounds = multihost.run_spmd_worker(
            args.host, args.port, batch_per_device=per_dev,
            poll=args.poll, dtype=_NP_DTYPES[args.dtype or "f32"],
            mesh=mesh, kernel=args.kernel)
    if multihost.is_primary():
        print(f"multihost worker: drained after {rounds} round(s) "
              f"({multihost.process_count()} processes, {n_dev} devices)",
              flush=True)
    return 0


def _worker_exporter(worker, port: int):
    """The worker's own metrics exporter (``--exporter-port``)."""
    from distributedmandelbrot_tpu_torch.obs.exporter import ExporterThread
    from distributedmandelbrot_tpu_torch.obs.timeseries import \
        TimeseriesSampler
    exporter = ExporterThread(
        worker.counters.registry,
        sampler=TimeseriesSampler(worker.counters.registry),
        varz_extra=lambda: {
            "role": "worker",
            "worker_id": format(worker.spans.worker_id, "016x")},
        port=port)
    exporter.start()
    print(f"worker exporter on port {exporter.port}", flush=True)
    return exporter


def cmd_worker(argv: Sequence[str]) -> int:
    args = _parser().parse_args(argv)
    _configure_logging(args)
    if args.multihost:
        return _cmd_multihost(args)
    from distributedmandelbrot_tpu_torch.worker import (DistributerClient,
                                                        Worker)
    backend = _make_backend(args.backend, args.dtype, args.device,
                            args.kernel)
    batch_size = args.batch_size
    if batch_size <= 0:
        batch_size = (len(backend.devices()) if args.backend == "mesh"
                      else 1)
    ring = None
    host, port = args.host, args.port
    if args.ring is not None:
        from distributedmandelbrot_tpu_torch.control.ring import (
            HashRing, RingConfigError)
        try:
            ring = HashRing.load(args.ring)
        except RingConfigError as e:
            raise SystemExit(f"worker: {e}")
        if args.no_session:
            raise SystemExit("worker: --ring needs sessions (drop "
                             "--no-session)")
        # The classic client is the declined-hello fallback: shard 0.
        host = ring.shards[0].host
        port = ring.shards[0].distributer_port
    window = args.window
    if window < 0:
        window = (2 * args.depth * max(1, len(backend.devices()))
                  if hasattr(backend, "dispatch_tile") else 0)
    if ring is not None and window == 0:
        # Multi-homing lives in the pipelined session path.
        window = max(2, 2 * args.depth)
    worker = Worker(DistributerClient(host, port,
                                      reconnect_attempts=args.reconnect),
                    backend, batch_size=batch_size,
                    window=window, depth=args.depth,
                    upload_lanes=args.upload_lanes,
                    batch_tiles=args.batch_tiles,
                    grant_batch=args.grant_batch,
                    use_session=not args.no_session, ring=ring)
    exporter = (_worker_exporter(worker, args.exporter_port)
                if args.exporter_port >= 0 else None)
    # The host loops (numpy, native) have no devices(): the CPU.
    devices = (backend.devices() if hasattr(backend, "devices")
               else [getattr(backend, "device", "cpu")])
    try:
        with _profiled(args.profile, devices):
            if args.poll > 0:
                worker.run_forever(poll_interval=args.poll)
                return 0
            rounds = worker.run_until_drained()
    except KeyboardInterrupt:
        return 0
    except OSError as e:
        print(f"error: cannot reach coordinator at {host}:{port} "
              f"({e})", file=sys.stderr)
        return 1
    finally:
        if exporter is not None:
            exporter.stop()
    stats = worker.counters.snapshot()
    print(f"worker: drained after {rounds} round(s); "
          f"{stats.get('tiles_computed', 0)} tiles computed, "
          f"{stats.get('results_accepted', 0)} accepted", flush=True)
    payload = {"counters": stats, "rounds": rounds}
    if worker.pipeline is not None:
        ss = worker.pipeline.stage_stats()
        payload["stage_stats"] = ss
        occ = "  ".join(f"{name}={s['occupancy']:.0%}"
                        for name, s in ss["stages"].items())
        print(f"pipeline stage occupancy: {occ} "
              f"(window={worker.window}, depth={worker.depth})", flush=True)
        fus = ss.get("fusion", {})
        if fus.get("launches"):
            print(f"dispatch fusion: {fus['tiles']} tiles in "
                  f"{fus['launches']} launch(es), "
                  f"{fus['tiles_per_launch']:.1f} tiles/launch", flush=True)
    if args.stats_json:
        with open(args.stats_json, "w", encoding="utf-8") as fh:
            json.dump(payload, fh)
    return 0


# --- render ---------------------------------------------------------------

# Below this span, float64 pixel coordinates alias and the reference
# renders through perturbation.
DEEP_SPAN_THRESHOLD = 1e-12


# Mean-zero subpixel offsets (in pixel-pitch units): the sample cloud
# stays centered on the nominal pixel position, so supersampling never
# shifts the image, only averages across the pixel's footprint.
_SS_OFFSETS = {2: ((-0.25, -0.25), (0.25, 0.25)),
               4: ((-0.25, -0.25), (0.25, -0.25),
                   (-0.25, 0.25), (0.25, 0.25))}

_declines_lock = threading.Lock()
_declines: dict[str, int] = {}


def kernel_declines() -> dict[str, int]:
    """Kernel declines (``KernelUnsupported``) the render path has
    routed to the torch loops so far in this process, by wrapper."""
    with _declines_lock:
        return dict(_declines)


def reset_kernel_declines() -> None:
    with _declines_lock:
        _declines.clear()


def _kernel_first(kernel: str, /, *args, **kwargs):
    """Run the named ``ops.cuda_escape`` wrapper: its kernel on a CUDA
    device, its plain version on the CPU.  Returns None, logged and
    counted, only when the wrapper declines with ``KernelUnsupported``
    (the caller then takes the torch loop); anything else raises."""
    from distributedmandelbrot_tpu_torch.ops import cuda_escape
    try:
        return getattr(cuda_escape, kernel)(*args, **kwargs)
    except cuda_escape.KernelUnsupported as e:
        logger.info("kernel path declined %s: %s", kernel, e)
        with _declines_lock:
            _declines[kernel] = _declines.get(kernel, 0) + 1
        return None


def _span_f32_resolvable(cx: float, cy: float, span: float,
                         definition: int) -> bool:
    """One view -> one resolvability verdict: the single copy of the
    center/span -> TileSpec convention."""
    from distributedmandelbrot_tpu_torch.core.geometry import (
        TileSpec, spec_f32_resolvable)
    return spec_f32_resolvable(TileSpec(cx - span / 2, cy - span / 2,
                                        span, span, width=definition,
                                        height=definition))


def _view_f32_resolvable(args: argparse.Namespace,
                         center: tuple[float, float]) -> bool:
    """Whether the request's finest view resolves in f32: the smallest
    of ``span`` and an animation's two ends (a zoom out starts at the
    small span)."""
    span = min(getattr(args, "span", 4.0),
               getattr(args, "span_start", 4.0),
               getattr(args, "span_end", 4.0))
    return _span_f32_resolvable(center[0], center[1], span,
                                getattr(args, "definition", 1024))


def _resolve_dtype(args: argparse.Namespace,
                   center: tuple[float, float] | None = None,
                   can_perturb: bool = False):
    """The reference's ``--dtype`` default: f64 for ``--smooth`` (the
    quality path), f32 otherwise; an explicit ``--dtype`` wins.  A view
    that renders deep (``--deep``, a sub-threshold span) stays f32.  An
    f32 view too fine for f32 coordinates goes to f64 for ``--smooth``
    and for the families (which have no perturbation route); Mandelbrot
    and Julia stay f32, which the reference renders by perturbation.
    An animation whose sweep crosses the threshold at either end stays
    f32 on every frame: a sweep does not change dtype mid-animation."""
    if args.dtype is not None:
        return _NP_DTYPES[args.dtype]
    if (getattr(args, "deep", False)
            or getattr(args, "span", 1.0) < DEEP_SPAN_THRESHOLD
            or getattr(args, "span_start", 1.0) < DEEP_SPAN_THRESHOLD
            or getattr(args, "span_end", 1.0) < DEEP_SPAN_THRESHOLD):
        return np.float32
    if center is not None and not _view_f32_resolvable(args, center):
        if getattr(args, "smooth", False) or not can_perturb:
            return np.float64
        return np.float32
    return np.float64 if getattr(args, "smooth", False) else np.float32


def _join_negative_values(argv: Sequence[str], flags: Sequence[str]) -> list:
    """Merge ``--flag -0.8,0.156`` into ``--flag=-0.8,0.156`` so argparse
    doesn't mistake the negative value for an option."""
    out, it = [], iter(list(argv))
    for tok in it:
        if tok in flags:
            val = next(it, None)
            if val is None:
                out.append(tok)
            else:
                out.append(f"{tok}={val}")
        else:
            out.append(tok)
    return out


def _resolve_bla(args: argparse.Namespace) -> bool | None:
    """--bla / --no-bla -> the perturbation layer's tri-state: force on,
    force off, or (neither) the per-orbit auto-probe
    (ops.perturbation._auto_bla)."""
    if getattr(args, "bla", False):
        return True
    if getattr(args, "no_bla", False):
        return False
    return None


def _warn_if_deep_all_inset(plane, max_iter: int, span: float) -> None:
    """A deep view where EVERY pixel classifies in-set (value 0) is
    almost always an under-budgeted render, not a discovery: escape
    depths grow with zoom, so say so instead of writing a flat image
    with no hint.  (Shallow interior views are legitimately all-in-set,
    hence deep-path only.)"""
    if not np.any(np.asarray(plane)):
        logger.warning(
            "deep view at span %g: no pixel escaped within max_iter=%d — "
            "the output is a uniform in-set tile.  Deep zooms need "
            "budgets that grow with depth; retry with a larger "
            "--max-iter.", span, max_iter)


def _auto_deep(span: float, cx: float, cy: float, definition: int,
               np_dtype) -> bool:
    """Whether the reference renders a Mandelbrot/Julia view by
    perturbation: below the f64 threshold, or at f32 with a pixel pitch
    the direct path cannot resolve."""
    return span < DEEP_SPAN_THRESHOLD or (
        np_dtype == np.float32
        and not _span_f32_resolvable(cx, cy, span, definition))


def _resolve_deep(deep: bool | None, span: float, cx: float, cy: float,
                  definition: int, np_dtype,
                  family: tuple[int, bool] | None) -> bool:
    """The one direct-vs-perturbation decision: families have no
    perturbation route, an explicit ``deep`` wins, None auto-selects."""
    if family is not None:
        return False
    if deep is None:
        return _auto_deep(span, cx, cy, definition, np_dtype)
    return bool(deep)


def _resolve_family(fractal: str, power: int | None
                    ) -> tuple[int, bool] | None:
    """(power, burning) for the extended families, None for the core
    fractals, with ``--power`` placement validation."""
    if fractal == "ship":
        if power is not None:
            raise SystemExit("--power applies to multibrot only "
                             "(the burning ship is degree 2)")
        return (2, True)
    if fractal == "multibrot":
        p = 3 if power is None else power
        if p < 2:
            raise SystemExit("--power must be >= 2")
        return (p, False)
    if power is not None:
        raise SystemExit("--power applies to --fractal multibrot only")
    return None


def _render_supersampled(c_re: str, c_im: str, span: float, definition: int,
                         max_iter: int, *, supersample: int,
                         render_kwargs: dict) -> np.ndarray:
    """Anti-aliased render: ``supersample`` subpixel samples per output
    pixel, averaged in color space (each sample colormapped first, so
    the in-set black blends correctly at the set's boundary).

    Integer f32 direct views compute all samples in one K5 launch
    (``compute_tiles_packed_cuda``), each plane equal to K1 on its
    sample; every other route (smooth, deep, ``--no-kernel``, a declined
    pack) renders the samples one by one — the same output, linear
    cost."""
    from distributedmandelbrot_tpu_torch.core.geometry import TileSpec
    from distributedmandelbrot_tpu_torch.viewer import value_to_rgba

    offsets = _SS_OFFSETS[supersample]
    pitch = span / (definition - 1)

    kw = render_kwargs
    if (not kw.get("smooth") and not kw.get("no_kernel")
            and kw.get("np_dtype") == np.float32):
        cx, cy = float(c_re), float(c_im)
        if not _resolve_deep(kw.get("deep"), span, cx, cy, definition,
                             np.float32, kw.get("family")):
            power, burning = kw.get("family") or (2, False)
            jc_pair = kw.get("julia_c")
            jc = (complex(float(jc_pair[0]), float(jc_pair[1]))
                  if jc_pair is not None else None)
            specs = [TileSpec(cx - span / 2 + dx * pitch,
                              cy - span / 2 + dy * pitch, span, span,
                              width=definition, height=definition)
                     for dx, dy in offsets]
            planes = _kernel_first(
                "compute_tiles_packed_cuda", specs,
                [max_iter] * supersample, power=power, burning=burning,
                julia_cs=[jc] * supersample if jc is not None else None,
                device=kw["device"])
            if planes is not None:
                acc = None
                for plane in planes.cpu().numpy():
                    rgba = value_to_rgba(plane, colormap=kw["colormap"])
                    acc = rgba if acc is None else acc + rgba
                return acc / supersample

    acc = None
    for dx, dy in offsets:
        # Decimal shift keeps the center strings at full precision.
        sre = str(Decimal(c_re) + Decimal(repr(dx * pitch)))
        sim = str(Decimal(c_im) + Decimal(repr(dy * pitch)))
        rgba = _render_view(sre, sim, span, definition, max_iter, **kw)
        acc = rgba if acc is None else acc + rgba
    return acc / supersample


def _render_view(c_re: str, c_im: str, span: float, definition: int,
                 max_iter: int, *, smooth: bool, np_dtype, colormap: str,
                 device, deep: bool | None = None,
                 julia_c: tuple[str, str] | None = None,
                 family: tuple[int, bool] | None = None,
                 no_kernel: bool = False, normalize: bool = False,
                 supersample: int = 1, bla: bool | None = None
                 ) -> np.ndarray:
    """One view -> float RGBA (Mandelbrot, or Julia when ``julia_c`` is
    set, or a Multibrot/Burning-Ship view when ``family=(power,
    burning)``), on ``device``.

    f32 views go through the kernels first (K1 integer, K4 smooth); a
    view a kernel declines, an f64 view, or ``no_kernel`` takes the
    torch loops on the host-linspace grid (the kernels generate theirs
    as ``start + index * step`` in f32, up to one ulp away, so the two
    can differ on chaotic boundary pixels).  A Mandelbrot or Julia view
    that :func:`_resolve_deep` routes to perturbation renders through
    ``ops/perturbation.py`` (center strings at full precision; ``bla``
    the BLA tri-state), its scans on ``device``."""
    from distributedmandelbrot_tpu_torch.core.geometry import TileSpec
    from distributedmandelbrot_tpu_torch.ops import escape_time, families
    from distributedmandelbrot_tpu_torch.viewer import (smooth_to_rgba,
                                                        value_to_rgba)

    if supersample > 1:
        return _render_supersampled(
            c_re, c_im, span, definition, max_iter, supersample=supersample,
            render_kwargs=dict(smooth=smooth, np_dtype=np_dtype,
                               colormap=colormap, device=device, deep=deep,
                               julia_c=julia_c, family=family,
                               no_kernel=no_kernel, normalize=normalize,
                               bla=bla))

    kernel_first = (lambda *a, **k: None) if no_kernel else _kernel_first
    on_kernel = np_dtype == np.float32
    cx, cy = float(c_re), float(c_im)
    spec = TileSpec(cx - span / 2, cy - span / 2, span, span,
                    width=definition, height=definition)

    if family is not None:
        power, burning = family
        if smooth:
            nu = kernel_first("compute_tile_smooth_cuda", spec, max_iter,
                              power=power, burning=burning,
                              device=device) if on_kernel else None
            nu = (families.compute_tile_smooth_family(
                spec, max_iter, power=power, burning=burning,
                dtype=np_dtype, device=device)
                if nu is None else nu.cpu().numpy())
            return smooth_to_rgba(nu, max_iter, colormap=colormap,
                                  normalize=normalize)
        values = kernel_first("compute_tile_family_cuda", spec, max_iter,
                              power=power, burning=burning,
                              device=device) if on_kernel else None
        if values is None:
            values = families.compute_tile_family(
                spec, max_iter, power=power, burning=burning,
                dtype=np_dtype, device=device)
        return value_to_rgba(values.reshape(spec.height, spec.width),
                             colormap=colormap)

    if _resolve_deep(deep, span, cx, cy, definition, np_dtype, family):
        import torch

        from distributedmandelbrot_tpu_torch.ops import perturbation
        # Center strings pass through verbatim: their precision is not
        # bounded by float64.
        dspec = perturbation.DeepTileSpec(c_re, c_im, span, width=definition,
                                          height=definition)
        if smooth:
            nu, _ = perturbation.compute_smooth_perturb(
                dspec, max_iter, dtype=np_dtype, julia_c=julia_c, bla=bla,
                device=device)
            _warn_if_deep_all_inset(nu, max_iter, span)
            return smooth_to_rgba(nu, max_iter, colormap=colormap,
                                  normalize=normalize)
        counts, _ = perturbation.compute_counts_perturb(
            dspec, max_iter, dtype=np_dtype, julia_c=julia_c, bla=bla,
            device=device)
        # Warn on the raw counts: the uint8 encoding wraps the top band
        # of the budget to 0.
        _warn_if_deep_all_inset(counts, max_iter, span)
        values = escape_time.scale_counts_to_uint8(
            torch.from_numpy(counts), max_iter=max_iter).numpy()
        return value_to_rgba(values, colormap=colormap)
    jc = (complex(float(julia_c[0]), float(julia_c[1]))
          if julia_c is not None else None)
    if smooth:
        nu = kernel_first("compute_tile_smooth_cuda", spec, max_iter,
                          julia_c=jc, device=device) if on_kernel else None
        nu = (escape_time.compute_tile_smooth(spec, max_iter, dtype=np_dtype,
                                              julia_c=jc, device=device)
              if nu is None else nu.cpu().numpy())
        return smooth_to_rgba(nu, max_iter, colormap=colormap,
                              normalize=normalize)
    values = None
    if on_kernel:
        values = (kernel_first("compute_tile_cuda", spec, max_iter,
                               device=device) if jc is None else
                  kernel_first("compute_tile_julia_cuda", spec, jc,
                               max_iter, device=device))
    if values is None:
        values = (escape_time.compute_tile(spec, max_iter, dtype=np_dtype,
                                           device=device) if jc is None else
                  escape_time.compute_tile_julia(spec, jc, max_iter,
                                                 dtype=np_dtype,
                                                 device=device))
    return value_to_rgba(values.reshape(spec.height, spec.width),
                         colormap=colormap)


def _save_png(path: str, rgba) -> None:
    """Write float RGBA as an RGBA8 PNG with the bytes ``plt.imsave``
    would store (no matplotlib needed)."""
    from distributedmandelbrot_tpu_torch.serve.render import (encode_png,
                                                              imsave_bytes)
    data = encode_png(imsave_bytes(rgba))
    with open(path, "wb") as fh:
        fh.write(data)
    print(f"wrote {path} ({rgba.shape[1]}x{rgba.shape[0]})")


def _render_device(name: str):
    import torch
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("render --device cuda needs a CUDA device and "
                         "none is available; --device cpu runs the "
                         "kernels' plain versions")
    return dev


def cmd_render(argv: Sequence[str]) -> int:
    """Local (farm-less) rendering of any view on the GPU."""
    from distributedmandelbrot_tpu_torch.serve.render import COLORMAPS
    parser = argparse.ArgumentParser(
        prog="python -m distributedmandelbrot_tpu_torch render",
        description="Render a view locally on the CUDA kernels.")
    parser.add_argument("--fractal",
                        choices=["mandelbrot", "julia", "multibrot", "ship"],
                        default="mandelbrot")
    parser.add_argument("--power", type=int, default=None,
                        help="multibrot degree d in z^d + c (>= 2; "
                             "default 3; multibrot only)")
    parser.add_argument("--c", default="-0.8,0.156",
                        help="Julia constant as RE,IM")
    parser.add_argument("--center", default=None,
                        help="view center (default: -0.5,0 for mandelbrot, "
                             "0,0 for julia)")
    parser.add_argument("--span", type=float, default=3.0,
                        help="view side length in the complex plane")
    parser.add_argument("--definition", type=int, default=1024,
                        help="output pixels per side")
    parser.add_argument("--max-iter", type=int, default=256)
    parser.add_argument("--smooth", action="store_true",
                        help="band-free continuous coloring (defaults to "
                             "the f64 quality path, the torch loop; "
                             "--dtype f32 selects the smooth kernel)")
    parser.add_argument("--deep", action="store_true",
                        help="perturbation deep zoom: center taken at "
                             "arbitrary decimal precision, valid at any "
                             "span (auto-selected below 1e-12)")
    parser.add_argument("--bla", action="store_true",
                        help="force the bilinear-approximation fast path "
                             "for deep renders, integer or --smooth "
                             "(ops/bla.py): skips orbit segments where "
                             "the delta recurrence is effectively linear. "
                             "Approximate by contract: escapes inside a "
                             "skipped segment are detected at its end.  "
                             "Default (neither flag): a probe enables BLA "
                             "where it wins")
    parser.add_argument("--no-bla", action="store_true",
                        help="force the exact delta scan (disable the "
                             "BLA auto-probe)")
    parser.add_argument("--dtype", choices=["f32", "f64"], default=None,
                        help="arithmetic width; default: f64 for --smooth, "
                             "f32 otherwise.  f32 runs the kernels")
    parser.add_argument("--colormap", default="jet",
                        help=f"one of {sorted(COLORMAPS)}")
    parser.add_argument("--normalize", action="store_true",
                        help="stretch the view's own escaped-value range "
                             "over the full colormap (--smooth only)")
    parser.add_argument("--supersample", type=int, choices=[2, 4], default=1,
                        help="anti-aliasing: N subpixel samples per pixel, "
                             "averaged in color space; integer f32 views "
                             "compute all samples in one packed kernel "
                             "launch")
    parser.add_argument("--no-kernel", action="store_true",
                        help="take the torch loops on the host-linspace "
                             "grid instead of the kernels, whose f32 grid "
                             "(start + i*step) can differ from it at the "
                             "last ulp; reproduces host-grid renders "
                             "(direct views; deep views always scan on "
                             "their delta kernels)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "kernels' plain versions)")
    parser.add_argument("--out", required=True, help="output PNG path")
    _add_common(parser)
    args = parser.parse_args(_join_negative_values(argv, ("--c", "--center")))
    _configure_logging(args)

    _check_colormap(args.colormap)
    family = _resolve_family(args.fractal, args.power)
    if args.normalize and not args.smooth:
        raise SystemExit("--normalize applies to --smooth renders only "
                         "(integer output is already quantized upstream)")
    if family is not None:
        if args.deep:
            raise SystemExit(f"--fractal {args.fractal} has no perturbation "
                             "path (no --deep)")
        if args.span < DEEP_SPAN_THRESHOLD:
            raise SystemExit(f"--fractal {args.fractal} has no perturbation "
                             f"path; spans below {DEEP_SPAN_THRESHOLD} alias "
                             "float64 pixel coordinates")
    default_center = "0,0" if args.fractal == "julia" else "-0.5,0.0"
    c_re, c_im = (s.strip() for s in (args.center
                                      or default_center).split(","))
    julia_c = tuple(s.strip() for s in args.c.split(",")) \
        if args.fractal == "julia" else None
    np_dtype = _resolve_dtype(args, center=(float(c_re), float(c_im)),
                              can_perturb=family is None)
    deep = _resolve_deep(True if args.deep else None, args.span,
                         float(c_re), float(c_im), args.definition,
                         np_dtype, family)
    if args.bla and args.no_bla:
        raise SystemExit("--bla and --no-bla are mutually exclusive")
    if args.bla and not deep:
        raise SystemExit("--bla applies to perturbation deep renders "
                         "(--deep, or a view the auto-selector routes "
                         "to perturbation); this view renders on the "
                         "direct kernels, which have no orbit to skip")
    rgba = _render_view(c_re, c_im, args.span, args.definition,
                        args.max_iter, smooth=args.smooth, np_dtype=np_dtype,
                        colormap=args.colormap,
                        device=_render_device(args.device), deep=deep,
                        julia_c=julia_c, family=family,
                        no_kernel=args.no_kernel, normalize=args.normalize,
                        supersample=args.supersample, bla=_resolve_bla(args))
    _save_png(args.out, rgba)
    return 0


def _check_colormap(colormap: str) -> None:
    from distributedmandelbrot_tpu_torch.serve.render import COLORMAPS
    if colormap not in COLORMAPS:
        raise SystemExit(f"colormap {colormap!r} is not carried by the "
                         f"port; it carries {sorted(COLORMAPS)}")


def cmd_animate(argv: Sequence[str]) -> int:
    """Zoom animation: a geometric span sweep rendered frame by frame,
    each frame as ``render`` renders it (K1 or K4 direct, K5 with
    ``--supersample``, K9 or K10 once the span needs perturbation)."""
    parser = argparse.ArgumentParser(
        prog="python -m distributedmandelbrot_tpu_torch animate",
        description="Render a zoom animation as numbered PNG frames.")
    parser.add_argument("--center", required=True,
                        help="zoom target as RE,IM (decimal strings; "
                             "precision beyond float64 is honored on "
                             "deep frames)")
    parser.add_argument("--fractal",
                        choices=["mandelbrot", "julia", "multibrot", "ship"],
                        default="mandelbrot")
    parser.add_argument("--power", type=int, default=None,
                        help="multibrot degree d in z^d + c (>= 2; "
                             "default 3; multibrot only)")
    parser.add_argument("--c", default="-0.8,0.156",
                        help="Julia constant as RE,IM")
    parser.add_argument("--span-start", type=float, default=4.0)
    parser.add_argument("--span-end", type=float, default=1e-6)
    parser.add_argument("--frames", type=int, default=60)
    parser.add_argument("--definition", type=int, default=512)
    parser.add_argument("--max-iter", type=int, default=1000)
    parser.add_argument("--max-iter-end", type=int, default=None,
                        help="budget for the last frame; per-frame "
                             "budgets interpolate geometrically from "
                             "--max-iter, as the spans do")
    parser.add_argument("--smooth", action="store_true",
                        help="band-free coloring on every frame")
    parser.add_argument("--dtype", choices=["f32", "f64"], default=None,
                        help="arithmetic width; default: f64 for --smooth, "
                             "f32 otherwise, and f32 for a sweep that "
                             "renders deep")
    parser.add_argument("--colormap", default="jet")
    parser.add_argument("--supersample", type=int, choices=[2, 4], default=1,
                        help="anti-aliasing per frame (see render "
                             "--supersample)")
    parser.add_argument("--bla", action="store_true",
                        help="force the BLA fast path for the deep frames "
                             "(see render --bla); default: per-orbit "
                             "auto-probe")
    parser.add_argument("--no-bla", action="store_true",
                        help="force the exact delta scan (disable the "
                             "BLA auto-probe)")
    parser.add_argument("--no-kernel", action="store_true",
                        help="direct frames take the torch loops on the "
                             "host-linspace grid instead of the kernels "
                             "(see render --no-kernel)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "kernels' plain versions)")
    parser.add_argument("--out-dir", required=True,
                        help="directory for frame_NNNN.png files")
    parser.add_argument("--gif", metavar="PATH", default=None,
                        help="also assemble the frames into an animated "
                             "GIF at PATH (needs PIL)")
    parser.add_argument("--frame-ms", type=int, default=80,
                        help="GIF frame duration in milliseconds")
    _add_common(parser)
    args = parser.parse_args(
        _join_negative_values(argv, ("--center", "--c")))
    _configure_logging(args)
    if args.frames < 1:
        raise SystemExit("--frames must be >= 1")
    if args.span_end <= 0 or args.span_start <= 0:
        raise SystemExit("spans must be positive")
    if args.bla and args.no_bla:
        raise SystemExit("--bla and --no-bla are mutually exclusive")
    _check_colormap(args.colormap)

    family = _resolve_family(args.fractal, args.power)
    if family is not None and min(args.span_start,
                                  args.span_end) < DEEP_SPAN_THRESHOLD:
        # min of both ends: a zoom out starts at the small span.
        raise SystemExit(f"--fractal {args.fractal} has no perturbation "
                         f"path; spans below {DEEP_SPAN_THRESHOLD} "
                         "would alias float64 pixel coordinates")
    device = _render_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    c_re, c_im = (s.strip() for s in args.center.split(","))
    julia_c = tuple(s.strip() for s in args.c.split(",")) \
        if args.fractal == "julia" else None
    np_dtype = _resolve_dtype(args, center=(float(c_re), float(c_im)),
                              can_perturb=family is None)
    ratio = (args.span_end / args.span_start) ** (
        1.0 / max(1, args.frames - 1))
    if args.max_iter < 1:
        raise SystemExit("--max-iter must be >= 1")
    if args.max_iter_end is not None and args.max_iter_end < 1:
        raise SystemExit("--max-iter-end must be >= 1")
    mi_ratio = ((args.max_iter_end / args.max_iter) ** (
        1.0 / max(1, args.frames - 1))
        if args.max_iter_end is not None else 1.0)

    t0 = time.monotonic()
    for f in range(args.frames):
        span = args.span_start * ratio ** f
        max_iter = max(1, round(args.max_iter * mi_ratio ** f))
        # Decided once and passed down, so the label names the route
        # the frame took.
        deep = _resolve_deep(None, span, float(c_re), float(c_im),
                             args.definition, np_dtype, family)
        rgba = _render_view(c_re, c_im, span, args.definition, max_iter,
                            smooth=args.smooth, np_dtype=np_dtype,
                            colormap=args.colormap, device=device,
                            deep=deep, julia_c=julia_c, family=family,
                            no_kernel=args.no_kernel,
                            supersample=args.supersample,
                            bla=_resolve_bla(args))
        path = os.path.join(args.out_dir, f"frame_{f:04d}.png")
        _save_png(path, rgba)
        print(f"frame {f + 1}/{args.frames} span {span:.3g} "
              f"mi {max_iter}{' (deep)' if deep else ''} -> {path}",
              flush=True)
    dt = time.monotonic() - t0
    pixels = args.frames * args.definition * args.definition
    print(f"animation done: {args.frames} frames in {dt:.1f}s, "
          f"{pixels / dt / 1e6:.2f} Mpix/s end-to-end", flush=True)
    if args.gif:
        from PIL import Image

        def frame(f):
            return Image.open(
                os.path.join(args.out_dir, f"frame_{f:04d}.png")).convert(
                    "P", palette=Image.Palette.ADAPTIVE)

        # The tail frames stream through a generator: a deep zoom runs
        # to hundreds of frames.
        frame(0).save(args.gif, save_all=True,
                      append_images=(frame(f) for f in
                                     range(1, args.frames)),
                      duration=args.frame_ms, loop=0)
        print(f"wrote {args.gif} ({args.frames} frames @ "
              f"{args.frame_ms}ms)", flush=True)
    return 0


# --- the farm: coordinator, serve, viewer -------------------------------

def _add_coordinator_flags(parser: argparse.ArgumentParser) -> None:
    """The flags ``coordinator`` and ``serve`` share."""
    parser.add_argument("-l", "--levels", required=True,
                        help="level:max_iter[,level:max_iter...] "
                             "(e.g. 4:256,10:1024,20:1024)")
    parser.add_argument("-o", "--data-dir", default="",
                        help="parent directory for Data/ (default: cwd)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--distributer-port", type=int,
                        default=proto.DEFAULT_DISTRIBUTER_PORT)
    parser.add_argument("--dataserver-port", type=int,
                        default=proto.DEFAULT_DATASERVER_PORT)
    parser.add_argument("--lease-timeout", type=float,
                        default=proto.DEFAULT_LEASE_TIMEOUT,
                        help="seconds a worker has to return a tile")
    parser.add_argument("--sweep-period", type=float,
                        default=proto.DEFAULT_SWEEP_PERIOD,
                        help="seconds between expired-lease sweeps")
    parser.add_argument("--fsync-index", action="store_true",
                        help="fsync the tile index on every append")
    parser.add_argument("--read-timeout", type=float,
                        default=proto.DEFAULT_READ_TIMEOUT,
                        help="per-read socket deadline in seconds")
    parser.add_argument("--no-read-timeout", action="store_true",
                        help="disable socket read deadlines")
    parser.add_argument("--checkpoint-period", type=float, default=0.0,
                        help="write a durability checkpoint every N seconds "
                             "(0 disables; restart then replays the full "
                             "index instead of a suffix)")
    parser.add_argument("--stats-period", type=float, default=60.0,
                        help="seconds between progress/throughput log "
                             "lines (0 disables)")
    parser.add_argument("--exporter-port", type=int,
                        default=proto.DEFAULT_EXPORTER_PORT,
                        help="HTTP metrics port (/metrics, /varz, "
                             "/healthz); 0 = ephemeral, -1 disables")
    parser.add_argument("--no-info-log", action="store_true")
    _add_common(parser)


def _run_coordinator(prog: str, args: argparse.Namespace, suffix: str = "",
                     **kwargs) -> int:
    """Start the carried ``Coordinator`` with the shared flags (and the
    gateway's, as ``kwargs``) and serve until interrupted."""
    from distributedmandelbrot_tpu_torch.coordinator import Coordinator
    from distributedmandelbrot_tpu_torch.core.workload import \
        parse_level_settings
    from distributedmandelbrot_tpu_torch.storage.ownership import \
        LevelOwnedError
    from distributedmandelbrot_tpu_torch.storage.store import DataDirError

    settings = parse_level_settings(args.levels)
    try:
        coordinator = Coordinator(
            settings, data_dir_parent=args.data_dir, host=args.host,
            distributer_port=args.distributer_port,
            dataserver_port=args.dataserver_port,
            lease_timeout=args.lease_timeout, sweep_period=args.sweep_period,
            read_timeout=None if args.no_read_timeout else args.read_timeout,
            fsync_index=args.fsync_index, stats_period=args.stats_period,
            checkpoint_period=args.checkpoint_period,
            exporter_port=(None if args.exporter_port < 0
                           else args.exporter_port), **kwargs)
    except (DataDirError, LevelOwnedError) as e:
        # A clean pre-start failure: no traceback, exit code 1.
        raise SystemExit(f"{prog}: {e}")
    total = coordinator.scheduler.total_tiles
    done = coordinator.scheduler.completed_count
    print(f"{prog}: {len(settings)} level(s), {total} tiles ({done} "
          f"already complete on disk){suffix}", flush=True)
    try:
        asyncio.run(coordinator.run_forever())
    except KeyboardInterrupt:
        pass
    return 0


def cmd_coordinator(argv: Sequence[str]) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distributedmandelbrot_tpu_torch coordinator",
        description="Run the tile coordinator (Distributer + DataServer).")
    _add_coordinator_flags(parser)
    for flag in ("--distributer-log-info", "--distributer-log-error",
                 "--data-server-log-info", "--data-server-log-error"):
        parser.add_argument(flag, choices=["true", "false"], default="true")
    args = parser.parse_args(argv)
    _configure_logging(args)
    _configure_channel_logging(args)
    return _run_coordinator("coordinator", args)


def cmd_serve(argv: Sequence[str]) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distributedmandelbrot_tpu_torch serve",
        description="Run a serving coordinator: Distributer + DataServer + "
                    "tile gateway (cache, coalescing, compute-on-read, "
                    "admission control).")
    _add_coordinator_flags(parser)
    parser.add_argument("--gateway-port", type=int,
                        default=proto.DEFAULT_GATEWAY_PORT)
    parser.add_argument("--cache-tiles", type=int, default=256,
                        help="decoded-tile LRU capacity, in tiles")
    parser.add_argument("--render-cache-tiles", type=int, default=64,
                        help="rendered palette-PNG LRU capacity, in "
                             "entries (one per tile+colormap)")
    parser.add_argument("--max-queue-depth", type=int, default=1024,
                        help="max queries in service before shedding "
                             "with OVERLOADED")
    parser.add_argument("--rate", type=float, default=None,
                        help="token-bucket refill rate in queries/s "
                             "(default: unlimited)")
    parser.add_argument("--burst", type=float, default=256.0,
                        help="token-bucket capacity (burst size)")
    parser.add_argument("--ondemand-deadline", type=float,
                        default=proto.DEFAULT_ONDEMAND_DEADLINE,
                        help="seconds a miss may wait for the farm to "
                             "compute the tile before NOT_AVAILABLE")
    parser.add_argument("--sample-period", type=float, default=2.0,
                        help="seconds between /timeseries snapshots of "
                             "the registry")
    parser.add_argument("--history-window", type=float, default=600.0,
                        help="seconds of timeseries history kept in the "
                             "ring buffer")
    args = parser.parse_args(argv)
    _configure_logging(args)
    return _run_coordinator(
        "serve", args, f"; gateway on port {args.gateway_port}",
        sample_period=args.sample_period,
        history_window=args.history_window,
        gateway_port=args.gateway_port,
        gateway_cache_tiles=args.cache_tiles,
        gateway_render_tiles=args.render_cache_tiles,
        gateway_max_queue_depth=args.max_queue_depth,
        gateway_rate=args.rate, gateway_burst=args.burst,
        ondemand_deadline=args.ondemand_deadline)


def cmd_viewer(argv: Sequence[str]) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distributedmandelbrot_tpu_torch viewer",
        description="Fetch and render finished tiles.")
    parser.add_argument("level", type=int, nargs="?", default=None)
    parser.add_argument("index_real", type=int, nargs="?", default=None)
    parser.add_argument("index_imag", type=int, nargs="?", default=None)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int,
                        default=proto.DEFAULT_DATASERVER_PORT)
    parser.add_argument("--stitch", action="store_true",
                        help="fetch ALL chunks of the level into one image")
    parser.add_argument("--out", default=None,
                        help="write a PNG instead of opening a window")
    parser.add_argument("--colormap", default="jet")
    _add_common(parser)
    args = parser.parse_args(argv)
    _configure_logging(args)
    _check_colormap(args.colormap)

    if args.level is None and args.stitch:
        parser.error("--stitch requires a level")
    if args.level is None:
        # No arguments: the original viewer's interactive session, with
        # its prompts.  Closed stdin or a non-numeric answer exits with
        # a usage error, not a traceback.
        try:
            args.host = input("Server Addr> ") or args.host
            port_s = input("Server Port> ")
            args.port = int(port_s) if port_s else args.port
            args.level = int(input("Level> "))
            args.index_real = int(input("Index Re> "))
            args.index_imag = int(input("Index Im> "))
        except EOFError:
            parser.error("no arguments and no interactive input; "
                         "pass LEVEL [INDEX_RE INDEX_IM] (see --help)")
        except ValueError as e:
            parser.error(f"invalid numeric answer: {e}")

    from distributedmandelbrot_tpu_torch.viewer import DataClient

    client = DataClient(args.host, args.port)
    try:
        return _viewer_fetch_and_render(parser, args, client)
    except OSError as e:
        print(f"error: cannot reach data server at {args.host}:{args.port} "
              f"({e})", file=sys.stderr)
        return 1


def _viewer_fetch_and_render(parser, args, client) -> int:
    from distributedmandelbrot_tpu_torch.viewer import (FetchStatus,
                                                        stitch_level,
                                                        value_to_rgba)

    if args.stitch:
        missing = []

        def fetch(i: int, j: int) -> Optional[np.ndarray]:
            pixels, status = client.fetch(args.level, i, j)
            if status is not FetchStatus.OK:
                missing.append((i, j))
                return None
            return pixels

        values = stitch_level(fetch, args.level)
        if missing:
            print(f"warning: {len(missing)} chunk(s) unavailable, "
                  f"rendered black: {missing[:8]}...", file=sys.stderr)
    else:
        if args.index_real is None or args.index_imag is None:
            parser.error("index_real and index_imag required unless --stitch")
        pixels, status = client.fetch(args.level, args.index_real,
                                      args.index_imag)
        if status is FetchStatus.NOT_AVAILABLE:
            print("Chunk isn't available")
            return 1
        if status is FetchStatus.REJECTED:
            print("Request was rejected (invalid indices)", file=sys.stderr)
            return 2
        values = pixels

    rgba = value_to_rgba(values, colormap=args.colormap)
    if args.out:
        _save_png(args.out, rgba)
    else:  # pragma: no cover - needs a display
        from distributedmandelbrot_tpu_torch.viewer import show
        show(rgba)
    return 0


# --- operations: the sharded control plane and its tools ------------

def cmd_compact(argv: Sequence[str]) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distributedmandelbrot_tpu_torch compact",
        description="Offline maintenance: rewrite the append-only tile "
                    "index with one (last-wins) entry per tile and delete "
                    "chunk files nothing references.  Claims every level "
                    "in the index, so it fails loudly if a coordinator is "
                    "running on the same data directory.")
    parser.add_argument("-o", "--data-dir", default="",
                        help="parent directory of Data/ (default: cwd)")
    parser.add_argument("--keep-orphans", action="store_true",
                        help="only rewrite the index; leave unreferenced "
                             "chunk files in place")
    _add_common(parser)
    args = parser.parse_args(argv)
    _configure_logging(args)

    from distributedmandelbrot_tpu_torch.storage.index import CorruptIndexError
    from distributedmandelbrot_tpu_torch.storage.ownership import \
        LevelOwnedError
    from distributedmandelbrot_tpu_torch.storage.store import (DataDirError,
                                                               compact)

    try:
        stats = compact(args.data_dir,
                        remove_orphans=not args.keep_orphans)
    except (DataDirError, LevelOwnedError, CorruptIndexError,
            RuntimeError) as e:
        raise SystemExit(f"compact: {e}")
    print(f"compacted: {stats['entries_before']} -> "
          f"{stats['entries_after']} entries, "
          f"{stats['orphans_removed']} orphan file(s) removed, "
          f"index now {stats['index_bytes']} bytes", flush=True)
    return 0


def _fetch_varz(host: str, port: int, timeout: float) -> dict:
    import urllib.request
    url = f"http://{host}:{port}/varz"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def _print_varz(varz: dict) -> None:
    sched = varz.get("scheduler")
    if sched:
        print(f"progress: {sched.get('completed', 0)}/{sched.get('total', 0)}"
              f" tiles complete, {sched.get('outstanding_leases', 0)} leased,"
              f" frontier depth {sched.get('frontier_depth', 0)}")
    gauges = varz.get("gauges", {})
    if gauges:
        print("gauges:")
        for name in sorted(gauges):
            print(f"  {name:<40} {gauges[name]:.4g}")
    counters = varz.get("counters", {})
    if counters:
        print("counters:")
        for name in sorted(counters):
            print(f"  {name:<40} {counters[name]}")
    hists = varz.get("histograms", {})
    if hists:
        print(f"histograms:{'':<36} count      p50      p90      p99")
        for name in sorted(hists):
            h = hists[name]
            print(f"  {name:<40} {h.get('count', 0):>5}"
                  f" {h.get('p50', 0.0):>8.4f} {h.get('p90', 0.0):>8.4f}"
                  f" {h.get('p99', 0.0):>8.4f}")
    trace = varz.get("trace")
    if trace:
        skew = (trace.get("worker_skew") or {}).get("skew")
        print(f"trace: {trace.get('recorded', 0)} events "
              f"({trace.get('dropped', 0)} dropped), "
              f"{trace.get('complete_spans', 0)}/{trace.get('spans', 0)} "
              f"complete spans, worker skew "
              + (f"{skew:.2f}" if skew is not None else "n/a"))
        workers = (trace.get("worker_skew") or {}).get("workers") or {}
        for wid in sorted(workers):
            w = workers[wid]
            print(f"  {wid:<40} {w.get('tiles', 0)} tiles, "
                  f"{w.get('busy_s', 0.0):.3f}s busy "
                  f"({w.get('busy_source', 'lease')})")
    farm = varz.get("farm_trace")
    if farm and farm.get("tiles"):
        print(f"critical path ({farm['tiles']} tiles, "
              f"{farm.get('attributed_tiles', 0)} span-attributed):")
        for phase in ("queue", "compute", "d2h", "upload", "persist",
                      "other"):
            secs = farm.get(f"{phase}_s", 0.0)
            share = farm.get(f"{phase}_share", 0.0)
            print(f"  {phase:<10} {secs:>10.3f}s  {share * 100:5.1f}%")


def cmd_stats(argv: Sequence[str]) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distributedmandelbrot_tpu_torch stats",
        description="Fetch and pretty-print a running coordinator's /varz "
                    "(counters, gauges, histogram percentiles, trace "
                    "summary) from its metrics exporter.")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int,
                        default=proto.DEFAULT_EXPORTER_PORT)
    parser.add_argument("--timeout", type=float, default=5.0,
                        help="HTTP fetch timeout in seconds")
    parser.add_argument("--watch", type=float, default=0.0, metavar="SECS",
                        help="refresh every SECS seconds until interrupted")
    parser.add_argument("--json", action="store_true",
                        help="dump raw /varz JSON instead of pretty text")
    args = parser.parse_args(argv)

    while True:
        try:
            varz = _fetch_varz(args.host, args.port, args.timeout)
        except OSError as e:
            raise SystemExit(
                f"stats: cannot fetch http://{args.host}:{args.port}"
                f"/varz: {e}")
        if args.json:
            print(json.dumps(varz, indent=1, sort_keys=True), flush=True)
        else:
            _print_varz(varz)
        if args.watch <= 0:
            return 0
        print(flush=True)
        try:
            time.sleep(args.watch)
        except KeyboardInterrupt:
            return 0


def cmd_trace(argv: Sequence[str]) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distributedmandelbrot_tpu_torch trace",
        description="Dump a running coordinator's merged farm timeline "
                    "(coordinator lifecycle + clock-aligned worker spans) "
                    "as Chrome trace-event JSON from the metrics "
                    "exporter's /trace.json.  Load the file at "
                    "https://ui.perfetto.dev or chrome://tracing.")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int,
                        default=proto.DEFAULT_EXPORTER_PORT)
    parser.add_argument("--timeout", type=float, default=5.0,
                        help="HTTP fetch timeout in seconds")
    parser.add_argument("--out", default="-", metavar="PATH",
                        help="output path ('-' for stdout)")
    args = parser.parse_args(argv)

    import urllib.request
    url = f"http://{args.host}:{args.port}/trace.json"
    try:
        with urllib.request.urlopen(url, timeout=args.timeout) as resp:
            trace = json.loads(resp.read().decode("utf-8"))
    except (OSError, ValueError) as e:
        raise SystemExit(f"trace: cannot fetch {url}: {e}")
    body = json.dumps(trace, indent=1)
    if args.out == "-":
        print(body, flush=True)
    else:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(body + "\n")
        n = len(trace.get("traceEvents", []))
        print(f"wrote {n} trace events -> {args.out} "
              f"(load at https://ui.perfetto.dev)", flush=True)
    return 0


def cmd_postmortem(argv: Sequence[str]) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distributedmandelbrot_tpu_torch postmortem",
        description="Merge a directory of flight-recorder dumps (one "
                    "JSONL per process; DMTPU_FLIGHT_DIR made them) "
                    "into one causally-ordered cross-process timeline, "
                    "reconstruct the leases in flight when each process "
                    "died, and run the anomaly detectors (grant without "
                    "accept, lease ping-pong, redirect loops, double "
                    "commits, retry storms).  Corrupt dumps never abort "
                    "the assembly; bad lines are counted and a partial "
                    "timeline renders.")
    parser.add_argument("dump_dir", metavar="DIR",
                        help="directory of flight-*.jsonl dumps")
    fmt = parser.add_mutually_exclusive_group()
    fmt.add_argument("--json", action="store_true",
                     help="full timeline + anomalies as JSON")
    fmt.add_argument("--chrome", action="store_true",
                     help="Chrome trace-event JSON (ui.perfetto.dev)")
    parser.add_argument("--limit", type=int, default=200, metavar="N",
                        help="text mode: show the last N merged events "
                             "(default 200; 0 = all)")
    parser.add_argument("--out", default="-", metavar="PATH",
                        help="output path ('-' for stdout)")
    args = parser.parse_args(argv)

    from distributedmandelbrot_tpu_torch.obs import postmortem

    pm = postmortem.assemble(args.dump_dir)
    if args.json:
        body = json.dumps(pm.to_dict(), indent=1, sort_keys=True)
    elif args.chrome:
        body = json.dumps(pm.to_chrome())
    else:
        body = pm.render_text(limit=args.limit or None)
    if args.out == "-":
        print(body, flush=True)
    else:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(body + "\n")
        print(f"wrote postmortem of {len(pm.dumps)} dump(s), "
              f"{len(pm.timeline)} events, {len(pm.anomalies)} "
              f"anomalies -> {args.out}", flush=True)
    if not pm.dumps:
        print(f"postmortem: no readable dumps in "
              f"{args.dump_dir}", file=sys.stderr)
        return 1
    return 0


def cmd_admin(argv: Sequence[str]) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distributedmandelbrot_tpu_torch admin",
        description="Administrative actions against a running "
                    "coordinator's metrics exporter.")
    parser.add_argument("action", choices=["checkpoint"],
                        help="checkpoint: write a durability checkpoint "
                             "now (POST /checkpoint) and print its stats")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int,
                        default=proto.DEFAULT_EXPORTER_PORT)
    parser.add_argument("--timeout", type=float, default=30.0,
                        help="HTTP timeout in seconds (checkpoint writes "
                             "are fsync'd; allow for slow disks)")
    args = parser.parse_args(argv)

    import urllib.request
    url = f"http://{args.host}:{args.port}/checkpoint"
    req = urllib.request.Request(url, data=b"", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=args.timeout) as resp:
            stats = json.loads(resp.read().decode("utf-8"))
    except (OSError, ValueError) as e:
        raise SystemExit(f"admin checkpoint: cannot POST {url}: {e}")
    print(json.dumps(stats, indent=1, sort_keys=True), flush=True)
    return 0


def cmd_loadgen(argv: Sequence[str]) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distributedmandelbrot_tpu_torch loadgen",
        description="Open-loop storm harness for the gateway read path: "
                    "Poisson arrivals, Zipf tile popularity, scripted "
                    "flash-crowd phases, replica fleets over one shared "
                    "object store.  Reports p50/p99/p999, goodput vs "
                    "offered load, and the shed fraction.")
    parser.add_argument("--smoke", action="store_true",
                        help="self-check on a virtual clock against a "
                             "stub gateway — no sockets (CI-safe)")
    parser.add_argument("--phases",
                        default="steady:200x5,spike:1200x2,steady:200x3",
                        help="schedule spec: kind:rate[-hi]xduration "
                             "segments, comma-separated (kinds: steady, "
                             "spike, ramp; e.g. ramp:200-2000x5)")
    parser.add_argument("--level", type=int, default=8,
                        help="tile level whose keyspace the Zipf sampler "
                             "draws from")
    parser.add_argument("--zipf", type=float, default=1.1,
                        help="Zipf popularity exponent s (P(rank k) ~ "
                             "k**-s)")
    parser.add_argument("--seed", type=int, default=0,
                        help="schedule + sampler seed (same seed, same "
                             "storm)")
    parser.add_argument("--replicas", type=int, default=1,
                        help="gateway replicas sharing one object store")
    parser.add_argument("--render", action="store_true",
                        help="issue rendered-tile queries (palette PNG "
                             "bodies) instead of raw codec payloads")
    parser.add_argument("--colormap", default="jet",
                        help="colormap for --render "
                             "(jet, viridis, plasma)")
    parser.add_argument("--rate", type=float, default=None,
                        help="per-replica admission token-bucket rate "
                             "(default: unlimited)")
    parser.add_argument("--burst", type=float, default=64.0,
                        help="per-replica token-bucket burst")
    parser.add_argument("--queue-depth", type=int, default=64,
                        help="per-replica cap on queries in service")
    parser.add_argument("--seed-tiles", type=int, default=16,
                        help="pre-seed the hottest N tiles into the "
                             "shared store before the storm")
    parser.add_argument("--timeout", type=float, default=30.0,
                        help="per-request client timeout (seconds)")
    parser.add_argument("--sessions", type=int, default=0, metavar="N",
                        help="interactive-session mode: deal arrivals "
                             "onto N panning sessions speaking the "
                             "session wire (trajectory tracking, "
                             "prefetch, per-session fairness)")
    parser.add_argument("--hot-share", type=float, default=0.0,
                        help="with --sessions: extra fraction of "
                             "arrivals routed to session 0 (the "
                             "flash-crowd fairness scenario)")
    parser.add_argument("--session-rate", type=float, default=None,
                        help="with --sessions: per-session admission "
                             "token rate (default: unlimited)")
    parser.add_argument("--session-burst", type=float, default=32.0,
                        help="with --sessions: per-session token burst")
    parser.add_argument("--json", action="store_true",
                        help="emit the report as JSON")
    args = parser.parse_args(argv)

    # Lazy: the loadgen package and the serve stack under it load only
    # for this command.
    from distributedmandelbrot_tpu_torch import loadgen

    try:
        phases = loadgen.parse_phases(args.phases)
    except ValueError as e:
        print(f"loadgen: {e}", file=sys.stderr)
        return 2
    if args.sessions:
        schedule = loadgen.build_session_schedule(
            phases, level=args.level, sessions=args.sessions,
            seed=args.seed, zipf_s=args.zipf, hot_share=args.hot_share)
    else:
        sampler = loadgen.ZipfTiles(args.level, s=args.zipf,
                                    seed=args.seed)
        schedule = loadgen.build_schedule(phases, sampler, seed=args.seed)
    if not schedule:
        print("loadgen: schedule is empty (rate 0?)", file=sys.stderr)
        return 2
    if args.sessions:
        return _loadgen_session_storm(args, phases, schedule,
                                      smoke=args.smoke)
    if args.smoke:
        return _loadgen_smoke(phases, schedule)
    return _loadgen_storm(args, phases, schedule)


def _loadgen_smoke(phases, schedule) -> int:
    """Virtual-clock self-check: stub gateway, deterministic, instant.

    The stub models a server with bounded concurrency: requests past its
    depth are shed immediately, admitted ones cost a fixed service time.
    The checks are consistency invariants, not performance numbers.
    """

    from distributedmandelbrot_tpu_torch import loadgen
    from distributedmandelbrot_tpu_torch.loadgen import recorder as rec

    timebase = loadgen.VirtualTimebase()
    recorder = loadgen.StormRecorder()
    inflight = 0

    async def stub(level: int, i: int, j: int) -> tuple[str, int]:
        nonlocal inflight
        if inflight >= 64:
            return rec.OUTCOME_SHED, 0
        inflight += 1
        try:
            await timebase.sleep(0.1)  # 640/s capacity vs 1200/s spike
        finally:
            inflight -= 1
        return rec.OUTCOME_OK, 1024

    runner = loadgen.OpenLoopRunner(schedule, stub, recorder,
                                    timebase=timebase)

    async def drive() -> float:
        task = asyncio.ensure_future(runner.run())
        await timebase.drain(until=task)
        return task.result()

    duration = asyncio.run(drive())
    report = recorder.report(duration=duration,
                             offered=loadgen.schedule.offered_rate(schedule),
                             phases=[p.name for p in phases])
    issued = report["requests"]
    settled = (report["completed"] + report["shed"]
               + report["unavailable"] + report["errors"])
    problems = []
    if issued != len(schedule):
        problems.append(f"issued {issued} != scheduled {len(schedule)}")
    if settled != issued:
        problems.append(f"settled {settled} != issued {issued}")
    if report["completed"] == 0 or report["p50"] is None:
        problems.append("no completed requests / empty latency histogram")
    if problems:
        print("loadgen --smoke FAILED: " + "; ".join(problems),
              file=sys.stderr)
        return 1
    print(f"loadgen smoke ok: {issued} arrivals over "
          f"{len(phases)} phase(s) in {duration:.1f} virtual s — "
          f"{report['completed']} completed, {report['shed']} shed, "
          f"p50 {report['p50']:.3f}s goodput {report['goodput']}/s")
    return 0


def _loadgen_storm(args, phases, schedule) -> int:
    """A real storm: threaded replica fleet over a shared in-memory
    object store, seeded with the Zipf head, driven open-loop."""


    from distributedmandelbrot_tpu_torch import loadgen
    from distributedmandelbrot_tpu_torch.core.chunk import Chunk
    from distributedmandelbrot_tpu_torch.core.geometry import CHUNK_PIXELS
    from distributedmandelbrot_tpu_torch.loadgen.driver import GatewayDriver
    from distributedmandelbrot_tpu_torch.loadgen.replicas import GatewayFleet
    from distributedmandelbrot_tpu_torch.storage.backends import (
        MemoryObjectStore, ObjectStoreBackend)
    from distributedmandelbrot_tpu_torch.storage.store import ChunkStore

    colormap_ids = {name: cid for cid, name in proto.COLORMAPS.items()}
    if args.render and args.colormap not in colormap_ids:
        print(f"loadgen: unknown colormap {args.colormap!r} "
              f"(have {sorted(colormap_ids)})", file=sys.stderr)
        return 2

    kv = MemoryObjectStore()
    seeder = ChunkStore(backend=ObjectStoreBackend(kv))
    # RLE-friendly non-constant pixels: long runs, a few distinct values.
    pixels = np.repeat(np.arange(64, dtype=np.uint8) + 1,
                       CHUNK_PIXELS // 64)
    sampler = loadgen.ZipfTiles(args.level, s=args.zipf, seed=args.seed)
    for level, i, j in sampler.hottest(args.seed_tiles):
        seeder.save(Chunk(level, i, j, pixels))

    fleet = GatewayFleet(kv, replicas=args.replicas, rate=args.rate,
                         burst=args.burst,
                         max_queue_depth=args.queue_depth)
    with fleet:
        driver = GatewayDriver(fleet.addresses, render=args.render,
                               colormap_id=colormap_ids.get(args.colormap,
                                                            0),
                               timeout=args.timeout)
        recorder = loadgen.StormRecorder()
        runner = loadgen.OpenLoopRunner(schedule, driver, recorder)
        duration = asyncio.run(runner.run())
        report = recorder.report(
            duration=duration,
            offered=loadgen.schedule.offered_rate(schedule),
            phases=[p.name for p in phases])
        report["replicas"] = args.replicas
        report["gateway_overloaded"] = fleet.counter("gateway_overloaded")
        report["gateway_served"] = (fleet.counter("gateway_served")
                                    + fleet.counter(
                                        "gateway_render_served"))
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        for key in ("requests", "completed", "shed", "unavailable",
                    "errors", "offered_rate", "goodput", "shed_fraction",
                    "p50", "p99", "p999", "bytes", "replicas",
                    "gateway_overloaded", "gateway_served"):
            print(f"{key:20} {report[key]}")
        for phase, stats in (report.get("phases") or {}).items():
            print(f"  {phase:18} p50={stats['p50']} p99={stats['p99']} "
                  f"p999={stats['p999']}")
    return 0


def _loadgen_session_storm(args, phases, schedule, *,
                           smoke: bool = False) -> int:
    """Trajectory storm against a session-enabled fleet.

    The store is pre-seeded with the *whole* level grid — sessions pan
    everywhere, and a fully-warm store keeps the measurement about the
    session machinery (prediction, prefetch marks, fair admission)
    rather than store misses.  ``smoke`` runs the same storm on a
    virtual clock and turns the report into pass/fail checks: ids
    issued, predictions planned, prefetch marks consumed, every arrival
    settled — host-only, no device needed.
    """


    from distributedmandelbrot_tpu_torch import loadgen
    from distributedmandelbrot_tpu_torch.core.chunk import Chunk
    from distributedmandelbrot_tpu_torch.core.geometry import CHUNK_PIXELS
    from distributedmandelbrot_tpu_torch.loadgen.replicas import GatewayFleet
    from distributedmandelbrot_tpu_torch.obs import names as obs_names
    from distributedmandelbrot_tpu_torch.storage.backends import (
        MemoryObjectStore, ObjectStoreBackend)
    from distributedmandelbrot_tpu_torch.storage.store import ChunkStore

    class _IoVirtualTimebase(loadgen.VirtualTimebase):
        # Real sockets under the virtual clock: after each quiesce
        # burst, yield to the selector for a moment so cross-thread
        # socket IO can land.  The deadlock guard gets minutes of
        # grace (>= 1 ms per idle round) because the in-flight tail
        # completes on wall time, not the virtual clock — the driver's
        # per-request timeout still bounds a genuine hang.
        def __init__(self) -> None:
            super().__init__(max_idle_rounds=120_000)

        async def _quiesce(self) -> None:
            await super()._quiesce()
            await asyncio.sleep(0.001)

    kv = MemoryObjectStore()
    seeder = ChunkStore(backend=ObjectStoreBackend(kv))
    pixels = np.repeat(np.arange(64, dtype=np.uint8) + 1,
                       CHUNK_PIXELS // 64)
    for i in range(args.level):
        for j in range(args.level):
            seeder.save(Chunk(args.level, i, j, pixels))

    fleet = GatewayFleet(kv, replicas=args.replicas, rate=args.rate,
                         burst=args.burst,
                         max_queue_depth=args.queue_depth,
                         sessions=True, session_rate=args.session_rate,
                         session_burst=args.session_burst)
    with fleet:
        driver = loadgen.SessionDriver(fleet.addresses,
                                       timeout=args.timeout)
        recorder = loadgen.StormRecorder()
        if smoke:
            timebase = _IoVirtualTimebase()
            runner = loadgen.SessionRunner(schedule, driver, recorder,
                                           timebase=timebase)

            async def drive() -> float:
                task = asyncio.ensure_future(runner.run())
                await timebase.drain(until=task)
                return task.result()

            duration = asyncio.run(drive())
        else:
            runner = loadgen.SessionRunner(schedule, driver, recorder)
            duration = asyncio.run(runner.run())
        report = recorder.report(
            duration=duration,
            offered=loadgen.schedule.offered_rate(schedule),
            phases=[p.name for p in phases])
        report["replicas"] = args.replicas
        report["sessions"] = args.sessions
        report["session_opens"] = fleet.counter(obs_names.SESSION_OPENS)
        report["session_throttled"] = fleet.counter(
            obs_names.SESSION_THROTTLED)
        report["prefetch_planned"] = fleet.counter(
            obs_names.PREFETCH_PLANNED)
        hits = fleet.counter(obs_names.PREFETCH_HITS)
        misses = fleet.counter(obs_names.PREFETCH_MISSES)
        report["prefetch_hits"] = hits
        report["prefetch_misses"] = misses
        report["prefetch_hit_ratio"] = (
            round(hits / (hits + misses), 4) if hits + misses else None)
        ok_min, ok_max = loadgen.ok_spread(driver.ok_by_session,
                                           args.sessions)
        report["ok_min_session"] = ok_min
        report["ok_max_session"] = ok_max

    if smoke:
        issued = report["requests"]
        settled = (report["completed"] + report["shed"]
                   + report["unavailable"] + report["errors"])
        problems = []
        if issued != len(schedule):
            problems.append(f"issued {issued} != scheduled "
                            f"{len(schedule)}")
        if settled != issued:
            problems.append(f"settled {settled} != issued {issued}")
        if report["completed"] == 0:
            problems.append("no completed requests")
        if report["session_opens"] < 1:
            problems.append("no sessions opened on the wire")
        if report["prefetch_planned"] < 1:
            problems.append("predictor planned no prefetches")
        if report["prefetch_hits"] < 1:
            problems.append("no query consumed a prefetch mark")
        if problems:
            print("loadgen --smoke FAILED: "
                  + "; ".join(problems), file=sys.stderr)
            return 1
        print(f"loadgen session smoke ok: {issued} arrivals, "
              f"{report['sessions']} sessions, "
              f"{report['session_opens']} opened, "
              f"prefetch hit ratio {report['prefetch_hit_ratio']}, "
              f"ok spread {report['ok_min_session']}.."
              f"{report['ok_max_session']}")
        return 0

    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        for key in ("requests", "completed", "shed", "unavailable",
                    "errors", "offered_rate", "goodput", "shed_fraction",
                    "p50", "p99", "p999", "bytes", "replicas",
                    "sessions", "session_opens", "session_throttled",
                    "prefetch_planned", "prefetch_hits",
                    "prefetch_misses", "prefetch_hit_ratio",
                    "ok_min_session", "ok_max_session"):
            print(f"{key:20} {report[key]}")
        for phase, stats in (report.get("phases") or {}).items():
            print(f"  {phase:18} p50={stats['p50']} p99={stats['p99']} "
                  f"p999={stats['p999']}")
    return 0


def cmd_coord(argv: Sequence[str]) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distributedmandelbrot_tpu_torch coord",
        description="Run ONE shard of the sharded control plane: the "
                    "full Distributer/DataServer stack restricted to the "
                    "consistent-hash slice --shard K/N owns, over a data "
                    "dir shared with the other N-1 shards.")
    parser.add_argument("--shard", required=True, metavar="K/N",
                        help="this shard's slice: index K of N shards "
                             "(e.g. 0/4)")
    parser.add_argument("--ring", default=None, metavar="RING_JSON",
                        help="ring config naming all N shard endpoints; "
                             "optional — ownership needs only K/N, so "
                             "ephemeral-port launches may start ringless "
                             "and publish bound ports afterwards")
    parser.add_argument("--ring-version", type=int, default=1,
                        help="ring version to advertise when launching "
                             "without --ring (skew detector on the wire)")
    parser.add_argument("-l", "--levels", required=True,
                        help="level:max_iter[,level:max_iter...] — must "
                             "be identical across the fleet")
    parser.add_argument("-o", "--data-dir", default="",
                        help="parent directory for the SHARED Data/ "
                             "(default: cwd)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--distributer-port", type=int, default=0,
                        help="0 = ephemeral (default: shards usually "
                             "co-locate, so fixed ports would collide)")
    parser.add_argument("--dataserver-port", type=int, default=0)
    parser.add_argument("--lease-timeout", type=float,
                        default=proto.DEFAULT_LEASE_TIMEOUT)
    parser.add_argument("--sweep-period", type=float,
                        default=proto.DEFAULT_SWEEP_PERIOD)
    parser.add_argument("--fsync-index", action="store_true")
    parser.add_argument("--checkpoint-period", type=float, default=0.0,
                        help="durability checkpoint every N seconds "
                             "(0 disables)")
    parser.add_argument("--stats-period", type=float, default=60.0)
    parser.add_argument("--exporter-port", type=int, default=0,
                        help="HTTP metrics port; 0 = ephemeral, "
                             "-1 disables")
    parser.add_argument("--sample-period", type=float, default=2.0,
                        help="seconds between /timeseries snapshots of "
                             "the registry")
    parser.add_argument("--history-window", type=float, default=600.0,
                        help="seconds of timeseries history kept in the "
                             "ring buffer")
    _add_common(parser)
    args = parser.parse_args(argv)
    _configure_logging(args)

    from distributedmandelbrot_tpu_torch.control import ShardedCoordinator
    from distributedmandelbrot_tpu_torch.control.ring import (
        RingConfigError, parse_shard_spec)
    from distributedmandelbrot_tpu_torch.storage.ownership import \
        LevelOwnedError
    from distributedmandelbrot_tpu_torch.storage.store import DataDirError

    from distributedmandelbrot_tpu_torch.core.workload import \
        parse_level_settings

    settings = parse_level_settings(args.levels)
    try:
        shard, n_shards = parse_shard_spec(args.shard)
        coordinator = ShardedCoordinator(
            settings, shard, n_shards,
            ring_path=args.ring, ring_version=args.ring_version,
            data_dir_parent=args.data_dir, host=args.host,
            distributer_port=args.distributer_port,
            dataserver_port=args.dataserver_port,
            lease_timeout=args.lease_timeout,
            sweep_period=args.sweep_period,
            fsync_index=args.fsync_index,
            checkpoint_period=args.checkpoint_period,
            stats_period=args.stats_period,
            sample_period=args.sample_period,
            history_window=args.history_window,
            exporter_port=(None if args.exporter_port < 0
                           else args.exporter_port))
    except (RingConfigError, DataDirError, LevelOwnedError) as e:
        raise SystemExit(f"coord: {e}")
    sched = coordinator.scheduler
    print(f"coord shard {shard}/{n_shards}: owns {sched.owned_tiles} of "
          f"{sched.total_tiles} tiles across {len(settings)} level(s) "
          f"({sched.completed_count} already complete on disk)",
          flush=True)
    try:
        asyncio.run(coordinator.run_forever())
    except KeyboardInterrupt:
        pass
    return 0


def cmd_chaos(argv: Sequence[str]) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distributedmandelbrot_tpu_torch chaos",
        description="Run one chaos scenario against a live sharded farm "
                    "(real subprocesses, real sockets, real numpy "
                    "compute): kill coordinators and workers on a "
                    "schedule, then audit exactly-once completion, ring "
                    "ownership, numpy-golden parity, and the "
                    "restart-to-first-grant blip.")
    parser.add_argument("scenario", nargs="?", default="coord-kill",
                        help="catalogue entry (see --list); default: "
                             "coord-kill")
    parser.add_argument("--list", action="store_true",
                        help="list the scenario catalogue and exit")
    parser.add_argument("--smoke", action="store_true",
                        help="CI-sized run: shallower tiles, one worker, "
                             "one parity sample")
    parser.add_argument("--levels", default=None,
                        help="override the scenario's level spec")
    parser.add_argument("--workers", type=int, default=None,
                        help="override the scenario's worker count")
    parser.add_argument("--shards", type=int, default=None,
                        help="override the scenario's shard count")
    parser.add_argument("--deadline", type=float, default=None,
                        help="override the completion deadline (seconds)")
    parser.add_argument("--workdir", default=None,
                        help="keep farm state + per-process logs here "
                             "(default: throwaway temp dir)")
    parser.add_argument("--json", action="store_true",
                        help="emit the report as JSON")
    _add_common(parser)
    args = parser.parse_args(argv)
    _configure_logging(args)

    import dataclasses as dc

    # Lazy: the chaos package loads only for this command; its
    # workers compute with numpy on the host.
    from distributedmandelbrot_tpu_torch.chaos import SCENARIOS, ChaosRunner

    if args.list:
        for name in sorted(SCENARIOS):
            sc = SCENARIOS[name]
            print(f"{name:18} {sc.description}")
        return 0
    if args.scenario not in SCENARIOS:
        print(f"chaos: unknown scenario {args.scenario!r}; have "
              f"{sorted(SCENARIOS)}", file=sys.stderr)
        return 2
    scenario = SCENARIOS[args.scenario]
    if args.smoke:
        scenario = dc.replace(scenario, levels="3:2", n_workers=1,
                              parity_samples=1, deadline=180.0)
    overrides = {}
    if args.levels is not None:
        overrides["levels"] = args.levels
    if args.workers is not None:
        overrides["n_workers"] = args.workers
    if args.shards is not None:
        overrides["n_shards"] = args.shards
    if args.deadline is not None:
        overrides["deadline"] = args.deadline
    if overrides:
        scenario = dc.replace(scenario, **overrides)

    runner = ChaosRunner(scenario, workdir=args.workdir,
                         log=None if args.quiet else print)
    report = runner.run()
    if args.json:
        print(report.to_json())
    else:
        print(f"chaos {report.scenario}: "
              f"{'OK' if report.ok else 'FAILED'} — "
              f"{report.tiles_on_disk}/{report.expected_tiles} tiles, "
              f"{report.duplicate_entries} duplicates, "
              f"{report.misowned_entries} misowned, "
              f"parity {report.parity_checked - report.parity_failures}/"
              f"{report.parity_checked}, {report.kills} kills, "
              f"{report.restarts} restarts, "
              f"first-grant blips {report.restart_to_first_grant_s} "
              f"in {report.duration_s:.1f}s")
        for failure in report.failures:
            print(f"  FAIL: {failure}")
    return 0 if report.ok else 1


def _parse_peer_args(args: argparse.Namespace) -> list:
    """--peers/--ring -> ``[role@]host:port`` peer specs for the
    aggregator (shared by cmd_top's direct mode and the smoke farm)."""
    peers: list = []
    for chunk in args.peers or []:
        peers.extend(s for s in (p.strip() for p in chunk.split(","))
                     if s)
    if args.ring:
        from distributedmandelbrot_tpu_torch.control.ring import (
            HashRing, RingConfigError)
        try:
            ring = HashRing.load(args.ring)
        except RingConfigError as e:
            raise SystemExit(f"top: {e}")
        for info in ring.shards:
            if info.exporter_port:
                peers.append(f"shard@{info.host}:{info.exporter_port}")
    return peers


def _fetch_fleet_doc(url: str, timeout: float = 5.0) -> dict:
    """One /fleet document from a running FleetService/exporter."""

    from distributedmandelbrot_tpu_torch.obs.fleet import (ScrapeError,
                                                           http_fetch)
    base = url if "://" in url else "http://" + url
    body = http_fetch(base.rstrip("/") + "/fleet", timeout)
    doc = json.loads(body.decode("utf-8", errors="replace"))
    if not isinstance(doc, dict):
        raise ScrapeError(f"/fleet returned {type(doc).__name__}")
    return doc


def _top_smoke(args) -> int:
    """Throwaway host-only farm (2 shards + 2 numpy workers via the
    chaos driver, 1 in-process gateway replica), one dashboard frame
    against it, and hard assertions that every role reports: the CI
    proof that the whole observability plane is wired end to end."""
    import shutil
    import subprocess
    import tempfile

    from distributedmandelbrot_tpu_torch.control.ring import (HashRing,
                                                              ShardInfo)
    from distributedmandelbrot_tpu_torch.loadgen.driver import GatewayDriver
    from distributedmandelbrot_tpu_torch.loadgen.replicas import GatewayFleet
    from distributedmandelbrot_tpu_torch.obs.fleet import FleetAggregator
    from distributedmandelbrot_tpu_torch.obs.top import render_top
    from distributedmandelbrot_tpu_torch.storage.backends import \
        MemoryObjectStore

    n_shards, n_workers, levels = 2, 2, "3:2"
    root = tempfile.mkdtemp(prefix="dmtpu-top-smoke-")
    procs: list = []
    fleet_gw = None
    failures: list[str] = []
    try:
        data_dir = f"{root}/farm"
        ring_path = f"{root}/ring.json"
        port_files = [f"{root}/shard-{k}.ports" for k in range(n_shards)]
        for k in range(n_shards):
            cmd = [sys.executable, "-m",
                   "distributedmandelbrot_tpu_torch.chaos.driver", "shard",
                   data_dir, port_files[k], levels, str(k), str(n_shards),
                   "--lease-timeout", "30", "--sweep-period", "0.5",
                   "--checkpoint-period", "0.5"]
            with open(f"{root}/shard-{k}.log", "w", encoding="utf-8") as lf:
                procs.append(subprocess.Popen(cmd, stdout=lf, stderr=lf))
        deadline = time.monotonic() + 30.0
        infos = []
        for k in range(n_shards):
            while True:
                try:
                    with open(port_files[k], "r", encoding="utf-8") as f:
                        infos.append(json.load(f))
                    break
                except (OSError, ValueError):
                    if time.monotonic() > deadline:
                        raise SystemExit(
                            f"top --smoke: shard {k} never "
                            f"published its ports (see {root})")
                    time.sleep(0.05)
        HashRing([ShardInfo("127.0.0.1",
                            distributer_port=i["distributer"],
                            dataserver_port=i["dataserver"],
                            exporter_port=i["exporter"])
                  for i in infos], version=1).save(ring_path)
        for _ in range(n_workers):
            cmd = [sys.executable, "-m",
                   "distributedmandelbrot_tpu_torch.chaos.driver", "worker",
                   ring_path, "--poll-interval", "0.2"]
            with open(f"{root}/worker.log", "a", encoding="utf-8") as lf:
                procs.append(subprocess.Popen(cmd, stdout=lf, stderr=lf))
        # The read tier: one exporter-bearing gateway replica over an
        # (empty) shared object store — misses still count queries and
        # time the request histogram, which is all the dashboard needs.
        fleet_gw = GatewayFleet(MemoryObjectStore(), replicas=1,
                                exporter=True).start()
        gw_peer = f"gateway@127.0.0.1:{fleet_gw.exporter_ports[0]}"
        agg = FleetAggregator(
            [f"shard@127.0.0.1:{i['exporter']}" for i in infos]
            + [gw_peer], rate_window=30.0)
        driver = GatewayDriver(fleet_gw.addresses)

        async def _storm(n: int) -> None:
            for i in range(n):
                await driver(3, i % 8, (i // 8) % 8)

        snap: dict = {}
        probe_deadline = time.monotonic() + 60.0
        while time.monotonic() < probe_deadline:
            asyncio.run(_storm(6))
            agg.scrape_once()
            snap = agg.snapshot()
            roles = snap.get("roles", {})
            if (snap["totals"]["grants_per_s"] > 0
                    and snap["totals"]["queries_per_s"] > 0
                    and snap.get("workers")
                    and "shard" in roles and "gateway" in roles):
                break
            time.sleep(1.0)
        print(render_top(snap, color=False), flush=True)

        roles = snap.get("roles", {})
        totals = snap.get("totals", {})
        if roles.get("shard", {}).get("healthy", 0) != n_shards:
            failures.append(f"expected {n_shards} healthy shard peers, "
                            f"got {roles.get('shard')}")
        if roles.get("gateway", {}).get("healthy", 0) < 1:
            failures.append(f"no healthy gateway peer: "
                            f"{roles.get('gateway')}")
        if not snap.get("workers"):
            failures.append("no span-reported worker rows")
        if not totals.get("grants_per_s", 0) > 0:
            failures.append(f"zero grant rate: {totals}")
        if not totals.get("queries_per_s", 0) > 0:
            failures.append(f"zero gateway query rate: {totals}")
        if not any(g.get("queries_per_s", 0) > 0
                   for g in snap.get("gateways", [])):
            failures.append("no gateway row with a nonzero query rate")
        for failure in failures:
            print(f"SMOKE FAIL: {failure}", file=sys.stderr)
        print(f"top smoke: {'OK' if not failures else 'FAILED'} — "
              f"{len(snap.get('peers', []))} peers, "
              f"{len(snap.get('workers', []))} workers, "
              f"{totals.get('grants_per_s')} grants/s, "
              f"{totals.get('queries_per_s')} q/s", flush=True)
        return 0 if not failures else 1
    finally:
        if fleet_gw is not None:
            fleet_gw.stop()
        for proc in procs:
            proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
        shutil.rmtree(root, ignore_errors=True)


def cmd_top(argv: Sequence[str]) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m distributedmandelbrot_tpu_torch top",
        description="Live fleet dashboard: scrape every exporter "
                    "(--peers / --ring), or read a running /fleet "
                    "endpoint (--fleet-url), and render per-role rates, "
                    "SLO burn, and straggler flags.")
    parser.add_argument("--peers", action="append", metavar="SPECS",
                        help="comma-separated [role@]host:port exporter "
                             "endpoints (repeatable)")
    parser.add_argument("--ring", default=None, metavar="RING_JSON",
                        help="scrape the exporter ports named in this "
                             "ring config")
    parser.add_argument("--fleet-url", default=None, metavar="URL",
                        help="read an existing fleet aggregator's /fleet "
                             "instead of scraping peers directly")
    parser.add_argument("--once", action="store_true",
                        help="print one frame and exit (CI mode)")
    parser.add_argument("--json", action="store_true",
                        help="emit the raw /fleet snapshot as JSON "
                             "instead of the dashboard")
    parser.add_argument("--interval", type=float, default=2.0,
                        help="seconds between frames (and scrapes)")
    parser.add_argument("--window", type=float, default=60.0,
                        help="trailing rate window in seconds")
    parser.add_argument("--no-color", action="store_true",
                        help="plain text (auto when stdout is not a tty)")
    parser.add_argument("--smoke", action="store_true",
                        help="spawn a throwaway host-only farm (2 shards, "
                             "2 numpy workers, 1 gateway), render one "
                             "frame against it, and assert every role "
                             "reports — the CI end-to-end check")
    _add_common(parser)
    args = parser.parse_args(argv)
    _configure_logging(args)

    from distributedmandelbrot_tpu_torch.obs.fleet import (FleetAggregator,
                                                           ScrapeError)
    from distributedmandelbrot_tpu_torch.obs.top import render_frame

    if args.smoke:
        return _top_smoke(args)

    color = not args.no_color and sys.stdout.isatty()
    interval = max(0.2, args.interval)

    if args.fleet_url:
        def take_snapshot() -> dict:
            return _fetch_fleet_doc(args.fleet_url)
    else:
        peers = _parse_peer_args(args)
        if not peers:
            parser.error("need --peers, --ring, or --fleet-url "
                         "(or --smoke)")
        agg = FleetAggregator(peers, rate_window=args.window)

        def take_snapshot() -> dict:
            agg.scrape_once()
            return agg.snapshot()

    try:
        if args.once and not args.fleet_url:
            # Rates need two scrape points: one warmup round, a beat,
            # then the rendered snapshot.
            take_snapshot()
            time.sleep(min(interval, 1.0))
        while True:
            try:
                snap = take_snapshot()
            except (ScrapeError, OSError, ValueError) as e:
                if args.once:
                    raise SystemExit(f"top: {e}")
                snap = {"peers": [], "error": str(e)}
            if args.json:
                print(json.dumps(snap, indent=1, sort_keys=True))
            else:
                sys.stdout.write(render_frame(snap, color=color,
                                              clear=not args.once))
                sys.stdout.flush()
            if args.once:
                return 0
            time.sleep(interval)
    except KeyboardInterrupt:
        return 0


COMMANDS = {"coordinator": cmd_coordinator, "serve": cmd_serve,
            "worker": cmd_worker, "viewer": cmd_viewer,
            "render": cmd_render, "animate": cmd_animate,
            "coord": cmd_coord, "compact": cmd_compact, "stats": cmd_stats,
            "trace": cmd_trace, "admin": cmd_admin,
            "postmortem": cmd_postmortem, "loadgen": cmd_loadgen,
            "chaos": cmd_chaos, "top": cmd_top}


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m distributedmandelbrot_tpu_torch "
              f"{{{','.join(COMMANDS)}}} [options]\nRun a subcommand with "
              "-h for its options.")
        return 0 if argv else 2
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; expected one of "
              f"{sorted(COMMANDS)}", file=sys.stderr)
        return 2
    return COMMANDS[cmd](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
