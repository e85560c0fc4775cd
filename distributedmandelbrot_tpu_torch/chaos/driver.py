"""Subprocess entrypoints for the chaos suite's live farm.

Two roles, selected by the first argument (modeled on
``tests/coordinator_driver.py``, which this generalizes to shards):

``shard``
    ``python -m distributedmandelbrot_tpu_torch.chaos.driver shard DATA_DIR
    PORT_FILE LEVELS SHARD N_SHARDS [flags]`` — runs one
    :class:`~distributedmandelbrot_tpu_torch.control.sharded.ShardedCoordinator`
    over the shared DATA_DIR on ephemeral loopback ports (exporter on),
    writes the bound ports to PORT_FILE as JSON (atomic rename — the
    runner polls for the file), then serves until SIGTERM (graceful:
    drains in-flight persists via ``stop()``) or SIGKILL (the chaos
    kill).  Crashpoints arm through ``DMTPU_CRASHPOINTS`` and slow
    points through ``DMTPU_SLOWPOINTS`` (utils/faults.py), both read at
    import inside this process.

``worker``
    ``python -m distributedmandelbrot_tpu_torch.chaos.driver worker RING_PATH
    [flags]`` — runs one multi-homed pipelined numpy worker against the
    ring table at RING_PATH: one session per shard, leases
    round-robined, uploads routed by key.  Stateless; the runner kills
    it with SIGKILL (dropped sessions) and just respawns it.

``drain``
    ``python -m distributedmandelbrot_tpu_torch.chaos.driver drain RING_PATH
    --duration S --out OUT.json`` — a grant-storm client for
    ``bench.py --shards``: hammers lease REQN exchanges through a
    multi-homed session group for a fixed wall-clock window (never
    uploading; the bench farm runs near-zero lease timeouts so the
    frontier recycles), re-dialing from the ring file whenever a shard
    dies under it, and reports ``{"grants", "seconds"}`` as JSON.
"""

import argparse
import asyncio
import json
import os
import signal
import sys


def _write_json_atomic(path: str, payload: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(json.dumps(payload))
    os.replace(tmp, path)  # atomic: the runner polls for this file


async def _run_shard(args: argparse.Namespace) -> None:
    from distributedmandelbrot_tpu_torch.control.sharded import ShardedCoordinator
    from distributedmandelbrot_tpu_torch.core.workload import parse_level_settings

    coordinator = ShardedCoordinator(
        parse_level_settings(args.levels), args.shard, args.n_shards,
        ring_version=args.ring_version,
        data_dir_parent=args.data_dir, host="127.0.0.1",
        distributer_port=0, dataserver_port=0, exporter_port=0,
        stats_period=0.0,
        lease_timeout=args.lease_timeout,
        sweep_period=args.sweep_period,
        checkpoint_period=args.checkpoint_period)
    await coordinator.start()
    _write_json_atomic(args.port_file, {
        "distributer": coordinator.distributer_port,
        "dataserver": coordinator.dataserver_port,
        "exporter": coordinator.exporter_port,
        "pid": os.getpid(),
        "shard": coordinator.shard,
        "n_shards": coordinator.n_shards,
    })
    stop = asyncio.Event()
    # SIGTERM is the *graceful* exit (runner teardown): drain in-flight
    # persists so the post-run invariant read sees a settled index.
    # The chaos kills are SIGKILL / crashpoint hard-exits — no drain.
    asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, stop.set)
    try:
        await stop.wait()
    finally:
        await coordinator.stop()


def _run_worker(args: argparse.Namespace) -> None:
    from distributedmandelbrot_tpu_torch.control.ring import HashRing
    from distributedmandelbrot_tpu_torch.worker.backends import NumpyBackend
    from distributedmandelbrot_tpu_torch.worker.client import DistributerClient
    from distributedmandelbrot_tpu_torch.worker.worker import Worker

    ring = HashRing.load(args.ring)
    # The classic client targets shard 0 — it is only the fallback for
    # a declined session hello; ring mode multi-homes the real path.
    first = ring.shards[0]
    client = DistributerClient(first.host, first.distributer_port,
                               timeout=args.timeout)
    worker = Worker(client, NumpyBackend(),
                    batch_size=args.batch_size, window=args.window,
                    ring=ring)
    worker.run_forever(poll_interval=args.poll_interval)


def _run_drain(args: argparse.Namespace) -> None:
    import time

    from distributedmandelbrot_tpu_torch.control.ring import HashRing
    from distributedmandelbrot_tpu_torch.worker.client import ShardedSessionGroup

    deadline = time.monotonic() + args.duration
    grants = 0
    group = None
    t0 = time.monotonic()
    while time.monotonic() < deadline:
        try:
            if group is None:
                group = ShardedSessionGroup(HashRing.load(args.ring),
                                            timeout=args.timeout)
                if not group.connect():
                    group = None
                    time.sleep(0.05)
                    continue
            got = group.request_batchn(args.batch)
            grants += len(got)
            if not got:
                time.sleep(0.002)  # every shard momentarily dry
        except Exception:
            # A shard died mid-exchange: drop the whole group and
            # re-dial from the ring file (the bench rewrites it with
            # the respawned shard's fresh ports).
            if group is not None:
                group.close()
                group = None
            time.sleep(0.05)
    if group is not None:
        group.close()
    _write_json_atomic(args.out, {"grants": grants,
                                  "seconds": time.monotonic() - t0})


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="dmtpu-chaos-driver")
    sub = parser.add_subparsers(dest="role", required=True)

    p_shard = sub.add_parser("shard")
    p_shard.add_argument("data_dir")
    p_shard.add_argument("port_file")
    p_shard.add_argument("levels")
    p_shard.add_argument("shard", type=int)
    p_shard.add_argument("n_shards", type=int)
    p_shard.add_argument("--ring-version", type=int, default=1)
    p_shard.add_argument("--lease-timeout", type=float, default=5.0)
    p_shard.add_argument("--sweep-period", type=float, default=0.2)
    p_shard.add_argument("--checkpoint-period", type=float, default=0.5)

    p_worker = sub.add_parser("worker")
    p_worker.add_argument("ring")
    p_worker.add_argument("--batch-size", type=int, default=2)
    p_worker.add_argument("--window", type=int, default=4)
    p_worker.add_argument("--poll-interval", type=float, default=0.2)
    p_worker.add_argument("--timeout", type=float, default=10.0)

    p_drain = sub.add_parser("drain")
    p_drain.add_argument("ring")
    p_drain.add_argument("--duration", type=float, default=4.0)
    p_drain.add_argument("--batch", type=int, default=32)
    p_drain.add_argument("--timeout", type=float, default=5.0)
    p_drain.add_argument("--out", required=True)

    args = parser.parse_args(argv)
    if args.role == "shard":
        asyncio.run(_run_shard(args))
    elif args.role == "worker":
        _run_worker(args)
    else:
        _run_drain(args)


if __name__ == "__main__":
    sys.exit(main())
