"""Coordinator durability: atomic scheduler checkpoints + restore.

The index alone already makes *completions* durable — replaying
``_index.dat`` rebuilds the completed set (``storage/index.py``).  What
dies with the process is everything else the scheduler knows: the
frontier cursor, the retry queue, the lease table, and which worker is
mid-flight on what.  After a crash the old code restarted from a full
index replay with every lease forgotten, so in-flight workers' uploads
were rejected and they waited out their own leases.

This module checkpoints that state periodically and restores it:

- a **checkpoint** is one immutable blob (``_checkpoint-<levels>.dat``
  beside the index; atomic PUT on every backend) holding the scheduler
  snapshot, the index's logical end offset at snapshot time, and a
  **generation number**;
- the **restore** path loads the checkpoint, seeds the completed set
  from it, replays only the index *suffix* past the recorded offset
  (O(new entries), not O(index)), and rebuilds leases with their
  remaining TTLs so in-flight workers land results across the restart;
- **fencing**: each restore bumps the generation, and a checkpoint
  write refuses to clobber a blob with a higher generation — a stale
  coordinator that lost its data dir to a successor fails loudly
  instead of corrupting the successor's recovery state.

Offset/snapshot ordering (the correctness core): the index offset is
read *before* the scheduler snapshot, and tiles whose persistence is
still in flight are excluded from the checkpointed completed set.
Every key in the checkpoint therefore has a durable index entry at or
below the offset, or will land past it where the suffix replay finds
it; a crash at any interleaving loses no tiles and invents none.

The wire structs live in ``codecs/checkpoint.py`` (one on-disk format,
one owning module); the record layout is documented there.
"""

from __future__ import annotations

import asyncio
import logging
import time
import zlib
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Optional, Sequence

from distributedmandelbrot_tpu_torch.codecs.checkpoint import (
    CHECKPOINT_CRC as _CRC, CHECKPOINT_HEADER as _HEADER,
    CHECKPOINT_KEY as _KEY, CHECKPOINT_LEASE as _LEASE,
    CHECKPOINT_MAGIC as MAGIC, CHECKPOINT_RETRY as _RETRY,
    CHECKPOINT_SETTING as _SETTING, CHECKPOINT_VERSION as VERSION)
from distributedmandelbrot_tpu_torch.coordinator.scheduler import (Key,
                                                             TileScheduler)
from distributedmandelbrot_tpu_torch.core.workload import LevelSetting, Workload
from distributedmandelbrot_tpu_torch.obs import events as obs_events
from distributedmandelbrot_tpu_torch.obs import flight
from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.storage.store import ChunkStore
from distributedmandelbrot_tpu_torch.utils import faults

if TYPE_CHECKING:
    from distributedmandelbrot_tpu_torch.obs.metrics import Registry

logger = logging.getLogger("dmtpu.recovery")


class CorruptCheckpointError(Exception):
    """The checkpoint blob fails validation (bad magic/version/CRC/shape)."""


class StaleGenerationError(RuntimeError):
    """A newer coordinator generation owns this checkpoint (fencing)."""


def checkpoint_blob_name(level_settings: Sequence[LevelSetting],
                         namespace: str = "") -> str:
    """Per-levels-group blob name, so coordinators sharing a data dir
    with disjoint level sets (which the flock claims permit) keep
    independent checkpoints instead of clobbering one blob.
    ``namespace`` extends the same isolation to ring shards sharing
    every level (``_checkpoint-3-s0of4.dat``)."""
    levels = "_".join(str(s.level) for s in
                      sorted(level_settings, key=lambda s: s.level))
    return f"_checkpoint-{levels}{namespace}.dat"


@dataclass
class Checkpoint:
    """Decoded scheduler checkpoint (see module docstring for the wire)."""

    generation: int
    index_offset: int
    settings: tuple[tuple[int, int], ...]  # (level, max_iter), grant order
    cursor_pos: int
    cursor_done: bool
    completed: set[Key]
    leases: list[tuple[Workload, float]]  # (workload, remaining TTL)
    retry: list[Workload]


def encode_checkpoint(ckpt: Checkpoint) -> bytes:
    out = bytearray()
    out += _HEADER.pack(MAGIC, VERSION, ckpt.generation, ckpt.index_offset,
                        ckpt.cursor_pos, int(ckpt.cursor_done),
                        len(ckpt.settings), len(ckpt.completed),
                        len(ckpt.leases), len(ckpt.retry))
    for level, max_iter in ckpt.settings:
        out += _SETTING.pack(level, max_iter)
    for key in sorted(ckpt.completed):
        out += _KEY.pack(*key)
    for w, remaining in ckpt.leases:
        out += _LEASE.pack(w.level, w.index_real, w.index_imag,
                           w.max_iter or 0, remaining)
    for w in ckpt.retry:
        out += _RETRY.pack(w.level, w.index_real, w.index_imag,
                           w.max_iter or 0)
    out += _CRC.pack(zlib.crc32(bytes(out)))
    return bytes(out)


def decode_checkpoint(data: bytes) -> Checkpoint:
    if len(data) < _HEADER.size + _CRC.size:
        raise CorruptCheckpointError(
            f"checkpoint too short ({len(data)} bytes)")
    body, (crc,) = data[:-_CRC.size], _CRC.unpack(data[-_CRC.size:])
    if zlib.crc32(body) != crc:
        raise CorruptCheckpointError("checkpoint CRC mismatch")
    (magic, version, generation, index_offset, cursor_pos, cursor_done,
     n_settings, n_completed, n_leases, n_retry) = \
        _HEADER.unpack_from(body, 0)
    if magic != MAGIC:
        raise CorruptCheckpointError(f"bad checkpoint magic {magic!r}")
    if version != VERSION:
        raise CorruptCheckpointError(
            f"unsupported checkpoint version {version}")
    expect = (_HEADER.size + n_settings * _SETTING.size
              + n_completed * _KEY.size + n_leases * _LEASE.size
              + n_retry * _RETRY.size)
    if len(body) != expect:
        raise CorruptCheckpointError(
            f"checkpoint length {len(body)} != declared {expect}")
    pos = _HEADER.size
    settings = tuple(_SETTING.unpack_from(body, pos + i * _SETTING.size)
                     for i in range(n_settings))
    pos += n_settings * _SETTING.size
    completed = {_KEY.unpack_from(body, pos + i * _KEY.size)
                 for i in range(n_completed)}
    pos += n_completed * _KEY.size
    leases: list[tuple[Workload, float]] = []
    for i in range(n_leases):
        level, re, im, max_iter, remaining = \
            _LEASE.unpack_from(body, pos + i * _LEASE.size)
        leases.append((Workload(level, max_iter, re, im), remaining))
    pos += n_leases * _LEASE.size
    retry: list[Workload] = []
    for i in range(n_retry):
        level, re, im, max_iter = _RETRY.unpack_from(body,
                                                     pos + i * _RETRY.size)
        retry.append(Workload(level, max_iter, re, im))
    return Checkpoint(generation=generation, index_offset=index_offset,
                      settings=settings, cursor_pos=cursor_pos,
                      cursor_done=bool(cursor_done), completed=completed,
                      leases=leases, retry=retry)


def peek_generation(store: ChunkStore,
                    level_settings: Sequence[LevelSetting],
                    namespace: str = "") -> Optional[int]:
    """Generation of the stored checkpoint from its header alone (the
    fencing read before a write), or None when absent/unreadable."""
    head = store.backend.peek_blob(
        checkpoint_blob_name(level_settings, namespace), _HEADER.size)
    if head is None or len(head) < _HEADER.size:
        return None
    magic, version, generation = _HEADER.unpack_from(head, 0)[:3]
    if magic != MAGIC or version != VERSION:
        return None
    return generation


def load_checkpoint(store: ChunkStore,
                    level_settings: Sequence[LevelSetting],
                    namespace: str = ""
                    ) -> Optional[Checkpoint]:
    """The stored checkpoint, or None when absent or unreadable (a
    corrupt checkpoint degrades to a full index replay, never an error:
    the index remains the source of truth)."""
    data = store.backend.get_blob(
        checkpoint_blob_name(level_settings, namespace))
    if data is None:
        return None
    try:
        return decode_checkpoint(data)
    except CorruptCheckpointError as e:
        logger.warning("ignoring unreadable checkpoint (%s); falling back "
                       "to full index replay", e)
        return None


@dataclass
class RestoreResult:
    """What startup recovery produced (coordinator/app.py consumes it)."""

    completed: set[Key]  # checkpoint set merged with the suffix replay
    generation: int      # this coordinator's fencing generation
    checkpoint: Optional[Checkpoint]  # None -> full replay happened
    replayed_entries: int  # index entries scanned (suffix-only if ckpt)

    def apply(self, scheduler: TileScheduler, *,
              registry: Optional["Registry"] = None) -> int:
        """Adopt the checkpointed frontier/leases; returns leases rebuilt."""
        if self.checkpoint is None:
            return 0
        rebuilt = scheduler.restore_state(
            cursor_pos=self.checkpoint.cursor_pos,
            cursor_done=self.checkpoint.cursor_done,
            retry=self.checkpoint.retry,
            leases=self.checkpoint.leases)
        if registry is not None:
            registry.inc(obs_names.COORD_RESTORED_LEASES, rebuilt)
        return rebuilt


def load_restore_state(store: ChunkStore,
                       level_settings: Sequence[LevelSetting], *,
                       registry: Optional["Registry"] = None,
                       namespace: str = ""
                       ) -> RestoreResult:
    """Startup recovery: checkpoint + index-suffix replay, or full replay.

    A checkpoint is honored only when its level settings match this
    run's exactly and its recorded offset still fits the index (an
    offline compaction rewrites the index and invalidates offsets);
    otherwise the completed set comes from a full replay and only the
    generation number carries over.
    """
    levels = {s.level for s in level_settings}
    expected = tuple((s.level, s.max_iter) for s in level_settings)
    ckpt = load_checkpoint(store, level_settings, namespace)
    generation = 1 if ckpt is None else ckpt.generation + 1
    if ckpt is not None and (ckpt.settings != expected
                             or ckpt.index_offset > store.index_offset()):
        logger.warning(
            "checkpoint does not match this run (settings or index "
            "changed); falling back to full index replay")
        ckpt = None
    if ckpt is not None:
        completed = {k for k in ckpt.completed if k[0] in levels}
        suffix = store.entries_from(ckpt.index_offset)
        for e in suffix:
            if e.level in levels:
                completed.add(e.key)
        replayed = len(suffix)
        logger.info(
            "restored from checkpoint generation %d: %d completed tiles, "
            "%d index entries replayed past offset %d, %d leases pending "
            "rebuild", ckpt.generation, len(completed), replayed,
            ckpt.index_offset, len(ckpt.leases))
        if registry is not None:
            registry.inc(obs_names.COORD_RESTORES)
    else:
        entries = store.entries()
        completed = {e.key for e in entries if e.level in levels}
        replayed = len(entries)
    if registry is not None:
        registry.inc(obs_names.COORD_REPLAY_ENTRIES, replayed)
    flight.note(obs_events.CKPT_RESTORE, generation=generation,
                completed=len(completed), replayed=replayed,
                from_checkpoint=ckpt is not None)
    return RestoreResult(completed=completed, generation=generation,
                         checkpoint=ckpt, replayed_entries=replayed)


class RecoveryManager:
    """Owns periodic + on-demand checkpoints for one live coordinator.

    ``pending_keys_fn`` reports tiles whose asynchronous persistence has
    not landed (the distributer's in-flight save set); they are excluded
    from every checkpoint per the ordering invariant above.  The
    snapshot itself runs on the caller's (event loop) thread — scheduler
    state is only ever mutated there — while encoding + the blob PUT go
    through a worker thread so a multi-megabyte checkpoint never stalls
    grants.
    """

    def __init__(self, store: ChunkStore, scheduler: TileScheduler, *,
                 generation: int = 1, period: float = 0.0,
                 registry: Optional["Registry"] = None,
                 pending_keys_fn: Optional[Callable[[], set[Key]]] = None,
                 namespace: str = ""
                 ) -> None:
        self.store = store
        self.scheduler = scheduler
        self.generation = generation
        self.period = period
        self._registry = registry
        self._pending_keys_fn = pending_keys_fn
        self.namespace = namespace
        self._blob_name = checkpoint_blob_name(scheduler.level_settings,
                                               namespace)
        self._task: Optional[asyncio.Task] = None
        self._fenced = False

    # -- lifecycle --------------------------------------------------------

    async def start(self) -> None:
        if self.period > 0:
            self._task = asyncio.create_task(self._loop())

    async def stop(self, *, final_checkpoint: bool = True) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            except Exception:
                logger.exception("checkpoint loop had failed")
            self._task = None
        if final_checkpoint and not self._fenced:
            # A clean shutdown's parting checkpoint makes the next
            # restart O(suffix) from the first moment.
            try:
                await self.checkpoint()
            except Exception:
                logger.exception("final checkpoint on stop failed")

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.period)
            try:
                await self.checkpoint()
            except StaleGenerationError:
                # A successor owns the data dir now; keeping our blob
                # writes away from it is the entire point of fencing.
                logger.error(
                    "fenced out: a newer coordinator generation owns the "
                    "checkpoint; disabling further checkpoints")
                flight.note(obs_events.CKPT_ERROR, reason="fenced",
                            generation=self.generation)
                self._fenced = True
                if self._registry is not None:
                    self._registry.inc(obs_names.COORD_CHECKPOINT_ERRORS)
                return
            except Exception as exc:
                logger.exception("periodic checkpoint failed")
                flight.note(obs_events.CKPT_ERROR, reason="exception",
                            error=str(exc)[:120])
                if self._registry is not None:
                    self._registry.inc(obs_names.COORD_CHECKPOINT_ERRORS)

    # -- checkpointing ----------------------------------------------------

    def build(self) -> Checkpoint:
        """Consistent snapshot (call on the scheduler's owning thread).

        The index offset is read BEFORE the scheduler snapshot: a save
        landing between the two reads puts its entry past the offset,
        where the restore-time suffix replay recovers it — the ordering
        that makes crash-at-any-point lossless.
        """
        index_offset = self.store.index_offset()
        pending = set(self._pending_keys_fn()) \
            if self._pending_keys_fn is not None else set()
        snap = self.scheduler.snapshot_state(exclude=pending)
        settings = tuple((s.level, s.max_iter)
                         for s in self.scheduler.level_settings)
        return Checkpoint(generation=self.generation,
                          index_offset=index_offset, settings=settings,
                          cursor_pos=snap["cursor_pos"],
                          cursor_done=snap["cursor_done"],
                          completed=snap["completed"],
                          leases=snap["leases"], retry=snap["retry"])

    async def checkpoint(self) -> dict:
        """Snapshot now, persist off-loop; returns write stats."""
        ckpt = self.build()
        return await asyncio.to_thread(self.write, ckpt)

    def checkpoint_sync(self) -> dict:
        """Blocking snapshot+write for offline callers (CLI, benches)."""
        return self.write(self.build())

    def write(self, ckpt: Checkpoint) -> dict:
        """Encode + fence-check + atomic PUT; returns write stats."""
        t0 = time.monotonic()
        flight.note(obs_events.CKPT_BEGIN, generation=ckpt.generation,
                    leases=len(ckpt.leases), completed=len(ckpt.completed))
        stored = peek_generation(self.store, self.scheduler.level_settings,
                                 self.namespace)
        if stored is not None and stored > ckpt.generation:
            raise StaleGenerationError(
                f"stored checkpoint generation {stored} > ours "
                f"{ckpt.generation}")
        data = encode_checkpoint(ckpt)
        # Crash here and the previous checkpoint survives untouched —
        # the blob PUT below is atomic on every backend.
        faults.hit("recovery.mid_checkpoint")
        self.store.backend.put_blob(self._blob_name, data, fsync=True)
        dt = time.monotonic() - t0
        flight.note(obs_events.CKPT_DONE, generation=ckpt.generation,
                    bytes=len(data), seconds=round(dt, 6))
        if self._registry is not None:
            self._registry.inc(obs_names.COORD_CHECKPOINTS_WRITTEN)
            self._registry.observe(obs_names.HIST_CHECKPOINT_SECONDS, dt)
        logger.info(
            "checkpoint generation %d: %d completed, %d leases, %d retry, "
            "index offset %d, %d bytes in %.3fs", ckpt.generation,
            len(ckpt.completed), len(ckpt.leases), len(ckpt.retry),
            ckpt.index_offset, len(data), dt)
        return {"generation": ckpt.generation,
                "index_offset": ckpt.index_offset,
                "completed": len(ckpt.completed),
                "leases": len(ckpt.leases), "retry": len(ckpt.retry),
                "bytes": len(data), "seconds": dt}
