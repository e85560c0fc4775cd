"""Chunk store: append-only index + codec'd chunk blobs over a backend.

Capabilities mirrored from the reference (``DataStorage.cs``), instance-based
rather than process-global so tests and multi-store coordinators compose:

- ``Data/`` directory with ``_index.dat`` created on demand
  (``DataStorage.cs:131-144``)
- chunk files named ``level;re;im`` with a numeric suffix on collision
  (``DataStorage.cs:392-405``)
- ``save()`` appends an index entry, then writes the chunk file for Regular
  chunks (``DataStorage.cs:410-427``); Never/Immediate chunks are tag-only
- ``load()``/``load_many()`` scan the index and synthesize Never/Immediate
  chunks in memory (``DataStorage.cs:256-292,86-118``); with duplicate
  entries the *last* (most recent append) wins
- ``completed_keys()`` replays the index for resume seeding
  (``Distributer.cs:165-175``)

Fixes over the reference (survey caveats): one lock serializes index
appends AND the per-file guard is a real mutex (the reference's
check-then-add spin-wait races, ``DataStorage.cs:158-162,337-341``);
optional fsync for the index; a serialized-payload LRU so the read path
doesn't decode + re-encode a chunk per request (the reference re-serializes
every fetch, ``DataServer.cs:204-221``).

Where the bytes live is a :class:`~distributedmandelbrot_tpu_torch.storage
.backends.StoreBackend`: the default :class:`LocalFileBackend` keeps the
reference's exact on-disk layout, while :class:`ObjectStoreBackend` maps
the same index + blobs onto object-store primitives.  This module owns
every policy above the backend — entry format, filenames, caching,
torn-tail repair — so the two layouts behave identically.

Durability details this layer owns:

- startup **torn-tail repair**: a crash mid-append leaves a truncated
  final entry; appending after it (``"ab"``) would bury the tear as
  *interior* corruption, so setup scans to the last valid entry boundary
  and truncates the tail before any post-restart append;
- **logical index offsets**: :meth:`ChunkStore.index_offset` /
  :meth:`ChunkStore.entries_from` let the coordinator checkpoint a
  high-water mark and replay only the suffix on restore;
- armed **crash points** (``utils/faults.py``) at the save path's two
  nasty interleavings, so the recovery tests can die exactly between the
  blob write and the index append.
"""

from __future__ import annotations

import io
import logging
import threading
import time
from collections import OrderedDict
from typing import TYPE_CHECKING, Iterable, Optional

from distributedmandelbrot_tpu_torch.core.chunk import Chunk
from distributedmandelbrot_tpu_torch.core.geometry import CHUNK_PIXELS
from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.storage.backends import (DATA_DIR_NAME,
                                                        INDEX_FILENAME,
                                                        DataDirError,
                                                        LocalFileBackend,
                                                        StoreBackend)
from distributedmandelbrot_tpu_torch.storage.index import (CorruptIndexError,
                                                     EntryType, IndexEntry,
                                                     TornEntry, read_entry,
                                                     scan_entries)
from distributedmandelbrot_tpu_torch.utils import faults

if TYPE_CHECKING:
    from distributedmandelbrot_tpu_torch.obs.metrics import Registry

__all__ = ["ChunkStore", "DataDirError", "compact", "DATA_DIR_NAME",
           "INDEX_FILENAME"]

logger = logging.getLogger("dmtpu.store")


class ChunkStore:
    """Durable chunk storage over a backend (default: ``parent_dir/Data/``)."""

    def __init__(self, parent_dir: str = "", *, fsync_index: bool = False,
                 payload_cache_size: int = 64,
                 registry: Optional["Registry"] = None,
                 backend: Optional[StoreBackend] = None,
                 namespace: str = "") -> None:
        # Optional latency telemetry (store_read/write_seconds); None
        # keeps the store dependency-free for scripts and tests.
        self._registry = registry
        # ``namespace`` gives one coordinator shard a private index log
        # inside a data dir shared with its peers; a caller supplying
        # its own backend namespaces it there instead.
        self.backend = backend if backend is not None \
            else LocalFileBackend(parent_dir, namespace=namespace)
        # Path attributes exist only for the local layout (ownership
        # flocks, offline compaction); object-store layouts have neither.
        self.data_dir = getattr(self.backend, "data_dir", None)
        self.index_path = getattr(self.backend, "index_path", None)
        self._fsync_index = fsync_index
        self._index_lock = threading.Lock()
        self._file_locks: dict[str, threading.Lock] = {}
        self._file_locks_guard = threading.Lock()
        self._payload_cache: OrderedDict[tuple[int, int, int], bytes] = \
            OrderedDict()
        self._payload_cache_size = payload_cache_size
        self._cache_lock = threading.Lock()
        self.setup()

    # -- directory / bookkeeping ------------------------------------------

    def setup(self) -> None:
        """Create the backing location, then repair any torn index tail.

        Backend setup probes writability the way the reference does
        before starting (``Program.cs:159-176``) and raises
        :class:`DataDirError` with a clean message instead of letting a
        raw OSError traceback surface from the CLI.  The tail repair
        must run before the first post-restart append: the index opens
        in append mode, so writing after a crash-torn final entry would
        turn it from a recoverable truncated tail into interior
        corruption on the next scan.
        """
        self.backend.setup()
        with self._index_lock:
            self._repair_index_tail()

    def _repair_index_tail(self) -> None:
        """Truncate the index to its last valid entry boundary (lock held)."""
        data = self.backend.read_index()
        size = len(data)
        f = io.BytesIO(data)
        valid = 0
        while True:
            try:
                read_entry(f)
            except EOFError:
                break  # clean end: valid == size
            except TornEntry:
                break  # crash-torn tail: truncate past `valid`
            except CorruptIndexError:
                # Interior corruption is not repairable; keep the bytes
                # for forensics and let entries() raise loudly, exactly
                # as an unrepaired store would.
                return
            valid = f.tell()
        if valid < size:
            self.backend.truncate_index(valid)
            logger.warning(
                "repaired torn index tail: truncated %d trailing bytes "
                "(crash mid-append); %d valid bytes kept", size - valid,
                valid)
            if self._registry is not None:
                self._registry.inc(obs_names.STORE_TORN_TAILS_REPAIRED)

    def _file_lock(self, filename: str) -> threading.Lock:
        with self._file_locks_guard:
            return self._file_locks.setdefault(filename, threading.Lock())

    def _generate_filename(self, chunk: Chunk) -> str:
        base = f"{chunk.level};{chunk.index_real};{chunk.index_imag}"
        if not self.backend.blob_exists(base):
            return base
        suffix = 0
        while self.backend.blob_exists(base + str(suffix)):
            suffix += 1
        return base + str(suffix)

    # -- write path -------------------------------------------------------

    def save(self, chunk: Chunk) -> IndexEntry:
        """Persist a chunk: write its blob (if Regular), then its index entry.

        The blob is written *before* the index entry so a crash between
        the two leaves an orphaned data blob (harmless) rather than an
        index entry pointing at nothing — the reverse of the reference's
        order, which can break resume.
        """
        t0 = time.monotonic()
        if chunk.is_never:
            entry = IndexEntry(*chunk.key, EntryType.NEVER)
        elif chunk.is_immediate:
            entry = IndexEntry(*chunk.key, EntryType.IMMEDIATE)
        else:
            filename = self._generate_filename(chunk)
            payload = chunk.serialize()
            with self._file_lock(filename):
                faults.hit("store.before_chunk_write")
                self.backend.put_blob(filename, payload)
            faults.hit("store.after_chunk_write")
            entry = IndexEntry(*chunk.key, EntryType.REGULAR, filename)
            self._cache_payload(chunk.key, payload)

        with self._index_lock:
            self.backend.append_index(entry.to_bytes(),
                                      fsync=self._fsync_index)
        # Outside the lock: the entry is already durable, and a slowpoint
        # here must not stall every other writer's append.
        faults.hit("store.after_index_append")
        if self._registry is not None:
            self._registry.observe(obs_names.HIST_STORE_WRITE_SECONDS,
                                   time.monotonic() - t0)
        return entry

    def put_many(self, chunks: list[Chunk]) -> list[IndexEntry]:
        """Group-commit a batch: blob writes first, then ONE index append.

        Same ordering guarantee as :meth:`save` (blobs before index, so a
        crash orphans blobs rather than dangling entries), but the index
        entries for the whole batch are concatenated into a single
        ``append_index`` call — one write + one optional fsync per batch,
        and a single atomic commit point: a crash before the append loses
        the whole batch's entries (tiles are re-granted), never a torn
        subset interleaved with other writers.
        """
        if not chunks:
            return []
        t0 = time.monotonic()
        entries: list[IndexEntry] = []
        for chunk in chunks:
            if chunk.is_never:
                entries.append(IndexEntry(*chunk.key, EntryType.NEVER))
            elif chunk.is_immediate:
                entries.append(IndexEntry(*chunk.key, EntryType.IMMEDIATE))
            else:
                filename = self._generate_filename(chunk)
                payload = chunk.serialize()
                with self._file_lock(filename):
                    faults.hit("store.before_chunk_write")
                    self.backend.put_blob(filename, payload)
                faults.hit("store.after_chunk_write")
                entries.append(
                    IndexEntry(*chunk.key, EntryType.REGULAR, filename))
                self._cache_payload(chunk.key, payload)
        with self._index_lock:
            self.backend.append_index(
                b"".join(e.to_bytes() for e in entries),
                fsync=self._fsync_index)
        faults.hit("store.after_index_append")  # see save(): post-commit
        if self._registry is not None:
            self._registry.observe(obs_names.HIST_STORE_WRITE_SECONDS,
                                   time.monotonic() - t0)
            self._registry.inc(obs_names.STORE_GROUP_COMMITS)
            self._registry.inc(obs_names.STORE_FLUSH_TILES, len(entries))
        return entries

    # -- read path --------------------------------------------------------

    def entries(self) -> list[IndexEntry]:
        with self._index_lock:
            data = self.backend.read_index()
        return list(scan_entries(io.BytesIO(data)))

    def index_offset(self) -> int:
        """Logical end offset of the index — the replay high-water mark a
        checkpoint records so restore can scan only the suffix."""
        with self._index_lock:
            return self.backend.index_size()

    def entries_from(self, offset: int) -> list[IndexEntry]:
        """Entries wholly past logical ``offset`` (the checkpointed
        prefix is already accounted; only the suffix needs replaying)."""
        with self._index_lock:
            data = self.backend.read_index(offset)
        return list(scan_entries(io.BytesIO(data)))

    def completed_keys(self, levels: Optional[Iterable[int]] = None
                       ) -> set[tuple[int, int, int]]:
        """Replay the index into a set of completed tile keys (resume path)."""
        level_filter = set(levels) if levels is not None else None
        keys: set[tuple[int, int, int]] = set()
        for entry in self.entries():
            if level_filter is None or entry.level in level_filter:
                keys.add(entry.key)
        return keys

    def load_many(self, keys: list[tuple[int, int, int]]
                  ) -> list[Optional[Chunk]]:
        """Load several chunks in one index scan; None where absent."""
        wanted = {key: i for i, key in enumerate(keys)}
        found: dict[tuple[int, int, int], IndexEntry] = {}
        for entry in self.entries():
            if entry.key in wanted:
                found[entry.key] = entry  # last entry wins
        out: list[Optional[Chunk]] = [None] * len(keys)
        for key, entry in found.items():
            out[wanted[key]] = self._entry_to_chunk(entry)
        return out

    def load(self, level: int, index_real: int, index_imag: int
             ) -> Optional[Chunk]:
        return self.load_many([(level, index_real, index_imag)])[0]

    def load_payload(self, level: int, index_real: int, index_imag: int
                     ) -> Optional[bytes]:
        """Serialized payload (code byte + body) for a chunk, LRU-cached.

        This is what the read-side server sends; caching skips the
        decode/re-encode round trip per request.
        """
        key = (level, index_real, index_imag)
        with self._cache_lock:
            if key in self._payload_cache:
                self._payload_cache.move_to_end(key)
                return self._payload_cache[key]
        # Only the miss path is timed: it is the index scan + file read +
        # re-encode an operator tunes the payload LRU to avoid.
        t0 = time.monotonic()
        chunk = self.load(level, index_real, index_imag)
        if chunk is not None and self._registry is not None:
            self._registry.observe(obs_names.HIST_STORE_READ_SECONDS,
                                   time.monotonic() - t0)
        if chunk is None:
            return None
        payload = chunk.serialize()
        self._cache_payload(key, payload)
        return payload

    def _cache_payload(self, key: tuple[int, int, int],
                       payload: bytes) -> None:
        if self._payload_cache_size <= 0:
            return
        with self._cache_lock:
            self._payload_cache[key] = payload
            self._payload_cache.move_to_end(key)
            while len(self._payload_cache) > self._payload_cache_size:
                self._payload_cache.popitem(last=False)

    def _entry_to_chunk(self, entry: IndexEntry) -> Chunk:
        if entry.type == EntryType.NEVER:
            return Chunk.never(*entry.key)
        if entry.type == EntryType.IMMEDIATE:
            return Chunk.immediate(*entry.key)
        with self._file_lock(entry.filename):
            payload = self.backend.get_blob(entry.filename)
        if payload is None:
            raise FileNotFoundError(
                f"chunk blob {entry.filename!r} referenced by the index "
                f"is missing from {self.backend.describe()}")
        data = Chunk.deserialize_data(payload)
        if data.size != CHUNK_PIXELS:
            raise ValueError(
                f"chunk file {entry.filename} decodes to {data.size} pixels")
        return Chunk(*entry.key, data)


def compact(parent_dir: str = "", *, remove_orphans: bool = True,
            fsync: bool = True) -> dict:
    """Rewrite ``Data/_index.dat`` with one (last-wins) entry per tile
    and optionally delete chunk files no surviving entry references.

    The reference's index is append-only by design (``DataStorage.cs``
    has no compaction; duplicate entries accumulate on re-saves and old
    chunk-file versions linger via collision suffixing) — fine for a
    run, unbounded for a long-lived farm.  Offline maintenance over the
    local-file layout (object-store layouts rotate their own segments):

    - claims EVERY level present in the index via the flock ownership
      locks, so running against a live coordinator fails loudly instead
      of racing its appends;
    - last entry per tile key wins (the store's own read rule);
    - the new index is written to a temp file and atomically renamed,
      with the directory fsynced, so a crash leaves either the old or
      the new index — never a torn one;
    - orphan removal only touches files matching the chunk-name pattern
      ``level;re;im[suffix]`` for tiles the index knows, never foreign
      files.

    Returns a stats dict: entries before/after, orphans removed, bytes
    reclaimed from the index.
    """
    import os
    import re as _re

    from distributedmandelbrot_tpu_torch.storage.ownership import LevelClaims

    probe = os.path.join(parent_dir, DATA_DIR_NAME, INDEX_FILENAME)
    if not os.path.exists(probe):
        # A maintenance command must not scaffold a farm out of a typo'd
        # path (ChunkStore.setup would create Data/ and an empty index,
        # masking the mistake as 'compacted: 0 -> 0').
        raise DataDirError(f"no tile index at {probe!r}; nothing to "
                           "compact (check -o)")
    store = ChunkStore(parent_dir)
    # Size BEFORE reading entries: an append landing between the two is
    # then included in the final-size comparison (conservative abort),
    # never silently dropped by the rewrite.
    size_at_read = os.path.getsize(store.index_path)
    entries = store.entries()
    if not entries:
        # Nothing to compact — and rewriting an empty index beside a
        # just-started coordinator (no entries yet, so no levels to
        # claim) could drop its first concurrent append.
        return {"entries_before": 0, "entries_after": 0,
                "orphans_removed": 0,
                "index_bytes": os.path.getsize(store.index_path)}
    levels = sorted({e.level for e in entries})
    claims = LevelClaims(store.data_dir, levels)
    try:
        last: dict[tuple[int, int, int], IndexEntry] = {}
        for e in entries:
            last[e.key] = e
        kept = [last[k] for k in sorted(last)]
        tmp = store.index_path + ".compact"
        with open(tmp, "wb") as f:
            for e in kept:
                f.write(e.to_bytes())
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        # The level claims exclude coordinators serving the levels we
        # read; a coordinator serving a level NOT yet in the index could
        # still append concurrently.  Last-moment growth check narrows
        # that window to microseconds and fails loudly instead of
        # silently dropping the newcomer's entries.
        if os.path.getsize(store.index_path) != size_at_read:
            os.unlink(tmp)
            raise RuntimeError(
                "index grew during compaction; a coordinator appears to "
                "be running on this data directory — stop it first")
        os.replace(tmp, store.index_path)
        if fsync:
            dir_fd = os.open(store.data_dir, os.O_RDONLY)
            try:
                os.fsync(dir_fd)
            finally:
                os.close(dir_fd)

        removed = 0
        if remove_orphans:
            referenced = {e.filename for e in kept if e.filename}
            # Chunk files are all-digit 'level;re;im[suffix]' names (the
            # suffix is indistinguishable from trailing index digits);
            # '.tmp' leftovers are saves that crashed before their
            # rename — safe to sweep under the level claims.
            pat = _re.compile(r"^\d+;\d+;\d+(\.tmp)?$")
            for name in os.listdir(store.data_dir):
                if name in referenced or not pat.match(name):
                    continue
                try:
                    os.unlink(os.path.join(store.data_dir, name))
                    removed += 1
                except OSError:
                    pass
        before = len(entries)
        return {"entries_before": before, "entries_after": len(kept),
                "orphans_removed": removed,
                "index_bytes": os.path.getsize(store.index_path)}
    finally:
        claims.release()
