"""Pluggable store backends: where the index log and chunk blobs live.

The store's durable state is exactly two things — an append-only index
log (the resume mechanism, ``storage/index.py``) and a namespace of
immutable chunk blobs — so that is the whole backend interface:
:class:`StoreBackend` is append-log segment ops plus blob put/get/list,
and :class:`~distributedmandelbrot_tpu_torch.storage.store.ChunkStore` holds
every policy above it (entry format, filenames, caching, locking).

Two layouts:

- :class:`LocalFileBackend` — byte-compatible with the layout the
  reference wrote (``DataStorage.cs``): ``Data/_index.dat`` plus
  ``level;re;im`` chunk files beside it.  A data directory written by
  any earlier build reads back unchanged.
- :class:`ObjectStoreBackend` — an object-store-shaped layout for the
  deployment the Julia-to-Cloud-TPU paper assumes (no rename, no
  append, atomic single-key PUT): a flat immutable keyspace under
  ``blobs/``, the index as rotated log segments under ``index/``
  (one small tail object per append, periodically merged into sealed
  segments), and an atomic ``index/manifest`` JSON naming the sealed
  segments in order.  Every operation maps 1:1 onto GCS/S3 primitives
  (PUT / GET / LIST / DELETE); the bundled :class:`MemoryObjectStore`
  and :class:`DirObjectStore` fakes back it for tests and benches.

Logical index offsets: both backends address the log by a cumulative
byte offset in read order, so a checkpoint can record a high-water mark
and a restore can replay only the suffix past it regardless of how the
bytes are physically segmented.
"""

from __future__ import annotations

import abc
import json
import os
import threading
from typing import Optional

INDEX_FILENAME = "_index.dat"
DATA_DIR_NAME = "Data"


class DataDirError(OSError):
    """The backing location cannot be created or written (clean CLI error;
    reference: the pre-start writability probe, ``Program.cs:159-176``)."""


class StoreBackend(abc.ABC):
    """Durable home of one store: an append log plus immutable blobs."""

    # -- lifecycle --------------------------------------------------------

    @abc.abstractmethod
    def setup(self) -> None:
        """Create the backing location and probe writability.

        Raises :class:`DataDirError` on an uncreatable/unwritable home.
        """

    @abc.abstractmethod
    def describe(self) -> str:
        """Human-readable location (logs, error messages)."""

    # -- append log (the tile index) --------------------------------------

    @abc.abstractmethod
    def append_index(self, data: bytes, *, fsync: bool = False) -> int:
        """Append ``data`` to the log; returns the end offset after it."""

    @abc.abstractmethod
    def index_size(self) -> int:
        """Current logical size of the log in bytes."""

    @abc.abstractmethod
    def read_index(self, offset: int = 0) -> bytes:
        """The log's bytes from logical ``offset`` to its end."""

    @abc.abstractmethod
    def truncate_index(self, size: int) -> None:
        """Discard log bytes past logical ``size`` (torn-tail repair)."""

    # -- immutable blobs (chunk payloads, checkpoints) --------------------

    @abc.abstractmethod
    def put_blob(self, name: str, data: bytes, *, fsync: bool = False
                 ) -> None:
        """Durably write ``name`` in one atomic step (PUT semantics)."""

    @abc.abstractmethod
    def get_blob(self, name: str) -> Optional[bytes]:
        """Blob contents, or None when absent."""

    @abc.abstractmethod
    def blob_exists(self, name: str) -> bool: ...

    @abc.abstractmethod
    def list_blobs(self) -> list[str]: ...

    def peek_blob(self, name: str, n: int) -> Optional[bytes]:
        """First ``n`` bytes of a blob (header sniffing), or None."""
        data = self.get_blob(name)
        return None if data is None else data[:n]


# -- local files (the reference's layout) ---------------------------------


class LocalFileBackend(StoreBackend):
    """``parent_dir/Data/`` with ``_index.dat`` + chunk files beside it.

    Byte-compatible with the layout every earlier build (and the C#
    reference) wrote: same directory, same index file, blobs are plain
    files named by the caller.  Blob puts go through a same-directory
    temp file and ``os.replace`` so a reader never sees a half-written
    chunk and a crash leaves at worst a ``.tmp`` orphan.
    """

    def __init__(self, parent_dir: str = "", *, namespace: str = "") -> None:
        # ``namespace`` isolates the append log of one coordinator shard
        # sharing the directory with others (``_index-s0of4.dat``); the
        # blob namespace stays shared — ring ownership is disjoint, so
        # shards never write the same chunk name.
        self.data_dir = os.path.join(parent_dir, DATA_DIR_NAME)
        self.namespace = namespace
        index_name = INDEX_FILENAME if not namespace else \
            f"_index{namespace}.dat"
        self.index_path = os.path.join(self.data_dir, index_name)

    def describe(self) -> str:
        return self.data_dir

    def _path(self, name: str) -> str:
        return os.path.join(self.data_dir, name)

    def setup(self) -> None:
        try:
            os.makedirs(self.data_dir, exist_ok=True)
        except (OSError, ValueError) as e:
            # NotADirectoryError/FileExistsError: the path (or a parent)
            # is occupied by a file; PermissionError: unwritable parent.
            raise DataDirError(
                f"cannot create data directory {self.data_dir!r}: "
                f"{e}") from e
        probe = os.path.join(self.data_dir,
                             f"_writable_probe_{os.getpid()}.tmp")
        try:
            with open(probe, "wb") as f:
                f.write(b"probe")
            os.unlink(probe)
        except OSError as e:
            raise DataDirError(
                f"data directory {self.data_dir!r} is not writable: "
                f"{e}") from e
        if not os.path.exists(self.index_path):
            with open(self.index_path, "wb"):
                pass

    # -- append log -------------------------------------------------------

    def append_index(self, data: bytes, *, fsync: bool = False) -> int:
        with open(self.index_path, "ab") as f:
            f.write(data)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
            return f.tell()

    def index_size(self) -> int:
        return os.path.getsize(self.index_path)

    def read_index(self, offset: int = 0) -> bytes:
        with open(self.index_path, "rb") as f:
            if offset:
                f.seek(offset)
            return f.read()

    def truncate_index(self, size: int) -> None:
        with open(self.index_path, "r+b") as f:
            f.truncate(size)
            os.fsync(f.fileno())

    # -- blobs ------------------------------------------------------------

    def put_blob(self, name: str, data: bytes, *, fsync: bool = False
                 ) -> None:
        tmp = self._path(name) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, self._path(name))

    def get_blob(self, name: str) -> Optional[bytes]:
        try:
            with open(self._path(name), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def peek_blob(self, name: str, n: int) -> Optional[bytes]:
        try:
            with open(self._path(name), "rb") as f:
                return f.read(n)
        except FileNotFoundError:
            return None

    def blob_exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))

    def list_blobs(self) -> list[str]:
        # Every per-shard index log is backend-internal, like
        # INDEX_FILENAME itself — never a blob.
        return sorted(
            name for name in os.listdir(self.data_dir)
            if not name.startswith("_index") and not name.endswith(".tmp"))


# -- object-store kv fakes ------------------------------------------------


class ObjectStore(abc.ABC):
    """The five primitives GCS/S3 give you: atomic PUT, GET, HEAD-ish
    size, LIST-by-prefix, DELETE.  No append, no rename — everything the
    :class:`ObjectStoreBackend` layout is built around."""

    @abc.abstractmethod
    def put(self, key: str, data: bytes, *, fsync: bool = False) -> None: ...

    @abc.abstractmethod
    def get(self, key: str) -> Optional[bytes]: ...

    @abc.abstractmethod
    def size(self, key: str) -> Optional[int]: ...

    @abc.abstractmethod
    def list(self, prefix: str = "") -> list[str]: ...

    @abc.abstractmethod
    def delete(self, key: str) -> None: ...

    def exists(self, key: str) -> bool:
        return self.size(key) is not None

    def describe(self) -> str:
        return type(self).__name__


class MemoryObjectStore(ObjectStore):
    """In-memory kv fake — the unit-test double for a bucket."""

    def __init__(self) -> None:
        self._objects: dict[str, bytes] = {}
        self._lock = threading.Lock()

    def put(self, key: str, data: bytes, *, fsync: bool = False) -> None:
        with self._lock:
            self._objects[key] = bytes(data)

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._objects.get(key)

    def size(self, key: str) -> Optional[int]:
        with self._lock:
            data = self._objects.get(key)
            return None if data is None else len(data)

    def list(self, prefix: str = "") -> list[str]:
        with self._lock:
            return sorted(k for k in self._objects if k.startswith(prefix))

    def delete(self, key: str) -> None:
        with self._lock:
            self._objects.pop(key, None)


class DirObjectStore(ObjectStore):
    """Directory-backed kv fake: keys become paths, ``/`` nests.

    PUT is temp-file + ``os.replace`` in the destination directory, so
    every object appears atomically — the invariant the object-store
    layout leans on instead of file appends.
    """

    def __init__(self, root: str) -> None:
        self.root = root

    def describe(self) -> str:
        return self.root

    def _path(self, key: str) -> str:
        # Keys are backend-internal ("index/tail-...", "blobs/4;1;2"):
        # forward slashes nest, nothing may escape the root.
        if key.startswith("/") or ".." in key.split("/"):
            raise ValueError(f"bad object key {key!r}")
        return os.path.join(self.root, *key.split("/"))

    def put(self, key: str, data: bytes, *, fsync: bool = False) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)

    def get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def size(self, key: str) -> Optional[int]:
        try:
            return os.path.getsize(self._path(key))
        except OSError:
            return None

    def list(self, prefix: str = "") -> list[str]:
        out: list[str] = []
        for dirpath, _dirnames, filenames in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            for name in filenames:
                if name.endswith(".tmp"):
                    continue
                key = name if rel == "." else \
                    "/".join(rel.split(os.sep) + [name])
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass


# -- object-store layout --------------------------------------------------

_TAIL_PREFIX = "index/tail-"
_SEG_PREFIX = "index/seg-"
_MANIFEST_KEY = "index/manifest"
_BLOB_PREFIX = "blobs/"
_MANIFEST_FORMAT = 1


class ObjectStoreBackend(StoreBackend):
    """Index log + blobs over five object-store primitives.

    Layout (flat keyspace, every object immutable once read):

    - ``blobs/<name>`` — chunk payloads and checkpoints, one PUT each;
    - ``index/tail-<seq>`` — one object per index append (object stores
      cannot append, so the log's tail is a run of tiny objects);
    - ``index/seg-<n>`` — sealed segments: every ``rotate_threshold``
      appends the tail run is merged into one segment object;
    - ``index/manifest`` — JSON naming the sealed segments in order plus
      the tail floor, PUT atomically *after* its segment exists, so a
      crash mid-rotation leaves the previous manifest + the still-live
      tail objects — never a torn log.

    Readers order the log as manifest segments then tail objects with
    ``seq > tail_floor`` (discovered by LIST); merged tails are deleted
    only after the manifest lands, so rotation is crash-safe at every
    step.  Logical offsets are cumulative bytes in that read order.
    """

    def __init__(self, kv: ObjectStore, *, rotate_threshold: int = 256,
                 namespace: str = "") -> None:
        if rotate_threshold < 1:
            raise ValueError("rotate_threshold must be >= 1")
        self.kv = kv
        self.rotate_threshold = rotate_threshold
        # ``namespace`` isolates one shard's index log in a shared
        # bucket (``index-s0of4/...``); blobs stay shared — ring
        # ownership is disjoint, so shards never write the same name.
        self.namespace = namespace
        self._tail_prefix = f"index{namespace}/tail-"
        self._seg_prefix = f"index{namespace}/seg-"
        self._manifest_key = f"index{namespace}/manifest"
        # Re-entrant: append_index rotates and setup loads under the
        # lock, and both helpers take it again for their own mutations.
        self._lock = threading.RLock()
        self._sealed: list[tuple[str, int]] = []  # (key, size), log order
        self._sealed_bytes = 0
        self._tails: list[tuple[int, int]] = []  # (seq, size), log order
        self._tail_floor = 0  # highest seq merged into a sealed segment
        self._next_seq = 1

    def describe(self) -> str:
        return f"object-store:{self.kv.describe()}"

    def _tail_key(self, seq: int) -> str:
        return f"{self._tail_prefix}{seq:012d}"

    def setup(self) -> None:
        probe_key = f"meta/_writable_probe_{os.getpid()}"
        try:
            self.kv.put(probe_key, b"probe")
            self.kv.delete(probe_key)
        except OSError as e:
            raise DataDirError(
                f"object store {self.kv.describe()!r} is not writable: "
                f"{e}") from e
        with self._lock:
            self._load_state()

    def _load_state(self) -> None:
        with self._lock:  # re-entrant under setup()'s hold
            self._sealed = []
            self._sealed_bytes = 0
            self._tail_floor = 0
            raw = self.kv.get(self._manifest_key)
            if raw is not None:
                manifest = json.loads(raw.decode("utf-8"))
                if manifest.get("format") != _MANIFEST_FORMAT:
                    raise DataDirError(
                        f"unsupported index manifest format "
                        f"{manifest.get('format')!r} in "
                        f"{self.kv.describe()!r}")
                self._sealed = [(key, int(size))
                                for key, size in manifest["sealed"]]
                self._sealed_bytes = sum(size for _, size in self._sealed)
                self._tail_floor = int(manifest["tail_floor"])
            self._tails = []
            for key in self.kv.list(self._tail_prefix):
                seq = int(key[len(self._tail_prefix):])
                if seq <= self._tail_floor:
                    continue  # merged into segment; deletion never finished
                size = self.kv.size(key)
                if size is not None:
                    self._tails.append((seq, size))
            self._tails.sort()
            self._next_seq = max([self._tail_floor]
                                 + [seq for seq, _ in self._tails]) + 1

    # -- append log -------------------------------------------------------

    def append_index(self, data: bytes, *, fsync: bool = False) -> int:
        with self._lock:
            seq = self._next_seq
            self.kv.put(self._tail_key(seq), data, fsync=fsync)
            self._next_seq += 1
            self._tails.append((seq, len(data)))
            if len(self._tails) >= self.rotate_threshold:
                self._rotate(fsync=fsync)
            return self._sealed_bytes + sum(s for _, s in self._tails)

    def _rotate(self, *, fsync: bool) -> None:
        """Merge the tail run into one sealed segment (re-entrant under
        append_index's hold)."""
        with self._lock:
            merged = b"".join(
                self.kv.get(self._tail_key(seq)) or b""
                for seq, _ in self._tails)
            seg_key = f"{self._seg_prefix}{len(self._sealed):08d}"
            self.kv.put(seg_key, merged, fsync=fsync)
            sealed = self._sealed + [(seg_key, len(merged))]
            floor = self._tails[-1][0]
            manifest = {"format": _MANIFEST_FORMAT,
                        "sealed": [[k, s] for k, s in sealed],
                        "tail_floor": floor}
            # The manifest PUT is the commit point: before it, readers see
            # the old manifest + live tails; after it, the new segment.
            # Tail deletion is garbage collection — a crash here just
            # leaves objects the floor tells every reader to skip.
            self.kv.put(self._manifest_key,
                        json.dumps(manifest, sort_keys=True).encode("utf-8"),
                        fsync=fsync)
            old_tails = self._tails
            self._sealed = sealed
            self._sealed_bytes += len(merged)
            self._tail_floor = floor
            self._tails = []
            for seq, _ in old_tails:
                self.kv.delete(self._tail_key(seq))

    def index_size(self) -> int:
        with self._lock:
            return self._sealed_bytes + sum(s for _, s in self._tails)

    def read_index(self, offset: int = 0) -> bytes:
        with self._lock:
            pieces = [(key, size) for key, size in self._sealed]
            pieces += [(self._tail_key(seq), size)
                       for seq, size in self._tails]
        out: list[bytes] = []
        skip = offset
        for key, size in pieces:
            if skip >= size:
                skip -= size
                continue
            data = self.kv.get(key)
            if data is None:
                raise DataDirError(
                    f"index object {key!r} vanished from "
                    f"{self.kv.describe()!r}")
            out.append(data[skip:])
            skip = 0
        return b"".join(out)

    def truncate_index(self, size: int) -> None:
        # Object PUTs are atomic, so a torn tail cannot occur in this
        # layout; repair is still honored for interface parity (property
        # tests drive both backends through the same sequences).
        with self._lock:
            if size < self._sealed_bytes:
                raise ValueError(
                    f"cannot truncate into sealed segments "
                    f"({size} < {self._sealed_bytes})")
            keep = size - self._sealed_bytes
            kept: list[tuple[int, int]] = []
            for seq, tail_size in self._tails:
                if keep >= tail_size:
                    kept.append((seq, tail_size))
                    keep -= tail_size
                elif keep > 0:
                    data = self.kv.get(self._tail_key(seq)) or b""
                    self.kv.put(self._tail_key(seq), data[:keep])
                    kept.append((seq, keep))
                    keep = 0
                else:
                    self.kv.delete(self._tail_key(seq))
            self._tails = kept

    # -- blobs ------------------------------------------------------------

    def put_blob(self, name: str, data: bytes, *, fsync: bool = False
                 ) -> None:
        self.kv.put(_BLOB_PREFIX + name, data, fsync=fsync)

    def get_blob(self, name: str) -> Optional[bytes]:
        return self.kv.get(_BLOB_PREFIX + name)

    def blob_exists(self, name: str) -> bool:
        return self.kv.exists(_BLOB_PREFIX + name)

    def list_blobs(self) -> list[str]:
        return [key[len(_BLOB_PREFIX):]
                for key in self.kv.list(_BLOB_PREFIX)]
