"""Durable persistence: append-only tile index + codec'd chunk blobs
over pluggable backends (local files or an object-store layout)."""

from distributedmandelbrot_tpu_torch.storage.backends import (DirObjectStore,
                                                        LocalFileBackend,
                                                        MemoryObjectStore,
                                                        ObjectStore,
                                                        ObjectStoreBackend,
                                                        StoreBackend)
from distributedmandelbrot_tpu_torch.storage.index import (CorruptIndexError,
                                                     EntryType, IndexEntry,
                                                     read_entry, scan_entries)
from distributedmandelbrot_tpu_torch.storage.store import (DATA_DIR_NAME,
                                                     INDEX_FILENAME,
                                                     ChunkStore,
                                                     DataDirError)

__all__ = ["CorruptIndexError", "EntryType", "IndexEntry", "read_entry",
           "scan_entries", "ChunkStore", "DataDirError", "DATA_DIR_NAME",
           "INDEX_FILENAME", "StoreBackend", "LocalFileBackend",
           "ObjectStore", "ObjectStoreBackend", "MemoryObjectStore",
           "DirObjectStore"]
