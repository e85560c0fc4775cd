"""Append-only tile index: the system's durable checkpoint.

Every accepted tile is recorded by appending an entry to ``_index.dat``; on
restart the coordinator replays the index to rebuild its completed set, so
the index *is* the resume mechanism (reference: ``DataStorage.cs:10-13,
358-387,187-225``; resume seeding ``Distributer.cs:165-175``).

Entry wire format (byte-compatible with the reference — note the comment in
the reference claims the type is uint8 but the code writes **int32 LE**;
the code is the truth, ``DataStorage.cs:205-206,373-374``):

    level:u32 LE | index_real:u32 LE | index_imag:u32 LE | type:i32 LE
    [ if type == Regular: filename_len:i32 LE | filename:ASCII ]

Entry types: ``Regular`` (pixels live in a chunk file), ``Never`` (all
pixels 0 — tile entirely in-set), ``Immediate`` (all pixels 1).  The
special types collapse a 16 MiB tile to a tag.

Durability fix over the reference: entries are written with a single
``write`` call (not field-by-field) and optionally fsync'd, and the scan
treats a *trailing* torn entry as end-of-log (recoverable) rather than
corrupting the whole index — only a malformed interior entry raises.
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass
from typing import BinaryIO, Iterator, Optional

_FIXED = struct.Struct("<IIIi")
_LEN = struct.Struct("<i")

MAX_FILENAME_LEN = 4096  # sanity bound; real filenames are ~20 chars


class EntryType(enum.IntEnum):
    REGULAR = 0
    NEVER = 1
    IMMEDIATE = 2


class CorruptIndexError(Exception):
    """An interior index entry is malformed (not a recoverable torn tail)."""


@dataclass(frozen=True)
class IndexEntry:
    level: int
    index_real: int
    index_imag: int
    type: EntryType
    filename: Optional[str] = None

    def __post_init__(self) -> None:
        if self.type == EntryType.REGULAR and not self.filename:
            raise ValueError("Regular index entries require a filename")
        if self.type != EntryType.REGULAR and self.filename:
            raise ValueError(f"{self.type.name} entries carry no filename")

    @property
    def key(self) -> tuple[int, int, int]:
        return (self.level, self.index_real, self.index_imag)

    def to_bytes(self) -> bytes:
        head = _FIXED.pack(self.level, self.index_real, self.index_imag,
                           int(self.type))
        if self.type != EntryType.REGULAR:
            return head
        name = self.filename.encode("ascii")
        return head + _LEN.pack(len(name)) + name


class TornEntry(Exception):
    """Internal: entry truncated at end of stream (torn append)."""


def _read_exact(f: BinaryIO, n: int) -> bytes:
    data = f.read(n)
    if len(data) == 0 and n > 0:
        raise EOFError
    if len(data) < n:
        raise TornEntry
    return data


def read_entry(f: BinaryIO) -> IndexEntry:
    """Read one entry at the current stream position.

    Raises ``EOFError`` at a clean end, ``TornEntry`` on a truncated tail,
    ``CorruptIndexError`` on malformed content.
    """
    head = _read_exact(f, _FIXED.size)
    level, index_real, index_imag, type_raw = _FIXED.unpack(head)
    try:
        etype = EntryType(type_raw)
    except ValueError:
        raise CorruptIndexError(
            f"unknown index entry type {type_raw}") from None
    if etype != EntryType.REGULAR:
        return IndexEntry(level, index_real, index_imag, etype)
    try:
        (name_len,) = _LEN.unpack(_read_exact(f, _LEN.size))
    except EOFError:
        raise TornEntry from None
    if not (0 < name_len <= MAX_FILENAME_LEN):
        raise CorruptIndexError(f"implausible filename length {name_len}")
    try:
        name = _read_exact(f, name_len)
    except EOFError:
        raise TornEntry from None
    try:
        filename = name.decode("ascii")
    except UnicodeDecodeError:
        raise CorruptIndexError("non-ASCII filename in index") from None
    return IndexEntry(level, index_real, index_imag, etype, filename)


def scan_entries(f: BinaryIO, *, tolerate_torn_tail: bool = True
                 ) -> Iterator[IndexEntry]:
    """Yield all entries in an index stream.

    A truncated final entry (torn append from a crash mid-write) ends the
    scan cleanly when ``tolerate_torn_tail`` — the preceding entries are
    all durable.  Malformed interior content always raises
    :class:`CorruptIndexError`.
    """
    while True:
        try:
            yield read_entry(f)
        except EOFError:
            return
        except TornEntry:
            # A short read on a regular file only happens at EOF, so a torn
            # entry is by construction the tail.
            if tolerate_torn_tail:
                return
            raise CorruptIndexError("truncated entry at end of index") from None
