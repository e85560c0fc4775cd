"""Checkpoint blob wire structs — the on-disk format owned here.

Like the chunk codecs, this module owns one on-disk format in one
place (the wire-literal rule keeps struct formats out of everywhere
else).  The record layout and the encode/decode logic live in
``coordinator/recovery.py``; this module holds only the magic, the
version, and the precompiled :class:`struct.Struct` objects.

Layout (all little-endian, CRC32 trailer over everything before it):

    HEADER:  "DMCP" | version:u32 | generation:u64 | index_offset:u64 |
             cursor_pos:u64 | cursor_done:u8 | pad[3] |
             n_settings:u32 | n_completed:u32 | n_leases:u32 | n_retry:u32
    SETTING: level:u32 | max_iter:u32
    KEY:     level:u32 | re:u32 | im:u32
    LEASE:   level:u32 | re:u32 | im:u32 | max_iter:u32 | remaining:f64
    RETRY:   level:u32 | re:u32 | im:u32 | max_iter:u32
    CRC:     crc32:u32
"""

from __future__ import annotations

import struct

CHECKPOINT_MAGIC = b"DMCP"
CHECKPOINT_VERSION = 1

CHECKPOINT_HEADER = struct.Struct("<4sIQQQB3xIIII")
CHECKPOINT_SETTING = struct.Struct("<II")
CHECKPOINT_KEY = struct.Struct("<III")
CHECKPOINT_LEASE = struct.Struct("<IIIId")
CHECKPOINT_RETRY = struct.Struct("<IIII")
CHECKPOINT_CRC = struct.Struct("<I")
