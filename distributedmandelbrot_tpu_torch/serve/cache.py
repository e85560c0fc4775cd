"""Tier-1 decoded-tile cache in front of the store's byte-payload LRU.

The store already keeps a serialized-payload LRU (:class:`ChunkStore`'s
``load_payload`` cache) so hot reads skip the index scan + file read +
re-encode.  The gateway adds a second, richer tier on top of it: an LRU of
:class:`CachedTile` entries holding the wire payload *and* (lazily) the
decoded pixel array, keyed like the store on ``(level, index_real,
index_imag)``.  A tier-1 hit serves a query with zero store traffic; a
tier-1 miss that the store satisfies *promotes* the payload into tier 1.

Promotion is also where cold raw payloads get one shot at the wire-RLE
win: a payload stored with the Raw codec (legacy raw-only data dirs —
this repo's own save path already picks the smallest codec) runs the
RLE ``estimate_ratio`` heuristic and is re-encoded before it enters the
cache when RLE clearly wins, so every later hit ships the small body.

:class:`RenderedTileCache` is the third tier: colormapped palette-PNG
bodies keyed by ``(level, index_real, index_imag, colormap_id)`` — a hot
rendered tile ships ~50-200 KB instead of the 16 MiB escape payload.

Every movement is counted through :class:`~distributedmandelbrot_tpu_torch.utils.
metrics.Counters` (``tile_cache_hits`` / ``tile_cache_misses`` /
``tile_cache_evictions`` / ``tile_cache_promotions``) so the serving bench
and the load-shed policy can see the cache working.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

import numpy as np

from distributedmandelbrot_tpu_torch import codecs
from distributedmandelbrot_tpu_torch.codecs.base import RAW_CODE
from distributedmandelbrot_tpu_torch.codecs.rle import estimate_ratio
from distributedmandelbrot_tpu_torch.core.chunk import Chunk
from distributedmandelbrot_tpu_torch.obs import names as obs_names
from distributedmandelbrot_tpu_torch.storage.store import ChunkStore
from distributedmandelbrot_tpu_torch.utils.metrics import Counters

Key = tuple[int, int, int]
RenderKey = tuple[int, int, int, int]


class CachedTile:
    """One resident tile: the wire payload, pixels decoded on first use."""

    __slots__ = ("payload", "_pixels", "_decode_lock")

    def __init__(self, payload: bytes) -> None:
        self.payload = payload
        self._pixels: Optional[np.ndarray] = None
        self._decode_lock = threading.Lock()

    @property
    def pixels(self) -> np.ndarray:
        """Decoded flat uint8 pixels, cached after the first decode."""
        with self._decode_lock:
            if self._pixels is None:
                self._pixels = Chunk.deserialize_data(self.payload)
                self._pixels.setflags(write=False)
            return self._pixels


class DecodedTileCache:
    """LRU of :class:`CachedTile` over a :class:`ChunkStore`.

    Thread-safe: the gateway's event loop reads inline while store lookups
    run on worker threads.  ``capacity`` is in tiles (payloads are codec-
    compressed, so byte-exact accounting would punish exactly the cheap
    Never/Immediate tiles worth keeping resident).
    """

    def __init__(self, store: ChunkStore, *, capacity: int = 64,
                 recompress_min_ratio: float = 2.0,
                 counters: Optional[Counters] = None) -> None:
        self.store = store
        self.capacity = capacity
        # Minimum estimated RLE ratio before a cold raw payload is
        # re-encoded on promotion; <= 0 disables the recompression pass.
        self.recompress_min_ratio = recompress_min_ratio
        self.counters = counters if counters is not None else Counters()
        self._entries: OrderedDict[Key, CachedTile] = OrderedDict()
        self._lock = threading.Lock()
        # Live hit-ratio gauges, derived from the movement counters at
        # scrape time (callback gauges — nothing to update per request).
        registry = self.counters.registry

        def _ratio(hit_name: str, miss_name: str) -> float:
            hits = registry.counter_value(hit_name) or 0
            misses = registry.counter_value(miss_name) or 0
            total = hits + misses
            return hits / total if total else 0.0

        registry.gauge(
            obs_names.GAUGE_TIER1_HIT_RATIO,
            help="decoded-tile LRU hits / lookups",
            fn=lambda: _ratio(obs_names.TILE_CACHE_HITS,
                              obs_names.TILE_CACHE_MISSES))
        registry.gauge(
            obs_names.GAUGE_TIER2_HIT_RATIO,
            help="store (payload LRU + disk) hits / tier-1 misses",
            fn=lambda: _ratio(obs_names.TILE_CACHE_PROMOTIONS,
                              obs_names.TILE_CACHE_STORE_MISSES))

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- tier 1 (no I/O) --------------------------------------------------

    def get_cached(self, key: Key) -> Optional[CachedTile]:
        """Tier-1 lookup only; never touches the store."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.counters.inc("tile_cache_misses")
                return None
            self._entries.move_to_end(key)
            self.counters.inc("tile_cache_hits")
            return entry

    def contains(self, key: Key) -> bool:
        """Residency peek for planners: no promotion, no LRU bump, and —
        unlike :meth:`get_cached` — no hit/miss accounting, so probing
        does not skew the tier-1 ratio gauge."""
        with self._lock:
            return key in self._entries

    def invalidate(self, key: Key) -> bool:
        """Drop a tile so the next read re-reads the store.

        Called when a deeper-``max_iter`` variant of the tile persists:
        the store's payload LRU is refreshed by the save itself, but an
        entry here would keep serving the stale shallow pixels.  Not a
        miss — nothing was looked up.
        """
        with self._lock:
            if self._entries.pop(key, None) is None:
                return False
        self.counters.inc(obs_names.TILE_CACHE_INVALIDATIONS)
        return True

    def put(self, key: Key, payload: bytes) -> CachedTile:
        """Insert/refresh a tile, evicting LRU entries past capacity."""
        entry = CachedTile(payload)
        if self.capacity <= 0:
            return entry
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.counters.inc("tile_cache_evictions")
        return entry

    # -- tier 1 -> tier 2 (store; blocking I/O) ---------------------------

    def load(self, key: Key) -> Optional[CachedTile]:
        """Tier-1 lookup, falling through to the store (payload LRU, then
        disk) and promoting what it finds.  Blocking — call off-loop."""
        entry = self.get_cached(key)
        if entry is not None:
            return entry
        payload = self.store.load_payload(*key)
        if payload is None:
            self.counters.inc(obs_names.TILE_CACHE_STORE_MISSES)
            return None
        self.counters.inc("tile_cache_promotions")
        return self.put(key, self._maybe_recompress(payload))

    def _maybe_recompress(self, payload: bytes) -> bytes:
        """Re-encode a raw-codec payload to RLE when the estimate says the
        wire win is clear (>= ``recompress_min_ratio``).

        Runs once per promotion, on the store-read thread, so the cost
        (a strided histogram, plus one boundary pass only for plausible
        tiles) is paid off-loop and only on cold fetches.  Payloads this
        repo saved are already pick-smallest encoded; this path is for
        data dirs written by raw-only writers (the reference's early
        builds).
        """
        if self.recompress_min_ratio <= 0 or not payload \
                or payload[0] != RAW_CODE:
            return payload
        pixels = np.frombuffer(payload, dtype=np.uint8, offset=1)
        if estimate_ratio(pixels,
                          self.recompress_min_ratio) < self.recompress_min_ratio:
            self.counters.inc(obs_names.SERVE_RLE_SKIPPED)
            return payload
        body = codecs.RLE.encode(pixels)
        recoded = bytes([codecs.RLE.code]) + body
        if len(recoded) >= len(payload):
            # The estimate was optimistic; keep the bytes we trust.
            self.counters.inc(obs_names.SERVE_RLE_SKIPPED)
            return payload
        self.counters.inc(obs_names.SERVE_RLE_RECOMPRESSIONS)
        self.counters.inc(obs_names.SERVE_RLE_BYTES_SAVED,
                          len(payload) - len(recoded))
        return recoded


class RenderedTileCache:
    """Tier-3 LRU of rendered palette-PNG bodies.

    Keyed by ``(level, index_real, index_imag, colormap_id)`` — the same
    tile rendered under two colormaps is two entries.  Thread-safe like
    the decoded-tile tier (the gateway's loop reads inline while renders
    happen on worker threads); ``capacity`` is in entries, since bodies
    are already deflate-compressed and roughly uniform for a workload.
    """

    def __init__(self, *, capacity: int = 64,
                 counters: Optional[Counters] = None) -> None:
        self.capacity = capacity
        self.counters = counters if counters is not None else Counters()
        self._entries: OrderedDict[RenderKey, bytes] = OrderedDict()
        self._lock = threading.Lock()
        registry = self.counters.registry

        def _hit_ratio() -> float:
            hits = registry.counter_value(
                obs_names.GATEWAY_RENDER_CACHE_HITS) or 0
            misses = registry.counter_value(
                obs_names.GATEWAY_RENDER_CACHE_MISSES) or 0
            total = hits + misses
            return hits / total if total else 0.0

        registry.gauge(obs_names.GAUGE_RENDER_HIT_RATIO,
                       help="rendered-tile LRU hits / lookups",
                       fn=_hit_ratio)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, key: RenderKey) -> Optional[bytes]:
        with self._lock:
            body = self._entries.get(key)
            if body is None:
                self.counters.inc(obs_names.GATEWAY_RENDER_CACHE_MISSES)
                return None
            self._entries.move_to_end(key)
            self.counters.inc(obs_names.GATEWAY_RENDER_CACHE_HITS)
            return body

    def put(self, key: RenderKey, body: bytes) -> bytes:
        if self.capacity <= 0:
            return body
        with self._lock:
            self._entries[key] = body
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.counters.inc(obs_names.GATEWAY_RENDER_CACHE_EVICTIONS)
        return body

    def invalidate_tile(self, key: Key) -> int:
        """Drop every colormap variant of one tile (a deeper-``max_iter``
        variant persisted; cached PNGs render the stale shallow pixels).
        Returns how many entries went."""
        level, index_real, index_imag = key
        with self._lock:
            stale = [k for k in self._entries
                     if k[0] == level and k[1] == index_real
                     and k[2] == index_imag]
            for k in stale:
                del self._entries[k]
        if stale:
            self.counters.inc(obs_names.GATEWAY_RENDER_CACHE_INVALIDATIONS,
                              len(stale))
        return len(stale)
