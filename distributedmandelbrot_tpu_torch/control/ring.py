"""Consistent-hash ring: tile key -> coordinator shard.

The MPI reference (PAPERS.md, arxiv 2007.00745) partitions grant
authority statically by rank — rank ``r`` owns every ``r``-th row —
which couples the partition to the process count and reshuffles
*everything* when a rank is added.  A consistent-hash ring owns the
same decision with two properties that matter for an elastic fleet:

- **determinism**: ownership is a pure function of ``(key, n_shards,
  replicas)`` via BLAKE2b over the packed key bytes — every process
  holding the same ring config (or even just ``K/N``) computes the
  same owner, with no coordination and no RPC on the hot path;
- **stability**: growing N to N+1 moves ~1/(N+1) of the keyspace, so a
  scale-out event invalidates a sliver of in-flight leases instead of
  all of them.

The ring config is a small versioned JSON document (``ring.json``)
naming the shard endpoints in shard-index order::

    {
      "format": 1,
      "version": 3,
      "replicas": 64,
      "shards": [
        {"host": "127.0.0.1", "distributer_port": 59010,
         "dataserver_port": 59011, "gateway_port": 59012},
        ...
      ]
    }

``version`` is the skew detector: it rides the wire in
``RING_REQ``/``RING_INFO``/``REDIRECT`` frames (net/protocol.py) so a
worker holding a stale config learns about it on its first exchange.
Ownership itself depends only on ``len(shards)`` and ``replicas`` —
endpoints can be rewritten (ephemeral ports after a restart) without
remapping any key, which is what lets a chaos run SIGKILL a shard and
bring it back on a fresh port under the same ring version.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import struct
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

Key = tuple[int, int, int]  # (level, index_real, index_imag)

RING_FORMAT = 1
# Virtual nodes per shard.  64 keeps the max/min slice ratio under ~1.3
# for small N while the full point table stays tiny (N*64 u64s).
DEFAULT_REPLICAS = 64

# Deliberately NOT net/protocol's QUERY struct, even though the format
# matches today: this is the frozen hash-domain encoding of a tile key,
# and tying it to the wire layout would silently remap every key (and
# orphan every on-disk shard namespace) the day the wire format changes.
_KEY_PACK = struct.Struct("<III")  # dmtpu: ignore[wire-literal]


class RingConfigError(ValueError):
    """The ring config document fails validation."""


def _hash64(data: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "little")


@dataclass(frozen=True)
class ShardInfo:
    """One shard's endpoints, in ring-config order."""

    host: str
    distributer_port: int
    dataserver_port: int = 0
    gateway_port: int = 0
    # Metrics exporter endpoint (0 = none bound): what the fleet
    # aggregator scrapes; optional so pre-observability ring files keep
    # loading, and ownership never depends on it.
    exporter_port: int = 0

    def to_config(self) -> dict:
        return {"host": self.host,
                "distributer_port": self.distributer_port,
                "dataserver_port": self.dataserver_port,
                "gateway_port": self.gateway_port,
                "exporter_port": self.exporter_port}

    @classmethod
    def from_config(cls, doc: dict) -> "ShardInfo":
        try:
            return cls(host=str(doc["host"]),
                       distributer_port=int(doc["distributer_port"]),
                       dataserver_port=int(doc.get("dataserver_port", 0)),
                       gateway_port=int(doc.get("gateway_port", 0)),
                       exporter_port=int(doc.get("exporter_port", 0)))
        except (KeyError, TypeError, ValueError) as e:
            raise RingConfigError(f"bad shard entry {doc!r}: {e}") from None


class HashRing:
    """Maps tile keys to shard indices; the config is the identity.

    Two rings with the same ``(n_shards, replicas)`` agree on every
    key regardless of endpoints or version — see the module docstring
    for why that is a feature, not an oversight.
    """

    def __init__(self, shards: Sequence[ShardInfo], *, version: int = 1,
                 replicas: int = DEFAULT_REPLICAS) -> None:
        if not shards:
            raise RingConfigError("a ring needs at least one shard")
        if replicas < 1:
            raise RingConfigError(f"replicas {replicas} < 1")
        if version < 1:
            raise RingConfigError(f"ring version {version} < 1")
        self.shards = tuple(shards)
        self.version = version
        self.replicas = replicas
        points: list[tuple[int, int]] = []
        for shard in range(len(self.shards)):
            for replica in range(replicas):
                points.append((_hash64(b"shard:%d:%d"
                                       % (shard, replica)), shard))
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [s for _, s in points]

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def owner(self, level: int, index_real: int, index_imag: int) -> int:
        """The shard index owning tile ``(level, index_real, index_imag)``."""
        h = _hash64(_KEY_PACK.pack(level, index_real, index_imag))
        i = bisect.bisect_left(self._points, h)
        if i == len(self._points):
            i = 0
        return self._owners[i]

    def owner_of(self, key: Key) -> int:
        return self.owner(*key)

    def slice(self, shard: int) -> "RingSlice":
        if not 0 <= shard < self.n_shards:
            raise RingConfigError(
                f"shard {shard} outside [0, {self.n_shards})")
        return RingSlice(self, shard)

    # -- config document ---------------------------------------------------

    def to_config(self) -> dict:
        return {"format": RING_FORMAT, "version": self.version,
                "replicas": self.replicas,
                "shards": [s.to_config() for s in self.shards]}

    @classmethod
    def from_config(cls, doc: dict) -> "HashRing":
        if not isinstance(doc, dict):
            raise RingConfigError(f"ring config is {type(doc).__name__}, "
                                  f"not an object")
        fmt = doc.get("format")
        if fmt != RING_FORMAT:
            raise RingConfigError(f"unsupported ring format {fmt!r}")
        shards_doc = doc.get("shards")
        if not isinstance(shards_doc, list) or not shards_doc:
            raise RingConfigError("ring config has no shards")
        try:
            version = int(doc.get("version", 1))
            replicas = int(doc.get("replicas", DEFAULT_REPLICAS))
        except (TypeError, ValueError) as e:
            raise RingConfigError(str(e)) from None
        return cls([ShardInfo.from_config(s) for s in shards_doc],
                   version=version, replicas=replicas)

    def save(self, path: str) -> None:
        data = json.dumps(self.to_config(), indent=1, sort_keys=True) + "\n"
        with open(path, "w", encoding="utf-8") as f:
            f.write(data)

    @classmethod
    def load(cls, path: str) -> "HashRing":
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise RingConfigError(f"cannot load ring config {path}: {e}") \
                from None
        return cls.from_config(doc)

    @classmethod
    def local(cls, n_shards: int, *, version: int = 1,
              replicas: int = DEFAULT_REPLICAS) -> "HashRing":
        """An all-loopback ring with unbound (0) ports — the shape a
        launcher starts from before it rewrites real bound ports in."""
        return cls([ShardInfo("127.0.0.1", 0) for _ in range(n_shards)],
                   version=version, replicas=replicas)


@dataclass(frozen=True)
class RingSlice:
    """One shard's view of a ring: ``owns()`` is its keyspace filter.

    This is what threads through the coordinator stack — the scheduler
    takes ``owns`` as its frontier filter, the distributer answers
    misrouted uploads with the true ``ring.owner_of(key)``, and the
    storage layer namespaces per-shard state with ``namespace``.
    """

    ring: HashRing
    shard: int

    @property
    def n_shards(self) -> int:
        return self.ring.n_shards

    @property
    def version(self) -> int:
        return self.ring.version

    @property
    def namespace(self) -> str:
        """Blob/lock/index name suffix, e.g. ``-s0of4``.  Depends only
        on the slice identity, never the ring version: a version bump
        that keeps N must not orphan the shard's durable state."""
        return f"-s{self.shard}of{self.n_shards}"

    def owns(self, key: Key) -> bool:
        return self.ring.owner_of(key) == self.shard

    def owner_of(self, key: Key) -> int:
        return self.ring.owner_of(key)


def shard_namespace(shard: int, n_shards: int) -> str:
    """The ``RingSlice.namespace`` string without needing a ring."""
    return f"-s{shard}of{n_shards}"


OwnsFn = Callable[[Key], bool]


def parse_shard_spec(spec: str) -> tuple[int, int]:
    """``"K/N"`` -> ``(K, N)`` with bounds checking (CLI input)."""
    try:
        k_str, n_str = spec.split("/", 1)
        k, n = int(k_str), int(n_str)
    except ValueError:
        raise RingConfigError(
            f"shard spec {spec!r} is not K/N") from None
    if n < 1 or not 0 <= k < n:
        raise RingConfigError(
            f"shard spec {spec!r}: need 0 <= K < N")
    return k, n


def load_ring_for_shard(ring_path: Optional[str], shard: int,
                        n_shards: int, *, version: int = 1,
                        replicas: int = DEFAULT_REPLICAS) -> RingSlice:
    """The slice a shard process runs under.

    With a ring file the slice comes from it (and the file's shard
    count must match ``n_shards`` — a mismatched launch would silently
    re-partition the keyspace).  Without one, ownership needs only
    ``K/N``: a launcher may start shards on ephemeral ports before the
    endpoint table exists.
    """
    if ring_path is not None:
        ring = HashRing.load(ring_path)
        if ring.n_shards != n_shards:
            raise RingConfigError(
                f"ring config has {ring.n_shards} shards, launch asked "
                f"for shard {shard}/{n_shards}")
    else:
        ring = HashRing.local(n_shards, version=version, replicas=replicas)
    return ring.slice(shard)
