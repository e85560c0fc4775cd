"""The port's consistent-hash ring (``control/ring.py``, carried from
the JAX package), under the JAX package's own tests.

The contract under test is the one the sharded control plane leans on:
ownership is a pure function of ``(n_shards, replicas)`` — endpoints
and ring version can be rewritten without remapping a single key — and
the per-shard durable namespace depends only on the slice identity.
"""

import pytest

from distributedmandelbrot_tpu_torch.control.ring import (
    DEFAULT_REPLICAS, HashRing, RingConfigError, ShardInfo,
    load_ring_for_shard, parse_shard_spec, shard_namespace)


def _grid(level):
    return [(level, i, j) for i in range(level) for j in range(level)]


def test_ownership_ignores_endpoints_and_version():
    # Endpoints and version are the *rewritable* part of the config (a
    # restarted shard comes back on fresh ephemeral ports); ownership
    # must not notice.
    local = HashRing.local(4)
    real = HashRing(
        [ShardInfo("10.0.0.%d" % k, distributer_port=59000 + k,
                   dataserver_port=60000 + k, gateway_port=61000 + k)
         for k in range(4)],
        version=7)
    for key in _grid(16):
        assert local.owner_of(key) == real.owner_of(key)


def test_ownership_changes_with_replicas():
    a = HashRing.local(4)
    b = HashRing.local(4, replicas=DEFAULT_REPLICAS * 2)
    assert any(a.owner_of(k) != b.owner_of(k) for k in _grid(32))


def test_every_shard_owns_part_of_the_grid():
    ring = HashRing.local(4)
    owners = {ring.owner_of(k) for k in _grid(16)}
    assert owners == {0, 1, 2, 3}


def test_owner_and_owner_of_agree_and_stay_in_range():
    ring = HashRing.local(3)
    for key in _grid(8):
        owner = ring.owner_of(key)
        assert owner == ring.owner(*key)
        assert 0 <= owner < ring.n_shards


def test_config_round_trip(tmp_path):
    path = str(tmp_path / "ring.json")
    ring = HashRing(
        [ShardInfo("127.0.0.1", distributer_port=59010,
                   dataserver_port=59011),
         ShardInfo("127.0.0.2", distributer_port=59020, gateway_port=59022)],
        version=3, replicas=32)
    ring.save(path)
    loaded = HashRing.load(path)
    assert loaded.version == 3
    assert loaded.replicas == 32
    assert loaded.shards == ring.shards
    for key in _grid(8):
        assert loaded.owner_of(key) == ring.owner_of(key)


def test_load_rejects_garbage(tmp_path):
    path = tmp_path / "ring.json"
    with pytest.raises(RingConfigError):
        HashRing.load(str(path))  # no such file
    path.write_text("not json", encoding="utf-8")
    with pytest.raises(RingConfigError):
        HashRing.load(str(path))
    path.write_text('{"format": 99, "shards": []}', encoding="utf-8")
    with pytest.raises(RingConfigError):
        HashRing.load(str(path))


def test_from_config_validation():
    with pytest.raises(RingConfigError):
        HashRing.from_config([])  # not an object
    with pytest.raises(RingConfigError):
        HashRing.from_config({"format": 1, "shards": []})
    with pytest.raises(RingConfigError):
        HashRing.from_config(
            {"format": 1, "shards": [{"host": "x"}]})  # missing port


def test_ctor_validation():
    with pytest.raises(RingConfigError):
        HashRing([])
    with pytest.raises(RingConfigError):
        HashRing.local(2, replicas=0)
    with pytest.raises(RingConfigError):
        HashRing.local(2, version=0)


def test_slice_partition_and_namespace():
    ring = HashRing.local(3, version=5)
    slices = [ring.slice(k) for k in range(3)]
    for key in _grid(8):
        owning = [s for s in slices if s.owns(key)]
        assert len(owning) == 1
        assert owning[0].shard == ring.owner_of(key)
        assert owning[0].owner_of(key) == ring.owner_of(key)
    for s in slices:
        assert s.n_shards == 3
        assert s.version == 5
        # The namespace is the durable identity: slice only, never the
        # version — a version bump must not orphan on-disk state.
        assert s.namespace == f"-s{s.shard}of3"
        assert s.namespace == shard_namespace(s.shard, 3)
    with pytest.raises(RingConfigError):
        ring.slice(3)
    with pytest.raises(RingConfigError):
        ring.slice(-1)


def test_parse_shard_spec():
    assert parse_shard_spec("0/1") == (0, 1)
    assert parse_shard_spec("3/4") == (3, 4)
    for bad in ("", "2", "a/b", "1.5/4", "4/4", "-1/4", "0/0"):
        with pytest.raises(RingConfigError):
            parse_shard_spec(bad)


def test_load_ring_for_shard(tmp_path):
    path = str(tmp_path / "ring.json")
    HashRing.local(2, version=4).save(path)
    sl = load_ring_for_shard(path, 1, 2)
    assert (sl.shard, sl.n_shards, sl.version) == (1, 2, 4)
    # Mismatched launch would silently re-partition the keyspace.
    with pytest.raises(RingConfigError):
        load_ring_for_shard(path, 0, 3)
    # Without a file, K/N alone determines ownership.
    sl = load_ring_for_shard(None, 2, 4)
    assert (sl.shard, sl.n_shards) == (2, 4)
    assert all(sl.owns(k) == (HashRing.local(4).owner_of(k) == 2)
               for k in _grid(8))
