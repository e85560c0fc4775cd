"""The port's store, chunk and codecs against the JAX package's on the CPU:
each package's ``ChunkStore`` writes the same data directory byte for
byte and reads the other's, and a checkpoint written by one restores in
the other."""

import os

import numpy as np
import pytest

from distributedmandelbrot_tpu import codecs as ref_codecs
from distributedmandelbrot_tpu.coordinator import recovery as ref_recovery
from distributedmandelbrot_tpu.coordinator import scheduler as ref_scheduler
from distributedmandelbrot_tpu.core import chunk as ref_chunk
from distributedmandelbrot_tpu.core import workload as ref_workload
from distributedmandelbrot_tpu.storage import store as ref_store
from distributedmandelbrot_tpu_torch import codecs
from distributedmandelbrot_tpu_torch.coordinator import recovery
from distributedmandelbrot_tpu_torch.coordinator import scheduler
from distributedmandelbrot_tpu_torch.core import chunk
from distributedmandelbrot_tpu_torch.core import workload
from distributedmandelbrot_tpu_torch.core.geometry import CHUNK_PIXELS
from distributedmandelbrot_tpu_torch.storage import store

PACKAGES = {
    "jax": dict(store=ref_store, chunk=ref_chunk, codecs=ref_codecs,
                recovery=ref_recovery, scheduler=ref_scheduler,
                workload=ref_workload),
    "port": dict(store=store, chunk=chunk, codecs=codecs,
                 recovery=recovery, scheduler=scheduler, workload=workload),
}
OTHER = {"jax": "port", "port": "jax"}


def _payloads():
    """Chunk pixels that take every codec path: noise (raw), runs (RLE),
    all 0 and all 1 (the index's Never and Immediate kinds, no file)."""
    rng = np.random.default_rng(11)
    runs = np.repeat(rng.integers(0, 256, CHUNK_PIXELS // 4096),
                     4096).astype(np.uint8)
    return {(8, 0, 0): rng.integers(0, 256, CHUNK_PIXELS).astype(np.uint8),
            (8, 1, 0): runs,
            (8, 2, 0): np.zeros(CHUNK_PIXELS, np.uint8),
            (8, 3, 0): np.ones(CHUNK_PIXELS, np.uint8),
            (8, 0, 1): runs[::-1].copy()}


def _write(pkg, parent, payloads):
    store = PACKAGES[pkg]["store"].ChunkStore(str(parent))
    Chunk = PACKAGES[pkg]["chunk"].Chunk
    for (level, i, j), px in payloads.items():
        store.save(Chunk(level, i, j, px))
    # A second save of one key: the index keeps both, the last wins.
    store.save(Chunk(8, 0, 0, payloads[(8, 1, 0)]))
    return store


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_store_reads_the_others_data_dir(tmp_path, writer):
    """The data directory one package writes is the other's, file for
    file and byte for byte, and the other package's store reads every
    chunk back (last write wins) with the same index entries."""
    payloads = _payloads()
    _write(writer, tmp_path / "a", payloads)
    _write(OTHER[writer], tmp_path / "b", payloads)
    tree_a, tree_b = _tree(tmp_path / "a"), _tree(tmp_path / "b")
    assert sorted(tree_a) == sorted(tree_b)
    assert len(tree_a) >= 4  # the index and the three files
    for name in tree_a:
        assert tree_a[name] == tree_b[name], name

    reader = PACKAGES[OTHER[writer]]["store"].ChunkStore(str(tmp_path / "a"))
    want = dict(payloads)
    want[(8, 0, 0)] = payloads[(8, 1, 0)]
    assert reader.completed_keys() == set(want)
    for key, px in want.items():
        got = reader.load(*key)
        assert got is not None and np.array_equal(got.data, px), key
    ref_entries = PACKAGES[writer]["store"].ChunkStore(
        str(tmp_path / "a")).entries()

    def rows(entries):
        return [(e.key, int(e.type), e.filename) for e in entries]

    assert rows(reader.entries()) == rows(ref_entries)
    assert len(ref_entries) == len(payloads) + 1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_codec_payloads_are_the_same_bytes(writer):
    """``Chunk.serialize`` picks the same codec and writes the same bytes
    in both packages; each decodes the other's."""
    for px in _payloads().values():
        payload = PACKAGES[writer]["chunk"].Chunk(8, 0, 0, px).serialize()
        other = PACKAGES[OTHER[writer]]
        assert other["chunk"].Chunk(8, 0, 0, px).serialize() == payload
        assert np.array_equal(other["chunk"].Chunk.deserialize_data(payload),
                              px)
        assert np.array_equal(other["codecs"].deserialize(payload,
                                                          CHUNK_PIXELS), px)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_recovers_in_the_other_package(tmp_path, writer):
    """A checkpoint (completed set, cursor, leases, retry queue) written
    by one package restores in the other: the same completed set, the
    same replayed index suffix and generation, and the same blob bytes
    as the other package writes for the same state."""
    w, r = PACKAGES[writer], PACKAGES[OTHER[writer]]
    settings = [w["workload"].LevelSetting(8, 100)]
    store = w["store"].ChunkStore(str(tmp_path))
    sched = w["scheduler"].TileScheduler(settings)
    for _ in range(4):
        t = sched.acquire()
        sched.complete(t)
        store.save(w["chunk"].Chunk.never(t.level, t.index_real,
                                          t.index_imag))
    leased = sched.acquire()
    mgr = w["recovery"].RecoveryManager(store, sched, generation=3)
    ckpt = mgr.build()
    mgr.write(ckpt)
    for _ in range(2):  # past the checkpoint: replayed from the index
        t = sched.acquire()
        sched.complete(t)
        store.save(w["chunk"].Chunk.never(t.level, t.index_real,
                                          t.index_imag))

    r_settings = [r["workload"].LevelSetting(8, 100)]
    r_store = r["store"].ChunkStore(str(tmp_path))
    res = r["recovery"].load_restore_state(r_store, r_settings)
    want = w["recovery"].load_restore_state(
        w["store"].ChunkStore(str(tmp_path)), settings)
    assert res.checkpoint is not None
    assert res.completed == want.completed and len(res.completed) == 6
    assert res.replayed_entries == want.replayed_entries == 2
    assert res.generation == want.generation == 4
    assert [(lw.key, ttl) for lw, ttl in res.checkpoint.leases] == \
        [(lw.key, ttl) for lw, ttl in want.checkpoint.leases]
    assert leased.key in {lw.key for lw, _ in res.checkpoint.leases}

    # The restored state drives the other package's scheduler.
    r_sched = r["scheduler"].TileScheduler(r_settings,
                                           completed=res.completed)
    res.apply(r_sched)
    assert r_sched.completed_count == 6
    level, i, j = leased.key
    assert r_sched.can_accept(r["workload"].Workload(level, 100, i, j))

    blob = w["recovery"].encode_checkpoint(ckpt)
    decoded = r["recovery"].decode_checkpoint(blob)
    assert r["recovery"].encode_checkpoint(decoded) == blob
    assert r["recovery"].checkpoint_blob_name(r_settings) == \
        w["recovery"].checkpoint_blob_name(settings)
