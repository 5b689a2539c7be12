"""The port's online index lifecycle (``repro_torch.lifecycle``) held
against the JAX package's on the same seeded inputs (on the CPU).

  * the golden churn stream (tests/test_golden_regression.py's
    ``_churned_world``) drives both ``MutableIndex``es: every mirror
    array, ``slack()``, ``unsorted_tail_fraction()``, the counters, the
    id map and the rng state are equal after the first rounds, after the
    compaction and at the dirty tail;
  * the port's churned snapshot matches the committed golden ``churned``
    entries and the live reference on all 11 TopK fields;
  * clipping, requantizing compaction and ``IndexFullError`` behave
    alike, and a CPU snapshot owns its memory;
  * checkpoints cross-load both ways (every field equal, digests verify),
    legacy v1 and v5 checkpoints and shard subsets load alike, and a
    corrupt, truncated or swapped-aside checkpoint is detected and fallen
    back from as the reference does;
  * ``MutableIndex.recover`` in each package, on a durable directory the
    other package's writer left behind at each fault point, is bit-exact
    with the uncrashed writer, rng state included;
  * the writers publish epochs the way the reference's do.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import repro.lifecycle as jlc
import repro_torch.lifecycle as tlc
import test_crash_recovery as tc
import test_golden_regression as tg
from repro.core import search as jsearch
from repro_torch.core.search import brute_force_topk, retrieve
from repro_torch.core.types import INDEX_FIELDS, TOPK_FIELDS
from repro_torch.lifecycle.wal import SNAPSHOT_SUBDIR, WAL_SUBDIR
from repro_torch.tools.golden_world import (WRITER_SEED, apply_op,
                                            golden_churn_ops)
from test_lifecycle import _downgrade_to_v1, _downgrade_to_v5
from test_torch_search import assert_topk_equal, port_cfg, port_state

_W: dict = {}


def bases():
    """(JAX base index, port base index, port queries, concrete ops)."""
    if not _W:
        jidx, jq = tg._world()
        tidx, tq = port_state(jidx, jq, "cpu")
        _W["w"] = (jidx, tidx, tq, golden_churn_ops())
    return _W["w"]


# index of the compact op in the golden stream, and the stream's stages
_COMPACT_AT = 140


def _stage_ops(ops: list, stage: str) -> list:
    assert ops[_COMPACT_AT] == ["compact"]
    return {"rounds": ops[:_COMPACT_AT], "compact": ops[:_COMPACT_AT + 1],
            "dirty_tail": ops}[stage]


def assert_same_writer(port, ref) -> None:
    """Bit-exact MutableIndex equality across the packages: every mirror
    array (dtype too), the exact scale, and every piece of writer state
    that shapes later mutations."""
    hp, hr = port._host_index(), ref._host_index()
    for f in INDEX_FIELDS:
        a, b = np.asarray(getattr(hp, f)), np.asarray(getattr(hr, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert port.scale == ref.scale
    assert port.op_seq == ref.op_seq
    assert port._next_doc_id == ref._next_doc_id
    assert port._loc == ref._loc
    assert port._rng.bit_generator.state == ref._rng.bit_generator.state
    for k in ("n_inserts", "n_deletes", "n_clipped", "n_compactions"):
        assert getattr(port, k) == getattr(ref, k), k
    assert port._clipped.keys() == ref._clipped.keys()
    for d, (t, w) in port._clipped.items():
        np.testing.assert_array_equal(t, ref._clipped[d][0])
        np.testing.assert_array_equal(w, ref._clipped[d][1])
    assert port.slack() == ref.slack()
    assert port.unsorted_tail_fraction() == ref.unsorted_tail_fraction()


def _churned_pair(stage: str = "dirty_tail"):
    jidx, tidx, _, ops = bases()
    ref = jlc.MutableIndex(jidx, seed=WRITER_SEED)
    port = tlc.MutableIndex(tidx, seed=WRITER_SEED)
    for op in _stage_ops(ops, stage):
        tc.apply_op(ref, op)
        apply_op(port, op)
    return port, ref


def test_golden_ops_equal_the_reference_stream():
    assert golden_churn_ops() == tc._record_golden_ops()


@pytest.mark.parametrize("stage", ["rounds", "compact", "dirty_tail"])
def test_churned_mirrors_equal_reference(stage):
    port, ref = _churned_pair(stage)
    assert_same_writer(port, ref)
    # the same live-id order too: the stream draws its deletes from it
    np.testing.assert_array_equal(port.live_ids(), ref.live_ids())
    if stage == "compact":
        assert (port.sorted_upto == port.d_pad).all()
    else:
        assert port.unsorted_tail_fraction() > 0      # a dirty tail


@pytest.fixture(scope="module")
def churned():
    """(port churned snapshot, port queries, JAX churned snapshot, JAX
    queries, committed golden entries)."""
    port, _ = _churned_pair()
    jsnap, jq = tg._churned_world()
    with open(tg.GOLDEN_PATH) as f:
        golden = json.load(f)["churned"]
    return port.snapshot("cpu"), bases()[2], jsnap, jq, golden


@pytest.mark.parametrize("name", sorted(tg.CHURNED_ENGINES)
                         + ["brute_force"])
def test_churned_snapshot_matches_golden_and_reference(churned, name):
    snap, tq, jsnap, jq, golden = churned
    for f in INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(snap, f).numpy(),
                                      np.asarray(getattr(jsnap, f)),
                                      err_msg=f)
    if name == "brute_force":
        got = brute_force_topk(snap, tq, tg.K, device="cpu")
        want = jsearch.brute_force_topk(jsnap, jq, tg.K)
    else:
        jcfg = tg.CHURNED_ENGINES[name]
        got = retrieve(snap, tq, port_cfg(jcfg), device="cpu")
        want = jsearch.retrieve(jsnap, jq, jcfg)
    tg._check_entry(golden[name], tg._topk_entry(got.__class__(
        *(getattr(got, f).numpy() for f in TOPK_FIELDS))), name)
    assert_topk_equal(want, got, f"churned {name}")


def _clip_stream(mi, n_big: int) -> None:
    """Deletes, ordinary inserts, and inserts whose weights clip at the
    pinned scale (255 * scale is the largest storable weight)."""
    rng = np.random.default_rng(5)
    for d in rng.choice(mi.live_ids(), 30, replace=False):
        mi.delete(int(d))
    for i in range(25):
        nnz = int(rng.integers(4, 12))
        t = rng.choice(mi.vocab, nnz, replace=False)
        w = rng.lognormal(0.0, 0.5, nnz).astype(np.float32)
        if i < n_big:
            w[0] = np.float32(mi.scale * 255 * (2 + i))
        mi.insert(t, w)


@pytest.mark.parametrize("requantize", [None, True, False])
def test_clip_and_requantize_parity(requantize):
    jidx, tidx, _, _ = bases()
    port = tlc.MutableIndex(tidx, seed=3)
    ref = jlc.MutableIndex(jidx, seed=3)
    for mi in (port, ref):
        _clip_stream(mi, n_big=3)
    assert port.n_clipped == 3
    assert_same_writer(port, ref)
    scale0 = port.scale
    port.compact(requantize=requantize)
    ref.compact(requantize=requantize)
    assert_same_writer(port, ref)
    # default and True re-derive the scale from the true float weights
    assert (port.scale != scale0) == (requantize is not False)


def test_index_full_parity():
    jidx, tidx, _, _ = bases()
    port = tlc.MutableIndex(tidx, seed=4)
    ref = jlc.MutableIndex(jidx, seed=4)
    free = int(port.free_slots.sum())
    assert free == int(ref.free_slots.sum()) > 0
    for mi in (port, ref):
        for i in range(free):
            mi.insert([i % mi.vocab, (i + 1) % mi.vocab], [0.5, 0.25])
    assert_same_writer(port, ref)
    with pytest.raises(tlc.IndexFullError):
        port.insert([1], [0.5])
    with pytest.raises(jlc.IndexFullError):
        ref.insert([1], [0.5])
    assert port.op_seq == ref.op_seq


def test_cpu_snapshot_owns_its_memory():
    """``torch.from_numpy`` would alias the mirrors: a snapshot must not
    change under later writes, and shares no storage with them."""
    _, tidx, _, _ = bases()
    mi = tlc.MutableIndex(tidx, seed=6)
    snap = mi.snapshot("cpu")
    frozen = {f: getattr(snap, f).clone() for f in INDEX_FIELDS}
    mirrors = mi._host_index()
    for f in INDEX_FIELDS:
        t = getattr(snap, f)
        arr = np.asarray(getattr(mirrors, f))
        assert not np.shares_memory(t.numpy(), arr), f
    for d in mi.live_ids()[:20]:
        mi.delete(int(d))
    for i in range(20):
        mi.insert([i, i + 1, i + 2], [0.5, 9.0, 1.0])
    mi.compact(requantize=True)
    for f in INDEX_FIELDS:
        assert torch.equal(getattr(snap, f), frozen[f]), f
    # and the mirrors never aliased the base index either
    assert torch.equal(tidx.doc_ids, frozen["doc_ids"])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

PERSIST = {"port": tlc, "ref": jlc}


def _same_index(a, b) -> None:
    for f in INDEX_FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.vocab, a.n_seg) == (b.vocab, b.n_seg)


def _load(pkg: str, path: str, **kw):
    if pkg == "port":
        return tlc.load_index(path, device="cpu", **kw)
    return jlc.load_index(path, **kw)


@pytest.mark.parametrize("n_shards", [1, 3])
@pytest.mark.parametrize("writer,reader", [("port", "ref"),
                                           ("ref", "port")])
def test_checkpoints_cross_load(tmp_path, writer, reader, n_shards):
    port, ref = _churned_pair()
    index = port.snapshot("cpu") if writer == "port" else ref.snapshot()
    path = PERSIST[writer].save_index(str(tmp_path / "ix"), index, epoch=4,
                                      n_shards=n_shards,
                                      extra={"writer": port.writer_state()})
    assert tlc.verify_checkpoint(path) == jlc.verify_checkpoint(path) == []
    assert tlc.read_manifest(path)["shards"] == \
        jlc.read_manifest(path)["shards"]
    loaded, manifest = _load(reader, path)
    assert manifest["epoch"] == 4 and manifest["n_shards"] == n_shards
    _same_index(loaded, ref.snapshot())


@pytest.mark.parametrize("version", ["v1_collapsed", "v1_bare", "v5",
                                     "v1_arrival_order"])
def test_legacy_checkpoints_load_alike(tmp_path, version):
    """v1 (separate seg_max, with or without the collapsed row; and an
    arrival-order pack that v1-v3 loads re-sort segment-major) and v5
    (no stored grouping) checkpoints load with every derived field equal
    to the reference's load of the same files."""
    from repro.core.index import build_index as jbuild
    from repro.data.synthetic import CorpusSpec, make_corpus
    from repro_torch.tools.golden_world import GOLDEN_SPEC
    jidx, _, _, _ = bases()
    if version == "v1_arrival_order":
        docs, _ = make_corpus(CorpusSpec(**dataclasses.asdict(GOLDEN_SPEC)))
        jidx = jbuild(docs, np.arange(600) % 12, m=12, n_seg=4, d_pad=64,
                      seed=21, sort_segments=False)
    path = jlc.save_index(str(tmp_path / "ix"), jidx, n_shards=3)
    if version == "v5":
        _downgrade_to_v5(path)
    else:
        _downgrade_to_v1(path, keep_collapsed=version == "v1_collapsed")
    mine, m_manifest = tlc.load_index(path, device="cpu")
    ref, r_manifest = jlc.load_index(path)
    assert m_manifest == r_manifest
    _same_index(mine, ref)


@pytest.mark.parametrize("shards", [[0], [2], [1, 2]])
def test_shard_subsets_load_alike(tmp_path, shards):
    port, _ = _churned_pair()
    path = tlc.save_index(str(tmp_path / "ix"), port.snapshot("cpu"),
                          n_shards=3)
    mine, _ = tlc.load_index(path, shards=shards, device="cpu")
    ref, _ = jlc.load_index(path, shards=shards)
    _same_index(mine, ref)
    assert mine.m < port.m


def _flip_byte(path: str, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)[0]
        f.seek(offset)
        f.write(bytes([b ^ 0x01]))


@pytest.mark.parametrize("damage", ["bitflip", "truncate", "missing_field"])
def test_damaged_checkpoint_detected_alike(tmp_path, damage):
    _, tidx, _, _ = bases()
    path = tlc.save_index(str(tmp_path / "ix"), tidx, n_shards=2)
    shard = os.path.join(path, "shard_0001.npz")
    if damage == "bitflip":
        _flip_byte(shard, 100)
    elif damage == "truncate":
        os.truncate(shard, os.path.getsize(shard) - 7)
    else:
        with np.load(shard) as z:
            arrays = {f: z[f] for f in z.files if f != "doc_tw"}
        np.savez(shard, **arrays)
    problems = tlc.verify_checkpoint(path)
    assert problems and problems == jlc.verify_checkpoint(path)
    with pytest.raises(tlc.CheckpointCorruptError) as mine:
        tlc.load_index(path, device="cpu")
    with pytest.raises(jlc.CheckpointCorruptError) as ref:
        jlc.load_index(path)
    assert [p for _, p in mine.value.problems] == \
        [p for _, p in ref.value.problems]
    if damage == "missing_field":
        with pytest.raises(KeyError, match="doc_tw"):
            tlc.load_index(path, verify=False, device="cpu")


@pytest.mark.parametrize("point", ["persist.swap.between_renames",
                                   "persist.swap.post_promote",
                                   "persist.shard.mid_write",
                                   "persist.manifest.pre_write"])
def test_interrupted_overwrite_falls_back_alike(tmp_path, point):
    """A port save interrupted at each persist point leaves a checkpoint
    both packages load the same way: the old one (or, after promotion
    with the primary corrupted, the swapped-aside copy)."""
    from repro_torch.obs import MetricsRegistry
    port, _ = _churned_pair("rounds")
    _, tidx, _, _ = bases()
    path = str(tmp_path / "ix")
    tlc.save_index(path, tidx, epoch=1)
    with tlc.install(tlc.FaultSchedule([(point, 1, "raise")])):
        with pytest.raises(tlc.FaultInjected):
            tlc.save_index(path, port.snapshot("cpu"), epoch=2)
    want_epoch = 1
    if point == "persist.swap.post_promote":
        # the new checkpoint was promoted; corrupt it so the loaders walk
        # back to the swapped-aside copy
        _flip_byte(os.path.join(path, "shard_0000.npz"), 50)
    reg = MetricsRegistry()
    mine, m_manifest = tlc.load_index(path, device="cpu", registry=reg)
    ref, r_manifest = jlc.load_index(path)
    assert m_manifest["epoch"] == r_manifest["epoch"] == want_epoch
    _same_index(mine, ref)
    _same_index(mine, tidx)
    if point == "persist.swap.post_promote":
        assert reg.snapshot()["snapshot_corrupt_shards_total"] >= 1


# ---------------------------------------------------------------------------
# recovery across the packages, at every fault point
# ---------------------------------------------------------------------------

# (fault point, nth hit, op index of the mid-stream checkpoint)
FAULTS = {
    "none": (None, 0, 100),
    "compact.mid_pack": ("compact.mid_pack", 1, 100),
    "persist.shard.mid_write": ("persist.shard.mid_write", 1, 100),
    "persist.manifest.pre_write": ("persist.manifest.pre_write", 1, 100),
    "persist.swap.between_renames": ("persist.swap.between_renames", 1,
                                     100),
    "persist.swap.post_promote": ("persist.swap.post_promote", 1, 100),
    "wal.append.pre_write": ("wal.append.pre_write", 150, 60),
    "wal.append.pre_fsync": ("wal.append.pre_fsync", 150, 60),
}


def _crashed_writer(pkg: str, d: str, fault: str) -> None:
    """A WAL-backed writer of package ``pkg`` over the golden base: base
    checkpoint, the golden stream with one more checkpoint mid-stream, cut
    by the fault (an exception standing in for the crash), its WAL
    buffer flushed as the process would leave it."""
    jidx, tidx, _, ops = bases()
    lc = PERSIST[pkg]
    point, nth, checkpoint_at = FAULTS[fault]
    apply = apply_op if pkg == "port" else tc.apply_op
    fsync = "always" if point == "wal.append.pre_fsync" else "off"
    wal = lc.WriteAheadLog(os.path.join(d, WAL_SUBDIR), fsync=fsync)
    mi = lc.MutableIndex(tidx if pkg == "port" else jidx, seed=WRITER_SEED,
                         wal=wal)
    mi.checkpoint(d)
    sched = lc.FaultSchedule([(point, nth, "raise")]) if point else None
    with (lc.install(sched) if sched else contextlib.nullcontext()):
        try:
            for i, op in enumerate(ops):
                if i == checkpoint_at:
                    mi.checkpoint(d)
                apply(mi, op)
        except lc.FaultInjected:
            pass
    assert sched is None or sched.fired == [(point, "raise")]
    mi.wal.flush(fsync=False)


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_recover_is_bit_exact_across_packages(tmp_path, writer, fault):
    d = str(tmp_path / "durable")
    _crashed_writer(writer, d, fault)
    mine, m_stats = tlc.MutableIndex.recover(d, attach_wal=False)
    ref, r_stats = jlc.MutableIndex.recover(d, attach_wal=False)
    for k in ("checkpoint_epoch", "last_published_epoch",
              "checkpoint_op_seq", "op_seq", "n_replayed", "torn_tail"):
        assert m_stats[k] == r_stats[k], k
    assert_same_writer(mine, ref)
    # the uncrashed writer that ran exactly the durable prefix
    jidx, _, _, ops = bases()
    oracle = jlc.MutableIndex(jidx, seed=WRITER_SEED)
    for op in ops[:mine.op_seq]:
        tc.apply_op(oracle, op)
    assert_same_writer(mine, oracle)
    assert mine.op_seq > 0
    if fault == "none":
        assert mine.op_seq == len(ops)
    # both go on identically from the recovered state
    for op in ops[mine.op_seq:]:
        apply_op(mine, op)
        tc.apply_op(ref, op)
    assert_same_writer(mine, ref)


def test_recover_rejects_plain_checkpoints(tmp_path):
    _, tidx, _, _ = bases()
    d = str(tmp_path)
    tlc.save_index(os.path.join(d, SNAPSHOT_SUBDIR), tidx)
    with pytest.raises(ValueError, match="writer state"):
        tlc.MutableIndex.recover(d)


# ---------------------------------------------------------------------------
# writers and epochs
# ---------------------------------------------------------------------------

def test_writer_publishes_epochs_like_the_reference(tmp_path):
    """IndexWriter and DurableIndexWriter on the CPU: the same epochs,
    pending counts and published contents as the reference's writers on
    the same stream, a graceful close recovers with nothing to replay,
    and recovery republishes into the serving publisher."""
    jidx, tidx, _, ops = bases()
    port = tlc.DurableIndexWriter(tidx, str(tmp_path / "port"),
                                  fsync="off", checkpoint_every=2,
                                  seed=WRITER_SEED, device="cpu")
    ref = jlc.DurableIndexWriter(jidx, str(tmp_path / "ref"), fsync="off",
                                 checkpoint_every=2, seed=WRITER_SEED)
    assert port.publisher.current.epoch == ref.publisher.current.epoch == 0
    assert port.publisher.current.index is tidx
    for lo in range(0, len(ops), 47):
        for op in ops[lo:lo + 47]:
            apply_op(port, op)
            # the reference's writers have no compact(): it runs on their
            # MutableIndex, as the port's apply_op does
            tc.apply_op(ref.mutable if op == ["compact"] else ref, op)
        assert port.pending == ref.pending
        a, b = port.commit(), ref.commit()
        assert (a.epoch, a.n_docs) == (b.epoch, b.n_docs)
        _same_index(a.index, b.index)
    assert_same_writer(port.mutable, ref.mutable)
    publisher = port.publisher
    pinned = publisher.current
    port.mutable.wal.flush()                   # the writer dies here
    rec = tlc.DurableIndexWriter.recover(str(tmp_path / "port"),
                                         fsync="off", publisher=publisher,
                                         device="cpu")
    assert rec.publisher is publisher
    assert publisher.current.epoch == pinned.epoch + 1
    _same_index(publisher.current.index, pinned.index)
    assert_same_writer(rec.mutable, ref.mutable)
    rec.close()
    again = tlc.DurableIndexWriter.recover(str(tmp_path / "port"),
                                           fsync="off", device="cpu")
    assert again.recovery_stats["n_replayed"] == 0
    assert_same_writer(again.mutable, ref.mutable)


def test_writers_refuse_an_index_off_their_device():
    _, tidx, _, _ = bases()
    with pytest.raises(ValueError, match="lives on"):
        tlc.IndexWriter(tidx, device="meta")


def test_publisher_counts_pins_and_collects_epochs():
    """Pin counts per epoch and the GC accounting of superseded epochs,
    as the reference's publisher keeps them."""
    import gc
    _, tidx, _, _ = bases()
    pub = tlc.SnapshotPublisher(tidx)
    s0a, s0b = pub.pin(), pub.pin()
    assert pub.reader_counts() == {0: 2}
    pub.unpin(s0b)
    pub.publish(tidx, n_docs=5)
    assert pub.current.n_docs == 5
    s1 = pub.pin()
    assert pub.reader_counts() == {0: 1, 1: 1}
    assert pub.gc_stats()["collected_epochs"] == 0
    pub.unpin(s0a)
    del s0a, s0b
    gc.collect()
    stats = pub.gc_stats()
    assert stats["collected_epochs"] == 1
    assert stats["live_readers"] == {1: 1}
    pub.unpin(s1)
    assert pub.reader_counts() == {}
    assert pub.previous is None
    assert tlc.IndexSnapshot.of(tidx, 3).n_docs == int(tidx.doc_mask.sum())
    assert dataclasses.is_dataclass(pub.current)


def test_lifecycle_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """``device=None`` means the card: with none present the writers,
    the snapshot, the loader and recovery raise rather than run on the
    CPU."""
    _, tidx, _, _ = bases()
    mi = tlc.MutableIndex(tidx, seed=1)
    path = tlc.save_index(str(tmp_path / "ix"), tidx)
    durable = str(tmp_path / "durable")
    tlc.DurableIndexWriter(tidx, durable, fsync="off", device="cpu").close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tlc.IndexWriter(tidx),
                 lambda: tlc.DurableIndexWriter(tidx, str(tmp_path / "d")),
                 lambda: mi.snapshot(),
                 lambda: mi.to_sparse_docs(),
                 lambda: tlc.load_index(path),
                 lambda: tlc.DurableIndexWriter.recover(durable)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
