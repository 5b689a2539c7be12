"""Online index mutation: the write path over a static ClusterIndex
(PyTorch port of ``repro/lifecycle/mutable.py``).

The read path (core/search.py) only ever sees immutable tensors; all
mutation happens here on host-side numpy mirrors of the index arrays
(read from the index once, one ``.cpu().numpy()`` a field, when the
writer is made), and readers pick up changes through epoch snapshots
(lifecycle/snapshot.py), each a copy that owns its memory.

Rank-safety under churn (docs/lifecycle.md has the full argument):

  * insert — the new document's quantized weights are max-folded into its
    segment's row of ``seg_max`` (a monotone update), so after an insert
    every segment bound is still the *exact* maximum over its live docs:
    all of the paper's Propositions 1-4 hold exactly, unchanged.
  * delete — tombstone only: ``doc_mask`` drops the doc from scoring and
    from the brute-force oracle, while ``seg_max`` keeps the dead doc's
    contribution. A stale maximum can only *over*-estimate, and every
    pruning proposition only requires seg_max to upper-bound live-doc
    scores — so bounds stay valid (just looser), and mu = eta = 1 remains
    rank-safe. The cost is wasted work, not wrong results.
  * quantization — the global ``scale`` is pinned at build time. An
    inserted weight above ``255 * scale`` clips; scoring and bounds both
    use the clipped uint8 value, so safety in quantized score space is
    unaffected, but the doc's score is under-resolved. Clips are counted
    as staleness, and the clipped documents' *true float weights* are
    retained on the side so compaction can widen the scale and restore
    their resolution (from the stored uint8 alone the original range
    would be unrecoverable).

``slack()`` turns both staleness sources (tombstones + clips) into one
scalar; when it crosses ``compact_threshold`` the index is re-packed
through :func:`repro_torch.core.index.pack_clusters` — the *same* code
the offline build uses — restoring tight maxima and a fresh scale.

Durability (docs/lifecycle.md §durability): constructed with a
``wal`` (:class:`repro_torch.lifecycle.wal.WriteAheadLog`), every mutation
appends a logical redo record *before* touching any array, and
:meth:`checkpoint` / :meth:`recover` bracket the crash story —
checkpoint persists the arrays plus the writer's replay context
(``op_seq``, rng state, exact float scale, clipped-doc side table);
recover loads the last intact checkpoint and replays the WAL tail
through the normal insert/delete/compact code paths, reproducing the
uncrashed index bit-exactly. A mutation that fails mid-WAL-append (an
injected fault, a full disk) leaves the in-memory object inconsistent
with its own log — discard it and :meth:`recover`; that is the
degraded-mode protocol serve.py drives.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from repro_torch.core.index import capacity_rebalance, pack_clusters
from repro_torch.core.types import INDEX_FIELDS, ClusterIndex, SparseDocs
from repro_torch.device import resolve_device
from repro_torch.lifecycle.faults import fault_point
from repro_torch.lifecycle.wal import (SNAPSHOT_SUBDIR, WAL_SUBDIR,
                                       WriteAheadLog, read_wal)
from repro_torch.obs.metrics import DURATION_BUCKETS_S


def _mirror(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``t`` that shares no memory with it."""
    a = t.cpu().numpy()
    return a.copy() if t.device.type == "cpu" else a


class IndexFullError(RuntimeError):
    """No cluster has a free slot for the inserted document."""


class WalReplayError(RuntimeError):
    """WAL replay diverged from the logged run — the checkpoint and the
    log tail disagree (wrong centroids, a foreign WAL, or a real bug)."""


class MutableIndex:
    """Mutable host-side mirror of a :class:`ClusterIndex`.

    Single-writer: callers serialize access (the IndexWriter in
    lifecycle/snapshot.py does). Readers never touch this object — they
    search immutable snapshots taken with :meth:`snapshot`.

    With ``registry`` (a :class:`repro_torch.obs.MetricsRegistry`) every
    write mirrors the staleness story into ``index_*`` metrics: insert /
    delete / clip counters, the slack and unsorted-tail-fraction gauges
    they drive, and a compaction-duration histogram (the writer-side
    pause a compaction costs; docs/observability.md §lifecycle).
    """

    def __init__(self, index: ClusterIndex,
                 centroids: np.ndarray | None = None,
                 compact_threshold: float = 0.25,
                 seg_method: str = "random_uniform",
                 seed: int = 0,
                 registry=None,
                 wal: "WriteAheadLog | None" = None):
        self.registry = registry
        self.wal = wal
        self.op_seq = 0             # ops applied ever (insert/delete/compact)
        self._replaying = False     # recovery replay: don't re-log records
        # one device-to-host read a field, made once per writer (and once
        # per recovery); every later write touches only these mirrors. A
        # CPU index is copied too, so the mirrors never alias its memory
        host = {f: _mirror(getattr(index, f))
                for f in INDEX_FIELDS if f != "scale"}
        self.doc_tids = host["doc_tids"]
        self.doc_tw = host["doc_tw"]
        self.doc_mask = host["doc_mask"]
        self.doc_ids = host["doc_ids"]
        self.doc_seg = host["doc_seg"]
        # hoisted pre-modded segment map: kept consistent with doc_seg by
        # every write (insert/delete/compaction), so planning never mods
        self.doc_seg_mod = host["doc_seg_mod"]
        # one stacked mirror; seg_max / seg_max_collapsed are numpy *views*
        # into it, so max-folding either keeps the stored stacked layout
        # (what snapshots publish) coherent for free
        self.seg_max_stacked = host["seg_max_stacked"]
        self.seg_max = self.seg_max_stacked[:, : index.n_seg]
        self.seg_max_collapsed = self.seg_max_stacked[:, index.n_seg]
        # level-0 superblock layer: grouping is stable under insert /
        # delete (docs stay in their cluster, clusters stay in their
        # superblock); the coarse table mirrors seg_max's maintenance —
        # insert max-folds keep dominance exact, deletes leave it stale
        # but still dominating, compaction rebuilds it tight
        self.super_of = host["super_of"]
        self.super_members = host["super_members"]
        self.super_max_stacked = host["super_max_stacked"]
        self.super_max = self.super_max_stacked[:, : index.n_seg]
        self.super_max_collapsed = self.super_max_stacked[:, index.n_seg]
        # segment-major layout metadata: the prefix table describes the
        # sorted prefix [0, sorted_upto) of each cluster; inserts append
        # into the unsorted tail and may shrink sorted_upto (below)
        self.seg_offsets = host["seg_offsets"]
        self.sorted_upto = host["sorted_upto"]
        self.cluster_ndocs = host["cluster_ndocs"]
        self.scale = float(index.scale)
        self.vocab = index.vocab
        self.n_seg = index.n_seg

        self.centroids = (np.asarray(centroids, np.float32)
                          if centroids is not None else None)
        self.compact_threshold = compact_threshold
        if seg_method != "random_uniform":
            # compaction re-segments without dense representations, which
            # kmeans_sub needs; fail here, not mid-serving at first compact
            raise ValueError(
                f"online re-segmentation supports only 'random_uniform', "
                f"got {seg_method!r}")
        self.seg_method = seg_method
        self._rng = np.random.default_rng(seed)

        live = self.doc_ids[self.doc_mask]
        cl, sl = np.nonzero(self.doc_mask)
        self._loc = {int(d): (int(c), int(s))
                     for d, c, s in zip(live, cl, sl)}
        self._next_doc_id = int(live.max()) + 1 if live.size else 0

        self.n_inserts = 0
        self.n_deletes = 0          # tombstones since last compaction
        self.n_clipped = 0          # scale-overflow inserts since compaction
        self.n_compactions = 0
        # true float weights of clipped inserts, so requantization can
        # restore their resolution: doc_id -> (tids, tw)
        self._clipped: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    # -- geometry ---------------------------------------------------------
    @property
    def m(self) -> int:
        return self.doc_tids.shape[0]

    @property
    def d_pad(self) -> int:
        return self.doc_tids.shape[1]

    @property
    def t_pad(self) -> int:
        return self.doc_tids.shape[2]

    @property
    def live(self) -> int:
        return int(self.cluster_ndocs.sum())

    @property
    def free_slots(self) -> np.ndarray:
        return self.d_pad - self.cluster_ndocs

    # -- write path -------------------------------------------------------
    def _choose_cluster(self, dense_rep: np.ndarray | None) -> int:
        room = np.nonzero(self.cluster_ndocs < self.d_pad)[0]
        if room.size == 0:
            raise IndexFullError(
                f"all {self.m} clusters at capacity d_pad={self.d_pad}")
        if self.centroids is not None and dense_rep is not None:
            d2 = ((self.centroids[room]
                   - np.asarray(dense_rep, np.float32)[None, :]) ** 2).sum(-1)
            return int(room[np.argmin(d2)])
        return int(room[np.argmin(self.cluster_ndocs[room])])

    def insert(self, tids: np.ndarray, tw: np.ndarray,
               doc_id: int | None = None,
               dense_rep: np.ndarray | None = None) -> int:
        """Insert one sparse document; returns its global id.

        Placement: nearest centroid with room when centroids are known,
        else least-loaded cluster. Segment: uniform random, preserving the
        Prop-4 random-segmentation model. seg_max is max-updated, so
        post-insert bounds are exact (no staleness added).
        """
        tids = np.asarray(tids, np.int64).ravel()
        tw = np.asarray(tw, np.float32).ravel()
        keep = (tw > 0) & (tids >= 0) & (tids < self.vocab)
        tids, tw = tids[keep], tw[keep]
        if tids.size == 0:
            raise ValueError("insert needs at least one positive-weight term")
        if tids.size > self.t_pad:           # keep the heaviest t_pad terms
            top = np.argsort(-tw)[: self.t_pad]
            tids, tw = tids[top], tw[top]

        c = self._choose_cluster(dense_rep)
        # append into the unsorted tail when it has room; only when every
        # free slot sits inside the sorted prefix (tombstone reuse) does
        # the insert land there — shrinking sorted_upto to that slot, so
        # the planner's prefix-table runs never cover unsorted docs. The
        # segment-major invariant degrades gracefully under churn and
        # compaction restores sorted_upto = d_pad for free.
        free = np.nonzero(~self.doc_mask[c])[0]
        tail_free = free[free >= self.sorted_upto[c]]
        slot = int(tail_free[0]) if tail_free.size else int(free[0])
        j = int(self._rng.integers(self.n_seg))

        qf = np.round(tw / self.scale)
        clipped = bool((qf > 255).any())
        q = np.clip(qf, 0, 255).astype(np.uint8)

        if doc_id is None:
            doc_id = self._next_doc_id
        elif doc_id in self._loc:
            raise ValueError(f"doc_id {doc_id} already live")

        # log intent, then apply: everything below the append is pure
        # array mutation, so a crash either loses the op entirely (record
        # not durable) or replays it exactly — never half-applies it. The
        # record carries the computed placement purely so replay can
        # assert determinism (recover()/_apply_record).
        self.op_seq += 1
        if self.wal is not None and not self._replaying:
            self.wal.append_insert(self.op_seq, int(doc_id), c, slot, j,
                                   tids, tw, dense_rep)

        if slot < self.sorted_upto[c]:
            self.sorted_upto[c] = slot
        self._next_doc_id = max(self._next_doc_id, int(doc_id) + 1)
        if clipped:
            self.n_clipped += 1
            self._clipped[int(doc_id)] = (tids.copy(), tw.copy())

        n = tids.size
        self.doc_tids[c, slot, :] = self.vocab
        self.doc_tids[c, slot, :n] = tids.astype(self.doc_tids.dtype)
        self.doc_tw[c, slot, :] = 0
        self.doc_tw[c, slot, :n] = q
        self.doc_mask[c, slot] = True
        self.doc_ids[c, slot] = doc_id
        self.doc_seg[c, slot] = j
        self.doc_seg_mod[c, slot] = j % self.n_seg
        np.maximum.at(self.seg_max[c, j], tids, q)   # monotone => exact
        np.maximum.at(self.seg_max_collapsed[c], tids, q)
        # mirror the fold into the cluster's superblock row so the coarse
        # table keeps elementwise-dominating every member (rank safety of
        # the level-0 prune rests on exactly this invariant)
        sb = int(self.super_of[c])
        np.maximum.at(self.super_max[sb, j], tids, q)
        np.maximum.at(self.super_max_collapsed[sb], tids, q)
        self.cluster_ndocs[c] += 1
        self._loc[int(doc_id)] = (c, slot)
        self.n_inserts += 1
        if self.registry is not None:
            self.registry.counter("index_inserts_total",
                                  "documents inserted").inc()
            if clipped:
                self.registry.counter(
                    "index_clipped_inserts_total",
                    "inserts whose weights clipped at the pinned "
                    "quantization scale").inc()
            self._mirror_staleness()
        return int(doc_id)

    def delete(self, doc_id: int) -> bool:
        """Tombstone a document. seg_max is deliberately left stale: it
        still upper-bounds every live doc, which is all pruning needs."""
        did = int(doc_id)
        loc = self._loc.get(did)
        if loc is None:
            return False
        self.op_seq += 1
        if self.wal is not None and not self._replaying:
            self.wal.append_delete(self.op_seq, did)
        self._loc.pop(did)
        self._clipped.pop(did, None)
        c, slot = loc
        self.doc_mask[c, slot] = False
        self.doc_ids[c, slot] = -1
        self.doc_tids[c, slot, :] = self.vocab
        self.doc_tw[c, slot, :] = 0
        self.doc_seg[c, slot] = 0
        self.doc_seg_mod[c, slot] = 0
        self.cluster_ndocs[c] -= 1
        self.n_deletes += 1
        if self.registry is not None:
            self.registry.counter("index_deletes_total",
                                  "documents tombstoned").inc()
            self._mirror_staleness()
        return True

    # -- staleness / compaction ------------------------------------------
    def slack(self) -> float:
        """Staleness metric in [0, inf): stale-bound contributors (deleted
        docs whose maxima linger + clipped inserts) per live doc."""
        return (self.n_deletes + self.n_clipped) / max(1, self.live)

    def unsorted_tail_fraction(self) -> float:
        """Fraction of capacity outside the segment-sorted prefixes —
        slots the planner's prefix-table doc runs cannot cover (PR 5
        layout); grows with churn, reset to 0 by compaction."""
        return float(1.0 - self.sorted_upto.sum()
                     / max(self.m * self.d_pad, 1))

    def _mirror_staleness(self) -> None:
        reg = self.registry
        reg.gauge("index_live_docs", "live (non-tombstoned) docs").set(
            self.live)
        reg.gauge("index_slack",
                  "stale-bound contributors per live doc "
                  "(compaction trigger)").set(self.slack())
        reg.gauge("index_unsorted_tail_fraction",
                  "capacity fraction outside segment-sorted "
                  "prefixes").set(self.unsorted_tail_fraction())

    def needs_compaction(self) -> bool:
        return self.slack() > self.compact_threshold

    def maybe_compact(self) -> bool:
        if self.needs_compaction():
            self.compact()
            return True
        return False

    def compact(self, rebalance: bool = True,
                requantize: bool | None = None) -> None:
        """Re-pack live docs through the shared offline build path:
        rebuilds seg_max tight, re-randomizes segments, optionally
        rebalances overfull clusters, and (when clips happened or
        ``requantize=True``) re-derives the quantization scale from the
        retained *unclipped* float weights — the stored uint8 values
        alone max out at exactly ``255 * scale`` and could never widen
        the range."""
        t0 = time.perf_counter()
        if requantize is None:
            requantize = bool(self._clipped)
        # the compaction *barrier*: log the intent (flags + the rng state
        # the re-segmentation will consume) before any repacking, so a
        # crash mid-pack replays the whole compaction from the record
        self.op_seq += 1
        if self.wal is not None and not self._replaying:
            self.wal.append_compact(self.op_seq, rebalance, requantize,
                                    self._rng.bit_generator.state)

        live_c, live_s = np.nonzero(self.doc_mask)
        n_live = live_c.size
        safe_tids = self.doc_tids[live_c, live_s]          # (n_live, t_pad)
        tw_u8 = self.doc_tw[live_c, live_s]
        ids = self.doc_ids[live_c, live_s].astype(np.int64)
        assign = live_c.astype(np.int64)

        if requantize and n_live:
            floats = tw_u8.astype(np.float32) * self.scale
            true_max = float(floats.max()) if floats.size else 0.0
            for _, cw in self._clipped.values():
                true_max = max(true_max, float(cw.max()))
            new_scale = max(true_max, 1e-6) / 255.0
            tw_u8 = np.clip(np.round(floats / new_scale), 0, 255
                            ).astype(np.uint8)
            # clipped docs re-enter at full resolution from their true
            # float weights instead of the saturated uint8 copies
            row_of = {int(i): r for r, i in enumerate(ids)}
            for did, (ct, cw) in self._clipped.items():
                r = row_of.get(did)
                if r is None:
                    continue
                row_t = np.full(self.t_pad, self.vocab, safe_tids.dtype)
                row_w = np.zeros(self.t_pad, np.uint8)
                row_t[: ct.size] = ct.astype(safe_tids.dtype)
                row_w[: ct.size] = np.clip(np.round(cw / new_scale), 0, 255)
                safe_tids[r] = row_t
                tw_u8[r] = row_w
            self.scale = new_scale
            self._clipped.clear()

        if rebalance:
            assign = capacity_rebalance(assign, self.m, self.d_pad)

        fault_point("compact.mid_pack",
                    self.wal.path if self.wal is not None else None)
        packed = pack_clusters(
            safe_tids, tw_u8, assign, self.m, self.n_seg, self.d_pad,
            self.vocab, doc_ids=ids, seg_method=self.seg_method,
            rng=self._rng)
        self.doc_tids = packed["doc_tids"]
        self.doc_tw = packed["doc_tw"]
        self.doc_mask = packed["doc_mask"]
        self.doc_ids = packed["doc_ids"]
        self.doc_seg = packed["doc_seg"]
        self.doc_seg_mod = packed["doc_seg_mod"]
        self.seg_max_stacked = packed["seg_max_stacked"]
        self.seg_max = self.seg_max_stacked[:, : self.n_seg]
        self.seg_max_collapsed = self.seg_max_stacked[:, self.n_seg]
        self.super_of = packed["super_of"]
        self.super_members = packed["super_members"]
        self.super_max_stacked = packed["super_max_stacked"]
        self.super_max = self.super_max_stacked[:, : self.n_seg]
        self.super_max_collapsed = self.super_max_stacked[:, self.n_seg]
        self.seg_offsets = packed["seg_offsets"]
        self.sorted_upto = packed["sorted_upto"]
        self.cluster_ndocs = packed["cluster_ndocs"]

        cl, sl = np.nonzero(self.doc_mask)
        self._loc = {int(d): (int(c), int(s))
                     for d, c, s in zip(self.doc_ids[cl, sl], cl, sl)}
        self.n_deletes = 0
        self.n_clipped = len(self._clipped)   # 0 unless requantize skipped
        self.n_compactions += 1
        if self.registry is not None:
            self.registry.counter("index_compactions_total",
                                  "index compactions run").inc()
            self.registry.histogram(
                "index_compaction_duration_seconds",
                "writer-side pause per compaction (re-pack + "
                "requantize + rebalance)",
                buckets=DURATION_BUCKETS_S).observe(
                time.perf_counter() - t0)
            self._mirror_staleness()

    def live_ids(self) -> np.ndarray:
        """Global ids of all live (non-tombstoned) documents."""
        return np.fromiter(self._loc.keys(), np.int64, len(self._loc))

    # -- durability --------------------------------------------------------
    def _host_index(self) -> ClusterIndex:
        """ClusterIndex over the live numpy mirrors (no device copy) —
        checkpoint writes go straight from host memory."""
        return ClusterIndex(
            doc_tids=self.doc_tids, doc_tw=self.doc_tw,
            doc_mask=self.doc_mask, doc_ids=self.doc_ids,
            doc_seg=self.doc_seg, doc_seg_mod=self.doc_seg_mod,
            seg_max_stacked=self.seg_max_stacked,
            seg_offsets=self.seg_offsets, sorted_upto=self.sorted_upto,
            scale=np.float32(self.scale),
            cluster_ndocs=self.cluster_ndocs,
            super_of=self.super_of, super_members=self.super_members,
            super_max_stacked=self.super_max_stacked,
            vocab=self.vocab, n_seg=self.n_seg)

    def writer_state(self) -> dict:
        """The replay context a checkpoint must carry for recovery to be
        bit-exact: op counter, exact (float64) quantization scale, rng
        state, clipped-doc side table, and the WAL horizon."""
        return {
            "op_seq": self.op_seq,
            "next_doc_id": self._next_doc_id,
            # the manifest's own "scale" field round-trips through
            # float32; replayed quantization needs the exact value
            "scale": float(self.scale),
            "rng_state": self._rng.bit_generator.state,
            "compact_threshold": float(self.compact_threshold),
            "seg_method": self.seg_method,
            "counters": {
                "n_inserts": self.n_inserts,
                "n_deletes": self.n_deletes,
                "n_clipped": self.n_clipped,
                "n_compactions": self.n_compactions,
            },
            "clipped": {
                str(d): {"tids": t.tolist(),
                         "tw": [float(x) for x in w]}
                for d, (t, w) in self._clipped.items()},
            "wal_lsn": self.wal.lsn if self.wal is not None else 0,
        }

    def _restore_writer_state(self, ws: dict) -> None:
        self.op_seq = int(ws["op_seq"])
        self._next_doc_id = int(ws["next_doc_id"])
        self.scale = float(ws["scale"])
        self._rng.bit_generator.state = ws["rng_state"]
        self.compact_threshold = float(
            ws.get("compact_threshold", self.compact_threshold))
        c = ws.get("counters", {})
        self.n_inserts = int(c.get("n_inserts", 0))
        self.n_deletes = int(c.get("n_deletes", 0))
        self.n_clipped = int(c.get("n_clipped", 0))
        self.n_compactions = int(c.get("n_compactions", 0))
        self._clipped = {
            int(d): (np.asarray(v["tids"], np.int64),
                     np.asarray(v["tw"], np.float32))
            for d, v in ws.get("clipped", {}).items()}

    def checkpoint(self, directory: str, epoch: int = 0,
                   n_shards: int = 1) -> str:
        """Write a durable checkpoint under ``directory`` (arrays in
        ``<directory>/snapshot``, checksummed v5 manifest with the writer
        replay state in ``extra``) and retire WAL segments it covers.
        The WAL is fsync'd first, so the recorded lsn only ever points at
        durable records."""
        from repro_torch.lifecycle.persist import save_index
        state = self.writer_state()
        if self.wal is not None:
            self.wal.flush(fsync=True)
        path = save_index(os.path.join(directory, SNAPSHOT_SUBDIR),
                          self._host_index(), epoch=epoch,
                          n_shards=n_shards, extra={"writer": state})
        if self.wal is not None:
            self.wal.truncate_upto(int(state["wal_lsn"]))
        return path

    @classmethod
    def recover(cls, directory: str,
                centroids: np.ndarray | None = None,
                registry=None,
                attach_wal: bool = True,
                fsync: str = "interval",
                **wal_kwargs) -> tuple["MutableIndex", dict]:
        """Rebuild the uncrashed index from ``directory``: last intact
        checkpoint + WAL-tail replay, bit-exact (tests/test_lifecycle.py
        pins array-for-array equality, rng state included).

        Pass the same ``centroids`` the original writer used (they are
        placement inputs, not checkpoint state); a mismatch is caught by
        the per-record placement assertions, not silently absorbed.
        Returns ``(index, stats)`` — stats carry the replay count, torn
        tail flag, last published epoch and duration; with ``registry``
        they also land in ``wal_records_replayed_total`` and the
        ``index_recovery_duration_seconds`` histogram.
        """
        from repro_torch.lifecycle.persist import load_index
        t0 = time.perf_counter()
        # the checkpoint stays on the host: the mirrors are host arrays
        index, manifest = load_index(
            os.path.join(directory, SNAPSHOT_SUBDIR), registry=registry,
            device="cpu")
        ws = (manifest.get("extra") or {}).get("writer")
        if ws is None:
            raise ValueError(
                f"{directory!r} holds a plain save_index checkpoint, not "
                f"a durable one (no writer state; use "
                f"MutableIndex.checkpoint to write recoverable ones)")
        mi = cls(index, centroids=centroids,
                 compact_threshold=float(ws.get("compact_threshold", .25)),
                 seg_method=ws.get("seg_method", "random_uniform"),
                 registry=registry)
        mi._restore_writer_state(ws)
        records, wal_stats = read_wal(
            os.path.join(directory, WAL_SUBDIR),
            from_lsn=int(ws.get("wal_lsn", 0)))
        last_epoch = int(manifest.get("epoch", 0))
        n_applied = 0
        mi._replaying = True
        try:
            for rec in records:
                if rec["op"] == "epoch":
                    last_epoch = int(rec["epoch"])
                    continue
                mi._apply_record(rec)
                n_applied += 1
        finally:
            mi._replaying = False
        if attach_wal:
            mi.wal = WriteAheadLog(os.path.join(directory, WAL_SUBDIR),
                                   fsync=fsync, registry=registry,
                                   **wal_kwargs)
        duration = time.perf_counter() - t0
        if registry is not None:
            registry.counter(
                "wal_records_replayed_total",
                "WAL records replayed during recovery").inc(len(records))
            registry.histogram(
                "index_recovery_duration_seconds",
                "checkpoint load + WAL tail replay, per recovery",
                buckets=DURATION_BUCKETS_S).observe(duration)
        stats = {
            "checkpoint_epoch": int(manifest.get("epoch", 0)),
            "last_published_epoch": last_epoch,
            "checkpoint_op_seq": int(ws["op_seq"]),
            "op_seq": mi.op_seq,
            "n_replayed": n_applied,
            "torn_tail": bool(wal_stats["torn"]),
            "duration_s": duration,
        }
        return mi, stats

    def _apply_record(self, rec: dict) -> None:
        """Replay one WAL record through the normal write path, asserting
        the logged outcome (op ordering, insert placement) so replay
        divergence fails loudly instead of serving a silently different
        index."""
        if rec["op_seq"] != self.op_seq + 1:
            raise WalReplayError(
                f"WAL record op_seq {rec['op_seq']} does not follow "
                f"state at op_seq {self.op_seq}")
        if rec["op"] == "insert":
            did = self.insert(rec["tids"], rec["tw"],
                              doc_id=rec["doc_id"],
                              dense_rep=rec["dense_rep"])
            c, slot = self._loc[did]
            got = (c, slot, int(self.doc_seg[c, slot]))
            logged = (rec["c"], rec["slot"], rec["seg"])
            if got != logged:
                raise WalReplayError(
                    f"replayed insert of doc {did} landed at "
                    f"(c, slot, seg)={got}, log says {logged} — replay "
                    f"diverged (different centroids or rng state?)")
        elif rec["op"] == "delete":
            if not self.delete(rec["doc_id"]):
                raise WalReplayError(
                    f"replayed delete of doc {rec['doc_id']} found "
                    f"nothing to delete")
        elif rec["op"] == "compact":
            # restore the logged rng state (idempotent when replay is in
            # lockstep) so the re-segmentation consumes the same stream
            self._rng.bit_generator.state = rec["rng_state"]
            self.compact(rebalance=rec["rebalance"],
                         requantize=rec["requantize"])
        else:
            raise WalReplayError(f"unknown WAL record {rec['op']!r}")

    # -- read-side handoff ------------------------------------------------
    def snapshot(self, device: str | torch.device | None = None
                 ) -> ClusterIndex:
        """Immutable copy of the current state on ``device`` (None: the
        CUDA card) that owns its memory: ``torch.from_numpy`` would alias
        the mirrors, so every field is copied, and later mutation never
        leaks into a published snapshot. On the card the copy is complete
        when this returns (the copying stream is synchronized), so a
        reader on any other stream sees the whole index, never part of
        it."""
        dev = resolve_device(device)
        host = self._host_index()
        snap = ClusterIndex(
            **{f: torch.from_numpy(np.asarray(getattr(host, f))).to(
                dev, copy=True) for f in INDEX_FIELDS},
            vocab=self.vocab, n_seg=self.n_seg)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        return snap

    def to_sparse_docs(self, device: str | torch.device | None = None
                       ) -> tuple[SparseDocs, np.ndarray, np.ndarray]:
        """Live docs as (SparseDocs on ``device``, assignment, global
        ids) — the rebuild-from-scratch equivalent the churn tests
        compare against. Weights are dequantized with the pinned
        scale."""
        dev = resolve_device(device)
        live_c, live_s = np.nonzero(self.doc_mask)
        tids = self.doc_tids[live_c, live_s].astype(np.int32)
        tw = self.doc_tw[live_c, live_s].astype(np.float32) * self.scale
        mask = tids < self.vocab
        tids = np.where(mask, tids, -1)
        docs = SparseDocs(tids=torch.from_numpy(tids).to(dev),
                          tw=torch.from_numpy(tw).to(dev),
                          mask=torch.from_numpy(mask).to(dev),
                          vocab=self.vocab)
        return docs, live_c.astype(np.int64), \
            self.doc_ids[live_c, live_s].astype(np.int64)
