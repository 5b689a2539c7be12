"""Epoch-based snapshot publishing: immutable reads over a mutating index
(PyTorch port of ``repro/lifecycle/snapshot.py``).

The serving invariant: a query only ever runs against one
:class:`IndexSnapshot`, pinned for the whole request. The writer batches
mutations into a :class:`MutableIndex` and publishes a fresh copy on its
device as a new epoch; the swap is a single reference assignment under a
lock, so readers either see the old epoch or the new one — never a
half-written index. On the card that needs the copy to be *complete*
before the swap: a reader on another stream (the pipelined engine's
planner and executor streams) does not order itself after the copying
stream, so :meth:`MutableIndex.snapshot` synchronizes the copy before it
returns, and only then is the epoch published. In-flight queries keep
their pinned handle alive (plain Python refcounting), which is exactly
double-buffering: the previous epoch's tensors survive until the last
reader drops them, and the serving engine unpins only after its closing
``torch.cuda.synchronize``, so no kernel still reads an epoch whose
memory went back to the caching allocator.

Geometry (m, d_pad, t_pad, n_seg, vocab) is fixed at build time, so
every epoch has the same shapes; a compaction changes the contents and,
when it requantizes, ``scale``, which every kernel reads per call.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import weakref

import numpy as np
import torch

from repro_torch.core.types import ClusterIndex
from repro_torch.device import check_on, resolve_device
from repro_torch.lifecycle.mutable import MutableIndex
from repro_torch.lifecycle.wal import (SNAPSHOT_SUBDIR, WAL_SUBDIR,
                                       WriteAheadLog)


@dataclasses.dataclass(frozen=True)
class IndexSnapshot:
    """An immutable, epoch-stamped index handle."""

    index: ClusterIndex
    epoch: int
    n_docs: int
    published_s: float

    @staticmethod
    def of(index: ClusterIndex, epoch: int,
           n_docs: int | None = None) -> "IndexSnapshot":
        """``n_docs``: the live count when the caller knows it on the
        host (the writers pass their mirror's ``cluster_ndocs`` sum);
        None reads it from the index (one device read on the card)."""
        if n_docs is None:
            n_docs = int(index.doc_mask.sum())
        return IndexSnapshot(index=index, epoch=epoch, n_docs=int(n_docs),
                             published_s=time.time())


class SnapshotPublisher:
    """Atomic epoch swap between one writer and many readers.

    GC accounting (ROADMAP "snapshot GC metrics"): readers that pin
    epochs through :meth:`pin`/:meth:`unpin` are counted per epoch, and
    every published snapshot carries a ``weakref.finalize`` hook that
    records, when the *superseded* snapshot's last reference drops, how
    long it outlived its replacement. ``max_epoch_lifetime_s`` is the
    worst observed overstay — the double-buffering depth in seconds; a
    growing value means some reader is sitting on an old epoch and the
    publisher is effectively triple-or-more-buffered.

    With ``registry`` (a :class:`repro_torch.obs.MetricsRegistry`) every
    swap, pin and collection is mirrored into ``lifecycle_*`` metrics, so
    the exposition endpoint sees writer-side state even between searches
    (the serving engine mirrors the same numbers per request).
    """

    def __init__(self, index: ClusterIndex | None = None,
                 registry=None, n_docs: int | None = None):
        self.registry = registry
        self._lock = threading.Lock()
        self._current: IndexSnapshot | None = None
        # weakref only: the publisher must not pin the N-1 epoch's device
        # arrays itself — old epochs live exactly as long as their last
        # in-flight reader, which is the whole double-buffering contract
        self._previous: weakref.ref | None = None
        self._readers: dict[int, int] = {}       # epoch -> live pin count
        self._collected_epochs = 0
        self._max_lifetime_s = 0.0
        if index is not None:
            self.publish(index, n_docs=n_docs)

    def publish(self, index: ClusterIndex, min_epoch: int = 0,
                n_docs: int | None = None) -> IndexSnapshot:
        """Swap in a new snapshot (an index whose tensors are complete:
        :meth:`MutableIndex.snapshot` returns only such). ``min_epoch``
        floors the assigned epoch — recovery uses it so numbering
        resumes monotonically from the last epoch the WAL saw published,
        even into a fresh publisher. ``n_docs`` as in
        :meth:`IndexSnapshot.of`."""
        with self._lock:
            epoch = self._current.epoch + 1 if self._current else 0
            epoch = max(epoch, min_epoch)
            snap = IndexSnapshot.of(index, epoch, n_docs)
            if self._current is not None:
                old = self._current
                self._previous = weakref.ref(old)
                # the old epoch starts overstaying *now*; the finalizer
                # fires when its last reference (reader or `previous`
                # probe) drops, never keeping the snapshot alive itself
                weakref.finalize(
                    old, self._note_collected, old.epoch, time.time())
            self._current = snap
        if self.registry is not None:
            self.registry.counter(
                "lifecycle_epoch_swaps_total",
                "snapshot epochs published").inc()
            self.registry.gauge(
                "lifecycle_epoch", "current published epoch").set(epoch)
        return snap

    def _note_collected(self, epoch: int, superseded_s: float) -> None:
        lifetime = time.time() - superseded_s
        with self._lock:
            self._collected_epochs += 1
            self._max_lifetime_s = max(self._max_lifetime_s, lifetime)
            self._readers.pop(epoch, None)
        if self.registry is not None:
            self.registry.gauge(
                "lifecycle_collected_epochs",
                "superseded epochs garbage-collected").set(
                self._collected_epochs)
            self.registry.gauge(
                "lifecycle_max_epoch_lifetime_seconds",
                "longest any superseded epoch was held alive "
                "by readers").set(self._max_lifetime_s)

    # -- reader accounting -------------------------------------------------
    def pin(self) -> IndexSnapshot:
        """Current snapshot, counted as one live reader of its epoch.
        Pair with :meth:`unpin` (the serving engine does per search)."""
        with self._lock:
            if self._current is None:
                raise RuntimeError("nothing published yet")
            snap = self._current
            self._readers[snap.epoch] = self._readers.get(snap.epoch, 0) + 1
            n_live = sum(self._readers.values())
        self._mirror_pins(n_live)
        return snap

    def unpin(self, snap: IndexSnapshot) -> None:
        with self._lock:
            n = self._readers.get(snap.epoch, 0) - 1
            if n > 0:
                self._readers[snap.epoch] = n
            else:
                self._readers.pop(snap.epoch, None)
            n_live = sum(self._readers.values())
        self._mirror_pins(n_live)

    def _mirror_pins(self, n_live: int) -> None:
        if self.registry is not None:
            self.registry.gauge(
                "lifecycle_pinned_readers",
                "live pinned readers across epochs").set(n_live)

    def reader_counts(self) -> dict[int, int]:
        """Live pinned readers per epoch (only epochs with readers)."""
        with self._lock:
            return dict(self._readers)

    def gc_stats(self) -> dict:
        """GC accounting: epochs collected, worst overstay, live pins."""
        with self._lock:
            return {
                "collected_epochs": self._collected_epochs,
                "max_epoch_lifetime_s": self._max_lifetime_s,
                "live_readers": dict(self._readers),
            }

    @property
    def current(self) -> IndexSnapshot:
        with self._lock:
            if self._current is None:
                raise RuntimeError("nothing published yet")
            return self._current

    @property
    def previous(self) -> IndexSnapshot | None:
        """The N-1 epoch, if some reader still holds it alive (None once
        the last reference drops — the publisher never pins it)."""
        with self._lock:
            return self._previous() if self._previous is not None else None

    @property
    def epoch(self) -> int:
        return self.current.epoch


class IndexWriter:
    """Single-writer mutation batching + epoch publishing + auto-compaction.

    Usage::

        writer = IndexWriter(index, centroids=centers)    # on the card
        engine = RetrievalEngine(writer.publisher, cfg)   # snapshot-aware
        writer.insert(tids, tw); writer.delete(doc_id); ...
        writer.commit()        # compacts if stale, publishes next epoch

    ``device`` (None: the CUDA card) is where every epoch is published;
    ``index`` must already live there, and a fresh publisher serves it
    as epoch 0. The mirrors are read from it once, here.
    """

    def __init__(self, index: ClusterIndex,
                 centroids: np.ndarray | None = None,
                 compact_threshold: float = 0.25,
                 publisher: SnapshotPublisher | None = None,
                 seg_method: str = "random_uniform",
                 seed: int = 0,
                 registry=None,
                 wal=None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        check_on(index.doc_tids, self.device, "index")
        self.mutable = MutableIndex(
            index, centroids=centroids, compact_threshold=compact_threshold,
            seg_method=seg_method, seed=seed, registry=registry, wal=wal)
        self.publisher = publisher if publisher is not None \
            else SnapshotPublisher(index, registry=registry,
                                   n_docs=self.mutable.live)
        self._pending = 0

    @property
    def pending(self) -> int:
        """Mutations applied since the last commit (invisible to readers
        until published)."""
        return self._pending

    def insert(self, tids, tw, doc_id: int | None = None,
               dense_rep=None) -> int:
        out = self.mutable.insert(tids, tw, doc_id=doc_id,
                                  dense_rep=dense_rep)
        self._pending += 1
        return out

    def delete(self, doc_id: int) -> bool:
        ok = self.mutable.delete(doc_id)
        self._pending += int(ok)
        return ok

    def commit(self) -> IndexSnapshot:
        """Compact when slack demands it, then publish the next epoch."""
        self.mutable.maybe_compact()
        snap = self.publisher.publish(self.mutable.snapshot(self.device),
                                      n_docs=self.mutable.live)
        self._pending = 0
        return snap


class DurableIndexWriter(IndexWriter):
    """IndexWriter whose write plane survives crashes.

    One directory holds the whole durable state::

        <directory>/snapshot/    checksummed v5 checkpoint (persist.py)
        <directory>/wal/         redo log segments (wal.py)

    Construction writes the base checkpoint the WAL replays from (unless
    one exists already); every :meth:`commit` stamps an epoch-publish
    record and flushes the log, and every ``checkpoint_every`` commits
    (0 = never automatically) a fresh checkpoint retires the replayed
    prefix. :meth:`recover` rebuilds writer + publisher state after a
    crash — into an *existing* publisher when serving is live, so
    readers keep the last-good epoch pinned until the recovered writer
    republishes (the degraded-mode story in launch/serve.py).
    """

    def __init__(self, index: ClusterIndex, directory: str,
                 fsync: str = "interval",
                 checkpoint_every: int = 8,
                 n_shards: int = 1,
                 centroids: np.ndarray | None = None,
                 compact_threshold: float = 0.25,
                 publisher: SnapshotPublisher | None = None,
                 seg_method: str = "random_uniform",
                 seed: int = 0,
                 registry=None,
                 device: str | torch.device | None = None,
                 **wal_kwargs):
        device = resolve_device(device)      # before anything is written
        os.makedirs(directory, exist_ok=True)
        wal = WriteAheadLog(os.path.join(directory, WAL_SUBDIR),
                            fsync=fsync, registry=registry, **wal_kwargs)
        super().__init__(index, centroids=centroids,
                         compact_threshold=compact_threshold,
                         publisher=publisher, seg_method=seg_method,
                         seed=seed, registry=registry, wal=wal,
                         device=device)
        self.directory = directory
        self.n_shards = n_shards
        self.checkpoint_every = int(checkpoint_every)
        self._commits_since_checkpoint = 0
        self.recovery_stats: dict | None = None
        if not os.path.exists(os.path.join(directory, SNAPSHOT_SUBDIR)):
            self.checkpoint()

    @classmethod
    def recover(cls, directory: str,
                fsync: str = "interval",
                checkpoint_every: int = 8,
                n_shards: int = 1,
                centroids: np.ndarray | None = None,
                publisher: SnapshotPublisher | None = None,
                registry=None,
                device: str | torch.device | None = None,
                **wal_kwargs) -> "DurableIndexWriter":
        """Rebuild writer + publisher state from ``directory`` and
        republish the recovered index on ``device`` (None: the card)."""
        dev = resolve_device(device)
        mutable, stats = MutableIndex.recover(
            directory, centroids=centroids, registry=registry,
            fsync=fsync, **wal_kwargs)
        writer = cls.__new__(cls)
        writer.device = dev
        writer.mutable = mutable
        writer.publisher = publisher if publisher is not None \
            else SnapshotPublisher(registry=registry)
        writer._pending = 0
        writer.directory = directory
        writer.n_shards = n_shards
        writer.checkpoint_every = int(checkpoint_every)
        writer._commits_since_checkpoint = 0
        writer.recovery_stats = stats
        # republish: readers of an existing publisher move off the
        # last-good epoch only now, when the recovered index is whole.
        # Epoch numbering resumes after the last publish the WAL saw, so
        # restart never reuses an epoch readers may have observed.
        writer.publisher.publish(
            mutable.snapshot(dev),
            min_epoch=int(stats.get("last_published_epoch", 0)) + 1,
            n_docs=mutable.live)
        return writer

    def commit(self) -> IndexSnapshot:
        snap = super().commit()
        self.mutable.wal.append_epoch(self.mutable.op_seq, snap.epoch)
        self.mutable.wal.flush(fsync=self.mutable.wal.fsync == "always")
        self._commits_since_checkpoint += 1
        if (self.checkpoint_every
                and self._commits_since_checkpoint >= self.checkpoint_every):
            self.checkpoint()
        return snap

    def checkpoint(self) -> str:
        """Durable checkpoint of the current state (commit-published or
        not); retires the WAL prefix it covers."""
        epoch = self.publisher._current.epoch \
            if self.publisher._current is not None else 0
        path = self.mutable.checkpoint(self.directory, epoch=epoch,
                                       n_shards=self.n_shards)
        self._commits_since_checkpoint = 0
        return path

    def close(self) -> None:
        """Graceful shutdown: final checkpoint, then flush + close the
        WAL — a clean exit recovers with zero replay."""
        self.checkpoint()
        self.mutable.wal.close()
