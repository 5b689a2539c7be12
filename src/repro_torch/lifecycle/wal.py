"""Write-ahead log for the mutable index: logical redo records (the
port's own copy of ``repro/lifecycle/wal.py``, byte for byte the same
framing, so a log written by either package replays in the other).

Durability model (docs/lifecycle.md §durability): the writer appends a
*logical* record — the op and its arguments, not the resulting array
bytes — before mutating any index array, and recovery replays the tail
through the exact same ``MutableIndex`` code paths on top of the last
checkpoint. Because the checkpoint also captures the writer's rng state
(segment draws, compaction segmentation) and exact float scale, replay
consumes randomness in lockstep with the original run and reproduces the
uncrashed index bit-for-bit; every INSERT record carries the placement
``(cluster, slot, segment)`` the original run computed purely so replay
can *assert* the determinism instead of trusting it.

On-disk layout — a directory of rotating segment files::

    wal-0000000000000000.log      records with lsn in [0, n1)
    wal-00000000000n1.log         records with lsn in [n1, ...)

Each segment starts with a 14-byte header (magic ``RWAL``, format
version, first lsn) followed by length + CRC32 framed records::

    [u32 payload_len][u32 crc32(payload)][payload]

A torn tail — the partially-written or bit-flipped last frame a crash
leaves behind — fails the length or CRC check; the reader truncates at
the first bad frame and replays only the durable prefix, and re-opening
for append repairs the file to that prefix. fsync policy is configurable:
``always`` (fsync every record), ``interval`` (grouped: every
``sync_every_n`` records or ``sync_interval_s`` seconds), ``off`` (flush
to the OS only — survives process death, not power loss).
"""

from __future__ import annotations

import glob
import io
import json
import os
import struct
import time
import zlib

import numpy as np

from repro_torch.lifecycle import faults as _faults
from repro_torch.lifecycle.faults import fault_point

_MAGIC = b"RWAL"
_WAL_VERSION = 1
_HEADER = struct.Struct("<4sHQ")            # magic, version, start lsn
_FRAME = struct.Struct("<II")               # payload length, crc32
_HEADER_SIZE = _HEADER.size
_FRAME_SIZE = _FRAME.size

OP_INSERT = 1
OP_DELETE = 2
OP_COMPACT = 3
OP_EPOCH = 4

_INSERT = struct.Struct("<BQqIIIHH")    # op, op_seq, doc_id, c, slot, seg,
                                        # n_terms, dense_dim
_DELETE = struct.Struct("<BQq")         # op, op_seq, doc_id
_COMPACT = struct.Struct("<BQB")        # op, op_seq, flags (+ rng json)
_EPOCH = struct.Struct("<BQQ")          # op, op_seq, epoch

FSYNC_POLICIES = ("always", "interval", "off")

#: subdirectory names of a durable index directory (mutable.checkpoint /
#: MutableIndex.recover agree on these)
SNAPSHOT_SUBDIR = "snapshot"
WAL_SUBDIR = "wal"


# -- record codecs ---------------------------------------------------------
def encode_insert(op_seq: int, doc_id: int, c: int, slot: int, seg: int,
                  tids: np.ndarray, tw: np.ndarray,
                  dense_rep: np.ndarray | None) -> bytes:
    """``tids``/``tw`` must be C-contiguous int64/float32 (the insert
    path guarantees this; other callers should convert first)."""
    if dense_rep is None:
        return (_INSERT.pack(OP_INSERT, op_seq, doc_id, c, slot, seg,
                             tids.size, 0)
                + tids.tobytes() + tw.tobytes())
    dense = np.ascontiguousarray(dense_rep, np.float32)
    return (_INSERT.pack(OP_INSERT, op_seq, doc_id, c, slot, seg,
                         tids.size, dense.size)
            + tids.tobytes() + tw.tobytes() + dense.tobytes())


def encode_delete(op_seq: int, doc_id: int) -> bytes:
    return _DELETE.pack(OP_DELETE, op_seq, doc_id)


def encode_compact(op_seq: int, rebalance: bool, requantize: bool,
                   rng_state: dict) -> bytes:
    flags = int(rebalance) | (int(requantize) << 1)
    return (_COMPACT.pack(OP_COMPACT, op_seq, flags)
            + json.dumps(rng_state).encode())


def encode_epoch(op_seq: int, epoch: int) -> bytes:
    return _EPOCH.pack(OP_EPOCH, op_seq, epoch)


def decode_record(payload: bytes) -> dict:
    op = payload[0]
    if op == OP_INSERT:
        (_, op_seq, doc_id, c, slot, seg,
         n, dense_dim) = _INSERT.unpack_from(payload)
        off = _INSERT.size
        tids = np.frombuffer(payload, np.int64, n, off)
        off += 8 * n
        tw = np.frombuffer(payload, np.float32, n, off)
        off += 4 * n
        dense = (np.frombuffer(payload, np.float32, dense_dim, off)
                 if dense_dim else None)
        return {"op": "insert", "op_seq": op_seq, "doc_id": doc_id,
                "c": c, "slot": slot, "seg": seg,
                "tids": tids, "tw": tw, "dense_rep": dense}
    if op == OP_DELETE:
        _, op_seq, doc_id = _DELETE.unpack(payload)
        return {"op": "delete", "op_seq": op_seq, "doc_id": doc_id}
    if op == OP_COMPACT:
        _, op_seq, flags = _COMPACT.unpack_from(payload)
        return {"op": "compact", "op_seq": op_seq,
                "rebalance": bool(flags & 1),
                "requantize": bool(flags & 2),
                "rng_state": json.loads(payload[_COMPACT.size:])}
    if op == OP_EPOCH:
        _, op_seq, epoch = _EPOCH.unpack(payload)
        return {"op": "epoch", "op_seq": op_seq, "epoch": epoch}
    raise ValueError(f"unknown WAL opcode {op}")


# -- segment scanning ------------------------------------------------------
def _segment_paths(directory: str) -> list[str]:
    return sorted(glob.glob(os.path.join(directory, "wal-*.log")))


def _segment_path(directory: str, start_lsn: int) -> str:
    return os.path.join(directory, f"wal-{start_lsn:016d}.log")


def _read_header(f: io.BufferedReader) -> int | None:
    """Start lsn of the segment, or None when the header is unreadable."""
    raw = f.read(_HEADER.size)
    if len(raw) != _HEADER.size:
        return None
    magic, version, start_lsn = _HEADER.unpack(raw)
    if magic != _MAGIC or version != _WAL_VERSION:
        return None
    return start_lsn


def _scan_segment(path: str) -> tuple[int | None, list[bytes], int, bool]:
    """Walk one segment's frames.

    Returns ``(start_lsn, payloads, valid_end_offset, torn)`` where
    ``torn`` means bytes exist past the last frame that passes the length
    + CRC checks (the signature a torn write leaves).
    """
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        start_lsn = _read_header(f)
        if start_lsn is None:
            return None, [], 0, size > 0
        payloads: list[bytes] = []
        off = _HEADER.size
        while True:
            head = f.read(_FRAME.size)
            if len(head) == 0:
                return start_lsn, payloads, off, False
            if len(head) < _FRAME.size:
                return start_lsn, payloads, off, True
            length, crc = _FRAME.unpack(head)
            # no record is empty (every opcode is >= 1 byte); a zero
            # length means a zero-filled torn region, which would
            # otherwise pass the CRC check since crc32(b"") == 0
            if length == 0:
                return start_lsn, payloads, off, True
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                return start_lsn, payloads, off, True
            payloads.append(payload)
            off += _FRAME.size + length


def read_wal(directory: str, from_lsn: int = 0
             ) -> tuple[list[dict], dict]:
    """Replay-read all records with ``lsn >= from_lsn``.

    Reading stops at the first bad frame anywhere in the sequence (a torn
    tail truncates the log; records past it were never acknowledged as
    durable). Returns ``(records, stats)`` — each record dict carries its
    ``lsn`` — with stats ``{n_records, n_segments, torn, end_lsn}``.
    """
    records: list[dict] = []
    torn = False
    n_segments = 0
    lsn = 0
    for path in _segment_paths(directory) if os.path.isdir(directory) \
            else []:
        start_lsn, payloads, _, seg_torn = _scan_segment(path)
        if start_lsn is None:
            torn = torn or seg_torn
            break
        n_segments += 1
        lsn = start_lsn
        for payload in payloads:
            if lsn >= from_lsn:
                rec = decode_record(payload)
                rec["lsn"] = lsn
                records.append(rec)
            lsn += 1
        if seg_torn:
            torn = True
            break
    return records, {"n_records": len(records), "n_segments": n_segments,
                     "torn": torn, "end_lsn": lsn}


class WriteAheadLog:
    """Append-only, CRC-framed, segment-rotating redo log.

    Single-writer (same contract as MutableIndex). ``lsn`` is the log
    sequence number the *next* append will get; checkpoints record it so
    recovery replays only the tail, and :meth:`truncate_upto` reclaims
    whole segments the newest checkpoint has made redundant.
    """

    def __init__(self, directory: str, fsync: str = "interval",
                 sync_every_n: int = 1024, sync_interval_s: float = 0.2,
                 segment_bytes: int = 4 << 20, registry=None):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"fsync policy must be one of {FSYNC_POLICIES}, "
                f"got {fsync!r}")
        self.directory = directory
        self.fsync = fsync
        self._fsync_always = fsync == "always"
        self.sync_every_n = int(sync_every_n)
        self.sync_interval_s = float(sync_interval_s)
        self.segment_bytes = int(segment_bytes)
        self.registry = registry
        os.makedirs(directory, exist_ok=True)

        self._pending = 0
        self._last_sync = time.monotonic()
        self._f: io.BufferedWriter | None = None
        self._lsn = 0
        self._size = 0
        self._buf: list[bytes] = []      # payloads framed+written in batches
        self._open_tail()

    # -- open / rotation ---------------------------------------------------
    def _open_tail(self) -> None:
        """Adopt an existing log: repair the last segment's torn tail and
        position the next lsn after the last durable record."""
        paths = _segment_paths(self.directory)
        next_lsn = 0
        for i, path in enumerate(paths):
            start_lsn, payloads, valid_end, torn = _scan_segment(path)
            if start_lsn is None:
                # unreadable header: nothing durable in it — drop it (and
                # anything after it, which replay could never reach)
                for p in paths[i:]:
                    os.remove(p)
                paths = paths[:i]
                self._note_repair()
                break
            next_lsn = start_lsn + len(payloads)
            if torn:
                os.truncate(path, valid_end)
                for p in paths[i + 1:]:      # frames past a tear are dead
                    os.remove(p)
                paths = paths[:i + 1]
                self._note_repair()
                break
        self._lsn = next_lsn
        if paths and os.path.getsize(paths[-1]) < self.segment_bytes:
            self._f = open(paths[-1], "ab")
            self._size = os.path.getsize(paths[-1])
        else:
            self._new_segment()

    def _note_repair(self) -> None:
        if self.registry is not None:
            self.registry.counter(
                "wal_torn_tail_truncations_total",
                "torn WAL tails repaired at open").inc()

    def _new_segment(self) -> None:
        if self._f is not None:
            self._sync(force=True)
            self._f.close()
        path = _segment_path(self.directory, self._lsn)
        self._f = open(path, "wb")
        self._f.write(_HEADER.pack(_MAGIC, _WAL_VERSION, self._lsn))
        self._f.flush()
        self._size = _HEADER.size

    @property
    def lsn(self) -> int:
        """The lsn the next appended record will receive."""
        return self._lsn

    @property
    def path(self) -> str:
        return self._f.name

    # -- append ------------------------------------------------------------
    #: frames are assembled and pushed to the OS in batches of this many
    #: records — the process-crash loss window for the "off"/"interval"
    #: policies (power-loss durability is governed by fsync alone)
    WRITE_BATCH = 64

    def append(self, payload: bytes) -> int:
        size = self._size + _FRAME_SIZE + len(payload)
        if size > self.segment_bytes and self._size > _HEADER_SIZE:
            self._new_segment()
            size = self._size + _FRAME_SIZE + len(payload)
        if _faults._ACTIVE is not None:
            fault_point("wal.append.pre_write", self._f.name)
        self._buf.append(payload)
        self._size = size
        self._pending += 1
        lsn = self._lsn
        self._lsn += 1
        if self.registry is not None:
            self.registry.counter("wal_records_appended_total",
                                  "records appended to the WAL").inc()
            self.registry.counter("wal_bytes_written_total",
                                  "WAL bytes written").inc(
                                      _FRAME_SIZE + len(payload))
        if self._fsync_always:
            self._sync(force=True)
        elif (len(self._buf) >= self.WRITE_BATCH
              or self._pending >= self.sync_every_n):
            self._maybe_sync()
        return lsn

    def append_insert(self, op_seq, doc_id, c, slot, seg, tids, tw,
                      dense_rep=None) -> int:
        return self.append(encode_insert(op_seq, doc_id, c, slot, seg,
                                         tids, tw, dense_rep))

    def append_delete(self, op_seq, doc_id) -> int:
        return self.append(encode_delete(op_seq, doc_id))

    def append_compact(self, op_seq, rebalance, requantize,
                       rng_state) -> int:
        return self.append(encode_compact(op_seq, rebalance, requantize,
                                          rng_state))

    def append_epoch(self, op_seq, epoch) -> int:
        return self.append(encode_epoch(op_seq, epoch))

    # -- durability --------------------------------------------------------
    def _write_out(self) -> None:
        """Frame the buffered payloads and push them to the OS in one
        write — batching keeps the per-append cost to a list push."""
        if self._buf:
            pack, crc = _FRAME.pack, zlib.crc32
            self._f.write(b"".join(
                pack(len(p), crc(p)) + p for p in self._buf))
            self._buf.clear()

    def _maybe_sync(self) -> None:
        if self.fsync == "always":
            self._sync(force=True)
        elif self.fsync == "interval":
            self._write_out()
            if (self._pending >= self.sync_every_n
                    or time.monotonic() - self._last_sync
                    >= self.sync_interval_s):
                self._sync(force=True)
        else:                                # "off": OS-durable only
            self._write_out()
            self._f.flush()
            self._pending = 0

    def _sync(self, force: bool = False) -> None:
        self._write_out()
        self._f.flush()
        if force:
            fault_point("wal.append.pre_fsync", self._f.name)
            os.fsync(self._f.fileno())
            if self.registry is not None:
                self.registry.counter("wal_fsyncs_total",
                                      "WAL fsync calls").inc()
        self._pending = 0
        self._last_sync = time.monotonic()

    def flush(self, fsync: bool = True) -> None:
        """Push buffered frames out; ``fsync=True`` forces the disk sync
        regardless of policy (checkpoints call this before trusting the
        lsn they record)."""
        self._sync(force=fsync)

    # -- retention ---------------------------------------------------------
    def truncate_upto(self, lsn: int) -> int:
        """Remove whole segments whose records all have lsn < ``lsn``
        (they are covered by a newer checkpoint). Returns segments
        removed. The active segment is never removed."""
        paths = _segment_paths(self.directory)
        removed = 0
        for path, nxt in zip(paths, paths[1:]):
            if path == self._f.name:
                break
            with open(nxt, "rb") as f:
                nxt_start = _read_header(f)
            if nxt_start is not None and nxt_start <= lsn:
                os.remove(path)
                removed += 1
            else:
                break
        return removed

    def close(self) -> None:
        if self._f is not None:
            self._sync(force=True)
            self._f.close()
            self._f = None
