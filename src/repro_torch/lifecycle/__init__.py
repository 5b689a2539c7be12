"""Online index lifecycle: incremental mutation, epoch snapshots,
persistence, and the crash-safe write plane (WAL + checksummed
checkpoints + recovery) — the PyTorch port of ``repro.lifecycle``, with
the same exports. Checkpoints and WALs are byte-compatible with the JAX
package's. See docs/lifecycle.md for the rank-safety and durability
arguments."""

from repro_torch.lifecycle.faults import (FaultInjected, FaultSchedule,
                                          fault_point, install)
from repro_torch.lifecycle.mutable import (IndexFullError, MutableIndex,
                                           WalReplayError)
from repro_torch.lifecycle.persist import (FORMAT_VERSION,
                                           CheckpointCorruptError,
                                           load_index, read_manifest,
                                           save_index, verify_checkpoint)
from repro_torch.lifecycle.snapshot import (DurableIndexWriter,
                                            IndexSnapshot, IndexWriter,
                                            SnapshotPublisher)
from repro_torch.lifecycle.wal import WriteAheadLog, read_wal

__all__ = [
    "FORMAT_VERSION",
    "CheckpointCorruptError",
    "DurableIndexWriter",
    "FaultInjected",
    "FaultSchedule",
    "IndexFullError",
    "IndexSnapshot",
    "IndexWriter",
    "MutableIndex",
    "SnapshotPublisher",
    "WalReplayError",
    "WriteAheadLog",
    "fault_point",
    "install",
    "load_index",
    "read_manifest",
    "read_wal",
    "save_index",
    "verify_checkpoint",
]
