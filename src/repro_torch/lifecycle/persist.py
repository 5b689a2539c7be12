"""Versioned persistence of ClusterIndex shards (PyTorch port of
``repro/lifecycle/persist.py``: the same format, v6 written, v1-v6
read, so a checkpoint written by either package loads in the other).

Layout (one directory per saved index)::

    <dir>/manifest.json     format version, epoch, geometry, scale, shards
    <dir>/shard_0000.npz    cluster rows [0, r1)
    <dir>/shard_0001.npz    cluster rows [r1, r2) ...

Shards split the cluster (m) axis so a multi-host serving tier can load
only the clusters it owns; a single-host load concatenates them. Fresh
saves are atomic (tmp dir + ``os.replace``); overwriting an existing
checkpoint swaps the old one aside first, so a crash at any point leaves
either the old or the new data intact on disk — ``load_index`` falls back
to the swapped-aside copy if the crash hit the brief window between the
two renames. Same protocol family as training/checkpoint.py.

Since v5 the manifest carries each shard's sha256 and byte length, and
loading *verifies* them: a corrupt or partial checkpoint (bitrot, torn
write, crash between the shard writes and the manifest) is detected
before a single array is deserialized, counted in the obs registry
(``snapshot_corrupt_shards_total``), and the loader walks the fallback
chain — the directory itself, then swapped-aside ``.old-*`` copies
newest-first — taking the first candidate whose checksums all pass.
Only when no candidate is intact does it raise
:class:`CheckpointCorruptError` (distinct from "nothing saved here",
which still raises ``FileNotFoundError``).
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import shutil
import time

import numpy as np
import torch

from repro_torch.core.index import group_superblocks, superblock_tables
from repro_torch.core.types import INDEX_FIELDS, ClusterIndex
from repro_torch.device import resolve_device
from repro_torch.lifecycle.faults import fault_point

# version history:
#   1 — seg_max (m, n_seg, V) per shard, optionally seg_max_collapsed
#   2 — stored stacked bound table seg_max_stacked (m, n_seg + 1, V);
#       v1 shards are still readable: the stacked layout (and the
#       collapsed row, if the shard predates it) is derived at load
#   3 — hoisted modded segment map doc_seg_mod (m, d_pad); v1/v2 shards
#       derive it at load as doc_seg % n_seg (bit-exact: the write paths
#       only ever store in-range segment ids)
#   4 — segment-major physical layout: per-cluster segment prefix table
#       seg_offsets (m, n_seg + 1) + sorted prefix length sorted_upto
#       (m,). v1-v3 shards (arrival-order slots) are re-sorted at load:
#       each cluster's live slots are stable-sorted by segment, which is
#       exactly the permutation pack_clusters applies at build time, so
#       the derived layout is bit-identical to a fresh segment-major
#       pack of the same membership (global doc ids ride along — results
#       are unchanged, only slot order moves)
#   5 — integrity: manifest lists every shard with its sha256 + byte
#       length ("shards": [{file, sha256, bytes}]); loads verify before
#       deserializing. v1-v4 shards predate checksums and load unverified.
#   6 — superblock grouping super_of (m,): the level-0 pruning layer's
#       cluster -> superblock assignment (stable under churn, so it must
#       be stored, not recomputed from drifted bounds). The coarse
#       tables themselves (super_members, super_max_stacked) are *never*
#       stored — they are always derived at load from (super_of,
#       seg_max_stacked), which both keeps shards smaller and makes the
#       dominance invariant true by construction after any load. v1-v5
#       shards derive super_of by re-running the deterministic
#       (rng-free) grouping over the collapsed bound rows — bit-exact
#       vs. a fresh v6 pack of the same index.
FORMAT_VERSION = 6
_READABLE_VERSIONS = (1, 2, 3, 4, 5, 6)


class CheckpointCorruptError(RuntimeError):
    """Every checkpoint candidate (primary + swapped-aside copies) failed
    integrity verification."""

    def __init__(self, directory: str,
                 problems: list[tuple[str, list[str]]]):
        detail = "; ".join(
            f"{cand}: {', '.join(errs)}" for cand, errs in problems)
        super().__init__(
            f"no intact checkpoint for {directory!r} — {detail}")
        self.directory = directory
        self.problems = problems

# cluster-axis-sharded array fields, in manifest order
_FIELDS = ("doc_tids", "doc_tw", "doc_mask", "doc_ids", "doc_seg",
           "doc_seg_mod", "seg_max_stacked", "seg_offsets", "sorted_upto",
           "cluster_ndocs", "super_of")


def _derive_stacked(arrays: dict, manifest: dict) -> "np.ndarray":
    """Legacy (v1) shards: build the stacked table from seg_max plus the
    collapsed row (recomputed when the shard predates it too)."""
    seg_max = arrays.pop("seg_max")
    collapsed = arrays.pop("seg_max_collapsed", None)
    if collapsed is None:
        collapsed = seg_max.max(axis=1)
    return np.concatenate([seg_max, collapsed[:, None]], axis=1)


def _derive_seg_mod(arrays: dict, manifest: dict) -> "np.ndarray":
    """v1/v2 shards predate the hoisted modded segment map."""
    return (arrays["doc_seg"] % manifest["n_seg"]).astype(np.int32)


def _derive_super_of(arrays: dict, manifest: dict) -> "np.ndarray":
    """v1-v5 shards predate the superblock grouping: re-run the
    deterministic grouping over the collapsed bound rows (runs after the
    seg_max_stacked derivation — _DERIVABLE is ordered)."""
    return group_superblocks(arrays["seg_max_stacked"][:, manifest["n_seg"]])


def _derive_segment_major(arrays: dict, manifest: dict) -> None:
    """v1-v3 shards store arrival-order slots: re-sort each cluster's
    slots segment-major in place (stable by segment, live docs first,
    tombstones/padding last) and synthesize the prefix table. The stable
    sort is exactly the permutation ``pack_clusters`` applies at build
    time, so the derived layout is bit-identical to a fresh pack of the
    same membership; tombstoned slots already hold the dead pattern
    (tids == vocab, tw == 0, ids == -1, seg == 0) so moving them to the
    tail reproduces the packed padding exactly."""
    n_seg = manifest["n_seg"]
    mask = arrays["doc_mask"]
    m, d_pad = mask.shape
    key = np.where(mask, arrays["doc_seg_mod"], n_seg)       # dead last
    order = np.argsort(key, axis=1, kind="stable")           # (m, d_pad)
    for f in ("doc_tids", "doc_tw", "doc_mask", "doc_ids", "doc_seg",
              "doc_seg_mod"):
        a = arrays[f]
        idx = order[..., None] if a.ndim == 3 else order
        arrays[f] = np.take_along_axis(a, idx, axis=1)
    counts = np.zeros((m, n_seg), np.int64)
    live_c, live_s = np.nonzero(arrays["doc_mask"])
    np.add.at(counts, (live_c, arrays["doc_seg_mod"][live_c, live_s]), 1)
    seg_offsets = np.zeros((m, n_seg + 1), np.int32)
    seg_offsets[:, 1:] = np.cumsum(counts, axis=1)
    arrays["seg_offsets"] = seg_offsets
    arrays["sorted_upto"] = np.full((m,), d_pad, np.int32)


# fields that may be absent in checkpoints written before they existed;
# each maps to a recompute-from-what-is-there fallback applied at load
_DERIVABLE = {
    "seg_max_stacked": _derive_stacked,
    "doc_seg_mod": _derive_seg_mod,
    "super_of": _derive_super_of,
}
# fields derived jointly by the segment-major migration (they permute
# several arrays at once, so they run after the per-field derivations)
_LAYOUT_FIELDS = ("seg_offsets", "sorted_upto")
# legacy spellings accepted from old shards (loaded, then folded into the
# derivation above instead of becoming index fields)
_LEGACY_FIELDS = ("seg_max", "seg_max_collapsed")


def _shard_rows(m: int, n_shards: int) -> list[int]:
    """Boundaries [0, ..., m] splitting the cluster axis near-evenly."""
    return [round(s * m / n_shards) for s in range(n_shards + 1)]


def _file_digest(path: str) -> tuple[str, int]:
    """(sha256 hexdigest, byte length) of a file, streamed."""
    h = hashlib.sha256()
    nbytes = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return h.hexdigest(), nbytes
            h.update(chunk)
            nbytes += len(chunk)


def _host(x) -> np.ndarray:
    """A field as a host numpy array: a tensor is read once with
    ``.cpu().numpy()``; numpy mirrors pass through."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _tensor(a) -> torch.Tensor:
    """A CPU tensor over ``a``'s memory (0-d arrays included), copying
    only when ``a`` is not C-contiguous."""
    a = np.asarray(a)
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)
    return torch.from_numpy(a)


def save_index(directory: str, index: ClusterIndex, *, epoch: int = 0,
               n_shards: int = 1, extra: dict | None = None) -> str:
    """Atomically write ``index`` under ``directory``; returns the path.
    The fields may be tensors on any device or numpy mirrors."""
    if not 1 <= n_shards <= index.m:
        raise ValueError(f"n_shards must be in [1, m={index.m}]")
    host = {f: _host(getattr(index, f)) for f in _FIELDS}
    rows = _shard_rows(index.m, n_shards)

    parent = os.path.dirname(os.path.abspath(directory)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent,
                       f".tmp-{os.path.basename(directory)}-{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    shard_entries = []
    for s in range(n_shards):
        lo, hi = rows[s], rows[s + 1]
        name = f"shard_{s:04d}.npz"
        path = os.path.join(tmp, name)
        np.savez(path, **{f: a[lo:hi] for f, a in host.items()})
        fault_point("persist.shard.mid_write", path)
        digest, nbytes = _file_digest(path)
        shard_entries.append({"file": name, "sha256": digest,
                              "bytes": nbytes})
    manifest = {
        "format_version": FORMAT_VERSION,
        "epoch": int(epoch),
        "time": time.time(),
        "vocab": index.vocab,
        "n_seg": index.n_seg,
        "m": index.m,
        "d_pad": index.d_pad,
        "t_pad": index.t_pad,
        "scale": float(index.scale),
        "n_shards": n_shards,
        "shard_rows": rows,
        "shards": shard_entries,
        "extra": extra or {},
    }
    fault_point("persist.manifest.pre_write",
                os.path.join(tmp, shard_entries[-1]["file"]))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    base = os.path.basename(directory)
    if os.path.exists(directory):
        # never destroy the previous checkpoint before the new one is in
        # place: swap the old aside, promote, then reap — a crash leaves
        # either the old or the new checkpoint recoverable on disk
        old = os.path.join(parent, f".old-{base}-{os.getpid()}")
        if os.path.exists(old):
            shutil.rmtree(old)
        os.replace(directory, old)
        fault_point("persist.swap.between_renames", None)
        os.replace(tmp, directory)
    else:
        os.replace(tmp, directory)
    fault_point("persist.swap.post_promote", None)
    # reap swapped-aside copies from this save AND any earlier crashed
    # save (their pids differ) — the promoted checkpoint supersedes them
    for stale in glob.glob(os.path.join(parent, f".old-{base}-*")):
        shutil.rmtree(stale, ignore_errors=True)
    return directory


def verify_checkpoint(directory: str) -> list[str]:
    """Integrity problems with the checkpoint at ``directory`` (empty
    list = intact). v5+ checkpoints verify every shard's byte length and
    sha256 against the manifest; pre-v5 checkpoints predate checksums
    and only the manifest's readability is checked."""
    mpath = os.path.join(directory, "manifest.json")
    if not os.path.exists(mpath):
        return ["manifest.json missing"]
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return [f"manifest unreadable: {e}"]
    if int(manifest.get("format_version", 0)) < 5:
        # pre-checksum formats: digests in the manifest (e.g. left behind
        # by a hand-downgrade) have nothing trustworthy to say
        return []
    problems = []
    for entry in manifest.get("shards", []):
        path = os.path.join(directory, entry["file"])
        if not os.path.exists(path):
            problems.append(f"{entry['file']} missing")
            continue
        digest, nbytes = _file_digest(path)
        if nbytes != entry["bytes"]:
            problems.append(
                f"{entry['file']}: {nbytes} bytes on disk, manifest "
                f"says {entry['bytes']}")
        elif digest != entry["sha256"]:
            problems.append(f"{entry['file']}: sha256 mismatch")
    return problems


def _recover_path(directory: str, verify: bool = True,
                  registry=None) -> str:
    """Resolve the checkpoint to actually read: ``directory`` itself when
    intact, else the newest intact swapped-aside ``.old-*`` copy (the
    survivor of an interrupted or corrupted overwrite)."""
    parent = os.path.dirname(os.path.abspath(directory)) or "."
    base = os.path.basename(directory)
    survivors = sorted(glob.glob(os.path.join(parent, f".old-{base}-*")),
                       key=os.path.getmtime, reverse=True)
    candidates = [directory] + survivors
    if not verify:
        for cand in candidates:
            if os.path.exists(os.path.join(cand, "manifest.json")):
                return cand
        return directory                 # let the open() raise normally
    problems_seen: list[tuple[str, list[str]]] = []
    any_manifest = False
    for cand in candidates:
        problems = verify_checkpoint(cand)
        if not problems:
            return cand
        if problems != ["manifest.json missing"]:
            any_manifest = True
            if registry is not None:
                n_shard_problems = sum(
                    1 for p in problems if not p.startswith("manifest"))
                if n_shard_problems:
                    registry.counter(
                        "snapshot_corrupt_shards_total",
                        "checkpoint shards failing checksum "
                        "verification at load").inc(n_shard_problems)
        problems_seen.append((cand, problems))
    if not any_manifest:
        return directory                 # nothing saved: FileNotFoundError
    raise CheckpointCorruptError(directory, problems_seen)


def read_manifest(directory: str, verify: bool = True,
                  registry=None) -> dict:
    directory = _recover_path(directory, verify=verify, registry=registry)
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    version = manifest.get("format_version")
    if version not in _READABLE_VERSIONS:
        raise ValueError(
            f"index at {directory!r} has format version {version}; this "
            f"build reads versions {_READABLE_VERSIONS}")
    return manifest


def load_index(directory: str,
               shards: list[int] | None = None,
               verify: bool = True,
               registry=None,
               device: str | torch.device | None = None
               ) -> tuple[ClusterIndex, dict]:
    """Load (a subset of the shards of) a saved index.

    ``shards`` selects which cluster shards to load (default: all — the
    single-host cold start). Returns (index, manifest); with a shard
    subset the index's ``m`` is the subset's row count and ``doc_ids``
    stay global.

    ``verify=True`` checks every shard's sha256/byte length against the
    manifest (v5+) before reading arrays, falling back to a swapped-aside
    previous checkpoint when the primary is corrupt or partial; note the
    whole candidate is verified even under a shard subset, so fallback
    decisions are consistent across hosts.

    ``device=None`` places the index on the CUDA card (and raises without
    one); ``device="cpu"`` keeps it on the host without copying the
    loaded arrays again.
    """
    dev = resolve_device(device)
    directory = _recover_path(directory, verify=verify, registry=registry)
    manifest = read_manifest(directory, verify=False)
    pick = list(range(manifest["n_shards"])) if shards is None else shards
    parts: dict[str, list[np.ndarray]] = {
        f: [] for f in _FIELDS + _LEGACY_FIELDS}
    for s in pick:
        path = os.path.join(directory, f"shard_{s:04d}.npz")
        with np.load(path) as z:
            for f in _FIELDS + _LEGACY_FIELDS:
                if f not in z.files:
                    if (f in _DERIVABLE or f in _LEGACY_FIELDS
                            or f in _LAYOUT_FIELDS):
                        continue
                    raise KeyError(f"shard {path!r} is missing field {f!r}")
                parts[f].append(z[f])
    # one shard: its arrays as loaded (no 667 MB concatenate copy)
    arrays = {f: p[0] if len(p) == 1 else np.concatenate(p, axis=0)
              for f, p in parts.items() if p}
    for f, derive in _DERIVABLE.items():
        if f not in arrays:
            arrays[f] = derive(arrays, manifest)
    if any(f not in arrays for f in _LAYOUT_FIELDS):
        _derive_segment_major(arrays, manifest)

    if shards is None and arrays["doc_tids"].shape[0] != manifest["m"]:
        raise ValueError("shard rows do not reassemble the manifest's m")

    # the coarse tables are derived on every load (never stored): the
    # member lists and max-folds come straight from (super_of,
    # seg_max_stacked), so dominance holds by construction
    arrays["super_members"], arrays["super_max_stacked"] = \
        superblock_tables(arrays["super_of"], arrays["seg_max_stacked"])
    arrays["scale"] = np.float32(manifest["scale"])
    index = ClusterIndex(
        **{f: _tensor(arrays[f]).to(dev) for f in INDEX_FIELDS},
        vocab=manifest["vocab"], n_seg=manifest["n_seg"])
    return index, manifest
