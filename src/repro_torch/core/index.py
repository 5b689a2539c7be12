"""Offline cluster-skipping index construction (PyTorch port of
``repro/core/index.py``).

The build stays numpy on the host, bit-identical to the reference, and
moves the finished arrays to ``device`` at the end. Under an open trace
request (``obs/trace.py``) its stages are spans: ``rebalance``,
``quantize``, ``pack`` (its args the per-cluster loop's summed host
seconds), ``tables`` and ``upload``.

``build_index`` is the host-side (numpy) data-engineering step: it takes a
sparse corpus + a cluster assignment and emits the padded, quantized
:class:`ClusterIndex`. The packing core (:func:`pack_clusters`) is the one
the online write path (``lifecycle/mutable.py``) re-packs through at
compaction, as in the reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import segmentation
from repro_torch.core.types import INDEX_FIELDS, ClusterIndex, SparseDocs
from repro_torch.device import resolve_device
from repro_torch.obs.trace import NULL_SPAN, span


def _no_clock() -> float:
    return 0.0


def capacity_rebalance(assign: np.ndarray, m: int, d_pad: int,
                       order_hint: np.ndarray | None = None) -> np.ndarray:
    """Spill overflow docs (beyond ``d_pad`` per cluster) into the nearest
    clusters with room (by ``order_hint`` preference if given, else
    least-loaded-first). Returns a capacity-respecting copy."""
    assign = assign.astype(np.int64).copy()
    counts = np.bincount(assign, minlength=m)
    if (counts <= d_pad).all():
        return assign.astype(np.int32)
    for c in np.nonzero(counts > d_pad)[0]:
        docs = np.nonzero(assign == c)[0]
        overflow = docs[d_pad:]
        for d in overflow:
            if order_hint is not None:
                prefs = order_hint[d]
            else:
                prefs = np.argsort(counts)
            for tgt in prefs:
                if counts[tgt] < d_pad:
                    assign[d] = tgt
                    counts[tgt] += 1
                    counts[c] -= 1
                    break
            else:  # pragma: no cover - capacity must be sized sanely
                raise ValueError("total capacity m*d_pad < n_docs")
    return assign.astype(np.int32)


def group_superblocks(seg_max_collapsed: np.ndarray,
                      n_super: int | None = None) -> np.ndarray:
    """Group the m clusters into S superblocks: (m,) int32 ``super_of``.

    Deterministic, rng-free centroid k-means over the clusters' collapsed
    bound rows (``seg_max_collapsed``): farthest-point seeding from
    cluster 0, a few Lloyd refinements, then a capacity-bounded greedy
    assignment (cap = ceil(m / S)) in assignment-confidence order so no
    superblock overflows its padded member slab. Being rng-free is
    load-bearing: WAL-replayed compactions and v1–v5 legacy loads
    re-derive the *identical* grouping from the same bound table
    (lifecycle/persist.py), with no generator state to persist.

    ``n_super`` defaults to ceil(sqrt(m)) — the S that balances the
    level-0 bound pass (O(S)) against the expected fine survivors
    (docs/perf.md §superblock has the arithmetic).
    """
    x = np.asarray(seg_max_collapsed, np.float32)
    m = x.shape[0]
    S = (max(1, int(np.ceil(np.sqrt(m)))) if n_super is None
         else int(n_super))
    S = max(1, min(S, m))
    if S == 1:
        return np.zeros((m,), np.int32)
    cap = -(-m // S)

    # the rows' squared norms, the same reduction of the same array each
    # call, so computing them once leaves every distance bit-identical
    xx = (x * x).sum(1)[:, None]

    def d2(b: np.ndarray) -> np.ndarray:
        return xx + (b * b).sum(1)[None, :] - 2.0 * (x @ b.T)

    # farthest-point seeding from cluster 0
    seeds = [0]
    dmin = d2(x[:1])[:, 0]
    for _ in range(1, S):
        nxt = int(np.argmax(dmin))
        seeds.append(nxt)
        dmin = np.minimum(dmin, d2(x[nxt:nxt + 1])[:, 0])
    cent = x[np.asarray(seeds)].copy()
    for _ in range(4):
        a = np.argmin(d2(cent), axis=1)
        for s in range(S):
            mem = x[a == s]
            if len(mem):
                cent[s] = mem.mean(axis=0)

    # capacity-bounded greedy in confidence order (stable argsorts keep
    # every tie-break deterministic)
    dist = d2(cent)
    pref = np.argsort(dist, axis=1, kind="stable")
    conf = np.argsort(dist.min(axis=1), kind="stable")
    super_of = np.full((m,), -1, np.int32)
    counts = np.zeros((S,), np.int64)
    for c in conf:
        for s in pref[c]:
            if counts[s] < cap:
                super_of[c] = s
                counts[s] += 1
                break
    return super_of


def superblock_tables(super_of: np.ndarray, seg_max_stacked: np.ndarray,
                      n_super: int | None = None
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Derive the level-0 tables from a grouping + the fine bound table:
    (``super_members`` (S, cap) int32 ascending / -1 padded,
    ``super_max_stacked`` (S, n_seg + 1, V) uint8 = elementwise max over
    member rows). Exact by construction — the dominance invariant
    ``super_max_stacked[super_of[c]] >= seg_max_stacked[c]`` holds with
    equality somewhere in every coordinate's argmax member."""
    super_of = np.asarray(super_of, np.int32)
    st = np.asarray(seg_max_stacked)
    S = (int(super_of.max()) + 1 if n_super is None else int(n_super))
    S = max(1, S)
    counts = np.bincount(super_of, minlength=S)
    cap = max(1, int(counts.max()))
    super_members = np.full((S, cap), -1, np.int32)
    super_max = np.zeros((S,) + st.shape[1:], st.dtype)
    for s in range(S):
        mem = np.nonzero(super_of == s)[0]
        if len(mem):
            super_members[s, :len(mem)] = mem
            super_max[s] = st[mem].max(axis=0)
    return super_members, super_max


def pack_clusters(
    safe_tids: np.ndarray,
    tw_u8: np.ndarray,
    assign: np.ndarray,
    m: int,
    n_seg: int,
    d_pad: int,
    vocab: int,
    doc_ids: np.ndarray | None = None,
    seg_method: str = "random_uniform",
    dense_rep: np.ndarray | None = None,
    rng: np.random.Generator | None = None,
    sort_segments: bool = True,
) -> dict[str, np.ndarray]:
    """Pack quantized docs into the (m, d_pad) slab layout + seg_max table.

    safe_tids: (n_docs, t_pad) term ids with padding already mapped to
               ``vocab`` (the zero landing slot), dtype uint16/int32.
    tw_u8:     (n_docs, t_pad) quantized weights (0 at padding).
    doc_ids:   global id per row (defaults to arange) — compaction passes
               the surviving original ids through here.

    With ``sort_segments`` (the default) each cluster's docs are laid out
    *segment-contiguously*: segment assignment stays random (the Prop-4
    model is about membership, not slot order), but slots are stable-
    sorted by segment so segment j occupies exactly
    ``[seg_offsets[c, j], seg_offsets[c, j + 1])`` — an admitted segment
    is one physical doc run and the planner's run encoding is a prefix-
    table gather. ``sort_segments=False`` keeps arrival order (the
    pre-segment-major layout; ``seg_offsets`` degenerates to zeros and
    ``sorted_upto`` to 0 so planning treats every slot as unsorted tail).

    Returns the host-side arrays of a :class:`ClusterIndex` (everything
    except ``scale``). Used by both the offline build and online
    compaction/re-segmentation, which is what keeps the seg_max invariant
    (exact max over the packed docs' quantized weights) single-sourced.

    Traced, the per-cluster loop is the ``pack`` span, whose args sum its
    member scans (``scan_s``), row copies (``copy_s``) and segment maxima
    (``max_at_s``) in host seconds; the tables after it are ``tables``.
    """
    n_docs, t_pad = safe_tids.shape
    V = vocab
    rng = rng or np.random.default_rng(0)
    if doc_ids is None:
        doc_ids_in = np.arange(n_docs, dtype=np.int64)
    else:
        doc_ids_in = np.asarray(doc_ids, np.int64)

    tid_dtype = safe_tids.dtype
    doc_tids = np.full((m, d_pad, t_pad), V, tid_dtype)
    doc_tw = np.zeros((m, d_pad, t_pad), np.uint8)
    doc_mask = np.zeros((m, d_pad), bool)
    out_ids = np.full((m, d_pad), -1, np.int32)
    doc_seg = np.zeros((m, d_pad), np.int32)
    seg_max = np.zeros((m, n_seg, V), np.uint8)
    cluster_ndocs = np.zeros((m,), np.int32)
    seg_offsets = np.zeros((m, n_seg + 1), np.int32)
    sorted_upto = np.full((m,), d_pad if sort_segments else 0, np.int32)

    with span("pack") as pack_span:
        # the loop's parts are timed only when the span records
        tick = _no_clock if pack_span is NULL_SPAN else time.perf_counter
        scan_s = copy_s = max_at_s = 0.0
        for c in range(m):
            t0 = tick()
            members = np.nonzero(assign == c)[0]
            scan_s += tick() - t0
            nc = len(members)
            cluster_ndocs[c] = nc
            if nc == 0:
                continue

            if seg_method == "random_uniform":
                seg = segmentation.random_uniform_segments(rng, nc, n_seg)
            elif seg_method == "kmeans_sub":
                if dense_rep is None:
                    raise ValueError("kmeans_sub segmentation needs "
                                     "dense_rep")
                seg = segmentation.kmeans_sub_segments(
                    np.asarray(dense_rep)[members], n_seg, rng=rng)
            else:
                raise ValueError(f"unknown seg_method {seg_method!r}")
            seg = np.asarray(seg, np.int64)
            if sort_segments:
                # segment-major slot order: stable, so within a segment
                # the original member order is preserved (what makes
                # legacy-load re-sorting in lifecycle/persist.py
                # bit-exact)
                order = np.argsort(seg, kind="stable")
                members, seg = members[order], seg[order]
                seg_offsets[c, 1:] = np.cumsum(
                    np.bincount(seg, minlength=n_seg))
            t0 = tick()
            doc_tids[c, :nc] = safe_tids[members]
            doc_tw[c, :nc] = tw_u8[members]
            doc_mask[c, :nc] = True
            out_ids[c, :nc] = doc_ids_in[members]
            doc_seg[c, :nc] = seg
            t1 = tick()

            # segmented maxima over quantized weights: one max-fold a
            # cluster (a max is order-free, so this equals the reference's
            # fold a doc)
            t = safe_tids[members].astype(np.int64)
            keep = t < V
            j = np.broadcast_to(seg[:, None], t.shape)
            np.maximum.at(seg_max[c], (j[keep], t[keep]),
                          tw_u8[members][keep])
            copy_s += t1 - t0
            max_at_s += tick() - t1
        pack_span.set_args(clusters=m, scan_s=scan_s, copy_s=copy_s,
                           max_at_s=max_at_s)

    with span("tables"):
        # stored stacked layout: segment rows + the collapsed BoundSum
        # row, so the fused bounds GEMM never materializes a per-call copy
        seg_max_stacked = np.concatenate(
            [seg_max, seg_max.max(axis=1, keepdims=True)], axis=1)
        # hoisted modded segment map: planning (doc admission + doc-run
        # compaction) indexes segment tables with this directly, instead
        # of re-modding doc_seg once per wave
        doc_seg_mod = (doc_seg % n_seg).astype(np.int32)
        # level-0 superblock grouping + coarse bound table (rng-free, so
        # compaction replay and legacy loads regroup identically)
        super_of = group_superblocks(seg_max_stacked[:, n_seg])
        super_members, super_max_stacked = superblock_tables(
            super_of, seg_max_stacked)
    return dict(doc_tids=doc_tids, doc_tw=doc_tw, doc_mask=doc_mask,
                doc_ids=out_ids, doc_seg=doc_seg, doc_seg_mod=doc_seg_mod,
                seg_max_stacked=seg_max_stacked, seg_offsets=seg_offsets,
                sorted_upto=sorted_upto,
                cluster_ndocs=cluster_ndocs, super_of=super_of,
                super_members=super_members,
                super_max_stacked=super_max_stacked)


def build_index(
    docs: SparseDocs,
    assign: np.ndarray,
    m: int,
    n_seg: int,
    d_pad: int | None = None,
    seg_method: str = "random_uniform",
    dense_rep: np.ndarray | None = None,
    seed: int = 0,
    scale: float | None = None,
    doc_ids: np.ndarray | None = None,
    sort_segments: bool = True,
    device: str | torch.device | None = None,
) -> ClusterIndex:
    """Assemble the padded forward index + segmented max-weight table.

    ``scale`` overrides the derived global quantization scale — the online
    write path pins it so an incrementally-mutated index and its
    rebuilt-from-scratch equivalent quantize identically (and so the churn
    tests can compare them bit-exactly). ``device=None`` places the index
    on the CUDA card (and raises without one).
    """
    dev = resolve_device(device)
    tids = docs.tids.cpu().numpy()
    tw = docs.tw.cpu().numpy().astype(np.float32)
    mask = docs.mask.cpu().numpy()
    n_docs, _ = tids.shape
    V = docs.vocab
    rng = np.random.default_rng(seed)

    assign = np.asarray(assign, np.int64)
    if d_pad is None:
        d_pad = int(max(1, np.bincount(assign, minlength=m).max()))
    with span("rebalance"):
        assign = capacity_rebalance(assign, m, d_pad)

    # ---- global uint8 quantization (weights first, maxima after) ----
    with span("quantize"):
        if scale is None:
            live_max = float((tw * mask).max()) if n_docs else 1.0
            scale = max(live_max, 1e-6) / 255.0
        tw_u8 = np.clip(np.round(tw / scale), 0, 255).astype(np.uint8)
        tw_u8 = np.where(mask, tw_u8, 0).astype(np.uint8)

        # term ids are uint16 when the vocab allows (WordPiece's 30522
        # does): 3 bytes/posting instead of 5, the stand-in for the
        # paper's SIMD-BP128 posting compression
        tid_dtype = np.uint16 if V < 2**16 else np.int32
        safe_tids = np.where(mask, tids, V).astype(tid_dtype)

    packed = pack_clusters(safe_tids, tw_u8, assign, m, n_seg, d_pad, V,
                           doc_ids=doc_ids, seg_method=seg_method,
                           dense_rep=dense_rep, rng=rng,
                           sort_segments=sort_segments)

    packed["scale"] = np.float32(scale)
    with span("upload"):
        return ClusterIndex(
            **{f: torch.from_numpy(np.asarray(packed[f])).to(dev)
               for f in INDEX_FIELDS},
            vocab=V, n_seg=n_seg)
