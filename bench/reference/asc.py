"""Plain reference of ASC retrieval: the index derived again from the raw
corpus, and the batched walk, in float64 (or, for the control, in a
lower precision).

It follows the semantics the program states and shares no code with it:

  * quantization: one global scale, ``max live weight / 255`` in float32,
    weights rounded half to even to uint8;
  * segments: per cluster, in cluster order, its documents in ascending
    id order dealt ``arange(n) % n_seg`` and shuffled by
    ``numpy.random.default_rng(seed)`` (a frozen copy of the program's
    random uniform segmentation, which the seed fixes);
  * segment maxima over the quantized weights; bounds
    ``B[q, c, j] = scale * sum_t w_q(t) * segmax[c, j, t]``, MaxSBound and
    AvgSBound their max and mean over segments;
  * the walk: each query ranks the clusters by MaxSBound; the batch
    visits them in order of the best rank any query gives, ties by the
    batch's largest MaxSBound (larger first), then by id, in waves of
    ``group_size``. In a wave a query not yet done admits a cluster unless
    ``MaxS <= theta / mu`` and ``AvgS <= theta / eta``, and of an
    admitted cluster the segments with ``B > theta / eta``; every live
    document of an admitted segment is scored, those above theta join the
    running top-k, and a query is done once the largest MaxSBound left on
    its walk is at most ``theta / eta``. theta is the k-th best score so
    far (minus infinity until k are found).

Scores are ``scale * sum_t w_q(t) * w_u8(t, d)``. The walk decides on
the sums before the scale, which float64 holds exactly (a float32 query
weight times an 8-bit weight, a few dozen of them), and compares
``x <= theta / mu`` as ``x * num <= theta * den`` with ``mu = num / den``
as the configuration writes it, so every decision is the exact one, ties
included. Everything runs in blocks on the device the tensors are on;
this module imports neither the program nor JAX.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import numpy as np
import torch

NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class RefIndex:
    """tids (n, t_pad) int32 with -1 padding; w (n, t_pad) uint8;
    cluster, seg (n,) int64; order (n,) documents sorted by cluster
    (stable); start (m + 1,) their offsets; segmax (m, n_seg, V) uint8."""

    tids: torch.Tensor
    w: torch.Tensor
    scale: float
    cluster: torch.Tensor
    seg: torch.Tensor
    order: torch.Tensor
    start: torch.Tensor
    segmax: torch.Tensor
    vocab: int

    @property
    def m(self) -> int:
        return self.segmax.shape[0]

    @property
    def n_seg(self) -> int:
        return self.segmax.shape[1]


def quantize(tw: np.ndarray, mask: np.ndarray,
             rows: int = 1 << 20) -> tuple[np.ndarray, float]:
    """(uint8 weights, the float32 scale) of a float32 corpus."""
    live_max = 0.0
    for lo in range(0, tw.shape[0], rows):
        blk = np.where(mask[lo:lo + rows], tw[lo:lo + rows], 0)
        if blk.size:
            live_max = max(live_max, float(blk.max()))
    scale = np.float32(max(live_max, 1e-6) / 255.0)
    out = np.empty(tw.shape, np.uint8)
    for lo in range(0, tw.shape[0], rows):
        q = np.clip(np.round(tw[lo:lo + rows] / scale), 0, 255)
        out[lo:lo + rows] = np.where(mask[lo:lo + rows], q, 0)
    return out, float(scale)


def segment_draw(assign: np.ndarray, m: int, n_seg: int,
                 seed: int) -> np.ndarray:
    """(n,) int64 segment of every document (the seed's random uniform
    segmentation, cluster by cluster)."""
    assign = np.asarray(assign, np.int64)
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=m)
    start = np.concatenate([[0], np.cumsum(counts)])
    rng = np.random.default_rng(seed)
    seg = np.zeros(assign.shape[0], np.int64)
    for c in range(m):
        nc = int(counts[c])
        if nc == 0:
            continue
        s = np.arange(nc, dtype=np.int32) % n_seg
        rng.shuffle(s)
        seg[order[start[c]:start[c + 1]]] = s
    return seg


def derive_index(tids: np.ndarray, tw: np.ndarray, mask: np.ndarray,
                 assign: np.ndarray, m: int, n_seg: int, d_pad: int,
                 seed: int, vocab: int, device,
                 rows: int = 1 << 20) -> RefIndex:
    """The index, worked out again from the raw corpus (host arrays) and
    the assignment; its tensors go to ``device``."""
    assign = np.asarray(assign, np.int64)
    counts = np.bincount(assign, minlength=m)
    if counts.max() > d_pad:
        raise ValueError("a cluster holds more than d_pad documents")
    w_u8, scale = quantize(tw, mask, rows)
    seg = segment_draw(assign, m, n_seg, seed)
    t = torch.where(torch.from_numpy(mask).to(device),
                    torch.from_numpy(tids).to(device), -1)
    w = torch.from_numpy(w_u8).to(device)
    cl = torch.from_numpy(assign).to(device)
    sg = torch.from_numpy(seg).to(device)
    segmax = torch.zeros((m * n_seg * vocab,), dtype=torch.uint8,
                         device=device)
    for lo in range(0, t.shape[0], rows):
        tt, ww = t[lo:lo + rows], w[lo:lo + rows]
        keep = tt >= 0
        flat = ((cl[lo:lo + rows] * n_seg + sg[lo:lo + rows])[:, None]
                * vocab + tt.long())[keep]
        segmax.scatter_reduce_(0, flat, ww[keep], reduce="amax")
    order = torch.sort(cl, stable=True).indices
    start = torch.zeros(m + 1, dtype=torch.int64, device=device)
    start[1:] = torch.cumsum(torch.bincount(cl, minlength=m), 0)
    return RefIndex(tids=t, w=w, scale=scale, cluster=cl, seg=sg,
                    order=order, start=start,
                    segmax=segmax.reshape(m, n_seg, vocab), vocab=vocab)


def _union(qt: torch.Tensor, qw: torch.Tensor, vocab: int, dtype):
    """(union term ids (U,), dense (n_q, U) query weights in ``dtype``,
    lookup (V + 1,) from a term id to its union column, U for none)."""
    valid = qt >= 0
    union = torch.unique(qt[valid])
    U = union.shape[0]
    lut = torch.full((vocab + 1,), U, dtype=torch.int64, device=qt.device)
    lut[union] = torch.arange(U, device=qt.device)
    col = lut[torch.where(valid, qt, vocab)]
    q = torch.zeros((qt.shape[0], U + 1), dtype=torch.float64,
                    device=qt.device)
    q.scatter_(1, col, torch.where(valid, qw.to(torch.float64), 0.0))
    return union, q[:, :U].to(dtype), lut


def bounds(ix: RefIndex, q_u: torch.Tensor, union: torch.Tensor,
           dtype, clusters: int = 512) -> torch.Tensor:
    """(n_q, m, n_seg) float64 segment bounds before the scale, computed
    in ``dtype``."""
    n_q = q_u.shape[0]
    out = torch.empty((n_q, ix.m, ix.n_seg), dtype=torch.float64,
                      device=q_u.device)
    for lo in range(0, ix.m, clusters):
        hi = min(lo + clusters, ix.m)
        table = ix.segmax[lo:hi][:, :, union].reshape(-1, union.shape[0])
        b = table.to(dtype) @ q_u.T                        # (rows, n_q)
        out[:, lo:hi] = b.T.reshape(n_q, hi - lo, ix.n_seg).to(torch.float64)
    return out


def doc_scores(ix: RefIndex, docs: torch.Tensor, q_u: torch.Tensor,
               lut: torch.Tensor, dtype, rows: int = 1 << 15
               ) -> torch.Tensor:
    """(n_q, len(docs)) float64 scores of ``docs`` before the scale,
    computed in ``dtype``."""
    U = q_u.shape[1]
    out = torch.empty((q_u.shape[0], docs.shape[0]), dtype=torch.float64,
                      device=q_u.device)
    for lo in range(0, docs.shape[0], rows):
        d = docs[lo:lo + rows]
        t = ix.tids[d]
        col = lut[torch.where(t >= 0, t, ix.vocab)]
        dense = torch.zeros((d.shape[0], U + 1), dtype=dtype,
                            device=q_u.device)
        dense.scatter_(1, col, ix.w[d].to(dtype))
        out[:, lo:lo + rows] = (dense[:, :U] @ q_u.T).T.to(torch.float64)
    return out


def exact_scores(ix: RefIndex, qt: torch.Tensor, qw: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """(n_q, r) float64 score of document ``ids[q, j]`` for query q (ids
    must be valid)."""
    union, q_u, lut = _union(qt, qw, ix.vocab, torch.float64)
    t = ix.tids[ids]                                       # (n_q, r, T)
    col = lut[torch.where(t >= 0, t, ix.vocab)]
    qpad = torch.cat([q_u, q_u.new_zeros((q_u.shape[0], 1))], dim=1)
    rows = torch.arange(ids.shape[0], device=ids.device)[:, None, None]
    return (qpad[rows, col] * ix.w[ids].to(torch.float64)).sum(-1) * ix.scale


def _members(ix: RefIndex, cids: torch.Tensor) -> tuple:
    """Documents of clusters ``cids`` (concatenated) and each one's slot
    in ``cids``."""
    lens = ix.start[cids + 1] - ix.start[cids]
    total = int(lens.sum())
    slot = torch.repeat_interleave(torch.arange(cids.shape[0],
                                                device=cids.device), lens)
    first = torch.cumsum(lens, 0) - lens
    pos = (torch.repeat_interleave(ix.start[cids], lens)
           + torch.arange(total, device=cids.device)
           - torch.repeat_interleave(first, lens))
    return ix.order[pos], slot


def _ratio(x: float) -> tuple[float, float]:
    """(num, den) of a configuration's decimal value."""
    f = Fraction(str(x))
    return float(f.numerator), float(f.denominator)


def search(ix: RefIndex, qt: torch.Tensor, qw: torch.Tensor, k: int,
           mu: float, eta: float, group_size: int,
           dtype=torch.float64) -> dict:
    """The batched walk over one batch of queries (tids -1 padded, float
    weights): ids (n_q, k) int64 (-1 where fewer than k), scores (n_q, k)
    float64, and per query the clusters and documents it scored."""
    dev = qt.device
    n_q = qt.shape[0]
    mu_n, mu_d = _ratio(mu)
    eta_n, eta_d = _ratio(eta)
    union, q_u, lut = _union(qt, qw, ix.vocab, dtype)
    b = bounds(ix, q_u, union, dtype)
    max_s, sum_s = b.amax(-1), b.sum(-1)
    m, G, n_seg = ix.m, group_size, ix.n_seg
    n_groups = -(-m // G)
    rank = torch.argsort(torch.argsort(-max_s, dim=1, stable=True), dim=1,
                         stable=True)
    prio = rank.amin(0).to(torch.float64)
    tie = max_s.amax(0)
    tie = tie / (tie.abs().amax() + 1.0)
    shared = torch.argsort(prio - tie, stable=True)
    suffix = torch.flip(torch.cummax(torch.flip(max_s[:, shared], [1]),
                                     1).values, [1])

    top_s = torch.full((n_q, k), NEG_INF, dtype=torch.float64, device=dev)
    top_i = torch.full((n_q, k), -1, dtype=torch.int64, device=dev)
    done = torch.zeros(n_q, dtype=torch.bool, device=dev)
    n_clusters = torch.zeros(n_q, dtype=torch.int64, device=dev)
    n_docs = torch.zeros(n_q, dtype=torch.int64, device=dev)
    waves = 0
    for g in range(n_groups):
        theta = top_s[:, k - 1, None]
        cids = shared[g * G:(g + 1) * G]
        pruned = ((max_s[:, cids] * mu_n <= theta * mu_d)
                  & (sum_s[:, cids] * eta_n <= theta * (eta_d * n_seg)))
        admit = ~done[:, None] & ~pruned                       # (n_q, G)
        seg_ok = admit[:, :, None] & (b[:, cids, :] * eta_n
                                      > theta[:, :, None] * eta_d)
        docs, slot = _members(ix, cids)
        adm = seg_ok[:, slot, ix.seg[docs]]                    # (n_q, D)
        s = doc_scores(ix, docs, q_u, lut, dtype)
        cand = torch.where(adm & (s > theta), s, NEG_INF)
        c_s, c_p = torch.topk(cand, min(k, cand.shape[1]), dim=1)
        c_i = torch.where(c_s > NEG_INF, docs[c_p], -1)
        top_s, sel = torch.topk(torch.cat([top_s, c_s], 1), k, dim=1)
        top_i = torch.gather(torch.cat([top_i, c_i], 1), 1, sel)
        n_clusters += admit.sum(1)
        n_docs += adm.sum(1)
        waves += 1
        nxt = min((g + 1) * G, m - 1)
        done |= suffix[:, nxt] * eta_n <= top_s[:, k - 1] * eta_d
        if g + 1 < n_groups and bool(done.all()):
            break
    top_i = torch.where(top_s > NEG_INF, top_i, -1)
    return dict(ids=top_i, scores=top_s * ix.scale,
                n_scored_clusters=n_clusters, n_scored_docs=n_docs,
                waves=waves)
