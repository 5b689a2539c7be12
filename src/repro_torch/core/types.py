"""Core data types for the ASC cluster-skipping index (PyTorch port of
``repro/core/types.py``).

Frozen dataclasses of padded dense tensors take the place of the JAX
pytrees. Static geometry (vocab, n_seg) stays plain Python metadata. The
layout is the reference's, field for field and dtype for dtype, so the
parity tests compare like with like:

  * forward (doc-major) layout inside clusters: ``doc_tids``/``doc_tw``
    hold each document's own nonzero terms, and scoring is a gather from
    a dense query map + dot;
  * a dense uint8 stacked segment-maximum table ``seg_max_stacked`` of
    shape ``(m, n_seg + 1, V)``: the bound pass for a query batch is one
    GEMM over it;
  * weights quantized to uint8 with one global scale, segment maxima taken
    after quantization.

``doc_tids`` is ``torch.uint16`` (2 bytes a term id) whenever the vocab
allows. PyTorch refuses ``uint16`` as an index, so the plain code widens
on use and the CUDA kernels read the raw 16-bit values.
"""

from __future__ import annotations

import dataclasses

import torch

# Sentinel term id used to pad ``doc_tids`` rows. Points at a dedicated
# zero-weight slot (index ``vocab``) in every dense query map.
PAD_TERM = -1


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along the leading axis. CUDA has no indexing kernel for
    ``uint16``, so term ids are gathered through an ``int16`` view of the
    same bytes."""
    if x.dtype == torch.uint16:
        return x.view(torch.int16)[idx].view(torch.uint16)
    return x[idx]


def widen_tids(tids: torch.Tensor) -> torch.Tensor:
    """int64 term ids from ``uint16``/``int32`` storage, for indexing."""
    if tids.dtype == torch.uint16:
        return tids.view(torch.int16).long() & 0xFFFF
    return tids.long()


@dataclasses.dataclass(frozen=True)
class SparseDocs:
    """A batch of sparse documents in padded COO-per-row form.

    tids: (n_docs, t_pad) int32, PAD_TERM-padded term ids.
    tw:   (n_docs, t_pad) float32 term weights (0 at padding).
    mask: (n_docs, t_pad) bool validity of each slot.
    """

    tids: torch.Tensor
    tw: torch.Tensor
    mask: torch.Tensor
    vocab: int

    @property
    def n_docs(self) -> int:
        return self.tids.shape[0]

    @property
    def t_pad(self) -> int:
        return self.tids.shape[1]

    def densify(self) -> torch.Tensor:
        """(n_docs, vocab) dense matrix — test/oracle use only."""
        tids = torch.where(self.mask, self.tids, self.vocab).long()
        dense = torch.zeros((self.n_docs, self.vocab + 1), dtype=self.tw.dtype,
                            device=self.tw.device)
        dense.scatter_reduce_(1, tids, torch.where(self.mask, self.tw, 0.0),
                              reduce="amax")
        return dense[:, : self.vocab]


@dataclasses.dataclass(frozen=True)
class QueryBatch:
    """A batch of sparse queries.

    tids: (n_q, q_pad) int32 term ids (PAD_TERM padded).
    tw:   (n_q, q_pad) float32 query term weights (0 at padding).
    mask: (n_q, q_pad) bool.
    """

    tids: torch.Tensor
    tw: torch.Tensor
    mask: torch.Tensor
    vocab: int

    @property
    def n_queries(self) -> int:
        return self.tids.shape[0]

    @property
    def q_pad(self) -> int:
        return self.tids.shape[1]

    @property
    def device(self) -> torch.device:
        return self.tids.device

    def to(self, device: torch.device | str) -> "QueryBatch":
        return QueryBatch(tids=self.tids.to(device), tw=self.tw.to(device),
                          mask=self.mask.to(device), vocab=self.vocab)

    def dense_map(self) -> torch.Tensor:
        """(n_q, vocab + 1) dense query maps; the trailing slot is the
        zero-weight landing pad for PAD_TERM gathers. Query term ids are
        unique per row, so the scatter-add is exact in any order."""
        tids = torch.where(self.mask, self.tids, self.vocab).long()
        out = torch.zeros((self.n_queries, self.vocab + 1),
                          dtype=torch.float32, device=self.device)
        out.scatter_add_(1, tids, torch.where(self.mask, self.tw, 0.0))
        out[:, self.vocab] = 0.0
        return out


# data fields of ClusterIndex, in the reference's order (convert.py and
# the parity tests walk this tuple)
INDEX_FIELDS = ("doc_tids", "doc_tw", "doc_mask", "doc_ids", "doc_seg",
                "doc_seg_mod", "seg_max_stacked", "seg_offsets",
                "sorted_upto", "scale", "cluster_ndocs", "super_of",
                "super_members", "super_max_stacked")


@dataclasses.dataclass(frozen=True)
class ClusterIndex:
    """Cluster-skipping forward index with segmented maximum term weights.

    m = number of clusters, d_pad = padded docs/cluster, t_pad = padded
    terms/doc, n_seg = segments per cluster, V = vocab. Every field has the
    meaning, shape and dtype of ``repro.core.types.ClusterIndex``:

    doc_tids: (m, d_pad, t_pad) uint16 (int32 if vocab >= 2^16), == V at
              padding.
    doc_tw:   (m, d_pad, t_pad) uint8 quantized term weights.
    doc_mask: (m, d_pad) bool per-document validity.
    doc_ids:  (m, d_pad) int32 global document ids (-1 padding).
    doc_seg:  (m, d_pad) int32 segment id of each doc.
    doc_seg_mod: (m, d_pad) int32 ``doc_seg % n_seg``, hoisted for the
              planner.
    seg_max_stacked: (m, n_seg + 1, V) uint8 segment maxima plus their
              max over segments (the BoundSum row).
    seg_offsets: (m, n_seg + 1) int32 segment-major slot prefix table.
    sorted_upto: (m,) int32 slots that still obey the segment-major layout.
    scale:    () float32, w_fp = w_u8 * scale.
    cluster_ndocs: (m,) int32 live docs per cluster.
    super_of: (m,) int32 superblock of each cluster.
    super_members: (S, super_cap) int32 member ids, -1 padded.
    super_max_stacked: (S, n_seg + 1, V) uint8 coarse bound table.

    The superblock tables are built so every field compares equal with the
    reference; the two-level walk that reads them is not ported yet.
    """

    doc_tids: torch.Tensor
    doc_tw: torch.Tensor
    doc_mask: torch.Tensor
    doc_ids: torch.Tensor
    doc_seg: torch.Tensor
    doc_seg_mod: torch.Tensor
    seg_max_stacked: torch.Tensor
    seg_offsets: torch.Tensor
    sorted_upto: torch.Tensor
    scale: torch.Tensor
    cluster_ndocs: torch.Tensor
    super_of: torch.Tensor
    super_members: torch.Tensor
    super_max_stacked: torch.Tensor
    vocab: int
    n_seg: int

    @property
    def device(self) -> torch.device:
        return self.doc_tids.device

    @property
    def seg_max(self) -> torch.Tensor:
        """(m, n_seg, V) segment rows of the stacked table (a view)."""
        return self.seg_max_stacked[:, : self.n_seg]

    @property
    def seg_max_collapsed(self) -> torch.Tensor:
        """(m, V) BoundSum row (max over segments) of the stacked table."""
        return self.seg_max_stacked[:, self.n_seg]

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
    def n_super(self) -> int:
        """S — number of superblocks of the level-0 grouping."""
        return self.super_max_stacked.shape[0]

    @property
    def super_cap(self) -> int:
        return self.super_members.shape[1]

    @property
    def n_docs(self) -> torch.Tensor:
        return self.cluster_ndocs.sum()

    def replace(self, **updates) -> "ClusterIndex":
        return dataclasses.replace(self, **updates)

    def nbytes(self) -> int:
        return sum(
            x.numel() * x.element_size()
            for x in (self.doc_tids, self.doc_tw, self.doc_mask,
                      self.doc_ids, self.doc_seg, self.doc_seg_mod,
                      self.seg_max_stacked, self.seg_offsets,
                      self.sorted_upto, self.super_of,
                      self.super_members, self.super_max_stacked)
        )


@dataclasses.dataclass(frozen=True)
class TopK:
    """Top-k result plus the nine work counters of
    ``repro.core.types.TopK`` (same names, shapes and semantics).

    doc_ids: (n_q, k) int32, score-descending; -1 where fewer than k hits.
    scores:  (n_q, k) float32.
    n_scored_docs / n_scored_clusters / n_scored_segments /
    n_scored_tiles / n_walked_tiles / n_walked_docs / n_bounded_clusters /
    n_walked_superblocks / n_pruned_superblocks: (n_q,) int32.
    """

    doc_ids: torch.Tensor
    scores: torch.Tensor
    n_scored_docs: torch.Tensor
    n_scored_clusters: torch.Tensor
    n_scored_segments: torch.Tensor
    n_scored_tiles: torch.Tensor
    n_walked_tiles: torch.Tensor
    n_walked_docs: torch.Tensor
    n_bounded_clusters: torch.Tensor
    n_walked_superblocks: torch.Tensor
    n_pruned_superblocks: torch.Tensor


TOPK_FIELDS = tuple(f.name for f in dataclasses.fields(TopK))
