"""K-means document clustering (PyTorch port of ``repro/core/clustering.py``).

The paper clusters documents with k-means over *dense counterparts* of the
learned sparse vectors. This module holds:

  * ``lloyd_kmeans``       — Lloyd's iterations: the assignment distance
    matrix is one GEMM, the centroid sums a one-hot GEMM (deterministic
    on the card);
  * ``balanced_assign``    — capacity-bounded assignment so every cluster
    fits the padded ``d_pad`` slab of the index layout;
  * dense representation builders: max / mean / CLS pooling, and the
    random-projection fallback used by synthetic corpora that have no
    trained encoder.

Each function runs on the device its tensors live on. Random draws come
from an explicit ``torch.Generator`` on the CPU (where the reference takes
a JAX key), so the card and the CPU draw the same values from the same
seed; the draws are split from the arithmetic (``_lloyd`` takes the
initial centers, ``_project`` the projection matrix) so a caller can feed
in any draw. The distance GEMM runs in fp32: with TF32 matmuls allowed on
the card it would not, and the caller keeps that switch off.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.types import SparseDocs
from repro_torch.device import resolve_device
from repro_torch.utils import rank_within_run


def sq_distances(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(n, k) squared euclidean distances via the GEMM expansion."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)               # (n, 1)
    c2 = torch.sum(c * c, dim=-1)[None, :]                    # (1, k)
    return x2 + c2 - 2.0 * (x @ c.T)


def _cpu_draws(generator: torch.Generator | None) -> torch.Generator:
    if generator is None:
        return torch.Generator().manual_seed(0)
    if generator.device.type != "cpu":
        raise ValueError("clustering draws from a CPU torch.Generator, so "
                         "every device draws the same values")
    return generator


def kmeans_plus_plus_lite(generator: torch.Generator | None,
                          x: torch.Tensor, k: int,
                          n_candidates: int = 4) -> torch.Tensor:
    """Cheap k-means++ seeding: sample k centers, each chosen from a few
    distance-weighted candidates."""
    g = _cpu_draws(generator)
    n = x.shape[0]
    first = int(torch.randint(0, n, (), generator=g))
    centers = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = x[first]
    d2 = torch.sum((x - x[first]) ** 2, dim=-1)
    for ki in range(1, k):
        p = d2 / torch.clamp(d2.sum(), min=1e-9)
        cand = torch.multinomial(p.cpu(), n_candidates, replacement=True,
                                 generator=g).to(x.device)
        # pick the candidate that most reduces total distance
        cand_d2 = torch.sum((x[None, :, :] - x[cand][:, None, :]) ** 2, -1)
        tot = torch.sum(torch.minimum(d2[None, :], cand_d2), dim=-1)
        best = cand[torch.argmin(tot)]
        centers[ki] = x[best]
        d2 = torch.minimum(d2, torch.sum((x - x[best]) ** 2, -1))
    return centers


_SUM_ROWS = 1 << 17      # rows of x per one-hot GEMM in _cluster_sums


def _cluster_sums(x: torch.Tensor, assign: torch.Tensor,
                  k: int) -> torch.Tensor:
    """(k, d) sums of x's rows by cluster, the same bits on every run: a
    one-hot GEMM over fixed row chunks, added in order (float atomics,
    as ``index_add_`` uses on the card, would make k-means differ from
    run to run for one seed)."""
    ids = torch.arange(k, device=x.device)[:, None]
    sums = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    for lo in range(0, x.shape[0], _SUM_ROWS):
        hot = (assign[None, lo:lo + _SUM_ROWS] == ids).to(x.dtype)
        sums += hot @ x[lo:lo + _SUM_ROWS]
    return sums


def _lloyd(x: torch.Tensor, centers: torch.Tensor,
           iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's iterations from given initial centers; returns (centroids,
    assignment). An empty cluster keeps its center."""
    k = centers.shape[0]
    for _ in range(iters):
        assign = torch.argmin(sq_distances(x, centers), dim=-1)
        sums = _cluster_sums(x, assign, k)
        cnt = torch.bincount(assign, minlength=k).to(x.dtype)
        centers = torch.where(cnt[:, None] > 0,
                              sums / torch.clamp(cnt, min=1)[:, None],
                              centers)
    return centers, torch.argmin(sq_distances(x, centers), dim=-1)


def lloyd_kmeans(generator: torch.Generator | None, x: torch.Tensor, k: int,
                 iters: int = 10, seed_mode: str = "random"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means. Returns (centroids (k, d), assignment (n,)).
    ``seed_mode="random"`` starts from k distinct points drawn uniformly
    without replacement."""
    g = _cpu_draws(generator)
    if seed_mode == "kmeans++":
        centers = kmeans_plus_plus_lite(g, x, k)
    else:
        idx = torch.randperm(x.shape[0], generator=g)[:k]
        centers = x[idx.to(x.device)]
    return _lloyd(x, centers, iters)


def balanced_assign(x: torch.Tensor, centers: torch.Tensor,
                    capacity: int) -> torch.Tensor:
    """Capacity-bounded cluster assignment (int32, (n,)).

    Greedy over distance rank: in each round every unassigned doc asks for
    its next-nearest centroid, and each cluster accepts the lowest-indexed
    askers that fit its remaining room; the rest move one choice down.
    The reference scans k rounds; a round with nothing unassigned changes
    nothing, so the rounds stop there, with the same result."""
    return _balanced_rounds(sq_distances(x, centers), capacity)


def _balanced_rounds(d2: torch.Tensor, capacity: int) -> torch.Tensor:
    """``balanced_assign``'s rounds over a given (n, k) distance matrix."""
    n, k = d2.shape
    dev = d2.device
    pref = torch.argsort(d2, dim=-1, stable=True)                  # (n, k)
    assign = torch.full((n,), -1, dtype=torch.int32, device=dev)
    choice_ix = torch.zeros((n,), dtype=torch.int64, device=dev)
    counts = torch.zeros((k,), dtype=torch.int64, device=dev)
    for _ in range(k):
        rows = torch.nonzero(assign < 0).flatten()          # ascending ids
        if rows.numel() == 0:
            break
        want = pref[rows, torch.clamp(choice_ix[rows], max=k - 1)]
        # arrival order within each wanted cluster: a stable sort by the
        # cluster keeps the lower id first
        order = torch.argsort(want, stable=True)
        want_sorted = want[order]
        accept_sorted = (rank_within_run(want_sorted)
                         < (capacity - counts)[want_sorted])
        accept = torch.zeros_like(accept_sorted)
        accept[order] = accept_sorted
        took = want[accept]
        assign[rows[accept]] = took.to(torch.int32)
        counts += torch.bincount(took, minlength=k)
        choice_ix[rows[~accept]] += 1
    # any stragglers (pathological capacity): round-robin into free slots
    return torch.where(assign < 0, (torch.arange(n, device=dev) % k).to(
        torch.int32), assign)


# ---------------------------------------------------------------------------
# Dense counterparts for clustering (paper §3.4)
# ---------------------------------------------------------------------------

#: documents a bag-sum chunk of ``dense_rep_projection`` covers
PROJECTION_CHUNK = 1 << 18


def rademacher(vocab: int, dim: int, seed: int = 0) -> torch.Tensor:
    """(vocab + 1, dim) float32 random signs, drawn on the CPU; the last
    row (the padding slot) is zero."""
    g = torch.Generator().manual_seed(seed)
    proj = torch.randint(0, 2, (vocab + 1, dim), generator=g).float() * 2 - 1
    proj[vocab] = 0.0
    return proj


def _project(docs: SparseDocs, proj: torch.Tensor) -> torch.Tensor:
    """Sum of each document's weighted projection rows, / sqrt(dim): a
    weighted bag sum, chunked over documents, that never materialises the
    (n, t_pad, dim) gather."""
    dim = proj.shape[1]
    dev = proj.device
    out = torch.empty((docs.n_docs, dim), dtype=torch.float32, device=dev)
    for lo in range(0, docs.n_docs, PROJECTION_CHUNK):
        hi = min(lo + PROJECTION_CHUNK, docs.n_docs)
        mask = docs.mask[lo:hi].to(dev)
        tids = torch.where(mask, docs.tids[lo:hi].to(dev), docs.vocab).long()
        w = torch.where(mask, docs.tw[lo:hi].to(dev), 0.0)
        out[lo:hi] = F.embedding_bag(tids, proj, per_sample_weights=w,
                                     mode="sum")
    return out / math.sqrt(dim)


def dense_rep_projection(docs: SparseDocs, dim: int = 128, seed: int = 0,
                         device: str | torch.device | None = None
                         ) -> torch.Tensor:
    """Random-projection dense counterpart on ``device`` (None: the card):
    sign-random-project the sparse vector. Used by synthetic corpora that
    have no trained encoder; inner products (hence k-means geometry) are
    preserved in expectation."""
    dev = resolve_device(device)
    return _project(docs, rademacher(docs.vocab, dim, seed).to(dev))


def dense_rep_pooled(token_embeddings: torch.Tensor, token_mask: torch.Tensor,
                     mode: str = "max") -> torch.Tensor:
    """Paper options over encoder token embeddings (L, d) per doc:
    max / mean pooling or CLS (position 0)."""
    if mode == "cls":
        return token_embeddings[:, 0, :]
    m = token_mask[..., None]
    if mode == "max":
        neg = torch.finfo(token_embeddings.dtype).min
        return torch.max(torch.where(m, token_embeddings, neg), dim=1).values
    if mode == "mean":
        s = torch.sum(torch.where(m, token_embeddings, 0.0), dim=1)
        return s / torch.sum(m, dim=1).clamp(min=1)
    raise ValueError(f"unknown pooling mode {mode!r}")
