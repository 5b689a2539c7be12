"""Cluster segmentation for segmented maximum term weights (paper §3.4).

Two offline options, compared in paper Table 3:

  * ``random_uniform`` (default, and the one that makes Proposition 4 hold:
    every document has an equal chance of landing in any segment) —
    "random even partitioning": shuffle the docs of a cluster and deal them
    round-robin over ``n_seg`` segments;
  * ``kmeans_sub`` — k-means sub-clustering of the docs inside each cluster
    over their dense counterparts; tighter-looking bounds but a larger
    Max-Avg segment-bound gap, i.e. more aggressive (less safe) pruning.
"""

from __future__ import annotations

import numpy as np


def random_uniform_segments(rng: np.random.Generator, n_docs: int,
                            n_seg: int) -> np.ndarray:
    """Segment id per doc, |size difference| <= 1, uniformly random."""
    seg = np.arange(n_docs, dtype=np.int32) % n_seg
    rng.shuffle(seg)
    return seg


def kmeans_sub_segments(dense: np.ndarray, n_seg: int, iters: int = 8,
                        rng: np.random.Generator | None = None) -> np.ndarray:
    """Plain (unbalanced) k-means into n_seg sub-clusters; ties to random."""
    rng = rng or np.random.default_rng(0)
    n = dense.shape[0]
    if n <= n_seg:
        return np.arange(n, dtype=np.int32) % n_seg
    centers = dense[rng.choice(n, n_seg, replace=False)]
    assign = np.zeros((n,), np.int32)
    for _ in range(iters):
        d2 = (
            (dense * dense).sum(-1, keepdims=True)
            + (centers * centers).sum(-1)[None, :]
            - 2.0 * dense @ centers.T
        )
        assign = d2.argmin(-1).astype(np.int32)
        for j in range(n_seg):
            pick = assign == j
            if pick.any():
                centers[j] = dense[pick].mean(0)
    return assign
