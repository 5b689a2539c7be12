"""What decides ``correct``: the served answers of a sample of the window's
batches against the plain reference (``bench/reference/asc.py``).

Two numbers, each with its own limit (PERF.md gives the readings each
limit was set from):

  * ``queries_off_share``: the share of the checked queries whose served
    top-k departs from the reference walk's, a query departing where the
    relative gap between its served and reference scores exceeds
    ``QUERY_GAP`` at some rank. It covers the index build, the bounds,
    the (mu, eta) admission, the walk, the scoring and the merge: a
    decision taken otherwise than the reference's changes a query's top-k,
    and so its scores. It is a share and not the widest gap because the
    program decides in float32 and the reference exactly: a bound within
    float32 rounding of theta / mu can go either way, and where the
    cluster it admits or prunes holds a top-k document, that one query's
    answer departs from the reference by up to 1 - mu, in a sound run;
  * ``doc_score_gap``: the widest relative gap between a served score
    and the exact score of the document the program named beside it, so
    a wrong id, a wrong weight or a score altered where it is produced
    shows in any one query, even where the ranked scores agree.

A slot the program leaves empty (id -1) where the reference has a
document reads a gap of 1, as does an id outside the corpus.
"""

from __future__ import annotations

import math

import torch

LIMITS = {"queries_off_share": 0.05, "doc_score_gap": 1e-4}
QUERY_GAP = 1e-4


def _rel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs() / b.abs().clamp(min=1e-30)


def query_gaps(ids: torch.Tensor, scores: torch.Tensor,
               ref_ids: torch.Tensor, ref_scores: torch.Tensor
               ) -> torch.Tensor:
    """(n_q,) float64: each query's widest relative gap, rank by rank,
    between the served (ids, scores) and the reference's."""
    have, want = ids >= 0, ref_ids >= 0
    gap = torch.where(have & want, _rel(scores.double(), ref_scores), 0.0)
    gap = torch.where(have != want, 1.0, gap)
    return gap.amax(-1) if gap.shape[-1] else gap.new_zeros(gap.shape[:-1])


def doc_score_gap(ids: torch.Tensor, scores: torch.Tensor, n_docs: int,
                  exact) -> float:
    """Served scores against ``exact(safe_ids)``, the reference's score
    of each named document (ids clamped into range; -1 slots skipped)."""
    inside = (ids >= 0) & (ids < n_docs)
    got = exact(torch.where(inside, ids, 0).long())
    gap = torch.where(inside, _rel(scores.double(), got), 0.0)
    gap = torch.where(ids >= n_docs, 1.0, gap)
    return float(gap.max()) if gap.numel() else 0.0


def verdict(numbers: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) in LIMITS' order; a number
    that is not finite reads 1."""
    checks = {name: {"value": (numbers[name] if math.isfinite(numbers[name])
                               else 1.0), "limit": limit}
              for name, limit in LIMITS.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
