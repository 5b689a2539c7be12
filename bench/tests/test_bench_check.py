"""The compared numbers of ``bench/check.py`` on hand-made answers."""

from __future__ import annotations

import pytest
import torch

from bench import check


def _answers(n_q: int = 768, k: int = 10, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, 10**6, (n_q, k), generator=g)
    scores = torch.sort(torch.rand((n_q, k), generator=g, dtype=torch.float64)
                        + 1.0, dim=1, descending=True).values
    return ids, scores


def test_query_gaps_are_each_querys_widest_rank_gap():
    ids, scores = _answers(4, 3)
    got_s = scores.clone()
    got_s[1, 2] *= 1 + 3e-3
    got_s[2, 0] *= 1 - 5e-7
    got_i = ids.clone()
    got_i[3, 1] = -1
    gaps = check.query_gaps(got_i, got_s.float(), ids, scores)
    assert gaps.shape == (4,)
    assert float(gaps[0]) < 1e-7
    assert float(gaps[1]) == pytest.approx(3e-3, rel=1e-3)
    assert float(gaps[2]) < 1e-6
    assert float(gaps[3]) == 1.0


@pytest.mark.parametrize("n_off, correct", [(0, True), (1, True), (38, True),
                                            (39, False), (768, False)])
def test_the_share_of_departed_queries_against_its_limit(n_off, correct):
    # one query whose walk took the other side of a float32 near tie is a
    # sound run; a share over the limit is not
    ids, scores = _answers()
    got_i, got_s = ids.clone(), scores.clone()
    got_s[:n_off, 0] *= 1 - (1 - 0.9) / 2
    gaps = check.query_gaps(got_i, got_s, ids, scores)
    share = int((gaps > check.QUERY_GAP).sum()) / gaps.shape[0]
    ok, checks = check.verdict({"queries_off_share": share,
                                "doc_score_gap": 0.0})
    assert ok is correct
    assert checks["queries_off_share"]["value"] == share


def test_a_number_that_is_not_finite_reads_one():
    ok, checks = check.verdict({"queries_off_share": 0.0,
                                "doc_score_gap": float("nan")})
    assert ok is False and checks["doc_score_gap"]["value"] == 1.0
