"""Each stage's work count against shapes counted by hand, and the
roofline share built from it."""

from __future__ import annotations

import pytest
import torch

from bench import devtrace, roofline
from repro_torch.kernels.query_terms import query_terms
from repro_torch.core.types import QueryBatch


def test_bounds_work_by_hand():
    # 36,864 table rows (4,096 clusters x 9), 256 queries of 32 slots,
    # 5,000 union terms, 5,888 live query terms
    b, o = roofline.bounds_work(36864, 256, 32, 5000, 5888)
    assert b == 5000 * 36864 + 256 * 32 * 8 + 256 * 4 + 256 * 36864 * 4
    assert o == 2 * 5888 * 36864


def test_score_merge_plan_work_by_hand():
    b, o = roofline.score_work(union_docs=60000, t_pad=128, tid_bytes=2,
                               pairs=1_000_000, n_q=256, q_pad=32, calls=3)
    assert b == 60000 * 128 * 3 + 3 * 256 * 32 * 8 + 4_000_000 and o == 0
    b, o = roofline.merge_work(pairs=1_000_000, n_q=256, k=10, calls=3)
    assert b == 4_000_000 + 3 * 256 * 10 * 20 and o == 0
    assert roofline.plan_work(100, 28) == (128.0, 0.0)


def test_least_time_names_its_bound():
    t, by = roofline.least_time(3.35e12, 1.0)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = roofline.least_time(1.0, 67e12)
    assert by == "ops" and t == pytest.approx(1.0)
    share, by = roofline.share({"bytes": 3.35e9, "ops": 0.0,
                                "device_s": 4e-3})
    assert share == pytest.approx(25.0) and by == "bytes"
    assert roofline.share({"bytes": 1.0, "ops": 0.0, "device_s": 0.0}) is None
    assert roofline.share(None) is None


def test_recorded_work_counts_the_calls_inputs():
    """StageWork notes K1's table rows and union from the call's own
    term layout, and sums the executor's admitted documents over calls."""
    work = devtrace.StageWork()
    q = QueryBatch(tids=torch.tensor([[3, 5, -1], [5, 7, 9]]),
                   tw=torch.ones(2, 3), mask=torch.tensor(
                       [[True, True, False], [True, True, True]]), vocab=10)
    terms = query_terms(q)
    work.note("bounds", (torch.zeros(18, 10, dtype=torch.uint8), terms,
                         None), None)

    class Plan:
        # two clusters of 4 docs, 2 segments; query 0 admits cluster 0's
        # segment 1, query 1 cluster 0's segment 1 and cluster 1's both
        seg_admit = torch.tensor([[[False, True], [False, False]],
                                  [[False, True], [True, True]]])
    dseg = torch.tensor([[0, 1, 1, 0], [0, 0, 1, 1]])
    dmask = torch.tensor([[True, True, True, False], [True, True, True,
                                                        True]])
    tids = torch.zeros((2, 4, 6), dtype=torch.int16)
    for _ in range(2):
        work.note("score", (tids, None, dseg, dmask, terms, Plan), None)
    work.note("merge", (torch.zeros(2, 10), None, None, None, None, 10),
              None)
    tot = work.totals(pairs=123)
    # union {3, 5, 7, 9} over 18 rows; 5 live query terms
    assert (tot["bounds"]["bytes"], tot["bounds"]["ops"]) == \
        roofline.bounds_work(18, 2, terms.q_pad, 4, 5)
    # admitted by some query: cluster 0 segment 1 (2 docs) + cluster 1 (4)
    assert tot["score"]["bytes"] == roofline.score_work(
        12, 6, 2, 123, 2, terms.q_pad, 2)[0]
    assert tot["merge"]["calls"] == 1 and "plan" not in tot

