"""The wave's merge (``kernels/merge_topk``): its plain version, the sort
path the CPU runs, against an independent numpy oracle on
``repro_torch.tools.merge_cases``.

The oracle ranks [running top-k ‖ the wave's scores above theta, NEG
elsewhere] with ``np.lexsort`` on (position, -score): score descending,
position ascending, the running entries first. It compares +0.0 and -0.0
as equal, as the sorts do. Scores are compared bit for bit, ids exactly.
The kernel itself runs only on the card (``tests/test_torch_kernels.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.search import _merge_wave
from repro_torch.kernels.merge_topk.ops import (MERGE_BUFFER,
                                                MERGE_MAX_CLUSTER,
                                                merge_cluster, merge_keys,
                                                merge_topk)
from repro_torch.kernels.merge_topk.ref import merge_wave_ref
from repro_torch.tools.merge_cases import (CASES, KS, N_QS, NEG, case_args,
                                           merge_case)


def oracle(top_scores, top_ids, scores, theta, ids_flat, k):
    n_q = scores.shape[0]
    cand = np.where(scores > theta[:, None, None], scores,
                    NEG).reshape(n_q, -1).astype(np.float32)
    cand_ids = np.where(cand > NEG, ids_flat[None, :], -1)
    vals = np.concatenate([top_scores, cand], axis=1)
    ids = np.concatenate([top_ids, cand_ids], axis=1)
    pos = np.arange(vals.shape[1])
    out_s = np.empty((n_q, k), np.float32)
    out_i = np.empty((n_q, k), np.int32)
    for q in range(n_q):
        order = np.lexsort((pos, -vals[q]))[:k]
        out_s[q], out_i[q] = vals[q, order], ids[q, order]
    return out_s, out_i


@pytest.mark.parametrize("n_q", N_QS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", CASES)
def test_plain_merge_matches_oracle(case, k, n_q):
    c = merge_case(case, n_q, k)
    want_s, want_i = oracle(**c, k=k)
    got_s, got_i = merge_wave_ref(*case_args(c, "cpu", k))
    assert got_s.dtype == torch.float32 and got_i.dtype == torch.int32
    assert np.array_equal(got_s.numpy().view(np.int32),
                          want_s.view(np.int32)), "scores (bits)"
    assert np.array_equal(got_i.numpy(), want_i), "ids"


def test_signed_zero_keeps_position_order():
    """A -0.0 ahead of a +0.0 stays ahead: the two rank as equal, so the
    earlier position wins, bits and all."""
    top = torch.tensor([[5.0, NEG]])
    ids = torch.tensor([[7, -1]], dtype=torch.int32)
    scores = torch.tensor([[[-0.0, 0.0, -0.0]]])
    got_s, got_i = merge_wave_ref(top, ids, scores, torch.tensor([-1.0]),
                                  torch.tensor([10, 11, 12],
                                               dtype=torch.int32), 3)
    assert got_i.tolist() == [[7, 10, 11]]
    assert torch.signbit(got_s).tolist() == [[False, True, False]]


@pytest.mark.parametrize("case", ["random", "first_wave", "ties",
                                  "narrow"])
def test_plain_merge_matches_oracle_deep(case):
    """k = 1,000, deeper than the wave is wide in the narrow case."""
    k = 1000
    c = merge_case(case, 4, k, width=(4, 600) if case != "narrow" else None)
    want_s, want_i = oracle(**c, k=k)
    got_s, got_i = merge_wave_ref(*case_args(c, "cpu", k))
    assert np.array_equal(got_s.numpy().view(np.int32),
                          want_s.view(np.int32)), "scores (bits)"
    assert np.array_equal(got_i.numpy(), want_i), "ids"


def test_cpu_merge_is_the_plain_version():
    """On the CPU ``_merge_wave`` and the kernel's wrapper both give the
    plain version's answer, and the wrapper launches nothing."""
    c = merge_case("random", 8, 10)
    args = case_args(c, "cpu", 10)
    want = merge_wave_ref(*args)
    before = merge_topk.launches
    for got in (_merge_wave(*args), merge_topk(*args)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert merge_topk.launches == before


@pytest.mark.parametrize("n_q,L,k,n_sm,want", [
    (256, 81920, 10, 132, 4), (64, 81920, 10, 132, 8),
    (1, 81920, 10, 132, 8), (1024, 81920, 10, 132, 1),
    (256, 400, 10, 132, 1), (64, 9000, 10, 132, 2),
    (256, 81920, 100, 132, 4), (64, 81920, 1000, 132, 2),
    (64, 81920, 2000, 132, 1), (1, 81920, 5000, 132, 2),
    (1, 81920, 20000, 132, 2)])
def test_merge_cluster_fills_the_card(n_q, L, k, n_sm, want):
    """Blocks a row: about four blocks an SM, a power of two, at most
    eight, a slice of at least 4,096 scores a block, and no more than the
    first block's workspace holds the lists of."""
    assert merge_cluster(n_q, L, k, n_sm) == want


@pytest.mark.parametrize("k", [1, 10, 100, 128, 1000, 2048, 5000, 20000])
def test_merge_workspace_holds_list_buffer_and_cluster(k):
    """A block's workspace is a power of two that holds its list and the
    buffer behind it, and the first block's holds every list of its
    cluster beside the running top-k, at every k."""
    cap = merge_keys(k)
    assert cap & (cap - 1) == 0 and cap >= k + MERGE_BUFFER
    assert cap < 2 * max(k + MERGE_BUFFER, 2 * k)
    for n_q in (1, 64, 256):
        cs = merge_cluster(n_q, 81920, k, 132)
        assert 1 <= cs <= MERGE_MAX_CLUSTER and (cs + 1) * k <= cap


@pytest.mark.parametrize("engine", ["batched", "two_level", "pipelined",
                                    "per_query"])
def test_walks_merge_each_wave_through_merge_wave(engine):
    """Every wave of the batched walks merges once, through
    ``_merge_wave`` inside a ``merge`` span; the pipelined engine merges
    each wave of a fused step, a gated one too; the per-query engine
    takes none. On the CPU the kernel's wrapper launches nothing."""
    import repro_torch.core.search as search_mod
    from repro_torch.core.search import (SearchConfig, retrieve,
                                         retrieve_pipelined)
    from repro_torch.obs import TraceRecorder
    from repro_torch.tools.golden_world import golden_world
    index, queries = golden_world("cpu")
    cfg = SearchConfig(k=10, mu=0.8, eta=1.0, block_q=4, block_d=8,
                       group_size=2, bounds_impl="gemm",
                       engine="per_query" if engine == "per_query"
                       else engine if engine == "pipelined" else "batched",
                       superblocks=engine == "two_level")
    stats: dict = {}
    calls = []

    def counted(*a):
        calls.append(a[-1])
        return merge_wave_ref(*a)

    rec = TraceRecorder(None, enabled=True)
    before = merge_topk.launches
    mp = pytest.MonkeyPatch()
    mp.setattr(search_mod, "merge_topk", counted)
    try:
        with rec.request():
            if engine == "pipelined":
                retrieve_pipelined(index, queries, cfg, device="cpu",
                                   stats=stats)
            else:
                retrieve(index, queries, cfg, device="cpu", stats=stats)
    finally:
        mp.undo()
    (_, events), = rec.requests()
    merges = [e for e in events if e["name"] == "merge"]
    assert merge_topk.launches == before
    assert all(k == 10 for k in calls)
    if engine == "per_query":
        assert not calls and not merges
    elif engine == "pipelined":
        assert len(calls) >= stats["waves"] >= 1
    else:
        assert len(calls) == len(merges) >= 1
        if engine == "batched":
            assert len(calls) == stats["waves"]
