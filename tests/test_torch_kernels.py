"""Kernel parity for the PyTorch port (repro_torch.kernels).

Each kernel's plain PyTorch version — what its wrapper runs for a CPU
tensor — is held against the JAX package's Pallas kernel (interpret mode,
as tests/test_kernels.py and tests/test_batched_engine.py run it) and
against the JAX reference, on the same numpy inputs:

  * the sparse query layout (kernels/query_terms.py) both kernels read:
    it rebuilds every query's dense map and every block's transposed map
    exactly;
  * K1 segment bounds: rtol 1e-5 (fp32 sums in another order);
  * K3 compaction: bit-exact, empty and full rows included;
  * K2 executor and K4 per-query scoring (by cluster id with the
    admission applied, and on a flat batch): rtol 1e-5 on admitted
    scores, NEG positions exact.

The ``gpu`` tests hold each CUDA kernel against its plain version on the
card (the wave planner, K3, on ``repro_torch.tools.plan_cases``; its plain
version is ``plan_wave``'s op-by-op code, whose CPU parity is
tests/test_torch_plan.py's; the wave's merge bit for bit on
``repro_torch.tools.merge_cases``, whose CPU oracle is
tests/test_torch_merge.py's), the superblock walk and the pipelined
engine on the card against the on-card plain path, and the lifecycle on
the card (the churned golden world against the CPU path, a card snapshot
a complete copy that later writes never reach, an engine over a
publisher serving two epochs against the on-card plain path), the
streaming front-end served from its pump thread, and ``balanced_assign``
on the card against the CPU port; they skip where there is none. This file must also collect on the
machine with the card, which has no JAX: the reference is imported inside
the tests that use it. Run the card tests with
``PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.index import build_index
from repro_torch.core.search import (SearchConfig, retrieve,
                                     retrieve_pipelined, retrieve_with_plans)
from repro_torch.core.plan import PLAN_FIELDS, plan_wave
from repro_torch.core.types import TOPK_FIELDS, QueryBatch, take_rows
from repro_torch.data.synthetic import CorpusSpec, make_corpus, make_queries
from repro_torch.kernels import MAIN_PATH, launch_counts
from repro_torch.kernels.plan_wave.compact import (compact_front,
                                                   compact_front_plain)
from repro_torch.kernels.plan_wave.ref import compact_front_ref
from repro_torch.kernels.query_terms import block_map_t, query_terms
from repro_torch.kernels.score_cluster_batch import ops as k2_ops
from repro_torch.kernels.score_cluster_batch.ops import score_admitted
from repro_torch.kernels.score_cluster_batch.ref import (NEG,
                                                         score_admitted_ref,
                                                         score_runs_ref)
from repro_torch.kernels.score_docs.ops import score_clusters, score_docs
from repro_torch.kernels.score_docs.ref import (score_clusters_ref,
                                                score_docs_ref)
from repro_torch.kernels.segment_bound.ops import segment_bound_gemm
from repro_torch.kernels.segment_bound.ref import segment_bound_gemm_ref
from repro_torch.tools.plain_path import plain_versions, swapped_wrappers

RTOL = 1e-5


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # full fp32 for the plain K1 version, which refuses TF32
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand_table(rng, s, v):
    return rng.integers(0, 256, (s, v)).astype(np.uint8)


def _rand_qmap(rng, q, v, density=0.2):
    m = rng.random((q, v)) < density
    return (rng.random((q, v)) * m).astype(np.float32)


def _batch_from_map(qmap, vocab, seed=0):
    """A QueryBatch holding the nonzeros of dense (Q, vocab') maps, in a
    shuffled slot order (the layout sorts them), one PAD slot a row."""
    rng = np.random.default_rng(seed)
    q = qmap.shape[0]
    width = int((qmap != 0).sum(1).max(initial=0)) + 1
    tids = np.full((q, width), -1, np.int32)
    tw = np.zeros((q, width), np.float32)
    for r in range(q):
        idx = np.flatnonzero(qmap[r])
        rng.shuffle(idx)
        tids[r, :len(idx)] = idx
        tw[r, :len(idx)] = qmap[r, idx]
    return QueryBatch(tids=_t(tids), tw=_t(tw), mask=_t(tids >= 0),
                      vocab=vocab)


# ---------------------------------------------------------------------------
# the sparse query layout
# ---------------------------------------------------------------------------

def _ragged_queries():
    """37 queries over V = 70: query 5 has no terms, odd queries share
    the terms 0..19, every row has PAD slots (mask False, and id V)."""
    rng = np.random.default_rng(11)
    n_q, qp, V = 37, 8, 70
    tids = np.full((n_q, qp), -1, np.int32)
    tw = np.zeros((n_q, qp), np.float32)
    mask = np.zeros((n_q, qp), bool)
    for q in range(n_q):
        k = 0 if q == 5 else int(rng.integers(1, qp - 1))
        pick = rng.choice(20 if q % 2 else V, k, replace=False)
        slots = rng.choice(qp, k, replace=False)
        tids[q, slots] = pick
        tw[q, slots] = rng.random(k).astype(np.float32) + 0.1
        mask[q, slots] = True
    tids[3, ~mask[3]] = V                       # a PAD slot at id V
    tids[4, np.flatnonzero(~mask[4])[0]] = 7    # masked: not a term
    return QueryBatch(tids=_t(tids), tw=_t(tw), mask=_t(mask), vocab=V)


def _layout_case(name, request):
    from repro_torch.convert import queries_from_arrays
    if name == "ragged":
        return _ragged_queries(), 16, None
    if name == "golden":
        _, jq, _, q = _jax_world()
        return q, 4, jq
    jq, _ = request.getfixturevalue("queries")       # conftest's SPEC
    q = queries_from_arrays(np.asarray(jq.tids), np.asarray(jq.tw),
                            np.asarray(jq.mask), vocab=jq.vocab,
                            device="cpu")
    return q, 8, jq


@pytest.mark.parametrize("case", ["ragged", "golden", "spec"])
def test_query_terms_rebuild_dense_maps(case, request):
    """Each query's term list rebuilds its dense map, and each block's
    bitmap + prefix counts + CSR rebuild the block's transposed map, the
    way K2 looks a term up; ids ascend and counts are exact."""
    queries, bq, jq = _layout_case(case, request)
    terms = query_terms(queries, bq)
    dense = queries.dense_map()
    assert torch.equal(terms.qmaps, dense)
    if jq is not None:
        np.testing.assert_array_equal(terms.qmaps.numpy(),
                                      np.asarray(jq.dense_map()))
    V = queries.vocab
    valid = queries.mask & (queries.tids < V)
    assert torch.equal(terms.count, valid.sum(1, dtype=torch.int32))
    slot = torch.arange(terms.q_pad)[None]
    live = slot < terms.count[:, None]
    assert bool((terms.tids[:, 1:] > terms.tids[:, :-1])[live[:, 1:]].all())
    assert bool((terms.tids[~live] == V).all())
    assert bool((terms.tw[~live] == 0).all())
    n_qb = -(-queries.n_queries // bq)
    padded = torch.zeros((n_qb * bq, V + 1))
    padded[:queries.n_queries] = dense
    for b in range(n_qb):
        want = padded[b * bq:(b + 1) * bq].T
        assert torch.equal(block_map_t(terms, b), want), (case, b)
        union = (want != 0).any(1)
        assert int(terms.n_union[b]) == int(union.sum())
        assert int(terms.term_ptr[b, -1]) == int((want != 0).sum())
    if case == "ragged":
        assert int(terms.count[5]) == 0
        assert not bool(terms.qmaps[5].any())
        assert n_qb * bq > queries.n_queries             # a partial block


def test_query_terms_without_blocks():
    """The per-query part alone (K1, the per-query engine)."""
    q = _ragged_queries()
    terms = query_terms(q)
    assert terms.block_q is None and terms.bitmap is None
    assert torch.equal(terms.qmaps, q.dense_map())


# ---------------------------------------------------------------------------
# K1: segment bounds
# ---------------------------------------------------------------------------

K1_SHAPES = [(1, 1, 1), (7, 3, 33), (130, 129, 513), (384, 64, 2048)]


@pytest.mark.parametrize("s,q,v", K1_SHAPES)
def test_segment_bound_plain_matches_pallas(s, q, v):
    import jax.numpy as jnp
    from repro.kernels.segment_bound import ops as jops
    from repro.kernels.segment_bound import ref as jref
    rng = np.random.default_rng(s * 1000 + q * 10 + v)
    table, qmap = _rand_table(rng, s, v), _rand_qmap(rng, q, v)
    scale = np.float32(0.037)
    terms = query_terms(_batch_from_map(qmap, v, seed=s))
    got = segment_bound_gemm(_t(table), terms, torch.tensor(scale))
    assert got.shape == (q, s) and got.dtype == torch.float32
    for want in (jops.segment_bound_gemm(jnp.asarray(table),
                                         jnp.asarray(qmap), scale),
                 jref.segment_bound_gemm_ref(jnp.asarray(table),
                                             jnp.asarray(qmap), scale)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=1e-6)


def test_segment_bound_takes_a_column_slice():
    """The term lists leave out slot V, so the bounds are those of the
    (Q, V) view of the (Q, V + 1) maps."""
    rng = np.random.default_rng(5)
    table = _t(_rand_table(rng, 40, 99))
    wide = _rand_qmap(rng, 6, 100)
    wide[:, 99] = 1.0                              # the pad slot, dropped
    scale = torch.tensor(np.float32(0.5))
    got = segment_bound_gemm(table, query_terms(_batch_from_map(wide, 99)),
                             scale)
    want = torch.einsum("sv,qv->qs", table.float(), _t(wide)[:, :99]) * scale
    assert torch.equal(got, want)


def test_wrappers_on_golden_world():
    """K1 and K2 through the term layout on the golden world equal the
    JAX package's kernels (interpret mode) on its dense maps."""
    import jax.numpy as jnp
    from repro.core.plan import plan_wave as jplan_wave
    from repro.kernels.score_cluster_batch import ops as jk2
    from repro.kernels.segment_bound import ops as jk1
    jidx, jq, idx, q = _jax_world()
    terms = query_terms(q, 4)
    m, n1, V = idx.seg_max_stacked.shape
    got = segment_bound_gemm(idx.seg_max_stacked.reshape(m * n1, V), terms,
                             idx.scale)
    want = jk1.segment_bound_gemm(jidx.seg_max_stacked.reshape(m * n1, V),
                                  jq.dense_map()[:, :V], jidx.scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-6)
    cids = np.arange(idx.m, dtype=np.int32)
    seg = np.random.default_rng(9).random((q.n_queries, idx.m,
                                           idx.n_seg)) < 0.5
    jc = jnp.asarray(cids)
    jplan = jplan_wave(jc, jnp.ones(idx.m, bool), jnp.asarray(seg.any(-1)),
                       jnp.asarray(seg), 4, jidx.doc_seg_mod[jc],
                       jidx.doc_mask[jc], block_d=8,
                       seg_offsets=jidx.seg_offsets[jc],
                       sorted_upto=jidx.sorted_upto[jc])
    tc = torch.from_numpy(cids).long()
    plan = plan_wave(torch.from_numpy(cids), torch.ones(idx.m, dtype=bool),
                     _t(seg.any(-1)), _t(seg), 4, idx.doc_seg_mod[tc],
                     idx.doc_mask[tc], block_d=8,
                     seg_offsets=idx.seg_offsets[tc],
                     sorted_upto=idx.sorted_upto[tc])
    got = score_admitted(idx.doc_tids, idx.doc_tw, idx.doc_seg_mod[tc],
                         idx.doc_mask[tc], terms, plan, idx.scale).numpy()
    want = np.asarray(jk2.score_admitted(
        jidx.doc_tids, jidx.doc_tw, jidx.doc_seg_mod[jc], jidx.doc_mask[jc],
        jq.dense_map(), jplan, jidx.scale))
    neg = want == NEG
    np.testing.assert_array_equal(got == NEG, neg)
    np.testing.assert_allclose(got[~neg], want[~neg], rtol=RTOL)


# ---------------------------------------------------------------------------
# K3: queue compaction
# ---------------------------------------------------------------------------

K3_SHAPES = [(4,), (3, 7), (2, 5, 13), (8, 130), (64, 16), (1, 1),
             (5, 250)]


def _masks(shape, p, seed):
    if p == 0.0:
        return np.zeros(shape, bool)
    if p == 1.0:
        return np.ones(shape, bool)
    return np.random.default_rng(seed).random(shape) < p


@pytest.mark.parametrize("shape", K3_SHAPES)
@pytest.mark.parametrize("p", [0.0, 0.15, 0.5, 1.0])
def test_compaction_bit_exact_with_reference(shape, p):
    import jax.numpy as jnp
    from repro.kernels.plan_wave.compact import (compact_front as jxla,
                                                 compact_front_pallas_jit)
    from repro.kernels.plan_wave.ref import compact_front_ref as jref
    keep = _masks(shape, p, seed=len(shape) * 7 + int(p * 100))
    outs = {"plain": compact_front_plain(_t(keep)),
            "ref": compact_front_ref(_t(keep)),
            "dispatch": compact_front(_t(keep))}
    want_idx, want_cnt = map(np.asarray, jref(jnp.asarray(keep)))
    for jfn in (jxla, compact_front_pallas_jit):
        idx, cnt = jfn(jnp.asarray(keep))
        np.testing.assert_array_equal(np.asarray(idx), want_idx)
        np.testing.assert_array_equal(np.asarray(cnt), want_cnt)
    for name, (idx, cnt) in outs.items():
        assert idx.dtype == torch.int32 and cnt.dtype == torch.int32
        np.testing.assert_array_equal(idx.numpy(), want_idx, err_msg=name)
        np.testing.assert_array_equal(cnt.numpy(), want_cnt, err_msg=name)


# ---------------------------------------------------------------------------
# K2: work-queue executor
# ---------------------------------------------------------------------------

_WORLD: dict = {}


def _jax_world():
    """The golden world (600 docs, V=256, m=12) on both sides."""
    if "w" not in _WORLD:
        from test_golden_regression import _world
        from repro_torch.convert import index_from_arrays, queries_from_arrays
        from repro_torch.core.types import INDEX_FIELDS
        jidx, jq = _world()
        idx = index_from_arrays(
            {f: np.asarray(getattr(jidx, f)) for f in INDEX_FIELDS},
            vocab=jidx.vocab, n_seg=jidx.n_seg, device="cpu")
        q = queries_from_arrays(np.asarray(jq.tids), np.asarray(jq.tw),
                                np.asarray(jq.mask), vocab=jq.vocab,
                                device="cpu")
        _WORLD["w"] = (jidx, jq, idx, q)
    return _WORLD["w"]


@pytest.mark.parametrize("block_q,block_d,p,seed", [
    (4, 8, 0.6, 0), (8, None, 0.6, 1), (2, 16, 0.3, 2), (4, 8, 1.0, 3),
    (4, 8, 0.0, 4)])
def test_executor_plain_matches_pallas(block_q, block_d, p, seed):
    import jax.numpy as jnp
    from repro.core.plan import plan_wave as jplan_wave
    from repro.kernels.score_cluster_batch import ops as jops
    jidx, jq, idx, q = _jax_world()
    cids = np.array([3, 0, 7, 11, 5], np.int32)
    rng = np.random.default_rng(seed)
    seg_admit = rng.random((q.n_queries, len(cids), idx.n_seg)) < p
    seg_admit[:, 1] = False                   # a tile nobody admits
    admit = seg_admit.any(-1)
    live = np.ones(len(cids), bool)
    jc = jnp.asarray(cids)
    jplan = jplan_wave(jc, jnp.asarray(live), jnp.asarray(admit),
                       jnp.asarray(seg_admit), block_q,
                       jidx.doc_seg_mod[jc], jidx.doc_mask[jc],
                       block_d=block_d, seg_offsets=jidx.seg_offsets[jc],
                       sorted_upto=jidx.sorted_upto[jc])
    tc = torch.from_numpy(cids).long()
    plan = plan_wave(torch.from_numpy(cids), _t(live), _t(admit),
                     _t(seg_admit), block_q, idx.doc_seg_mod[tc],
                     idx.doc_mask[tc], block_d=block_d,
                     seg_offsets=idx.seg_offsets[tc],
                     sorted_upto=idx.sorted_upto[tc])
    qmaps, jqmaps = q.dense_map(), jq.dense_map()
    terms = query_terms(q, block_q)
    dseg, dmask = idx.doc_seg_mod[tc], idx.doc_mask[tc]
    jdseg, jdmask = jidx.doc_seg_mod[jc], jidx.doc_mask[jc]
    want = np.asarray(jops.score_admitted(
        jidx.doc_tids, jidx.doc_tw, jdseg, jdmask, jqmaps, jplan,
        jidx.scale))
    want_ref = np.asarray(jops.score_admitted_ref(
        jidx.doc_tids[jc], jidx.doc_tw[jc], jdseg, jdmask, jqmaps, jplan,
        jidx.scale))
    outs = {
        "dispatch": score_admitted(idx.doc_tids, idx.doc_tw, dseg, dmask,
                                   terms, plan, idx.scale),
        "ref": score_admitted_ref(idx.doc_tids[tc], idx.doc_tw[tc], dseg,
                                  dmask, qmaps, plan, idx.scale),
        "runs_ref": score_runs_ref(idx.doc_tids[tc], idx.doc_tw[tc], dseg,
                                   dmask, qmaps, plan, idx.scale),
    }
    neg = want == NEG
    np.testing.assert_array_equal(want_ref == NEG, neg)
    for name, out in outs.items():
        out = out.numpy()
        assert out.shape == want.shape, name
        np.testing.assert_array_equal(out == NEG, neg, err_msg=name)
        np.testing.assert_allclose(out[~neg], want[~neg], rtol=RTOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# K4: per-query document scoring
# ---------------------------------------------------------------------------

def _docs(rng, shape, vocab):
    tids = rng.integers(0, vocab + 1, shape).astype(np.uint16)
    tw = rng.integers(0, 256, shape).astype(np.uint8)
    tw[tids == vocab] = 0                          # padding slot
    qmap = (rng.random(vocab + 1) * (rng.random(vocab + 1) < 0.3)).astype(
        np.float32)
    qmap[vocab] = 0.0
    return tids, tw, qmap


@pytest.mark.parametrize("shape,vocab", [((1, 1), 7), ((7, 5), 33),
                                         ((300, 24), 256), ((3, 4, 16), 99)])
def test_score_docs_plain_matches_pallas(shape, vocab):
    import jax.numpy as jnp
    from repro.kernels.score_docs import ops as jops
    rng = np.random.default_rng(sum(shape) + vocab)
    tids, tw, qmap = _docs(rng, shape, vocab)
    scale = np.float32(0.021)
    got = score_docs(_t(tids), _t(tw), _t(qmap), torch.tensor(scale))
    jt = jnp.asarray(tids.astype(np.int32))
    flat = (jt.reshape(-1, shape[-1]), jnp.asarray(tw).reshape(-1, shape[-1]))
    for want in (jops.score_docs(jt, jnp.asarray(tw), jnp.asarray(qmap),
                                 scale),
                 jops.score_docs_ref(*flat, jnp.asarray(qmap),
                                     scale).reshape(shape[:-1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=1e-6)


def _cluster_case(case, n_seg, m, rng):
    """(cids (8,), seg_admit (8, n_seg)) of one K4 case: segment
    admission at random, one cluster admitting nothing, and the collapsed
    (n_seg == 1) table for ``"collapsed"``."""
    cids = rng.permutation(m)[:8]
    seg_admit = rng.random((8, 1 if case == "collapsed" else n_seg)) < 0.6
    seg_admit[2] = False
    return cids, seg_admit


@pytest.mark.parametrize("case", ["golden", "collapsed", "tombstoned"])
def test_score_clusters_plain_matches_pallas(case):
    """K4 as the per-query engine calls it (clusters by id, the admission
    applied) equals the JAX package's score_docs kernel (interpret mode)
    on the gathered tiles and the query's dense map, masked the same way,
    for each query of the golden world."""
    import jax.numpy as jnp
    from repro.kernels.score_docs import ops as jops
    jidx, jq, idx, q = _jax_world()
    rng = np.random.default_rng(["golden", "collapsed",
                                 "tombstoned"].index(case))
    cids, seg_admit = _cluster_case(case, idx.n_seg, idx.m, rng)
    doc_mask = np.asarray(jidx.doc_mask).copy()
    if case == "tombstoned":
        doc_mask &= rng.random(doc_mask.shape) >= 0.3
    seg = np.asarray(jidx.doc_seg_mod)[cids]
    ok = (seg_admit[:, :1] if seg_admit.shape[1] == 1
          else np.take_along_axis(seg_admit, seg, 1))
    admitted = doc_mask[cids] & ok
    tiles = jnp.asarray(np.asarray(jidx.doc_tids).astype(np.int32)[cids])
    weights = jnp.asarray(np.asarray(jidx.doc_tw)[cids])
    qmaps = jq.dense_map()
    terms = query_terms(q)
    for i in range(q.n_queries):
        want = np.where(admitted, np.asarray(jops.score_docs(
            tiles, weights, qmaps[i], jidx.scale)), NEG)
        got = score_clusters(idx.doc_tids, idx.doc_tw, idx.doc_seg_mod,
                             _t(doc_mask), torch.from_numpy(cids),
                             _t(seg_admit), terms, i, idx.scale).numpy()
        neg = want == NEG
        np.testing.assert_array_equal(got == NEG, neg)
        assert neg.any() and not neg.all()
        np.testing.assert_allclose(got[~neg], want[~neg], rtol=RTOL,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

def _card_world(device):
    spec = CorpusSpec(n_docs=900, vocab=300, n_topics=9, doc_terms=20,
                      t_pad=28, query_terms=8, q_pad=12, seed=31)
    docs, topic = make_corpus(spec)
    index = build_index(docs, topic % 10, m=10, n_seg=4, d_pad=128, seed=32,
                        device=device)
    queries, _ = make_queries(spec, 11, topic, seed=33)
    return index, queries.to(device)


def _sparse_qmap(rng, q, v, nnz):
    """(q, v) maps with ``nnz[i]`` terms in row i (0 allowed)."""
    out = np.zeros((q, v), np.float32)
    for r, k in enumerate(nnz):
        out[r, rng.choice(v, min(k, v), replace=False)] = \
            rng.random(min(k, v)) + 0.05
    return out


@pytest.mark.gpu
def test_segment_bound_kernel_on_card(cuda):
    """Dense-ish and sparse term lists, rows of every alignment (V odd),
    an empty query and one wider than q_pad = 32, and Q above one query
    block; a table that starts unaligned raises."""
    rng = np.random.default_rng(0)
    scale = torch.tensor(np.float32(0.037), device=cuda)
    cases = [(s, _rand_qmap(rng, q, v)) for s, q, v in K1_SHAPES]
    cases += [(4608, _sparse_qmap(rng, 2, 1000, [23, 0])),
              (333, _sparse_qmap(rng, 65, 3001, [23] * 63 + [40, 0])),
              (1001, _sparse_qmap(rng, 130, 30522, [0, 45] + [23] * 128))]
    for s, qmap in cases:
        v = qmap.shape[1]
        table = _t(_rand_table(rng, s, v)).to(cuda)
        terms = query_terms(_batch_from_map(qmap, v).to(cuda))
        before = launch_counts()["segment_bound_gemm"]
        got = segment_bound_gemm(table, terms, scale)
        assert launch_counts()["segment_bound_gemm"] == before + 1
        want = segment_bound_gemm_ref(table, terms, scale)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=1e-6)
    with pytest.raises(ValueError, match="aligned"):
        segment_bound_gemm(table[1:], terms, scale)


@pytest.mark.gpu
def test_compaction_kernel_on_card(cuda):
    for shape in K3_SHAPES + [(32, 1289), (7, 2560)]:
        for p in (0.0, 0.15, 0.5, 1.0):
            keep = _t(_masks(shape, p, seed=3)).to(cuda)
            idx, cnt = compact_front(keep)
            want_idx, want_cnt = compact_front_plain(keep)
            assert torch.equal(idx, want_idx) and torch.equal(cnt, want_cnt)


@pytest.mark.gpu
def test_executor_kernel_on_card(cuda, monkeypatch):
    """Partial query blocks (11 queries), several doc blockings, the
    collapsed n_seg == 1 admission, a sub-tile staged in chunks; an
    unaligned sub-tile and block_v raise."""
    index, queries = _card_world(cuda)
    cids = torch.tensor([4, 0, 9, 2, 7], dtype=torch.int32, device=cuda)
    cl = cids.long()
    dseg, dmask = index.doc_seg_mod[cl], index.doc_mask[cl]
    rng = np.random.default_rng(1)

    def run(block_q, block_d, n_seg):
        seg_admit = _t(rng.random((queries.n_queries, 5, n_seg)) < 0.5
                       ).to(cuda)
        seg_admit[:, 3] = False
        plan = plan_wave(cids, torch.ones(5, dtype=torch.bool, device=cuda),
                         seg_admit.any(-1), seg_admit, block_q, dseg, dmask,
                         block_d=block_d, seg_offsets=index.seg_offsets[cl],
                         sorted_upto=index.sorted_upto[cl])
        terms = query_terms(queries, block_q)
        got = score_admitted(index.doc_tids, index.doc_tw, dseg, dmask,
                             terms, plan, index.scale)
        want = score_admitted_ref(take_rows(index.doc_tids, cl),
                                  index.doc_tw[cl], dseg, dmask,
                                  terms.qmaps, plan, index.scale)
        neg = want == NEG
        assert torch.equal(got == NEG, neg), (block_q, block_d, n_seg)
        torch.testing.assert_close(got[~neg], want[~neg], rtol=RTOL,
                                   atol=1e-6)
        return terms, plan

    for block_q, block_d, n_seg in [(4, 8, 4), (16, 32, 4), (1, None, 4),
                                    (4, 8, 1), (8, None, 1)]:
        run(block_q, block_d, n_seg)
    monkeypatch.setattr(k2_ops, "SMEM_BUDGET", 8 * 1024)
    assert k2_ops.doc_chunk(128, 28, 2, 16, 4, index.vocab // 32 + 1,
                            16 * queries.q_pad)[0] < 128
    run(16, None, 4)
    terms, plan = run(4, 8, 4)
    with pytest.raises(ValueError, match="block_v"):
        score_admitted(index.doc_tids, index.doc_tw, dseg, dmask, terms,
                       plan, index.scale, block_v=128)
    seg_admit = torch.ones((queries.n_queries, 5, 4), dtype=torch.bool,
                           device=cuda)
    plan2 = plan_wave(cids, torch.ones(5, dtype=torch.bool, device=cuda),
                      seg_admit.any(-1), seg_admit, 4, dseg, dmask,
                      block_d=2)
    with pytest.raises(ValueError, match="multiple of 16"):
        score_admitted(index.doc_tids, index.doc_tw, dseg, dmask, terms,
                       plan2, index.scale)


@pytest.mark.gpu
def test_score_docs_kernel_on_card(cuda):
    rng = np.random.default_rng(2)
    for shape, vocab in [((1, 1), 7), ((300, 24), 256), ((3, 4, 16), 99),
                         ((64, 2560, 128), 30522)]:
        tids, tw, qmap = _docs(rng, shape, vocab)
        args = (_t(tids).to(cuda), _t(tw).to(cuda), _t(qmap).to(cuda),
                torch.tensor(np.float32(0.021), device=cuda))
        got = score_docs(*args)
        torch.testing.assert_close(got, score_docs_ref(*args), rtol=RTOL,
                                   atol=1e-6)


@pytest.mark.gpu
def test_plan_kernel_on_card(cuda):
    """The planner kernel (plan_wave on CUDA tensors, nothing injected)
    equals the plain op-by-op planner field for field on every edge case,
    in one call of two launches and no compact_front launch; int64 cids
    raise."""
    from repro_torch.tools.plan_cases import plan_cases
    for case in plan_cases():
        args, kw = case.args(cuda)
        before = launch_counts()
        got = plan_wave(*args, **kw)
        after = launch_counts()
        assert after["plan_wave"] == before["plan_wave"] + 2, case.name
        assert after["compact_front"] == before["compact_front"], case.name
        want = plan_wave(*args, **kw, _compact=compact_front_plain)
        for f in PLAN_FIELDS:
            g, w = getattr(got, f), getattr(want, f)
            assert g.dtype == w.dtype and torch.equal(g, w), (case.name, f)
    with pytest.raises(TypeError, match="cids"):
        plan_wave(args[0].long(), *args[1:], **kw)


@pytest.mark.gpu
def test_score_clusters_kernel_on_card(cuda):
    """K4 by cluster id against its plain version: both segment tables,
    tombstoned docs, int32 and int64 cluster ids, on a small world and at
    the MS MARCO widths (V = 30522, 2560 x 128 tiles, q_pad 32)."""
    rng = np.random.default_rng(3)
    index, queries = _card_world(cuda)
    m, dp, tp, V = 12, 2560, 128, 30522
    tids = rng.integers(0, V + 1, (m, dp, tp))
    tw = rng.integers(0, 256, (m, dp, tp)).astype(np.uint8)
    tw[tids == V] = 0
    qt = np.stack([rng.choice(np.unique(tids[:, :64])[:-1], 32,
                              replace=False) for _ in range(3)])
    wide = QueryBatch(tids=_t(qt.astype(np.int32)),
                      tw=_t(rng.random((3, 32)).astype(np.float32)),
                      mask=_t(np.ones((3, 32), bool)), vocab=V).to(cuda)
    arrays = dict(doc_tids=_t(tids.astype(np.uint16)).to(cuda),
                  doc_tw=_t(tw).to(cuda),
                  doc_seg_mod=_t(rng.integers(0, 8, (m, dp)).astype(
                      np.int32)).to(cuda),
                  doc_mask=_t(rng.random((m, dp)) < 0.9).to(cuda),
                  n_seg=8, m=m, scale=torch.tensor(np.float32(0.021),
                                                   device=cuda))
    worlds = [(dict(doc_tids=index.doc_tids, doc_tw=index.doc_tw,
                    doc_seg_mod=index.doc_seg_mod,
                    doc_mask=index.doc_mask & _t(
                        rng.random(tuple(index.doc_mask.shape)) >= 0.3
                    ).to(cuda),
                    n_seg=index.n_seg, m=index.m, scale=index.scale),
               queries),
              (arrays, wide)]
    for w, qs in worlds:
        terms = query_terms(qs)
        for case in ("segments", "collapsed"):
            cids, seg_admit = _cluster_case(case, w["n_seg"], w["m"], rng)
            for cid_dtype in (torch.int64, torch.int32):
                args = (w["doc_tids"], w["doc_tw"], w["doc_seg_mod"],
                        w["doc_mask"], _t(cids).to(cuda, cid_dtype),
                        _t(seg_admit).to(cuda))
                for i in range(min(qs.n_queries, 3)):
                    before = launch_counts()["score_clusters"]
                    got = score_clusters(*args, terms, i, w["scale"])
                    assert launch_counts()["score_clusters"] == before + 1
                    want = score_clusters_ref(*args, terms.qmaps[i],
                                              w["scale"])
                    neg = want == NEG
                    assert torch.equal(got == NEG, neg)
                    torch.testing.assert_close(got[~neg], want[~neg],
                                               rtol=RTOL, atol=1e-6)


# the golden world's slice configs (tests/test_golden_regression.py)
GOLDEN_CONFIGS = [
    dict(mu=0.8, eta=1.0, method="asc", engine="batched", block_q=4,
         block_d=8),
    dict(mu=1.0, eta=1.0, method="asc", engine="batched", block_q=4,
         block_d=8),
    dict(mu=1.0, eta=1.0, method="anytime", engine="batched", block_q=4,
         block_d=None),
    dict(mu=0.8, eta=1.0, method="asc", engine="per_query"),
    dict(mu=1.0, eta=1.0, method="anytime", engine="batched",
         cluster_budget=4, block_q=4, block_d=8),
]


def _same_merge(got, want, what):
    """Scores bit for bit (+0.0 against -0.0 too) and ids exactly."""
    (gs, gi), (ws, wi) = got, want
    assert gs.dtype == ws.dtype and gi.dtype == wi.dtype, what
    assert torch.equal(gs.cpu().view(torch.int32),
                       ws.cpu().view(torch.int32)), (what, "scores")
    assert torch.equal(gi.cpu(), wi.cpu()), (what, "ids")


@pytest.mark.gpu
def test_merge_kernel_on_card(cuda):
    """The merge kernel equals the sort path bit for bit, on the card and
    on the CPU, on every case of ``tools/merge_cases`` (ties, +-0.0, rows
    short of k survivors, all-NEG rows, the first wave, a wave narrower
    than k, a row width that is no multiple of 4) at k 1, 10, 100 and
    1, 64, 256 queries, and on random waves of the benchmark's width (256
    x 32 x 2,560) at several theta quantiles; one launch a call."""
    from repro_torch.kernels.merge_topk.ops import merge_topk
    from repro_torch.kernels.merge_topk.ref import merge_wave_ref
    from repro_torch.tools.merge_cases import (CASES, KS, N_QS, case_args,
                                               merge_case)
    for name in CASES:
        for k in KS:
            for n_q in N_QS:
                c = merge_case(name, n_q, k)
                args = case_args(c, cuda, k)
                before = merge_topk.launches
                got = merge_topk(*args)
                assert merge_topk.launches == before + 1
                what = (name, k, n_q)
                _same_merge(got, merge_wave_ref(*args), what)
                _same_merge(got, merge_wave_ref(*case_args(c, "cpu", k)),
                            what)
    for name, n_q, k in (("quantiles", 256, 10), ("first_wave", 256, 10),
                         ("random", 256, 10), ("quantiles", 64, 100),
                         ("ties", 256, 10), ("signed_zero", 64, 10)):
        c = merge_case(name, n_q, k, seed=1, width=(32, 2560))
        args = case_args(c, cuda, k)
        _same_merge(merge_topk(*args), merge_wave_ref(*args),
                    (name, "benchmark width", n_q, k))


@pytest.mark.gpu
def test_merge_takes_the_kernel_up_to_its_depth(cuda):
    """``_merge_wave`` launches the kernel at every k, once a call, and
    equals the sort path bit for bit on the card and the CPU: k = 128 and
    1,000 (the workspace in 32 KiB of shared memory), 5,000 (128 KiB),
    20,000 (a workspace in global memory), and k = 1,000 at the
    benchmark's width."""
    from repro_torch.core.search import _merge_wave
    from repro_torch.kernels.merge_topk.ops import merge_topk
    from repro_torch.kernels.merge_topk.ref import merge_wave_ref
    from repro_torch.tools.merge_cases import case_args, merge_case
    runs = [(name, n_q, k, width)
            for k, n_q, width in ((128, 64, (4, 300)), (1000, 64, (4, 3000)),
                                  (5000, 8, (4, 9000)),
                                  (20000, 4, (8, 6000)))
            for name in ("random", "first_wave", "ties")]
    runs += [(name, 256, 1000, (32, 2560))
             for name in ("first_wave", "quantiles")]
    for name, n_q, k, width in runs:
        c = merge_case(name, n_q, k, seed=2, width=width)
        args = case_args(c, cuda, k)
        before = merge_topk.launches
        got = _merge_wave(*args)
        assert merge_topk.launches == before + 1, (name, k)
        _same_merge(got, merge_wave_ref(*args), (name, n_q, k))
        _same_merge(got, merge_wave_ref(*case_args(c, "cpu", k)),
                    (name, n_q, k, "cpu"))


@pytest.mark.gpu
def test_merge_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.kernels.merge_topk.ops import merge_topk
    from repro_torch.tools.merge_cases import case_args, merge_case
    ts, ti, sc, th, ids, k = case_args(merge_case("random", 8, 10), cuda, 10)
    with pytest.raises(TypeError, match="scores"):
        merge_topk(ts, ti, sc.double(), th, ids, k)
    with pytest.raises(TypeError, match="ids_flat"):
        merge_topk(ts, ti, sc, th, ids.long(), k)
    with pytest.raises(ValueError, match="CUDA"):
        merge_topk(ts, ti, sc, th, ids.cpu(), k)
    with pytest.raises(ValueError, match="contiguous"):
        merge_topk(ts, ti, sc.transpose(1, 2), th, ids, k)
    with pytest.raises(ValueError, match="contiguous"):
        merge_topk(ts.t().contiguous().t(), ti, sc, th, ids, k)
    with pytest.raises(ValueError, match="theta"):
        merge_topk(ts, ti, sc, th.cpu(), ids, k)
    with pytest.raises(ValueError, match="at least one"):
        merge_topk(ts[:, :0], ti[:, :0], sc, th, ids, 0)


@pytest.mark.gpu
def test_walks_on_card_count_kernel_merges(cuda):
    """On the card every wave of the batched walk merges in one launch of
    the kernel, and every walked superblock of the two-level walk, at k =
    10 and at k = 200, with the answers of the on-card plain path."""
    from repro_torch.kernels.merge_topk.ops import merge_topk
    index, queries = _card_world(cuda)
    for k in (10, 200):
        for two_level in (False, True):
            cfg = SearchConfig(k=k, mu=0.8, eta=1.0, engine="batched",
                               block_q=4, block_d=8, bounds_impl="gemm",
                               superblocks=two_level)
            stats: dict = {}
            before = merge_topk.launches
            got = retrieve(index, queries, cfg, device=cuda, stats=stats)
            merges = merge_topk.launches - before
            if two_level:
                assert 1 <= merges <= stats["waves"], (k, two_level)
            else:
                assert merges == stats["waves"] >= 1, (k, two_level)
            with swapped_wrappers(plain_versions):
                want = retrieve(index, queries, cfg, device=cuda)
            _assert_fields(got, want, (k, two_level))


@pytest.mark.gpu
def test_card_retrieval_equals_cpu_path(cuda):
    """The golden world, built by the port on both devices: on the card
    (all four kernels) every TopK field equals the CPU plain path — ids
    and counters exactly, so every admission bit agrees — for each slice
    config and both bound impls."""
    spec = CorpusSpec(n_docs=600, vocab=256, n_topics=8, doc_terms=20,
                      t_pad=24, query_terms=8, q_pad=12, seed=777)
    docs, topic = make_corpus(spec)
    queries, _ = make_queries(spec, 6, topic, seed=779)
    kw = dict(m=12, n_seg=4, d_pad=64, seed=778)
    on_cpu = build_index(docs, topic % 12, device="cpu", **kw)
    on_card = build_index(docs, topic % 12, device=cuda, **kw)
    before = launch_counts()
    for conf in GOLDEN_CONFIGS:
        for impl in ("gather", "gemm"):
            cfg = SearchConfig(k=10, bounds_impl=impl, **conf)
            want = retrieve(on_cpu, queries, cfg, device="cpu")
            got = retrieve(on_card, queries, cfg, device=cuda)
            for f in TOPK_FIELDS:
                w, g = getattr(want, f), getattr(got, f).cpu()
                if f == "scores":
                    torch.testing.assert_close(g, w, rtol=RTOL, atol=1e-6)
                else:
                    assert torch.equal(g, w), (conf, impl, f)
    after = launch_counts()
    assert all(after[k] > before[k] for k in MAIN_PATH)


def _assert_fields(got, want, what, exact=False):
    for f in TOPK_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if f == "scores" and not exact:
            torch.testing.assert_close(g, w, rtol=RTOL, atol=1e-6)
        else:
            assert torch.equal(g, w), (what, f)


@pytest.mark.gpu
def test_superblock_walk_on_card(cuda):
    """The two-level walk on the card (K1 at level 0 and for each walked
    superblock's members, the planner and K2 a walked wave) against the
    same walk with every kernel swapped for its plain version on the
    card: ids and counters exactly, scores to rtol 1e-5."""
    index, queries = _card_world(cuda)
    before = launch_counts()
    for conf in (dict(mu=0.8, eta=1.0, method="asc"),
                 dict(mu=1.0, eta=1.0, method="anytime", cluster_budget=4),
                 dict(mu=0.6, eta=0.8, method="asc", block_d=None)):
        cfg = SearchConfig(**{**dict(k=10, engine="batched", block_q=4,
                                     block_d=8, bounds_impl="gemm",
                                     superblocks=True), **conf})
        got = retrieve(index, queries, cfg, device=cuda)
        with swapped_wrappers(plain_versions):
            want = retrieve(index, queries, cfg, device=cuda)
        _assert_fields(got, want, conf)
    after = launch_counts()
    assert all(after[k] > before[k] for k in ("segment_bound_gemm",
                                              "plan_wave", "score_queue"))


@pytest.mark.gpu
def test_pipelined_engine_on_card(cuda):
    """The pipelined engine on the card (planner stream, executor stream)
    equals the card's batched engine bit for bit, wave summaries included,
    at each fuse width, and the on-card plain path field for field."""
    from repro_torch.core.plan import wave_summaries
    index, queries = _card_world(cuda)
    base = SearchConfig(k=10, mu=0.8, eta=1.0, engine="batched", block_q=4,
                        block_d=8, group_size=2, bounds_impl="gemm")
    ref, (plans, executed) = retrieve_with_plans(index, queries, base,
                                                 device=cuda)
    for fuse in (1, 2, 4):
        cfg = dataclasses.replace(base, engine="pipelined", fuse_waves=fuse)
        before = launch_counts()
        got, info = retrieve_pipelined(index, queries, cfg, device=cuda,
                                       with_info=True)
        after = launch_counts()
        _assert_fields(got, ref, fuse, exact=True)
        assert info["summaries"] == wave_summaries(plans, executed)
        assert all(after[k] > before[k] for k in (
            "segment_bound_gemm", "plan_wave", "score_queue"))
        with swapped_wrappers(plain_versions):
            plain = retrieve_pipelined(index, queries, cfg, device=cuda)
        _assert_fields(got, plain, fuse)


def _churned_golden(device):
    """The golden world's churned writer (the fixture's stream) and the
    six golden queries."""
    from repro_torch.lifecycle import MutableIndex
    from repro_torch.tools.golden_world import (WRITER_SEED, apply_op,
                                                golden_churn_ops,
                                                golden_world)
    index, queries = golden_world(device)
    mi = MutableIndex(index, seed=WRITER_SEED)
    for op in golden_churn_ops():
        apply_op(mi, op)
    return mi, queries


CHURNED_CONFIGS = [
    dict(mu=1.0, eta=1.0, method="asc", engine="batched", block_q=4,
         block_d=8),
    dict(mu=0.8, eta=1.0, method="asc", engine="batched", block_q=4,
         block_d=8),
    dict(mu=1.0, eta=1.0, method="asc", engine="batched", superblocks=True,
         block_q=4, block_d=8),
    dict(mu=0.8, eta=1.0, method="asc", engine="per_query"),
]


@pytest.mark.gpu
def test_churned_golden_on_card_equals_cpu_path(cuda):
    """The churned golden world (tombstones, a dirty unsorted tail, a
    compacted layout) published to the card: every TopK field equals the
    CPU path's on the CPU snapshot of the same writer, and all four
    kernels ran."""
    from repro_torch.core.search import brute_force_topk
    mi, queries = _churned_golden("cpu")
    assert mi.unsorted_tail_fraction() > 0 and mi.n_deletes > 0
    on_cpu, on_card = mi.snapshot("cpu"), mi.snapshot(cuda)
    before = launch_counts()
    for conf in CHURNED_CONFIGS:
        cfg = SearchConfig(k=10, bounds_impl="gemm", **conf)
        want = retrieve(on_cpu, queries, cfg, device="cpu")
        got = retrieve(on_card, queries, cfg, device=cuda)
        _assert_fields(got, want.__class__(
            *(getattr(want, f).to(cuda) for f in TOPK_FIELDS)), conf)
    bf = brute_force_topk(on_card, queries, 10, device=cuda)
    assert torch.equal(bf.doc_ids.cpu(), brute_force_topk(
        on_cpu, queries, 10, device="cpu").doc_ids)
    after = launch_counts()
    assert all(after[k] > before[k] for k in MAIN_PATH)


@pytest.mark.gpu
def test_card_snapshot_is_a_complete_copy(cuda):
    """A snapshot on the card is complete when it returns and owns its
    memory: later inserts, deletes and a requantizing compaction of the
    writer never reach it."""
    from repro_torch.core.types import INDEX_FIELDS
    mi, _ = _churned_golden("cpu")
    snap = mi.snapshot(cuda)
    host = mi._host_index()
    frozen = {f: torch.from_numpy(np.array(getattr(host, f)))
              for f in INDEX_FIELDS}
    for d in mi.live_ids()[:30]:
        mi.delete(int(d))
    for i in range(30):
        mi.insert([i, i + 7], [0.5, 40.0])
    mi.compact(requantize=True)
    for f in INDEX_FIELDS:
        t = getattr(snap, f)
        assert t.device.type == "cuda", f
        assert torch.equal(t.cpu(), frozen[f]), f


@pytest.mark.gpu
def test_engine_over_publisher_serves_epochs_on_card(cuda):
    """A writer publishing to the card and an engine over its publisher:
    each of two epochs (the second after churn) is served through the
    kernels and equals the on-card plain path on the same epoch."""
    from repro_torch.lifecycle import IndexWriter
    from repro_torch.serving.engine import RetrievalEngine
    from repro_torch.tools.golden_world import (WRITER_SEED, apply_op,
                                                golden_churn_ops,
                                                golden_world)
    index, queries = golden_world(cuda)
    writer = IndexWriter(index, seed=WRITER_SEED, device=cuda)
    cfg = SearchConfig(k=10, mu=0.8, eta=1.0, engine="batched", block_q=4,
                       block_d=8, bounds_impl="gemm")
    eng = RetrievalEngine(writer.publisher, cfg, device=cuda)
    ops = golden_churn_ops()
    for epoch, (lo, hi) in enumerate([(0, 0), (0, len(ops))]):
        for op in ops[lo:hi]:
            apply_op(writer, op)
        if hi:
            writer.commit()
        got = eng.search(queries)
        assert eng.last_epoch == epoch
        with swapped_wrappers(plain_versions):
            want = retrieve(writer.publisher.current.index, queries, cfg,
                            device=cuda)
        _assert_fields(got, want, epoch)
    assert writer.publisher.reader_counts() == {}


@pytest.mark.gpu
def test_frontend_pump_thread_on_card(cuda):
    """The streaming front-end served through ``start()``'s pump thread,
    which launches the kernels from a thread of its own: every served row
    equals its dispatch, every dispatch equals a direct ``engine.search``
    of the same batch on the caller's thread, and buckets below 4 (K4)
    and of 4 (K1, the planner, K2) both ran."""
    from repro_torch.serving.engine import RetrievalEngine
    from repro_torch.serving.frontend import (FrontendConfig, ServedResult,
                                              StreamingFrontend, query_rows)
    from repro_torch.tools.golden_world import GOLDEN_SPEC, golden_world
    index, _ = golden_world(cuda)
    _, topic = make_corpus(GOLDEN_SPEC)
    queries, _ = make_queries(GOLDEN_SPEC, 19, topic, seed=4242)
    cfg = SearchConfig(k=10, mu=0.8, eta=1.0, block_q=4, block_d=8,
                       bounds_impl="gemm")
    eng = RetrievalEngine(index, cfg, device=cuda)
    rows = list(query_rows(queries))
    assert len({r.tids.numpy().tobytes() for r in rows}) == len(rows)
    fe = StreamingFrontend(eng, FrontendConfig(
        max_batch=4, max_queue=64, default_deadline_ms=1e4,
        max_linger_ms=2.0))
    fe.warmup(rows[0])
    dispatches = []
    search = eng.search

    def recorder(qb, mu_eta=None, budget_frac=None):
        out = search(qb, mu_eta=mu_eta, budget_frac=budget_frac)
        dispatches.append((qb, mu_eta, budget_frac, out))
        return out
    eng.search = recorder
    before = launch_counts()
    fe.start()
    futs = [fe.submit(rows[0])]
    assert isinstance(futs[0].result(timeout=60), ServedResult)  # bucket 1
    futs += [fe.submit(r) for r in rows[1:]]
    outs = [f.result(timeout=60) for f in futs]
    fe.shutdown(drain_deadline_ms=1e4)
    after = launch_counts()
    eng.search = search
    assert fe._thread is None and all(f.done() for f in futs)
    assert fe.conservation()["balanced"]
    assert all(isinstance(o, ServedResult) for o in outs)
    assert all(after[k] > before[k] for k in MAIN_PATH)
    assert min(qb.n_queries for qb, *_ in dispatches) < 4
    assert max(qb.n_queries for qb, *_ in dispatches) == 4
    for qb, mu_eta, frac, out in dispatches:
        again = search(qb, mu_eta=mu_eta, budget_frac=frac)
        _assert_fields(again, out, qb.n_queries)
    # each served row is a row of its dispatch (the queries are distinct)
    served = {}
    for qb, _, _, out in dispatches:
        for i in range(qb.n_queries):
            served.setdefault(qb.tids[i].numpy().tobytes(),
                              (out.doc_ids[i].cpu(), out.scores[i].cpu()))
    for r, o in zip(rows, outs):
        ids, scores = served[r.tids[0].numpy().tobytes()]
        assert torch.equal(o.doc_ids, ids) and torch.equal(o.scores, scores)


@pytest.mark.gpu
def test_balanced_assign_on_card_equals_cpu(cuda):
    """``balanced_assign`` on the card against the CPU port: the rounds
    exactly, given the same distances (a tight capacity, many spills); and
    the whole function on every row whose two nearest distances differ by
    more than fp32 rounding, where no cluster fills."""
    from repro_torch.core import clustering as tc
    g = torch.Generator().manual_seed(11)
    x = torch.randn((4096, 48), generator=g)
    centers = torch.randn((64, 48), generator=g)
    d2 = tc.sq_distances(x.to(cuda), centers.to(cuda))
    tight = tc._balanced_rounds(d2, capacity=70)
    assert torch.equal(tight.cpu(), tc._balanced_rounds(d2.cpu(), 70))
    assert int(torch.bincount(tight, minlength=64).max()) <= 70
    got = tc.balanced_assign(x.to(cuda), centers.to(cuda), 4096).cpu()
    want = tc.balanced_assign(x, centers, 4096)
    near = torch.topk(tc.sq_distances(x, centers), 2, largest=False).values
    tie = (near[:, 1] - near[:, 0]) <= 1e-5 * near[:, 1].abs().clamp(min=1)
    assert torch.equal(got[~tie], want[~tie])


def test_k2_phase_cuts_find_their_loops():
    """tools/k2_phases.py times K2 with loops cut out of a copy of its
    source: each cut must still match exactly one loop."""
    from repro_torch.device import CSRC
    from repro_torch.tools.k2_phases import BUILDS, CUTS
    src = (CSRC / "score_queue.cu").read_text()
    for name, (old, new) in CUTS.items():
        assert src.count(old) == 1, name
    assert all(c in CUTS for cuts in BUILDS.values() for c in cuts)
