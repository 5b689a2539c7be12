"""Index-build parity for the PyTorch port: corpus, queries, segmentation
and the packed ClusterIndex must equal the JAX package's bit for bit.

The corpus, segmentation and packing are numpy on both sides, so the same
seeds give the same arrays; clustering is not (it uses the JAX PRNG), so
the reference's ``assign`` array feeds both builds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from conftest import SPEC
from repro.core import index as jindex
from repro.core import segmentation as jseg
from repro.data import synthetic as jsyn
from repro_torch.convert import index_from_arrays, queries_from_arrays
from repro_torch.core import index as tindex
from repro_torch.core import segmentation as tseg
from repro_torch.core.types import INDEX_FIELDS
from repro_torch.data import synthetic as tsyn

# the golden world of tests/test_golden_regression.py
GOLDEN_SPEC = jsyn.CorpusSpec(n_docs=600, vocab=256, n_topics=8, doc_terms=20,
                              t_pad=24, query_terms=8, q_pad=12, seed=777)
_DTYPES = {np.dtype(np.uint16): torch.uint16, np.dtype(np.uint8): torch.uint8,
           np.dtype(np.int32): torch.int32, np.dtype(bool): torch.bool,
           np.dtype(np.float32): torch.float32}


def _tspec(spec):
    return tsyn.CorpusSpec(**dataclasses.asdict(spec))


def assert_index_equal(jidx, tidx):
    """Every ClusterIndex field: same dtype, same shape, same bits."""
    assert (tidx.vocab, tidx.n_seg) == (jidx.vocab, jidx.n_seg)
    for f in INDEX_FIELDS:
        want = np.asarray(getattr(jidx, f))
        got = getattr(tidx, f)
        assert got.dtype == _DTYPES[want.dtype], f
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)


@pytest.mark.parametrize("spec,n_q,q_seed", [(GOLDEN_SPEC, 6, 779),
                                             (SPEC, 16, 3)])
def test_corpus_and_queries_bit_exact(spec, n_q, q_seed):
    jdocs, jtopic = jsyn.make_corpus(spec)
    tdocs, ttopic = tsyn.make_corpus(_tspec(spec))
    np.testing.assert_array_equal(ttopic, jtopic)
    for f in ("tids", "tw", "mask"):
        np.testing.assert_array_equal(getattr(tdocs, f).numpy(),
                                      np.asarray(getattr(jdocs, f)), err_msg=f)
    jq, jqt = jsyn.make_queries(spec, n_q, jtopic, seed=q_seed)
    tq, tqt = tsyn.make_queries(_tspec(spec), n_q, ttopic, seed=q_seed)
    np.testing.assert_array_equal(tqt, jqt)
    for f in ("tids", "tw", "mask"):
        np.testing.assert_array_equal(getattr(tq, f).numpy(),
                                      np.asarray(getattr(jq, f)), err_msg=f)
    np.testing.assert_array_equal(tq.dense_map().numpy(),
                                  np.asarray(jq.dense_map()))
    np.testing.assert_array_equal(tdocs.densify().numpy(),
                                  np.asarray(jdocs.densify()))


@pytest.mark.parametrize("sort_segments", [True, False])
def test_golden_world_index_bit_exact(sort_segments):
    jdocs, jtopic = jsyn.make_corpus(GOLDEN_SPEC)
    tdocs, ttopic = tsyn.make_corpus(_tspec(GOLDEN_SPEC))
    kw = dict(m=12, n_seg=4, d_pad=64, seed=778, sort_segments=sort_segments)
    jidx = jindex.build_index(jdocs, jtopic % 12, **kw)
    tidx = tindex.build_index(tdocs, ttopic % 12, device="cpu", **kw)
    assert_index_equal(jidx, tidx)
    # the views
    np.testing.assert_array_equal(tidx.seg_max.numpy(),
                                  np.asarray(jidx.seg_max))
    np.testing.assert_array_equal(tidx.seg_max_collapsed.numpy(),
                                  np.asarray(jidx.seg_max_collapsed))
    assert (tidx.m, tidx.d_pad, tidx.t_pad, tidx.n_super, tidx.super_cap) \
        == (jidx.m, jidx.d_pad, jidx.t_pad, jidx.n_super, jidx.super_cap)
    assert tidx.nbytes() == jidx.nbytes()
    assert int(tidx.n_docs) == int(jidx.n_docs)


@pytest.mark.parametrize("fixture,n_seg", [("index", 4), ("index_1seg", 1)])
def test_kmeans_assigned_index_bit_exact(request, corpus, assignment,
                                         fixture, n_seg):
    """conftest's SPEC index (1500 docs, V=512, m=24) from the reference's
    k-means assignment."""
    jidx = request.getfixturevalue(fixture)
    tdocs, _ = tsyn.make_corpus(_tspec(SPEC))
    tidx = tindex.build_index(tdocs, assignment, m=24, n_seg=n_seg, seed=0,
                              device="cpu")
    assert_index_equal(jidx, tidx)


def test_converted_index_equals_port_build():
    jdocs, jtopic = jsyn.make_corpus(GOLDEN_SPEC)
    jidx = jindex.build_index(jdocs, jtopic % 12, m=12, n_seg=4, d_pad=64,
                              seed=778)
    conv = index_from_arrays({f: np.asarray(getattr(jidx, f))
                              for f in INDEX_FIELDS},
                             vocab=jidx.vocab, n_seg=jidx.n_seg, device="cpu")
    assert_index_equal(jidx, conv)
    jq, _ = jsyn.make_queries(GOLDEN_SPEC, 6, jtopic, seed=779)
    tq = queries_from_arrays(np.asarray(jq.tids), np.asarray(jq.tw),
                             np.asarray(jq.mask), vocab=jq.vocab,
                             device="cpu")
    np.testing.assert_array_equal(tq.dense_map().numpy(),
                                  np.asarray(jq.dense_map()))
    with pytest.raises(KeyError, match="missing index fields"):
        index_from_arrays({"doc_tids": np.zeros((1, 1, 1), np.uint16)},
                          vocab=4, n_seg=1, device="cpu")


def test_int32_term_ids_above_uint16_vocab():
    """vocab >= 2^16 stores int32 term ids on both sides."""
    spec = jsyn.CorpusSpec(n_docs=40, vocab=70000, n_topics=2, doc_terms=6,
                           t_pad=10, seed=5)
    jdocs, jtopic = jsyn.make_corpus(spec)
    tdocs, ttopic = tsyn.make_corpus(_tspec(spec))
    jidx = jindex.build_index(jdocs, jtopic, m=2, n_seg=2, seed=6)
    tidx = tindex.build_index(tdocs, ttopic, m=2, n_seg=2, seed=6,
                              device="cpu")
    assert tidx.doc_tids.dtype == torch.int32
    assert_index_equal(jidx, tidx)


def test_segmentation_and_rebalance_match():
    for n, s, seed in [(1, 4, 0), (17, 4, 1), (64, 8, 2)]:
        np.testing.assert_array_equal(
            tseg.random_uniform_segments(np.random.default_rng(seed), n, s),
            jseg.random_uniform_segments(np.random.default_rng(seed), n, s))
    dense = np.random.default_rng(3).random((40, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        tseg.kmeans_sub_segments(dense, 4, rng=np.random.default_rng(4)),
        jseg.kmeans_sub_segments(dense, 4, rng=np.random.default_rng(4)))
    assign = np.random.default_rng(5).integers(0, 3, 50)
    assign[:30] = 0                              # overflow cluster 0
    np.testing.assert_array_equal(tindex.capacity_rebalance(assign, 4, 16),
                                  jindex.capacity_rebalance(assign, 4, 16))
    st = np.random.default_rng(6).integers(0, 256, (9, 3, 20)).astype(
        np.uint8)
    sup = tindex.group_superblocks(st[:, 2])
    np.testing.assert_array_equal(sup, jindex.group_superblocks(st[:, 2]))
    for a, b in zip(tindex.superblock_tables(sup, st),
                    jindex.superblock_tables(sup, st)):
        np.testing.assert_array_equal(a, b)


def test_build_index_places_on_requested_device():
    tdocs, ttopic = tsyn.make_corpus(_tspec(GOLDEN_SPEC))
    tidx = tindex.build_index(tdocs, ttopic % 12, m=12, n_seg=4, d_pad=64,
                              seed=778, device="cpu")
    assert all(getattr(tidx, f).device.type == "cpu" for f in INDEX_FIELDS)
    assert tidx.scale.shape == () and tidx.scale.dtype == torch.float32
    assert tidx.doc_tids.dtype == torch.uint16
