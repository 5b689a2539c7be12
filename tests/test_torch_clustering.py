"""The port's index-build tooling (repro_torch.core.clustering,
quantization, static_pruning) held against the JAX package.

  * quantization and ``static_prune`` on the golden world's documents,
    exactly (ties in weight keep slot order);
  * ``balanced_assign`` given the reference's centers equals the
    reference's assignment, at a loose and a tight capacity;
  * Lloyd's iterations from the reference's initial centers, and the
    projection from the reference's Rademacher matrix, within 1e-5;
  * the clustering invariants of tests/test_core.py on the port.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as jc
from repro.core import quantization as jq
from repro.core.static_pruning import static_prune as j_static_prune
from repro.core.types import SparseDocs as JSparseDocs
from repro.data.synthetic import CorpusSpec, make_corpus
from repro_torch.core import clustering as tc
from repro_torch.core import quantization as tq
from repro_torch.core.static_pruning import static_prune
from repro_torch.core.types import SparseDocs
from repro_torch.data.synthetic import make_corpus as t_make_corpus
from repro_torch.utils import rank_within_run

# tests/test_golden_regression.py's world
GOLDEN_SPEC = CorpusSpec(n_docs=600, vocab=256, n_topics=8, doc_terms=20,
                         t_pad=24, query_terms=8, q_pad=12, seed=777)
# tests/conftest.py's corpus
SPEC = CorpusSpec(n_docs=1500, vocab=512, n_topics=16, doc_terms=40,
                  t_pad=56, query_terms=12, q_pad=20, seed=0)

_C: dict = {}


def corpora(spec):
    """(reference docs, port docs, doc_topic) of one spec."""
    if spec not in _C:
        jd, topic = make_corpus(spec)
        td, _ = t_make_corpus(spec)
        _C[spec] = (jd, td, topic)
    return _C[spec]


def rep_of(spec, dim=64):
    """The reference's projection of a corpus, as a numpy array."""
    key = ("rep", spec, dim)
    if key not in _C:
        _C[key] = np.array(jc.dense_rep_projection(corpora(spec)[0],
                                                    dim=dim))
    return _C[key]


def with_ties(docs: JSparseDocs) -> JSparseDocs:
    """Weights rounded to one decimal: many equal weights in a document."""
    return JSparseDocs(tids=docs.tids, tw=jnp.round(docs.tw * 10) / 10,
                       mask=docs.mask, vocab=docs.vocab)


def port_docs(docs: JSparseDocs) -> SparseDocs:
    return SparseDocs(tids=torch.from_numpy(np.array(docs.tids)),
                      tw=torch.from_numpy(np.array(docs.tw)),
                      mask=torch.from_numpy(np.array(docs.mask)),
                      vocab=docs.vocab)


# ---------------------------------------------------------------------------
# quantization and static pruning
# ---------------------------------------------------------------------------

def test_quantization_matches_reference():
    jd, td, _ = corpora(GOLDEN_SPEC)
    j_scale = jq.weight_scale(jd.tw, jd.mask)
    scale = tq.weight_scale(td.tw, td.mask)
    assert float(scale) == float(j_scale)
    q = tq.quantize(td.tw, scale)
    assert q.dtype == torch.uint8
    np.testing.assert_array_equal(q.numpy(),
                                  np.asarray(jq.quantize(jd.tw, j_scale)))
    np.testing.assert_array_equal(
        tq.dequantize(q, scale).numpy(),
        np.asarray(jq.dequantize(jq.quantize(jd.tw, j_scale), j_scale)))
    # halves round to even, as jnp.round does
    halves = np.float32([0.5, 1.5, 2.5, 254.5, 300.0])
    np.testing.assert_array_equal(
        tq.quantize(torch.from_numpy(halves), 1.0).numpy(),
        np.asarray(jq.quantize(jnp.asarray(halves), 1.0)))


@pytest.mark.parametrize("keep_frac,floor_frac,ties",
                         [(0.6, 0.05, False), (0.3, 0.5, False),
                          (1.0, 0.05, False), (0.45, 0.2, True)])
def test_static_prune_matches_reference(keep_frac, floor_frac, ties):
    jd, _, _ = corpora(GOLDEN_SPEC)
    if ties:
        jd = with_ties(jd)
    want = j_static_prune(jd, keep_frac=keep_frac,
                          global_floor_frac=floor_frac)
    got = static_prune(port_docs(jd), keep_frac=keep_frac,
                       global_floor_frac=floor_frac)
    for f in ("tids", "tw", "mask"):
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.vocab == want.vocab
    if keep_frac < 1.0:
        assert int(got.mask.sum()) < int(port_docs(jd).mask.sum())
    with pytest.raises(ValueError, match="keep_frac"):
        static_prune(port_docs(jd), keep_frac=0.0)


# ---------------------------------------------------------------------------
# clustering against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [80, 63])
def test_balanced_assign_matches_reference(capacity):
    """Given the reference's centers, the same assignment: 80 leaves room
    everywhere but the largest clusters, 63 (1500 docs into 24 clusters)
    spills nearly every cluster."""
    rep = rep_of(SPEC)
    centers, _ = jc.lloyd_kmeans(jax.random.PRNGKey(0), jnp.asarray(rep),
                                 k=24, iters=6)
    want = np.asarray(jc.balanced_assign(jnp.asarray(rep), centers,
                                         capacity=capacity))
    got = tc.balanced_assign(torch.from_numpy(rep),
                             torch.from_numpy(np.asarray(centers)),
                             capacity=capacity)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.bincount(want, minlength=24).max() <= capacity


def test_balanced_rounds_stop_early_with_the_same_result():
    """A capacity below n/k leaves stragglers: they go round-robin, as the
    reference's k-round scan leaves them."""
    rep = rep_of(SPEC)[:200]
    centers = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (10, 64)))
    want = np.asarray(jc.balanced_assign(jnp.asarray(rep),
                                         jnp.asarray(centers), capacity=15))
    got = tc.balanced_assign(torch.from_numpy(rep),
                             torch.from_numpy(centers), capacity=15)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rank_within_matches_reference():
    """``balanced_assign``'s arrival ranks: the port's shared
    ``utils.rank_within_run`` against the reference's ``_rank_within``."""
    keys = np.sort(np.random.default_rng(5).integers(0, 9, 300))
    np.testing.assert_array_equal(
        rank_within_run(torch.from_numpy(keys)).numpy(),
        np.asarray(jc._rank_within(jnp.asarray(keys), 9)))


def test_lloyd_steps_match_reference():
    """The reference's random initial centers through the port's Lloyd
    iterations: centroids within 1e-5 and the same assignment."""
    rep = rep_of(SPEC)
    key = jax.random.PRNGKey(0)
    init = np.asarray(jnp.asarray(rep)[jax.random.choice(
        key, rep.shape[0], (24,), replace=False)])
    want_c, want_a = jc.lloyd_kmeans(key, jnp.asarray(rep), k=24, iters=6)
    got_c, got_a = tc._lloyd(torch.from_numpy(rep), torch.from_numpy(init),
                             iters=6)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(
        tc.sq_distances(torch.from_numpy(rep), got_c).numpy(),
        np.asarray(jc.sq_distances(jnp.asarray(rep), want_c)),
        rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("spec,dim", [(GOLDEN_SPEC, 96), (SPEC, 64)])
def test_dense_rep_projection_matches_reference(spec, dim):
    """The reference's Rademacher matrix through the port's bag sum."""
    jd, td, _ = corpora(spec)
    proj = jax.random.rademacher(jax.random.PRNGKey(0),
                                 (spec.vocab + 1, dim), jnp.float32)
    proj = np.asarray(proj.at[spec.vocab].set(0.0))
    got = tc._project(td, torch.from_numpy(proj))
    want = np.asarray(jc.dense_rep_projection(jd, dim=dim, seed=0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the port's own draw: signs, a zero padding row, the same scale
    mine = tc.rademacher(spec.vocab, dim, seed=0)
    assert set(np.unique(mine[:-1].numpy())) == {-1.0, 1.0}
    assert not mine[-1].any()
    out = tc.dense_rep_projection(td, dim=dim, device="cpu")
    assert out.shape == (spec.n_docs, dim) and bool(torch.isfinite(out).all())


def test_dense_rep_projection_chunks_the_bag_sum(monkeypatch):
    _, td, _ = corpora(GOLDEN_SPEC)
    whole = tc.dense_rep_projection(td, dim=32, seed=3, device="cpu")
    monkeypatch.setattr(tc, "PROJECTION_CHUNK", 128)
    np.testing.assert_array_equal(
        tc.dense_rep_projection(td, dim=32, seed=3, device="cpu").numpy(),
        whole.numpy())


@pytest.mark.parametrize("mode", ["max", "mean", "cls"])
def test_dense_rep_pooled_matches_reference(mode):
    tok = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (6, 12, 32)))
    mask = np.ones((6, 12), bool)
    mask[:, 8:] = False
    want = np.asarray(jc.dense_rep_pooled(jnp.asarray(tok),
                                          jnp.asarray(mask), mode))
    got = tc.dense_rep_pooled(torch.from_numpy(tok), torch.from_numpy(mask),
                              mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="pooling"):
        tc.dense_rep_pooled(torch.from_numpy(tok), torch.from_numpy(mask),
                            "sum")


# ---------------------------------------------------------------------------
# the invariants of tests/test_core.py, on the port
# ---------------------------------------------------------------------------

def test_lloyd_kmeans_reduces_inertia():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((500, 16), generator=g)
    centers0 = x[torch.randperm(500, generator=g)[:8]]
    inertia0 = float(tc.sq_distances(x, centers0).min(dim=1).values.sum())
    centers, assign = tc.lloyd_kmeans(g, x, k=8, iters=10)
    inertia = float(tc.sq_distances(x, centers).min(dim=1).values.sum())
    assert inertia <= inertia0
    assert assign.shape == (500,)


def test_kmeans_plus_plus_seeding():
    g = torch.Generator().manual_seed(1)
    x = torch.randn((300, 8), generator=g)
    centers, assign = tc.lloyd_kmeans(g, x, k=6, iters=5,
                                      seed_mode="kmeans++")
    assert centers.shape == (6, 8)
    assert int(assign.max()) < 6
    # every seed is a data point, and seeding is reproducible
    seeds = tc.kmeans_plus_plus_lite(torch.Generator().manual_seed(2), x, 6)
    assert all(bool((x == c).all(dim=1).any()) for c in seeds)
    torch.testing.assert_close(
        seeds, tc.kmeans_plus_plus_lite(torch.Generator().manual_seed(2),
                                        x, 6))


def test_lloyd_draws_are_reproducible():
    """One seed, one draw: the same centers from two generators of the
    same seed, and the same as no generator (seed 0)."""
    x = torch.randn((50, 4), generator=torch.Generator().manual_seed(9))
    a = tc.lloyd_kmeans(torch.Generator().manual_seed(0), x, k=5, iters=2)
    b = tc.lloyd_kmeans(None, x, k=5, iters=2)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    assert torch.equal(a[1], b[1])


def test_cluster_sums_over_chunks(monkeypatch):
    """Lloyd's centroid sums, taken over several row chunks, equal the
    scatter-add sums within fp32 rounding, and equal themselves bit for
    bit on a second call."""
    monkeypatch.setattr(tc, "_SUM_ROWS", 64)
    g = torch.Generator().manual_seed(4)
    x = torch.randn((300, 12), generator=g)
    assign = torch.randint(0, 7, (300,), generator=g)
    assign[assign == 5] = 6                  # cluster 5 stays empty
    got = tc._cluster_sums(x, assign, 7)
    want = torch.zeros((7, 12)).index_add_(0, assign, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert not got[5].any()
    assert torch.equal(got, tc._cluster_sums(x, assign, 7))


def test_balanced_assign_respects_capacity():
    x = torch.randn((200, 8), generator=torch.Generator().manual_seed(2))
    centers = torch.randn((10, 8), generator=torch.Generator().manual_seed(3))
    assign = tc.balanced_assign(x, centers, capacity=25)
    counts = np.bincount(assign.numpy(), minlength=10)
    assert (counts <= 25).all()
    assert counts.sum() == 200


def test_dense_rep_projection_preserves_geometry():
    """Random projection approximately preserves inner products, so
    topically-similar docs should be closer than cross-topic ones."""
    _, td, doc_topic = corpora(SPEC)
    rep = tc.dense_rep_projection(td, dim=128, device="cpu").numpy()
    rng = np.random.default_rng(0)
    same, cross = [], []
    for _ in range(400):
        i, j = rng.integers(0, td.n_docs, 2)
        d = float(np.sum((rep[i] - rep[j]) ** 2))
        (same if doc_topic[i] == doc_topic[j] else cross).append(d)
    assert np.mean(same) < np.mean(cross)


def test_dense_rep_pooled_modes():
    tok = torch.randn((6, 12, 32), generator=torch.Generator().manual_seed(4))
    mask = torch.ones((6, 12), dtype=torch.bool)
    mask[:, 8:] = False
    for mode in ("max", "mean", "cls"):
        out = tc.dense_rep_pooled(tok, mask, mode)
        assert out.shape == (6, 32)
        assert bool(torch.isfinite(out).all())
    mx = tc.dense_rep_pooled(tok, mask, "max")
    # masked positions must not contribute
    tok2 = tok.clone()
    tok2[:, 8:, :] = 1e9
    torch.testing.assert_close(tc.dense_rep_pooled(tok2, mask, "max"), mx)
