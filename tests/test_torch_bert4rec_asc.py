"""The catalog example (``repro_torch.examples.bert4rec_asc_retrieval``):
BERT4Rec's items served through ASC, held against the reference's
``examples/bert4rec_asc_retrieval.py`` on the CPU.

The reference's example runs once (module fixture) with its functions
wrapped to record what flows through them: the initial parameters, the
users' hidden states, the sparse docs and the assignment handed to
``build_index``, the index, the queries, and each ASC and brute-force
result. Then, stage by stage:

  * the port's ``encode_users`` on the carried weights and the
    reference's batch gives its hidden states (rtol 1e-5, atol 1e-6) and
    the same sparse queries (weights to 1e-5 on the same terms);
  * the port's sparse docs of the reference's item embeddings equal the
    reference's bit for bit, and ``build_index`` on the reference's docs
    and assignment gives its index arrays bit for bit;
  * on the reference's index and query arrays, ``asc_retrieve`` at mu 1.0
    and 0.9 and ``brute_force_topk`` give all 11 ``TopK`` fields: ids and
    counters exactly, scores to 1e-4 (the golden contract);
  * ``serve`` on those arrays prints the reference's recall lines to the
    digit, and the catalog line matches.

The port's own run (its own draws) prints the reference's lines, numbers
aside. The ``gpu`` test serves the smoke catalog on the card. This file
collects without JAX: the reference is imported inside the fixture.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.convert import (index_from_arrays, queries_from_arrays,
                                 recsys_params_from_arrays)
from repro_torch.core.index import build_index
from repro_torch.core.search import asc_retrieve, brute_force_topk
from repro_torch.core.types import INDEX_FIELDS, TOPK_FIELDS, SparseDocs
from repro_torch.examples import bert4rec_asc_retrieval as t_ex
from repro_torch.models.sparse_encoder import to_sparse_docs

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref():
    """The reference example's run: its printed lines and what its stages
    handed each other, as numpy."""
    import jax

    from repro.models import recsys as j_rs
    spec = importlib.util.spec_from_file_location(
        "ref_bert4rec_asc", ROOT / "examples" / "bert4rec_asc_retrieval.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    seen: dict = {"asc": {}}

    def record(fn, keep):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            keep(out, *args, **kw)
            return out
        return wrapped

    def keep_init(out, key, cfg):
        seen["params"] = jax.tree_util.tree_map(np.asarray, out)

    def keep_encode(out, params, batch, cfg):
        seen["batch"] = {k: np.asarray(v) for k, v in batch.items()}
        seen["hidden"] = np.asarray(out)[:, -1, :]

    def keep_build(out, docs, assign, **kw):
        seen.update(docs=docs, assign=np.asarray(assign), index=out,
                    build_kw=kw)

    def keep_asc(out, index, queries, **kw):
        seen["queries"] = queries
        seen["asc"][kw["mu"]] = out

    def keep_bf(out, index, queries, k):
        seen["oracle"] = out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_rs, "bert4rec_init",
                   record(j_rs.bert4rec_init, keep_init))
        mp.setattr(j_rs, "bert4rec_encode",
                   record(j_rs.bert4rec_encode, keep_encode))
        mp.setattr(ex, "build_index", record(ex.build_index,
                                             keep_build))
        mp.setattr(ex, "asc_retrieve", record(ex.asc_retrieve,
                                              keep_asc))
        mp.setattr(ex, "brute_force_topk", record(ex.brute_force_topk,
                                                  keep_bf))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            ex.main()
    seen["lines"] = out.getvalue().splitlines()
    seen["cfg"] = get_arch("bert4rec").smoke_config()
    return seen


def _ref_index(ref):
    idx = ref["index"]
    return index_from_arrays({f: np.asarray(getattr(idx, f))
                              for f in INDEX_FIELDS},
                             vocab=idx.vocab, n_seg=idx.n_seg, device="cpu")


def _ref_queries(ref):
    q = ref["queries"]
    return queries_from_arrays(np.asarray(q.tids), np.asarray(q.tw),
                               np.asarray(q.mask), vocab=q.vocab,
                               device="cpu")


def _dense(tids, tw, vocab: int) -> np.ndarray:
    out = np.zeros((tids.shape[0], vocab), np.float32)
    np.put_along_axis(out, np.asarray(tids, np.int64), np.asarray(tw), 1)
    return out


def test_users_encode_as_reference(ref):
    """encode_users on the carried weights and the reference's batch: the
    last hidden states, and sparse queries over the same terms with the
    same weights."""
    cfg = ref["cfg"]
    model = recsys_params_from_arrays(ref["params"], "bert4rec", cfg,
                                      device="cpu")
    batch = {k: torch.from_numpy(v.copy()) for k, v in ref["batch"].items()}
    hidden, queries = t_ex.encode_users(model, batch)
    np.testing.assert_allclose(hidden.numpy(), ref["hidden"], rtol=1e-5,
                               atol=1e-6)
    want = ref["queries"]
    assert queries.vocab == want.vocab == 2 * cfg.embed_dim
    assert tuple(queries.tids.shape) == want.tids.shape
    np.testing.assert_array_equal(queries.mask.numpy(),
                                  np.asarray(want.mask))
    np.testing.assert_allclose(
        _dense(queries.tids.numpy(), queries.tw.numpy(), queries.vocab),
        _dense(np.asarray(want.tids), np.asarray(want.tw), want.vocab),
        rtol=1e-5, atol=1e-6)


def test_catalog_docs_and_index_equal_reference(ref):
    """The port's sparse docs of the reference's item embeddings are the
    reference's bit for bit; build_index on the reference's docs and
    assignment gives its index, every array bit for bit."""
    cfg = ref["cfg"]
    item_emb = torch.from_numpy(np.array(
        ref["params"]["item_emb"][:cfg.n_items]))
    vocab = 2 * cfg.embed_dim
    docs = to_sparse_docs(t_ex.sparse_rows(item_emb), t_pad=vocab // 2,
                          vocab=vocab)
    for f in ("tids", "tw", "mask"):
        np.testing.assert_array_equal(getattr(docs, f).numpy(),
                                      np.asarray(getattr(ref["docs"], f)),
                                      err_msg=f)
    want = ref["index"]
    got = build_index(SparseDocs(
        tids=torch.from_numpy(np.array(ref["docs"].tids)),
        tw=torch.from_numpy(np.array(ref["docs"].tw)),
        mask=torch.from_numpy(np.array(ref["docs"].mask)), vocab=vocab),
        ref["assign"], device="cpu", **ref["build_kw"])
    assert ref["build_kw"]["d_pad"] == t_ex.default_d_pad(cfg.n_items, 16)
    for f in INDEX_FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def _assert_topk(got, want, what: str) -> None:
    for f in TOPK_FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.shape == w.shape and g.dtype == w.dtype, f"{what}: {f}"
        if f == "scores":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{what}: {f}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {f}")


@pytest.mark.parametrize("mu", [1.0, 0.9])
def test_asc_on_reference_arrays_equals_reference(ref, mu):
    """On the reference's index and query arrays: asc_retrieve at mu (eta
    1.0; the gemm bounds) and brute force, all 11 TopK fields."""
    index, queries = _ref_index(ref), _ref_queries(ref)
    got = asc_retrieve(index, queries, k=10, mu=mu, eta=1.0,
                       bounds_impl="gemm", device="cpu")
    _assert_topk(got, ref["asc"][mu], f"asc mu={mu}")
    _assert_topk(brute_force_topk(index, queries, 10, device="cpu"),
                 ref["oracle"], "brute force")


def test_serve_prints_the_reference_recalls(ref):
    """serve on the reference's index, queries, hidden states and item
    embeddings prints the reference's two recall lines to the digit; the
    catalog line of the port's index equals the reference's."""
    cfg = ref["cfg"]
    index = _ref_index(ref)
    item_emb = torch.from_numpy(np.array(
        ref["params"]["item_emb"][:cfg.n_items]))
    lines: list[str] = []
    out = t_ex.serve(index, _ref_queries(ref),
                     torch.from_numpy(ref["hidden"].copy()), item_emb, "cpu",
                     log=lines.append)
    want = [x for x in ref["lines"] if x.startswith("ASC mu=")]
    assert lines == want and len(lines) == 2
    assert ref["lines"][0] == (f"catalog index: {cfg.n_items} items, 16 "
                               f"clusters, {index.nbytes() / 2**20:.2f} MiB")
    assert out["recall"][1.0][0] == 1.0      # rank-safe: exact on the index


def _shape(line: str) -> str:
    return re.sub(r"\d+(\.\d+)?", "N", line)


def test_example_prints_the_reference_lines(ref, capsys, monkeypatch):
    """``--device cpu`` with no other flag: the reference's lines, numbers
    aside (its own draws); rank-safe ASC keeps the whole index-exact top
    10. Without a card the default ``cuda`` exits with an error."""
    t_ex.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert [_shape(x) for x in got] == [_shape(x) for x in ref["lines"]]
    assert "recall@10 vs index-exact=1.00" in got[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        t_ex.main([])


@pytest.mark.gpu
def test_catalog_on_card():
    """The smoke catalog built and served on the card: the kernels launch
    (K1, the planner and K2 on 8 users; K4 on 2), rank-safe ASC equals
    brute force on the card, and the card's results equal the CPU's on
    the same index (scores rtol 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.types import QueryBatch
    from repro_torch.data import pipeline as t_pl
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import recsys as t_rs
    cfg = get_arch("bert4rec").smoke_config()
    model = t_rs.bert4rec_init(torch.Generator().manual_seed(0), cfg,
                               device="cuda")
    index = t_ex.build_catalog_index(cfg, model, 16,
                                     t_ex.default_d_pad(cfg.n_items, 16),
                                     torch.Generator().manual_seed(1),
                                     "cuda")
    hidden, queries = t_ex.encode_users(model, t_pl.bert4rec_batch(cfg, 8,
                                                                   0))
    reset_launch_counts()
    out = t_ex.serve(index, queries, hidden, t_ex.item_embeddings(model),
                     "cuda", log=lambda s: None)
    two = QueryBatch(tids=queries.tids[:2], tw=queries.tw[:2],
                     mask=queries.mask[:2], vocab=queries.vocab)
    asc_retrieve(index, two, k=10, mu=0.9, bounds_impl="gemm",
                 device="cuda")
    counts = launch_counts()
    for name in ("segment_bound_gemm", "plan_wave", "score_queue",
                 "score_clusters"):
        assert counts[name] > 0, name
    safe, oracle = out["asc"][1.0], out["oracle"]
    np.testing.assert_allclose(safe.scores.cpu().numpy(),
                               oracle.scores.cpu().numpy(), rtol=1e-5)
    host = index_from_arrays({f: getattr(index, f).cpu().numpy()
                              for f in INDEX_FIELDS}, vocab=index.vocab,
                             n_seg=index.n_seg, device="cpu")
    on_cpu = asc_retrieve(host, queries.to("cpu"), k=10, mu=0.9,
                          bounds_impl="gemm", device="cpu")
    np.testing.assert_allclose(out["asc"][0.9].scores.cpu().numpy(),
                               on_cpu.scores.numpy(), rtol=1e-5)
