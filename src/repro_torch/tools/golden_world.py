"""The golden world of tests/test_golden_regression.py, built by the port
alone, and its churn stream.

:func:`golden_world` rebuilds the 600-doc base world with the port's
numpy builders (bit-identical to the JAX package's build from the same
seeds). :func:`golden_churn_ops` replays the fixture's seeded
insert/delete/compact stream (``_churned_world``) against a port
:class:`MutableIndex` and records it as concrete data, the form
tests/test_crash_recovery.py uses: ``["insert", tids, weights]``,
``["delete", doc_id]``, ``["compact"]``. Every op consumes one
``op_seq``, so ``ops[recovered.op_seq:]`` finishes a stream a crash cut.
The CPU tests, the ``gpu`` tests, the crash test's child process and
``chip_smoke.py`` share these, so none of them needs JAX.
"""

from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import CorpusSpec

GOLDEN_SPEC = CorpusSpec(n_docs=600, vocab=256, n_topics=8, doc_terms=20,
                         t_pad=24, query_terms=8, q_pad=12, seed=777)
#: the seed of the golden writer's MutableIndex and of its op draws
WRITER_SEED, OPS_SEED = 881, 882


def golden_world(device):
    """(index on ``device``, 6 queries) of the golden fixture."""
    from repro_torch.core.index import build_index
    from repro_torch.data.synthetic import make_corpus, make_queries
    docs, doc_topic = make_corpus(GOLDEN_SPEC)
    index = build_index(docs, doc_topic % 12, m=12, n_seg=4, d_pad=64,
                        seed=778, device=device)
    queries, _ = make_queries(GOLDEN_SPEC, 6, doc_topic, seed=779)
    return index, queries


def apply_op(mi, op) -> None:
    """Apply one concrete op to a MutableIndex (or an IndexWriter)."""
    kind = op[0]
    if kind == "insert":
        mi.insert(np.asarray(op[1], np.int64), np.asarray(op[2], np.float32))
    elif kind == "delete":
        mi.delete(int(op[1]))
    elif kind == "compact":
        getattr(mi, "mutable", mi).compact(*op[1:])
    else:
        raise ValueError(f"unknown op {kind!r}")


def golden_churn_ops() -> list:
    """The fixture's churn stream as concrete ops: two rounds of 40
    deletes and 30 inserts, one compaction, then 20 deletes and 25
    inserts, so the final state carries a dirty unsorted tail."""
    from repro_torch.lifecycle import MutableIndex
    index, _ = golden_world("cpu")
    mi = MutableIndex(index, seed=WRITER_SEED)
    rng = np.random.default_rng(OPS_SEED)
    ops: list = []

    def record(op):
        ops.append(op)
        apply_op(mi, op)

    def inserts(n):
        for _ in range(n):
            nnz = int(rng.integers(4, 12))
            t = rng.choice(GOLDEN_SPEC.vocab, nnz, replace=False)
            w = rng.lognormal(0.0, 0.5, nnz).astype(np.float32)
            record(["insert", t.tolist(), [float(x) for x in w]])

    def deletes(n):
        for d in rng.choice(mi.live_ids(), n, replace=False):
            record(["delete", int(d)])

    for _ in range(2):
        deletes(40)
        inserts(30)
    record(["compact"])
    deletes(20)
    inserts(25)
    return ops
