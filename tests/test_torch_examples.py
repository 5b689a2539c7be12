"""The root examples in the port (``repro_torch.examples.quickstart`` and
``repro_torch.examples.serve_retrieval``), held against
``examples/quickstart.py`` and ``examples/serve_retrieval.py`` on the CPU.

Each reference example runs once (a module fixture) with its functions
wrapped to record what flows through them: the assignment handed to
``build_index`` and the index, every ASC and brute-force result, every
batch its engines served with the budget each searched under. The corpus
and queries are numpy streams, the same bit for bit in both packages; the
k-means draws are not, so the port is fed the reference's assignment:

  * ``build_index`` on it gives the reference's index, every array bit
    for bit;
  * quickstart: on that index ``retrieve_all`` gives, at each (mu, eta)
    and for brute force, all 11 ``TopK`` fields (ids and counters
    exactly, scores to 1e-4: the golden contract) and prints the
    reference's lines to the digit;
  * serve_retrieval: each batch the reference's engines served, the
    unbudgeted ones and those under the adaptive budget, equals the
    port's ``retrieve`` at the same budget on all 11 fields.

Each port example run on its own (its own draws and timings) prints the
reference's lines with the numbers masked (quickstart: the decimals, its
counts must agree). This file collects without JAX: the reference is
imported inside the fixtures.
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

from repro_torch.convert import queries_from_arrays
from repro_torch.core.search import retrieve
from repro_torch.core.types import INDEX_FIELDS, TOPK_FIELDS
from repro_torch.examples import quickstart as t_qs
from repro_torch.examples import serve_retrieval as t_sr

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", ROOT / "examples" / f"{name}.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    return ex


def _record(fn, keep):
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        keep(out, *args, **kw)
        return out
    return wrapped


def _run(ex) -> list[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ex.main()
    return out.getvalue().splitlines()


@pytest.fixture(scope="module")
def ref_qs():
    """The reference quickstart's run: its lines, the assignment and
    index of its build, and each result."""
    ex = _load("quickstart")
    seen: dict = {"asc": {}}

    def keep_build(out, docs, assign, **kw):
        seen.update(assign=np.asarray(assign), index=out)

    def keep_asc(out, index, queries, **kw):
        seen["queries"] = queries
        seen["asc"][kw["mu"], kw["eta"]] = out

    def keep_bf(out, index, queries, k):
        seen["oracle"] = out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ex, "build_index", _record(ex.build_index, keep_build))
        mp.setattr(ex, "asc_retrieve", _record(ex.asc_retrieve, keep_asc))
        mp.setattr(ex, "brute_force_topk", _record(ex.brute_force_topk,
                                                   keep_bf))
        seen["lines"] = _run(ex)
    return seen


@pytest.fixture(scope="module")
def ref_sr():
    """The reference serving example's run: its lines, its assignment and
    index, and every batch its two engines served as (queries, budget,
    TopK)."""
    from repro.serving.engine import RetrievalEngine as JEngine
    ex = _load("serve_retrieval")
    seen: dict = {"batches": []}
    search = JEngine.search

    def keep_build(out, docs, assign, **kw):
        seen.update(assign=np.asarray(assign), index=out)

    def recorded_search(self, queries, *a, **kw):
        budget = int(self._budget(self._resolve()))
        out = search(self, queries, *a, **kw)
        seen["batches"].append((queries, budget, out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ex, "build_index", _record(ex.build_index, keep_build))
        mp.setattr(JEngine, "search", recorded_search)
        seen["lines"] = _run(ex)
    return seen


def _assert_index(got, want) -> None:
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


def _port_queries(q):
    return queries_from_arrays(np.asarray(q.tids), np.asarray(q.tw),
                               np.asarray(q.mask), vocab=q.vocab,
                               device="cpu")


def test_quickstart_on_reference_assignment_equals_reference(ref_qs):
    """The port's corpus and queries equal the reference's; its index on
    the reference's assignment equals the reference's; ``retrieve_all``
    on it prints the reference's lines to the digit and gives every
    result's 11 fields."""
    lines: list[str] = []
    docs, queries = t_qs.corpus(log=lines.append)
    want_q = ref_qs["queries"]
    for f in ("tids", "tw", "mask"):
        np.testing.assert_array_equal(getattr(queries, f).numpy(),
                                      np.asarray(getattr(want_q, f)))
    idx = t_qs.index(docs, ref_qs["assign"], "cpu", log=lines.append)
    _assert_index(idx, ref_qs["index"])
    out = t_qs.retrieve_all(idx, queries, "cpu", log=lines.append)
    assert lines == ref_qs["lines"][:5]
    assert sorted(out["asc"]) == sorted(ref_qs["asc"]) == sorted(
        t_qs.SETTINGS)
    for key, got in out["asc"].items():
        _assert_topk(got, ref_qs["asc"][key], f"asc {key}")
    _assert_topk(out["oracle"], ref_qs["oracle"], "brute force")
    assert out["recall"][1.0, 1.0] == 1.0      # rank-safe


def test_serve_retrieval_batches_equal_reference(ref_sr):
    """The port's index on the reference's assignment equals the
    reference's; every batch the reference's engines served (8
    unbudgeted, 8 under the adaptive budget, after a warm-up each)
    equals the port's ``retrieve`` at the budget it was served under."""
    idx, _ = t_sr.build(torch.Generator(), "cpu", assign=ref_sr["assign"])
    _assert_index(idx, ref_sr["index"])
    batches = ref_sr["batches"]
    assert len(batches) == 2 * t_sr.BATCHES
    budgets = [b for _, b, _ in batches]
    assert budgets[:t_sr.BATCHES] == [t_sr.M + 1] * t_sr.BATCHES
    assert all(b <= t_sr.M for b in budgets[t_sr.BATCHES:])
    for i, (q, budget, want) in enumerate(batches):
        got = retrieve(idx, _port_queries(q), t_sr.CFG, budget=budget,
                       device="cpu")
        _assert_topk(got, want, f"batch {i} (budget {budget})")


def _decimals(line: str) -> str:
    return re.sub(r"\s+", " ", re.sub(r"-?\d+\.\d+", "X", line))


def _numbers(line: str) -> str:
    # a number's padding goes with it: ``f"{ms:6.2f}"`` pads 5.12 and not
    # 105.12, and a timing's magnitude depends on the machine's load
    return re.sub(r"\s+", " ", re.sub(r" *-?\d+(\.\d+)?", " N", line))


def test_quickstart_prints_the_reference_lines(ref_qs, capsys,
                                               monkeypatch):
    """``--device cpu``: the reference's lines, decimals aside (its own
    k-means draws); the counts agree and rank-safe ASC keeps the whole
    top 10. Without a card the default ``cuda`` exits with an error."""
    t_qs.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert [_decimals(x) for x in got] == [_decimals(x)
                                           for x in ref_qs["lines"]]
    assert "recall@10=1.000" in got[2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        t_qs.main([])


def test_serve_retrieval_prints_the_reference_lines(ref_sr, capsys,
                                                    monkeypatch):
    """``--device cpu``: the reference's lines, numbers aside (its own
    draws and timings); the budget falls toward the target. Without a
    card the default ``cuda`` exits with an error."""
    t_sr.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert [_numbers(x) for x in got] == [_numbers(x)
                                          for x in ref_sr["lines"]]
    budgets = [int(re.search(r"budget=\s*(\d+)", x).group(1))
               for x in got if "budget=" in x]
    assert len(budgets) == t_sr.BATCHES and budgets[-1] <= budgets[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        t_sr.main([])
