"""The control and the planted faults: with the timed path broken, or the
reference computed one precision lower in the program's place, a run has
to come out not correct.

The cell is the small one of ``conftest.write_tiny_root``; the harness's
look for a card is skipped (``device="cpu"``), the rest of a run is
driven as the command drives it. A one-card cell has no exchange between
chips to leave out."""

from __future__ import annotations

import pytest
import torch

import repro_torch.core.search as search_mod
from bench import control, harness
from bench.tests.conftest import TINY_CELL
from repro_torch.core.types import QueryBatch, TopK
from repro_torch.serving.engine import RetrievalEngine

SEED = 2**31 + 23


@pytest.mark.parametrize("seed", [3, 4, 2**31 + 5])
def test_the_bfloat16_control_is_not_correct(tiny_root, seed):
    out = control.control(tiny_root, TINY_CELL, seed, "cpu")
    assert out["correct"] is False
    assert out["checks"]["queries_off_share"]["value"] > \
        out["checks"]["queries_off_share"]["limit"]


def test_the_float64_reference_in_place_is_correct(tiny_root):
    out = control.control(tiny_root, TINY_CELL, 6, "cpu",
                          dtype=torch.float64)
    assert out["correct"] is True


def _state_unchanged(monkeypatch):
    # every wave's merge hands back the running top-k it was given
    monkeypatch.setattr(search_mod, "_merge_wave",
                        lambda top_s, top_i, *a: (top_s, top_i))


def _half_batch(monkeypatch):
    # the engine serves the first half of the batch and hands its answers
    # to the other half too
    search = RetrievalEngine.search

    def half(self, queries, *a, **kw):
        h = queries.n_queries // 2
        part = QueryBatch(tids=queries.tids[:h], tw=queries.tw[:h],
                          mask=queries.mask[:h], vocab=queries.vocab)
        out = search(self, part, *a, **kw)
        return TopK(*(torch.cat([x, x]) for x in (
            getattr(out, f) for f in out.__dataclass_fields__)))
    monkeypatch.setattr(RetrievalEngine, "search", half)


def _id_altered(monkeypatch):
    # the merge names the next document beside the best score of query 0
    merge = search_mod._merge_wave

    def altered(*a):
        s, i = merge(*a)
        i = i.clone()
        i[0, 0] = torch.where(i[0, 0] >= 0, i[0, 0] + 1, i[0, 0])
        return s, i
    monkeypatch.setattr(search_mod, "_merge_wave", altered)


def _score_altered(monkeypatch):
    # the executor's scores of query 0 come out 0.1% high
    score = search_mod.score_admitted

    def altered(*a, **kw):
        out = score(*a, **kw)
        out[0] = torch.where(out[0] > 0, out[0] * 1.001, out[0])
        return out
    monkeypatch.setattr(search_mod, "score_admitted", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _id_altered, _score_altered])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    line = harness.run_cell(tiny_root, TINY_CELL, SEED, 0.3, False, "cpu")
    assert line["correct"] is False, line["checks"]
