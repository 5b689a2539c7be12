"""A cell made only of files (a configuration and a mix written to a
temporary checkout), run through the harness on the CPU, with no edit
to the harness; and the harness's own guards."""

from __future__ import annotations

import json

import pytest

from bench import harness
from bench.tests.conftest import TINY_CELL

SEED = 2**31 + 17


@pytest.mark.parametrize("trace", [False, True])
def test_a_cell_from_files_runs_and_is_correct(tiny_root, trace):
    line = harness.run_cell(tiny_root, TINY_CELL, SEED, 0.5, trace, "cpu")
    assert line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] % 32 == 0
    assert list(line)[-1] == "checks"
    assert len(line["world"]["batch_ms_thirds"]) == 3
    assert set(line["checks"]) == {"queries_off_share", "doc_score_gap"}
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    got = set(line["metrics"])
    if trace:
        # the CPU gives no device trace: those readers find nothing
        assert got == {"waves_per_batch", "clusters_scored_frac",
                       "docs_scored_per_query", "build_index_s"}
        assert line["device"]["busy_s"] == 0.0
        assert "breakdown" in line
    else:
        assert got == {m["name"] for m in bench["end_to_end"]}
    for name, m in line["metrics"].items():
        # no card, no device memory
        assert m["value"] > 0 or name == "device_peak_gb", name
    json.dumps(line, allow_nan=False)


def test_the_seed_fixes_the_run(tiny_root):
    a = harness.run_cell(tiny_root, TINY_CELL, SEED, 0.2, False, "cpu")
    b = harness.run_cell(tiny_root, TINY_CELL, SEED, 0.2, False, "cpu")
    assert a["world"]["mean_doc_terms"] == b["world"]["mean_doc_terms"]
    c = harness.run_cell(tiny_root, TINY_CELL, SEED + 1, 0.2, False, "cpu")
    assert a["world"]["mean_doc_terms"] != c["world"]["mean_doc_terms"]


def test_an_open_loop_mix_is_refused(tiny_root):
    mix = tiny_root / "bench/traffic/tiny-mix.json"
    spec = json.loads(mix.read_text())
    mix.write_text(json.dumps(dict(spec, loop="open")))
    with pytest.raises(ValueError, match="closed loop"):
        harness.run_cell(tiny_root, TINY_CELL, SEED, 0.2, False, "cpu")


def test_an_unknown_cell_is_refused(tiny_root):
    with pytest.raises(SystemExit):
        harness.load_cell(tiny_root, "no-such-cell")


def test_malformed_answers_are_counted():
    import torch
    ids = torch.tensor([[[1, 2, 3], [4, 4, 5], [1, -1, 2], [7, 8, 9]]])
    scores = torch.tensor([[[3.0, 2.0, 1.0], [3.0, 2.0, 1.0],
                            [3.0, 2.0, 1.0], [1.0, 2.0, 3.0]]])
    # a repeated id, an empty slot, scores out of order
    assert harness._malformed(ids, scores, 3, 100) == 3
    assert harness._malformed(ids[:, :1], scores[:, :1], 3, 2) == 1


@pytest.mark.gpu
def test_a_small_cell_on_the_card_is_correct(tiny_root):
    """The same small cell through the kernels (K1, K3, K2) on the card,
    traced: every stage's range holds device time."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    line = harness.run_cell(tiny_root, TINY_CELL, SEED, 1.0, True, "cuda")
    assert line["correct"] is True
    for name in ("bounds_roofline", "plan_roofline", "score_roofline",
                 "merge_roofline", "device_idle_frac"):
        assert name in line["metrics"], name
    assert 0.0 < line["device"]["busy_s"] <= line["device"]["window_s"]
