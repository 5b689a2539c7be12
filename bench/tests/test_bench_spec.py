"""``BENCHMARK.json`` against the benchmark's contract: its keys, names,
units and limits, and a file of its own for every configuration, mix and
per-layer metric."""

from __future__ import annotations

import json
import re
from pathlib import Path

from bench import harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = {"msmarco-b256-k10", "beir-nq-b256-k10"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"] == f"bench/configs/{c['name']}.json"
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1 and _line(w["why"])
    assert {w["name"] for w in SPEC["workloads"]} == CELLS
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    all_names = [x["name"] for x in SPEC["configs"] + SPEC["workloads"]
                 + metrics]
    assert len(set(all_names)) == len(all_names)


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert set(e2e) == {"qps", "batch_p90_ms", "device_peak_gb", "setup_s"}
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25


def test_per_layer_metrics_have_readers_and_layers():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert len(SPEC["per_layer"]) == 9
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        assert set(m["workloads"]) == CELLS
        assert callable(harness.reader(m["name"]))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and m["source"] == "device_trace"


def test_every_cell_has_its_files():
    for w in SPEC["workloads"]:
        _, cell, cfg, mix = harness.load_cell(ROOT, w["name"])
        assert cfg["name"] == cell["config"]
        assert mix["loop"] == "closed" and mix["clients"] == 1
        assert cfg["reduced"] == next(
            c for c in SPEC["configs"] if c["name"] == cfg["name"])["reduced"]


def test_a_full_check_fits_with_every_cell():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
