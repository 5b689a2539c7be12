"""Shared set-up of the benchmark's CPU tests: the checkout's root and
``src`` on the path, and a small cell written as files of its own."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CELL = "tiny-cell"


def write_tiny_root(tmp: Path, n_docs: int = 6000, m: int = 40,
                    pool: int = 200, batch: int = 32, check: int = 2) -> Path:
    """A checkout-like directory holding a ``BENCHMARK.json`` with one
    small cell and its configuration and mix files, each derived from the
    committed ones by changing only sizes."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "bench/configs/msmarco-splade.json").read_text())
    cfg["name"] = "tiny"
    cfg["corpus"].update(n_docs=n_docs, vocab=3000, t_pad=48, n_topics=24,
                         doc_terms=30)
    cfg["index"].update(m=m, n_seg=4, d_pad=256)
    cfg["queries"].update(pool=pool, q_pad=16)
    cfg["search"]["group_size"] = 8
    mix = json.loads((ROOT / "bench/traffic/b256-k10.json").read_text())
    mix.update(batch=batch, check_batches=check)
    mix["queries"]["query_terms"] = 10
    for sub in ("configs", "traffic"):
        (tmp / "bench" / sub).mkdir(parents=True, exist_ok=True)
    (tmp / "bench/configs/tiny.json").write_text(json.dumps(cfg))
    (tmp / "bench/traffic/tiny-mix.json").write_text(json.dumps(mix))
    bench["configs"] = [dict(bench["configs"][0], name="tiny",
                             file="bench/configs/tiny.json")]
    bench["workloads"] = [dict(bench["workloads"][0], name=TINY_CELL,
                               config="tiny", traffic="tiny-mix")]
    for mt in bench["per_layer"]:
        mt["workloads"] = [TINY_CELL]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return write_tiny_root(tmp_path)
