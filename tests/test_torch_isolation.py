"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

from __future__ import annotations

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import get_arch
from repro_torch.convert import (gnn_params_from_arrays, index_from_arrays,
                                 lm_params_from_arrays, queries_from_arrays,
                                 recsys_params_from_arrays, to_arrays)
from repro_torch.core.index import build_index
from repro_torch.core.search import SearchConfig, brute_force_topk, retrieve
from repro_torch.core.types import INDEX_FIELDS
from repro_torch.data.synthetic import CorpusSpec, make_corpus, make_queries
from repro_torch.kernels import launch_counts, reset_launch_counts, wrappers
from repro_torch.models.gnn import init_params as gnn_init
from repro_torch.models.recsys import RECSYS
from repro_torch.models.sparse_encoder import SparseEncConfig, init_params
from repro_torch.models.transformer import init_cache
from repro_torch.models.transformer import init_params as lm_init
from repro_torch.serving.engine import RetrievalEngine, shard_index

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$)",
                       re.MULTILINE)


def _modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_import_pulls_in_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m == 'repro'\n"
        "             or m.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert len(_modules()) >= 20


def test_sources_never_import_jax_or_repro():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        hits = FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny():
    spec = CorpusSpec(n_docs=60, vocab=50, n_topics=3, doc_terms=6,
                      t_pad=10, query_terms=4, q_pad=6, seed=1)
    docs, topic = make_corpus(spec)
    queries, _ = make_queries(spec, 2, topic, seed=2)
    index = build_index(docs, topic, m=3, n_seg=2, seed=3, device="cpu")
    return docs, topic, index, queries


def test_entry_points_default_to_the_card(no_card):
    docs, topic, index, queries = _tiny()
    lm_cfg = get_arch("olmo-1b").smoke_config()
    b4r_cfg = get_arch("bert4rec").smoke_config()
    gnn_cfg = get_arch("meshgraphnet").smoke_config()
    cfg = SearchConfig(k=3)
    calls = [
        lambda: build_index(docs, topic, m=3, n_seg=2),
        lambda: retrieve(index, queries, cfg),
        lambda: brute_force_topk(index, queries, 3),
        lambda: RetrievalEngine(index, cfg),
        lambda: index_from_arrays({f: getattr(index, f).numpy()
                                   for f in INDEX_FIELDS},
                                  vocab=50, n_seg=2),
        lambda: queries_from_arrays(np.zeros((1, 2), np.int32),
                                    np.zeros((1, 2), np.float32),
                                    np.zeros((1, 2), bool), vocab=50),
        lambda: shard_index(index, mesh=None),
        lambda: init_params(torch.Generator().manual_seed(0),
                            SparseEncConfig(vocab=50, d_model=8,
                                            n_layers=1, n_heads=2,
                                            d_ff=16)),
        lambda: lm_init(torch.Generator().manual_seed(0), lm_cfg),
        lambda: lm_init(torch.Generator().manual_seed(0),
                        get_arch("olmoe-1b-7b").smoke_config()),
        lambda: init_cache(lm_cfg, 1, 4),
        lambda: lm_params_from_arrays(
            to_arrays(lm_init(torch.Generator(), lm_cfg, device="cpu")),
            lm_cfg),
        *(lambda arch=arch: RECSYS[arch][0](
            torch.Generator(), get_arch(arch).smoke_config())
          for arch in RECSYS),
        lambda: recsys_params_from_arrays(
            to_arrays(RECSYS["bert4rec"][0](torch.Generator(), b4r_cfg,
                                            device="cpu")),
            "bert4rec", b4r_cfg),
        lambda: gnn_init(torch.Generator(), gnn_cfg),
        lambda: gnn_params_from_arrays(
            to_arrays(gnn_init(torch.Generator(), gnn_cfg, device="cpu")),
            gnn_cfg),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # the training launcher, on one device and sharded over ranks, exits
    # with the error before it builds or spawns anything
    from repro_torch.launch import train as train_cli
    for argv in (["--arch", "olmo-1b"],
                 ["--arch", "olmo-1b", "--devices", "2"],
                 ["--arch", "dlrm-mlperf", "--devices", "4"]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            train_cli.main(argv)
    # a spawned rank asked for the card raises in the rank
    from repro_torch.launch.mesh import rank_device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rank_device(1, "cuda")


def test_cpu_tensors_take_the_plain_path():
    """On the CPU every wrapper runs its plain version and launches
    nothing; the launch counters stay at zero."""
    _, _, index, queries = _tiny()
    reset_launch_counts()
    out = retrieve(index, queries, SearchConfig(k=3, bounds_impl="gemm",
                                                engine="batched"),
                   device="cpu")
    retrieve(index, queries, SearchConfig(k=3, engine="per_query"),
             device="cpu")
    assert out.doc_ids.shape == (2, 3)
    assert set(launch_counts()) == set(wrappers())
    assert all(v == 0 for v in launch_counts().values())


def test_index_must_live_on_the_call_device():
    _, _, index, queries = _tiny()
    with pytest.raises(ValueError, match="lives on"):
        retrieve(index, queries, SearchConfig(k=3), device="meta")
