"""The port's sharded retrieval (``repro_torch.serving.engine``'s
``distributed_retrieve`` over ``repro_torch.launch.mesh``) held against the
JAX package's shard_map path, on the CPU.

The JAX side runs once, in a subprocess with eight host devices (as
tests/test_distributed.py runs it), and writes its worlds and results to
an npz. The port side runs one process a rank over gloo with a
``file://`` rendezvous; every spawn has a hard limit of 120 s, so a hang
fails the case instead of holding the suite.

  * the (4, 2) ("data", "model") mesh on the 800-doc, m = 16 world of
    tests/test_distributed.py, in safe mode and at (mu, eta) = (0.9, 1.0),
    and the (2, 2, 2) ("pod", "data", "model") mesh on its 600-doc, m = 8
    world, where each rank's local batch of 2 takes the per-query route:
    all 11 TopK fields on every rank, ids and counters exactly, scores to
    1e-4;
  * the funnel rank 0 records into a registry equals the reference's;
  * safe mode sharded equals single-device retrieval (the reference
    test's own assertion), and the superblock refusal;
  * a rank that raises, or hangs, fails the spawn quickly.

The ``gpu`` test runs two ranks on one card against the same two ranks on
the CPU. This file collects without JAX (the machine with the card has
none): the reference is imported inside the tests that use it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.convert import index_from_arrays, queries_from_arrays
from repro_torch.core.search import SearchConfig, retrieve
from repro_torch.core.types import INDEX_FIELDS, TOPK_FIELDS
from repro_torch.launch.mesh import make_host_mesh, rank_device, spawn_ranks
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving.engine import (distributed_retrieve,
                                        index_shard_specs, shard_index)

ROOT = Path(__file__).resolve().parents[1]
SCORE_TOL = 1e-4
RANK_TIMEOUT_S = 120.0

# the worlds of tests/test_distributed.py
WORLDS = {
    "w800": dict(spec=dict(n_docs=800, vocab=256, n_topics=8, seed=3),
                 n_q=8, q_seed=4, m=16, n_seg=4),
    "w600": dict(spec=dict(n_docs=600, vocab=256, n_topics=8, seed=5),
                 n_q=4, q_seed=6, m=8, n_seg=2),
}
CASES = {
    "data4_model2_safe": dict(world="w800", shape=[4, 2],
                              axes=["data", "model"], multi_pod=False,
                              cfg=dict(k=10, mu=1.0, eta=1.0)),
    "data4_model2_approx": dict(world="w800", shape=[4, 2],
                                axes=["data", "model"], multi_pod=False,
                                cfg=dict(k=10, mu=0.9, eta=1.0),
                                funnel=True),
    "pod2_data2_model2_safe": dict(world="w600", shape=[2, 2, 2],
                                   axes=["pod", "data", "model"],
                                   multi_pod=True,
                                   cfg=dict(k=5, mu=1.0, eta=1.0)),
}

REFERENCE = """
import json, sys
import numpy as np
import jax
assert jax.device_count() == 8, jax.devices()
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core.index import build_index
from repro.core.search import SearchConfig
from repro.data.synthetic import CorpusSpec, make_corpus, make_queries
from repro.obs.metrics import MetricsRegistry
from repro.serving.engine import distributed_retrieve, index_shard_specs

out_path, worlds, cases, index_fields, topk_fields = (
    sys.argv[1], *map(json.loads, sys.argv[2:6]))
arrays, meta = {}, {"funnel": {}}
built = {}
for name, w in worlds.items():
    spec = CorpusSpec(**w["spec"])
    docs, doc_topic = make_corpus(spec)
    q, _ = make_queries(spec, w["n_q"], doc_topic, seed=w["q_seed"])
    idx = build_index(docs, doc_topic % w["m"], m=w["m"], n_seg=w["n_seg"])
    built[name] = (idx, q)
    for f in index_fields:
        arrays[f"{name}.index.{f}"] = np.asarray(getattr(idx, f))
    for f in ("tids", "tw", "mask"):
        arrays[f"{name}.q.{f}"] = np.asarray(getattr(q, f))
    arrays[f"{name}.vocab"] = np.int64(idx.vocab)
    arrays[f"{name}.n_seg"] = np.int64(idx.n_seg)
for name, c in cases.items():
    idx, q = built[c["world"]]
    cfg = SearchConfig(**c["cfg"])
    mesh = jax.make_mesh(tuple(c["shape"]), tuple(c["axes"]))
    reg = MetricsRegistry() if c.get("funnel") else None
    with mesh:
        ispecs = index_shard_specs(idx, multi_pod=c["multi_pod"])
        i_shard = jax.tree_util.tree_map(
            lambda s: NamedSharding(mesh, s), ispecs,
            is_leaf=lambda x: isinstance(x, P))
        idx_s = jax.device_put(idx, i_shard)
        q_s = jax.device_put(q, jax.tree_util.tree_map(
            lambda _: NamedSharding(mesh, P("model", None)),
            q, is_leaf=lambda x: hasattr(x, "shape")))
        dist = distributed_retrieve(idx_s, q_s, cfg, mesh,
                                    multi_pod=c["multi_pod"], registry=reg)
        if name == "data4_model2_safe":
            try:
                distributed_retrieve(idx_s, q_s, SearchConfig(
                    superblocks=True), mesh)
            except ValueError as e:
                meta["superblock_error"] = str(e)
    for f in topk_fields:
        arrays[f"{name}.dist.{f}"] = np.asarray(getattr(dist, f))
    if reg is not None:
        meta["funnel"][name] = reg.snapshot()
np.savez(out_path, **arrays)
with open(out_path + ".json", "w") as fh:
    json.dump(meta, fh)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's worlds and results, from one subprocess."""
    out = tmp_path_factory.mktemp("dist_ref") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    env["PYTHONPATH"] = str(ROOT / "src")
    run = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(out), json.dumps(WORLDS),
         json.dumps(CASES), json.dumps(INDEX_FIELDS),
         json.dumps(TOPK_FIELDS)],
        env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout + run.stderr
    meta = json.loads(Path(str(out) + ".json").read_text())
    with np.load(out) as z:
        arrays = dict(z)
    return {"npz": str(out), "arrays": arrays, **meta}


def _world(z, name: str, device: str = "cpu"):
    index = index_from_arrays(
        {f: z[f"{name}.index.{f}"] for f in INDEX_FIELDS},
        vocab=int(z[f"{name}.vocab"]), n_seg=int(z[f"{name}.n_seg"]),
        device=device)
    q = queries_from_arrays(z[f"{name}.q.tids"], z[f"{name}.q.tw"],
                            z[f"{name}.q.mask"], vocab=index.vocab,
                            device=device)
    return index, q


def _rank_case(rank: int, npz_path: str, case: dict,
               device_type: str = "cpu") -> dict:
    """One rank of a case: its shard, the sharded search, every field as
    numpy (and rank 0's funnel when the case asks for one)."""
    torch.set_num_threads(1)
    dev = rank_device(rank, device_type)
    with np.load(npz_path) as z:
        index, q = _world(z, case["world"])
    mesh = make_host_mesh(case["shape"], case["axes"], dev.type)
    local = shard_index(index, mesh, case["multi_pod"], dev)
    reg = MetricsRegistry() if case.get("funnel") else None
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    out = distributed_retrieve(local, q, SearchConfig(**case["cfg"]), mesh,
                               multi_pod=case["multi_pod"], registry=reg)
    return {"fields": {f: getattr(out, f).cpu().numpy()
                       for f in TOPK_FIELDS},
            "funnel": reg.snapshot() if reg is not None else None,
            "local_m": local.m, "launches": launch_counts()}


_RESULTS: dict = {}


def _sharded(reference, name: str) -> list[dict]:
    if name not in _RESULTS:
        case = CASES[name]
        _RESULTS[name] = spawn_ranks(
            _rank_case, int(np.prod(case["shape"])),
            (reference["npz"], case), timeout_s=RANK_TIMEOUT_S)
    return _RESULTS[name]


def _assert_fields(got: dict, want: dict, what: str) -> None:
    for f in TOPK_FIELDS:
        if f == "scores":
            np.testing.assert_allclose(got[f], want[f], rtol=SCORE_TOL,
                                       atol=SCORE_TOL, err_msg=what)
        else:
            np.testing.assert_array_equal(got[f], want[f],
                                          err_msg=f"{what}: {f}")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_equals_reference(reference, name):
    """Every rank returns the whole batch, equal to the reference's
    global result on all 11 fields; each rank held m / shards clusters."""
    case = CASES[name]
    z = reference["arrays"]
    want = {f: z[f"{name}.dist.{f}"] for f in TOPK_FIELDS}
    results = _sharded(reference, name)
    n_shards = int(np.prod(case["shape"][:-1]))
    for rank, r in enumerate(results):
        _assert_fields(r["fields"], want, f"{name} rank {rank}")
        assert r["local_m"] == WORLDS[case["world"]]["m"] // n_shards


def test_funnel_recorded_on_rank_zero(reference):
    """Rank 0's registry holds the reference's funnel (global m, one
    representative slot per query shard); no other rank records."""
    name = "data4_model2_approx"
    results = _sharded(reference, name)
    want = reference["funnel"][name]
    assert results[0]["funnel"] == want
    assert want["funnel_clusters_budgeted_total"] == 16 * 8
    assert all(not r["funnel"] for r in results[1:])


@pytest.mark.parametrize("name", ["data4_model2_safe",
                                  "pod2_data2_model2_safe"])
def test_safe_mode_sharded_equals_single_device(reference, name):
    """tests/test_distributed.py's assertion, on the port: in rank-safe
    mode the sharded result set equals single-device retrieval's."""
    case = CASES[name]
    z = reference["arrays"]
    index, q = _world(z, case["world"])
    single = retrieve(index, q, SearchConfig(**case["cfg"]), device="cpu")
    got = _sharded(reference, name)[0]["fields"]["scores"]
    np.testing.assert_allclose(np.sort(got, 1),
                               np.sort(single.scores.numpy(), 1),
                               rtol=SCORE_TOL, atol=SCORE_TOL)


def test_superblocks_refused(reference):
    """The same ValueError as the reference, before any collective."""
    z = reference["arrays"]
    index, q = _world(z, "w800")
    with pytest.raises(ValueError) as err:
        distributed_retrieve(index, q, SearchConfig(superblocks=True),
                             mesh=None)
    assert str(err.value) == reference["superblock_error"]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_shard_specs_match_reference(multi_pod):
    """Split fields, replicated fields and the cluster axes of each."""
    from jax.sharding import PartitionSpec

    from repro.serving.engine import index_shard_specs as j_specs
    from repro_torch.tools.golden_world import golden_world
    index, _ = golden_world("cpu")
    got = index_shard_specs(index, multi_pod)
    want = j_specs(index, multi_pod)
    for f in INDEX_FIELDS:
        spec = getattr(want, f)
        assert isinstance(spec, PartitionSpec)
        lead = spec[0] if len(spec) else None
        lead = (lead,) if isinstance(lead, str) else (lead or ())
        assert got[f] == tuple(lead), f


def _rank_fails(rank: int) -> None:
    if rank == 1:
        raise ValueError("rank 1 refuses")
    torch.distributed.barrier()            # rank 0 waits for rank 1


def _rank_sleeps(rank: int, seconds: float) -> None:
    time.sleep(seconds)


def test_spawn_reports_a_failed_rank_and_a_hang():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 refuses"):
        spawn_ranks(_rank_fails, 2, timeout_s=RANK_TIMEOUT_S)
    with pytest.raises(TimeoutError, match="2 of 2 ranks"):
        spawn_ranks(_rank_sleeps, 2, (600.0,), timeout_s=3.0)
    assert time.monotonic() - t0 < RANK_TIMEOUT_S


@pytest.mark.gpu
def test_two_ranks_on_one_card_equal_the_cpu(tmp_path):
    """Two ranks sharing cuda:0 over gloo (K1, the planner and K2 on each
    shard) against the same two ranks on the CPU: ids and counters
    exactly, scores to 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.index import build_index
    from repro_torch.data.synthetic import (CorpusSpec, make_corpus,
                                            make_queries)
    spec = CorpusSpec(n_docs=800, vocab=256, n_topics=8, seed=3)
    docs, topic = make_corpus(spec)
    q, _ = make_queries(spec, 8, topic, seed=4)
    index = build_index(docs, topic % 16, m=16, n_seg=4, device="cpu")
    arrays = {f"w.index.{f}": getattr(index, f).numpy()
              for f in INDEX_FIELDS}
    arrays.update({f"w.q.{f}": getattr(q, f).numpy()
                   for f in ("tids", "tw", "mask")})
    path = str(tmp_path / "w.npz")
    np.savez(path, **arrays, **{"w.vocab": np.int64(256),
                                "w.n_seg": np.int64(4)})
    case = dict(world="w", shape=[2, 1], axes=["data", "model"],
                multi_pod=False, cfg=dict(k=10, mu=0.9, eta=1.0,
                                          bounds_impl="gemm"))
    on_cpu = spawn_ranks(_rank_case, 2, (path, case, "cpu"),
                         timeout_s=RANK_TIMEOUT_S)
    on_card = spawn_ranks(_rank_case, 2, (path, case, "cuda"),
                          timeout_s=RANK_TIMEOUT_S)
    for rank in range(2):
        got, want = on_card[rank]["fields"], on_cpu[rank]["fields"]
        for f in TOPK_FIELDS:
            if f == "scores":
                np.testing.assert_allclose(got[f], want[f], rtol=1e-5,
                                           atol=1e-6)
            else:
                np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        launches = on_card[rank]["launches"]
        assert all(launches[k] > 0 for k in ("segment_bound_gemm",
                                             "plan_wave", "score_queue"))
