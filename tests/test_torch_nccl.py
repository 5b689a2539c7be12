"""The port's meshes over nccl (``repro_torch.launch.mesh`` and the two
launchers' ``--devices``): what the CPU can hold of that branch, and, on
a machine with four cards, the branch itself.

On the CPU:

  * the backend choice: nccl exactly when every rank owns a card, for
    ``launch/serve.py`` and ``launch/train.py`` (``torch.cuda.device_count``
    monkeypatched, ``spawn_ranks`` recorded);
  * ``_rank_main``'s order: under nccl the rank's card is bound before
    the rank joins the process group, which gets it as ``device_id``;
    the group's timeout reaches ``init_process_group``, and a rank stuck
    in a gloo collective fails within it;
  * every collective operand of ``distributed_retrieve`` (on (2, 2))
    and of one sharded training step (OLMo's smoke config, FSDP on
    (4, 1), FSDP and the sequence over 'model' on (2, 2)) lies on the
    rank's device and is contiguous (nccl refuses a strided operand that
    gloo takes): a dispatch mode records each ``c10d`` op's tensors on
    four gloo CPU ranks; the retrieval equals the one-process merge bit
    for bit and each step one device's.

On four cards (``gpu``; this file imports no JAX, so it runs with
``--noconftest``): the same over nccl, each rank on its own card, with
K1, the planner and K2 launched on every card.
"""

from __future__ import annotations

import argparse
import datetime
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import spawn_ranks

RANK_TIMEOUT_S = 120.0
LR = 1e-3
B, S = 8, 32
CFG = dict(k=5, mu=0.9, eta=1.0, bounds_impl="gemm", engine="batched")


# ---------------------------------------------------------------------------
# the backend choice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cards,want", [(4, "nccl"), (8, "nccl"),
                                        (3, "gloo"), (1, "gloo"),
                                        (0, "gloo")])
def test_backend_for_needs_a_card_a_rank(monkeypatch, cards, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert mesh_lib.backend_for(4, "cuda") == want
    assert mesh_lib.backend_for(4, "cpu") == "gloo"


def _recorded_spawn(monkeypatch, result=None) -> list:
    calls = []

    def spawn(fn, world, args=(), **kw):
        calls.append(dict(fn=fn.__name__, world=world, **kw))
        return [dict(result or {}) for _ in range(world)]

    monkeypatch.setattr(mesh_lib, "spawn_ranks", spawn)
    return calls


@pytest.mark.parametrize("cards,want", [(4, "nccl"), (2, "gloo")])
def test_serve_launcher_picks_nccl_when_each_rank_owns_a_card(
        monkeypatch, capsys, cards, want):
    from repro_torch import device as dev_lib
    from repro_torch.launch import serve
    from repro_torch.tools.golden_world import golden_world
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(dev_lib, "build_kernels", lambda: None)
    calls = _recorded_spawn(monkeypatch)
    index, _ = golden_world("cpu")
    args = argparse.Namespace(devices=4, churn=0, save_dir=None,
                              budget_ms=None)
    serve._serve_sharded(args, index, None, None, None,
                         torch.device("cuda"))
    assert [(c["world"], c["backend"]) for c in calls] == [(4, want)]
    assert f"[serve] 4 ranks over {want} on {cards} card(s)" \
        in capsys.readouterr().out
    # on the CPU: gloo, whatever the machine's cards
    serve._serve_sharded(args, index, None, None, None,
                         torch.device("cpu"))
    assert calls[-1]["backend"] == "gloo"
    assert "[serve] 4 ranks over gloo on the CPU" in capsys.readouterr().out


@pytest.mark.parametrize("cards,want", [(4, "nccl"), (3, "gloo")])
def test_train_launcher_picks_nccl_when_each_rank_owns_a_card(
        monkeypatch, capsys, tmp_path, cards, want):
    import json

    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    calls = _recorded_spawn(monkeypatch, dict(
        rank_device="cuda:0", peak_memory_bytes=1, peak_reserved_bytes=2))
    metrics = tmp_path / "m.json"
    for device, line in (("cuda", f"4 ranks over {want} on {cards} card(s)"),
                         ("cpu", "4 ranks over gloo on the CPU")):
        args = argparse.Namespace(devices=4, device=device,
                                  metrics_json=str(metrics))
        train._sharded(args, "lm")
        got = calls[-1]["backend"]
        assert got == (want if device == "cuda" else "gloo")
        assert json.loads(metrics.read_text())["backend"] == got
        assert capsys.readouterr().out.splitlines() == [
            "[train] mesh: {'data': 4, 'model': 1}", f"[train] {line}"]


# ---------------------------------------------------------------------------
# _rank_main: the card before the group, the group's timeout
# ---------------------------------------------------------------------------

class _Results(list):
    put = list.append


def _rank_main_calls(monkeypatch, backend: str) -> list:
    calls: list = []
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("set_device", d)))
    monkeypatch.setattr(mesh_lib.dist, "init_process_group",
                        lambda *a, **kw: calls.append(("init", a, kw)))
    monkeypatch.setattr(mesh_lib.dist, "destroy_process_group",
                        lambda: calls.append(("destroy",)))
    results = _Results()
    mesh_lib._rank_main(2, 4, "file:///nowhere", backend,
                        lambda rank: calls.append(("fn", rank)) or rank,
                        (), results, 123.0)
    assert results == [(2, True, 2)]
    return calls


def test_nccl_rank_binds_its_card_before_it_joins(monkeypatch):
    calls = _rank_main_calls(monkeypatch, "nccl")
    assert [c[0] for c in calls] == ["set_device", "init", "fn", "destroy"]
    assert calls[0][1] == torch.device("cuda", 2)
    _, args, kw = calls[1]
    assert args == ("nccl",)
    assert kw["device_id"] == torch.device("cuda", 2)
    assert kw["timeout"] == datetime.timedelta(seconds=123.0)
    assert (kw["rank"], kw["world_size"]) == (2, 4)


def test_gloo_rank_joins_with_the_timeout_and_no_card(monkeypatch):
    calls = _rank_main_calls(monkeypatch, "gloo")
    assert [c[0] for c in calls] == ["init", "fn", "destroy"]
    _, args, kw = calls[0]
    assert args == ("gloo",) and "device_id" not in kw
    assert kw["timeout"] == datetime.timedelta(seconds=123.0)


def test_nccl_refuses_to_share_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="a card of its own"):
        spawn_ranks(_rank_waits, 4, (0.0,), backend="nccl")


def _rank_waits(rank: int, seconds: float) -> None:
    """Rank 0 waits in an all-reduce that rank 1 joins after
    ``seconds``."""
    import torch.distributed as dist
    if rank == 1:
        time.sleep(seconds)
    dist.all_reduce(torch.ones(1))


def test_a_rank_stuck_in_a_collective_fails_within_the_timeout():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 failed"):
        spawn_ranks(_rank_waits, 2, (60.0,), timeout_s=RANK_TIMEOUT_S,
                    collective_timeout_s=1.0)
    assert time.monotonic() - t0 < 30.0


# ---------------------------------------------------------------------------
# where the collectives' operands live
# ---------------------------------------------------------------------------

class OperandRecorder(TorchDispatchMode):
    """Each ``c10d`` op dispatched inside it, with the devices of its
    tensor arguments (inputs and outputs alike) and whether every one of
    them is contiguous (nccl refuses one that is not; gloo takes it).
    ``barrier``'s own placeholder tensor is left out: the backend makes
    it."""

    def __init__(self):
        super().__init__()
        self.ops: list[tuple[str, list[str], bool]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "c10d":
            name = func._schema.name.split("::")[-1]
            if name != "barrier":
                ts = [t for t in tree_leaves((args, kwargs))
                      if isinstance(t, torch.Tensor)]
                self.ops.append((name, sorted({str(t.device) for t in ts}),
                                 all(t.is_contiguous() for t in ts)))
        return func(*args, **(kwargs or {}))


def _lm_cfg():
    from repro_torch.configs import get_arch
    return get_arch("olmo-1b").smoke_config()


def _lm_batch(dev) -> dict:
    from repro_torch.data.pipeline import LMDataSpec, lm_batch
    return {k: v[:, :S].to(dev) for k, v in
            lm_batch(LMDataSpec(_lm_cfg().vocab, S + 1, B), 0).items()}


def _train_step(dev, mesh=None, record=None) -> dict:
    """One AdamW step of OLMo's smoke config from seed 0 on ``dev`` (FSDP
    over ``mesh``'s "data" under ``lm_rules``, else one device): the
    loss, grad norm and every parameter after it (whole, on the host)."""
    import contextlib

    from repro_torch.distributed import parallelize as par
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer as tf
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    from repro_torch.training.tree import leaves, module_tree
    cfg = _lm_cfg()
    model = tf.init_params(torch.Generator().manual_seed(0), cfg,
                           device=dev)
    layout = None
    if mesh is not None:
        rules = sh.lm_rules(mesh)
        par.shard_module(model, rules, tf.param_axes(cfg))
        layout = par.Layout(rules, par.batch_axes_of(rules))
    opt = opt_lib.adamw(opt_lib.constant_schedule(LR))
    state = opt.init(module_tree(model))
    step = make_train_step(tf.loss_fn, opt, TrainConfig(), layout=layout)
    batch = _lm_batch(dev)
    with record if record is not None else contextlib.nullcontext():
        model, state, m = step(model, state, batch, 0)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": [par.full(p).detach().cpu().numpy()
                       for p in leaves(module_tree(model))]}


def _rank(rank: int, device_type: str, retrieve_shapes: list,
          train_shapes: list) -> dict:
    """The golden world's queries through ``distributed_retrieve`` on each
    of ``retrieve_shapes`` and one sharded step on each of
    ``train_shapes`` (FSDP over "data", the sequence over 'model'), every
    ``c10d`` op's operands recorded."""
    from repro_torch.core.search import SearchConfig
    from repro_torch.core.types import TOPK_FIELDS
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh, rank_device
    from repro_torch.serving.engine import distributed_retrieve, shard_index
    from repro_torch.tools.golden_world import golden_world
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = rank_device(rank, device_type)
    index, q = golden_world("cpu")
    out: dict = {"device": str(dev), "retrieve": []}
    for shape in retrieve_shapes:
        mesh = make_host_mesh(shape, ("data", "model"), dev.type)
        local = shard_index(index, mesh, device=dev)
        rec = OperandRecorder()
        reset_launch_counts()
        with rec:
            got = distributed_retrieve(local, q, SearchConfig(**CFG), mesh)
        out["retrieve"].append(dict(
            shape=list(shape), ops=rec.ops, launches=launch_counts(),
            fields={f: getattr(got, f).cpu().numpy() for f in TOPK_FIELDS}))
    out["train"] = []
    for shape in train_shapes:
        rec = OperandRecorder()
        mesh = make_host_mesh(shape, ("data", "model"), dev.type)
        out["train"].append(dict(_train_step(dev, mesh, rec), ops=rec.ops,
                                 shape=list(shape)))
    return out


def _check_operands(ranks: list) -> None:
    """Every rank's recorded ops touched only its own device, each
    operand contiguous, and each part made its collectives: the
    retrieval's all-gathers and all-reduce, a train step's all-reduce
    and, under whichever names this torch gives its single-tensor
    collectives, its weight gathers and gradient reduce-scatters."""
    for r in ranks:
        parts = [(f"retrieve {p['shape']}", p["ops"]) for p in r["retrieve"]]
        parts += [(f"train {t['shape']}", t["ops"]) for t in r["train"]]
        for what, ops in parts:
            names = {name for name, _, _ in ops}
            if what.startswith("retrieve"):
                assert {"allgather_", "allreduce_"} <= names, (what, names)
            else:
                assert "allreduce_" in names, (what, names)
                assert any("gather" in n for n in names - {"allgather_"}), \
                    (what, names)
                assert any("reduce_scatter" in n for n in names), \
                    (what, names)
            for name, devices, contiguous in ops:
                assert devices == [r["device"]], (what, name, devices)
                assert contiguous, (what, name)


def _check_train(ranks: list, one: dict) -> None:
    for r in ranks:
        for got in r["train"]:
            np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5,
                                       atol=1e-6)
            for a, b in zip(got["params"], one["params"]):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def _check_ranks(ranks: list, dev: torch.device) -> None:
    """``_rank``'s results on (2, 2) and (4, 1), (2, 2) against one
    process on ``dev``: every collective operand on the rank's device and
    contiguous, the retrieval equal to the one-process merge bit for bit
    on every rank, each train step against one device's."""
    from repro_torch.tools.golden_world import golden_world
    _check_operands(ranks)
    index, q = golden_world(dev)
    want = _one_process_merge(index, q, (2, 2), dev)
    for r in ranks:
        for f, w in want.items():
            np.testing.assert_array_equal(r["retrieve"][0]["fields"][f], w,
                                          err_msg=f)
    _check_train(ranks, _train_step(dev))


def test_collective_operands_live_on_the_rank_device():
    ranks = spawn_ranks(_rank, 4, ("cpu", [(2, 2)], [(4, 1), (2, 2)]),
                        timeout_s=RANK_TIMEOUT_S)
    _check_ranks(ranks, torch.device("cpu"))


# ---------------------------------------------------------------------------
# four cards, one rank each, over nccl
# ---------------------------------------------------------------------------

def _one_process_merge(index, q, shape, dev) -> dict:
    """The sharded search done in one process on the kernel path: each
    query block searched on each cluster shard, the shards' top-k merged
    by a stable top-k over their concatenation, seven counters summed
    and the superblock pair taken as it is."""
    from repro_torch.core.search import SearchConfig, retrieve, topk_stable
    from repro_torch.core.types import (INDEX_FIELDS, TOPK_FIELDS,
                                        ClusterIndex, QueryBatch)
    from repro_torch.serving.engine import index_shard_specs
    cfg = SearchConfig(**CFG)
    n_data, n_model = shape
    size = index.m // n_data
    specs = index_shard_specs(index)
    shards = [ClusterIndex(
        **{f: (getattr(index, f)[s * size:(s + 1) * size] if specs[f]
               else getattr(index, f)) for f in INDEX_FIELDS},
        vocab=index.vocab, n_seg=index.n_seg) for s in range(n_data)]
    n_local = q.n_queries // n_model
    cols: list = []
    for h in range(n_model):
        lo, hi = h * n_local, (h + 1) * n_local
        qh = QueryBatch(tids=q.tids[lo:hi], tw=q.tw[lo:hi],
                        mask=q.mask[lo:hi], vocab=q.vocab)
        part = [retrieve(sh, qh, cfg, device=dev) for sh in shards]
        scores, pos = topk_stable(torch.cat([p.scores for p in part], 1),
                                  cfg.k)
        ids = torch.gather(torch.cat([p.doc_ids for p in part], 1), 1, pos)
        counters = ([sum(getattr(p, f) for p in part)
                     for f in TOPK_FIELDS[2:9]]
                    + [getattr(part[0], f) for f in TOPK_FIELDS[9:]])
        cols.append([ids, scores, *counters])
    return {f: torch.cat(c).cpu().numpy()
            for f, c in zip(TOPK_FIELDS, zip(*cols))}


@pytest.mark.gpu
def test_four_cards_over_nccl():
    """distributed_retrieve on (2, 2) over nccl, each rank on its own
    card, equal to the one-process kernel-path merge bit for bit (K1,
    the planner and K2 launched on every card); one sharded step on
    (4, 1) and on (2, 2) against one device (loss rtol 1e-5, parameters
    rtol 1e-4 / atol 1e-6, fp32); every collective operand on
    ``cuda:rank`` and contiguous."""
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs four CUDA cards, this machine has "
                    f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    ranks = spawn_ranks(_rank, 4, ("cuda", [(2, 2)], [(4, 1), (2, 2)]),
                        backend="nccl", timeout_s=300.0)
    assert [r["device"] for r in ranks] == [f"cuda:{i}" for i in range(4)]
    for r in ranks:
        for k in ("segment_bound_gemm", "plan_wave", "score_queue"):
            assert r["retrieve"][0]["launches"][k] > 0, (r["device"], k)
    _check_ranks(ranks, torch.device("cuda"))
