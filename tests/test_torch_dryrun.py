"""The port's dry-run (``repro_torch.launch.dryrun``) and its multi-pod
example.

The instruments first, on hand-written programs: the collective counter
must give exact counts and result bytes in all five of the reference's
kinds for an 8-rank program of torch's fake process group, and the
live-bytes tracker must give the same peak on the meta device as on real
CPU tensors. Then ``run_cell`` at full production shapes on meta, rank 0
of a 256- or 512-rank fake group, for one cell of each family: status
ok, ``argument_size_in_bytes`` equal to rank 0's blocks worked out here
from ``shard_with_shapes`` and the batch's split (rows over "data", the
sequence over 'model'), the LM training cell's FLOPs within [1.2, 1.5]
of its rank's share of MODEL_FLOPS (the remat recompute and the
attention chunks), its FSDP all-gather and reduce-scatter bytes and its
K/V gathers equal to a count from the blocks' shapes, and the decode
cells' cache blocks as ``cache_axes()`` under the rules give them. Then
the CLI's lines and record keys, the example's lines, and
``parallelize.group`` on two meshes built in turn.
"""

from __future__ import annotations

import gc
import json
import math
import re

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor.debug import CommDebugMode

from repro_torch.configs import get_arch
from repro_torch.convert import LayerStack, reference_view
from repro_torch.distributed import parallelize as par
from repro_torch.distributed import sharding as sh
from repro_torch.launch import cells, dryrun
from repro_torch.launch.dryrun import (COLLECTIVES, CollectiveCounter,
                                       LiveBytes, run_cell)
from repro_torch.launch.mesh import fake_world, make_host_mesh
from repro_torch.models.layers import shapes_only


def _expect(**kinds) -> dict:
    out = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
    for k, (n, b) in kinds.items():
        out[k.replace("_", "-")] = {"count": n, "bytes": b}
    return out


def test_collective_counter_counts_every_kind_exactly():
    with fake_world(8):
        mesh = make_host_mesh((2, 4), ("data", "model"))
        g = par.group(mesh, "model")
        counter, comm = CollectiveCounter(), CommDebugMode()
        with comm, counter:
            x = torch.ones(4, 6)                               # 96 B
            dist.all_reduce(x)
            out = torch.empty(32, 6)
            dist.all_gather_into_tensor(out, x)                # 768 B
            dist.all_gather([torch.empty(4, 6) for _ in range(8)], x)
            r = torch.empty(1, 6)
            dist.reduce_scatter_tensor(r, torch.ones(8, 6))    # 24 B
            a = torch.empty(8, 6, dtype=torch.bfloat16)
            dist.all_to_all_single(a, torch.ones(8, 6, dtype=torch.bfloat16))
            # the port's own: a bf16 gather over 'model' moves raw bytes
            y = par.gather(torch.ones(2, 3, dtype=torch.bfloat16), 0, g)
            par.all_to_all(torch.ones(4, 2), g)                # 32 B
        assert y.shape == (8, 3)
        # torch's CommDebugMode sees raw calls too (no DTensor op here)
        assert comm.get_total_counts() > 0
        assert counter.counts == _expect(
            all_gather=(3, 768 + 768 + 8 * 3 * 2), all_reduce=(1, 96),
            reduce_scatter=(1, 24), all_to_all=(2, 96 + 32))
        with pytest.raises(ValueError, match="uncounted"), CollectiveCounter():
            dist.broadcast(torch.ones(3), 0)


def _program(device):
    """A small training-like program: products, an activation freed
    early, a backward pass, an in-place update of an argument."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(64, 48, generator=g).to(device).requires_grad_()
    x = torch.randn(40, 64, generator=g).to(device)
    args = [w, x]
    live = LiveBytes(args)
    with live:
        h = torch.relu(x @ w)
        y = (h @ h.T).tanh()
        del h
        loss = (y * y).sum()
        (grad,) = torch.autograd.grad(loss, w)
        tmp = torch.empty(3000, device=device)
        del tmp, y, loss
        with torch.no_grad():
            w.add_(grad, alpha=-0.1)
    return live


def test_live_bytes_meta_peak_equals_cpu_peak():
    meta, cpu = _program("meta"), _program("cpu")
    assert meta.peak == cpu.peak > 40 * 48 * 4
    # each storage rounded to the CUDA allocator's 512-byte blocks
    assert meta.peak % 512 == 0
    # the in-place update of the weight, the one argument written
    assert len(meta.written) == len(cpu.written) == 1


# ---------------------------------------------------------------------------
# run_cell at production shapes
# ---------------------------------------------------------------------------

def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def _block(shape, spec, sizes) -> tuple:
    return tuple(d // math.prod(sizes[a] for a in sh.entry_axes(e))
                 for d, e in zip(shape, tuple(spec) + (None,) * len(shape)))


def _param_blocks(model, rules, axes_tree) -> list[tuple[tuple, torch.dtype]]:
    """(block shape, dtype) of every parameter, a layer stack's per
    layer, from ``shard_with_shapes`` of the unsharded model."""
    view = reference_view(model)
    specs = sh.shard_with_shapes(rules, axes_tree, view)
    sizes = sh.mesh_sizes(rules.mesh)
    out = []

    def add(axes, s, leaf):
        if isinstance(leaf, LayerStack):
            blk = _block(leaf.shape, s.spec, sizes)[1:]
            out.extend([(blk, leaf.items[0].dtype)] * len(leaf.items))
        else:
            out.append((_block(leaf.shape, s.spec, sizes), leaf.dtype))
    sh.map_axes(add, axes_tree, specs, view)
    return out


def _meta_model(init):
    with shapes_only():
        return init(torch.Generator().manual_seed(0), "meta")


@pytest.fixture(scope="module")
def olmo_train():
    return run_cell("olmo-1b", "train_4k", "single", save=False)


def test_run_cell_lm_train_record(olmo_train):
    from repro_torch.models import transformer as tf
    rec = olmo_train
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_devices"] == 256 and rec["mode"] == "train"
    cfg = get_arch("olmo-1b").config()
    with fake_world(256):
        mesh = make_host_mesh((16, 16), ("data", "model"))
        rules = sh.lm_rules(mesh, training=True)
        blocks = _param_blocks(_meta_model(
            lambda g, d: tf.init_params(g, cfg, device=d)), rules,
            tf.param_axes(cfg))
    params = sum(_nbytes(s, d) for s, d in blocks)
    # AdamW's two float32 moments; the batch's 256 rows over 16 'data',
    # its 4,096 positions over 16 'model'
    batch = 3 * 16 * 256 * 4
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == 3 * params + batch
    assert mem["alias_size_in_bytes"] == params
    assert mem["temp_size_in_bytes"] > 0
    # every rank's share: the sequence split leaves no compute repeated
    share = rec["model_flops"] / 256
    assert 1.2 <= rec["flops"] / share <= 1.5
    assert rec["flops_total"] == rec["flops"]
    assert rec["bytes_accessed"] is None and rec["hlo_lines"] is None


def test_run_cell_fsdp_collectives_match_block_count(olmo_train):
    """Every weight is cast to bfloat16 and gathered at use, innermost
    mesh dim first: twice a layer (the forward and the remat recompute),
    twice for the tied embedding (lookup and head). Each use's gradient
    is reduce-scattered (float32) over every dim it was split on, 'data'
    and 'model' alike (the sequence split over 'model' gives its ranks
    other tokens), once a use of the forward that autograd
    differentiates. Each layer gathers its K and V (bfloat16) over
    'model' in the forward and the recompute, and reduce-scatters their
    gradients (float32) back to each rank's chunk."""
    from repro_torch.models import transformer as tf
    cfg = get_arch("olmo-1b").config()
    with fake_world(256):
        mesh = make_host_mesh((16, 16), ("data", "model"))
        rules = sh.lm_rules(mesh, training=True)
        model = _meta_model(lambda g, d: tf.init_params(g, cfg, device=d))
        par.shard_module(model, rules, tf.param_axes(cfg))
        ag = rs = n_ag = n_rs = 0
        for name, p in model.named_parameters():
            uses = 2
            stages = [i for i, q in enumerate(p.placements)
                      if q.is_shard()][::-1]
            cur = p.to_local().numel()
            for i in stages:
                cur *= mesh.size(i)
                ag += uses * cur * 2
                n_ag += uses
            g = p.numel()
            for i in reversed(stages):
                g //= mesh.size(i)
                n = 2 if name == "embed" else 1
                rs += n * g * 4
                n_rs += n
    # the K/V: 16 rows a rank, the 4,096 positions gathered, 256 its own
    kv = 16 * 4096 * cfg.n_kv_heads * cfg.head_dim
    ag += cfg.n_layers * 4 * kv * 2
    n_ag += cfg.n_layers * 4
    rs += cfg.n_layers * 2 * kv // 16 * 4
    n_rs += cfg.n_layers * 2
    coll = olmo_train["collectives"]
    assert coll["all-gather"] == {"count": n_ag, "bytes": ag}
    assert coll["reduce-scatter"] == {"count": n_rs, "bytes": rs}
    assert coll["all-to-all"]["count"] == 0
    assert coll["collective-permute"]["count"] == 0


def _cache_bytes(cfg, rules, B: int, S: int) -> int:
    """The bytes of rank 0's K and V blocks: ``cache_axes()`` under
    ``rules`` (divisible_spec: the batch's axes dropped where B does not
    divide them)."""
    from repro_torch.models import transformer as tf
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
    spec = sh.divisible_spec(rules, tf.cache_axes()["k"], shape)
    return 2 * _nbytes(_block(shape, spec, sh.mesh_sizes(rules.mesh)),
                       torch.bfloat16)


def test_run_cell_moe_decode_multi_pod():
    from repro_torch.models import transformer as tf
    rec = run_cell("olmoe-1b-7b", "decode_32k", "multi", save=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_devices"] == 512 and rec["mode"] == "decode"
    cfg = get_arch("olmoe-1b-7b").config()
    with fake_world(512):
        mesh = make_host_mesh((2, 16, 16), ("pod", "data", "model"))
        rules = sh.lm_rules(mesh, training=False, decode=True)
        blocks = _param_blocks(_meta_model(
            lambda g, d: tf.init_params(g, cfg, device=d,
                                        param_dtype=torch.bfloat16)),
            rules, tf.param_axes(cfg))
    params = sum(_nbytes(s, d) for s, d in blocks)
    # the cache's 128 rows over (pod, data) = 32 ranks and its 32,768
    # slots over 16 'model' ranks: (4, 2,048) each
    kv = (cfg.n_layers, 4, 2048, cfg.n_kv_heads, cfg.head_dim)
    assert _cache_bytes(cfg, rules, 128, 32768) == 2 * _nbytes(
        kv, torch.bfloat16)
    want = params + 2 * _nbytes(kv, torch.bfloat16) + 4 + 4 * 1 * 4
    assert rec["memory"]["argument_size_in_bytes"] == want
    assert "batch axes only" not in rec["notes"] and rec["notes"] == ""


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_run_cell_lm_decode_cache_blocks(shape):
    """olmo-1b's decode cells hold rank 0's block of the cache as
    ``cache_axes()`` under the rules give it: ``decode_32k`` its 8 of 128
    rows and 2,048 of 32,768 slots, ``long_500k`` its one row whole and
    2,048 of 524,288 slots (over ("data", "model")); the record's
    argument bytes are those blocks, the bf16 weights' blocks, ``len``
    and the tokens."""
    from repro_torch.models import transformer as tf
    rec = run_cell("olmo-1b", shape, "single", save=False)
    assert rec["status"] == "ok", rec.get("traceback")
    cfg = get_arch("olmo-1b").config()
    spec = cells.LM_SHAPES[shape]
    with fake_world(256):
        mesh = make_host_mesh((16, 16), ("data", "model"))
        rules = sh.lm_rules(mesh, training=False, decode=True,
                            long_context=shape == "long_500k")
        blocks = _param_blocks(_meta_model(
            lambda g, d: tf.init_params(g, cfg, device=d,
                                        param_dtype=torch.bfloat16)),
            rules, tf.param_axes(cfg))
        cache = _cache_bytes(cfg, rules, spec["batch"], spec["seq"])
    rows = spec["batch"] // 16 if shape == "decode_32k" else 1
    assert cache == 2 * _nbytes((cfg.n_layers, rows, 2048, cfg.n_kv_heads,
                                 cfg.head_dim), torch.bfloat16)
    params = sum(_nbytes(s, d) for s, d in blocks)
    assert rec["memory"]["argument_size_in_bytes"] == \
        params + cache + 4 + rows * 4
    # the step writes its cache in place
    assert rec["memory"]["alias_size_in_bytes"] == cache
    assert rec["notes"] == ""


def test_run_cell_recsys_serve_and_graph_train():
    from repro_torch.models import gnn
    from repro_torch.models.recsys import RECSYS, RECSYS_AXES
    rec = run_cell("deepfm", "serve_p99", "single", save=False)
    assert rec["status"] == "ok", rec.get("traceback")
    cfg = get_arch("deepfm").config()
    with fake_world(256):
        mesh = make_host_mesh((16, 16), ("data", "model"))
        rules = sh.recsys_rules(mesh)
        blocks = _param_blocks(_meta_model(
            lambda g, d: RECSYS["deepfm"][0](g, cfg, device=d)), rules,
            RECSYS_AXES["deepfm"](cfg))
    # 512 rows over 16 'data' ranks
    want = sum(_nbytes(s, d) for s, d in blocks) + 32 * cfg.n_fields * 4
    assert rec["memory"]["argument_size_in_bytes"] == want
    assert rec["memory"]["alias_size_in_bytes"] == 0

    rec = run_cell("meshgraphnet", "molecule", "single", save=False)
    assert rec["status"] == "ok", rec.get("traceback")
    spec = cells.GNN_SHAPES["molecule"]
    N, E = 4096, 8192          # 3840 nodes, 8192 edges, padded to 512
    gcfg = get_arch("meshgraphnet").config(node_in=spec["d_feat"],
                                           edge_in=spec["d_edge"],
                                           node_out=spec["node_out"])
    with fake_world(256):
        mesh = make_host_mesh((16, 16), ("data", "model"))
        rules = sh.gnn_rules(mesh)
        blocks = _param_blocks(_meta_model(
            lambda g, d: gnn.init_params(g, gcfg, device=d)), rules,
            gnn.param_axes(gcfg))
    params = sum(_nbytes(s, d) for s, d in blocks)
    # rank 0's blocks of node rows and edge rows: nodes and edges over
    # every mesh axis, 256 ranks
    n, e = N // 256, E // 256
    graph = (n * (spec["d_feat"] + spec["node_out"]) * 4
             + e * spec["d_edge"] * 4 + 2 * e * 4 + n + e)
    assert rec["memory"]["argument_size_in_bytes"] == 3 * params + graph
    assert rec["notes"] == ""


def _ratio(rec: dict) -> float:
    """All ranks' FLOPs over MODEL_FLOPS."""
    return rec["flops"] * rec["n_devices"] / rec["model_flops"]


@pytest.mark.parametrize("shape", list(cells.GNN_SHAPES))
def test_graph_cells_are_partitioned(shape):
    """Nodes and edges over every mesh axis, on both meshes: all ranks'
    FLOPs come to MODEL_FLOPS (at most 1.2x; every rank running the whole
    graph read 253-512x), every cell fits an 80 GB card (ogb_products too,
    4,258.8 GiB a rank whole), and each layer all-gathers the node states
    (forward) and the aggregate's gradient (backward), N x 128 fp32 each,
    and reduce-scatters the aggregate and the states' gradient."""
    cfg = get_arch("meshgraphnet").config()
    N, _ = cells._gnn_geometry(cells.GNN_SHAPES[shape])
    N = -(-N // 512) * 512
    for mk in ("single", "multi"):
        rec = run_cell("meshgraphnet", shape, mk, save=False)
        assert rec["status"] == "ok", rec.get("traceback")
        assert _ratio(rec) <= 1.2, (mk, _ratio(rec))
        assert dryrun.per_device_gib(rec) * 2 ** 30 < 80e9, mk
        coll = rec["collectives"]
        layers = 2 * cfg.n_layers
        assert coll["all-gather"]["bytes"] >= layers * N * cfg.d_hidden * 4
        assert coll["reduce-scatter"]["count"] >= layers


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-scout-17b-a16e"])
def test_moe_decode_keeps_the_experts_split(arch):
    """A decode step's one-token groups take no all-to-all: the experts
    stay split over 'model' (each rank runs its own), so the step
    all-gathers no expert weight (at most 0.01 GB, from 12.9 GB for olmoe
    and 193 GB for llama4-scout gathered whole) and all-reduces each
    layer's partial outputs, fp32, over its rows."""
    cfg = get_arch(arch).config()
    for mk, rows in (("single", 128 // 16), ("multi", 128 // 32)):
        rec = run_cell(arch, "decode_32k", mk, save=False)
        assert rec["status"] == "ok", rec.get("traceback")
        coll = rec["collectives"]
        assert coll["all-gather"]["bytes"] <= 0.01e9, (mk, coll)
        assert coll["all-reduce"]["bytes"] >= \
            cfg.n_layers * rows * cfg.d_model * 4, (mk, coll)


def test_run_cell_retrieval_without_a_shard():
    rec = run_cell("asc-splade", "serve_k10", "multi", save=False)
    assert rec["status"] == "ok", rec.get("traceback")
    icfg = get_arch("asc-splade").config()
    m, dp, tp, V = 4096 // 32, icfg.d_pad, icfg.t_pad, icfg.vocab
    S, cap = cells.coarse_geometry(icfg.m)
    shard = (m * dp * tp * (2 + 1) + m * dp * (1 + 3 * 4)
             + m * (icfg.n_seg + 1) * (V + 4) + 4 * m * 3 + 4
             + S * cap * 4 + S * (icfg.n_seg + 1) * V)
    b, k = 256 // 16, 10
    assert rec["memory"]["argument_size_in_bytes"] == \
        shard + b * icfg.q_pad * (4 + 4 + 1)
    assert rec["memory"]["temp_size_in_bytes"] is None
    assert rec["flops"] is None
    # per cluster axis (pod, data): the scores' and ids' gathers and the
    # counters' sum; over 'model': ids, scores and counters gathered
    gather = 2 * 2 * b * k * 4 + 16 * 2 * b * k * 4 + 2 * 16 * b * k * 4 \
        + 16 * 9 * b * 4
    assert rec["collectives"] == _expect(all_gather=(7, gather),
                                         all_reduce=(2, 2 * 7 * b * 4))


def test_train_step_frees_its_tensors_without_the_cycle_collector():
    """A step's gradients and updates die when it returns: before the
    tree walkers stopped being recursive closures (a function and its own
    cell: a reference cycle), their lists stayed alive until the cyclic
    collector ran (DLRM: two blocks of its table, 2 x 3.33 GB, into the
    next step)."""
    from repro_torch.launch.mesh import make_production_mesh
    gc.collect()
    gc.disable()
    try:
        with fake_world(256):
            mesh = make_production_mesh(device_type="cpu")
            prog = cells.build_cell("dlrm-mlperf", "train_batch", mesh,
                                    False).build("meta")
            live = LiveBytes(dryrun.tensors(prog.args))
            with live:
                out = prog.run()
            del out
            assert live.peak > 10 * 2 ** 30 and live.live == 0
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# the CLI, the example, the group cache
# ---------------------------------------------------------------------------

KEYS = {"arch", "shape", "mesh", "n_devices", "device", "status", "mode",
        "model_flops", "notes", "build_s", "run_s", "total_s", "memory",
        "flops", "flops_total", "bytes_accessed", "bytes_total",
        "hlo_lines", "collectives", "collectives_total"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "generated_code_size_in_bytes",
               "alias_size_in_bytes"}


def test_cli_lines_and_record_keys(tmp_path, capsys):
    argv = ["--arch", "deepfm", "--shape", "serve_p99", "--mesh", "both",
            "--out-dir", str(tmp_path)]
    dryrun.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    for line, mk in zip(lines, ("single", "multi")):
        assert re.fullmatch(
            rf"\[OK \] deepfm {{17}}serve_p99 {{6}}{mk} +run=\d+\.\ds "
            rf"mem/dev=\d+\.\d\dGiB flops=\d\.\d+e\+\d\d", line), line
    assert lines[-1] == "done: ok=2 fail=0 skipped=0"
    for mk in ("single", "multi"):
        rec = json.loads((tmp_path / f"deepfm__serve_p99__{mk}.json")
                         .read_text())
        assert set(rec) == KEYS and set(rec["memory"]) == MEMORY_KEYS
        assert set(rec["collectives"]) == set(COLLECTIVES)
        assert rec["memory"]["generated_code_size_in_bytes"] == 0
    dryrun.main(argv)
    assert capsys.readouterr().out.strip() == \
        "done: ok=0 fail=0 skipped=2"
    dryrun.main(["--table", "--out-dir", str(tmp_path)])
    rows = capsys.readouterr().out.strip().splitlines()
    assert len(rows) == 3 and rows[2].startswith(
        "| deepfm serve_p99 | 0.10 / 0.10 | yes / yes | 15.97 / 15.97 |")


def test_multipod_launch_lines(capsys):
    from repro_torch.examples import multipod_launch
    rec = multipod_launch.main(["--arch", "deepfm", "--shape", "serve_p99",
                                "--mesh", "multi"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == ("deepfm x serve_p99 on the 2x16x16 multi-pod mesh "
                      "(512 ranks):")
    gib = dryrun.per_device_gib(rec)
    assert out[3] == (f"  memory/device       {gib:.2f} GiB "
                      f"(fits an 80 GB H100: True)")
    assert out[4] == f"  FLOPs/device        {rec['flops']:.3e}"
    assert out[5] == "  collective schedule:"
    coll = rec["collectives"]
    assert out[6:] == [f"    {k:20s} x{v['count']:<4d} "
                       f"{v['bytes'] / 2**20:10.1f} MiB"
                       for k, v in coll.items() if v["count"]]


def test_group_cache_does_not_outlive_its_mesh():
    axes = ("pod", "data")
    with fake_world(8):
        first = make_host_mesh((2, 2, 2), ("pod", "data", "model"))
        assert dist.get_world_size(par.group(first, axes)) == 4
    del first
    gc.collect()
    with fake_world(16):
        second = make_host_mesh((2, 4, 2), ("pod", "data", "model"))
        g = par.group(second, axes)
        assert dist.get_world_size(g) == 8
        x = torch.ones(2)
        dist.all_reduce(x, group=g)
