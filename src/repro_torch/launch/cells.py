"""Cell definitions: (architecture x input shape) -> rank 0's program
(PyTorch port of ``repro/launch/cells.py``).

``build_cell(arch, shape, mesh, multi_pod)`` returns a :class:`CellPlan`:
the mode, the ambient sharding rules, MODEL_FLOPS (the hand-counted
useful FLOPs, the reference's formulas verbatim) and ``build(device)``,
which makes rank ``dist.get_rank()``'s program on ``device``.

Where the reference lowers one program over the whole mesh from abstract
shapes, the port runs one process a rank (``distributed/parallelize.py``),
so a cell is the program of one rank of the mesh: the model built from
shapes (``models/layers.shapes_only``) and placed by ``par.shard_module``
(parameters are ``DTensor``s holding this rank's block), the optimizer
state over those blocks, and this rank's block of the batch or cache.
On the meta device nothing is allocated and nothing computes; on a real
device the blocks are drawn from a seeded generator (ids within their
tables) after the layout was made on meta, so no rank ever holds a whole
production tensor. :class:`Program` is the callable that runs the step
once, its arguments, and each argument leaf's placement
(``sh.shard_with_shapes``: the block rank 0 holds).

The choices are the reference's: float32 masters for training and
bfloat16 weights for serving, ``lm_rules(..., long_context=(shape ==
"long_500k"), decode=...)``, AdamW on ``cosine_schedule(3e-4, 100,
1000)`` for the LMs and ``cosine_schedule(1e-4, 100, 1000)`` for the
graph, row-wise Adagrad at 0.01 for DLRM and DeepFM and AdamW at 1e-3
for DIN and BERT4Rec, a bfloat16 KV cache. A graph cell's rank holds its
block of the padded graph's node rows and edge rows (``gnn_rules`` split
both over every mesh axis; ``models/gnn.py``). Where the port's program
differs from the reference's, the cell says so in ``notes`` (the
retrieval cells).

The reference's ``unroll`` argument is gone: it exists because XLA's
cost analysis counts a scanned loop body once, so the reference compiles
a second, unrolled program to extrapolate per-layer costs. The port runs
every layer eagerly and counts each, so ``flops_total == flops``.

Shape sets follow the reference's table verbatim; ``molecule`` is
flattened to one disjoint-union graph, ``minibatch_lg`` uses the
neighbour-sampler output geometry (seeds + fanout 15-10), and the
encoder-only and recsys archs have no decode cells by construction.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch import nn

from repro_torch.configs import arch_kind, get_arch
from repro_torch.distributed import parallelize as par
from repro_torch.distributed import sharding as sh
from repro_torch.models.layers import shapes_only
from repro_torch.training import optimizer as opt_lib

I32, F32, BF16, BOOL = torch.int32, torch.float32, torch.bfloat16, torch.bool


LM_SHAPES = {
    "train_4k": {"mode": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"mode": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"mode": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"mode": "decode", "seq": 524288, "batch": 1},
}

GNN_SHAPES = {
    # Cora-geometry full batch
    "full_graph_sm": {"mode": "train", "n_nodes": 2708, "n_edges": 10556,
                      "d_feat": 1433, "d_edge": 16, "node_out": 7},
    # Reddit-geometry sampled training: seeds + fanout (15, 10)
    "minibatch_lg": {"mode": "train", "batch_nodes": 1024,
                     "fanout": (15, 10), "d_feat": 602, "d_edge": 16,
                     "node_out": 41},
    # ogbn-products full batch
    "ogb_products": {"mode": "train", "n_nodes": 2_449_029,
                     "n_edges": 61_859_140, "d_feat": 100, "d_edge": 8,
                     "node_out": 47},
    # 128 molecules of 30 nodes / 64 edges, disjoint union
    "molecule": {"mode": "train", "n_graphs": 128, "nodes_per": 30,
                 "edges_per": 64, "d_feat": 16, "d_edge": 8, "node_out": 3},
}

RECSYS_SHAPES = {
    "train_batch": {"mode": "train", "batch": 65536},
    "serve_p99": {"mode": "serve", "batch": 512},
    "serve_bulk": {"mode": "serve", "batch": 262144},
    "retrieval_cand": {"mode": "retrieval", "batch": 1,
                       "n_candidates": 1_000_000},
}

RETRIEVAL_SHAPES = {
    "serve_k10": {"mode": "retrieve", "batch": 256, "k": 10},
    "serve_k1000": {"mode": "retrieve", "batch": 64, "k": 1000},
}

SHAPES_BY_KIND = {"lm": LM_SHAPES, "gnn": GNN_SHAPES,
                  "recsys": RECSYS_SHAPES, "retrieval": RETRIEVAL_SHAPES}


def shapes_for(arch: str) -> list[str]:
    return list(SHAPES_BY_KIND[arch_kind(arch)])


def all_cells() -> list[tuple[str, str]]:
    from repro_torch.configs import list_archs
    return [(arch, shape) for arch in list_archs()
            for shape in shapes_for(arch)]


def layer_count(arch: str) -> int:
    if arch_kind(arch) in ("lm", "gnn"):
        return get_arch(arch).config().n_layers
    return 1


def _mlp_flops(dims) -> float:
    return 2.0 * sum(float(dims[i]) * dims[i + 1]
                     for i in range(len(dims) - 1))


def _gnn_geometry(spec: dict) -> tuple[int, int]:
    if "n_nodes" in spec:
        return spec["n_nodes"], spec["n_edges"]
    if "batch_nodes" in spec:                      # sampled minibatch
        n, e = spec["batch_nodes"], 0
        frontier = spec["batch_nodes"]
        for f in spec["fanout"]:
            e += frontier * f
            frontier *= f
            n += frontier
        return n, e
    n = spec["n_graphs"] * spec["nodes_per"]       # molecule union
    e = spec["n_graphs"] * spec["edges_per"]
    return n, e


# ===========================================================================
# Programs
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class Leaf:
    """One batch or cache tensor of the whole step: its shape and dtype,
    the exclusive bound of its values (ids: the table they index, a
    float mask: 2; None: floats drawn normal, bools True, ints 0), the
    dim split over the batch axes (None: every rank holds it whole) and
    the dim split over the sequence's axes (None: none)."""
    shape: tuple
    dtype: torch.dtype
    high: int | None = None
    dim: int | None = 0
    seq: int | None = None


@dataclasses.dataclass
class Program:
    """Rank 0's step: ``run()`` calls ``fn(*args)`` once under
    ``layout``, with autograd on for a training step only (serving keeps
    no activations for a backward pass). ``in_shardings`` mirrors
    ``args`` with each leaf's ``NamedSharding`` (the block this rank
    holds)."""
    fn: Callable
    args: tuple
    in_shardings: tuple
    layout: par.Layout | None
    train: bool = False

    def run(self):
        with par.use_layout(self.layout), torch.set_grad_enabled(self.train):
            return self.fn(*self.args)


@dataclasses.dataclass
class CellPlan:
    arch: str
    shape: str
    mode: str
    rules: sh.ShardingRules
    model_flops: float
    build: Callable[..., Program]     # build(device) -> Program
    notes: str = ""


def _gen(device: torch.device, seed: int) -> torch.Generator | None:
    return (None if device.type == "meta"
            else torch.Generator(device=device).manual_seed(seed))


def _fill(t: torch.Tensor, gen, high: int | None = None) -> torch.Tensor:
    """``t`` (fresh, on a real device) filled in place: ids (and a float
    mask) uniform below ``high``, other floats normal with std 0.02,
    bools True."""
    if gen is None:
        return t
    if t.dtype == BOOL:
        return t.fill_(True)
    if t.is_floating_point():
        # a float with a bound: a 0/1 mask
        return (t.random_(0, high, generator=gen) if high
                else t.normal_(0.0, 0.02, generator=gen))
    return t.random_(0, high, generator=gen) if high else t.zero_()


def _split_axes(layout_axes: tuple, mesh, rows: int) -> tuple:
    """The batch axes a leading dim of ``rows`` is split over: all of
    them, or none when ``rows`` does not divide them (the reference's
    replicated fallback, ``par.local_batch``)."""
    n = par.axes_size(mesh, layout_axes) if layout_axes else 1
    return layout_axes if n > 1 and rows % n == 0 else ()


def make_leaves(leaves: dict, mesh, axes: tuple, device, gen,
                seq_axes: tuple = ()) -> tuple[dict, dict]:
    """(this rank's block of each leaf on ``device``, its NamedSharding):
    a split leaf keeps its chunk of ``leaf.dim`` over ``axes`` and of
    ``leaf.seq`` over ``seq_axes``; the others stay whole."""
    out, shard = {}, {}
    for k, leaf in leaves.items():
        shape, spec = list(leaf.shape), [None] * len(leaf.shape)
        for d, ax in ((leaf.dim, axes), (leaf.seq, seq_axes)):
            if d is not None and ax:
                shape[d] //= par.axes_size(mesh, ax)
                spec[d] = ax if len(ax) > 1 else ax[0]
        out[k] = _fill(torch.empty(shape, dtype=leaf.dtype, device=device),
                       gen, leaf.high)
        shard[k] = sh.NamedSharding(mesh, sh.P(*spec))
    return out, shard


def materialize(model: nn.Module, device: torch.device, gen) -> nn.Module:
    """Each parameter of ``model`` (built and sharded on meta) replaced
    by a tensor of its block's shape on ``device``, drawn from ``gen``:
    only this rank's blocks are made real. A no-op on meta."""
    if gen is None:
        return model
    from torch.distributed.tensor import DTensor
    for mod in model.modules():
        for name, p in list(mod._parameters.items()):
            if p is None:
                continue
            local = p.to_local() if isinstance(p, DTensor) else p
            real = _fill(torch.empty(local.shape, dtype=local.dtype,
                                     device=device), gen)
            if isinstance(p, DTensor):
                real = DTensor.from_local(real, p.device_mesh, p.placements,
                                          run_check=False, shape=p.shape,
                                          stride=p.stride())
            mod._parameters[name] = nn.Parameter(
                real, requires_grad=p.requires_grad)
    return model


def sharding_of(t) -> sh.NamedSharding | None:
    """The ``NamedSharding`` of a ``DTensor``'s placements (a dim split
    over several mesh dims names them in mesh order); None for a plain
    tensor."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor):
        return None
    mesh = t.device_mesh
    spec: list = [()] * t.dim()
    for name, p in zip(mesh.mesh_dim_names, t.placements):
        if isinstance(p, Shard):
            spec[p.dim] += (name,)
    return sh.NamedSharding(mesh, sh.P(*(
        None if not e else (e[0] if len(e) == 1 else e) for e in spec)))


def placed_model(init: Callable, axes_tree, rules: sh.ShardingRules,
                 device, gen) -> tuple[nn.Module, Any]:
    """(the model built from shapes and sharded by ``rules``, rank 0's
    blocks made real on ``device``; each parameter leaf's sharding in the
    reference's layout)."""
    from repro_torch.convert import reference_view
    with shapes_only():
        model = init(torch.Generator().manual_seed(0), "meta")
    par.shard_module(model, rules, axes_tree)
    shard = sh.shard_with_shapes(rules, axes_tree, reference_view(model))
    return materialize(model, device, gen), shard


def _train_program(model, p_shard, loss_fn, optimizer, batch: dict,
                   b_shard: dict, layout: par.Layout) -> Program:
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    from repro_torch.training.tree import module_tree, tree_map
    opt_state = optimizer.init(module_tree(model))
    step = make_train_step(loss_fn, optimizer, TrainConfig(), layout=layout,
                           batch_is_local=True)
    return Program(step, (model, opt_state, batch, 0),
                   (p_shard, tree_map(sharding_of, opt_state), b_shard,
                    None), layout, train=True)


# ===========================================================================
# LM cells
# ===========================================================================

def _build_lm(arch: str, shape: str, mesh, multi_pod: bool) -> CellPlan:
    from repro_torch.models import transformer as tf
    spec = LM_SHAPES[shape]
    cfg = get_arch(arch).config()
    mode = spec["mode"]
    B, S = spec["batch"], spec["seq"]
    rules = sh.lm_rules(mesh, training=(mode == "train"),
                        long_context=(shape == "long_500k"),
                        decode=(mode == "decode"))
    n_act = cfg.active_param_count()
    L, h, d = cfg.n_layers, cfg.n_heads, cfg.head_dim
    # training holds float32 masters; serving artifacts are bfloat16
    param_dtype = F32 if mode == "train" else BF16
    batch_axes = _split_axes(par.batch_axes_of(rules), mesh, B)
    layout = par.Layout(rules, batch_axes)

    def model_on(device, gen):
        return placed_model(
            lambda g, dev: tf.init_params(g, cfg, device=dev,
                                          param_dtype=param_dtype),
            tf.param_axes(cfg), rules, device, gen)

    seq_axes = layout.seq_axes
    if mode == "train":
        def build(device, seed: int = 0) -> Program:
            device = torch.device(device)
            gen = _gen(device, seed)
            model, p_shard = model_on(device, gen)
            batch, b_shard = make_leaves(
                {"tokens": Leaf((B, S), I32, cfg.vocab, seq=1),
                 "labels": Leaf((B, S), I32, cfg.vocab, seq=1),
                 "mask": Leaf((B, S), F32, high=2, seq=1)}, mesh,
                batch_axes, device, gen, seq_axes)
            optimizer = opt_lib.adamw(opt_lib.cosine_schedule(3e-4, 100,
                                                              1000))
            return _train_program(model, p_shard, tf.loss_fn, optimizer,
                                  batch, b_shard, layout)
        flops = 6.0 * n_act * B * S + 6.0 * B * S * S * h * d * L
        return CellPlan(arch, shape, mode, rules, flops, build)

    if mode == "prefill":
        def build(device, seed: int = 0) -> Program:
            device = torch.device(device)
            gen = _gen(device, seed)
            model, p_shard = model_on(device, gen)
            toks, t_shard = make_leaves(
                {"tokens": Leaf((B, S), I32, cfg.vocab, seq=1)}, mesh,
                batch_axes, device, gen, seq_axes)
            return Program(tf.prefill, (model, toks["tokens"]),
                           (p_shard, t_shard["tokens"]), layout)
        flops = 2.0 * n_act * B * S + 2.0 * B * S * S * h * d * L
        return CellPlan(arch, shape, mode, rules, flops, build)

    # decode: one step at a full bfloat16 cache, its sequence split over
    # the cache's axes ('model'; ("data", "model") for long_500k)
    cache_axes = par.spec_axes(rules, "batch", "cache_seq")

    def build(device, seed: int = 0) -> Program:
        device = torch.device(device)
        gen = _gen(device, seed)
        model, p_shard = model_on(device, gen)
        kv = Leaf((L, B, S, cfg.n_kv_heads, d), BF16, dim=1, seq=2)
        cache, c_shard = make_leaves(
            {"k": kv, "v": kv, "len": Leaf((), I32, dim=None)}, mesh,
            batch_axes, device, gen, cache_axes)
        toks, t_shard = make_leaves(
            {"tokens": Leaf((B, 1), I32, cfg.vocab)}, mesh, batch_axes,
            device, gen)
        return Program(tf.decode_step, (model, cache, toks["tokens"]),
                       (p_shard, c_shard, t_shard["tokens"]), layout)
    flops = 2.0 * n_act * B + 4.0 * B * S * cfg.n_kv_heads * d * (
        cfg.n_heads // cfg.n_kv_heads) * L
    return CellPlan(arch, shape, mode, rules, flops, build)


# ===========================================================================
# GNN cells
# ===========================================================================

def _build_gnn(arch: str, shape: str, mesh, multi_pod: bool) -> CellPlan:
    from repro_torch.models import gnn
    spec = GNN_SHAPES[shape]
    N, E = _gnn_geometry(spec)
    # pad node/edge counts to the shard grid (the data pipeline emits
    # masked padding nodes/edges); 512 = lcm of both production meshes'
    # combined data axes
    N, E = -(-N // 512) * 512, -(-E // 512) * 512
    cfg = get_arch(arch).config(node_in=spec["d_feat"],
                                edge_in=spec["d_edge"],
                                node_out=spec["node_out"])
    rules = sh.gnn_rules(mesh)
    # nodes and edges over every mesh axis: rank 0's blocks of both
    axes = _split_axes(par.batch_axes_of(rules), mesh, N)
    layout = par.Layout(rules, axes)

    def build(device, seed: int = 0) -> Program:
        device = torch.device(device)
        gen = _gen(device, seed)
        model, p_shard = placed_model(
            lambda g, dev: gnn.init_params(g, cfg, device=dev),
            gnn.param_axes(cfg), rules, device, gen)
        graph, g_shard = make_leaves(
            {"node_feat": Leaf((N, spec["d_feat"]), F32),
             "edge_feat": Leaf((E, spec["d_edge"]), F32),
             "senders": Leaf((E,), I32, N), "receivers": Leaf((E,), I32, N),
             "node_mask": Leaf((N,), BOOL), "edge_mask": Leaf((E,), BOOL),
             "target": Leaf((N, spec["node_out"]), F32)},
            mesh, axes, device, gen)
        optimizer = opt_lib.adamw(opt_lib.cosine_schedule(1e-4, 100, 1000))
        return _train_program(model, p_shard, gnn.loss_fn, optimizer, graph,
                              g_shard, layout)

    d = cfg.d_hidden
    hid = [d] * cfg.mlp_layers
    fwd = (N * _mlp_flops([cfg.node_in] + hid + [d])
           + E * _mlp_flops([cfg.edge_in] + hid + [d])
           + cfg.n_layers * (E * _mlp_flops([3 * d] + hid + [d])
                             + N * _mlp_flops([2 * d] + hid + [d]))
           + N * _mlp_flops([d] + hid + [cfg.node_out]))
    return CellPlan(arch, shape, "train", rules, 3.0 * fwd, build)


# ===========================================================================
# RecSys cells
# ===========================================================================

def _recsys_batch_shapes(arch: str, cfg, B: int) -> tuple[dict, float]:
    """(leaves, fwd_flops_per_sample) for a training/serving batch of the
    given arch."""
    if arch == "dlrm-mlperf":
        leaves = {"dense": Leaf((B, cfg.n_dense), F32),
                  "sparse": Leaf((B, cfg.n_sparse), I32,
                                 cfg.vocab_per_table),
                  "labels": Leaf((B,), F32, 2)}
        f = cfg.n_sparse + 1
        fwd = (_mlp_flops([cfg.n_dense, *cfg.bot_mlp])
               + _mlp_flops([cfg.top_in, *cfg.top_mlp])
               + 2.0 * f * f * cfg.embed_dim)
    elif arch == "din":
        L = cfg.seq_len
        leaves = {"hist_items": Leaf((B, L), I32, cfg.n_items),
                  "hist_cates": Leaf((B, L), I32, cfg.n_cates),
                  "hist_mask": Leaf((B, L), BOOL),
                  "target_item": Leaf((B,), I32, cfg.n_items),
                  "target_cate": Leaf((B,), I32, cfg.n_cates),
                  "labels": Leaf((B,), F32, 2)}
        fdim = cfg.feat_dim
        fwd = (L * _mlp_flops([4 * fdim, *cfg.attn_mlp, 1])
               + _mlp_flops([3 * fdim, *cfg.mlp, 1]) + 2.0 * L * fdim)
    elif arch == "deepfm":
        leaves = {"fields": Leaf((B, cfg.n_fields), I32,
                                 cfg.vocab_per_field),
                  "labels": Leaf((B,), F32, 2)}
        fwd = (_mlp_flops([cfg.n_fields * cfg.embed_dim, *cfg.mlp, 1])
               + 4.0 * cfg.n_fields * cfg.embed_dim)
    elif arch == "bert4rec":
        L, D = cfg.seq_len, cfg.embed_dim
        leaves = {"items": Leaf((B, L), I32, cfg.n_items + 1),
                  "mask": Leaf((B, L), BOOL),
                  "labels": Leaf((B, L), I32, cfg.n_items),
                  "label_mask": Leaf((B, L), BOOL),
                  "negatives": Leaf((cfg.n_negatives,), I32, cfg.n_items,
                                    dim=None)}
        per_tok = 8.0 * D * D + 4.0 * D * L + 2.0 * 8 * D * D
        fwd = cfg.n_blocks * L * per_tok \
            + L * 2.0 * D * (1 + cfg.n_negatives)
    else:
        raise KeyError(arch)
    return leaves, fwd


def _retrieval_leaves(arch: str, cfg, C: int) -> tuple[dict, float]:
    """(leaves, fwd_flops_per_candidate) of one user against ``C``
    candidates: the user's tensors whole on every rank, the candidates
    split over the rules' 'candidates' axes."""
    if arch == "dlrm-mlperf":
        one = {"dense": Leaf((1, cfg.n_dense), F32),
               "sparse": Leaf((1, cfg.n_sparse), I32, cfg.vocab_per_table)}
        cand = {"cand_ids": Leaf((C,), I32, cfg.vocab_per_table)}
        fwd = _recsys_batch_shapes(arch, cfg, 1)[1]
    elif arch == "din":
        L = cfg.seq_len
        one = {"hist_items": Leaf((1, L), I32, cfg.n_items),
               "hist_cates": Leaf((1, L), I32, cfg.n_cates),
               "hist_mask": Leaf((1, L), BOOL)}
        cand = {"cand_items": Leaf((C,), I32, cfg.n_items),
                "cand_cates": Leaf((C,), I32, cfg.n_cates)}
        fwd = _recsys_batch_shapes(arch, cfg, 1)[1]
    elif arch == "deepfm":
        one = {"fields": Leaf((1, cfg.n_fields), I32, cfg.vocab_per_field)}
        cand = {"cand_ids": Leaf((C,), I32, cfg.vocab_per_field)}
        fwd = _recsys_batch_shapes(arch, cfg, 1)[1]
    else:  # bert4rec: encode once + 1M dots
        L = cfg.seq_len
        one = {"items": Leaf((1, L), I32, cfg.n_items + 1),
               "mask": Leaf((1, L), BOOL)}
        cand = {"cand_ids": Leaf((C,), I32, cfg.n_items)}
        fwd = 2.0 * cfg.embed_dim       # per-candidate: one D-dim dot
    return {**{k: dataclasses.replace(v, dim=None) for k, v in one.items()},
            **cand}, fwd


def _build_recsys(arch: str, shape: str, mesh, multi_pod: bool) -> CellPlan:
    from repro_torch.models.recsys import RECSYS, RECSYS_AXES
    spec = RECSYS_SHAPES[shape]
    cfg = get_arch(arch).config()
    mode = spec["mode"]
    rules = sh.recsys_rules(mesh)
    B = spec["batch"]
    init_fn, fwd_fn, loss_fn, retr_fn = RECSYS[arch]
    axes_tree = RECSYS_AXES[arch](cfg)

    def model_on(device, gen):
        return placed_model(lambda g, dev: init_fn(g, cfg, device=dev),
                            axes_tree, rules, device, gen)

    if mode == "retrieval":
        C = spec["n_candidates"]
        leaves, fwd = _retrieval_leaves(arch, cfg, C)
        axes = _split_axes(tuple(sh.entry_axes(rules.spec("candidates")[0])),
                           mesh, C)
        flops = fwd * C
    else:
        leaves, fwd = _recsys_batch_shapes(arch, cfg, B)
        if mode == "serve":
            leaves.pop("labels")
            if arch == "bert4rec":
                leaves.pop("label_mask"), leaves.pop("negatives")
        axes = _split_axes(par.batch_axes_of(rules), mesh, B)
        flops = (3.0 if mode == "train" else 1.0) * fwd * B
    layout = par.Layout(rules, axes)

    def build(device, seed: int = 0) -> Program:
        device = torch.device(device)
        gen = _gen(device, seed)
        model, p_shard = model_on(device, gen)
        batch, b_shard = make_leaves(leaves, mesh, axes, device, gen)
        if mode == "train":
            # row-wise adagrad on the big tables (the MLPerf recipe) for
            # DLRM and DeepFM; AdamW elsewhere (tables are small)
            optimizer = (opt_lib.rowwise_adagrad(opt_lib.constant_schedule(
                0.01)) if arch in ("dlrm-mlperf", "deepfm")
                else opt_lib.adamw(opt_lib.constant_schedule(1e-3)))
            return _train_program(model, p_shard, loss_fn, optimizer, batch,
                                  b_shard, layout)
        fn = retr_fn if mode == "retrieval" else fwd_fn
        return Program(fn, (model, batch), (p_shard, b_shard), layout)

    return CellPlan(arch, shape, mode, rules, flops, build)


# ===========================================================================
# ASC retrieval cells (the paper's architecture)
# ===========================================================================

def coarse_geometry(m: int) -> tuple[int, int]:
    """(S, cap) of a global index of ``m`` clusters: ``ceil(sqrt(m))``
    superblocks of at most ``ceil(m / S)`` members
    (``core/index.py::group_superblocks``)."""
    S = max(1, math.ceil(math.sqrt(m)))
    return S, -(-m // S)


def _build_retrieval(arch: str, shape: str, mesh,
                     multi_pod: bool) -> CellPlan:
    from repro_torch.core.search import SearchConfig
    from repro_torch.core.types import INDEX_FIELDS, ClusterIndex, \
        QueryBatch
    from repro_torch.serving import engine
    spec = RETRIEVAL_SHAPES[shape]
    icfg = get_arch(arch).config()
    rules = sh.retrieval_rules(mesh)
    B = spec["batch"]
    m, n_seg, V = icfg.m, icfg.n_seg, icfg.vocab
    dp, tp, qp = icfg.d_pad, icfg.t_pad, icfg.q_pad
    S, cap = coarse_geometry(m)
    c_axes = engine._cluster_axes(multi_pod)
    n_blocks = par.axes_size(mesh, c_axes)
    n_model = sh.mesh_sizes(mesh)["model"]
    m_local, b_local = m // n_blocks, B // n_model
    tid_dtype = I32 if V >= 2 ** 16 else torch.uint16
    # the global shapes; a split field's leading (cluster) dim is this
    # rank's block
    shapes = {"doc_tids": ((m, dp, tp), tid_dtype),
              "doc_tw": ((m, dp, tp), torch.uint8),
              "doc_mask": ((m, dp), BOOL), "doc_ids": ((m, dp), I32),
              "doc_seg": ((m, dp), I32), "doc_seg_mod": ((m, dp), I32),
              "seg_max_stacked": ((m, n_seg + 1, V), torch.uint8),
              "seg_offsets": ((m, n_seg + 1), I32),
              "sorted_upto": ((m,), I32), "scale": ((), F32),
              "cluster_ndocs": ((m,), I32), "super_of": ((m,), I32),
              "super_members": ((S, cap), I32),
              "super_max_stacked": ((S, n_seg + 1, V), torch.uint8)}
    scfg = SearchConfig(k=spec["k"], mu=icfg.mu, eta=icfg.eta,
                        method="asc", group_size=icfg.group_size,
                        bounds_impl="gemm")

    def build(device, seed: int = 0, index: ClusterIndex | None = None
              ) -> Program:
        """``index``: this rank's shard to search (its fields at the
        shapes above); None builds it from shapes (on meta only: the
        search cannot run there)."""
        device = torch.device(device)
        specs = engine.index_shard_specs(None, multi_pod)
        if index is None:
            index = ClusterIndex(
                **{f: torch.empty(((m_local,) + shp[1:]) if specs[f]
                                  else shp, dtype=dt, device=device)
                   for f, (shp, dt) in shapes.items()},
                vocab=V, n_seg=n_seg)
        for f in INDEX_FIELDS:
            shp, dt = shapes[f]
            want = ((m_local,) + shp[1:]) if specs[f] else shp
            got = getattr(index, f)
            if tuple(got.shape) != want or got.dtype != dt:
                raise ValueError(f"shard field {f}: {tuple(got.shape)} "
                                 f"{got.dtype}, a rank of this cell holds "
                                 f"{want} {dt}")
        i_shard = {f: sh.NamedSharding(mesh, sh.P(
            *(((c_axes if len(c_axes) > 1 else c_axes[0]),) if specs[f]
              else ()), *([None] * (len(shapes[f][0]) - bool(specs[f])))))
            for f in INDEX_FIELDS}
        gen = _gen(device, seed)
        q = QueryBatch(tids=torch.empty((b_local, qp), dtype=I32,
                                        device=device),
                       tw=torch.empty((b_local, qp), device=device),
                       mask=torch.ones((b_local, qp), dtype=BOOL,
                                       device=device), vocab=V)
        if gen is not None:
            # qp distinct terms a query, weights in (0, 1)
            q.tids.copy_(torch.rand((b_local, V), generator=gen,
                                    device=device).argsort(1)[:, :qp])
            q.tw.uniform_(0.05, 1.0, generator=gen)
        q_shard = {k: sh.NamedSharding(mesh, sh.P("model", None))
                   for k in ("tids", "tw", "mask")}

        def fn(idx, q_local):
            # every 'model' rank's rows are this block, so the rank's
            # slice of the whole batch (by its 'model' coordinate) is it
            whole = QueryBatch(tids=q_local.tids.repeat(n_model, 1),
                               tw=q_local.tw.repeat(n_model, 1),
                               mask=q_local.mask.repeat(n_model, 1),
                               vocab=V)
            return engine.distributed_retrieve(idx, whole, scfg, mesh,
                                               multi_pod=multi_pod)
        return Program(fn, (index, q), (i_shard, q_shard), None)

    # useful work: bounds for all clusters + exhaustive scoring upper bound
    flops = B * (2.0 * m * n_seg * qp + 2.0 * icfg.n_docs * tp)
    return CellPlan(arch, shape, "retrieve", rules, flops, build,
                    notes="the search syncs with the host every wave, so "
                          "it runs only on a real shard; FLOPs count the "
                          "ATen products only, not the CUDA kernels")


def build_cell(arch: str, shape: str, mesh,
               multi_pod: bool = False) -> CellPlan:
    kind = arch_kind(arch)
    builder = {"lm": _build_lm, "gnn": _build_gnn, "recsys": _build_recsys,
               "retrieval": _build_retrieval}[kind]
    return builder(arch, shape, mesh, multi_pod)
