"""MeshGraphNet (Pfaff et al., arXiv:2010.03409): encode-process-decode
MPNN with edge and node MLP updates and sum aggregation (PyTorch port of
``repro/models/gnn.py``).

Graphs are padded-dense: {node_feat, edge_feat, senders, receivers,
node_mask, edge_mask}; batched small graphs (the molecule shape) are
flattened into one disjoint union by the data layer. Message passing
gathers ``h[senders]`` and ``h[receivers]`` and sums each edge's message
into its receiver with ``models/embedding.segment_sum`` (``index_add``).

Determinism: on the card ``index_add`` sums with float atomics unless
``torch.use_deterministic_algorithms(True)`` is on; then PyTorch routes
it through the sorting ``index_put_(accumulate=True)``, as it does the
gathers' backward, and a step gives the same bits on every run (a
resumed ``fit`` equals an uninterrupted one). The CPU sums in edge order
either way.

The model is a :class:`~repro_torch.models.layers.TreeModel` with the
reference's names, one module a processor layer where the reference
stacks the layers (``convert.gnn_params_from_arrays`` carries a JAX tree
across). ``unroll`` is the reference's scan unroll and has no meaning
here. ``param_axes`` and the ``constrain`` calls are the reference's.

Partitioned (under a ``parallelize.Layout`` whose rules split "nodes"
and "edges", ``gnn_rules``: every mesh axis, the layout's batch axes), a
rank holds its contiguous block of node rows (``node_feat``,
``node_mask``, ``target``) and of edge rows (``edge_feat``,
``edge_mask``, ``senders``, ``receivers``), the edges keeping the whole
graph's node ids: ``parallelize.local_batch`` of the graph that
:func:`pad_graph` padded with masked nodes and edges to a multiple of
the ranks.
Each layer runs as GSPMD lowers the reference's gather and segment sum
on split operands: the node states all-gathered once (the backward
reduce-scatters their gradient) for the rank's edges, whose messages
are summed into every node and reduce-scattered back to each rank's
nodes (the backward all-gathers), the mean aggregator's degree the same
way; the node update and the decoder run on the rank's nodes. The loss
divides by the whole graph's node count, so the ranks' losses add up to
the reference's. Only indices are kept for the backward of the gathers
and the segment sum, so no whole-graph buffer outlives its layer. The
weights are FSDP over the data axes (gathered at use), replicated over
'model', their gradients summed over every axis.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.distributed import parallelize as par
from repro_torch.distributed.parallelize import unshard
from repro_torch.distributed.sharding import constrain, map_axes
from repro_torch.models.embedding import segment_sum
from repro_torch.models.layers import TreeModel, apply_norm, \
    norm_init, randn
from repro_torch.models.transformer import DTYPES


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    node_in: int
    edge_in: int
    node_out: int
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    aggregator: str = "sum"
    dtype: str = "float32"
    unroll: int = 1


def _mlp_init(gen: torch.Generator, dims: list[int], dtype) -> dict:
    return {
        f"l{i}": {
            "w": (randn(gen, (dims[i], dims[i + 1]))
                  * (1.0 / math.sqrt(dims[i]))).to(dtype),
            "b": torch.zeros((dims[i + 1],), dtype=dtype),
        }
        for i in range(len(dims) - 1)
    }


def _mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    n = len(p)
    for i in range(n):
        x = x @ unshard(p[f"l{i}"]["w"]) + unshard(p[f"l{i}"]["b"])
        if i < n - 1:
            x = torch.relu(x)
    return x


def _mlp_axes(dims: list[int]) -> dict:
    return {f"l{i}": {"w": ("w_fsdp", "w_out"), "b": ("w_out",)}
            for i in range(len(dims) - 1)}


def param_axes(cfg: GNNConfig) -> dict:
    d = cfg.d_hidden
    hidden = [d] * cfg.mlp_layers

    def stack(ax):
        return map_axes(lambda t: ("layers",) + t, ax)

    layer_ax = {
        "edge_mlp": stack(_mlp_axes([3 * d] + hidden + [d])),
        "edge_ln": stack({"scale": ("feat",), "bias": ("feat",)}),
        "node_mlp": stack(_mlp_axes([2 * d] + hidden + [d])),
        "node_ln": stack({"scale": ("feat",), "bias": ("feat",)}),
    }
    return {
        "node_enc": _mlp_axes([cfg.node_in] + hidden + [d]),
        "edge_enc": _mlp_axes([cfg.edge_in] + hidden + [d]),
        "layers": layer_ax,
        "decoder": _mlp_axes([d] + hidden + [cfg.node_out]),
    }


def init_params(gen: torch.Generator, cfg: GNNConfig,
                device: str | torch.device | None = None) -> TreeModel:
    """Random init at the reference's scales, drawn from ``gen`` and
    placed on ``device`` (None: the CUDA card)."""
    dev = resolve_device(device)
    dt = DTYPES[cfg.dtype]
    d = cfg.d_hidden
    hidden = [d] * cfg.mlp_layers
    layers = [{"edge_mlp": _mlp_init(gen, [3 * d] + hidden + [d], dt),
               "edge_ln": norm_init("ln", d, dt),
               "node_mlp": _mlp_init(gen, [2 * d] + hidden + [d], dt),
               "node_ln": norm_init("ln", d, dt)}
              for _ in range(cfg.n_layers)]
    return TreeModel(cfg, {
        "node_enc": _mlp_init(gen, [cfg.node_in] + hidden + [d], dt),
        "edge_enc": _mlp_init(gen, [cfg.edge_in] + hidden + [d], dt),
        "layers": layers,
        "decoder": _mlp_init(gen, [d] + hidden + [cfg.node_out], dt),
    }).to(dev)


NODE_KEYS = ("node_feat", "node_mask", "target")
EDGE_KEYS = ("edge_feat", "edge_mask", "senders", "receivers")


def pad_graph(graph: dict, multiple: int) -> dict:
    """``graph`` with its node and edge rows padded up to a multiple of
    ``multiple``: masked nodes and edges (mask False, features, targets
    and ids 0), which change no output row, loss or gradient."""
    out = dict(graph)
    for keys in (NODE_KEYS, EDGE_KEYS):
        n = graph[keys[0]].shape[0]
        extra = -n % multiple
        if not extra:
            continue
        for k in keys:
            if k in graph:
                v = graph[k]
                out[k] = torch.cat([v, v.new_zeros((extra, *v.shape[1:]))])
    return out


def node_group():
    """The group of the ranks that split the graph's nodes and edges (None:
    this rank holds the whole graph). Under rules that split them, the
    installed layout's batch axes must be the nodes' axes: a graph whose
    rows the ranks do not divide would otherwise run whole."""
    layout = par.current_layout()
    if layout is None:
        return None
    axes = par.spec_axes(layout.rules, "nodes")
    held = (layout.batch_axes if layout.batch_axes and par.axes_size(
        layout.mesh, layout.batch_axes) > 1 else ())
    if held != axes:
        raise ValueError(
            f"the graph's rows are split over {held} where the rules split "
            f"its nodes and edges over {axes}: pad it (gnn.pad_graph) to a "
            f"multiple of their ranks")
    return par.group(layout.mesh, axes) if axes else None


def forward(model: TreeModel, graph: dict) -> torch.Tensor:
    """graph: node_feat (N, Fn), edge_feat (E, Fe), senders/receivers
    (E,), node_mask (N,), edge_mask (E,), on any device (moved to the
    model's). Returns (N, node_out). Partitioned (:func:`node_group`), the
    graph is this rank's block and so is the output."""
    cfg, dev = model.cfg, model.device
    g = node_group()
    node_feat = graph["node_feat"].to(dev)
    # the whole graph's node count: the ids index it
    n_nodes = node_feat.shape[0] * (dist.get_world_size(g) if g else 1)
    h = constrain(_mlp_apply(model["node_enc"], node_feat), "nodes", "feat")
    e = constrain(_mlp_apply(model["edge_enc"], graph["edge_feat"].to(dev)),
                  "edges", "feat")
    snd = graph["senders"].to(device=dev, dtype=torch.int64)
    rcv = graph["receivers"].to(device=dev, dtype=torch.int64)
    emask = graph["edge_mask"].to(dev)[:, None].to(h.dtype)
    deg = None
    if cfg.aggregator == "mean":
        deg = torch.clamp(par.scatter_sum(segment_sum(emask, rcv, n_nodes),
                                          0, g), min=1.0)
    for lp in model["layers"]:
        h_all = par.gather_sum(h, 0, g)
        msg_in = torch.cat([e, h_all[snd], h_all[rcv]], dim=-1)
        del h_all
        e_new = _mlp_apply(lp["edge_mlp"], msg_in)
        e_new = apply_norm(lp["edge_ln"], e_new, "ln")
        e = constrain(e + e_new * emask, "edges", "feat")
        agg = par.scatter_sum(segment_sum(e * emask, rcv, n_nodes), 0, g)
        if deg is not None:
            agg = agg / deg
        h_new = _mlp_apply(lp["node_mlp"], torch.cat([h, agg], dim=-1))
        h_new = apply_norm(lp["node_ln"], h_new, "ln")
        h = constrain(h + h_new, "nodes", "feat")
    out = _mlp_apply(model["decoder"], h)
    return out * graph["node_mask"].to(dev)[:, None].to(out.dtype)


def loss_fn(model: TreeModel, graph: dict) -> torch.Tensor:
    """L2 regression against graph['target'] (N, node_out); partitioned,
    this rank's share: its nodes' errors over the whole graph's count."""
    pred = forward(model, graph)
    mask = graph["node_mask"].to(pred.device)[:, None].to(pred.dtype)
    err = (pred - graph["target"].to(pred.device)) ** 2 * mask
    return torch.sum(err) / torch.clamp(par.batch_sum(torch.sum(mask)),
                                        min=1.0)
