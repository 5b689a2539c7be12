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
here. ``param_axes`` and the ``constrain`` calls are the reference's; on
a sharded model the weights are gathered at use and every rank runs the
whole graph (the port does not partition a graph's message passing:
``gnn_rules``' node and edge axes name activations only).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device
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


def forward(model: TreeModel, graph: dict) -> torch.Tensor:
    """graph: node_feat (N, Fn), edge_feat (E, Fe), senders/receivers
    (E,), node_mask (N,), edge_mask (E,), on any device (moved to the
    model's). Returns (N, node_out)."""
    cfg, dev = model.cfg, model.device
    node_feat = graph["node_feat"].to(dev)
    n_nodes = node_feat.shape[0]
    h = constrain(_mlp_apply(model["node_enc"], node_feat), "nodes", "feat")
    e = constrain(_mlp_apply(model["edge_enc"], graph["edge_feat"].to(dev)),
                  "edges", "feat")
    snd = graph["senders"].to(device=dev, dtype=torch.int64)
    rcv = graph["receivers"].to(device=dev, dtype=torch.int64)
    emask = graph["edge_mask"].to(dev)[:, None].to(h.dtype)
    for lp in model["layers"]:
        msg_in = torch.cat([e, h[snd], h[rcv]], dim=-1)
        e_new = _mlp_apply(lp["edge_mlp"], msg_in)
        e_new = apply_norm(lp["edge_ln"], e_new, "ln")
        e = constrain(e + e_new * emask, "edges", "feat")
        agg = segment_sum(e * emask, rcv, n_nodes)
        if cfg.aggregator == "mean":
            deg = segment_sum(emask, rcv, n_nodes)
            agg = agg / torch.clamp(deg, min=1.0)
        h_new = _mlp_apply(lp["node_mlp"], torch.cat([h, agg], dim=-1))
        h_new = apply_norm(lp["node_ln"], h_new, "ln")
        h = constrain(h + h_new, "nodes", "feat")
    out = _mlp_apply(model["decoder"], h)
    return out * graph["node_mask"].to(dev)[:, None].to(out.dtype)


def loss_fn(model: TreeModel, graph: dict) -> torch.Tensor:
    """L2 regression against graph['target'] (N, node_out)."""
    pred = forward(model, graph)
    mask = graph["node_mask"].to(pred.device)[:, None].to(pred.dtype)
    err = (pred - graph["target"].to(pred.device)) ** 2 * mask
    return torch.sum(err) / torch.clamp(torch.sum(mask), min=1.0)
