"""Embedding substrate: plain lookup, EmbeddingBag and the row-sharded
lookup (PyTorch port of ``repro/models/embedding.py``).

Bags are a gather and a segment reduction, as the reference builds them
from ``jnp.take`` and ``segment_sum``: ``index_add_`` for the sums, a
``scatter_reduce`` for the maxima.

Distributed lookup: under sharding rules whose 'table_rows' axis splits a
table (a ``DTensor`` of ``distributed/parallelize.py``), each rank masks
the ids its rows hold, gathers them from its block, and an all-reduce
over the table axis assembles the rows, so the table is never gathered
(the reference's ``shard_map`` with ``psum``). The ids are this rank's
(the batch is split over the data axes before the model sees it, and a
batch that does not divide them stays whole on every rank, the
reference's replicated fallback).

Ids stay int64: a full DLRM table holds 13.3G elements, so a row's flat
element offset does not fit 32 bits (PyTorch's gather indexes in 64 bits
when a tensor needs it).

Determinism on the card: ``index_add_`` on a CUDA tensor sums with float
atomics, so two runs can differ in the last bit; under
``torch.use_deterministic_algorithms(True)`` PyTorch routes it through
``index_put_(accumulate=True)``, which sorts the indices and sums each
row's sources in one fixed order. The gather's backward (``table[ids]``)
is that same accumulating ``index_put_``. ``amax`` is exact in any order.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import parallelize as par
from repro_torch.distributed.sharding import current_rules, entry_axes
from repro_torch.models.layers import draw_device


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """ids (...,) -> (..., D); row-sharded when the rules split ``table``'s
    rows over their 'table_rows' axis (mask, local gather, all-reduce),
    else a plain gather (a sharded table split otherwise is gathered
    first)."""
    ids = ids.to(device=table.device, dtype=torch.int64)
    rules = current_rules()
    axes = entry_axes(rules.table.get("table_rows")) if rules else ()
    if len(axes) == 1 and _rows_split_over(table, axes[0]):
        (axis,) = axes
        mesh = table.device_mesh
        local = par.unshard(table, keep=(axis,))
        r_local = local.shape[0]
        local_ids = ids - par.coordinate(mesh, axis) * r_local
        valid = (local_ids >= 0) & (local_ids < r_local)
        emb = local[torch.clamp(local_ids, 0, r_local - 1)]
        emb = torch.where(valid[..., None], emb, 0)
        return par.reduce_from(emb, par.group(mesh, axis))
    return par.unshard(table)[ids]


def _rows_split_over(table, axis: str) -> bool:
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(table, DTensor):
        return False
    names = table.device_mesh.mesh_dim_names
    if axis not in names:
        return False
    p = table.placements[names.index(axis)]
    return isinstance(p, Shard) and p.dim == 0


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: (L, ...) rows summed into (n_segments,
    ...). The ids must lie in [0, n_segments) (JAX drops the others;
    ``index_add`` refuses them)."""
    seg = segment_ids.to(device=data.device, dtype=torch.int64)
    out = torch.zeros((n_segments, *data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add(0, seg, data)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """``jax.ops.segment_max``: an empty segment is -inf (JAX's identity
    of max), so the reduction starts from -inf and leaves it there."""
    seg = segment_ids.to(device=data.device, dtype=torch.int64)
    out = torch.full((n_segments, *data.shape[1:]), float("-inf"),
                     dtype=data.dtype, device=data.device)
    index = seg.reshape(-1, *([1] * (data.dim() - 1))).expand_as(data)
    return out.scatter_reduce(0, index, data, "amax", include_self=False)


def embedding_bag(table: torch.Tensor, flat_ids: torch.Tensor,
                  segment_ids: torch.Tensor, n_segments: int,
                  mode: str = "sum",
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """EmbeddingBag: ragged multi-hot bags -> (n_segments, D) reduce.

    flat_ids (L,), segment_ids (L,) sorted, optional per-sample weights
    (L,). ``mean`` divides by max(count, 1); ``max`` leaves an empty bag
    at -inf, as the reference's ``segment_max``."""
    emb = embedding_lookup(table, flat_ids)                    # (L, D)
    if weights is not None:
        emb = emb * weights.to(emb.device)[:, None]
    if mode == "sum":
        return segment_sum(emb, segment_ids, n_segments)
    if mode == "mean":
        s = segment_sum(emb, segment_ids, n_segments)
        cnt = segment_sum(torch.ones(flat_ids.shape, dtype=torch.float32,
                                     device=emb.device),
                          segment_ids, n_segments)
        return s / torch.clamp(cnt, min=1.0)[:, None]
    if mode == "max":
        return segment_max(emb, segment_ids, n_segments)
    raise ValueError(f"unknown bag mode {mode!r}")


# rows a chunk of the draw: a chunk stays under 2^30 elements
_DRAW_ELEMS = 1 << 30


def embedding_init(gen: torch.Generator, n_rows: int, dim: int,
                   scale: float = 0.01, dtype=torch.float32,
                   pad_rows_to: int = 1,
                   device: str | torch.device | None = None) -> torch.Tensor:
    """Normal(0, scale) rows drawn from ``gen`` on ``gen``'s device, then
    placed on ``device`` (default: ``gen``'s). ``pad_rows_to`` rounds the
    row count up so a row-sharded table divides any mesh axis (ids never
    reference the padding rows). The draw goes in chunks of rows: a CUDA
    generator fills a 53 GB table on the card in seconds, where the CPU
    takes minutes."""
    rows = -(-n_rows // pad_rows_to) * pad_rows_to
    drawn_on = draw_device(gen)
    out = torch.empty((rows, dim), dtype=torch.float32, device=drawn_on)
    step = max(1, _DRAW_ELEMS // max(dim, 1))
    if not out.is_meta:
        for lo in range(0, rows, step):
            out[lo:lo + step].normal_(0.0, 1.0, generator=gen)
        out.mul_(scale)
    dev = drawn_on if device is None else torch.device(device)
    return out.to(device=dev, dtype=dtype)
