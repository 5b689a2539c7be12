"""Logical-axis sharding rules on a ``DeviceMesh`` (PyTorch port of
``repro/distributed/sharding.py``).

Models name the axes of their parameters and activations with *logical*
names (``("w_fsdp", "w_mlp")``, ``constrain(x, "batch", "seq",
"embed")``); a :class:`ShardingRules` table maps each logical name to
physical mesh axes. Rules are installed with a context manager, so model
code threads no mesh through its calls; with no rules installed every
annotation is the identity (the single-device path).

A spec is a :class:`PartitionSpec`: one entry a tensor dim, each ``None``
(replicated), a mesh-axis name, or a tuple of names (the dim split over
their product, the first axis major, as ``jax.sharding.PartitionSpec``).
:func:`placements` turns it into the ``DTensor`` placements of a
``DeviceMesh`` (``Shard(d)`` or ``Replicate()`` a mesh dim); a dim split
over several mesh axes shards in mesh-dim order, so its axes must appear
in the mesh's order (every table here names them so).

The uniform LM recipe of the reference: batch and FSDP weight sharding
ride ("pod", "data"); the weights' FFN, vocab and expert dims are stored
over "model". A spec gives a mesh axis to the first name that asks for
it, so in training and prefill the sequence takes "model" (sequence
parallelism, attention context-parallel) and the MLP's and vocab's
activations stay whole, while decode leaves the sequence whole and they
take "model" (tensor parallelism, the KV cache's slots over "model").
The tables are the reference's; how the port executes a model under them
(one process a rank, the tokens split as the specs say, weights gathered
at use) is ``distributed/parallelize.py``'s. Nothing here runs a
collective: the functions below only map names to placements, except
:func:`constrain`, which redistributes a ``DTensor``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Mapping, Sequence

Axes = str | tuple[str, ...] | None

_state = threading.local()


class PartitionSpec(tuple):
    """``PartitionSpec(*entries)``: a tuple of per-dim mesh axes."""

    def __new__(cls, *entries: Axes):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size for a ``DeviceMesh`` (or any object with
    ``mesh_dim_names`` and ``shape``); empty for ``None``."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def entry_axes(entry: Axes) -> tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(mesh, spec: Sequence[Axes]) -> tuple:
    """``spec`` as ``DTensor`` placements on ``mesh``: ``Shard(d)`` on each
    mesh dim that dim ``d`` is split over, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axs = entry_axes(entry)
        order = [names.index(a) for a in axs]
        if order != sorted(order):
            raise ValueError(f"dim {d} of {spec} names its mesh axes out of "
                             f"the mesh's order {names}")
        for i in order:
            out[i] = Shard(d)
    return tuple(out)


class ShardingRules:
    def __init__(self, mesh, table: Mapping[str, Axes]):
        self.mesh = mesh
        self.table = dict(table)

    def spec(self, *logical: str | None) -> PartitionSpec:
        mesh_axes = (set(self.mesh.mesh_dim_names)
                     if self.mesh is not None else None)
        phys: list[Axes] = []
        used: set[str] = set()
        for name in logical:
            ax = self.table.get(name) if name is not None else None
            # drop axes absent from the mesh (e.g. 'pod' on a single pod);
            # a mesh axis may appear only once in a spec — later wins None
            if isinstance(ax, tuple):
                ax = tuple(a for a in ax
                           if (mesh_axes is None or a in mesh_axes)
                           and a not in used) or None
                if ax is not None:
                    used.update(ax)
            elif ax is not None:
                if (mesh_axes is not None and ax not in mesh_axes) \
                        or ax in used:
                    ax = None
                else:
                    used.add(ax)
            phys.append(ax)
        return PartitionSpec(*phys)

    def sharding(self, *logical: str | None) -> "NamedSharding":
        assert self.mesh is not None
        return NamedSharding(self.mesh, self.spec(*logical))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart)."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


@contextlib.contextmanager
def use_rules(rules: ShardingRules | None):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def current_rules() -> ShardingRules | None:
    return getattr(_state, "rules", None)


def constrain(x, *logical: str | None):
    """The reference's ``with_sharding_constraint`` under the ambient rules.
    The identity without rules or a mesh, and for a plain tensor: in the
    port's per-rank program (``distributed/parallelize.py``) a plain
    tensor is this rank's block, already laid out by the code around it.
    A ``DTensor`` is redistributed to the spec's placements."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh,
                          placements(x.device_mesh, rules.spec(*logical)))


def spec_for(*logical: str | None) -> PartitionSpec:
    rules = current_rules()
    if rules is None:
        return PartitionSpec()
    return rules.spec(*logical)


# ---------------------------------------------------------------------------
# Rule tables (the reference's, entry for entry)
# ---------------------------------------------------------------------------

def lm_rules(mesh, *, training: bool = True, long_context: bool = False,
             decode: bool = False) -> ShardingRules:
    """Uniform LM recipe: batch/FSDP on (pod, data), TP on model.

    Activations: batch -> (pod, data); the query sequence over 'model' in
    train/prefill, the KV-cache sequence over 'model' in decode. Weights:
    the input dim FSDP over (pod, data), the output-feature dims (mlp,
    vocab, experts) over 'model'. Serving (``training=False``) replicates
    the weights over the data axes; ``decode`` leaves the length-1
    sequence unsharded; ``long_context`` spreads the cache over the whole
    mesh."""
    table: dict[str, Axes] = {
        "batch": ("pod", "data"),
        "seq": "model",
        "seq_q": "model",
        "seq_kv": None,
        "cache_seq": "model",
        "embed": None,
        "heads": None,
        "kv_heads": None,
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "expert_cap": None,
        # weight dims
        "w_fsdp": ("pod", "data"),
        "w_mlp": "model",
        "w_vocab": "model",
        "w_embed": None,
        "layers": None,
    }
    if not training:
        table["w_fsdp"] = None
    if decode:
        table["seq"] = None
        table["seq_q"] = None
    if long_context:
        table["batch"] = None
        table["cache_seq"] = ("data", "model")
    return ShardingRules(mesh, table)


def gnn_rules(mesh) -> ShardingRules:
    """Edges/nodes sharded over every data-ish axis; features local."""
    table: dict[str, Axes] = {
        "edges": ("pod", "data", "model"),
        "nodes": ("pod", "data", "model"),
        "batch": ("pod", "data", "model"),
        "feat": None,
        "w_fsdp": ("pod", "data"),
        "w_out": None,
        "layers": None,
    }
    return ShardingRules(mesh, table)


def recsys_rules(mesh) -> ShardingRules:
    """Row-sharded embedding tables over 'model', batch over the rest."""
    table: dict[str, Axes] = {
        "batch": ("pod", "data"),
        "candidates": ("pod", "data"),
        "feat": None,
        "fields": None,
        "seq": None,
        "table_rows": "model",
        "embed": None,
        "w_fsdp": ("pod", "data"),
        "w_out": None,
        "layers": None,
    }
    return ShardingRules(mesh, table)


def retrieval_rules(mesh) -> ShardingRules:
    """ASC serving: clusters over (pod, data), query batch over 'model'."""
    table: dict[str, Axes] = {
        "clusters": ("pod", "data"),
        "queries": "model",
        "vocab": None,
        "doc_slots": None,
        "seg": None,
    }
    return ShardingRules(mesh, table)


# ---------------------------------------------------------------------------
# Trees of logical axes
# ---------------------------------------------------------------------------

def is_axes_leaf(x: Any) -> bool:
    """A tuple of logical names (or None): one leaf's axes."""
    return isinstance(x, tuple) and all(
        isinstance(a, (str, type(None))) for a in x)


def map_axes(fn, tree_axes: Any, *rest: Any) -> Any:
    """``fn(axes, *matching)`` over each axes leaf of ``tree_axes`` and the
    matching nodes of ``rest`` (dicts by key, lists by position)."""
    if is_axes_leaf(tree_axes):
        return fn(tree_axes, *rest)
    if isinstance(tree_axes, dict):
        return {k: map_axes(fn, v, *(r[k] for r in rest))
                for k, v in tree_axes.items()}
    if isinstance(tree_axes, list):
        return [map_axes(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree_axes)]
    raise TypeError(f"not an axes tree node: {tree_axes!r}")


def make_sharding(tree_axes: Any, rules: ShardingRules) -> Any:
    """Map a tree of logical-axis tuples to NamedShardings."""
    return map_axes(lambda axes: rules.sharding(*axes), tree_axes)


def divisible_spec(rules: ShardingRules, axes: Sequence[str | None],
                   shape: Sequence[int]) -> PartitionSpec:
    """Logical axes -> PartitionSpec, dropping mesh axes that do not divide
    the corresponding dimension (innermost first, so partial sharding is
    kept where it can be): a 13-wide DLRM bottom-MLP input simply
    replicates, big divisible dims stay sharded."""
    base = rules.spec(*axes)
    sizes = mesh_sizes(rules.mesh)
    out: list[Axes] = []
    for i, entry in enumerate(base):
        dim = shape[i] if i < len(shape) else 1
        axs = list(entry_axes(entry))
        while axs:
            total = 1
            for a in axs:
                total *= sizes.get(a, 1)
            if dim % total == 0:
                break
            axs.pop()                      # drop innermost first
        out.append(tuple(axs) if len(axs) > 1 else (axs[0] if axs else None))
    return PartitionSpec(*out)


def shard_with_shapes(rules: ShardingRules, tree_axes: Any,
                      tree_shapes: Any) -> Any:
    """Tree of logical-axis tuples + matching tree of tensors (anything
    with ``.shape``) -> NamedShardings with per-dim divisibility checks."""
    return map_axes(
        lambda axes, val: NamedSharding(
            rules.mesh, divisible_spec(rules, axes, tuple(val.shape))),
        tree_axes, tree_shapes)
