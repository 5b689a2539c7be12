"""Sharded programs (training and serving): parameters placed by the
sharding rules, one process a rank.

The reference lays one program over the mesh and lets GSPMD place every
value from the rules. The port runs one process a rank
(``launch/mesh.py``) and writes the rank's program out, as the
reference's own ``shard_map`` paths do:

  * **parameters** are ``DTensor``s on the ``DeviceMesh``, each holding
    the block its placement (``sharding.shard_with_shapes``) gives this
    rank: ``w_fsdp`` over the data axes (FSDP), ``w_mlp``, ``w_vocab``,
    ``experts`` and ``table_rows`` over 'model'. AdamW's moments are
    ``zeros_like`` of them and so take their placement; the masters stay
    in their own dtype (float32);
  * **the tokens** are split as the rules lay them (:class:`Layout`):
    the batch's rows over the data axes (:func:`local_batch`; a batch
    that does not divide them stays whole on every rank, as the
    reference's embedding lookup falls back to a replicated id batch),
    and the sequence over the axes the rules give "seq" after "batch"
    ('model' in LM training and prefill: sequence parallelism). A
    sequence that those axes do not divide raises: a rank never runs
    whole what the rules split;
  * **at use** a weight is cast to the compute dtype and then gathered
    over the axes it is split on (:func:`unshard`): the FSDP all-gather
    moves compute-dtype bytes, and its backward is a reduce-scatter over
    the token axes (the ranks there saw other tokens; a weight replicated
    over them has its gradient summed over them, a norm's scale over
    'model' too). A caller may keep an axis split: the expert-parallel MoE
    keeps 'model' (``models/moe.py``), the row-sharded lookup keeps
    'table_rows' (``models/embedding.py``), and where the rules put a
    feature dim on 'model' (decode: "mlp" and "vocab", as the sequence
    leaves 'model' to them, :func:`spec_axes`) the MLP and the LM head
    keep it and reduce or gather their products (tensor parallelism);
  * **attention** under a sequence split is context-parallel: each rank's
    queries at their global positions, K/V gathered over the sequence's
    axes (:func:`gather_seq`, whose backward is a reduce-scatter); in
    decode the KV cache's slots are split over "cache_seq"'s axes and the
    softmax is combined over them (``models/attention.py``);
  * **a graph** (``gnn_rules``: nodes and edges over every mesh axis,
    the batch axes) is the rank's block of node rows and its block of
    edge rows, the edges keeping their global node ids: each layer
    all-gathers the node states for the rank's edges (:func:`gather_sum`,
    whose backward is a reduce-scatter) and reduce-scatters the rank's
    messages, summed into every node, back to each rank's nodes
    (:func:`scatter_sum`, whose backward is an all-gather), as GSPMD
    lowers the reference's gather and segment sum (``models/gnn.py``);
  * **an MoE's experts** where the all-to-all does not apply (decode, or
    a batch the data axes do not divide) stay split over 'model': every
    'model' rank holds the same tokens and dispatch, runs its own experts
    on their slots and the partial outputs are summed over 'model'
    (:func:`sum_shares`; ``models/moe.py``);
  * **losses** are shares: a rank's loss is its part of the whole
    batch's (a mean divides by every token's count, :func:`batch_sum`
    over the token axes), so the ranks' losses add up to the
    reference's, and their gradients too.

Compute that no axis splits runs whole on every rank of that axis, with
the same inputs, so its gradients agree there: the attention projections
in decode (the rules leave "heads" whole, as the reference's do), and an
MoE's experts where they do not divide 'model' (gathered whole, as the
reference's ``divisible_spec`` leaves them).

Every collective is a raw ``torch.distributed`` call on this rank's plain
tensors, in the autograd functions below. ``DTensor`` is only the
parameters' container (``from_local``/``to_local``, which move nothing):
under gloo on a CUDA tensor, torch 2.11's ``DTensor`` collectives crash
the ranks (SIGSEGV) while the raw collectives run
(``tools/gloo_cuda_probe.py``), and ``fully_shard`` goes through the
former. Reductions of 16-bit floats run in float32, and 16-bit gathers
and all-to-alls move the raw bytes (a ``uint8`` view of the last dim),
which every backend carries.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
import weakref

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.distributed import sharding as sh

_state = threading.local()
# id(mesh) -> {axes: this rank's group}; an entry leaves with its mesh
# (``weakref.finalize``), so a later mesh (the dry-run joins a new
# process group for each production mesh) never finds a group of a
# process group that is gone, even where it reuses a freed id
_groups: dict[int, dict] = {}


@dataclasses.dataclass(frozen=True)
class Layout:
    """How a rank's program is laid over ``rules.mesh``: the rules, and
    the mesh axes the batch's rows are split over (empty: every rank
    computes every row). The tokens' sequence is split over the axes the
    rules give "seq" after "batch" (:attr:`seq_axes`: 'model' in LM
    training and prefill, none in decode), so a rank's tokens are its
    rows' chunk of the sequence; its loss is its share over
    :attr:`token_axes`, the batch axes and the sequence's."""
    rules: sh.ShardingRules
    batch_axes: tuple[str, ...]

    @property
    def mesh(self):
        return self.rules.mesh

    @functools.cached_property
    def seq_axes(self) -> tuple[str, ...]:
        return spec_axes(self.rules, "batch", "seq")

    @property
    def token_axes(self) -> tuple[str, ...]:
        return self.batch_axes + self.seq_axes


def batch_axes_of(rules: sh.ShardingRules) -> tuple[str, ...]:
    """The mesh axes the rules put the batch on."""
    spec = rules.spec("batch")
    return sh.entry_axes(spec[0]) if len(spec) else ()


def spec_axes(rules: sh.ShardingRules | None, *logical: str
              ) -> tuple[str, ...]:
    """The mesh axes the last of ``logical`` takes in the rules' spec of
    them all (an axis goes to the first name that asks for it, as the
    reference's specs give it), or () where they hold one rank: for
    ("batch", "seq") the sequence's split, for ("batch", "seq", "mlp")
    the MLP's hidden dim's (none while the sequence holds 'model'), for
    ("batch", "cache_seq") the KV cache's."""
    if rules is None or rules.mesh is None:
        return ()
    axes = sh.entry_axes(rules.spec(*logical)[-1])
    return axes if axes_size(rules.mesh, axes) > 1 else ()


def split_axes(*logical: str) -> tuple[str, ...]:
    """:func:`spec_axes` under the installed layout (() without one)."""
    layout = current_layout()
    return spec_axes(layout.rules, *logical) if layout is not None else ()


@contextlib.contextmanager
def use_layout(layout: Layout | None):
    """Install ``layout``'s rules and batch axes for the code inside."""
    prev = getattr(_state, "layout", None)
    _state.layout = layout
    try:
        with sh.use_rules(layout.rules if layout else None):
            yield layout
    finally:
        _state.layout = prev


def current_layout() -> Layout | None:
    return getattr(_state, "layout", None)


def in_context(fn):
    """``fn``, run under the layout and rules installed now wherever it is
    called later. ``torch.utils.checkpoint`` recomputes a layer inside the
    backward, which the autograd engine runs on a thread of its own for a
    CUDA tensor, where this thread's layout is not installed: the
    recompute would take another path (the all-to-all or not) and sum
    another batch."""
    layout, rules = current_layout(), sh.current_rules()

    def run(*args, **kwargs):
        prev = current_layout()
        _state.layout = layout
        try:
            with sh.use_rules(rules):
                return fn(*args, **kwargs)
        finally:
            _state.layout = prev
    return run


# ---------------------------------------------------------------------------
# Groups and coordinates
# ---------------------------------------------------------------------------

def coordinate(mesh, axis: str) -> int:
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)]


def group(mesh, axes) -> dist.ProcessGroup | None:
    """The process group of this rank's line along ``axes`` (one axis or
    several, in mesh order; rank order is the row-major order of their
    coordinates); None for no axes."""
    axes = axes if isinstance(axes, tuple) else (axes,)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if id(mesh) not in _groups:
        _groups[id(mesh)] = {}
        weakref.finalize(mesh, _groups.pop, id(mesh), None)
    cached = _groups[id(mesh)]
    if axes not in cached:
        # every rank creates every line's group, in one order
        names = mesh.mesh_dim_names
        ranks = mesh.mesh
        dims = [names.index(a) for a in axes]
        other = [i for i in range(len(names)) if i not in dims]
        lines = ranks.permute(*other, *dims).reshape(
            -1, math.prod(ranks.shape[i] for i in dims))
        mine = None
        for line in lines.tolist():
            g = dist.new_group(line)
            if dist.get_rank() in line:
                mine = g
        cached[axes] = mine
    return cached[axes]


def axes_size(mesh, axes) -> int:
    sizes = sh.mesh_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def line_index(mesh, axes) -> int:
    """This rank's place along ``axes`` (row-major over their coordinates,
    in the order given): its rank in :func:`group`'s line, and the block
    it holds of a dim split over them."""
    sizes = sh.mesh_sizes(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coordinate(mesh, a)
    return idx


# ---------------------------------------------------------------------------
# Collectives on plain tensors
# ---------------------------------------------------------------------------

_WIDE = (torch.bfloat16, torch.float16)
# the names torch 2.13 gives the single-tensor collectives; earlier
# releases know only the older ones
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A 16-bit float tensor as the bytes of a row-major copy (the last dim
    doubled; ``contiguous`` leaves a size-1 last dim's stride as it is,
    which the view refuses); other dtypes as they are, made
    contiguous."""
    if t.dtype not in _WIDE:
        return t.contiguous()
    if t.dim() and t.stride(-1) != 1:
        t = torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)
    return t.contiguous().view(torch.uint8)


def _gather_dim(t: torch.Tensor, dim: int, g) -> torch.Tensor:
    n = dist.get_world_size(g)
    x = _bytes(t.movedim(dim, 0))
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    _all_gather(out, x, group=g)
    return out.view(t.dtype).movedim(0, dim)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """A reduction's operand: a 16-bit float widened to float32, any
    other dtype as it is."""
    return t.float() if t.dtype in _WIDE else t


def _scatter_sum_dim(t: torch.Tensor, dim: int, g) -> torch.Tensor:
    """Sum over the group, each rank keeping its chunk of ``dim``."""
    n = dist.get_world_size(g)
    x = _wide(t.movedim(dim, 0)).contiguous()
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    _reduce_scatter(out, x, group=g)
    return out.to(t.dtype).movedim(0, dim)


def _chunk(t: torch.Tensor, dim: int, g) -> torch.Tensor:
    n = dist.get_world_size(g)
    return t.chunk(n, dim)[dist.get_rank(g)].contiguous()


def _sum(t: torch.Tensor, g) -> torch.Tensor:
    # a row-major copy: nccl refuses a strided operand (a gradient
    # reduce-scattered over another dim arrives moved back, strided)
    x = _wide(t).clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=g)
    return x.to(t.dtype)


class _Unshard(torch.autograd.Function):
    """Forward: gather a weight block over the mesh dims listed in
    ``gather`` ((mesh dim, tensor dim), innermost first). Backward: over
    each gathered dim, the token axes' gradient is reduce-scattered (their
    ranks computed on other tokens) and the others' chunked (their ranks
    hold the same gradient); over ``summed`` (replicated dims on token
    axes) it is all-reduced."""

    @staticmethod
    def forward(ctx, w, mesh, gather, summed, tokens):
        ctx.mesh, ctx.gather, ctx.summed, ctx.batch = (mesh, gather, summed,
                                                       tokens)
        names = mesh.mesh_dim_names
        for i, d in gather:
            w = _gather_dim(w, d, mesh.get_group(names[i]))
        return w if gather else w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        names = ctx.mesh.mesh_dim_names
        for i, d in reversed(ctx.gather):
            grp = ctx.mesh.get_group(names[i])
            g = (_scatter_sum_dim(g, d, grp) if names[i] in ctx.batch
                 else _chunk(g, d, grp))
        for i in ctx.summed:
            g = _sum(g, ctx.mesh.get_group(names[i]))
        return g, None, None, None, None


def unshard(w, dtype: torch.dtype | None = None, keep=()) -> torch.Tensor:
    """``w`` for this rank's compute: a plain tensor, cast to ``dtype``
    (if given, and ``w`` is float32), then gathered over every mesh axis
    it is split on except those in ``keep`` (logical names resolved by
    the ambient rules, or mesh axes). A plain ``w`` is only cast."""
    from torch.distributed.tensor import DTensor, Shard
    cast = dtype is not None and w.dtype == torch.float32
    if not isinstance(w, DTensor):
        return w.to(dtype) if cast else w
    layout = current_layout()
    tokens = layout.token_axes if layout is not None else ()
    mesh = w.device_mesh
    names = mesh.mesh_dim_names
    rules = sh.current_rules()
    kept = set()
    for k in keep:
        kept.update(sh.entry_axes(rules.table.get(k, k)) if rules else (k,))
    local = w.to_local(grad_placements=w.placements)
    if cast:
        local = local.to(dtype)
    gather, summed = [], []
    for i, p in enumerate(w.placements):
        if isinstance(p, Shard):
            if names[i] not in kept:
                gather.append((i, p.dim))
        elif names[i] in tokens:
            summed.append(i)
    # gather innermost first: a dim split over (pod, data) is pod-major
    gather.reverse()
    if not gather and not summed:
        return local
    return _Unshard.apply(local, mesh, tuple(gather), tuple(summed), tokens)


def split_dim_axes(w, dim: int) -> tuple[str, ...]:
    """The mesh axes ``w`` (a ``DTensor``; a plain tensor: none) splits
    its dim ``dim`` over, in mesh order."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(w, DTensor):
        return ()
    names = w.device_mesh.mesh_dim_names
    return tuple(n for n, p in zip(names, w.placements)
                 if isinstance(p, Shard) and p.dim == dim)


class _SumShares(torch.autograd.Function):
    """All-reduce (sum) forward and backward: the value a sum of every
    rank's share, each rank's loss holding its share of what uses it."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _sum(x, g)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.g), None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward: partial values summed
    for compute that every rank of the group then runs alike."""

    @staticmethod
    def forward(ctx, x, g):
        return _sum(x, g)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    """All-gather of ``dim`` forward, this rank's chunk backward: a value
    gathered for compute that every rank of the group then runs alike."""

    @staticmethod
    def forward(ctx, x, dim, g):
        ctx.dim, ctx.g = dim, g
        return _gather_dim(x, dim, g)

    @staticmethod
    def backward(ctx, grad):
        return _chunk(grad, ctx.dim, ctx.g), None, None


class _GatherSum(torch.autograd.Function):
    """All-gather of ``dim`` forward, reduce-scatter backward: a value split
    over the group gathered whole for compute in which every rank's share
    of the loss reaches every part of it (context-parallel attention's
    K/V, the sequence before an MoE's dispatch), so each part's gradient
    is the sum of every rank's."""

    @staticmethod
    def forward(ctx, x, dim, g):
        ctx.dim, ctx.g = dim, g
        return _gather_dim(x, dim, g)

    @staticmethod
    def backward(ctx, grad):
        return _scatter_sum_dim(grad, ctx.dim, ctx.g), None, None


class _ScatterSum(torch.autograd.Function):
    """Reduce-scatter of ``dim`` forward, all-gather backward: every rank's
    partial sum of a value split over the group (a graph's aggregate into
    every node, each rank summing its own edges' messages), each rank
    keeping its chunk; every chunk's gradient reaches every rank's
    partial, so the backward gathers them all (the transpose of
    :class:`_GatherSum`)."""

    @staticmethod
    def forward(ctx, x, dim, g):
        ctx.dim, ctx.g = dim, g
        return _scatter_sum_dim(x, dim, g)

    @staticmethod
    def backward(ctx, grad):
        return _gather_dim(grad, ctx.dim, ctx.g), None, None


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over equal dim-0 chunks, forward and
    backward (the exchange is its own transpose)."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _a2a(x, g)

    @staticmethod
    def backward(ctx, grad):
        return _a2a(grad, ctx.g), None


def _a2a(x: torch.Tensor, g) -> torch.Tensor:
    raw = _bytes(x)
    out = torch.empty_like(raw)
    dist.all_to_all_single(out, raw, group=g)
    return out.view(x.dtype)


def reduce_from(x: torch.Tensor, g) -> torch.Tensor:
    return x if g is None else _ReduceFrom.apply(x, g)


def gather(x: torch.Tensor, dim: int, g) -> torch.Tensor:
    return x if g is None else _Gather.apply(x, dim, g)


def gather_sum(x: torch.Tensor, dim: int, g) -> torch.Tensor:
    return x if g is None else _GatherSum.apply(x, dim, g)


def scatter_sum(x: torch.Tensor, dim: int, g) -> torch.Tensor:
    return x if g is None else _ScatterSum.apply(x, dim, g)


def sum_shares(x: torch.Tensor, g) -> torch.Tensor:
    return x if g is None else _SumShares.apply(x, g)


def all_to_all(x: torch.Tensor, g) -> torch.Tensor:
    return x if g is None else _AllToAll.apply(x, g)


def max_over(x: torch.Tensor, g) -> torch.Tensor:
    """The elementwise maximum over the group (no gradient)."""
    if g is None:
        return x
    x = x.detach().float().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=g)
    return x


# ---------------------------------------------------------------------------
# The tokens' split: rows over the batch axes, the sequence over its axes
# ---------------------------------------------------------------------------

def seq_group():
    """The group of the ranks that split this rank's sequence (None: it is
    whole here)."""
    layout = current_layout()
    if layout is None or not layout.seq_axes:
        return None
    return group(layout.mesh, layout.seq_axes)


def seq_offset(n_local: int) -> int:
    """Where this rank's chunk of ``n_local`` positions starts in its
    rows' sequence (0 where the sequence is whole)."""
    layout = current_layout()
    if layout is None or not layout.seq_axes:
        return 0
    return line_index(layout.mesh, layout.seq_axes) * n_local


def gather_seq(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's chunk of the sequence (``dim``) gathered whole over
    the sequence's axes, every chunk's gradient reduce-scattered back
    (:class:`_GatherSum`); ``x`` itself where the sequence is whole."""
    return gather_sum(x, dim, seq_group())


def from_last_chunk(x: torch.Tensor) -> torch.Tensor:
    """``x`` (no gradient) as the rank holding the sequence's last chunk
    has it, on every rank of the sequence's group (a sum in which the
    others add zeros: exact)."""
    g = seq_group()
    if g is None:
        return x
    last = dist.get_rank(g) == dist.get_world_size(g) - 1
    return _sum(x.detach() if last else torch.zeros_like(x), g)


def token_group():
    """The group of the ranks that split the tokens (None: every rank
    holds them all)."""
    layout = current_layout()
    if layout is None or not layout.token_axes:
        return None
    return group(layout.mesh, layout.token_axes)


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` (no gradient: a count) summed over the token axes (the batch
    axes and the sequence's)."""
    g = token_group()
    return t if g is None else _sum(t.detach(), g)


def batch_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean over the token axes of each rank's ``t`` (a mean over its
    equal slice of the tokens), with the gradient of every rank's
    share."""
    g = token_group()
    if g is None:
        return t
    return sum_shares(t, g) / dist.get_world_size(g)


def batch_share(t: torch.Tensor) -> torch.Tensor:
    """This rank's share of a whole-batch mean: ``t`` over the number of
    ranks that split the tokens (``t`` a mean over this rank's equal
    slice, or a whole-batch value every rank computed alike)."""
    g = token_group()
    return t if g is None else t / dist.get_world_size(g)


# ---------------------------------------------------------------------------
# Placing a model and a batch
# ---------------------------------------------------------------------------

def block(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of ``full`` under ``placements`` (no
    communication: every rank holds ``full``). A dim split over several
    mesh dims is split in mesh-dim order, as ``DTensor`` splits it."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    out = full
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            out = out.chunk(mesh.size(i), p.dim)[coord[i]]
    # a copy of a part, so that ``full`` can be freed
    return out.contiguous() if out.numel() == full.numel() else out.clone(
        memory_format=torch.contiguous_format)


def place(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(block(full, mesh, placements), mesh,
                              placements, run_check=False,
                              shape=full.shape, stride=full.stride())


def shard_module(model: nn.Module, rules: sh.ShardingRules,
                 axes_tree) -> nn.Module:
    """Replace each parameter of ``model`` (whole on every rank) by a
    ``DTensor`` of its block under ``shard_with_shapes(rules, axes_tree,
    <the model in the reference's layout>)``. A per-layer parameter takes
    its stacked leaf's spec without the leading layer axis (which every
    table maps to None). Returns ``model``, changed in place."""
    from repro_torch.convert import LayerStack, reference_view
    owner = {}
    for mod in model.modules():
        for name, p in mod._parameters.items():
            if p is not None:
                owner[id(p)] = (mod, name)
    view = reference_view(model)
    shardings = sh.shard_with_shapes(rules, axes_tree, view)
    mesh = rules.mesh

    def put(s: sh.NamedSharding, leaf) -> None:
        items = leaf.items if isinstance(leaf, LayerStack) else [leaf]
        spec = s.spec
        if isinstance(leaf, LayerStack):
            if spec and spec[0] is not None:
                raise ValueError(f"the layer axis is sharded: {spec}")
            spec = sh.PartitionSpec(*spec[1:])
        pl = sh.placements(mesh, spec)
        for p in items:
            mod, name = owner[id(p)]
            mod._parameters[name] = nn.Parameter(
                place(p.detach(), mesh, pl), requires_grad=p.requires_grad)

    sh.map_axes(lambda _, s, leaf: put(s, leaf), axes_tree, shardings, view)
    return model


def local_batch(batch: dict, layout: Layout,
                replicated=("negatives",)) -> tuple[dict, tuple]:
    """This rank's block of ``batch`` and the axes its rows were split
    over: rows (dim 0) split over the batch axes, then, where the rules
    split the sequence (``layout.seq_axes``), dim 1 of every tensor of two
    dims or more split over those. Keys in ``replicated`` (shared by every
    example, as BERT4Rec's negatives) stay whole; a batch whose leading
    dim does not divide the batch axes keeps its rows whole on every rank
    (the reference's replicated fallback), and then no axis splits them.
    A sequence that its axes do not divide raises: the rank's program
    would run it whole where the rules split it."""
    axes = layout.batch_axes
    n = axes_size(layout.mesh, axes) if axes else 1
    rows = {v.shape[0] for k, v in batch.items() if k not in replicated}
    if n == 1 or any(r % n for r in rows):
        axes = ()
    out = dict(batch)
    if axes:
        idx = line_index(layout.mesh, axes)
        out = {k: (v if k in replicated else v.chunk(n, 0)[idx])
               for k, v in out.items()}
    seq = layout.seq_axes
    if seq:
        m = axes_size(layout.mesh, seq)
        idx = line_index(layout.mesh, seq)
        for k, v in out.items():
            if k in replicated or v.dim() < 2:
                continue
            if v.shape[1] % m:
                raise ValueError(
                    f"{k!r}'s sequence of {v.shape[1]} does not divide "
                    f"over {seq} ({m} ranks), where the rules split it")
            out[k] = v.chunk(m, 1)[idx]
    return out, axes


# ---------------------------------------------------------------------------
# Whole tensors, shard norms
# ---------------------------------------------------------------------------

def full(x) -> torch.Tensor:
    """The whole tensor of a ``DTensor`` (gathered over its split mesh
    dims; every rank must call it), a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    out = x.to_local().detach()
    for i in reversed(range(mesh.ndim)):
        p = x.placements[i]
        if isinstance(p, Shard):
            out = _gather_dim(out, p.dim, mesh.get_group(i))
    return out


def like(full_value: torch.Tensor, live) -> torch.Tensor:
    """``full_value`` laid out as ``live``: this rank's block as a
    ``DTensor`` of ``live``'s placements, or the tensor itself."""
    from torch.distributed.tensor import DTensor
    if not isinstance(live, DTensor):
        return full_value
    return place(full_value, live.device_mesh, live.placements)


def replication(x) -> int:
    """How many ranks hold each block of ``x`` (a plain tensor: every
    rank)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return dist.get_world_size()
    n = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Replicate):
            n *= x.device_mesh.size(i)
    return n


def global_norm(grads: list) -> torch.Tensor:
    """sqrt of the sum of squares of the whole tensors, from the blocks:
    each block's sum divided by the ranks that hold it, one all-reduce
    over the world (the mesh's ranks)."""
    from torch.distributed.tensor import DTensor
    local = torch.stack([
        torch.sum(torch.square((g.to_local() if isinstance(g, DTensor)
                                else g).float())) / replication(g)
        for g in grads])
    total = torch.sum(local)
    dist.all_reduce(total)
    return torch.sqrt(total)
