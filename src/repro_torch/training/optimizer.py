"""Optimizers on parameter trees (PyTorch port of
``repro/training/optimizer.py``): AdamW, row-wise Adagrad (embedding
tables: one accumulator a row), SGD with momentum, LR schedules,
global-norm clipping, and the path-prefix ``mixed`` optimizer.

The interface is the reference's, which mirrors optax:
``opt.init(params) -> state`` and ``opt.update(grads, state, params, step)
-> (updates, state)``; the caller adds the updates to the parameters.
``params`` and ``grads`` are trees (``training/tree.py``: nested dicts and
lists of tensors; a model's is its ``module_tree``), and the state is
plain dicts of tensors under the reference's keys (``{"mu", "nu"}``,
``{"acc"}``, ``{"mom"}``). The arithmetic is the reference's, in float32:
the schedule and AdamW's bias corrections ``1 - b ** t`` are float32
tensors, weight decay is applied inside the update, and each update is
cast to its parameter's dtype. A schedule returns a 0-dim CPU tensor,
which combines with tensors on any device without a copy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.training.tree import leaves, paths, structure, tree_map, \
    unflatten

Schedule = Callable[[object], torch.Tensor]
F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(device="cpu", dtype=F32)


def constant_schedule(lr: float) -> Schedule:
    return lambda step: _f32(lr)


def cosine_schedule(lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> Schedule:
    def fn(step):
        step = _f32(step)
        warm = lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac * lr + (1 - final_frac) * lr * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return fn


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, step) -> (updates, state)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares.
    ``torch._foreach_norm`` and ``linalg.vector_norm`` would take fewer
    launches, but on the CPU they accumulate a large leaf's squares with
    float32 rounding that ``torch.sum`` avoids: the grad norm came out
    9e-4 off on the encoder's 7.8M-entry embedding."""
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(x.float())) for x in leaves(tree)])))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by ``min(1, max_norm / max(norm, 1e-9))``, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    flat = leaves(grads)
    scaled = torch._foreach_mul([g.float() for g in flat], scale)
    return unflatten(structure(grads), [x.to(g.dtype) for x, g in
                                        zip(scaled, flat)]), norm


def _map_n(fn, n: int, tree, *rest) -> tuple:
    """``fn`` (returning an n-tuple) over matching leaves -> n trees of
    ``tree``'s structure."""
    outs = [fn(*xs) for xs in zip(*(leaves(t) for t in (tree, *rest)))]
    struct = structure(tree)
    return tuple(unflatten(struct, [o[i] for o in outs]) for i in range(n))


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=F32)


def adamw(schedule: Schedule, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"mu": tree_map(_zeros32, params),
                "nu": tree_map(_zeros32, params)}

    def update(grads, state, params, step):
        # float32 scalars, handed to the kernels as their exact values
        lr = schedule(step).item()
        t = _f32(step) + 1.0
        c1 = (1.0 - _f32(b1) ** t).item()
        c2 = (1.0 - _f32(b2) ** t).item()
        g = [x.float() for x in leaves(grads)]
        p = leaves(params)
        # the reference's per-leaf formula, each operation once over all
        # leaves (multi-tensor launches); in-place only on fresh results:
        # m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g
        m = torch._foreach_mul(leaves(state["mu"]), b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        v = torch._foreach_mul(leaves(state["nu"]), b2)
        gg = torch._foreach_mul(g, 1 - b2)
        torch._foreach_mul_(gg, g)
        torch._foreach_add_(v, gg)
        # u = -lr ((m / c1) / (sqrt(v / c2) + eps) + wd p)
        den = torch._foreach_div(v, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        u = torch._foreach_div(m, c1)
        torch._foreach_div_(u, den)
        del den, gg
        torch._foreach_add_(u, torch._foreach_mul(
            [x.detach().float() for x in p], weight_decay))
        torch._foreach_mul_(u, -lr)
        struct = structure(grads)
        return (unflatten(struct, [x.to(q.dtype) for x, q in zip(u, p)]),
                {"mu": unflatten(struct, m), "nu": unflatten(struct, v)})

    return Optimizer(init, update)


def _row_acc(p: torch.Tensor) -> torch.Tensor:
    """Zeros, one a row of ``p``; for a sharded ``p`` (a ``DTensor``) the
    block of its rows this rank holds, split as ``p``'s rows are (the
    reference's ``P(spec[0])``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(p, DTensor):
        return torch.zeros(p.shape[:1], dtype=F32, device=p.device)
    local = p.to_local()
    rows = tuple(q if isinstance(q, Shard) and q.dim == 0 else Replicate()
                 for q in p.placements)
    return DTensor.from_local(
        torch.zeros(local.shape[:1], dtype=F32, device=local.device),
        p.device_mesh, rows, run_check=False, shape=p.shape[:1],
        stride=(1,) if p.dim() else ())


def rowwise_adagrad(schedule: Schedule, eps: float = 1e-8) -> Optimizer:
    """One accumulator scalar per table *row* (FBGEMM/MLPerf style)."""
    def init(params):
        return {"acc": tree_map(_row_acc, params)}

    def update(grads, state, params, step):
        lr = schedule(step)

        def upd(g, a, p):
            g = g.float()
            red = tuple(range(1, g.ndim))
            a = a + torch.mean(g * g, dim=red) if g.ndim > 1 else a + g * g
            scale = torch.rsqrt(a + eps)
            u = -lr * g * scale.reshape(scale.shape + (1,) * (g.ndim - 1))
            return u.to(p.dtype), a

        ups, acc = _map_n(upd, 2, grads, state["acc"], params)
        return ups, {"acc": acc}

    return Optimizer(init, update)


def sgd(schedule: Schedule, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {}
        return {"mom": tree_map(_zeros32, params)}

    def update(grads, state, params, step):
        lr = schedule(step)
        if momentum == 0.0:
            return tree_map(lambda g, p: (-lr * g.float()).to(p.dtype),
                            grads, params), state

        def upd(g, m, p):
            m = momentum * m + g.float()
            return (-lr * m).to(p.dtype), m

        ups, mom = _map_n(upd, 2, grads, state["mom"], params)
        return ups, {"mom": mom}

    return Optimizer(init, update)


def _leaf_path_str(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def mixed(rules: list[tuple[str, Optimizer]],
          default: Optimizer) -> Optimizer:
    """Route leaves to optimizers by param-path prefix.

    ``rules = [("tables", rowwise_adagrad(...))]`` sends every leaf whose
    path (keys and list indices joined by "/") starts with 'tables' to
    adagrad, the rest to ``default``. Each optimizer runs over the flat
    list of its leaves; the updates are scattered back into leaf order."""
    table = {prefix: opt for prefix, opt in rules}
    table["__default__"] = default

    def _labels(params) -> list[str]:
        labels = []
        for path in paths(params):
            name = _leaf_path_str(path)
            lab = "__default__"
            for prefix, _opt in rules:
                if name.startswith(prefix):
                    lab = prefix
                    break
            labels.append(lab)
        return labels

    def init(params):
        flat, labels = leaves(params), _labels(params)
        return {name: opt.init([x for x, lab in zip(flat, labels)
                                if lab == name])
                for name, opt in table.items()}

    def update(grads, state, params, step):
        gflat, pflat, labels = leaves(grads), leaves(params), _labels(params)
        new_state = {}
        updates_flat: list = [None] * len(gflat)
        for name, opt in table.items():
            ix = [i for i, lab in enumerate(labels) if lab == name]
            if not ix:
                new_state[name] = state[name]
                continue
            ups, st = opt.update([gflat[i] for i in ix], state[name],
                                 [pflat[i] for i in ix], step)
            new_state[name] = st
            for i, u in zip(ix, ups):
                updates_flat[i] = u
        return unflatten(structure(grads), updates_flat), new_state

    return Optimizer(init, update)


def apply_updates(params, updates):
    """``params + updates`` leaf by leaf, as new tensors (the train step
    adds in place instead: ``train_loop.make_train_step``)."""
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
