"""Train-step factory and training loop with fault tolerance (PyTorch port
of ``repro/training/train_loop.py``).

``make_train_step(loss_fn, optimizer, ...)`` builds the step: the loss and
its gradients by autograd -> (optional microbatch accumulation) ->
(optional int8 gradient compression over a ``torch.distributed`` group)
-> global-norm clip -> optimizer update, added to the parameters in
place. The model is an ``nn.Module`` (``nn.ParameterDict`` for a bare set
of tensors); ``loss_fn(model, batch)`` returns a scalar, and the
optimizer sees the module's parameter tree (``tree.module_tree``).

``fit`` is the loop: resume from the latest checkpoint, periodic async
saves, deterministic data order keyed by step (a restart re-produces the
same batch sequence).

Sharded training (``layout``, a ``distributed.parallelize.Layout``): the
model's parameters are ``DTensor``s (``parallelize.shard_module``), every
rank runs the step on its block of the batch under the layout's rules
(its rows, and its chunk of their sequence where the rules split it:
``parallelize.local_batch``), and its loss is its share of the whole
batch's. The step reports the whole batch's loss (the shares summed
over the token axes), clips by the norm
of the whole gradients (from the blocks, one all-reduce) and updates each
rank's blocks in place; AdamW's moments are blocks of the same
placements. Checkpoints hold whole tensors, written by rank 0.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch
from torch import nn

from repro_torch.training import optimizer as opt_lib
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.tree import leaves, module_tree, structure, \
    tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    max_to_keep: int = 3
    grad_clip: float = 1.0
    microbatches: int = 1          # gradient accumulation
    grad_compression: bool = False  # int8 + error feedback over a group


def make_train_step(loss_fn: Callable, optimizer: opt_lib.Optimizer,
                    cfg: TrainConfig, compression_group=None, layout=None,
                    batch_is_local: bool = False):
    """``loss_fn(model, batch) -> scalar``. Returns ``step(model,
    opt_state, batch, step_no, [ef_state]) -> (model, opt_state,
    metrics[, ef])``; the model's parameters are updated in place and the
    same module is returned. ``compression_group`` (a process group, e.g.
    ``torch.distributed.group.WORLD``) turns on ``compressed_mean`` when
    ``cfg.grad_compression`` is set; ``None`` leaves it off. ``layout``
    runs the sharded step (every rank calls it with the whole batch, or
    with its own block, split as ``parallelize.local_batch`` splits it,
    when ``batch_is_local``)."""
    compress = cfg.grad_compression and compression_group is not None
    if layout is not None:
        return _sharded_step(loss_fn, optimizer, cfg, layout,
                             batch_is_local)

    def value_and_grad(model, params, batch):
        loss = loss_fn(model, batch)
        flat = leaves(params)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        return loss.detach(), unflatten(structure(params), grads)

    def grads_of(model, params, batch):
        if cfg.microbatches <= 1:
            return value_and_grad(model, params, batch)
        # split the leading batch dim into microbatches and accumulate in
        # float32, in order, then scale by 1/n (the reference's scan)
        n = cfg.microbatches
        loss_acc = torch.zeros((), dtype=torch.float32)
        g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        for i in range(n):
            mb = tree_map(lambda x: x[i * (x.shape[0] // n):
                                      (i + 1) * (x.shape[0] // n)], batch)
            loss, g = value_and_grad(model, params, mb)
            loss_acc = loss_acc.to(loss.device) + loss
            g_acc = tree_map(torch.add, g_acc, g)
        scale = 1.0 / n
        return loss_acc * scale, tree_map(lambda g: g * scale, g_acc)

    def step(model: nn.Module, opt_state, batch, step_no, ef_state=None):
        params = module_tree(model)
        loss, grads = grads_of(model, params, batch)
        if compress:
            from repro_torch.training.compression import compressed_mean
            grads, ef_state = compressed_mean(grads, ef_state,
                                              compression_group)
        grads, gnorm = opt_lib.clip_by_global_norm(grads, cfg.grad_clip)
        updates, opt_state = optimizer.update(grads, opt_state, params,
                                              step_no)
        with torch.no_grad():
            flat = leaves(params)
            torch._foreach_add_(flat, [u.to(p.dtype) for p, u in
                                       zip(flat, leaves(updates))])
        metrics = {"loss": loss, "grad_norm": gnorm}
        if compress:
            return model, opt_state, metrics, ef_state
        return model, opt_state, metrics

    return step


def _sharded_step(loss_fn: Callable, optimizer: opt_lib.Optimizer,
                  cfg: TrainConfig, layout, batch_is_local: bool = False):
    if cfg.microbatches > 1:
        raise ValueError("the sharded step takes no microbatches")
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import parallelize as par

    def local(x):
        return x.to_local() if isinstance(x, DTensor) else x

    def rewrap(x, like):
        if not isinstance(like, DTensor):
            return x
        return DTensor.from_local(x, like.device_mesh, like.placements,
                                  run_check=False, shape=like.shape,
                                  stride=like.stride())

    def step(model: nn.Module, opt_state, batch, step_no):
        params = module_tree(model)
        rows, axes = ((batch, layout.batch_axes) if batch_is_local
                      else par.local_batch(batch, layout))
        # a batch that does not divide the axes runs whole on every rank
        with par.use_layout(par.Layout(layout.rules, axes)):
            loss = loss_fn(model, rows)
            flat = leaves(params)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(flat, grads)]
            loss = par.batch_sum(loss.detach())
        gnorm = par.global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        g_local = torch._foreach_mul([local(g).float() for g in grads],
                                     scale)
        p_local = [local(p) for p in leaves(params)]
        struct = structure(params)
        st_local = tree_map(local, opt_state)
        updates, st_new = optimizer.update(
            unflatten(struct, [g.to(p.dtype) for g, p in
                               zip(g_local, p_local)]),
            st_local, unflatten(struct, p_local), step_no)
        with torch.no_grad():
            torch._foreach_add_(p_local, [u.to(p.dtype) for p, u in
                                          zip(p_local, leaves(updates))])
        opt_state = tree_map(rewrap, st_new, opt_state)
        return model, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


def fit(*, params: nn.Module, optimizer: opt_lib.Optimizer,
        loss_fn: Callable, data_fn: Callable[[int], Any], cfg: TrainConfig,
        ckpt_dir: str | None = None,
        log_fn: Callable[[str], None] = print,
        layout=None) -> tuple[nn.Module, list[dict]]:
    """Training loop. ``data_fn(step) -> batch`` must be deterministic in
    ``step`` (fault-tolerant replay). ``params`` is the model, trained in
    place. Returns (params, history). With ``layout`` (every rank calls
    ``fit``; ``params`` already sharded) the step is the sharded one and
    checkpoints hold whole tensors, rank 0 writing them."""
    opt_state = optimizer.init(module_tree(params))
    start_step = 0
    mgr = None
    if ckpt_dir is not None:
        mgr = CheckpointManager(ckpt_dir, max_to_keep=cfg.max_to_keep)
        template = {"step": 0, "params": params, "opt_state": opt_state}
        restored = mgr.restore_latest(template)
        if restored is not None:
            start_step = int(restored["step"]) + 1
            params = mgr.cast_like(restored["params"], params)
            opt_state = mgr.cast_like(restored["opt_state"], opt_state)
            log_fn(f"[fit] resumed from step {start_step - 1}")

    step_fn = make_train_step(loss_fn, optimizer, cfg, layout=layout)

    history = []
    t0 = time.perf_counter()
    for step in range(start_step, cfg.steps):
        batch = data_fn(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        if step % cfg.log_every == 0 or step == cfg.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["elapsed_s"] = time.perf_counter() - t0
            history.append(m)
            log_fn(f"[fit] step {step}: loss={m['loss']:.4f} "
                   f"gnorm={m['grad_norm']:.3f}")
        if mgr is not None and (step + 1) % cfg.checkpoint_every == 0:
            mgr.save(step, {"step": step, "params": params,
                            "opt_state": opt_state}, async_save=True)
    if mgr is not None:
        mgr.save(cfg.steps - 1, {"step": cfg.steps - 1, "params": params,
                                 "opt_state": opt_state})
        mgr.wait()
        if layout is not None:
            torch.distributed.barrier()
    return params, history
