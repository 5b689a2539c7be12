"""Training launcher (PyTorch port of ``repro/launch/train.py``):
``python -m repro_torch.launch.train --arch <id> [...]``.

Runs a fault-tolerant training job for an LM (dense or mixture of
experts), MeshGraphNet or one of the four recsys architectures on one
device or sharded over several, with the reference's data
per family (LM token batches; a 256-node, 1,024-edge random graph a step;
the recsys batches at ``--batch``) and its AdamW with a cosine schedule.
``--preset smoke`` (default) uses the reduced config, which runs on a
CPU; ``--preset full`` uses the production config. The flags and the
printed lines are the reference's, plus:

  --device D        cuda (default) or cpu. With cuda and no card the
                    launcher exits with an error.
  --layers N        cut the preset's depth to N layers (an LM or the
                    graph), its widths kept.
  --metrics-json P  write the run's history, parameter counts (an LM's
                    active count too), the examples (LM: tokens) a step
                    and (on the card) peak memory to P as JSON.

``--devices N`` (N > 1) trains sharded over N ranks, one process each
(``launch/mesh.py::spawn_ranks``), on the reference's square-ish
("data", "model") mesh ((2, 1) for 2, (4, 1) for 4, (4, 2) for 8) under
the family's rules (``lm_rules``, ``gnn_rules``, ``recsys_rules``):
FSDP over "data", the 'model' placements of the rules, the batch split
over "data" and, for an LM, the sequence over 'model' (sequence
parallelism: each 'model' rank trains on its chunk of every row, with
context-parallel attention); the graph's nodes and edges split over
every rank (each rank its block of the padded graph, ``models/gnn.py``);
``distributed/parallelize.py``. A sequence that 'model' does not divide
is refused. Each rank sits on ``cuda:(rank mod
cards)`` (or the CPU with ``--device cpu``); ranks talk over gloo where
they share a card or run on the CPU, over nccl where each owns a card
(``[train] N ranks over <backend> on ...`` after the mesh line).
Rank 0 prints the reference's lines; the metrics file adds the mesh, the
backend and each rank's peak memory.

``asc-splade`` has no train step (exit 2, as the reference's).
``--grad-compression`` reaches ``TrainConfig`` and, as in the reference
(whose ``fit`` passes no compression axis to its step), changes
nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time


def _parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--devices", type=int, default=0,
                    help="sharded training over N ranks (0 = one device)")
    ap.add_argument("--grad-compression", action="store_true",
                    help="int8+EF gradient compression (fit passes no "
                         "group, so it changes nothing, as in the "
                         "reference)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the preset's depth to N layers (an LM or the "
                         "graph; 0 = the preset's)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--metrics-json", default="",
                    help="write the run's history and sizes here")
    return ap.parse_args(argv)


def mesh_shape(n_dev: int) -> tuple[int, int]:
    """The reference's square-ish (data, model) mesh of ``n_dev``
    devices."""
    data = 1
    while data * data <= n_dev and n_dev % (data * 2) == 0:
        data *= 2
    return data, n_dev // data


def main(argv=None) -> None:
    args = _parse(argv)

    from repro_torch.configs import arch_kind

    kind = arch_kind(args.arch)
    if kind not in ("lm", "gnn", "recsys"):
        print(f"[train] arch kind {kind!r} has no train step "
              f"(use repro_torch.launch.serve)", file=sys.stderr)
        raise SystemExit(2)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("[train] no CUDA device is available; pass "
                         "--device cpu to train on the CPU")
    if args.devices > 1:
        _sharded(args, kind)
        return
    _train(args, kind, torch.device(args.device))


def _sharded(args, kind: str) -> None:
    import torch

    from repro_torch.launch.mesh import backend_for, spawn_ranks
    shape = mesh_shape(args.devices)
    print(f"[train] mesh: {dict(zip(('data', 'model'), shape))}",
          flush=True)
    backend = backend_for(args.devices, args.device)
    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    print(f"[train] {args.devices} ranks over {backend} on "
          f"{f'{cards} card(s)' if cards else 'the CPU'}", flush=True)
    results = spawn_ranks(_train_rank, args.devices, (args, kind, shape),
                          backend=backend, timeout_s=None)
    if args.metrics_json:
        out = results[0]
        out["mesh"] = dict(zip(("data", "model"), shape))
        out["backend"] = backend
        out["ranks"] = [{"rank": r, "device": res["rank_device"],
                         "peak_memory_bytes": res["peak_memory_bytes"],
                         "peak_reserved_bytes": res["peak_reserved_bytes"]}
                        for r, res in enumerate(results)]
        for k in ("rank_device", "peak_reserved_bytes"):
            out.pop(k)
        with open(args.metrics_json, "w") as f:
            json.dump(out, f, indent=1)


def _train_rank(rank: int, args, kind: str, shape) -> dict:
    """One rank of ``--devices``: the whole job on this rank's device,
    sharded over the mesh; rank 0 prints."""
    import torch

    from repro_torch.launch.mesh import make_host_mesh, rank_device
    dev = rank_device(rank, args.device)
    if dev.type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.devices))
    mesh = make_host_mesh(shape, ("data", "model"), dev.type)
    return _train(args, kind, dev, mesh=mesh, rank=rank)


def _train(args, kind: str, device, mesh=None, rank: int = 0):
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import pipeline as pl
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.train_loop import TrainConfig, fit

    mod = get_arch(args.arch)
    cfg = mod.smoke_config() if args.preset == "smoke" else mod.config()
    if args.layers:
        if kind not in ("lm", "gnn"):
            raise SystemExit(f"[train] --layers cuts an LM's or the graph's "
                             f"depth; {args.arch} has none")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    gen = torch.Generator().manual_seed(0)

    if kind == "lm":
        from repro_torch.models import transformer as tf
        model = tf.init_params(gen, cfg, device=device)
        axes = tf.param_axes(cfg)
        loss_fn = tf.loss_fn
        spec = pl.LMDataSpec(cfg.vocab, args.seq + 1, args.batch)
        per_step = {"tokens_per_step": args.batch * args.seq,
                    "param_count": cfg.param_count(),
                    "active_param_count": cfg.active_param_count()}

        def batch_fn(step: int) -> dict:
            return {k: v[:, : args.seq]
                    for k, v in pl.lm_batch(spec, step).items()}
    elif kind == "gnn":
        from repro_torch.models import gnn
        model = gnn.init_params(gen, cfg, device=device)
        axes = gnn.param_axes(cfg)
        loss_fn = gnn.loss_fn
        gspec = pl.GraphSpec(256, 1024, cfg.node_in, cfg.edge_in,
                             cfg.node_out)
        per_step = {"nodes_per_step": gspec.n_nodes,
                    "edges_per_step": gspec.n_edges}

        # sharded: padded to the ranks, which then take their blocks
        parts = 1 if mesh is None else mesh.size()

        def batch_fn(step: int) -> dict:
            return gnn.pad_graph(pl.random_graph(gspec, step), parts)
    else:
        from repro_torch.models.recsys import RECSYS, RECSYS_AXES
        init_fn, _, loss_fn, _ = RECSYS[args.arch]
        make = {"dlrm-mlperf": pl.dlrm_batch, "din": pl.din_batch,
                "deepfm": pl.deepfm_batch,
                "bert4rec": pl.bert4rec_batch}[args.arch]
        model = init_fn(gen, cfg, device=device)
        axes = RECSYS_AXES[args.arch](cfg)
        per_step = {"examples_per_step": args.batch}

        def batch_fn(step: int) -> dict:
            return make(cfg, args.batch, step)

    def data_fn(step: int) -> dict:
        return {k: v.to(device) for k, v in batch_fn(step).items()}

    optimizer = opt_lib.adamw(
        opt_lib.cosine_schedule(3e-4, warmup=max(1, args.steps // 10),
                                total=args.steps))
    tcfg = TrainConfig(steps=args.steps,
                       log_every=max(1, args.steps // 10),
                       checkpoint_every=max(5, args.steps // 3),
                       grad_compression=args.grad_compression)
    n_params = model.n_params()
    layout = None
    if mesh is not None:
        from repro_torch.distributed import parallelize as par
        from repro_torch.distributed import sharding as sh
        rules = {"lm": sh.lm_rules, "gnn": sh.gnn_rules,
                 "recsys": sh.recsys_rules}[kind](mesh)
        t0 = time.perf_counter()
        par.shard_module(model, rules, axes)
        layout = par.Layout(rules, par.batch_axes_of(rules))
        per_step["shard_s"] = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model, history = fit(params=model, optimizer=optimizer,
                         loss_fn=loss_fn, data_fn=data_fn, cfg=tcfg,
                         ckpt_dir=args.ckpt_dir,
                         log_fn=(functools.partial(print, flush=True)
                                 if rank == 0 else (lambda _: None)),
                         layout=layout)
    out = {"arch": args.arch, "kind": kind, "preset": args.preset,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "n_params": n_params, **per_step,
           "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
           "history": history}
    if mesh is None and args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(out, f, indent=1)
    if rank == 0:
        if not history:     # the checkpoint directory held the last step
            print(f"[train] done: resumed at step {args.steps - 1}, "
                  f"nothing left to train", flush=True)
        else:
            print(f"[train] done: loss {history[0]['loss']:.4f} -> "
                  f"{history[-1]['loss']:.4f} over {args.steps} steps",
                  flush=True)
    if mesh is None:
        return None
    out["rank_device"] = str(device)
    out["peak_reserved_bytes"] = (torch.cuda.max_memory_reserved(device)
                                  if device.type == "cuda" else None)
    return out


if __name__ == "__main__":
    main()
