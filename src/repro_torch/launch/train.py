"""Training launcher (PyTorch port of ``repro/launch/train.py``):
``python -m repro_torch.launch.train --arch <id> [...]``.

Runs a fault-tolerant training job for an LM (dense or mixture of
experts), MeshGraphNet or one of the four recsys architectures on one
device, with the reference's data
per family (LM token batches; a 256-node, 1,024-edge random graph a step;
the recsys batches at ``--batch``) and its AdamW with a cosine schedule.
``--preset smoke`` (default) uses the reduced config, which runs on a
CPU; ``--preset full`` uses the production config. The flags and the
printed lines are the reference's, plus:

  --device D        cuda (default) or cpu. With cuda and no card the
                    launcher exits with an error.
  --metrics-json P  write the run's history, parameter counts (an LM's
                    active count too), the examples (LM: tokens) a step
                    and (on the card) peak memory to P as JSON.

``asc-splade`` has no train step (exit 2, as the reference's);
``--devices N`` exits with an error until ``distributed/sharding.py`` is
ported.
``--grad-compression`` reaches ``TrainConfig`` and, as in the reference
(whose ``fit`` passes no compression axis to its step), changes
nothing.
"""

from __future__ import annotations

import argparse
import json
import sys


def _parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--devices", type=int, default=0,
                    help="sharded training over N devices (not ported yet)")
    ap.add_argument("--grad-compression", action="store_true",
                    help="int8+EF gradient compression (fit passes no "
                         "group, so it changes nothing, as in the "
                         "reference)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--metrics-json", default="",
                    help="write the run's history and sizes here")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = _parse(argv)
    if args.devices:
        raise SystemExit(
            "[train] --devices: sharded training over several devices is "
            "not ported yet (it needs repro_torch/distributed/sharding.py); "
            "run without --devices to train on one device")

    from repro_torch.configs import arch_kind

    kind = arch_kind(args.arch)
    if kind not in ("lm", "gnn", "recsys"):
        print(f"[train] arch kind {kind!r} has no train step "
              f"(use repro_torch.launch.serve)", file=sys.stderr)
        raise SystemExit(2)

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import pipeline as pl
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.train_loop import TrainConfig, fit

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("[train] no CUDA device is available; pass "
                         "--device cpu to train on the CPU")
    device = torch.device(args.device)
    mod = get_arch(args.arch)
    cfg = mod.smoke_config() if args.preset == "smoke" else mod.config()
    gen = torch.Generator().manual_seed(0)

    if kind == "lm":
        from repro_torch.models import transformer as tf
        model = tf.init_params(gen, cfg, device=device)
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
        loss_fn = gnn.loss_fn
        gspec = pl.GraphSpec(256, 1024, cfg.node_in, cfg.edge_in,
                             cfg.node_out)
        per_step = {"nodes_per_step": gspec.n_nodes,
                    "edges_per_step": gspec.n_edges}

        def batch_fn(step: int) -> dict:
            return pl.random_graph(gspec, step)
    else:
        from repro_torch.models.recsys import RECSYS
        init_fn, _, loss_fn, _ = RECSYS[args.arch]
        make = {"dlrm-mlperf": pl.dlrm_batch, "din": pl.din_batch,
                "deepfm": pl.deepfm_batch,
                "bert4rec": pl.bert4rec_batch}[args.arch]
        model = init_fn(gen, cfg, device=device)
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
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model, history = fit(params=model, optimizer=optimizer,
                         loss_fn=loss_fn, data_fn=data_fn, cfg=tcfg,
                         ckpt_dir=args.ckpt_dir)
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump({
                "arch": args.arch, "kind": kind, "preset": args.preset,
                "device": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
                "n_params": model.n_params(), **per_step,
                "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                      if device.type == "cuda" else None),
                "history": history}, f, indent=1)
    if not history:     # the checkpoint directory held the last step
        print(f"[train] done: resumed at step {args.steps - 1}, nothing "
              f"left to train")
        return
    print(f"[train] done: loss {history[0]['loss']:.4f} -> "
          f"{history[-1]['loss']:.4f} over {args.steps} steps")


if __name__ == "__main__":
    main()
