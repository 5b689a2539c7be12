"""Which ``torch.distributed`` collectives a backend runs on CUDA tensors.

    PYTHONPATH=src python -m repro_torch.tools.gloo_cuda_probe [--device cpu]
    PYTHONPATH=src python -m repro_torch.tools.gloo_cuda_probe --backend nccl

With gloo (the default) it spawns two ranks on one device (both on
``cuda:0``, as the sharded paths run where ranks share a card); with
nccl one rank a card on every card of the machine (at least two; nccl
never shares a card). Each collective that the sharded paths use is
tried on a small tensor of the rank's device: all-reduce, broadcast,
all-gather (list and into one tensor), reduce-scatter (into one tensor),
all-to-all (single tensor) and a barrier; then ``DTensor``'s own:
``distribute_tensor`` of a dim-0 shard, its ``redistribute`` to
replicated (an FSDP gather whose backward is a reduce-scatter),
``full_tensor``, and ``fully_shard`` on a linear layer through a
forward and backward; each in a fresh set of processes. Each result is
checked against its value computed by hand. Prints one JSON line a
collective, ``{"op": ..., "ok": ..., "error": ...}`` (a crash of the
ranks is an error too), and exits 0 however many of them fail: the
point is the table.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import rank_device, spawn_ranks


def _probe(rank: int, device_type: str, op: str) -> dict:
    dev = rank_device(rank, device_type)
    n = dist.get_world_size()
    base = torch.arange(4, dtype=torch.float32, device=dev)
    # 2 entries a rank, for the ops that split their input over the ranks
    wide = torch.arange(2 * n, dtype=torch.float32, device=dev)
    each = [torch.arange(4.0) + r for r in range(n)]

    def all_reduce():
        t = base + rank
        dist.all_reduce(t)
        return torch.equal(t.cpu(), sum(each))

    def broadcast():
        t = base + 10 * rank
        dist.broadcast(t, src=0)
        return torch.equal(t.cpu(), torch.arange(4.0))

    def all_gather():
        out = [torch.empty_like(base) for _ in range(n)]
        dist.all_gather(out, base + rank)
        return torch.equal(torch.cat(out).cpu(), torch.cat(each))

    def all_gather_into_tensor():
        out = torch.empty(n * 4, device=dev)
        dist.all_gather_into_tensor(out, base + rank)
        return torch.equal(out.cpu(), torch.cat(each))

    def reduce_scatter_tensor():
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, wide + rank)
        want = n * torch.arange(2.0 * n) + n * (n - 1) / 2
        return torch.equal(out.cpu(), want[2 * rank: 2 * rank + 2])

    def all_to_all_single():
        out = torch.empty(2 * n, device=dev)
        dist.all_to_all_single(out, wide + 10 * rank)
        want = torch.cat([torch.arange(2.0 * n)[2 * rank: 2 * rank + 2]
                          + 10 * j for j in range(n)])
        return torch.equal(out.cpu(), want)

    def barrier():
        dist.barrier()
        return True

    def mesh():
        from repro_torch.launch.mesh import make_host_mesh
        return make_host_mesh((n,), ("data",), device_type=dev.type)

    def dtensor_distribute_tensor():
        from torch.distributed.tensor import Shard, distribute_tensor
        whole = torch.arange(4.0 * n, device=dev).reshape(2 * n, 2)
        w = distribute_tensor(whole, mesh(), [Shard(0)])
        return torch.equal(w.to_local().cpu(),
                           whole.cpu()[2 * rank: 2 * rank + 2])

    def dtensor_fsdp_gather():
        from torch.distributed.tensor import (Partial, Replicate, Shard,
                                              distribute_tensor)
        m = mesh()
        w = torch.nn.Parameter(distribute_tensor(
            torch.ones(2 * n, 2, device=dev), m, [Shard(0)]))
        full = w.redistribute(m, [Replicate()]).to_local(
            grad_placements=[Partial()])
        loss = ((rank + 1) * full).sum()
        (g,) = torch.autograd.grad(loss, [w])
        return torch.equal(g.to_local().cpu(),
                           torch.full((2, 2), n * (n + 1) / 2))

    def dtensor_full_tensor():
        from torch.distributed.tensor import DTensor, Shard
        t = DTensor.from_local(base + rank, mesh(), [Shard(0)])
        return torch.equal(t.full_tensor().cpu(), torch.cat(each))

    def fully_shard():
        # the mean over the ranks of each rank's gradient: rank r feeds
        # rows of r + 1, so d(sum)/dW = 2 (r + 1) and d(sum)/db = 2
        from torch.distributed.fsdp import fully_shard as shard
        torch.manual_seed(0)
        lin = torch.nn.Linear(4, 4, device=dev)
        shard(lin, mesh=mesh())
        lin(torch.full((2, 4), rank + 1.0, device=dev)).sum().backward()
        return (torch.equal(lin.weight.grad.full_tensor().cpu(),
                            torch.full((4, 4), n + 1.0))
                and torch.equal(lin.bias.grad.full_tensor().cpu(),
                                torch.full((4,), 2.0)))

    fn = locals()[op]
    try:
        return {"op": op, "ok": bool(fn()), "error": None}
    except Exception as e:                # noqa: BLE001 — the probe's result
        return {"op": op, "ok": False,
                "error": f"{type(e).__name__}: {e}"[:300]}


OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
       "reduce_scatter_tensor", "all_to_all_single", "barrier",
       "dtensor_distribute_tensor", "dtensor_fsdp_gather",
       "dtensor_full_tensor", "fully_shard")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    args = ap.parse_args(argv)
    world = 2
    if args.backend == "nccl":
        if args.device != "cuda" or torch.cuda.device_count() < 2:
            raise SystemExit("--backend nccl needs --device cuda and two "
                             "cards or more (one a rank)")
        world = torch.cuda.device_count()
    for op in OPS:
        # one set of processes an op: a collective that crashes its
        # ranks (gloo on a CUDA tensor can) names itself
        try:
            row = spawn_ranks(_probe, world, (args.device, op),
                              backend=args.backend, timeout_s=120.0,
                              collective_timeout_s=60.0)[0]
        except (RuntimeError, TimeoutError) as e:
            row = {"op": op, "ok": False,
                   "error": f"{type(e).__name__}: {e}"[-300:]}
        print(json.dumps({"device": args.device, "backend": args.backend,
                          "world": world, "torch": torch.__version__,
                          **row}), flush=True)


if __name__ == "__main__":
    main()
