"""Which ``torch.distributed`` collectives gloo runs on CUDA tensors.

    PYTHONPATH=src python -m repro_torch.tools.gloo_cuda_probe [--device cpu]

Spawns two gloo ranks on one device (both on ``cuda:0`` by default, as
the sharded paths run where ranks share a card) and tries each collective
that sharded training uses on a small tensor of that device: all-reduce,
broadcast, all-gather (list and into one tensor), reduce-scatter (into
one tensor), all-to-all (single tensor) and a barrier, then a ``DTensor``
gather of a dim-0 shard whose backward is a reduce-scatter, each in a
fresh pair of processes. Each result is checked against its value
computed by hand. Prints one JSON line a collective, ``{"op": ...,
"ok": ..., "error": ...}`` (a crash of the ranks is an error too), and
exits 0 however many of them fail: the point is the table.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import rank_device, spawn_ranks


def _probe(rank: int, device_type: str, op: str) -> dict:
    dev = rank_device(rank, device_type)
    world = dist.get_world_size()
    base = torch.arange(4, dtype=torch.float32, device=dev)

    def all_reduce():
        t = base + rank
        dist.all_reduce(t)
        return torch.equal(t.cpu(), 2 * torch.arange(4.0) + 1)

    def broadcast():
        t = base + 10 * rank
        dist.broadcast(t, src=0)
        return torch.equal(t.cpu(), torch.arange(4.0))

    def all_gather():
        out = [torch.empty_like(base) for _ in range(world)]
        dist.all_gather(out, base + rank)
        return torch.equal(torch.cat(out).cpu(),
                           torch.cat([torch.arange(4.0),
                                      torch.arange(4.0) + 1]))

    def all_gather_into_tensor():
        out = torch.empty(world * 4, device=dev)
        dist.all_gather_into_tensor(out, base + rank)
        return torch.equal(out.cpu(), torch.cat([torch.arange(4.0),
                                                 torch.arange(4.0) + 1]))

    def reduce_scatter_tensor():
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, base + rank)
        want = (2 * torch.arange(4.0) + 1)[2 * rank: 2 * rank + 2]
        return torch.equal(out.cpu(), want)

    def all_to_all_single():
        out = torch.empty(4, device=dev)
        dist.all_to_all_single(out, base + 10 * rank)
        want = torch.tensor([0.0, 1.0, 10.0, 11.0]) + 2 * rank
        return torch.equal(out.cpu(), want)

    def barrier():
        dist.barrier()
        return True

    def dtensor_fsdp_gather():
        from torch.distributed.tensor import (Partial, Replicate, Shard,
                                              distribute_tensor)
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh((world,), ("data",), device_type=dev.type)
        w = torch.nn.Parameter(distribute_tensor(
            torch.ones(4, 2, device=dev), mesh, [Shard(0)]))
        full = w.redistribute(mesh, [Replicate()]).to_local(
            grad_placements=[Partial()])
        loss = ((rank + 1) * full).sum()
        (g,) = torch.autograd.grad(loss, [w])
        return torch.equal(g.to_local().cpu(), torch.full((2, 2), 3.0))

    fn = locals()[op]
    try:
        return {"op": op, "ok": bool(fn()), "error": None}
    except Exception as e:                # noqa: BLE001 — the probe's result
        return {"op": op, "ok": False,
                "error": f"{type(e).__name__}: {e}"[:300]}


OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
       "reduce_scatter_tensor", "all_to_all_single", "barrier",
       "dtensor_fsdp_gather")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    for op in OPS:
        # one pair of processes an op: a collective that crashes its
        # ranks (gloo on a CUDA tensor can) names itself
        try:
            row = spawn_ranks(_probe, 2, (args.device, op),
                              timeout_s=60.0)[0]
        except (RuntimeError, TimeoutError) as e:
            row = {"op": op, "ok": False,
                   "error": f"{type(e).__name__}: {e}"[-300:]}
        print(json.dumps({"device": args.device, "torch": torch.__version__,
                          **row}), flush=True)


if __name__ == "__main__":
    main()
