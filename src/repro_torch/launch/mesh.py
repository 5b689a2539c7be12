"""Meshes of ranks over ``torch.distributed`` (PyTorch port of
``repro/launch/mesh.py``).

Where JAX lays one program over a mesh of devices, the port runs one
process a rank: :func:`spawn_ranks` starts them (start method ``spawn``,
a ``file://`` rendezvous in a temporary directory, so no port is fixed),
each rank joins the default process group, and :func:`make_host_mesh`
names the group's axes with a ``DeviceMesh``. The group runs over nccl
when every rank owns a card (:func:`backend_for`; rank ``r`` on
``cuda:r``, bound before it joins), else over gloo (the CPU, or ranks
sharing cards); nothing falls back from one to the other, and a rank
whose collective waits past the group's timeout fails. Rank ``r`` sits at
``numpy.unravel_index(r, shape)``, the row-major order of ``jax.make_mesh``
over the same device list.

The production meshes of the reference, (16, 16) ("data", "model") and
(2, 16, 16) ("pod", "data", "model"), are :func:`make_production_mesh`
over a default group of 256 or 512 ranks. The dry-run
(``launch/dryrun.py``) joins such a group as one rank of torch's
``fake`` backend (:func:`fake_world`): no other rank runs, and every
collective returns at once without moving data, so one process can lay
out and run rank 0's program of a production mesh. Nothing here runs at
import time.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def make_host_mesh(shape=(1, 1), axes=("data", "model"),
                   device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` over the ranks of the default process
    group (which the caller has joined), one named dim per axis."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production mesh over the default process group
    (256 ranks for (16, 16), 512 for (2, 16, 16)), which the caller has
    joined (the dry-run: :func:`fake_world`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_host_mesh(shape, axes, device_type)


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """Join a default process group of ``world_size`` ranks as ``rank``,
    on torch's ``fake`` backend (no other process: a collective returns
    without moving data), and leave it on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def backend_for(world: int, device_type: str) -> str:
    """The backend a mesh of ``world`` ranks on ``device_type`` runs
    over: nccl exactly when every rank owns a card (nccl never puts two
    ranks on one card), else gloo (the CPU, or ranks sharing cards)."""
    if device_type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_device(rank: int, device_type: str,
                cards: int | None = None) -> torch.device:
    """The device a rank runs on: ``cuda:(rank mod cards)`` (``cards``
    None: every card of the machine), so ranks share cards when there are
    fewer cards than ranks. Under nccl each rank owns ``cuda:rank``,
    which :func:`spawn_ranks` bound before the rank joined its group;
    this agrees with it. A rank asked for ``cuda`` on a machine without
    a card raises."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank} was asked for {device_type!r} and "
                           f"no CUDA device is available")
    dev = torch.device("cuda", rank % (cards or torch.cuda.device_count()))
    if (dist.is_initialized() and dist.get_backend() == "nccl"
            and dev.index != torch.cuda.current_device()):
        raise RuntimeError(f"rank {rank} is bound to cuda:"
                           f"{torch.cuda.current_device()} for nccl and "
                           f"was asked for {dev}")
    torch.cuda.set_device(dev)
    return dev


# a rank stuck in a collective (or in joining its group) fails after
# this long instead of holding its peers and the caller: the process
# group's timeout, which nccl's watchdog enforces by aborting the rank
COLLECTIVE_TIMEOUT_S = 300.0


def _rank_main(rank: int, world: int, init_method: str, backend: str,
               fn, args: tuple, results,
               timeout_s: float = COLLECTIVE_TIMEOUT_S) -> None:
    try:
        kw = {}
        if backend == "nccl":
            # the card first: a communicator built before set_device
            # lands on cuda:0 for every rank
            dev = torch.device("cuda", rank)
            torch.cuda.set_device(dev)
            kw["device_id"] = dev
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s), **kw)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:               # noqa: BLE001 — reported, re-raised
        results.put((rank, False, traceback.format_exc()))
        raise


def _failures(results, rank: int, trace: str, wait_s: float = 2.0) -> str:
    """Every rank's failure that arrives within ``wait_s`` of the first:
    a rank that raises drops its connections, so its peers fail in their
    collectives too, and their reports can arrive first."""
    failed = {rank: trace}
    deadline = time.monotonic() + wait_s
    while (left := deadline - time.monotonic()) > 0:
        try:
            r, ok, out = results.get(timeout=left)
        except queue.Empty:
            break
        if not ok:
            failed[r] = out
    return "\n".join(f"rank {r} failed:\n{t}"
                     for r, t in sorted(failed.items()))


def spawn_ranks(fn, world: int, args: tuple = (), *, backend: str = "gloo",
                timeout_s: float | None = 120.0,
                collective_timeout_s: float = COLLECTIVE_TIMEOUT_S) -> list:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes that share one
    process group; returns each rank's result (picklable, on the CPU), in
    rank order.

    ``fn`` must be importable by name (spawned processes start from a
    fresh import). The first rank that raises or dies, or ``timeout_s``
    (None: no limit) without every result, kills all ranks and raises
    here: a rank left waiting in a collective never holds the caller.
    ``collective_timeout_s`` is the process group's timeout: a collective
    (or the group's join) that waits longer fails its rank. Under
    ``backend="nccl"`` rank ``r`` owns ``cuda:r``, bound before it joins
    the group; a world larger than the machine's cards raises here."""
    if backend == "nccl" and torch.cuda.device_count() < world:
        raise ValueError(f"nccl gives each of {world} ranks a card of its "
                         f"own; this machine has "
                         f"{torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, init, backend, fn, args,
                                   results, collective_timeout_s),
                             daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        got: dict[int, object] = {}
        t0 = time.monotonic()
        try:
            # a rank that exits 0 has sent its result; one that died is
            # given a last look at the queue for its traceback
            dead: dict[int, int] = {}
            while len(got) < world:
                try:
                    rank, ok, out = results.get(timeout=2.0 if dead
                                                else 1.0)
                except queue.Empty:
                    if dead:
                        raise RuntimeError(
                            f"ranks {sorted(dead)} died without a result "
                            f"(exit codes {sorted(dead.values())})"
                        ) from None
                    dead = {r: p.exitcode for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)}
                    if (timeout_s is not None
                            and time.monotonic() - t0 > timeout_s):
                        raise TimeoutError(
                            f"{world - len(got)} of {world} ranks gave no "
                            f"result within {timeout_s:.0f} s") from None
                    continue
                if not ok:
                    raise RuntimeError(_failures(results, rank, out))
                got[rank] = out
            for p in procs:
                p.join(timeout=30.0)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [got[r] for r in range(world)]
