"""Multi-pod dry-run: rank 0's program of every (arch x shape x mesh) cell
(PyTorch port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell for 512 placeholder host
devices and reads XLA's memory and cost analyses. The port runs one
process a rank, so its dry-run runs one rank's program: it joins a
process group of the production mesh's size as rank 0 on torch's
``fake`` backend (``launch/mesh.py::fake_world``: no other rank exists,
every collective returns at once), builds the cell on the meta device
(``launch/cells.py``: shapes and dtypes, no storage; the counterpart of
the reference's placeholder devices, which compute nothing either) and
runs the step once under three instruments:

  * :class:`CollectiveCounter` counts the raw ``torch.distributed`` calls
    the step makes (the ``c10d`` ops they dispatch to) by the reference's
    five kinds, with the bytes of their results, as the reference's
    ``parse_collectives`` counts result shapes (``collective-permute``
    stays 0: the port makes none);
  * ``torch.utils.flop_counter.FlopCounterMode`` counts the FLOPs of the
    ATen products (matmuls, convolutions, attention);
  * :class:`LiveBytes` follows every tensor storage the step makes until
    it is freed, rounded as the CUDA caching allocator rounds a block,
    and gives rank 0's peak above its arguments.

It writes one JSON record a cell under ``--out-dir`` (default
``dryrun_torch/`` at the repo root), with the reference's keys where they
mean the same thing: ``memory.argument_size_in_bytes`` (rank 0's blocks
of parameters, optimizer state and batch or cache),
``temp_size_in_bytes`` (the peak above them), ``output_size_in_bytes``
(new tensors returned), ``alias_size_in_bytes`` (arguments the step
writes in place: the parameters), ``flops``, ``collectives``. What has
no counterpart is not faked: ``bytes_accessed`` and ``hlo_lines`` are
null, ``generated_code_size_in_bytes`` is 0, and ``build_s``/``run_s``
stand where ``lower_s``/``compile_s`` stood. The port runs every layer,
so ``flops_total``/``collectives_total`` equal ``flops``/``collectives``
(no per-layer extrapolation).

A retrieval cell's search syncs with the host every wave and so cannot
run on meta. Without a shard (``index=None``) its record gives the
arguments from shapes and counts the collectives of rank 0's
``distributed_retrieve`` run on the CPU over a small synthetic shard at
the cell's per-rank batch and k (its all-gathers and counter all-reduce
depend on those alone); ``temp_size_in_bytes`` and ``flops`` are null.
``index=`` takes a real shard (``chip_smoke.py`` passes one on the card).

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
      [--force] [--out-dir D]
  python -m repro_torch.launch.dryrun --cell ARCH SHAPE MESH [--cell ...]
  python -m repro_torch.launch.dryrun --table [--out-dir D]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

OUT_DIR = Path(__file__).resolve().parents[3] / "dryrun_torch"

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# the c10d ops that torch.distributed's calls dispatch to, by the
# reference's kind; each one's first argument holds its result buffers
_C10D_KIND = {
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
}
# the CUDA caching allocator's smallest block and block granularity
_BLOCK = 512


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def tensors(tree) -> list[torch.Tensor]:
    """Every tensor of ``tree`` (dicts, lists, tuples, dataclasses, a
    module's parameters; a ``DTensor`` as its local block), each once."""
    out: dict[int, torch.Tensor] = {}
    _collect(tree, out)
    return list(out.values())


def _collect(x, out: dict) -> None:
    import dataclasses as dc

    from torch import nn
    if isinstance(x, torch.Tensor):
        x = _local(x)
        out.setdefault(id(x), x)
    elif isinstance(x, nn.Module):
        for p in x.parameters():
            _collect(p, out)
    elif isinstance(x, dict):
        for v in x.values():
            _collect(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _collect(v, out)
    elif dc.is_dataclass(x) and not isinstance(x, type):
        for f in dc.fields(x):
            _collect(getattr(x, f.name), out)


def nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class CollectiveCounter(TorchDispatchMode):
    """Counts the ``c10d`` collectives dispatched inside it by the
    reference's kinds: ``{kind: {"count", "bytes"}}``, bytes those of
    the results (a gather's whole output, a reduce-scatter's chunk).
    A ``c10d`` op of no kind raises: nothing goes uncounted."""

    def __init__(self):
        super().__init__()
        self.counts = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "c10d":
            name = func._schema.name.split("::")[-1]
            kind = _C10D_KIND.get(name)
            if kind is None:
                raise ValueError(f"uncounted collective c10d::{name}")
            self.counts[kind]["count"] += 1
            self.counts[kind]["bytes"] += nbytes(
                t for t in tree_leaves(args[0])
                if isinstance(t, torch.Tensor))
        return func(*args, **(kwargs or {}))


class LiveBytes(TorchDispatchMode):
    """The bytes of live tensor storage while the code inside runs, each
    storage rounded up to the CUDA caching allocator's 512-byte blocks:
    ``peak`` is the most ever live above ``held`` (the storages of the
    tensors given, live before it starts), ``written`` the held storages
    an in-place op wrote. A storage counts from the op that made it until
    it is freed (``weakref.finalize`` on it), on any device, the meta
    device too."""

    def __init__(self, held=()):
        super().__init__()
        self.held = {_key(t) for t in held}
        self.live = self.peak = 0
        self.written: set[int] = set()
        self._sizes: dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.held or key in self._sizes:
            return
        n = st.nbytes()
        n = -(-n // _BLOCK) * _BLOCK
        self._sizes[key] = n
        weakref.finalize(st, self._free, key)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for a, v in zip(func._schema.arguments,
                        list(args) + [kwargs.get(a.name) for a in
                                      func._schema.arguments[len(args):]]):
            if a.alias_info is not None and a.alias_info.is_write:
                for t in tree_leaves(v):
                    if isinstance(t, torch.Tensor) and \
                            _key(_local(t)) in self.held:
                        self.written.add(_key(_local(t)))
        out = func(*args, **kwargs)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and not t.is_sparse:
                self._track(_local(t))
        return out


@contextlib.contextmanager
def _world(size: int):
    """A default group of ``size`` ranks: the one joined already, or a
    fake one joined (as rank 0) and left around the code inside."""
    from repro_torch.launch.mesh import fake_world
    if dist.is_initialized():
        if dist.get_world_size() != size:
            raise ValueError(f"the joined group has "
                             f"{dist.get_world_size()} ranks; the mesh "
                             f"needs {size}")
        yield
        return
    with fake_world(size):
        yield


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _retrieval_collectives(shape: str, mesh, multi_pod: bool) -> dict:
    """Rank 0's collectives in ``distributed_retrieve`` at the cell's
    per-rank batch and k, run on the CPU over the golden world's index
    (600 docs): the merges' all-gathers and the counters' all-reduce
    depend on the batch, k and the mesh alone."""
    from repro_torch.core.search import SearchConfig
    from repro_torch.core.types import QueryBatch
    from repro_torch.data.synthetic import make_corpus, make_queries
    from repro_torch.launch.cells import RETRIEVAL_SHAPES
    from repro_torch.serving.engine import distributed_retrieve
    from repro_torch.tools.golden_world import GOLDEN_SPEC, golden_world
    spec = RETRIEVAL_SHAPES[shape]
    index, _ = golden_world("cpu")
    _, doc_topic = make_corpus(GOLDEN_SPEC)
    q, _ = make_queries(GOLDEN_SPEC, spec["batch"], doc_topic, seed=779)
    q = QueryBatch(tids=q.tids, tw=q.tw, mask=q.mask, vocab=q.vocab)
    cfg = SearchConfig(k=spec["k"], bounds_impl="gemm")
    counter = CollectiveCounter()
    with counter:
        distributed_retrieve(index, q, cfg, mesh, multi_pod=multi_pod)
    return counter.counts


def run_cell(arch: str, shape: str, mesh_kind: str, save: bool = True,
             device: str | torch.device = "meta", index=None,
             out_dir: str | Path | None = None, repeat: int = 0) -> dict:
    """Build and run rank 0's program of one cell on ``device`` (meta: no
    storage) under a group of the mesh's size (a fake one joined here
    unless one is joined), and return (and with ``save`` write) its
    record. ``index``: a retrieval cell's shard for rank 0 (on
    ``device``). ``repeat`` runs the step that many times more without
    the instruments and records the fastest as ``step_ms`` (rank 0's
    compute: the fake group's collectives move nothing). A failure is
    recorded, not raised."""
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_production_mesh
    device = torch.device(device)
    multi_pod = mesh_kind == "multi"
    n_dev = 512 if multi_pod else 256
    rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                 "n_devices": n_dev, "device": str(device),
                 "status": "error"}
    t0 = time.perf_counter()
    try:
        with _world(n_dev):
            mesh = make_production_mesh(
                multi_pod=multi_pod,
                device_type="cuda" if device.type == "cuda" else "cpu")
            plan = build_cell(arch, shape, mesh, multi_pod)
            rec.update({"mode": plan.mode, "model_flops": plan.model_flops,
                        "notes": plan.notes})
            prog = (plan.build(device, index=index)
                    if plan.mode == "retrieve" else plan.build(device))
            args = tensors(prog.args)
            t_build = time.perf_counter() - t0
            memory = {"argument_size_in_bytes": nbytes(args),
                      "output_size_in_bytes": 0, "temp_size_in_bytes": None,
                      "generated_code_size_in_bytes": 0,
                      "alias_size_in_bytes": 0}
            if plan.mode == "retrieve" and device.type == "meta":
                flops, colls = None, _retrieval_collectives(shape, mesh,
                                                            multi_pod)
                t_run = 0.0
            else:
                from torch.utils.flop_counter import FlopCounterMode
                flop_mode = FlopCounterMode(display=False)
                counter, live = CollectiveCounter(), LiveBytes(args)
                _sync(device)
                t1 = time.perf_counter()
                with flop_mode, counter, live:
                    out = prog.run()
                    _sync(device)
                t_run = time.perf_counter() - t1
                held = {_key(t): t for t in args}
                outs = tensors(out)
                aliased = {_key(t) for t in outs} & held.keys() \
                    | live.written
                memory.update(
                    temp_size_in_bytes=live.peak,
                    output_size_in_bytes=nbytes(
                        t for t in outs if _key(t) not in held),
                    alias_size_in_bytes=nbytes(held[k] for k in aliased))
                flops, colls = float(flop_mode.get_total_flops()), \
                    counter.counts
                # the repeats start from the arguments alone
                del out, outs, held
                times = []
                for _ in range(repeat):
                    t1 = time.perf_counter()
                    prog.run()
                    _sync(device)
                    times.append(time.perf_counter() - t1)
                if times:
                    rec["step_ms"] = min(times) * 1e3
        rec.update({
            "status": "ok", "build_s": round(t_build, 2),
            "run_s": round(t_run, 2), "memory": memory,
            "flops": flops, "flops_total": flops,
            "bytes_accessed": None, "bytes_total": None, "hlo_lines": None,
            "collectives": colls, "collectives_total": colls})
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.perf_counter() - t0, 2)
    if save:
        d = Path(out_dir) if out_dir is not None else OUT_DIR
        d.mkdir(parents=True, exist_ok=True)
        with open(d / f"{arch}__{shape}__{mesh_kind}.json", "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def per_device_gib(rec: dict) -> float:
    mem = rec["memory"]
    return (mem["argument_size_in_bytes"]
            + (mem["temp_size_in_bytes"] or 0)) / 2 ** 30


def record_line(rec: dict) -> str:
    tag = "OK " if rec["status"] == "ok" else "FAIL"
    head = f"[{tag}] {rec['arch']:22s} {rec['shape']:14s} {rec['mesh']:6s} "
    if rec["status"] != "ok":
        return head + rec["error"]
    flops = "n/a" if rec["flops"] is None else f"{rec['flops']:.3g}"
    return (head + f"run={rec['run_s']:.1f}s "
            f"mem/dev={per_device_gib(rec):.2f}GiB flops={flops}")


def table(out_dir: str | Path) -> list[str]:
    """The records under ``out_dir`` as markdown rows, one a cell with
    its meshes side by side (single / multi): GiB a rank (arguments +
    temp), whether that fits an 80 GB card, the FLOPs of all ranks over
    MODEL_FLOPS (each rank's times the mesh's size), and the GB of each
    collective kind a rank moves."""
    from repro_torch.launch.cells import all_cells
    kinds = COLLECTIVES[:4]
    rows = ["| cell | GiB a rank | fits 80 GB | ranks x FLOPs / MODEL_FLOPS "
            "| " + " | ".join(f"{k} GB" for k in kinds) + " |",
            "|---" * (4 + len(kinds)) + "|"]

    def both(recs, fn):
        return " / ".join("-" if r is None or r["status"] != "ok"
                          else fn(r) for r in recs)
    for arch, shape in all_cells():
        recs = []
        for mk in ("single", "multi"):
            path = Path(out_dir) / f"{arch}__{shape}__{mk}.json"
            recs.append(json.loads(path.read_text()) if path.exists()
                        else None)
        if all(r is None for r in recs):
            continue
        cols = [both(recs, lambda r: f"{per_device_gib(r):.2f}"),
                both(recs, lambda r: "yes" if per_device_gib(r) * 2 ** 30
                     < 80e9 else "no"),
                both(recs, lambda r: "n/a" if r["flops"] is None else
                     f"{r['flops'] * r['n_devices'] / r['model_flops']:.2f}")]
        cols += [both(recs, lambda r, k=k: f"{r['collectives'][k]['bytes'] / 1e9:.3g}")
                 for k in kinds]
        rows.append(f"| {arch} {shape} | " + " | ".join(cols) + " |")
    return rows


def main(argv=None) -> None:
    from repro_torch.launch.cells import all_cells
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cell", nargs=3, action="append", default=[],
                    metavar=("ARCH", "SHAPE", "MESH"),
                    help="one cell on one mesh (repeatable)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    ap.add_argument("--table", action="store_true",
                    help="print the records under --out-dir as a "
                         "markdown table and run nothing")
    args = ap.parse_args(argv)
    if args.table:
        print("\n".join(table(args.out_dir)))
        return

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = all_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    elif not args.cell:
        ap.error("--arch/--shape, --cell or --all")
    else:
        cells = []
    runs = [(a, s, mk) for a, s in cells for mk in meshes] + [
        tuple(c) for c in args.cell]

    n_ok = n_fail = n_skip = 0
    for arch, shape, mk in runs:
        path = os.path.join(args.out_dir, f"{arch}__{shape}__{mk}.json")
        if not args.force and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("status") == "ok":
                    n_skip += 1
                    continue
        rec = run_cell(arch, shape, mk, out_dir=args.out_dir)
        if rec["status"] == "ok":
            n_ok += 1
        else:
            n_fail += 1
        print(record_line(rec), flush=True)
    print(f"done: ok={n_ok} fail={n_fail} skipped={n_skip}", flush=True)


if __name__ == "__main__":
    main()
