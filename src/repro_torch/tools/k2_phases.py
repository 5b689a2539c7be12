"""Where K2's time goes, phase by phase, on the card.

    PYTHONPATH=src python -m repro_torch.tools.k2_phases

Builds ``kernels/csrc/score_queue.cu`` several times, each with one or
more phases cut out of the kernel by rewriting its loop bounds in a copy
of the source, and times each build (CUDA events, warmed, median of
repeats) on one synthetic wave at the MS MARCO shape of ``chip_smoke.py``'s
first 64-query wave: 32 tiles of 2560 x 128 slots, block_q 64, block_d
160, about 59 terms a doc, about 40% of them in the query block's union
of about 1,200 terms. The cut builds compute wrong scores: they exist
only to be timed. Prints one JSON line per build and one for the NEG fill
alone, with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch import device as dev
from repro_torch.core.plan import plan_wave
from repro_torch.core.types import QueryBatch
from repro_torch.kernels.query_terms import query_terms
from repro_torch.kernels.score_cluster_batch import ops

V, G, DP, TP, BQ, BD, N_SEG = 30522, 32, 2560, 128, 64, 160, 8

# phase -> (text in score_queue.cu, its replacement): each empties a loop
CUTS = {
    "transpose": ("e < nd * tp; e += kThreads) {",
                  "e < 0; e += kThreads) {"),
    "pass1+pass2": ("for (int dl = threadIdx.x; dl < nd; dl += kThreads) {",
                    "for (int dl = threadIdx.x; dl < 0; dl += kThreads) {"),
    "pass2": ("for (int h = 0; h < nh; ++h) {",
              "for (int h = 0; h < 0; ++h) {"),
    "store": ("e < bq * nd; e += kThreads) {",
              "e < 0; e += kThreads) {"),
}
BUILDS = {"full": (), "no_pass2": ("pass2",),
          "no_compute": ("pass1+pass2",), "no_store": ("store",),
          "no_transpose": ("transpose",),
          "copies_only": ("transpose", "pass1+pass2", "store")}


def build(cuts: tuple, out_dir: Path) -> ctypes.CDLL:
    src = (dev.CSRC / "score_queue.cu").read_text()
    for name in cuts:
        old, new = CUTS[name]
        if src.count(old) != 1:
            raise RuntimeError(f"cut {name!r}: anchor not found once")
        src = src.replace(old, new)
    tag = "_".join(cuts) or "full"
    cu = out_dir / f"sq_{tag}.cu"
    cu.write_text(src)
    lib = out_dir / f"libsq_{tag}.so"
    subprocess.run([dev._nvcc(), *dev.NVCC_FLAGS, "-I", str(dev.CSRC),
                    "-shared", str(cu), "-o", str(lib)], check=True,
                   capture_output=True)
    so = ctypes.CDLL(str(lib))
    so.score_queue.argtypes = dev._SIGNATURES["score_queue"]
    so.score_queue.restype = ctypes.c_int
    return so


def synthetic_wave(seed: int = 0, device: str = "cuda"):
    """Index arrays of 32 clusters, a 64-query term layout and a plan that
    walks every sub-tile of every tile for the one query block."""
    rng = np.random.default_rng(seed)
    pool = rng.choice(V, 4000, replace=False)   # ~1,230 distinct picked
    q_tids = np.stack([rng.choice(pool, 23, replace=False)
                       for _ in range(BQ)]).astype(np.int32)
    queries = QueryBatch(
        tids=torch.from_numpy(q_tids),
        tw=torch.from_numpy(rng.random((BQ, 23)).astype(np.float32) + 0.1),
        mask=torch.ones((BQ, 23), dtype=torch.bool), vocab=V).to(device)
    union = np.unique(q_tids)
    nnz = np.clip(rng.poisson(59, (G, DP)), 4, TP)
    tids = np.full((G, DP, TP), V, np.int32)
    tw = np.zeros((G, DP, TP), np.uint8)
    slot = np.arange(TP)[None, None]
    live = slot < nnz[..., None]
    in_union = rng.random((G, DP, TP)) < 0.4
    draw = np.where(in_union, union[rng.integers(0, len(union), (G, DP, TP))],
                    rng.integers(0, V, (G, DP, TP)))
    tids[live] = draw[live]
    tw[live] = rng.integers(1, 256, int(live.sum()))
    doc_tids = torch.from_numpy(tids.astype(np.uint16)).to(device)
    doc_tw = torch.from_numpy(tw).to(device)
    seg_mod = torch.from_numpy(rng.integers(0, N_SEG, (G, DP)).astype(
        np.int32)).to(device)
    doc_mask = torch.ones((G, DP), dtype=torch.bool, device=device)
    seg_admit = torch.ones((BQ, G, N_SEG), dtype=torch.bool, device=device)
    cids = torch.arange(G, dtype=torch.int32, device=device)
    plan = plan_wave(cids, torch.ones(G, dtype=torch.bool, device=device),
                     seg_admit.any(-1), seg_admit, BQ, seg_mod, doc_mask,
                     block_d=BD)
    return doc_tids, doc_tw, seg_mod, doc_mask, query_terms(queries, BQ), plan


def time_call(fn, reps: int = 50, rounds: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def main() -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    tids, tw, seg_mod, doc_mask, terms, plan = synthetic_wave()
    n_db = DP // BD
    dc, smem = ops.doc_chunk(BD, TP, 2, BQ, N_SEG, terms.n_words,
                             terms.max_entries)
    out = torch.empty((BQ, G, DP), device="cuda")
    admit = plan.admit.contiguous()
    seg_admit = plan.seg_admit.contiguous()
    scale = torch.ones((), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        for name, cuts in BUILDS.items():
            so = build(cuts, Path(tmp))

            def launch():
                rc = so.score_queue(
                    tids.data_ptr(), 2, tw.data_ptr(),
                    terms.bitmap.data_ptr(), terms.prefix.data_ptr(),
                    terms.term_ptr.data_ptr(), terms.ent_q.data_ptr(),
                    terms.ent_w.data_ptr(), terms.n_words,
                    terms.max_entries, plan.tile_cids.data_ptr(),
                    plan.tile_pos.data_ptr(), plan.n_tiles.data_ptr(),
                    plan.qblock.data_ptr(), plan.n_qblock.data_ptr(),
                    plan.dblock.data_ptr(), plan.n_dblock.data_ptr(),
                    admit.data_ptr(), seg_admit.data_ptr(), N_SEG,
                    seg_mod.data_ptr(), doc_mask.data_ptr(),
                    scale.data_ptr(),
                    out.data_ptr(), BQ, G, 1, n_db, DP, TP, BQ, BD, dc,
                    stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            print(json.dumps({"build": name, "cut": list(cuts),
                              "kernel_ms": time_call(launch),
                              "doc_chunk": dc, "smem_bytes": smem}),
                  flush=True)
    fill = time_call(lambda: torch.full((BQ, G, DP), -1.0, device="cuda"))
    print(json.dumps({"build": "neg_fill_only", "ms": fill}), flush=True)
    print(json.dumps({"card": card, "walked_docs": int(plan.walked_docs()),
                      "union_terms": int(terms.n_union[0])}), flush=True)


if __name__ == "__main__":
    main()
