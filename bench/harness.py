"""One run of one cell: the world from the seed, the program's index and
engine, the measured window, the comparison with the reference, and the
result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own that this module finds by the name
``BENCHMARK.json`` gives it:

  * ``workloads[i]`` names a configuration and a mix;
  * ``configs[j]["file"]``: the deployment (corpus distribution, index
    geometry, the program's ``SearchConfig`` and the query pool's size);
  * ``bench/traffic/<mix>.json``: the batch, ``k``, the query
    distribution, the closed loop and how many served batches the
    reference checks;
  * ``bench/metrics/<metric>.py``: a reader ``read(records)`` of one
    per-layer metric (None where it finds nothing to read).

The program is the PyTorch port (``repro_torch``, under ``src/``); the
reference is ``bench/reference``. Nothing here imports JAX or the JAX
package.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from bench import check, devtrace, world
from bench.reference import asc

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARMUP_BATCHES = 2
TRACE_BATCHES = 8


def load_cell(root: Path, workload: str) -> tuple[dict, dict, dict, dict]:
    """(benchmark, workload entry, configuration, mix) of a cell."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / entry["file"]).read_text())
    mix = json.loads((root / "bench" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    return bench, cell, cfg, mix


def reader(name: str):
    """``read`` of ``bench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_record(device: torch.device, count: int) -> dict:
    """The card as the run found it: name, count, and what nvidia-smi
    reads of its power limit and clocks."""
    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": count}
    fields = ("power.limit", "clocks.sm", "clocks.max.sm", "clocks.mem")
    try:
        line = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(fields)}",
             "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
            capture_output=True, text=True, check=True,
            timeout=30).stdout.strip().splitlines()[0]
        for f, v in zip(fields, line.split(",")):
            rec[f.replace(".", "_")] = float(v)
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        rec["nvidia_smi"] = "not read"
    return rec


class Pool:
    """The mix's query pool on the device; batch ``b`` is rows ``offset +
    b * size + i`` (mod the pool) for i < size."""

    def __init__(self, tids, tw, vocab: int, size: int, offset: int):
        self.tids, self.tw, self.vocab = tids, tw, vocab
        self.size, self.offset = size, offset

    @classmethod
    def seeded(cls, tids, tw, vocab: int, size: int, seed: int) -> "Pool":
        g = torch.Generator().manual_seed(world.sub_seed(seed, "offset"))
        return cls(tids, tw, vocab, size,
                   int(torch.randint(0, tids.shape[0], (1,), generator=g)))

    def rows(self, b: int) -> torch.Tensor:
        n = self.tids.shape[0]
        start = (self.offset + b * self.size) % n
        return (start + torch.arange(self.size, device=self.tids.device)) % n

    def batch(self, b: int):
        from repro_torch.core.types import QueryBatch
        r = self.rows(b)
        t = self.tids[r]
        return QueryBatch(tids=t, tw=self.tw[r], mask=t >= 0,
                          vocab=self.vocab)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def draw_world(cfg: dict, query_spec: dict, seed: int, device) -> tuple:
    """The corpus and the query pool drawn on ``device`` from the seed, the
    clusters assigned; the corpus comes back to the host and leaves the
    device: (tids, tw, mask, assign) as numpy, (pool tids, pool weights)
    on the device."""
    corpus = world.make_corpus(cfg["corpus"], seed, device)
    pool_t, pool_w = world.make_queries(cfg["corpus"], query_spec,
                                        cfg["queries"]["pool"], seed, device)
    assign = world.topic_chunked_assign(corpus.topic,
                                        cfg["index"]["m"]).cpu().numpy()
    tids, tw = corpus.tids.cpu().numpy(), corpus.tw.cpu().numpy()
    del corpus
    gc.collect()
    return tids, tw, tids >= 0, assign, pool_t, pool_w


def compare(ref_ix, pool: "Pool", batches: list[int], ids: torch.Tensor,
            scores: torch.Tensor, k: int, mu: float, eta: float,
            group_size: int) -> tuple[dict, dict]:
    """The compared numbers (bench/check.py) of the served answers of
    ``batches`` (``ids``/``scores`` indexed by batch) against the
    reference's walk of the same queries, and what they were read from
    (the queries checked, those that departed as (batch, row, gap), and
    the widest gap of any query)."""
    doc_gap, off, n_q, widest = 0.0, [], 0, 0.0
    dev = pool.tids.device
    for b in batches:
        r = pool.rows(b)
        qt, qw = pool.tids[r], pool.tw[r]
        ref = asc.search(ref_ix, qt, qw, k, mu, eta, group_size)
        got_i, got_s = ids[b].to(dev), scores[b].to(dev)
        gaps = check.query_gaps(got_i, got_s, ref["ids"], ref["scores"])
        n_q += gaps.shape[0]
        widest = max(widest, float(gaps.max()) if gaps.numel() else 0.0)
        off += [[b, int(i), float(gaps[i])]
                for i in torch.nonzero(gaps > check.QUERY_GAP).flatten()]
        doc_gap = max(doc_gap, check.doc_score_gap(
            got_i, got_s, ref_ix.tids.shape[0],
            lambda safe: asc.exact_scores(ref_ix, qt, qw, safe)))
    numbers = {"queries_off_share": len(off) / max(n_q, 1),
               "doc_score_gap": doc_gap}
    return numbers, {"queries": n_q, "off": off[:8],
                     "widest_score_gap": widest}


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str | torch.device,
             t_process: float | None = None, log=None) -> dict:
    """One run; returns the result line's object. ``device`` is the card
    (the command) or the CPU (the tests)."""
    from repro_torch.core.index import build_index
    from repro_torch.core.search import SearchConfig
    from repro_torch.core.types import SparseDocs
    from repro_torch.serving.engine import RetrievalEngine

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    t0 = time.perf_counter() if t_process is None else t_process
    device = torch.device(device)
    bench, cell, cfg, mix = load_cell(root, workload)
    corpus_spec, ix_spec = cfg["corpus"], cfg["index"]
    m, n_seg, d_pad = ix_spec["m"], ix_spec["n_seg"], ix_spec["d_pad"]
    V = corpus_spec["vocab"]
    query_spec = dict(mix["queries"], q_pad=cfg["queries"]["q_pad"])
    B, k = mix["batch"], mix["k"]
    if mix["loop"] != "closed" or mix["clients"] != 1:
        raise ValueError("the harness drives a closed loop of one client")
    build_seed = world.sub_seed(seed, "index")

    # ---- set-up: the world on the device, the index, the engine ----
    t_draw = time.perf_counter()
    (tids_h, tw_h, mask_h, assign, pool_t,
     pool_w) = draw_world(cfg, query_spec, seed, device)
    draw_s = time.perf_counter() - t_draw
    mean_terms = float(mask_h.sum()) / mask_h.shape[0]
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    docs = SparseDocs(tids=torch.from_numpy(tids_h),
                      tw=torch.from_numpy(tw_h),
                      mask=torch.from_numpy(mask_h), vocab=V)
    t_build = time.perf_counter()
    index = build_index(docs, assign, m=m, n_seg=n_seg, d_pad=d_pad,
                        seed=build_seed, device=device)
    _sync(device)
    build_s = time.perf_counter() - t_build
    del docs
    search_cfg = SearchConfig(k=k, **cfg["search"])
    engine = RetrievalEngine(index, search_cfg, device=device)
    pool = Pool.seeded(pool_t, pool_w, V, B, seed)
    for w in range(WARMUP_BATCHES):
        engine.warmup(pool.batch(-1 - w))
    _sync(device)
    setup_s = time.perf_counter() - t0
    log(f"[bench] {workload}: set-up {setup_s:.1f} s (index build "
        f"{build_s:.1f} s, {index.nbytes() / 1e9:.3f} GB)")

    # ---- the window: one client, batches back to back ----
    prof = None
    outs, times, waves = [], [], []
    with (devtrace.stage_ranges() if trace
          else contextlib.nullcontext()):
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            trace_file = tempfile.NamedTemporaryFile(
                prefix="bench_trace_", suffix=".json", delete=False)
            trace_file.close()
            prof = torch.profiler.profile(
                activities=acts, schedule=torch.profiler.schedule(
                    wait=0, warmup=1, active=TRACE_BATCHES, repeat=1),
                on_trace_ready=lambda p: p.export_chrome_trace(
                    trace_file.name))
            prof.start()
        t_start = time.perf_counter()
        b, trace_from, trace_to = 0, None, None
        least = TRACE_BATCHES + 1 if trace else 1
        while True:
            t_batch = time.perf_counter()
            qb = pool.batch(b)
            t1 = time.perf_counter()
            out = engine.search(qb)
            t2 = time.perf_counter()
            times.append(t2 - t1)
            waves.append(engine.last_run["waves"])
            outs.append((out.doc_ids, out.scores, out.n_scored_clusters,
                         out.n_scored_docs))
            if trace and 1 <= b <= TRACE_BATCHES:
                trace_from = trace_from or t_batch
                trace_to = t2
            b += 1
            if prof is not None and b <= TRACE_BATCHES + 1:
                prof.step()
            if t2 - t_start >= seconds and b >= least:
                break
        window_s = t2 - t_start
        if prof is not None:
            prof.stop()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    n_b = len(outs)
    ids = torch.stack([o[0] for o in outs]).cpu()
    scores = torch.stack([o[1] for o in outs]).cpu()
    clusters = torch.stack([o[2] for o in outs]).long().sum(1).cpu()
    scored = torch.stack([o[3] for o in outs]).long().sum(1).cpu()
    records = {
        "m": m, "k": k, "batch": B, "build_index_s": build_s,
        "batches": {"n_q": [B] * n_b, "waves": waves,
                    "scored_clusters": clusters.tolist(),
                    "scored_docs": scored.tolist()},
        "trace": None}
    result_device = (card_record(device, cell["chips"])
                     if device.type == "cuda" else
                     {"platform": "cpu", "kind": "cpu", "count": 1})
    result_device["memory_peak_bytes"] = int(peak)
    breakdown = None
    if prof is not None:
        try:
            tr = devtrace.read_trace(trace_file.name)
        finally:
            os.unlink(trace_file.name)
        pairs = int(scored[1:TRACE_BATCHES + 1].sum())
        stages = stage_work(engine, pool, ids, scores, log).totals(pairs)
        for s, w in stages.items():
            w["device_s"] = tr["stage_s"].get(s, 0.0)
        traced_s = trace_to - trace_from
        records["trace"] = {"window_s": traced_s, "busy_s": tr["busy_s"],
                            "stages": stages}
        result_device.update(busy_s=tr["busy_s"], window_s=traced_s)
        breakdown = {"device_ops": tr["device_ops"],
                     "idle_gaps": tr["idle_gaps"]}
        prof = None
    failed = _malformed(ids, scores, k, int(mask_h.shape[0]))

    # ---- the program's state freed; the reference on a sample ----
    del engine, index, outs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref_ix = asc.derive_index(tids_h, tw_h, mask_h, assign, m, n_seg, d_pad,
                              build_seed, V, device)
    gs = torch.Generator().manual_seed(world.sub_seed(seed, "check"))
    n_check = min(mix["check_batches"], n_b)
    sample = sorted(torch.randperm(n_b, generator=gs)[:n_check].tolist())
    numbers, read_from = compare(ref_ix, pool, sample, ids, scores, k,
                                 search_cfg.mu, search_cfg.eta,
                                 search_cfg.group_size)
    ref_s = time.perf_counter() - t_ref
    correct, checks = check.verdict(numbers)
    log(f"[bench] reference over batches {sample}: {ref_s:.1f} s")

    # ---- the line ----
    if trace:
        metrics = {}
        for mt in bench["per_layer"]:
            if "workloads" in mt and workload not in mt["workloads"]:
                continue
            v = reader(mt["name"])(records)
            if v is None:
                continue
            extra = v if isinstance(v, dict) else {"value": v}
            metrics[mt["name"]] = {"value": extra.pop("value"),
                                   "unit": mt["unit"], **extra}
    else:
        e2e = {
            "qps": n_b * B / window_s,
            "batch_p90_ms": _p90(times) * 1e3,
            "device_peak_gb": peak / 1e9,
            "setup_s": setup_s,
        }
        metrics = {mt["name"]: {"value": e2e[mt["name"]], "unit": mt["unit"]}
                   for mt in bench["end_to_end"]
                   if "workloads" not in mt or workload in mt["workloads"]}
    line = {"correct": correct, "attempted": n_b * B, "failed": failed,
            "metrics": metrics, "device": result_device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["world"] = {"docs": int(mask_h.shape[0]), "mean_doc_terms":
                     mean_terms, "draw_s": draw_s, "build_index_s": build_s,
                     "batches": n_b, "window_s": window_s,
                     "mean_waves": statistics.fmean(waves),
                     "reference_s": ref_s, "checked_batches": sample,
                     "checked": read_from,
                     "batch_ms_thirds": _thirds(times)}
    line["checks"] = checks
    return line


def stage_work(engine, pool: "Pool", ids: torch.Tensor,
               scores: torch.Tensor, log) -> devtrace.StageWork:
    """The work of each stage in the traced batches, noted in a second pass
    of those batches through the same engine once the window has closed,
    so the count adds nothing to the traced window. The pass has to serve
    the traced answers bit for bit; where it does not, no stage's work is
    known and their metrics are left out."""
    work = devtrace.StageWork()
    with devtrace.stage_ranges(work):
        for b in range(1, TRACE_BATCHES + 1):
            out = engine.search(pool.batch(b))
            if not (torch.equal(out.doc_ids.cpu(), ids[b])
                    and torch.equal(out.scores.cpu(), scores[b])):
                log(f"[bench] batch {b} served otherwise a second time: "
                    f"the stages' work is not counted")
                return devtrace.StageWork()
    return work


def _thirds(times: list[float]) -> list[float]:
    """Median batch time, in ms, of the window's first, middle and last
    third: whether the batches drift through the window."""
    n = len(times)
    return [statistics.median(times[i * n // 3:max((i + 1) * n // 3,
                                                   i * n // 3 + 1)]) * 1e3
            for i in range(3)]


def _p90(values: list[float]) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 90))


def _malformed(ids: torch.Tensor, scores: torch.Tensor, k: int,
               n_docs: int) -> int:
    """Queries whose answer is not k distinct in-range ids with
    non-increasing finite scores."""
    ok = (ids >= 0).all(-1) & (ids < n_docs).all(-1)
    ok &= torch.isfinite(scores).all(-1)
    ok &= (scores[..., :-1] >= scores[..., 1:]).all(-1)
    srt = torch.sort(ids, dim=-1).values
    ok &= (srt[..., 1:] != srt[..., :-1]).all(-1)
    return int((~ok).sum())


def loaded_forbidden() -> list[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX
    package."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))
