"""The traced run: the benchmark's own ranges around each stage of the
program, the work each stage's inputs need, and what the profiler's
device trace says about them.

The stages are the four kernel wrappers, swapped through
``repro_torch.tools.plain_path.swapped_wrappers``, and
``repro_torch.core.search._merge_wave``, wrapped by name. Each call runs
inside a ``record_function`` range named ``bench.<stage>``; a device
operation belongs to the stage whose range holds the runtime call that
launched it (the profiler's chrome trace pairs the two by their
correlation id, for kernels launched through PyTorch and through the
port's ``ctypes`` library alike). What a stage's work needs is recorded
from the calls' own inputs, but not inside the traced window, where
the ranges alone are added: the harness passes the traced batches
through the same engine a second time once the profiler has stopped,
with a ``StageWork`` noting each call (the executor's admitted
documents counted on the device), and holds that pass's answers to the
traced ones bit for bit.
"""

from __future__ import annotations

import bisect
import contextlib
import json

import numpy as np
import torch

from bench import roofline

# wrapper name (as swapped_wrappers names it) -> stage
STAGES = {"segment_bound_gemm": "bounds", "plan_wave_kernel": "plan",
          "score_admitted": "score", "_merge_wave": "merge"}
PREFIX = "bench."
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


class StageWork:
    """What the stages' calls needed, accumulated over a pass of the
    traced batches after the window (the executor's count launches work
    on the device)."""

    def __init__(self):
        self.calls = {s: 0 for s in STAGES.values()}
        self.bounds = []                 # (rows, terms) per call
        self.plan_bytes = [0, 0]         # inputs, outputs
        self.score = None                # (t_pad, tid bytes, n_q, q_pad)
        self.union_docs = 0              # summed over the executor's calls
        self.merge = None                # (n_q, k)

    def note(self, stage: str, args, out) -> None:
        self.calls[stage] += 1
        if stage == "bounds":
            table, terms = args[0], args[1]
            self.bounds.append((table.shape[0], terms))
        elif stage == "plan":
            ins = [a for a in args if isinstance(a, torch.Tensor)]
            self.plan_bytes[0] += sum(t.numel() * t.element_size()
                                      for t in ins)
            self.plan_bytes[1] += sum(t.numel() * t.element_size()
                                      for t in out.values())
        elif stage == "score":
            tids, _, dseg, dmask, terms, plan = args[:6]
            self.score = (tids.shape[2], tids.element_size(),
                          terms.n_queries, terms.q_pad)
            # each wave's live documents in a segment any query admitted
            per_seg = torch.zeros((dseg.shape[0], plan.seg_admit.shape[-1]),
                                  dtype=torch.float64, device=dseg.device)
            per_seg.scatter_add_(1, dseg.long(), dmask.to(torch.float64))
            self.union_docs += int((plan.seg_admit.any(0) * per_seg).sum())
        elif stage == "merge":
            top_scores, k = args[0], args[5]
            self.merge = (top_scores.shape[0], k)

    def totals(self, pairs: int) -> dict:
        """Each stage's (bytes, ops, calls); ``pairs`` is the admitted
        (query, document) pairs of the traced batches (their TopK
        counters)."""
        out = {}
        if self.bounds:
            b = o = 0.0
            for rows, terms in self.bounds:
                live = terms.tids < terms.vocab
                union = int(torch.unique(terms.tids[live]).numel())
                x, y = roofline.bounds_work(rows, terms.n_queries,
                                            terms.q_pad, union,
                                            int(live.sum()))
                b, o = b + x, o + y
            out["bounds"] = (b, o)
        if self.calls["plan"]:
            out["plan"] = roofline.plan_work(*self.plan_bytes)
        if self.score is not None:
            t_pad, tid_bytes, n_q, q_pad = self.score
            out["score"] = roofline.score_work(
                self.union_docs, t_pad, tid_bytes, pairs, n_q, q_pad,
                self.calls["score"])
        if self.merge is not None:
            out["merge"] = roofline.merge_work(pairs, *self.merge,
                                               self.calls["merge"])
        return {s: {"bytes": b, "ops": o, "calls": self.calls[s]}
                for s, (b, o) in out.items()}


@contextlib.contextmanager
def stage_ranges(work: StageWork | None = None):
    """Every stage call inside a ``bench.<stage>`` range; with ``work``,
    its work noted outside the range."""
    import repro_torch.core.search as search_mod
    from repro_torch.tools.plain_path import swapped_wrappers

    def ranged(name, fn):
        stage = STAGES.get(name)
        if stage is None:
            return fn

        def call(*args, **kwargs):
            with torch.profiler.record_function(PREFIX + stage):
                out = fn(*args, **kwargs)
            if work is not None:
                work.note(stage, args, out)
            return out
        return call

    merge = search_mod._merge_wave
    with swapped_wrappers(ranged):
        search_mod._merge_wave = ranged("_merge_wave", merge)
        try:
            yield
        finally:
            search_mod._merge_wave = merge


def read_trace(path) -> dict:
    """From a chrome trace the profiler exported: device seconds of each
    stage, the union of device busy time, the ten device operations that
    took most time and the ten longest idle gaps, each named by the
    innermost host call open at its middle. A device operation belongs
    to the stage whose range holds the runtime call that launched it."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    dev = [e for e in events if e.get("cat") in DEVICE_KINDS]
    host = [e for e in events if e.get("cat") in HOST_KINDS]
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):])
                    for e in host if e["cat"] == "user_annotation"
                    and e["name"].startswith(PREFIX))
    starts = [r[0] for r in ranges]
    launched = {e["args"]["correlation"]: e["ts"] for e in host
                if e["cat"] in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    stage_s: dict[str, float] = {}
    by_name: dict[str, float] = {}
    spans = []
    for e in dev:
        dur = e["dur"] / 1e6
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + dur
        spans.append((e["ts"], e["ts"] + e["dur"]))
        t = launched.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= ranges[i][1]:
            stage_s[ranges[i][2]] = stage_s.get(ranges[i][2], 0.0) + dur
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for lo, hi in sorted(spans):
        if cur_e is None or lo > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((lo - cur_e, cur_e, lo))
            cur_s, cur_e = lo, hi
        else:
            cur_e = max(cur_e, hi)
    if cur_e is not None:
        busy += cur_e - cur_s
    gaps.sort(reverse=True)
    h_start = np.array([e["ts"] for e in host], dtype=np.float64)
    h_end = h_start + np.array([e["dur"] for e in host], dtype=np.float64)
    idle = []
    for length, lo, hi in gaps[:TOP]:
        mid = (lo + hi) / 2
        open_ = np.nonzero((h_start <= mid) & (h_end >= mid))[0]
        label = (host[open_[np.argmax(h_start[open_])]]["name"]
                 if open_.size else "host, between recorded calls")
        idle.append([label[:120], length / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy / 1e6, "stage_s": stage_s,
            "device_ops": [[n[:120], t] for n, t in ops],
            "idle_gaps": idle, "device_events": len(dev)}
