"""Reading the profiler's chrome trace: stage attribution through the
launching runtime call, the union of busy time, and the idle gaps."""

from __future__ import annotations

import json

import pytest

from bench import devtrace


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def test_stages_busy_and_gaps(tmp_path):
    events = [
        _x("user_annotation", "bench.score", 0, 10),
        _x("cpu_op", "aten::fill_", 1, 2),
        _x("cuda_runtime", "cudaLaunchKernel", 2, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=2),
        _x("user_annotation", "bench.merge", 20, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 21, 1, correlation=3),
        _x("cpu_op", "aten::nonzero", 40, 30),
        _x("cuda_runtime", "cudaLaunchKernel", 80, 1, correlation=4),
        # device: fill and K2 overlap, the merge's sort, one outside
        _x("kernel", "fill", 3, 4, correlation=1),
        _x("kernel", "score_queue", 6, 10, correlation=2),
        _x("kernel", "sort", 22, 8, correlation=3),
        _x("gpu_memcpy", "Memcpy DtoH", 90, 5, correlation=4),
        _x("gpu_user_annotation", "bench.score", 3, 13),
        {"ph": "i", "cat": "instant", "name": "x", "ts": 1},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    tr = devtrace.read_trace(path)
    assert tr["stage_s"] == {"score": pytest.approx(14e-6),
                             "merge": pytest.approx(8e-6)}
    # [3, 16] + [22, 30] + [90, 95]
    assert tr["busy_s"] == pytest.approx(26e-6)
    assert tr["device_ops"][0] == ["score_queue", pytest.approx(10e-6)]
    assert [g[0] for g in tr["idle_gaps"]] == [
        "aten::nonzero", "host, between recorded calls"]
    assert tr["idle_gaps"][0][1] == pytest.approx(60e-6)
    assert tr["device_events"] == 4


@pytest.mark.parametrize("same", [True, False])
def test_stage_work_comes_from_a_second_pass_that_matches(same):
    """The stages' work is noted after the window, in a pass of the
    traced batches whose answers have to equal the traced ones; the
    window's own ranges note nothing."""
    import torch

    import repro_torch.core.search as search_mod
    from bench import harness

    k, n_q = 3, 4
    served = torch.arange(harness.TRACE_BATCHES + 2)[:, None, None] \
        .expand(-1, n_q, k).to(torch.int32)

    class Engine:
        def search(self, qb):
            b = int(qb.tids[0, 0])
            top = torch.full((n_q, k), -1e9)
            s, _ = search_mod._merge_wave(
                top, torch.full((n_q, k), -1, dtype=torch.int32),
                torch.rand(n_q, 1, 5), torch.zeros(n_q),
                torch.arange(5), k)

            class Out:
                doc_ids = served[b] + (0 if same else 1)
                scores = served[b].float()
            return Out

    tids = torch.arange(40)[:, None].expand(-1, 2).contiguous()
    pool = harness.Pool(tids, torch.ones(40, 2), 50, n_q, 0)
    pool.rows = lambda b: torch.full((n_q,), b)
    logged = []
    work = harness.stage_work(Engine(), pool, served, served.float(),
                              logged.append)
    assert work.calls["merge"] == (harness.TRACE_BATCHES if same else 0)
    assert bool(logged) is not same
    with devtrace.stage_ranges():
        Engine().search(pool.batch(1))
