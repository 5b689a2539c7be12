"""Serving launcher: ``python -m repro_torch.launch.serve [...]`` (PyTorch
port of ``repro/launch/serve.py``, the same flags and printed lines).

Builds an ASC cluster-skipping index over a synthetic corpus (k-means
over random-projection dense counterparts, then capacity-bounded
assignment) or cold starts from a saved one via --load-dir, and serves
query batches through the RetrievalEngine on the card, printing a
registry-backed summary of latency percentiles and the pruning funnel.

Device options:
  --device D      cuda (default) or cpu. With cuda and no card the
                  launcher exits with an error; it never falls back to
                  the CPU. cpu runs the kernels' plain PyTorch versions.
                  Cluster bounds take the segment-bound GEMM route, the
                  one that runs its kernel on the card.

Lifecycle options:
  --churn N       between batches, delete+insert N docs through the
                  IndexWriter and publish a new epoch; the engine serves
                  from the SnapshotPublisher, pinning one epoch per batch.
  --budget-ms T   adaptive latency target: the engine's AdaptiveBudget
                  feedback loop retargets the cluster budget per batch.
  --save-dir D    persist the final index (versioned npz shards).
  --load-dir D    cold-start from a persisted index instead of building.

Durability options (docs/lifecycle.md §durability; --churn only):
  --durable-dir D    crash-safe write plane: WAL + checksummed
                     checkpoints under D. When D already holds a
                     checkpoint the process *recovers* from it (replaying
                     the WAL tail) instead of building an index — so
                     SIGKILL + restart resumes serving where the log
                     ends. Writer faults degrade serving to the
                     last-good epoch while recovery retries with
                     backoff; SIGTERM/Ctrl-C flushes the WAL and writes
                     a final checkpoint before exiting.
  --fsync P          WAL fsync policy: always | interval | off.
  --checkpoint-every N   checkpoint every N commits (0 = only at exit).

Streaming options (docs/serving.md):
  --frontend M       off | closed | open. With closed/open the launcher
                     feeds queries one at a time (optionally paced by
                     --arrival-qps) through the StreamingFrontend's
                     bounded queue with per-request deadlines
                     (--deadline-ms), shedding over-capacity submits
                     (--max-queue). ``closed`` additionally runs the
                     (mu, eta)/budget degradation ladder against
                     --slo-p99-ms; SIGTERM stops intake, drains under
                     --drain-deadline-ms, then checkpoints.

Observability options (docs/observability.md):
  --metrics-port P   serve Prometheus text on http://0.0.0.0:P/metrics
                     (and a JSON snapshot on /metrics.json) while the
                     loop runs.
  --metrics-json F   at exit, write the registry snapshot to F (JSON)
                     and the Prometheus exposition next to it (.prom).
  --trace-dir D      write per-request Chrome-trace JSON (Perfetto-
                     loadable) under D; --trace-every N samples every
                     Nth request.
  --profile-first-n N  additionally wrap the first N requests in a
                     torch.profiler capture under D/torch_profile.
  --split-every N    every Nth request, split planner vs executor wall
                     time into the registry (0 = only traced requests).

``--devices N`` (the sharded path) is not ported yet: the launcher exits
with an error (ROADMAP A.13).
"""

from __future__ import annotations

import argparse
import json
import os


def _parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-docs", type=int, default=6000)
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--clusters", type=int, default=64)
    ap.add_argument("--segments", type=int, default=8)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--mu", type=float, default=0.9)
    ap.add_argument("--eta", type=float, default=1.0)
    ap.add_argument("--engine", type=str, default="auto",
                    choices=["auto", "per_query", "batched", "pipelined"],
                    help="search engine; pipelined = device wave "
                         "planning with plan/execute dispatch loop")
    ap.add_argument("--device", type=str, default="cuda",
                    choices=("cuda", "cpu"),
                    help="where the index lives and every search runs")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--budget-ms", type=float, default=0.0,
                    help="latency target (0 = unbudgeted)")
    ap.add_argument("--churn", type=int, default=0,
                    help="docs deleted+inserted between batches")
    ap.add_argument("--save-dir", type=str, default="")
    ap.add_argument("--load-dir", type=str, default="")
    ap.add_argument("--durable-dir", type=str, default="",
                    help="crash-safe write plane (WAL + checkpoints) "
                         "under this directory; recovers from it when "
                         "it already holds a checkpoint")
    ap.add_argument("--fsync", type=str, default="interval",
                    choices=("always", "interval", "off"),
                    help="WAL fsync policy (--durable-dir)")
    ap.add_argument("--checkpoint-every", type=int, default=8,
                    help="checkpoint every N commits (0 = only at exit)")
    ap.add_argument("--devices", type=int, default=0,
                    help="sharded serving over N devices (not ported yet)")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve /metrics on this port (0 = off)")
    ap.add_argument("--metrics-json", type=str, default="",
                    help="write registry snapshot JSON (+ .prom text) "
                         "here at exit")
    ap.add_argument("--trace-dir", type=str, default="",
                    help="write per-request Chrome-trace JSON here")
    ap.add_argument("--trace-every", type=int, default=1,
                    help="trace every Nth request")
    ap.add_argument("--profile-first-n", type=int, default=0,
                    help="torch.profiler capture for the first N requests")
    ap.add_argument("--split-every", type=int, default=0,
                    help="planner/executor split every Nth request "
                         "(0 = only on traced requests)")
    ap.add_argument("--frontend", type=str, default="off",
                    choices=("off", "closed", "open"),
                    help="streaming front-end mode: off = offline "
                         "batches (default); closed = deadline-aware "
                         "queue with the closed-loop (mu, eta) "
                         "degradation ladder; open = same queue with "
                         "the ladder disabled (baseline)")
    ap.add_argument("--arrival-qps", type=float, default=0.0,
                    help="frontend mode: pace submits at this rate "
                         "(0 = as fast as possible)")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="frontend mode: bounded queue depth; beyond "
                         "it submits are shed with a typed Rejected")
    ap.add_argument("--deadline-ms", type=float, default=200.0,
                    help="frontend mode: per-request deadline")
    ap.add_argument("--slo-p99-ms", type=float, default=50.0,
                    help="frontend mode: p99 SLO the degradation "
                         "controller defends")
    ap.add_argument("--drain-deadline-ms", type=float, default=1000.0,
                    help="frontend mode: graceful-shutdown drain "
                         "budget; queued requests past it are shed")
    return ap.parse_args(argv)


def _summary(registry, stats, index_m: int) -> str:
    """The end-of-run report, rendered from the registry snapshot —
    the same numbers /metrics exposes, not a parallel accounting."""
    snap = registry.snapshot()

    def scalar(name, default=0.0):
        v = snap.get(name, default)
        return v if not isinstance(v, dict) else default

    lines = [f"[serve] {stats.n_queries} queries in "
             f"{stats.n_requests} batches: mean {stats.mean_ms:.2f} ms/q, "
             f"batch p50 {stats.p(50):.2f} ms, p99 {stats.p(99):.2f} ms"]
    walked = scalar("funnel_tiles_walked_total")
    if walked:
        lines.append(
            "[serve] funnel: "
            f"{scalar('funnel_clusters_budgeted_total'):.0f} budgeted -> "
            f"{scalar('funnel_clusters_scored_total'):.0f} clusters -> "
            f"{walked:.0f} tiles walked -> "
            f"{scalar('funnel_tiles_scored_total'):.0f} scored -> "
            f"{scalar('funnel_doc_slots_walked_total'):.0f} doc slots -> "
            f"{scalar('funnel_docs_scored_total'):.0f} docs scored "
            f"(tile {scalar('funnel_tile_compaction_ratio'):.2f}, "
            f"doc {scalar('funnel_doc_compaction_ratio'):.2f})")
    if scalar("split_requests_total"):
        lines.append(
            f"[serve] planner share {scalar('planner_share'):.2f} "
            f"over {scalar('split_requests_total'):.0f} sampled "
            f"split(s)")
    if scalar("lifecycle_epoch_swaps_total"):
        lines.append(
            f"[serve] lifecycle: epoch {scalar('lifecycle_epoch'):.0f}, "
            f"{scalar('lifecycle_epoch_swaps_total'):.0f} swap(s), "
            f"{scalar('index_compactions_total'):.0f} compaction(s), "
            f"slack {scalar('index_slack'):.3f}, unsorted tail "
            f"{scalar('index_unsorted_tail_fraction'):.3f}")
    if scalar("adaptive_budget_clusters"):
        lines.append(
            f"[serve] adaptive budget -> "
            f"{min(scalar('adaptive_budget_clusters'), index_m):.0f}"
            f"/{index_m} clusters "
            f"(cost {scalar('adaptive_cost_ms'):.4f} ms/cluster)")
    return "\n".join(lines)


def _dump_metrics(registry, path: str) -> None:
    """Snapshot JSON at ``path`` + Prometheus text next to it, so a
    caller can validate both expositions without racing an HTTP
    server."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(registry.snapshot(), f, indent=1)
    prom = os.path.splitext(path)[0] + ".prom"
    with open(prom, "w") as f:
        f.write(registry.render_prometheus())
    print(f"[serve] metrics -> {path} + {prom}")


def _apply_churn(writer, rng, spec, n: int, registry) -> None:
    """One churn round: N deletes + up-to-N inserts + commit. An
    ``IndexFullError`` does not kill the round (or the process): force a
    compaction, back off, retry the insert; persistently-full indexes
    skip the rest of the round's inserts instead of failing serving."""
    import time as _time

    import numpy as np

    from repro_torch.lifecycle import IndexFullError

    live = writer.mutable.live_ids()
    for d in rng.choice(live, min(n, live.size), replace=False):
        writer.delete(int(d))
    # cap inserts at remaining capacity so a churn rate above the
    # delete rate degrades to steady state instead of overflowing
    free = int(writer.mutable.free_slots.sum())
    for _ in range(min(n, free)):
        nnz = int(rng.integers(4, 24))
        t = rng.choice(spec.vocab, nnz, replace=False)
        w = rng.lognormal(0.0, 0.6, nnz).astype(np.float32)
        backoff = 0.02
        for attempt in range(3):
            try:
                writer.insert(t, w)
                break
            except IndexFullError:
                registry.counter(
                    "serve_index_full_total",
                    "inserts rejected by a full index (forced "
                    "compaction + backoff + retry)").inc()
                writer.mutable.compact()
                _time.sleep(backoff)
                backoff *= 2
        else:
            print("[serve] index full even after compaction; "
                  "skipping remaining inserts this round")
            break
    writer.commit()


def _recover_writer(eng, args, registry, backoff_cap_s: float = 2.0):
    """Bounded-retry recovery of the durable write plane. Readers keep
    serving the engine's last-good pinned epoch the whole time; the
    publisher only swaps forward when recovery republishes. Retries
    back off exponentially to ``backoff_cap_s`` with up to 25% jitter
    (a fleet restarting against one shared volume must not retry in
    lockstep); every attempt increments
    ``writer_recovery_attempts_total``."""
    import time as _time

    import numpy as np

    from repro_torch.lifecycle import DurableIndexWriter

    attempts = registry.counter(
        "writer_recovery_attempts_total",
        "write-plane recovery attempts (success and failure)")
    rng = np.random.default_rng(17)
    backoff = 0.1
    last: Exception | None = None
    for attempt in range(5):
        attempts.inc()
        try:
            eng.health.to("recovering", f"recovery attempt {attempt + 1}")
            writer = DurableIndexWriter.recover(
                args.durable_dir, fsync=args.fsync,
                checkpoint_every=args.checkpoint_every,
                publisher=eng._source, registry=registry,
                device=eng.device)
            eng.health.to("healthy", "recovered")
            print(f"[serve] write plane recovered: {writer.recovery_stats}")
            return writer
        except Exception as e:          # noqa: BLE001 — retry any failure
            last = e
            eng.health.to("degraded", f"recovery failed: {e!r}")
            sleep_s = min(backoff, backoff_cap_s) * (
                1.0 + 0.25 * float(rng.random()))
            print(f"[serve] recovery attempt {attempt + 1} failed: {e!r}; "
                  f"retrying in {sleep_s:.2f}s")
            _time.sleep(sleep_s)
            backoff = min(backoff * 2, backoff_cap_s)
    raise RuntimeError(
        f"write-plane recovery failed after retries: {last!r}")


def main(argv=None) -> None:
    args = _parse(argv)
    if args.devices:
        raise SystemExit(
            "[serve] --devices: sharded serving over several devices is "
            "not ported yet (ROADMAP A.13); run without --devices to serve "
            "on one device")

    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("[serve] no CUDA device is available; pass "
                         "--device cpu to serve on the plain PyTorch path")
    dev = torch.device(args.device)

    from repro_torch.core.clustering import (balanced_assign,
                                             dense_rep_projection,
                                             lloyd_kmeans)
    from repro_torch.core.index import build_index
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.synthetic import (CorpusSpec, make_corpus,
                                            make_queries)
    from repro_torch.lifecycle import IndexWriter, load_index, save_index
    from repro_torch.obs import MetricsRegistry, Observability
    from repro_torch.serving.engine import (AdaptiveBudget, RetrievalEngine,
                                            ServeStats)

    want_obs = bool(args.metrics_port or args.metrics_json
                    or args.trace_dir or args.profile_first_n
                    or args.split_every)
    obs = Observability(
        trace_dir=args.trace_dir or None,
        trace_sample_every=max(args.trace_every, 1),
        profile_first_n=args.profile_first_n,
        split_every=args.split_every) if want_obs else None
    registry = obs.registry if obs is not None else MetricsRegistry()

    server = None
    if args.metrics_port:
        from repro_torch.obs.exposition import MetricsServer
        server = MetricsServer(registry, port=args.metrics_port)
        print(f"[serve] /metrics on port {server.port}")

    spec = CorpusSpec(n_docs=args.n_docs, vocab=args.vocab,
                      n_topics=max(8, args.clusters // 2))
    docs, doc_topic = make_corpus(spec)
    if args.load_dir:
        index, manifest = load_index(args.load_dir, device=dev)
        print(f"[serve] cold start from {args.load_dir} "
              f"(epoch {manifest['epoch']}, v{manifest['format_version']})")
        if index.vocab != spec.vocab:
            raise SystemExit(
                f"[serve] queries are generated over --vocab {spec.vocab} "
                f"but the loaded index covers vocab {index.vocab}; pass a "
                f"matching --vocab with --load-dir")
    else:
        rep = dense_rep_projection(docs, dim=96, device=dev)
        centers, _ = lloyd_kmeans(torch.Generator().manual_seed(0), rep,
                                  k=args.clusters, iters=8)
        d_pad = int(2.0 * args.n_docs / args.clusters)
        assign = balanced_assign(rep, centers, capacity=d_pad)
        index = build_index(docs, assign.cpu().numpy(), m=args.clusters,
                            n_seg=args.segments, d_pad=d_pad, device=dev)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"[serve] index: {index.m}x{index.n_seg}, "
          f"{index.nbytes() / 2**20:.1f} MiB, "
          f"{n_dev} device(s)")

    cfg = SearchConfig(k=args.k, mu=args.mu, eta=args.eta,
                       engine=args.engine, bounds_impl="gemm")

    writer = None
    if args.churn > 0:
        # synthetic churn docs have no dense representation, so placement
        # is least-loaded; pass centroids + dense_rep for real corpora
        if args.durable_dir:
            from repro_torch.lifecycle import DurableIndexWriter
            from repro_torch.lifecycle.wal import SNAPSHOT_SUBDIR
            if os.path.exists(os.path.join(args.durable_dir,
                                           SNAPSHOT_SUBDIR)):
                writer = DurableIndexWriter.recover(
                    args.durable_dir, fsync=args.fsync,
                    checkpoint_every=args.checkpoint_every,
                    registry=registry, device=dev)
                print(f"[serve] recovered write plane from "
                      f"{args.durable_dir}: {writer.recovery_stats}")
            else:
                writer = DurableIndexWriter(
                    index, args.durable_dir, fsync=args.fsync,
                    checkpoint_every=args.checkpoint_every, seed=9,
                    registry=registry, device=dev)
                print(f"[serve] durable write plane -> {args.durable_dir} "
                      f"(fsync={args.fsync})")
        else:
            writer = IndexWriter(index, seed=9, registry=registry,
                                 device=dev)
        source = writer.publisher
    else:
        source = index
    ab = (AdaptiveBudget(args.budget_ms, init_cost_ms=0.05)
          if args.budget_ms > 0 else None)
    eng = RetrievalEngine(source, cfg, adaptive=ab, obs=obs, device=dev)
    if obs is None:
        # no obs flags: the engine still accounts into `registry` so the
        # final summary renders from one source of truth
        eng.stats = ServeStats(registry=registry)
    warm, _ = make_queries(spec, args.batch_size, doc_topic, seed=997)
    eng.warmup(warm)

    # SIGTERM gets the same graceful path as Ctrl-C: flush the WAL,
    # final checkpoint, metrics dump — a signal is not a crash
    import signal

    def _on_sigterm(signum, frame):
        raise KeyboardInterrupt

    try:
        previous = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        previous = None                  # not the main thread (tests)

    frontend = None
    if args.frontend != "off":
        from repro_torch.serving.frontend import (FrontendConfig,
                                                  StreamingFrontend)
        frontend = StreamingFrontend(eng, FrontendConfig(
            max_batch=args.batch_size, max_queue=args.max_queue,
            default_deadline_ms=args.deadline_ms,
            slo_p99_ms=args.slo_p99_ms,
            drain_deadline_ms=args.drain_deadline_ms,
            closed_loop=(args.frontend == "closed")))
        from repro_torch.serving.frontend import query_rows as _rows
        frontend.warmup(next(_rows(warm)))
        frontend.start()
        print(f"[serve] streaming frontend ({args.frontend} loop): "
              f"queue<={args.max_queue}, deadline {args.deadline_ms:.0f} "
              f"ms, SLO p99 {args.slo_p99_ms:.0f} ms")

    rng = np.random.default_rng(123)
    out = None
    try:
        import time as _time

        from repro_torch.serving.frontend import query_rows
        interval_s = (1.0 / args.arrival_qps
                      if args.arrival_qps > 0 else 0.0)
        futures = []
        for step in range(args.batches):
            if writer is not None:
                try:
                    _apply_churn(writer, rng, spec, args.churn, registry)
                except KeyboardInterrupt:
                    raise
                except Exception as e:   # noqa: BLE001
                    # a mid-mutation writer fault leaves the in-memory
                    # index untrustworthy; readers stay on the last-good
                    # epoch while the durable state is recovered
                    if not args.durable_dir:
                        raise
                    print(f"[serve] write plane fault: {e!r} — serving "
                          f"degraded from last-good epoch")
                    if eng.health.healthy:
                        eng.health.to("degraded", repr(e))
                    writer = _recover_writer(eng, args, registry)
            q, _ = make_queries(spec, args.batch_size, doc_topic,
                                seed=step)
            if frontend is None:
                out = eng.search(q)
            else:
                for row in query_rows(q):
                    futures.append(frontend.submit(row))
                    if interval_s:
                        _time.sleep(interval_s)
        for f in futures:
            f.result()                   # typed outcome, never hangs
    except KeyboardInterrupt:
        print("[serve] interrupted — shutting down gracefully")
    finally:
        # graceful-drain ordering: stop intake and drain the queue
        # under its bounded deadline FIRST, so in-flight requests see a
        # consistent epoch; only then flush the WAL + final checkpoint
        if frontend is not None:
            drained = frontend.shutdown()
            cons = frontend.conservation()
            print(f"[serve] frontend drained: {drained['drained']} "
                  f"served, {drained['shed']} shed at deadline; "
                  f"totals {cons} (ladder max level "
                  f"{frontend.controller.level_max})")
        if writer is not None and hasattr(writer, "close"):
            writer.close()               # WAL flush + final checkpoint
            print(f"[serve] final checkpoint -> {args.durable_dir}")

        print(_summary(registry, eng.stats, index.m))
        if out is not None and obs is None:
            # without obs the funnel counters are empty; keep the quick
            # work-counter readout from the last batch
            print(f"[serve] last batch scored "
                  f"{float(out.n_scored_clusters.float().mean()):.1f}"
                  f"/{index.m} clusters")

        if args.metrics_json:
            _dump_metrics(registry, args.metrics_json)
        if server is not None:
            server.close()

        if args.save_dir:
            final = eng.index
            epoch = eng.last_epoch or 0
            save_index(args.save_dir, final, epoch=epoch,
                       n_shards=min(4, final.m))
            print(f"[serve] saved epoch {epoch} -> {args.save_dir}")
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)


if __name__ == "__main__":
    main()
