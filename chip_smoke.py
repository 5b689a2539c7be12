#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py                     # every phase, one card
    python3 chip_smoke.py --phases nccl       # build, world, nccl: 4 cards
    python3 chip_smoke.py --phases nccl_full  # the launcher at m = 4,096
    python3 chip_smoke.py --phases merge      # build, the merge's row: 1 card

Phases, each printing one JSON line (all must pass, or the script exits
nonzero and prints no result):

  1. build   — compile the six CUDA sources of ``kernels/csrc`` and
               print the build seconds and the card's name and power limit;
  2. golden  — rebuild the golden world of tests/test_golden_regression.py
               with the port's own numpy builders and run its seven
               configs (two of them the superblock walk) and brute force
               on the card against tests/golden/golden_topk.json; then
               push it through the fixture's churn stream with the port's
               MutableIndex, publish the snapshot to the card and hold the
               three churned configs and brute force against the file's
               ``churned`` entries;
  3. serve   — the main path at the MS MARCO widths of
               ``configs/asc_splade.py`` (V = 30522, t_pad = 128,
               q_pad = 32, n_seg = 8, d_pad = 2560, group_size = 32, k = 10,
               (mu, eta) = (0.9, 1.0), bounds_impl = "gemm"), depth cut to
               m = 512 clusters (about 1.1M documents): RetrievalEngine
               serves 8 batches of 64, 3 batches of 2 (the per-query route)
               and one batch of 64 with mixed per-row (mu, eta). Launch
               counts are zeroed just before and read just after; every
               kernel of ``kernels.MAIN_PATH`` must have launched. Then the
               kernel path is held against the plain path on the card (16
               queries) and safe mode against brute force (8 queries);
  4. superblock — the two-level walk (superblocks=True) in the same
               world (S = 23 superblocks of cap = 23 clusters), four
               64-query batches served with the counts zeroed before and
               read after (K1 once a batch at level 0 and once a walked
               superblock, the planner and K2 once a walked wave); every
               TopK field against the on-card plain path, safe mode against
               brute force (16 queries); the level-0 funnel, waves, syncs
               and batch ms;
  5. pipelined — engine="pipelined" (fuse_waves="auto") over the same
               four batches, counts zeroed before and read after; every
               TopK field bit for bit equal to engine="batched" and the
               wave summaries equal to the batched engine's recorded plans;
               batch ms of both engines in turns, their launch counts and
               host stalls, and planner_executor_split for both routes;
  6. lifecycle — a live, churning index at the same widths: a
               DurableIndexWriter (WAL, fsync "interval", a checkpoint
               every 4 commits) takes 6 rounds of 4,096 uniform deletes and
               4,096 inserts drawn from the scale world's distribution,
               with one rebalancing, requantizing compaction after round
               4, and publishes one epoch a round to the card; a
               RetrievalEngine with observability over its publisher
               serves each epoch a 64-query batch (K1, the planner, K2)
               and a 2-query batch (K1, K4), each held against the on-card
               plain path on all 11 fields (ids by the tie rule; the rows
               two fp32 sum orders rank differently are printed), every
               kernel call of both batches against its plain version on
               the epoch's churned inputs, and safe mode against brute
               force over the epoch's live docs (16 queries). In round 5 a
               WAL append fault degrades health; the engine serves the last
               good epoch bit for bit; DurableIndexWriter.recover
               republishes and the stream finishes. The recovered writer
               must equal a shadow MutableIndex that ran every op without
               a WAL (every array, op_seq, scale, rng state), and the last
               epoch on the card its host mirrors. Launches are counted
               around the engine's searches only; the line gives publish
               ms and GB/s, checkpoint, compaction and recovery seconds,
               health transitions, card memory with two epochs alive,
               each epoch's batch ms beside the serve phase's fresh-index
               ms for the same batch, its funnel, and the ``index_*``,
               ``wal_*`` and ``lifecycle_*`` metrics;
  7. kernels — each kernel against its plain version on the card at the
               inputs the main path gave it (captured in a warm-up run
               that is not counted) and at ragged shapes, with times: K1
               at both batch sizes the main path gives it (64 and 2), K2
               at the first wave of a 64-query batch, after a line of its
               query blocks' union sizes and doc-term hit fractions; the
               wave planner (K3) bit-exact on every wave of a 64-query
               batch and on ``tools/plan_cases.py``, timed three ways (the
               planner kernel, the op-by-op planner on ``compact_front``,
               the plain planner), with ``compact_front`` still checked on
               its own; K4 by cluster id against its plain version and
               timed against the gather + flat ``score_docs`` + mask
               sequence it replaced; the wave's merge bit for bit on
               ``tools/merge_cases.py`` and at k = 1,000 and 20,000, and
               timed at the benchmark's wave (256 queries x 32 x 2,560,
               k = 10 and 1,000) and at the serve phase's first 64-query
               wave, beside its plain sort path and ``torch.topk``
               (``--phases merge``: this row alone, its 64-query wave a
               synthetic first wave). K1 is also checked
               and timed at the level-0 shape (207 rows), K2 and the
               planner at the superblock wave (G = 23; every superblock
               wave of a batch for the planner). It runs after the dist
               phase and before the encoder, before any model phase (its
               profiler pass is the first since the retrieval phases; the
               moe phase profiles decode steps), and its line is printed
               at the end.

  8. frontend — the streaming front-end (``serving/frontend.py``) over
               the serve phase's engine, closed loop, max_batch 64, every
               bucket warmed, its SLO and deadline 2.5x and 4x the warm
               64-query batch ms it measures: single-query requests at
               0.7x, 2x and 0.5x the capacity that implies (64 / batch
               ms), then four lone ones, submitted from the main thread to
               ``start()``'s pump thread; then, with the pump idle, eight
               rows half stamped at the ladder's level (at least 1) and
               half at level 0, which one dispatch serves at mixed levels.
               Gates: conservation, no dispatch failure, the pump thread
               joined and every future done when ``shutdown`` returns,
               every served row equal to its recorded dispatch, and at
               least 8 dispatches (buckets below 4, a mixed-level one and
               degraded ones among them) replayed after the thread is
               joined equal to the on-card plain path. Reports served
               q/s, end-to-end and queue percentiles, batch sizes,
               shedding, the ladder and launches;
  9. cluster — ``dense_rep_projection`` (dim 96), ``lloyd_kmeans`` (k =
               512, 8 iterations) and ``balanced_assign`` (capacity d_pad)
               on the card over the scale world's 1.1M docs, timed, with
               peak memory: every doc placed once (also in the index built
               from the assignment), no cluster over capacity, the inertia
               not raised, a second build from the same seed bit for bit
               the same; on a 65,536-doc subsample the card's assignment
               equals the CPU port's on every row whose two nearest
               distances differ by more than the two devices' rounding
               (ties counted), and the rounds on the same distances at a
               tight capacity equal exactly. Reports the clusters a
               64-query batch scores on the k-means index beside the
               topic-chunked one;
 10. cli     — ``python -m repro_torch.launch.serve`` on the saved scale
               world (``--load-dir``, ``--frontend closed``, ``--churn
               4096``, ``--durable-dir``, a checkpoint every 4 commits,
               the front-end's measured capacity and SLO), SIGTERM after
               the first periodic checkpoint: exit 0, the drain line before
               the final-checkpoint line, the metrics dump's front-end
               counters balanced with requests served and no dispatch
               failed; a restart on the same directory recovers at that
               checkpoint's op_seq and serves two batches, held to the
               same front-end gates.
 11. dist    — sharded retrieval (``distributed_retrieve``) by 4 ranks on
               the one card over gloo, a (2, 2) ("data", "model") mesh:
               two cluster shards of 256 clusters, two query halves. The
               serve phase's first four 64-query batches, one 64-query
               batch in safe mode and one 2-query batch (a local batch of
               1, the per-query route), each counted from zero on every
               rank: every rank's result equals rank 0's and the same
               merge done in one process over per-shard searches on the
               kernel path, bit for bit; against that merge on the on-card
               plain path, ids by the tie rule and scores to rtol 1e-5,
               counters exactly except where a shard's own kernel-path
               and plain-path searches already differ (fp32 near ties at
               an admission threshold; listed); the safe batch's scores
               equal single-device ``retrieve``; every
               rank launched K1, the planner and K2, and K4 on the 2-query
               batch. Then ``python -m repro_torch.launch.serve --devices
               4`` on the world the cli phase saved: exit 0, data 2 /
               model 2 and its summary. Reports rank 0's batch ms beside
               the serve phase's, the backend, each rank's peak memory;
 12. encoder — ``SparseEncConfig()`` at its published widths (V 30522,
               d 256, 4 layers, 4 heads, d_ff 1024; 10,994,490
               parameters) with random weights from a seeded generator:
               64 queries of 64 tokens (half cut short) encoded on the
               card equal the CPU's (rtol 1e-4, atol 1e-5), and so do
               ``to_sparse_docs(t_pad=32)``'s weights (ids only swapped
               within near ties); the encoded queries, served by the serve
               phase's engine, equal the on-card plain path. Encode ms at
               batch 64 and 128, docs/s over 64 batches of 128 × 64
               tokens, peak memory.

 13. train_encoder — ``python -m repro_torch.examples.train_sparse_encoder``
               at its default flags, stage by stage (``SparseEncConfig()``,
               300 steps at batch 24 x 64 tokens, AdamW with cosine 3e-4,
               warmup 20): 2 steps at batch 8 on the card against the CPU
               (fp32, TF32 off; loss, grad norm, first moment and
               parameters, tolerances in ``card_vs_cpu``); under
               deterministic algorithms the 300-step fit, timed (its loss
               must fall), and fit(150) then fit(300) on one directory,
               equal to it bit for bit; a checkpoint's host copy and
               save; then 2,048 docs encoded, k-means (k = 32) and
               ``balanced_assign`` (d_pad 128), ``build_index``, and 16
               encoded queries through ``asc_retrieve`` (gemm bounds),
               counted from zero (K1, the planner and K2 must launch),
               held against the on-card plain path (``check_audited``)
               and in safe mode against brute force; recall@10 and %C;
 14. train_lm — OLMo-1B (``configs/olmo_1b.py``): one AdamW step at
               depth 2 with the full widths in fp32 on the card against
               the CPU, then 10 more on the same batch (the loss must
               fall by a nat); then ``python -m repro_torch.launch.train
               --arch olmo-1b --preset full --steps 10 --batch 8 --seq
               512`` as a subprocess (16 layers, bf16 compute on fp32
               masters, remat): exit 0, ten finite losses within 0.1 of
               ln V (its synthetic stream leaves ten steps at chance);
               step ms, tokens/s, MFU (6 N tokens over the step time over
               the 989 TFLOP/s bf16 peak) and peak memory.
 15. recsys_asc — ``repro_torch.examples.bert4rec_asc_retrieval`` at
               BERT4Rec's published config (10^6 items, embed_dim 64,
               seeded random weights): the catalog index built on the card
               (m = 512, d_pad = 5,120, 4 segments; V = 128, t_pad = q_pad =
               64), then, counts zeroed, the example's ``serve`` on four
               64-user and three 2-user batches of ``bert4rec_batch`` (seq
               200) at mu 1.0 and 0.9: K1, the planner, K2 and K4 must
               launch; every result equals the on-card plain path
               (``check_audited``) and rank-safe ASC brute force. A warm-up
               batch of each size is held kernel by kernel against the
               plain versions and each kernel timed at these shapes. Build
               ms by step, index MB, batch ms, clusters and items scored a
               query, recall@10 against index-exact and the dense dot
               product (reported, not gated);
 16. recsys  — DLRM, DIN, DeepFM and BERT4Rec: at the smoke config the
               forward and a 256-candidate retrieval on the card equal the
               CPU's on the same weights; at the published configs (DLRM's
               53.2 GB table drawn on the card from a CUDA generator) a
               forward at batch 2,048 and a 65,536-candidate retrieval,
               finite, timed: ms, lookups a second, peak memory;
 17. train_recsys — each recsys arch: two AdamW steps at the smoke config
               on the card against the CPU, then ``python -m
               repro_torch.launch.train`` as a subprocess for 10 steps
               (``--preset full``; DLRM at ``smoke``, since its full table
               and a dense gradient of the same size pass 80 GB before
               AdamW's moments) under deterministic algorithms: ten finite
               losses; step 9's checkpoint set aside and the launcher run
               again resumes from step 4, prints the same steps 5-9 and
               writes a step-9 checkpoint equal bit for bit;
 18. train_gnn — MeshGraphNet: the same at its full preset (15 layers, d
               128), then one forward at full width on a
               ``NeighborSampler`` subgraph (fanout 15, 10; 1,024 seeds over
               a 10^6-node CSR), timed.
 19. moe     — the mixture-of-experts LMs served: olmoe-1b-7b at depth 2
               with its full widths (fp32, 2 x 128 tokens) on the card
               against the CPU on the same weights (logits, aux loss and
               every layer's routing; a token whose experts differ must be
               a near tie, and its sequence is left out after it), and at
               no-drop capacity (E / K) a decode step equal to a full
               forward over S + 1; then olmoe at full depth (16 layers,
               6.92B parameters) and llama4-scout cut to 4 of its 48
               layers (10.88B), each drawn on the card from a CUDA
               generator, from fp32 masters and from bf16 parameters:
               prefill of 8 x 512 tokens and 32 greedy decode steps, timed,
               with the bytes bound of a decode step, its device time and
               the picks kept at capacity factor 1.25; the two parameter
               dtypes' prefill logits equal bit for bit under deterministic
               algorithms;
 20. train_moe — olmoe at full widths, depth 2: one AdamW step (fp32) on
               the card against the CPU with the routing audited, 10 more
               on the same batch (the loss must fall by a nat), 6 timed
               steps at 8 x 512 in bf16 compute on fp32 masters (step ms,
               tokens/s, MFU on the active parameters, peak memory); then
               the launcher for olmoe-1b-7b and llama4-scout-17b-a16e at
               ``--preset smoke`` through ``launch_and_resume`` (the full
               presets need 110 GB and more);
 21. train_sharded — sharded training, its two gloo ranks on the one
               card: ``python -m repro_torch.launch.train --arch olmo-1b
               --preset full --layers 2 --devices 2 --steps 10 --batch 8
               --seq 512 --ckpt-dir D`` (OLMo-1B's widths, its depth cut
               from 16 to 2 layers for time; mesh (2, 1), FSDP over
               "data"), killed with its ranks once its step-4 checkpoint
               is on disk (a preemption at step 5): its mesh line, finite
               losses for steps 0-4 within ``TS_LOSS_RTOL`` of the same
               ten steps run here on one device uninterrupted; the
               checkpoint (whole tensors) resumed on one device for steps
               5-9 within the same; step ms, tokens/s, MFU, the card's
               peak memory (``nvidia-smi``, polled) and each rank's (half
               of what the card gained while the two symmetric ranks ran),
               beside train_lm's. Then DLRM's 53.25 GB table row-sharded
               over the two ranks (26.6 GB each): a 2,048-example lookup,
               timed, and ids across the shard boundary against the rows
               gathered whole (exact);
 22. model_axis — the LM's 'model' axis as ``lm_rules`` lays it, on two
               gloo ranks sharing the card, a ("data" 1, "model" 2) mesh:
               OLMo-1B at its widths, cut to 4 layers for time, two AdamW
               steps sequence-parallel on 2 x 1,024 tokens (each rank its
               512 positions, K/V gathered for context-parallel
               attention), a 2 x 1,024 prefill (each rank's K/V chunk its
               cache block) and four greedy decode steps into the cache
               regrown to 1,032 slots over 'model' (the MLP and the vocab
               tensor-parallel, flash-decode over the blocks, the cache
               written in place), in bf16 and fp32 compute, each held to
               the same run on one device in this process: losses and
               prefill logits within 1e-4 relative, fp32 decode logits
               too, bf16 decode logits within 4 bf16 ulps in norm, greedy
               tokens equal, the decode cache's storage unchanged; the
               first step's gradients in fp32, gathered whole, each within
               1e-4 of its largest entry of one device's. Then
               olmoe at its widths, depth 2, through the expert-parallel
               all-to-all on each rank's chunk of the sequence (fp32, 2 x
               128 tokens): at no-drop capacity the loss (rtol 1e-5) and
               every gradient (1e-4 of its largest entry) against one
               device, and at capacity 1.25 the kept share of picks;
               olmoe served at depth 2 (prefill of 2 x 128 through the
               all-to-all, four greedy decode steps with each rank running
               its 32 of 64 experts and the partial outputs summed over
               'model'), fp32 logits within 1e-4, bf16 within 4 ulps in
               norm, tokens equal, against one device (in bf16 a row whose
               routing flips at a near tie, 1e-2 in probability, left
               out, and decode held against one device's decode from the
               rank's own prefill state), with each rank's expert bytes; MeshGraphNet at its published widths (15
               layers, d 128) on ``full_graph_sm``'s Cora geometry (2,708
               nodes, 10,556 edges, d_feat 1,433), each rank its half of
               the nodes and edges: step 0 and two AdamW steps in fp32
               and in float64, step 0's fp32 loss and the float64 losses
               within 1e-5 of one device's, step 0's float64 gradients
               within 1e-4 of each leaf's largest entry of one device's
               (the fp32 gradients and later losses reported: at these
               widths one device's own fp32 rounding reaches 1e-3 of a
               leaf's largest entry);
 23. examples — ``repro_torch.examples.quickstart`` and ``serve_retrieval``
               on the card, stage by stage (the planner and K2 must
               launch; rank-safe recall@10 1.000; every result against
               the on-card plain path with ``check_audited``, each served
               batch first replayed bit for bit), then each run as
               ``python -m`` with no flag: exit 0 and the reference's
               lines.
 24. dryrun  — the production dry-run (``repro_torch.launch.dryrun``):
               torch's fake process group on this torch (a collective of
               a card tensor); ``python -m repro_torch.launch.dryrun`` on
               the meta device for one cell an arch and each cell below
               (``DR_CELLS``, rank 0 of a 256- or 512-rank fake group;
               every record ok); the memory model on the card for OLMo-1B
               ``train_4k`` on the (2, 16, 16) mesh (the sequence over
               'model'), DLRM ``train_batch`` on (16, 16) and
               MeshGraphNet ``ogb_products`` on (16, 16) (rank 0's block
               of the graph's nodes and edges; each arch's first training
               cell predicted under 70 GB), and OLMo-1B and olmoe
               ``decode_32k`` on (16, 16) at their production blocks (8
               rows, 2,048 of the cache's 32,768 slots; olmoe's 4 of 64
               experts a layer): built and sharded on meta,
               only rank 0's blocks drawn on the card, one step under the
               same fake group, the predicted peak (arguments + temp)
               within 10% or 512 MiB of ``max_memory_allocated``, FLOPs
               and collectives equal to the meta record's, then the step
               timed (rank 0's compute: the fake collectives move
               nothing); ``asc-splade`` ``serve_k10`` on both meshes on a
               real shard (the scale world's first 256 or 128 clusters,
               16 random queries), counts zeroed before and read after:
               K1, the planner and K2 launch, every kernel call held
               against its plain version, arguments and collectives equal
               to the shard-less record's; and ``python -m
               repro_torch.examples.multipod_launch``, whose numbers must
               equal its record's.

 25. nccl    — the meshes across four cards, one rank a card over nccl
               (rank r on cuda:r, bound before it joins; it runs after
               dist, and on fewer than four cards prints a line saying it
               did not run and how many cards it saw): sharded retrieval
               on (2, 2) as in dist, every batch equal to the one-process
               kernel-path merge bit for bit and audited against the plain
               path, K1, the planner and K2 launched on every card, equal
               to the same ranks over gloo on one card, rank 0's batch ms
               of both beside one device's (in turns); the launcher's
               ``--devices 4`` (``4 ranks over nccl on 4 card(s)``); an
               all-gather of 1 GiB of bf16, timed against NVLink; the
               model_axis phase's checks on (2, 2) (both axes cross
               cards); OLMo-1B at all 16 layers through the training
               launcher's ``--devices 4`` ((4, 1), FSDP), its losses
               within 1e-3 of one device and the step-4 checkpoint
               resumed on one device within 1e-4, step ms, MFU, each
               card's memory; DLRM's table row-sharded over the four
               cards. Each part prints a line as it ends (``nccl_dist``,
               ``nccl_all_gather``, ``nccl_model_axis``, ``nccl_train``,
               ``nccl_dlrm``), then the ``nccl`` line sums them up.
               ``--phases nccl`` runs only build, the scale world and this
               phase; ``--phases nccl_full`` serves the launcher's
               ``--devices 4`` at m = 4,096 (about 8.8M docs); both need
               four cards and print no ``kernels`` line.

Phases 8–25 run after the lifecycle phase, the kernels phase (7) between
dist and encoder. Every row of the ``kernels`` line gives its launches in
each phase (``path_launches``: serve, superblock, pipelined, lifecycle,
frontend, dist (one count a rank), encoder, train_encoder, train_lm,
recsys_asc, recsys, train_recsys, train_gnn, moe, train_moe,
train_sharded, model_axis, examples, dryrun) and, under ``catalog``, its
times at the recsys_asc phase's shapes.
The last two lines are the ``kernels`` summary and the card line; the very
last is ``{"ok": true, "device": {...}}``. With ``--profile`` one more
phase traces one 64-query batch of the serve phase's engine and one of
the pipelined engine with torch.profiler (device time, busy share, top
kernels).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
GOLDEN = ROOT / "tests" / "golden" / "golden_topk.json"

# the H100 SXM's published peaks (NVIDIA data sheet): HBM3 bytes/s and
# fp32 FMA outside the tensor cores
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12

# tolerances of kernel vs plain version on the same inputs: fp32 sums in
# another order (K1, K2, K4); integer queues must match exactly (K3)
RTOL = 1e-5
ATOL = 1e-6

# scale phase: configs/asc_splade.py widths, depth cut m 4096 -> 512
M_CLUSTERS = 512
DOCS_PER_CLUSTER = 2148              # MS MARCO: 8.8M passages / 4096
N_TOPICS = 256
SEED = 20260
DEVICE = "cuda"


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# ---------------------------------------------------------------------------
# corpus at scale: a vectorised draw from make_corpus's distributions
# ---------------------------------------------------------------------------

def _first_distinct(cand: np.ndarray, need: np.ndarray) -> np.ndarray:
    """Per row, keep the first ``need`` distinct values of ``cand`` in draw
    order (successive sampling without replacement, the distribution of
    ``rng.choice(replace=False, p=...)``); -1 elsewhere."""
    n, c = cand.shape
    order = np.argsort(cand, axis=1, kind="stable")
    srt = np.take_along_axis(cand, order, axis=1)
    dup_sorted = np.zeros_like(srt, dtype=bool)
    dup_sorted[:, 1:] = srt[:, 1:] == srt[:, :-1]
    first = np.empty_like(dup_sorted)
    np.put_along_axis(first, order, ~dup_sorted, axis=1)
    rank = np.cumsum(first, axis=1)
    keep = first & (rank <= need[:, None])
    return np.where(keep, cand, -1)


def _draw_docs(spec, topic_cdf, base_cdf, doc_topic, seed, lo: int,
               hi: int) -> tuple[np.ndarray, np.ndarray]:
    """Docs ``[lo, hi)`` of ``make_corpus_fast`` from the stream
    ``default_rng(seed)``: (tids, weights), -1 / 0 padded."""
    draw = np.random.default_rng(seed)
    V, T = spec.vocab, spec.t_pad
    tids = np.full((hi - lo, T), -1, np.int32)
    tw = np.zeros((hi - lo, T), np.float32)
    chunk = 1 << 16
    for c_lo in range(lo, hi, chunk):
        c_hi = min(c_lo + chunk, hi)
        rows = c_hi - c_lo
        nnz = np.clip(draw.poisson(spec.doc_terms, rows), 4, T)
        n_top = np.rint(nnz * spec.topic_sharpness).astype(np.int64)
        n_bg = nnz - n_top
        u_top = draw.random((rows, 2 * int(n_top.max())))
        cand_top = np.empty(u_top.shape, np.int64)
        topics = doc_topic[c_lo:c_hi]
        for z in np.unique(topics):
            sel = topics == z
            cand_top[sel] = np.searchsorted(topic_cdf[z], u_top[sel])
        u_bg = draw.random((rows, 2 * max(int(n_bg.max()), 1)))
        cand_bg = np.searchsorted(base_cdf, u_bg)
        both = np.concatenate([_first_distinct(cand_top, n_top),
                               _first_distinct(cand_bg, n_bg)], axis=1)
        both = np.minimum(both, V - 1)
        both.sort(axis=1)                     # -1 (unused) first
        both[:, 1:][both[:, 1:] == both[:, :-1]] = -1     # t1 / t2 overlap
        both.sort(axis=1)
        terms = both[:, -T:]                  # the kept terms, ascending
        keep = terms >= 0
        # left-align each row's terms
        pos = np.cumsum(keep, axis=1) - 1
        r = np.repeat(np.arange(rows), keep.sum(axis=1)) + c_lo - lo
        tids[r, pos[keep]] = terms[keep]
        tw[r, pos[keep]] = draw.lognormal(
            0.0, 0.6, int(keep.sum())).astype(np.float32)
    return tids, tw


def make_corpus_fast(spec, rng_seed: int, parts: int = 1):
    """(SparseDocs, doc_topic) with ``make_corpus``'s distributions at a
    size its per-document loop cannot reach in a smoke run: the topic term
    sets and document topics are drawn exactly as ``make_corpus`` draws
    them from ``default_rng(spec.seed)``; each document's terms (Poisson
    nnz clipped to [4, t_pad], topical share from the boosted topic
    distribution, the rest zipf background, unique per document) and its
    lognormal(0, 0.6) weights come from a vectorised stream of their own
    (``parts`` > 1: ``parts`` equal blocks of documents, each from the
    stream ``default_rng([rng_seed, part])``, drawn in parallel
    processes)."""
    import torch
    from repro_torch.core.types import SparseDocs
    from repro_torch.data.synthetic import _zipf_probs

    V, n = spec.vocab, spec.n_docs
    rng = np.random.default_rng(spec.seed)
    base_p = _zipf_probs(V, spec.zipf_a)
    topic_size = max(8, V // spec.n_topics)
    topic_cdf = np.empty((spec.n_topics, V))
    for z in range(spec.n_topics):
        terms = rng.choice(V, topic_size, replace=False)
        p = base_p.copy()
        p[terms] *= spec.topic_boost
        topic_cdf[z] = np.cumsum(p / p.sum())
    doc_topic = rng.integers(0, spec.n_topics, n)
    base_cdf = np.cumsum(base_p)
    common = (spec, topic_cdf, base_cdf, doc_topic)
    if parts == 1:
        tids, tw = _draw_docs(*common, rng_seed, 0, n)
    else:
        import concurrent.futures
        import multiprocessing
        edges = np.linspace(0, n, parts + 1).astype(int)
        with concurrent.futures.ProcessPoolExecutor(
                parts, mp_context=multiprocessing.get_context("spawn")) as ex:
            done = list(ex.map(_draw_docs, *zip(*[
                (*common, [rng_seed, p], edges[p], edges[p + 1])
                for p in range(parts)])))
        tids = np.concatenate([d[0] for d in done])
        tw = np.concatenate([d[1] for d in done])
        del done
    mask = tids >= 0
    docs = SparseDocs(tids=torch.from_numpy(tids), tw=torch.from_numpy(tw),
                      mask=torch.from_numpy(mask), vocab=V)
    return docs, doc_topic


def topic_chunked_assign(doc_topic: np.ndarray, m: int) -> np.ndarray:
    """Topic-sorted chunking into m clusters (benchmarks/common.py)."""
    n = len(doc_topic)
    order = np.argsort(doc_topic, kind="stable")
    bounds = np.linspace(0, n, m + 1).astype(int)
    assign = np.empty(n, np.int64)
    for c in range(m):
        assign[order[bounds[c]:bounds[c + 1]]] = c
    return assign


# ---------------------------------------------------------------------------
# result checks
# ---------------------------------------------------------------------------

COUNTERS = ("n_scored_docs", "n_scored_clusters", "n_scored_segments",
            "n_scored_tiles", "n_walked_tiles", "n_walked_docs",
            "n_bounded_clusters", "n_walked_superblocks",
            "n_pruned_superblocks")
TIE_TOL = 1e-3


def check_topk(want_ids, want_scores, got_ids, got_scores, what: str) -> None:
    """tests/test_golden_regression.py's rule: score multisets to 1e-4,
    id sets exact except docs that tie the k-th score within 1e-3."""
    want_ids, got_ids = np.asarray(want_ids), np.asarray(got_ids)
    want_scores = np.asarray(want_scores, np.float64)
    got_scores = np.asarray(got_scores, np.float64)
    if got_ids.shape != want_ids.shape:
        raise AssertionError(f"{what}: shape {got_ids.shape} != "
                             f"{want_ids.shape}")
    if not np.allclose(np.sort(got_scores, 1), np.sort(want_scores, 1),
                       rtol=1e-4, atol=1e-4):
        raise AssertionError(f"{what}: top-k scores differ")
    for q in range(want_ids.shape[0]):
        diff = set(want_ids[q].tolist()) ^ set(got_ids[q].tolist())
        if not diff:
            continue
        score_of = dict(zip(want_ids[q].tolist(), want_scores[q]))
        score_of.update(zip(got_ids[q].tolist(), got_scores[q]))
        kth = want_scores[q].min()
        for d in diff:
            if abs(score_of[d] - kth) >= TIE_TOL:
                raise AssertionError(f"{what}: query {q} doc {d} differs "
                                     f"beyond tie tolerance")


def check_same(a, b, what: str) -> None:
    """Kernel path vs plain path: ids by the tie rule, scores to 1e-4,
    every counter equal."""
    check_topk(b.doc_ids.cpu(), b.scores.cpu(), a.doc_ids.cpu(),
               a.scores.cpu(), what)
    for f in COUNTERS:
        x, y = getattr(a, f).cpu(), getattr(b, f).cpu()
        if not bool((x == y).all()):
            raise AssertionError(f"{what}: counter {f} differs: "
                                 f"{x.tolist()} vs {y.tolist()}")


def check_fields(a, b, what: str) -> None:
    """All 11 TopK fields: ids and counters exactly, scores to RTOL."""
    import torch
    from repro_torch.core.types import TOPK_FIELDS
    for f in TOPK_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        same = (torch.allclose(x, y, rtol=RTOL, atol=ATOL) if f == "scores"
                else torch.equal(x, y))
        if not same:
            raise AssertionError(f"{what}: {f} differs")


def check_close(a, b, what: str) -> None:
    """All 11 TopK fields: the nine counters exactly, scores position by
    position to RTOL, ids by the tie rule of ``check_topk``. With the
    ranked scores equal to RTOL, two ids can only trade places where
    their scores tie that closely: K2 and the plain version sum in
    another fp32 order, so a near-tie (14.213666 against 14.213664) may
    come out in either order."""
    import torch
    if not torch.allclose(a.scores, b.scores, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{what}: scores differ beyond rtol {RTOL}")
    check_same(a, b, what)


def check_identical(a, b, what: str) -> None:
    """All 11 TopK fields bit for bit."""
    import torch
    from repro_torch.core.types import TOPK_FIELDS
    for f in TOPK_FIELDS:
        if not torch.equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"{what}: {f} differs")


def check_merge(got, want, what: str) -> None:
    """The merge's (scores, ids) bit for bit, +0.0 against -0.0 too."""
    import torch
    (gs, gi), (ws, wi) = got, want
    if not (torch.equal(gs.view(torch.int32), ws.view(torch.int32))
            and torch.equal(gi, wi)):
        raise AssertionError(f"{what}: differs from the sort path")


# the counters each query of a batched walk counts for itself; the others
# are batch-level (one value replicated over the batch) or constants
PER_QUERY = ("n_scored_docs", "n_scored_clusters", "n_scored_segments")


@contextlib.contextmanager
def recorded_decisions(log: list):
    """Record every batched walk's decisions: one entry a walk (its
    suffix maxima, from ``_walk_order``) holding each wave's admission
    inputs and outputs (from ``_admission``) and the theta each wave's
    merge leaves (from ``_merge_wave``). The per-query engine makes its
    decisions inline and records nothing."""
    import repro_torch.core.search as search_mod
    admission, walk_order = search_mod._admission, search_mod._walk_order
    merge_wave = search_mod._merge_wave

    def walk(order_key, n_pos):
        out = walk_order(order_key, n_pos)
        log.append({"suffix": out[2], "waves": [], "theta_end": []})
        return out

    def merge(top_scores, top_ids, scores, theta, ids_flat, k):
        out = merge_wave(top_scores, top_ids, scores, theta, ids_flat, k)
        log[-1]["theta_end"].append(out[0][:, k - 1])
        return out

    def admit(cfg, **kw):
        out = admission(cfg, **kw)
        log[-1]["waves"].append(dict(
            asc=cfg.method == "asc", admit=out[0], seg_admit=out[1],
            **{k: kw[k] for k in ("glive", "done", "theta", "max_s_w",
                                  "avg_s_w", "key_w", "seg_b_w", "mu",
                                  "eta")}))
        return out

    search_mod._walk_order, search_mod._admission = walk, admit
    search_mod._merge_wave = merge
    try:
        yield log
    finally:
        search_mod._walk_order, search_mod._admission = walk_order, admission
        search_mod._merge_wave = merge_wave


def _near(lhs, rhs) -> bool:
    """A decision ``lhs <= rhs`` (or ``>``) within the inputs' rounding:
    both sides come from fp32 sums (K1's bounds, K2's scores) that the
    kernel and its plain version take in other orders (RTOL each)."""
    return abs(float(lhs) - float(rhs)) <= 2 * RTOL * abs(float(rhs)) + ATOL


def _pruned(x: dict, q: int):
    """Query q's prune test over the wave's slots, recomputed from the
    recorded inputs exactly as ``_admission`` computes it."""
    th = x["theta"][q]
    if x["asc"]:
        return ((x["max_s_w"][q] <= th / x["mu"][q])
                & (x["avg_s_w"][q] <= th / x["eta"][q]))
    return x["key_w"][q] <= th / x["mu"][q]


def first_divergence(k_walk: dict, p_walk: dict, q: int) -> str | None:
    """Where query ``q``'s decisions first differ between the kernel-path
    and the plain-path walk (None if never). Raises unless every decision
    that differs at that wave is a near tie in both walks: the early exit
    taken after the previous wave (a walk that stopped had every query
    done), a live slot's prune test, a segment's admission in a cluster
    both admit. Admission can differ only through those (the budget
    horizon and clamp count earlier decisions, equal until here). Past the
    first divergence the walks may differ as its consequence."""
    import torch
    walks = (k_walk, p_walk)
    g = k_walk["waves"][0]["admit"].shape[1]
    for w in range(max(len(k_walk["waves"]), len(p_walk["waves"]))):
        done = [bool(x["waves"][w]["done"][q]) if w < len(x["waves"])
                else True for x in walks]
        if done[0] != done[1]:
            nxt = min(w * g, k_walk["suffix"].shape[1] - 1)
            x0 = k_walk["waves"][0]
            div = (x0["eta"] if x0["asc"] else x0["mu"])[q]
            if not all(_near(x["suffix"][q, nxt],
                             x["theta_end"][w - 1][q] / div) for x in walks):
                raise AssertionError(f"query {q}: the early exit after wave "
                                     f"{w - 1} differs beyond a near tie")
            return f"the early exit after wave {w - 1}"
        if done[0]:
            continue
        a, b = (x["waves"][w] for x in walks)
        th = [x["theta"][q] for x in (a, b)]
        div = [(x["eta"] if x["asc"] else x["mu"])[q] for x in (a, b)]
        d_prune = ((_pruned(a, q) != _pruned(b, q)) & a["glive"]
                   ).nonzero().flatten().tolist()
        both = a["admit"][q] & b["admit"][q]
        d_seg = ((a["seg_admit"][q] != b["seg_admit"][q]) & both[:, None]
                 ).nonzero().tolist()
        if not d_prune and not d_seg:
            if not torch.equal(a["admit"][q], b["admit"][q]):
                raise AssertionError(f"query {q}: admission differs at wave "
                                     f"{w} with every test equal")
            continue
        for j in d_prune:
            if a["asc"]:
                ok = all(_near(x["max_s_w"][q, j], t / x["mu"][q])
                         or _near(x["avg_s_w"][q, j], t / x["eta"][q])
                         for x, t in zip((a, b), th))
            else:
                ok = all(_near(x["key_w"][q, j], t / x["mu"][q])
                         for x, t in zip((a, b), th))
            if not ok:
                raise AssertionError(f"query {q}: the prune test of slot {j} "
                                     f"at wave {w} differs beyond a near tie")
        for j, sg in d_seg:
            if not all(_near(x["seg_b_w"][q, j, sg], t / v)
                       for x, t, v in zip((a, b), th, div)):
                raise AssertionError(f"query {q}: segment {sg} of slot {j} "
                                     f"at wave {w} differs beyond a near tie")
        return (f"wave {w}: prune tests of slots {d_prune}, segments "
                f"{d_seg}")
    return None


def check_audited(got, want, k_log: list, p_log: list, rows: list,
                  what: str) -> list[dict]:
    """Kernel path ``got`` against plain path ``want``: scores position by
    position to RTOL, ids by the tie rule of ``check_topk``, every counter
    exactly, except where the two paths' recorded decisions first diverge
    at a near tie (``first_divergence``): then that query's own counters,
    and the batch-level counters of its walk, may differ. ``rows[i]``
    lists the (walk, row) pairs output row i was merged from. Returns the
    counters that differed, each with the divergence behind it."""
    import torch
    if len(k_log) != len(p_log):
        raise AssertionError(f"{what}: {len(k_log)} walks against "
                             f"{len(p_log)}")
    if not torch.allclose(got.scores, want.scores, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{what}: scores differ beyond rtol {RTOL}")
    check_topk(want.doc_ids.cpu(), want.scores.cpu(), got.doc_ids.cpu(),
               got.scores.cpu(), what)
    seen: dict = {}

    def diverged(c: int, r: int):
        if (c, r) not in seen:
            seen[c, r] = first_divergence(k_log[c], p_log[c], r)
        return seen[c, r]

    flips = []
    for f in COUNTERS:
        a, b = getattr(got, f).cpu(), getattr(want, f).cpu()
        for i in (a != b).nonzero().flatten().tolist():
            walks = {c for c, _ in rows[i]}
            why = ([diverged(c, r) for c, r in rows[i]] if f in PER_QUERY
                   else [diverged(c, r) for c in walks
                         for r in range(k_log[c]["waves"][0]["admit"]
                                        .shape[0])])
            why = [x for x in why if x]
            if not why:
                raise AssertionError(f"{what}: counter {f} of row {i} "
                                     f"differs ({int(a[i])} against "
                                     f"{int(b[i])}) with no divergence")
            flips.append({"row": i, "counter": f, "kernel": int(a[i]),
                          "plain": int(b[i]), "near_tie": why[0]})
    return flips


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(fn, target_ms: float = 150.0) -> float:
    """Mean device time of ``fn`` over repeated calls (CUDA events,
    warmed; the repeat count is sized from one timed call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    one = max(start.elapsed_time(end), 1e-3)
    reps = int(min(max(math.ceil(target_ms / one), 3), 200))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: its kernels, fills and copies
    summed under torch.profiler, without the host's dispatch between
    them (which CUDA events around a call include)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = flops / FP32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(torch) -> str:
    from repro_torch import device as dev
    t0 = time.perf_counter()
    dev.kernel_lib()
    seconds = time.perf_counter() - t0
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        # the name alone: no number is reported without its power limit
        card = f"{torch.cuda.get_device_name(0)}, power limit not read"
    log("build", seconds=round(seconds, 3), cached=dev.build_info["cached"],
        card=card, torch=torch.__version__, cuda=torch.version.cuda,
        ptxas=[ln for ln in dev.build_info.get("ptxas", [])
               if "registers" in ln])
    return card


GOLDEN_CONFIGS = {
    "batched_asc": dict(k=10, mu=0.8, eta=1.0, method="asc",
                        engine="batched", block_q=4, block_d=8),
    "batched_asc_safe": dict(k=10, mu=1.0, eta=1.0, method="asc",
                             engine="batched", block_q=4, block_d=8),
    "batched_anytime": dict(k=10, mu=1.0, eta=1.0, method="anytime",
                            engine="batched", block_q=4, block_d=None),
    "per_query_asc": dict(k=10, mu=0.8, eta=1.0, method="asc",
                          engine="per_query"),
    "batched_budget": dict(k=10, mu=1.0, eta=1.0, method="anytime",
                           engine="batched", cluster_budget=4, block_q=4,
                           block_d=8),
    "superblock_asc_safe": dict(k=10, mu=1.0, eta=1.0, method="asc",
                                engine="batched", superblocks=True,
                                block_q=4, block_d=8),
    "superblock_approx": dict(k=10, mu=0.8, eta=1.0, method="asc",
                              engine="batched", superblocks=True, block_q=4),
}


# tests/test_golden_regression.py's CHURNED_ENGINES
CHURNED_CONFIGS = ("batched_asc_safe", "batched_asc", "superblock_asc_safe")


def phase_golden() -> None:
    from repro_torch.core.search import (SearchConfig, brute_force_topk,
                                         retrieve)
    from repro_torch.lifecycle import MutableIndex
    from repro_torch.tools.golden_world import (WRITER_SEED, apply_op,
                                                golden_churn_ops,
                                                golden_world)

    golden = json.loads(GOLDEN.read_text())
    index, queries = golden_world(DEVICE)
    results = {name: retrieve(index, queries, SearchConfig(**kw),
                              device=DEVICE)
               for name, kw in GOLDEN_CONFIGS.items()}
    results["brute_force"] = brute_force_topk(index, queries, 10,
                                              device=DEVICE)
    for name, r in results.items():
        want = golden["engines"][name]
        check_topk(want["doc_ids"], want["scores"], r.doc_ids.cpu(),
                   r.scores.cpu(), f"golden/{name}")
    # the churned fixture: the golden stream through the port's writer,
    # its snapshot published to the card
    mi = MutableIndex(index, seed=WRITER_SEED)
    for op in golden_churn_ops():
        apply_op(mi, op)
    churned = mi.snapshot(DEVICE)
    for name in CHURNED_CONFIGS + ("brute_force",):
        r = (brute_force_topk(churned, queries, 10, device=DEVICE)
             if name == "brute_force" else
             retrieve(churned, queries, SearchConfig(**GOLDEN_CONFIGS[name]),
                      device=DEVICE))
        want = golden["churned"][name]
        check_topk(want["doc_ids"], want["scores"], r.doc_ids.cpu(),
                   r.scores.cpu(), f"golden/churned/{name}")
    log("golden", configs=sorted(results), matched=True,
        churned=list(CHURNED_CONFIGS) + ["brute_force"],
        churned_matched=True)


def scale_world(m: int | None = None, parts: int = 1):
    """The MS MARCO geometry at ``m`` (None: ``M_CLUSTERS``) clusters of
    ``DOCS_PER_CLUSTER`` docs (``make_corpus_fast`` in ``parts``), its
    index on the card, and the phases' queries."""
    from repro_torch.configs.asc_splade import config
    from repro_torch.core.index import build_index
    from repro_torch.data.synthetic import CorpusSpec, make_queries

    geo = config()
    m = m or M_CLUSTERS
    n_docs = m * DOCS_PER_CLUSTER
    spec = CorpusSpec(n_docs=n_docs, vocab=geo.vocab, n_topics=N_TOPICS,
                      doc_terms=67, t_pad=geo.t_pad, query_terms=23,
                      q_pad=geo.q_pad, seed=SEED)
    t0 = time.perf_counter()
    docs, doc_topic = make_corpus_fast(spec, rng_seed=SEED + 1,
                                       parts=parts)
    t_corpus = time.perf_counter() - t0
    assign = topic_chunked_assign(doc_topic, m)
    t0 = time.perf_counter()
    index = build_index(docs, assign, m=m, n_seg=geo.n_seg,
                        d_pad=geo.d_pad, seed=SEED + 2, device=DEVICE)
    t_build = time.perf_counter() - t0
    queries, _ = make_queries(spec, 8 * 64 + 3 * 2 + 64 + 16 + 8 + 64,
                              doc_topic, seed=SEED + 3)
    fe_queries, _ = make_queries(spec, FE_QUERIES, doc_topic, seed=FE_SEED)
    log("scale_world", n_docs=n_docs, m=index.m, vocab=index.vocab,
        d_pad=index.d_pad, t_pad=index.t_pad, q_pad=queries.q_pad,
        n_seg=index.n_seg, mean_nnz=float(docs.mask.sum(1).float().mean()),
        index_mb=round(index.nbytes() / 1e6, 1),
        doc_tids_mb=round(index.doc_tids.numel() * 2 / 1e6, 1),
        corpus_parts=parts, seconds_corpus=round(t_corpus, 1),
        seconds_build=round(t_build, 1))
    return geo, index, queries, docs, fe_queries


def _slice(queries, lo, hi):
    from repro_torch.core.types import QueryBatch
    return QueryBatch(tids=queries.tids[lo:hi], tw=queries.tw[lo:hi],
                      mask=queries.mask[lo:hi], vocab=queries.vocab)


def _plan_call(args) -> tuple[tuple, dict]:
    """``plan_wave``'s (positional, keyword) arguments from a captured call
    of the planner kernel's wrapper."""
    (cids, live, admit, seg_admit, block_q, dseg, dmask, block_d, soff, su,
     scope) = args
    return ((cids, live, admit, seg_admit, block_q, dseg, dmask),
            dict(block_d=block_d, seg_offsets=soff, sorted_upto=su,
                 union_scope=scope))


def capture_inputs(engine, queries) -> dict:
    """Warm-up run of one 64-batch and one 2-batch that records the inputs
    the main path hands each kernel wrapper (first call of K2 and K4, K1's
    call at each batch size; every wave's planner call). Not counted."""
    seen: dict = {"plan_wave_kernel": [], "segment_bound_gemm": {}}

    def recorder(name, fn):
        def rec(*args, **kw):
            if name == "plan_wave_kernel":
                seen[name].append(args)
            elif name == "segment_bound_gemm":
                seen[name].setdefault(args[1].n_queries, args)
            elif name not in seen:
                seen[name] = (args, kw)
            return fn(*args, **kw)
        return rec

    from repro_torch.tools.plain_path import swapped_wrappers
    with swapped_wrappers(recorder):
        engine.warmup(_slice(queries, 0, 64))
        engine.warmup(_slice(queries, 64, 66))
    return seen


def phase_serve(geo, index, queries, torch):
    from repro_torch.core.search import (SearchConfig, brute_force_topk,
                                         retrieve)
    from repro_torch.kernels import (MAIN_PATH, launch_counts,
                                     reset_launch_counts)
    from repro_torch.serving.engine import RetrievalEngine
    from repro_torch.tools.plain_path import plain_versions, swapped_wrappers

    cfg = SearchConfig(k=geo.k, mu=geo.mu, eta=geo.eta, method="asc",
                       group_size=geo.group_size, bounds_impl="gemm",
                       engine="auto")
    engine = RetrievalEngine(index, cfg, device=DEVICE)
    captured = capture_inputs(engine, queries)

    batches = ([(_slice(queries, 64 * i, 64 * (i + 1)), None)
                for i in range(8)]
               + [(_slice(queries, 512 + 2 * i, 514 + 2 * i), None)
                  for i in range(3)])
    mixed = _slice(queries, 518, 582)
    ladder = np.array([[0.9, 1.0], [0.5, 0.7], [1.0, 1.0], [0.7, 0.9]],
                      np.float32)
    batches.append((mixed, ladder[np.arange(64) % 4]))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    per_batch = []
    t_all = time.perf_counter()
    outs = []
    for q, mu_eta in batches:
        t0 = time.perf_counter()
        out = engine.search(q, mu_eta=mu_eta)
        ms = (time.perf_counter() - t0) * 1e3
        outs.append(out)
        per_batch.append({
            "n_q": q.n_queries, "ms": round(ms, 3),
            "engine": engine.last_run["engine"],
            "waves": engine.last_run["waves"],
            "host_syncs": engine.last_run["host_syncs"],
            "mixed_mu_eta": mu_eta is not None,
            "scored_tiles": int(out.n_scored_tiles.max()),
            "walked_tiles": int(out.n_walked_tiles.max()),
            "walked_docs": int(out.n_walked_docs.max()),
            "scored_docs_mean": float(out.n_scored_docs.float().mean()),
            "scored_clusters_mean": float(
                out.n_scored_clusters.float().mean())})
    total_s = time.perf_counter() - t_all
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_served = sum(q.n_queries for q, _ in batches)
    for out in outs:
        ids = out.doc_ids
        if not (bool(torch.isfinite(out.scores).all())
                and bool((ids >= 0).all()) and ids.shape[1] == geo.k):
            raise AssertionError("serve: non-finite scores or missing ids")
    missing = [k for k in MAIN_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"serve: kernels never launched on the main "
                             f"path: {missing}")
    log("serve", batches=per_batch, queries=n_served,
        seconds=round(total_s, 4), qps=round(n_served / total_s, 2),
        launches=launches, max_memory_allocated_mb=round(peak / 1e6, 1))

    # kernel path vs plain path on the card, same inputs: all four
    # wrappers swapped for their plain versions
    q16 = _slice(queries, 582, 598)
    st_k, st_p = {}, {}
    got = retrieve(index, q16, cfg, device=DEVICE, stats=st_k)
    with swapped_wrappers(plain_versions):
        want = retrieve(index, q16, cfg, device=DEVICE, stats=st_p)
    check_same(got, want, "kernel vs plain (16 queries)")
    # safe mode against brute force
    q8 = _slice(queries, 598, 606)
    safe = retrieve(index, q8, SearchConfig(
        k=geo.k, mu=1.0, eta=1.0, method="asc", group_size=geo.group_size,
        bounds_impl="gemm", engine="batched"), device=DEVICE)
    bf = brute_force_topk(index, q8, geo.k, device=DEVICE)
    check_topk(bf.doc_ids.cpu(), bf.scores.cpu(), safe.doc_ids.cpu(),
               safe.scores.cpu(), "safe mode vs brute force (8 queries)")
    log("checks", kernel_vs_plain=True, kernel_waves=st_k["waves"],
        plain_waves=st_p["waves"], safe_vs_brute_force=True)
    fresh_ms = [b["ms"] for b in per_batch[:8]]
    return engine, launches, captured, fresh_ms


SB_BATCHES = 4          # 64-query batches each of the two engines serves


def _walk_cfg(geo, **over):
    from repro_torch.core.search import SearchConfig
    return SearchConfig(**{**dict(k=geo.k, mu=geo.mu, eta=geo.eta,
                                  method="asc", group_size=geo.group_size,
                                  bounds_impl="gemm", engine="batched"),
                           **over})


def phase_superblock(geo, index, queries, torch) -> dict:
    """The two-level walk served at the scale world: level 0 prices S
    superblocks with K1, each walked superblock prices its members with
    K1 again and runs one wave of K3 and K2 at G = cap. Returns the launch
    counts and the inputs its kernels were given (a warm-up run, not
    counted)."""
    from repro_torch.core.search import brute_force_topk, retrieve
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.engine import RetrievalEngine
    from repro_torch.tools.plain_path import plain_versions, swapped_wrappers

    cfg = _walk_cfg(geo, superblocks=True)
    engine = RetrievalEngine(index, cfg, device=DEVICE)
    batches = [_slice(queries, 64 * i, 64 * (i + 1))
               for i in range(SB_BATCHES)]
    seen: dict = {"segment_bound_gemm": [], "plan_wave_kernel": []}

    def recorder(name, fn):
        def rec(*args, **kw):
            if name in ("segment_bound_gemm", "plan_wave_kernel"):
                seen[name].append(args)
            elif name not in seen:
                seen[name] = (args, kw)
            return fn(*args, **kw)
        return rec

    with swapped_wrappers(recorder):
        engine.warmup(batches[0])
    torch.cuda.synchronize()
    reset_launch_counts()
    per_batch, outs = [], []
    for q in batches:
        t0 = time.perf_counter()
        out = engine.search(q)
        ms = (time.perf_counter() - t0) * 1e3
        outs.append(out)
        per_batch.append({
            "ms": round(ms, 3), "waves": engine.last_run["waves"],
            "host_syncs": engine.last_run["host_syncs"],
            "walked_superblocks": int(out.n_walked_superblocks[0]),
            "pruned_superblocks": int(out.n_pruned_superblocks[0]),
            "bounded_clusters": int(out.n_bounded_clusters[0]),
            "scored_clusters_mean": float(
                out.n_scored_clusters.float().mean()),
            "scored_tiles": int(out.n_scored_tiles[0]),
            "walked_tiles": int(out.n_walked_tiles[0])})
    launches = launch_counts()
    for out in outs:
        if not (bool(torch.isfinite(out.scores).all())
                and bool((out.doc_ids >= 0).all())):
            raise AssertionError("superblock: non-finite scores or "
                                 "missing ids")
    walked = sum(b["walked_superblocks"] for b in per_batch)
    # K1 once a batch at level 0 and once a walked superblock for its
    # members; one planner call (two kernels) and one K2 a walked wave
    want = {"segment_bound_gemm": SB_BATCHES + walked,
            "plan_wave": 2 * walked, "score_queue": walked,
            "score_clusters": 0}
    got = {name: launches[name] for name in want}
    if got != want or walked == 0:
        raise AssertionError(f"superblock: launches {got}, expected "
                             f"{want}")

    # every field against the on-card plain path, then safe mode against
    # brute force
    q = batches[0]
    mine = retrieve(index, q, cfg, device=DEVICE)
    with swapped_wrappers(plain_versions):
        plain = retrieve(index, q, cfg, device=DEVICE)
    check_fields(mine, plain, "superblock: kernel vs plain (64 queries)")
    q16 = _slice(queries, 582, 598)
    safe = retrieve(index, q16, dataclasses.replace(cfg, mu=1.0, eta=1.0),
                    device=DEVICE)
    bf = brute_force_topk(index, q16, geo.k, device=DEVICE)
    check_topk(bf.doc_ids.cpu(), bf.scores.cpu(), safe.doc_ids.cpu(),
               safe.scores.cpu(), "superblock: safe mode vs brute force "
               "(16 queries)")
    log("superblock", S=index.n_super, cap=index.super_cap, m=index.m,
        batches=per_batch, launches=launches,
        k1_launches={"level0": SB_BATCHES, "members": walked},
        kernel_vs_plain=True, safe_vs_brute_force=True)
    return {"launches": launches, "captured": seen}


def phase_pipelined(geo, index, queries, torch) -> dict:
    """The pipelined engine served at the scale world, held bit for bit
    against the batched engine on the same batches, then both timed in
    turns and split into planner and executor time."""
    from repro_torch.core.plan import wave_summaries
    from repro_torch.core.search import (planner_executor_split,
                                         retrieve_pipelined,
                                         retrieve_with_plans)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.engine import RetrievalEngine

    cfg_b = _walk_cfg(geo)
    cfg_p = dataclasses.replace(cfg_b, engine="pipelined", fuse_waves="auto")
    eng_p = RetrievalEngine(index, cfg_p, device=DEVICE)
    eng_b = RetrievalEngine(index, cfg_b, device=DEVICE)
    batches = [_slice(queries, 64 * i, 64 * (i + 1))
               for i in range(SB_BATCHES)]
    eng_p.warmup(batches[0])
    eng_b.warmup(batches[0])
    torch.cuda.synchronize()
    reset_launch_counts()
    runs, outs = [], []
    for q in batches:
        t0 = time.perf_counter()
        outs.append(eng_p.search(q))
        ms = (time.perf_counter() - t0) * 1e3
        runs.append({"ms": round(ms, 3), **{
            key: eng_p.last_run[key] for key in (
                "waves", "host_syncs", "plan_launches", "exec_launches",
                "fused_waves")},
            **{key: round(eng_p.last_run[key], 3)
               for key in ("plan_ms", "exec_ms")}})
    launches = launch_counts()
    waves = sum(r["waves"] for r in runs)
    # K1 once a batch (the prologue); at least one planner call and one
    # K2 a wave that ran; the per-query scorer never
    if not (launches["segment_bound_gemm"] == SB_BATCHES
            and launches["plan_wave"] >= 2 * waves
            and launches["score_queue"] >= waves
            and launches["score_clusters"] == 0):
        raise AssertionError(f"pipelined: launches {launches}")
    for q, out in zip(batches, outs):
        ref, (plans, executed) = retrieve_with_plans(index, q, cfg_b,
                                                     device=DEVICE)
        check_identical(out, ref, "pipelined vs batched")
        _, info = retrieve_pipelined(index, q, cfg_p, device=DEVICE,
                                     with_info=True)
        if info["summaries"] != wave_summaries(plans, executed):
            raise AssertionError("pipelined: wave summaries differ from "
                                 "the batched engine's recorded plans")

    # batch ms of both engines in turns (p, b, b, p, ...)
    turns = {"pipelined": [], "batched": []}
    for r in range(3):
        for q in batches:
            order = [("pipelined", eng_p), ("batched", eng_b)]
            for name, eng in (order if r % 2 == 0 else order[::-1]):
                t0 = time.perf_counter()
                eng.search(q)
                turns[name].append((time.perf_counter() - t0) * 1e3)
    split = {}
    for name, cfg in (("pipelined", cfg_p), ("batched", cfg_b)):
        _, _, sp = planner_executor_split(index, batches[0], cfg, reps=5,
                                          device=DEVICE)
        split[name] = {key: (round(v, 4) if isinstance(v, float) else v)
                       for key, v in sp.items()}
    log("pipelined", batches=runs, launches=launches,
        identical_to_batched=True, summaries_equal=True,
        batch_ms={name: {"median": float(np.median(v)),
                         "min": float(np.min(v)), "max": float(np.max(v)),
                         "n": len(v)} for name, v in turns.items()},
        split=split)
    return {"launches": launches, "engine": eng_p}


# lifecycle phase: 6 rounds of 4,096 deletes and 4,096 inserts, one
# requantizing compaction after round 4, a writer fault in round 5
LC_ROUNDS = 6
LC_DOCS = 4096
LC_COMPACT_AFTER = 4
LC_FAULT_ROUND = 5
LC_SEED = SEED + 10


def lifecycle_ops(live_ids, geo) -> tuple[list, list]:
    """The phase's op stream as concrete data (the form of
    tests/test_crash_recovery.py), and each round's [lo, hi) range.
    Deletes are drawn uniformly from the live ids; inserted documents
    come from the scale world's own distribution (``make_corpus_fast``
    with seeds of their own) and take the ids a writer hands out next;
    the compaction rebalances and requantizes."""
    from repro_torch.data.synthetic import CorpusSpec
    spec = CorpusSpec(n_docs=LC_ROUNDS * LC_DOCS, vocab=geo.vocab,
                      n_topics=N_TOPICS, doc_terms=67, t_pad=geo.t_pad,
                      query_terms=23, q_pad=geo.q_pad, seed=LC_SEED)
    docs, _ = make_corpus_fast(spec, rng_seed=LC_SEED + 1)
    tids, tw, mask = docs.tids.numpy(), docs.tw.numpy(), docs.mask.numpy()
    rng = np.random.default_rng(LC_SEED + 2)
    live = np.sort(np.asarray(live_ids, np.int64))
    next_id = int(live.max()) + 1
    ops, bounds = [], []
    for r in range(LC_ROUNDS):
        lo = len(ops)
        if r == LC_COMPACT_AFTER:
            ops.append(("compact", True, True))
        dead = rng.choice(live, LC_DOCS, replace=False)
        ops += [("delete", int(d)) for d in dead]
        live = np.setdiff1d(live, dead)
        for i in range(r * LC_DOCS, (r + 1) * LC_DOCS):
            ops.append(("insert", tids[i][mask[i]].astype(np.int64),
                        tw[i][mask[i]]))
        live = np.concatenate([live, np.arange(next_id, next_id + LC_DOCS)])
        next_id += LC_DOCS
        bounds.append((lo, len(ops)))
    return ops, bounds


@contextlib.contextmanager
def timed_methods(spec: dict):
    """Record the seconds of every call of each ``(class, method)`` in its
    list while the block runs."""
    originals = []
    for (cls, name), sink in spec.items():
        fn = getattr(cls, name)
        originals.append((cls, name, fn))

        def wrapper(self, *a, _fn=fn, _sink=sink, **kw):
            t0 = time.perf_counter()
            out = _fn(self, *a, **kw)
            _sink.append(time.perf_counter() - t0)
            return out
        setattr(cls, name, wrapper)
    try:
        yield
    finally:
        for cls, name, fn in originals:
            setattr(cls, name, fn)


def hold_kernels(run, torch, calls: list | None = None) -> dict:
    """Run ``run()`` once with every kernel wrapper recording its calls,
    then hold each recorded call's kernel output against its plain version
    on the same inputs: the planner's queues exactly, bounds and scores to
    RTOL with NEG positions exact. These launches are comparisons: the
    caller counts only its own searches. ``calls`` (if given) receives the
    recorded (name, wrapper, args, kwargs)."""
    from repro_torch.kernels.score_cluster_batch.ref import NEG
    from repro_torch.tools.plain_path import plain_versions, swapped_wrappers
    calls = [] if calls is None else calls

    def recorder(name, fn):
        def rec(*a, **kw):
            calls.append((name, fn, a, kw))
            return fn(*a, **kw)
        return rec
    with swapped_wrappers(recorder):
        run()
    held = {}
    for name, fn, a, kw in calls:
        got, want = fn(*a, **kw), plain_versions(name, fn)(*a, **kw)
        row = held.setdefault(name, {"calls": 0, "max_abs_err": 0.0})
        row["calls"] += 1
        if name == "plan_wave_kernel":
            bad = [f for f, x in want.items() if not torch.equal(got[f], x)]
            if bad:
                raise AssertionError(f"planner kernel differs from its "
                                     f"plain version: {bad}")
            continue
        if name == "merge_topk":
            check_merge(got, want, "merge kernel")
            continue
        neg = want == NEG
        if not torch.equal(got == NEG, neg):
            raise AssertionError(f"{name}: NEG positions differ")
        g, w = got[~neg], want[~neg]
        if not torch.allclose(g, w, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version beyond rtol {RTOL}")
        if g.numel():
            row["max_abs_err"] = max(row["max_abs_err"],
                                     float((g - w).abs().max()))
    return held


def reordered_rows(got, want) -> list[dict]:
    """The rows whose ids two paths ranked in another order, with the
    differing positions' ids and scores on each side."""
    rows = []
    for q in (got.doc_ids != want.doc_ids).any(1).nonzero().flatten():
        q = int(q)
        pos = (got.doc_ids[q] != want.doc_ids[q]).nonzero().flatten()
        rows.append(dict(query=q, positions=pos.tolist(),
                         kernel=[[int(got.doc_ids[q, i]),
                                  float(got.scores[q, i])] for i in pos],
                         plain=[[int(want.doc_ids[q, i]),
                                 float(want.scores[q, i])] for i in pos]))
    return rows


def _dir_mb(path: str) -> float:
    return sum(e.stat().st_size for e in os.scandir(path)
               if e.is_file()) / 1e6


def phase_lifecycle(geo, index, queries, fresh_ms, torch) -> dict:
    """A live, churning index served on the card: a DurableIndexWriter
    (WAL, checkpoints every 4 commits) publishes one epoch a round to a
    SnapshotPublisher that a RetrievalEngine with observability serves;
    each epoch's batches are held against the on-card plain path and safe
    mode against brute force. A WAL fault in round 5 degrades health while
    the engine keeps serving the last good epoch; recovery republishes and
    the stream finishes. The recovered writer must equal a shadow writer
    that ran every op without a WAL, and the last epoch on the card the
    writer's host mirrors."""
    import tempfile

    from repro_torch.core.search import (brute_force_topk, resolved_engine,
                                         retrieve)
    from repro_torch.core.types import INDEX_FIELDS
    from repro_torch.kernels import (MAIN_PATH, launch_counts,
                                     reset_launch_counts)
    from repro_torch.lifecycle import (DurableIndexWriter, FaultInjected,
                                       FaultSchedule, MutableIndex, install)
    from repro_torch.obs import Observability, funnel_from_topk
    from repro_torch.serving.engine import RetrievalEngine
    from repro_torch.tools.golden_world import apply_op
    from repro_torch.tools.plain_path import plain_versions, swapped_wrappers

    cfg = _walk_cfg(geo, engine="auto")
    safe_cfg = dataclasses.replace(cfg, mu=1.0, eta=1.0, engine="batched")
    launches = {name: 0 for name in launch_counts()}
    times = {"publish": [], "checkpoint": [], "compact": []}
    epochs = []

    def serve(engine, q):
        """One engine search, its kernel launches counted (and only
        its)."""
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = engine.search(q)
        ms = (time.perf_counter() - t0) * 1e3
        for name, n in launch_counts().items():
            launches[name] += n
        return out, ms

    def check_epoch(engine, writer, r, what):
        """Serve a 64-query batch (twice: the first call on the epoch and
        a warm one) and a 2-query batch on the current epoch; hold each
        against the on-card plain path on the same epoch, and safe mode
        against brute force over its live docs."""
        b = (r - 1) % 8
        q64 = _slice(queries, 64 * b, 64 * (b + 1))
        q2 = _slice(queries, 512 + 2 * (r % 3), 514 + 2 * (r % 3))
        out64, ms_first = serve(engine, q64)
        _, ms_warm = serve(engine, q64)
        out2, ms2 = serve(engine, q2)
        snap = writer.publisher.current
        if engine.last_epoch != snap.epoch:
            raise AssertionError(f"lifecycle: served epoch "
                                 f"{engine.last_epoch}, current "
                                 f"{snap.epoch}")
        reordered = []
        with swapped_wrappers(plain_versions):
            for q, out, n in ((q64, out64, 64), (q2, out2, 2)):
                want = retrieve(snap.index, q, cfg, device=DEVICE)
                check_close(out, want, f"lifecycle {what}: kernel vs "
                            f"plain ({n} queries)")
                # ids the two paths order differently (near-ties)
                reordered += [dict(batch=n, **row)
                              for row in reordered_rows(out, want)]
        # each kernel call of both batches on this epoch's churned inputs
        # (tombstones, unsorted tails, the current scale)
        held = hold_kernels(lambda: [retrieve(snap.index, q, cfg,
                                              device=DEVICE)
                                     for q in (q64, q2)], torch)
        q16 = _slice(queries, 582, 598)
        safe = retrieve(snap.index, q16, safe_cfg, device=DEVICE)
        bf = brute_force_topk(snap.index, q16, geo.k, device=DEVICE)
        check_topk(bf.doc_ids.cpu(), bf.scores.cpu(), safe.doc_ids.cpu(),
                   safe.scores.cpu(), f"lifecycle {what}: safe mode vs "
                   f"brute force (16 queries)")
        mi = writer.mutable
        epochs.append(dict(
            epoch=snap.epoch, what=what, n_docs=snap.n_docs,
            scale=float(mi.scale), slack=mi.slack(),
            unsorted_tail_fraction=mi.unsorted_tail_fraction(),
            clusters_with_tail=int((mi.sorted_upto < mi.d_pad).sum()),
            tie_reordered=reordered, kernels_held=held,
            batch=b, ms_64=round(ms_first, 3), ms_64_warm=round(ms_warm, 3),
            fresh_ms_64=fresh_ms[b], ms_2=round(ms2, 3),
            engine_64=resolved_engine(cfg, 64),
            engine_2=resolved_engine(cfg, 2),
            memory_allocated_mb=round(torch.cuda.memory_allocated() / 1e6,
                                      1),
            funnel_64={k: v for k, v in funnel_from_topk(
                out64, batched=True, n_q=64, d_pad=snap.index.d_pad,
                budget_clusters=snap.index.m).items() if k != "d_pad"}))
        return out64

    spec = {(MutableIndex, "snapshot"): times["publish"],
            (MutableIndex, "checkpoint"): times["checkpoint"],
            (MutableIndex, "compact"): times["compact"]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, timed_methods(spec):
        obs = Observability()
        t0 = time.perf_counter()
        # compaction only where the op stream puts it (slack stays far
        # below 1 here), so every op is one op_seq and the shadow, which
        # never commits, runs the same ops
        writer = DurableIndexWriter(index, tmp, fsync="interval",
                                    checkpoint_every=4, seed=LC_SEED + 3,
                                    compact_threshold=1.0,
                                    registry=obs.registry, device=DEVICE)
        t_writer = time.perf_counter() - t0
        engine = RetrievalEngine(writer.publisher, cfg, device=DEVICE,
                                 obs=obs)
        t0 = time.perf_counter()
        ops, bounds = lifecycle_ops(writer.mutable.live_ids(), geo)
        t_ops = time.perf_counter() - t0
        fault, recovery, slow_reader, good64 = {}, {}, None, None
        for r, (lo, hi) in enumerate(bounds, 1):
            todo = ops[lo:hi]
            if r == LC_FAULT_ROUND:
                # the fault: the WAL refuses one append mid-round (after
                # the compaction, the deletes and half the inserts); the
                # writer's in-memory state is then not trusted
                nth = 1 + LC_DOCS + LC_DOCS // 2 + 1
                sched = FaultSchedule([("wal.append.pre_write", nth,
                                        "raise")])
                try:
                    with install(sched):
                        for op in todo:
                            apply_op(writer, op)
                except FaultInjected:
                    pass
                if sched.fired != [("wal.append.pre_write", "raise")]:
                    raise AssertionError(f"lifecycle: fault fired "
                                         f"{sched.fired}")
                engine.health.to("degraded", "wal append fault")
                b = (LC_FAULT_ROUND - 2) % 8
                q = _slice(queries, 64 * b, 64 * (b + 1))
                degraded, ms = serve(engine, q)
                check_identical(degraded, good64, "lifecycle: degraded "
                                "batch vs the last good epoch")
                fault = dict(op=writer.mutable.op_seq, nth_append=nth,
                             served_epoch=engine.last_epoch,
                             degraded_batch_ms=round(ms, 3),
                             identical_to_last_good=True)
                # the dead writer's log as far as it got; its object goes
                writer.mutable.wal.close()
                publisher = writer.publisher
                del writer
                engine.health.to("recovering", "recovering the writer")
                t0 = time.perf_counter()
                writer = DurableIndexWriter.recover(
                    tmp, fsync="interval", checkpoint_every=4,
                    publisher=publisher, registry=obs.registry,
                    device=DEVICE)
                rec_s = time.perf_counter() - t0
                engine.health.to("healthy", "recovered epoch published")
                st = writer.recovery_stats
                recovery = dict(seconds=round(rec_s, 3),
                                load_and_replay_s=round(st["duration_s"], 3),
                                replayed=st["n_replayed"],
                                torn_tail=st["torn_tail"],
                                checkpoint_op_seq=st["checkpoint_op_seq"],
                                op_seq=st["op_seq"],
                                epoch=publisher.current.epoch)
                check_epoch(engine, writer, r, "recovered")
                todo = ops[writer.mutable.op_seq:hi]
            for op in todo:
                apply_op(writer, op)
            if r == LC_ROUNDS:
                # a slow reader keeps the previous epoch alive across the
                # last publish: two epochs (and the base) on the card
                slow_reader = writer.publisher.current
            writer.commit()
            out = check_epoch(engine, writer, r, f"round {r}")
            if r == LC_FAULT_ROUND - 1:
                good64 = out
        two_epochs_mb = torch.cuda.memory_allocated() / 1e6
        del slow_reader
        peak = torch.cuda.max_memory_allocated()
        phase_s = time.perf_counter() - t_phase
        missing = [k for k in MAIN_PATH if launches[k] == 0]
        if missing:
            raise AssertionError(f"lifecycle: kernels never launched: "
                                 f"{missing}")

        # the last epoch on the card is the writer's host mirrors
        host = writer.mutable._host_index()
        card = writer.publisher.current.index
        for f in INDEX_FIELDS:
            if not np.array_equal(getattr(card, f).cpu().numpy(),
                                  np.asarray(getattr(host, f))):
                raise AssertionError(f"lifecycle: card epoch field {f} "
                                     f"differs from the mirrors")
        ckpt_mb = _dir_mb(os.path.join(tmp, "snapshot"))
        free_gb = shutil.disk_usage(tmp).free / 1e9

    # the shadow: every op, no WAL, no fault
    t0 = time.perf_counter()
    shadow = MutableIndex(index, seed=LC_SEED + 3, compact_threshold=1.0)
    for op in ops:
        apply_op(shadow, op)
    shadow_s = time.perf_counter() - t0
    mine, ref = writer.mutable._host_index(), shadow._host_index()
    for f in INDEX_FIELDS:
        if not np.array_equal(np.asarray(getattr(mine, f)),
                              np.asarray(getattr(ref, f))):
            raise AssertionError(f"lifecycle: recovered writer field {f} "
                                 f"differs from the shadow")
    m, s = writer.mutable, shadow
    if not (m.op_seq == s.op_seq == len(ops) and m.scale == s.scale
            and m._rng.bit_generator.state == s._rng.bit_generator.state
            and m._loc == s._loc):
        raise AssertionError("lifecycle: recovered writer state differs "
                             "from the shadow")
    reg = obs.registry.snapshot()
    metrics = {k: v for k, v in reg.items()
               if k.startswith(("index_", "wal_", "lifecycle_"))}
    idx_bytes = index.nbytes()
    log("lifecycle", rounds=LC_ROUNDS,
        inserts=sum(op[0] == "insert" for op in ops),
        deletes=sum(op[0] == "delete" for op in ops),
        clips=int(reg.get("index_clipped_inserts_total", 0)),
        compactions=sum(op[0] == "compact" for op in ops),
        compaction_seconds=[round(t, 3) for t in times["compact"]],
        compaction_calls=["writer", "recovery replay"][:len(
            times["compact"])],
        publish_ms=[round(t * 1e3, 2) for t in times["publish"]],
        publish_gb_s=[round(idx_bytes / t / 1e9, 2)
                      for t in times["publish"]],
        index_mb=round(idx_bytes / 1e6, 1),
        checkpoint_seconds=[round(t, 3) for t in times["checkpoint"]],
        checkpoint_mb=round(ckpt_mb, 1), tmp_free_gb=round(free_gb, 1),
        writer_init_seconds=round(t_writer, 3),
        ops_build_seconds=round(t_ops, 3), fault=fault, recovery=recovery,
        health=[list(t) for t in engine.health.transitions],
        final_health=engine.health.state,
        two_epochs_memory_allocated_mb=round(two_epochs_mb, 1),
        max_memory_allocated_mb=round(peak / 1e6, 1),
        fresh_ms_64_median=float(np.median(fresh_ms)),
        shadow_seconds=round(shadow_s, 3), shadow_equal=True,
        card_equals_mirrors=True, epochs=epochs, launches=launches,
        metrics=metrics, seconds=round(phase_s, 3))
    return {"launches": launches}


# frontend phase: single-query requests at 0.7x, 2x and 0.5x the capacity
# the phase measures (64 / the warm 64-query batch ms), then lone requests
# each sent after the last was served (buckets of 1: the per-query route)
FE_STEPS = ((0.7, 1000), (2.0, 500), (0.5, 300))
FE_TRICKLE = 4
FE_MIXED = 8            # rows of the batch that mixes ladder levels
FE_MIXED_TRIES = 3
FE_QUERIES = (sum(n for _, n in FE_STEPS) + FE_TRICKLE
              + FE_MIXED * FE_MIXED_TRIES)
FE_REPLAYS = 8          # recorded dispatches held against the plain path
FE_SEED = SEED + 20


def _family_total(snap: dict, name: str) -> float:
    v = snap.get(name, 0.0)
    return float(sum(v.values())) if isinstance(v, dict) else float(v)


def phase_frontend(geo, engine, index, fe_queries, torch) -> dict:
    """The streaming front-end over the serve phase's engine (batches of 1
    and 2 take the per-query route, K4; 4 and up K1, the planner and K2),
    fed single-query requests from the main thread while ``start()``'s
    pump thread dispatches. Every served row must equal its row of the
    recorded dispatch, and recorded dispatches, replayed after the pump
    thread is joined, must equal the on-card plain path."""
    from repro_torch.core.search import retrieve
    from repro_torch.kernels import (MAIN_PATH, launch_counts,
                                     reset_launch_counts)
    from repro_torch.serving.frontend import (FrontendConfig, ServedResult,
                                              StreamingFrontend, query_rows)
    from repro_torch.tools.plain_path import plain_versions, swapped_wrappers

    rows = list(query_rows(fe_queries))
    keys = [r.tids[0].numpy().tobytes() for r in rows]
    if len(set(keys)) != len(keys):
        raise AssertionError("frontend: the request queries repeat")
    # capacity from the warm 64-query batch
    q64 = _slice(fe_queries, 0, 64)
    warm = []
    for _ in range(4):
        t0 = time.perf_counter()
        engine.search(q64)
        warm.append((time.perf_counter() - t0) * 1e3)
    batch_ms = float(np.median(warm[1:]))
    capacity = 64 / (batch_ms / 1e3)
    fcfg = FrontendConfig(max_batch=64, max_queue=256,
                          default_deadline_ms=4.0 * batch_ms,
                          slo_p99_ms=2.5 * batch_ms, closed_loop=True)
    fe = StreamingFrontend(engine, fcfg)
    t0 = time.perf_counter()
    fe.warmup(rows[0])
    warmup_s = time.perf_counter() - t0

    dispatches = []
    search = engine.search

    def recorder(qb, mu_eta=None, budget_frac=None):
        t0 = time.perf_counter()
        out = search(qb, mu_eta=mu_eta, budget_frac=budget_frac)
        dispatches.append(dict(qb=qb, mu_eta=mu_eta, budget_frac=budget_frac,
                               out=out, ms=(time.perf_counter() - t0) * 1e3))
        return out
    on_batch = fe.controller.on_batch
    evals = []

    def counted_on_batch(*a, **kw):
        on_batch(*a, **kw)
        evals.append(1)

    def wait_idle():
        # every recorded dispatch has passed its controller evaluation
        t0 = time.perf_counter()
        while fe.queue_depth or len(evals) < len(dispatches):
            if time.perf_counter() - t0 > 30:
                raise AssertionError("frontend: the pump thread is stuck")
            time.sleep(1e-3)

    engine.search = recorder
    fe.controller.on_batch = counted_on_batch
    torch.cuda.synchronize()
    reset_launch_counts()
    futs, i = [], 0
    mixed_tries = 0
    try:
        fe.start()
        t_start = time.perf_counter()
        due, step_s = 0.0, []
        for mult, n in FE_STEPS:
            t_step = time.perf_counter()
            for _ in range(n):
                due += 1.0 / (mult * capacity)
                wait = t_start + due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                futs.append(fe.submit(rows[i]))
                i += 1
            step_s.append(time.perf_counter() - t_step)
        for _ in range(FE_TRICKLE):
            futs.append(fe.submit(rows[i]))
            i += 1
            futs[-1].result(timeout=60)
        traffic_s = time.perf_counter() - t_start
        wait_idle()
        served_traffic = fe.conservation()["served"]
        # a batch that mixes levels: with the pump idle, half its rows
        # are stamped at the ladder's level (at least 1), then the
        # controller is put back to 0 and the rest stamped there; the
        # dispatch serves each row at the deeper of its stamp and 0
        deep = max(fe.controller.level, 1)
        while mixed_tries < FE_MIXED_TRIES:
            mixed_tries += 1
            wait_idle()
            fe.controller.level = deep
            batch = []
            for h in range(FE_MIXED):
                if h == FE_MIXED // 2:
                    fe.controller.level = 0
                batch.append(fe.submit(rows[i]))
                i += 1
            futs += batch
            for f in batch:
                f.result(timeout=60)
            wait_idle()
            if any(len({tuple(x) for x in rec["mu_eta"].tolist()}) > 1
                   for rec in dispatches[-2:]):
                break
        thread = fe._thread
        drained = fe.shutdown()
    finally:
        engine.search = search
        fe.controller.on_batch = on_batch
    launches = launch_counts()
    if thread is None or thread.is_alive():
        raise AssertionError("frontend: the pump thread was not joined")
    if not all(f.done() for f in futs):
        raise AssertionError("frontend: a future is not done after "
                             "shutdown")
    snap = fe.registry.snapshot()
    cons = fe.conservation()
    failures = _family_total(snap, "frontend_dispatch_failures_total")
    if not cons["balanced"] or failures:
        raise AssertionError(f"frontend: conservation {cons}, dispatch "
                             f"failures {failures}")
    missing = [k for k in MAIN_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"frontend: kernels never launched: {missing}")

    # every served row equals its row of the recorded dispatch
    where = {}
    for d, rec in enumerate(dispatches):
        for r in range(rec["qb"].n_queries):
            where.setdefault(rec["qb"].tids[r].numpy().tobytes(), (d, r))
    outcomes: dict = {}
    for key, f in zip(keys, futs):
        res = f.result(timeout=0)
        kind = type(res).__name__
        outcomes[kind] = outcomes.get(kind, 0) + 1
        if not isinstance(res, ServedResult):
            continue
        d, r = where[key]
        rec = dispatches[d]
        if not (torch.equal(res.doc_ids, rec["out"].doc_ids[r].cpu())
                and torch.equal(res.scores, rec["out"].scores[r].cpu())):
            raise AssertionError(f"frontend: a served row differs from "
                                 f"its dispatch {d} row {r}")
        me = rec["mu_eta"][r]
        if (float(me[0]), float(me[1])) != (np.float32(res.mu),
                                            np.float32(res.eta)):
            raise AssertionError("frontend: served (mu, eta) differs from "
                                 "the dispatch's")

    # replay: buckets below 4, mixed-level and degraded batches, then
    # evenly spaced others, through the on-card plain path
    def levels(rec):
        return {tuple(x) for x in rec["mu_eta"].tolist()}
    small = [d for d, rec in enumerate(dispatches) if rec["qb"].n_queries < 4]
    mixed = [d for d, rec in enumerate(dispatches) if len(levels(rec)) > 1]
    full = (engine.cfg.mu, engine.cfg.eta)
    degraded = [d for d, rec in enumerate(dispatches)
                if rec["budget_frac"] is not None
                or any(lv != tuple(np.float32(full)) for lv in levels(rec))]
    pick = sorted(set(small[:2] + mixed[:2] + degraded[:2]))
    for d in np.linspace(0, len(dispatches) - 1, FE_REPLAYS).astype(int):
        if len(pick) >= FE_REPLAYS:
            break
        if int(d) not in pick:
            pick.append(int(d))
    pick.sort()
    if len(pick) < FE_REPLAYS or not small:
        raise AssertionError(f"frontend: {len(dispatches)} dispatches, "
                             f"{len(small)} below 4: too few to replay")
    if not mixed:
        raise AssertionError(f"frontend: no dispatch mixed ladder levels "
                             f"in {mixed_tries} tries")
    if fe.controller.level_max > 0 and not set(pick) & set(degraded):
        raise AssertionError("frontend: the ladder moved but no degraded "
                             "batch was replayed")
    budget0 = engine._budget()
    flips = []
    for d in pick:
        rec = dispatches[d]
        b = budget0
        if rec["budget_frac"] is not None:
            b = max(8, int(min(b, index.m) * rec["budget_frac"]))
        what = f"frontend dispatch {d} ({rec['qb'].n_queries} queries)"
        k_log, p_log = [], []
        with recorded_decisions(k_log):
            kern = retrieve(index, rec["qb"], engine.cfg, budget=b,
                            mu_eta=rec["mu_eta"], device=DEVICE)
        check_identical(rec["out"], kern,
                        f"{what} vs its replay on the kernel path")
        with swapped_wrappers(plain_versions), recorded_decisions(p_log):
            want = retrieve(index, rec["qb"], engine.cfg, budget=b,
                            mu_eta=rec["mu_eta"], device=DEVICE)
        rows = [[(0, i)] if k_log else []
                for i in range(kern.doc_ids.shape[0])]
        flips += [{"dispatch": d, **f} for f in check_audited(
            kern, want, k_log, p_log, rows, f"{what} vs plain")]

    req = snap.get("serve_request_latency_ms", {})
    queue = snap.get("frontend_time_in_queue_ms", {})
    sizes = snap.get("frontend_batch_size", {})
    log("frontend", batch_ms_64=round(batch_ms, 3),
        capacity_qps=round(capacity, 1),
        slo_p99_ms=round(fcfg.slo_p99_ms, 3),
        deadline_ms=round(fcfg.default_deadline_ms, 3),
        steps=[dict(x_capacity=m, requests=n, seconds=round(t, 4),
                    offered_qps=round(n / t, 1))
               for (m, n), t in zip(FE_STEPS, step_s)],
        trickle=FE_TRICKLE, warmup_seconds=round(warmup_s, 3),
        traffic_seconds=round(traffic_s, 4),
        served_qps=round(served_traffic / traffic_s, 1), conservation=cons,
        outcomes=outcomes, drained=drained,
        e2e_p50_ms=req.get("p50"), e2e_p99_ms=req.get("p99"),
        e2e_windowed_p50_ms=engine.stats.windowed_p(50),
        e2e_windowed_p99_ms=engine.stats.windowed_p(99),
        queue_p50_ms=queue.get("p50"), queue_p99_ms=queue.get("p99"),
        queue_mean_ms=queue.get("mean"),
        batch_sizes=sizes.get("buckets"), dispatches=len(dispatches),
        counter_flips_vs_plain=flips,
        dispatch_ms_median=float(np.median([r["ms"] for r in dispatches])),
        shed=snap.get("frontend_shed_total", {}),
        deadline_met=snap.get("frontend_deadline_met_total"),
        deadline_missed=snap.get("frontend_deadline_missed_total"),
        deadline_exceeded=snap.get("frontend_deadline_exceeded_total"),
        served_by_level=snap.get("frontend_served_total", {}),
        ladder_max_level=fe.controller.level_max,
        ladder_moves=snap.get("frontend_degradation_transitions_total", {}),
        health=[list(t) for t in engine.health.transitions
                if t[3] == "overload"],
        mixed_dispatches=len(mixed), mixed_tries=mixed_tries,
        mixed_levels=sorted({lv for d in mixed
                             for lv in levels(dispatches[d])}),
        degraded_dispatches=len(degraded),
        replayed=[dict(dispatch=d, n_q=dispatches[d]["qb"].n_queries,
                       levels=len(levels(dispatches[d])),
                       budget_frac=dispatches[d]["budget_frac"])
                  for d in pick],
        dispatch_failures=failures, launches=launches)
    return {"launches": launches, "batch_ms": batch_ms,
            "capacity": capacity}


# cluster phase: k-means over the scale world's projection, then the
# balanced assignment at the index's d_pad
CL_DIM, CL_ITERS = 96, 8
CL_SUB = 65_536          # the card-vs-CPU subsample
CL_SUB_TIGHT = 160       # 1.25x its mean cluster: many spill rounds


def phase_cluster(geo, index, queries, docs, torch) -> dict:
    """The index-build tooling on the card at the scale world's size:
    ``dense_rep_projection`` (dim 96), ``lloyd_kmeans`` (k = 512, 8
    iterations) and ``balanced_assign`` (capacity d_pad), each timed; an
    index built from the assignment serves a 64-query batch beside the
    topic-chunked index. A second build from the same seed must give the
    same bits. On a subsample the card's balanced assignment is held
    against the CPU port's."""
    from repro_torch.core import clustering as tc
    from repro_torch.core.index import build_index
    from repro_torch.core.search import retrieve

    k, cap, n = M_CLUSTERS, geo.d_pad, docs.n_docs
    ms = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = round((time.perf_counter() - t0) * 1e3, 3)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 1e6
    rep = timed("projection", lambda: tc.dense_rep_projection(
        docs, dim=CL_DIM, device=DEVICE))
    # lloyd_kmeans's own draw of its initial centers, for the inertia gate
    init = rep[torch.randperm(n, generator=torch.Generator().manual_seed(
        0))[:k].to(DEVICE)]
    centers, nearest = timed("lloyd_kmeans", lambda: tc.lloyd_kmeans(
        torch.Generator().manual_seed(0), rep, k=k, iters=CL_ITERS))
    assign = timed("balanced_assign",
                   lambda: tc.balanced_assign(rep, centers, capacity=cap))
    peak_mb = torch.cuda.max_memory_allocated() / 1e6

    def inertia(c):
        return float(tc.sq_distances(rep, c).min(dim=1).values.double().sum())
    in0, in1 = inertia(init), inertia(centers)
    counts = torch.bincount(assign.long(), minlength=k)
    if not (assign.shape == (n,) and int(assign.min()) >= 0
            and int(assign.max()) < k and int(counts.sum()) == n):
        raise AssertionError("cluster: the assignment does not place "
                             "every doc in one cluster")
    if int(counts.max()) > cap:
        raise AssertionError(f"cluster: a cluster holds {int(counts.max())} "
                             f"docs, over capacity {cap}")
    if not in1 <= in0:
        raise AssertionError(f"cluster: Lloyd raised the inertia "
                             f"{in0} -> {in1}")
    natural = torch.bincount(nearest, minlength=k)
    # one seed, one index: a second build gives the same bits
    t0 = time.perf_counter()
    rep2 = tc.dense_rep_projection(docs, dim=CL_DIM, device=DEVICE)
    centers2, nearest2 = tc.lloyd_kmeans(torch.Generator().manual_seed(0),
                                         rep2, k=k, iters=CL_ITERS)
    assign2 = tc.balanced_assign(rep2, centers2, capacity=cap)
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    for what, a, b in (("projection", rep, rep2),
                       ("centroids", centers, centers2),
                       ("nearest", nearest, nearest2),
                       ("assignment", assign, assign2)):
        if not torch.equal(a, b):
            raise AssertionError(f"cluster: a second build from the same "
                                 f"seed gives another {what}")
    del rep2, centers2, nearest2, assign2

    # the index built from it: every doc placed once
    t0 = time.perf_counter()
    km = build_index(docs, assign.cpu().numpy(), m=k, n_seg=geo.n_seg,
                     d_pad=cap, seed=SEED + 2, device=DEVICE)
    build_s = time.perf_counter() - t0
    live = km.doc_ids[km.doc_mask]
    if not torch.equal(torch.sort(live).values,
                       torch.arange(n, dtype=live.dtype, device=DEVICE)):
        raise AssertionError("cluster: the built index does not hold every "
                             "doc exactly once")
    cfg = _walk_cfg(geo, engine="auto")
    q64 = _slice(queries, 0, 64)
    scored = {}
    for name, idx in (("kmeans", km), ("topic_chunks", index)):
        out = retrieve(idx, q64, cfg, device=DEVICE)
        scored[name] = dict(
            clusters_mean=float(out.n_scored_clusters.float().mean()),
            docs_mean=float(out.n_scored_docs.float().mean()),
            walked_tiles=int(out.n_walked_tiles.max()),
            scored_tiles=int(out.n_scored_tiles.max()))
    del km

    # the card against the CPU port on a subsample
    sub = rep[torch.randperm(n, generator=torch.Generator().manual_seed(
        1))[:CL_SUB].to(DEVICE)]
    got = tc.balanced_assign(sub, centers, capacity=cap).cpu()
    sub_c, cen_c = sub.cpu(), centers.cpu()
    want = tc.balanced_assign(sub_c, cen_c, capacity=cap)
    d2_card = tc.sq_distances(sub, centers)
    d2_cpu = tc.sq_distances(sub_c, cen_c)
    rounding = (d2_card.cpu() - d2_cpu).abs().max(dim=1).values
    near = torch.topk(d2_cpu, 2, dim=1, largest=False).values
    tie = (near[:, 1] - near[:, 0]) <= 2 * rounding
    if int(torch.bincount(want.long(), minlength=k).max()) >= cap:
        raise AssertionError("cluster: a subsample cluster filled")
    if not torch.equal(got[~tie], want[~tie]):
        raise AssertionError(f"cluster: the card's balanced_assign differs "
                             f"from the CPU port's on "
                             f"{int((got != want)[~tie].sum())} non-tie rows")
    tight = tc._balanced_rounds(d2_card, CL_SUB_TIGHT).cpu()
    if not torch.equal(tight, tc._balanced_rounds(d2_card.cpu(),
                                                  CL_SUB_TIGHT)):
        raise AssertionError("cluster: the card's balanced rounds differ "
                             "from the CPU's on the same distances")
    log("cluster", n_docs=n, k=k, dim=CL_DIM, iters=CL_ITERS, capacity=cap,
        ms=ms, peak_memory_allocated_mb=round(peak_mb, 1),
        base_memory_allocated_mb=round(base_mb, 1),
        inertia_initial=in0, inertia_final=in1,
        natural_sizes=dict(max=int(natural.max()), min=int(natural.min()),
                           over_capacity=int((natural > cap).sum())),
        balanced_sizes=dict(max=int(counts.max()), min=int(counts.min())),
        spilled_docs=int((assign.long() != nearest).sum()),
        build_seconds=round(build_s, 3), scored_64=scored,
        second_build_identical=True, second_build_seconds=round(rebuild_s, 3),
        subsample=dict(n=CL_SUB, capacity=cap, tie_rows=int(tie.sum()),
                       differing_rows=int((got != want).sum()),
                       max_distance_rounding=float(rounding.max()),
                       tight_capacity=CL_SUB_TIGHT,
                       tight_spilled=int((tight.long()
                                          != d2_cpu.argmin(1)).sum()),
                       tight_rounds_equal=True))
    return {"scored_64": scored}


CLI_CHURN = 4096
CLI_CHECKPOINT_EVERY = 4


def _cli_lines(out: str, prefix: str) -> list[int]:
    return [i for i, ln in enumerate(out.splitlines())
            if ln.startswith(prefix)]


def _cli_frontend(metrics_path, out: str, what: str) -> dict:
    """The launcher's front-end counters from its metrics dump: they must
    balance, no dispatch may have failed (the front-end turns a failure
    into a typed rejection, which would otherwise pass as shedding), and
    some request must have been served."""
    m = json.loads(Path(metrics_path).read_text())
    counts = {name: _family_total(m, name) for name in (
        "frontend_requests_total", "frontend_served_total",
        "frontend_shed_total", "frontend_deadline_exceeded_total",
        "frontend_dispatch_failures_total")}
    if counts["frontend_requests_total"] != (
            counts["frontend_served_total"] + counts["frontend_shed_total"]
            + counts["frontend_deadline_exceeded_total"]):
        raise AssertionError(f"{what}: front-end counters do not balance: "
                             f"{counts}")
    if (counts["frontend_dispatch_failures_total"]
            or "[frontend] dispatch failed" in out):
        raise AssertionError(f"{what}: a dispatch failed:\n{out}")
    if not counts["frontend_served_total"]:
        raise AssertionError(f"{what}: the front-end served nothing: "
                             f"{counts}")
    return {"metrics": m, "counts": counts}


def phase_cli(index, fe, saved, torch) -> None:
    """``python -m repro_torch.launch.serve`` as a user starts it, on the
    saved scale world: the closed-loop front-end, churn through a durable
    write plane, SIGTERM after the first periodic checkpoint (the drain,
    then the final checkpoint, exit 0), then a restart on the same
    directory that recovers at that checkpoint and serves. The world is
    saved to ``saved``, where the dist phase loads it again."""
    import signal
    import tempfile

    from repro_torch.lifecycle import read_manifest, save_index

    env = {**os.environ, "PYTHONPATH": str(SRC)}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_index(saved, index, epoch=0)
        save_s = time.perf_counter() - t0
        durable = os.path.join(tmp, "durable")
        args = [sys.executable, "-m", "repro_torch.launch.serve",
                "--device", DEVICE, "--load-dir", saved,
                "--vocab", str(index.vocab), "--n-docs", "2000",
                "--frontend", "closed", "--churn", str(CLI_CHURN),
                "--durable-dir", durable,
                "--checkpoint-every", str(CLI_CHECKPOINT_EVERY),
                "--batch-size", "64",
                "--arrival-qps", f"{0.7 * fe['capacity']:.1f}",
                "--slo-p99-ms", f"{2.5 * fe['batch_ms']:.3f}",
                "--deadline-ms", f"{4.0 * fe['batch_ms']:.3f}"]

        def epoch_on_disk() -> int:
            try:
                return int(read_manifest(os.path.join(durable, "snapshot"),
                                         verify=False)["epoch"])
            except (OSError, ValueError, KeyError, RuntimeError):
                return -1

        t0 = time.perf_counter()
        proc = subprocess.Popen(
            args + ["--batches", "1000", "--metrics-json",
                    os.path.join(tmp, "m1.json")], env=env, cwd=tmp,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            while epoch_on_disk() < CLI_CHECKPOINT_EVERY:
                if proc.poll() is not None:
                    raise AssertionError(f"cli: the launcher exited "
                                         f"early:\n{proc.stdout.read()}")
                if time.perf_counter() - t0 > 300:
                    raise AssertionError("cli: no periodic checkpoint "
                                         "within 300 s")
                time.sleep(0.1)
            up_s = time.perf_counter() - t0
            t_sig = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            out1, _ = proc.communicate(timeout=300)
            exit_s = time.perf_counter() - t_sig
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"cli: exit code {proc.returncode}:\n"
                                 f"{out1}")
        drain = _cli_lines(out1, "[serve] frontend drained")
        final = _cli_lines(out1, "[serve] final checkpoint")
        if not (drain and final and drain[0] < final[0]):
            raise AssertionError(f"cli: no drain line before the final "
                                 f"checkpoint line:\n{out1}")
        first = _cli_frontend(Path(tmp, "m1.json"), out1, "cli")
        m1 = first["metrics"]
        manifest = read_manifest(os.path.join(durable, "snapshot"))
        op_seq = int(manifest["extra"]["writer"]["op_seq"])

        t0 = time.perf_counter()
        again = subprocess.run(
            args + ["--batches", "2", "--metrics-json",
                    os.path.join(tmp, "m2.json")], env=env, cwd=tmp,
            capture_output=True, text=True, timeout=300)
        restart_s = time.perf_counter() - t0
        out2 = again.stdout
        if again.returncode != 0:
            raise AssertionError(f"cli restart: exit code "
                                 f"{again.returncode}:\n{out2}"
                                 f"{again.stderr}")
        rec = [ln for ln in out2.splitlines()
               if ln.startswith("[serve] recovered write plane")]
        if not (rec and f"'op_seq': {op_seq}," in rec[0]
                and f"'checkpoint_op_seq': {op_seq}," in rec[0]):
            raise AssertionError(f"cli restart: did not recover at op_seq "
                                 f"{op_seq}:\n{out2}")
        second = _cli_frontend(Path(tmp, "m2.json"), out2, "cli restart")
        m2 = second["metrics"]

        def summary(out):
            return [ln for ln in out.splitlines()
                    if ln.startswith(("[serve] frontend drained",
                                      "[serve] final checkpoint",
                                      "[serve] interrupted",
                                      "[serve] recovered write plane"))
                    or re.match(r"\[serve\] \d+ queries in", ln)
                    or ln.startswith(("[serve] funnel",
                                      "[serve] lifecycle"))]
        log("cli", save_index_seconds=round(save_s, 3),
            first_checkpoint_after_s=round(up_s, 3),
            sigterm_to_exit_s=round(exit_s, 3),
            restart_seconds=round(restart_s, 3), recovered_op_seq=op_seq,
            frontend_counters=first["counts"],
            frontend_counters_restart=second["counts"],
            epoch_at_exit=m1.get("lifecycle_epoch"),
            queries_first=m1.get("serve_queries_total"),
            queries_restart=m2.get("serve_queries_total"),
            recovery=rec[0], first_run=summary(out1),
            restart=summary(out2))


# ---------------------------------------------------------------------------
# dist: sharded retrieval, 4 ranks on the one card
# ---------------------------------------------------------------------------

DIST_SHAPE = (2, 2)                 # ("data", "model")
DIST_WORLD = DIST_SHAPE[0] * DIST_SHAPE[1]
# the fields the reference replicates over the cluster shards
DIST_REPLICATED = ("scale", "super_members", "super_max_stacked")
# kernels every rank must launch on a batch
DIST_NEED = {"b0": ("segment_bound_gemm", "plan_wave", "score_queue"),
             "q2": ("segment_bound_gemm", "score_clusters")}


def dist_batches(geo, queries) -> list[tuple[str, object, dict]]:
    """(name, queries, SearchConfig keywords): the serve phase's first
    four 64-query batches at (mu, eta), its fifth in safe mode, its first
    2-query batch (a local batch of 1: the per-query route)."""
    base = dict(k=geo.k, method="asc", group_size=geo.group_size,
                bounds_impl="gemm", engine="auto")
    out = [(f"b{i}", _slice(queries, 64 * i, 64 * (i + 1)),
            dict(base, mu=geo.mu, eta=geo.eta)) for i in range(4)]
    out.append(("safe", _slice(queries, 256, 320),
                dict(base, mu=1.0, eta=1.0)))
    out.append(("q2", _slice(queries, 512, 514),
                dict(base, mu=geo.mu, eta=geo.eta)))
    return out


def _dist_rank(rank: int, staged: str, batches: list, device_type: str,
               cards: int | None = None):
    """One rank of the dist phase: its cluster shard on its card
    (``cuda:(rank mod cards)``, ``cards`` None: every card), an untimed
    warm-up (a 64- and a 2-query batch), then each batch timed on the
    host clock, its launches counted from zero."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.search import SearchConfig
    from repro_torch.core.types import TOPK_FIELDS, QueryBatch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh, rank_device
    from repro_torch.serving.engine import (distributed_retrieve,
                                            shard_index, staged_index)

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    dev = rank_device(rank, device_type, cards)
    mesh = make_host_mesh(DIST_SHAPE, ("data", "model"), dev.type)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    local = shard_index(staged_index(staged), mesh, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(arrays, cfg_kw):
        q = QueryBatch(*(torch.from_numpy(a) for a in arrays),
                       vocab=local.vocab)
        return distributed_retrieve(local, q, SearchConfig(**cfg_kw), mesh)

    for name, arrays, cfg_kw in batches:
        if name in ("b0", "q2"):
            run(arrays, cfg_kw)
    sync()
    setup_s = time.perf_counter() - t0
    done = []
    for name, arrays, cfg_kw in batches:
        sync()
        reset_launch_counts()
        t1 = time.perf_counter()
        out = run(arrays, cfg_kw)
        sync()
        ms = (time.perf_counter() - t1) * 1e3
        done.append({"name": name, "ms": ms, "launches": launch_counts(),
                     "fields": {f: getattr(out, f).cpu().numpy()
                                for f in TOPK_FIELDS}})
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    return {"rank": rank, "coord": list(mesh.get_coordinate()),
            "device": str(dev), "backend": dist.get_backend(),
            "local_m": local.m, "setup_s": setup_s, "batches": done,
            "peak_mb": peak / 1e6}


def dist_reference(index, q, cfg, plain: bool):
    """The sharded search done in one process, by hand: each query half
    searched on each cluster shard (views of the card's index) on the
    kernel path or, with ``plain``, the on-card plain path, in the order
    (half, shard); the shards' top-k merged by a stable top-k over their
    concatenation, seven counters summed and the two superblock counters
    taken as they are, the halves stacked."""
    import torch
    from repro_torch.core.search import retrieve, topk_stable
    from repro_torch.core.types import INDEX_FIELDS, ClusterIndex, TopK
    from repro_torch.tools.plain_path import plain_versions, swapped_wrappers

    n_data, n_model = DIST_SHAPE
    size = index.m // n_data
    shards = [ClusterIndex(
        **{f: (getattr(index, f) if f in DIST_REPLICATED
               else getattr(index, f)[s * size:(s + 1) * size])
           for f in INDEX_FIELDS}, vocab=index.vocab, n_seg=index.n_seg)
        for s in range(n_data)]
    n_local = q.n_queries // n_model
    halves = []
    with (swapped_wrappers(plain_versions) if plain
          else contextlib.nullcontext()):
        for h in range(n_model):
            qh = _slice(q, h * n_local, (h + 1) * n_local)
            part = [retrieve(sh, qh, cfg, device=DEVICE) for sh in shards]
            scores, pos = topk_stable(
                torch.cat([p.scores for p in part], 1), cfg.k)
            ids = torch.gather(torch.cat([p.doc_ids for p in part], 1), 1,
                               pos)
            counters = ([sum(getattr(p, f) for p in part)
                         for f in COUNTERS[:7]]
                        + [getattr(part[0], f) for f in COUNTERS[7:]])
            halves.append([ids, scores, *counters])
    return TopK(*(torch.cat(col) for col in zip(*halves)))


def dist_arrays(batches) -> list:
    """``dist_batches`` as numpy arrays, for the spawned ranks."""
    return [(name, tuple(getattr(q, f).numpy() for f in ("tids", "tw",
                                                          "mask")), kw)
            for name, q, kw in batches]


def dist_check(index, batches, ranks, what: str) -> tuple[list, list,
                                                           list]:
    """Every batch of ``ranks`` (``_dist_rank``'s results) against
    ``dist_reference`` on the kernel path (bit for bit, every rank) and
    on the plain path (``check_audited``), the safe batch against
    single-device retrieval; every rank launched ``DIST_NEED``. Returns
    (the batches held, the audited counter flips) and each rank's
    launches summed over its batches."""
    import torch

    from repro_torch.core.search import SearchConfig, retrieve
    from repro_torch.core.types import TOPK_FIELDS, TopK

    held, flips = [], []
    for i, (name, q, kw) in enumerate(batches):
        cfg = SearchConfig(**kw)
        got = [TopK(**{f: torch.from_numpy(r["batches"][i]["fields"][f]
                                           ).to(DEVICE)
                       for f in TOPK_FIELDS}) for r in ranks]
        for r, other in enumerate(got[1:], 1):
            check_identical(other, got[0], f"{what} {name}: rank {r}")
        k_log, p_log = [], []
        with recorded_decisions(k_log):
            kernel = dist_reference(index, q, cfg, plain=False)
        check_identical(got[0], kernel,
                        f"{what} {name} vs the one-process kernel-path "
                        f"merge")
        with recorded_decisions(p_log):
            plain = dist_reference(index, q, cfg, plain=True)
        # output row i merges row r of walk (half, shard) for each shard
        n_data, n_model = DIST_SHAPE
        n_local = q.n_queries // n_model
        rows = [[(h * n_data + sh, r) for sh in range(n_data)] if k_log
                else [] for h, r in (divmod(i, n_local)
                                     for i in range(q.n_queries))]
        flips += [{"batch": name, **f} for f in check_audited(
            got[0], plain, k_log, p_log, rows,
            f"{what} {name} vs the one-process plain merge")]
        if name == "safe":
            single = retrieve(index, q, cfg, device=DEVICE)
            if not np.allclose(np.sort(got[0].scores.cpu().numpy(), 1),
                               np.sort(single.scores.cpu().numpy(), 1),
                               rtol=1e-4, atol=1e-4):
                raise AssertionError(f"{what} safe: sharded scores differ "
                                     f"from single-device retrieval")
        held.append(name)
    for r in ranks:
        for b in r["batches"]:
            missing = [k for k in DIST_NEED.get(b["name"], ())
                       if b["launches"][k] == 0]
            if missing:
                raise AssertionError(f"{what}: rank {r['rank']} launched "
                                     f"no {missing} on batch {b['name']}")
    launches = [{k: sum(b["launches"][k] for b in r["batches"])
                 for k in r["batches"][0]["launches"]} for r in ranks]
    return held, flips, launches


def dist_cli(index, saved, backend: str, torch) -> dict:
    """``python -m repro_torch.launch.serve --devices 4`` on the saved
    world, as a user starts it: exit 0, its mesh, backend and summary
    lines (``[serve] 4 ranks over <backend> on ...``)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        metrics = os.path.join(tmp, "m.json")
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--device",
             DEVICE, "--devices", "4", "--load-dir", saved, "--vocab",
             str(index.vocab), "--n-docs", "2000", "--batch-size", "64",
             "--batches", "4", "--metrics-json", metrics],
            env={**os.environ, "PYTHONPATH": str(SRC)}, cwd=tmp,
            capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        out = run.stdout
        if run.returncode != 0:
            raise AssertionError(f"dist cli: exit code {run.returncode}:\n"
                                 f"{out}{run.stderr}")
        cards = torch.cuda.device_count()
        for want in ("[serve] sharded over {'data': 2, 'model': 2}",
                     f"[serve] 4 ranks over {backend} on {cards} card(s)",
                     "[serve] 256 queries in 4 batches", "[serve] funnel"):
            if want not in out:
                raise AssertionError(f"dist cli: no {want!r} line:\n{out}")
        served = json.loads(Path(metrics).read_text())
    lines = [ln for ln in out.splitlines()
             if ln.startswith(("[serve] sharded", "[serve] 4 ranks",
                               "[serve] funnel"))
             or re.match(r"\[serve\] \d+ queries in", ln)]
    return dict(cli_seconds=round(cli_s, 2),
                cli_queries=served.get("serve_queries_total"), cli=lines)


def ranks_backend(ranks: list, what: str) -> str:
    """The one backend every rank of ``ranks`` reports having run."""
    got = {r["backend"] for r in ranks}
    if len(got) != 1:
        raise AssertionError(f"{what}: ranks ran over {sorted(got)}")
    return got.pop()


def phase_dist(geo, index, queries, fresh_ms, saved, torch) -> dict:
    """Sharded retrieval on the one card: 4 ranks over gloo on a (2, 2)
    ("data", "model") mesh, two cluster shards of m / 2 and two query
    halves; every batch against ``dist_reference`` on the kernel path (bit
    for bit) and on the plain path (``check_audited``), the safe batch
    against single-device retrieval, the launches of every rank; then the
    launcher's ``--devices 4`` on the saved world."""
    import tempfile

    from repro_torch.launch.mesh import backend_for, spawn_ranks
    from repro_torch.serving.engine import stage_index

    t_phase = time.perf_counter()
    batches = dist_batches(geo, queries)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as staged:
        stage_index(index, staged)
        stage_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = spawn_ranks(_dist_rank, DIST_WORLD,
                            (staged, dist_arrays(batches),
                             torch.device(DEVICE).type),
                            backend="gloo", timeout_s=600)
        ranks_s = time.perf_counter() - t0
    held, flips, launches = dist_check(index, batches, ranks, "dist")
    cli = dist_cli(index, saved, backend_for(DIST_WORLD, DEVICE), torch)
    ms0 = {b["name"]: round(b["ms"], 3) for b in ranks[0]["batches"]}
    log("dist", backend=ranks_backend(ranks, "dist"),
        mesh={"data": DIST_SHAPE[0], "model": DIST_SHAPE[1]},
        ranks=DIST_WORLD, cards=torch.cuda.device_count(),
        rank_devices=[r["device"] for r in ranks],
        local_m=[r["local_m"] for r in ranks],
        coords=[r["coord"] for r in ranks], held=held,
        counter_flips_vs_plain=flips,
        batch_ms_rank0=ms0, serve_phase_ms=fresh_ms[:4],
        peak_mb=[round(r["peak_mb"], 1) for r in ranks],
        setup_s=[round(r["setup_s"], 2) for r in ranks],
        stage_s=round(stage_s, 3), ranks_s=round(ranks_s, 2),
        launches=launches, **cli,
        seconds=round(time.perf_counter() - t_phase, 2))
    return {"launches": launches}


# ---------------------------------------------------------------------------
# encoder: the SPLADE encoder's forward pass at its published widths
# ---------------------------------------------------------------------------

ENC_SEED = SEED + 30
ENC_SEQ = 64
ENC_QUERIES = 64
ENC_DOC_BATCH = 128
ENC_DOC_BATCHES = 64
ENC_T_PAD = 32


def encoder_tokens(rng, vocab: int, batch: int, seq: int, ragged: bool):
    """examples/train_sparse_encoder.py's synthetic text, drawn with numpy:
    the first half of each row from a topic's 32 tokens, the rest noise;
    with ``ragged`` half the rows are cut short (at least 8 tokens)."""
    topic = rng.integers(0, vocab // 64, (batch, 1))
    base = topic * 64 + rng.integers(0, 32, (batch, seq))
    noise = rng.integers(0, vocab, (batch, seq))
    toks = np.where(np.arange(seq) < seq // 2, base, noise)
    lens = np.full(batch, seq)
    if ragged:
        lens[batch // 2:] = rng.integers(8, seq, batch - batch // 2)
    return toks.astype(np.int64), np.arange(seq)[None, :] < lens[:, None]


def phase_encoder(engine, index, torch) -> dict:
    """``SparseEncConfig()`` at its published widths with random weights
    from a seeded generator: encode on the card against the same weights
    on the CPU, ``to_sparse_docs`` on both, the encoded queries served by
    the serve phase's engine against the on-card plain path; encode timed
    at batch 64 and 128 and over 64 doc batches."""
    from repro_torch.core.search import retrieve
    from repro_torch.core.types import QueryBatch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.sparse_encoder import (SparseEncConfig, encode,
                                                   init_params,
                                                   to_sparse_docs)
    from repro_torch.tools.plain_path import plain_versions, swapped_wrappers

    t_phase = time.perf_counter()
    cfg = SparseEncConfig()
    if cfg.vocab != index.vocab:
        raise AssertionError(f"encoder: vocab {cfg.vocab} is not the "
                             f"index's {index.vocab}")
    t0 = time.perf_counter()
    model = init_params(torch.Generator().manual_seed(ENC_SEED), cfg,
                        device=DEVICE)
    on_cpu = init_params(torch.Generator().manual_seed(ENC_SEED), cfg,
                         device="cpu")
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(ENC_SEED)
    qt, qm = (torch.from_numpy(a) for a in encoder_tokens(
        rng, cfg.vocab, ENC_QUERIES, ENC_SEQ, ragged=True))
    errs = {}
    with torch.no_grad():
        got = encode(model, qt, qm)
        want = encode(on_cpu, qt, qm)
        # the same weights in float64 on the CPU: how far each device's
        # fp32 sits from exact, beside how far the two sit apart
        on_cpu = on_cpu.double()                # in place: last use
        exact = encode(on_cpu, qt, qm)
        for key in ("sparse", "dense_max", "token_emb"):
            live = exact[key] > -1e29
            errs[key] = {
                "card_vs_cpu": float((got[key].cpu() - want[key]).abs().max()),
                **{f"{what}_vs_f64": float(
                    (out.cpu().double() - exact[key])[live].abs().max())
                   for what, out in (("card", got[key]),
                                     ("cpu", want[key]))}}
        del exact
        for key in ("sparse", "dense_max"):
            if not torch.allclose(got[key].cpu(), want[key], rtol=1e-4,
                                  atol=1e-5):
                raise AssertionError(f"encoder: {key} on the card differs "
                                     f"from the CPU: {errs[key]}")
        card_q = to_sparse_docs(got["sparse"], ENC_T_PAD, cfg.vocab)
        cpu_q = to_sparse_docs(want["sparse"], ENC_T_PAD, cfg.vocab)
        if not torch.allclose(card_q.tw.cpu(), cpu_q.tw, rtol=1e-4,
                              atol=1e-5):
            raise AssertionError("encoder: to_sparse_docs weights differ")
        # an id may differ only where the card's term weighs, on the CPU,
        # what the CPU's term at that slot weighs: a near tie
        g_ids = card_q.tids.cpu().long()
        swaps = (g_ids != cpu_q.tids).nonzero().tolist()
        for r, c in swaps:
            a = float(want["sparse"][r, g_ids[r, c]])
            b = float(cpu_q.tw[r, c])
            if abs(a - b) > 1e-4 * abs(b) + 1e-5:
                raise AssertionError(f"encoder: query {r} slot {c}: ids "
                                     f"differ beyond a near tie")
    queries = QueryBatch(tids=card_q.tids, tw=card_q.tw, mask=card_q.mask,
                         vocab=cfg.vocab)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    served = engine.search(queries)
    serve_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    with swapped_wrappers(plain_versions):
        plain = retrieve(index, queries, engine.cfg, device=DEVICE)
    check_close(served, plain, "encoder: encoded queries, kernel vs plain")
    missing = [k for k in ("segment_bound_gemm", "plan_wave", "score_queue")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"encoder: the served batch launched no "
                             f"{missing}")

    qt_d, qm_d = qt.to(DEVICE), qm.to(DEVICE)
    docs = [tuple(torch.from_numpy(a).to(DEVICE) for a in encoder_tokens(
        rng, cfg.vocab, ENC_DOC_BATCH, ENC_SEQ, ragged=False))
        for _ in range(ENC_DOC_BATCHES)]
    with torch.no_grad():
        q_ms = time_ms(lambda: encode(model, qt_d, qm_d))
        d_ms = time_ms(lambda: encode(model, *docs[0]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for d in docs:
            encode(model, *d)
        torch.cuda.synchronize()
        docs_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log("encoder", params=model.n_params(), vocab=cfg.vocab,
        d_model=cfg.d_model, layers=cfg.n_layers, heads=cfg.n_heads,
        d_ff=cfg.d_ff, seq=ENC_SEQ, init_s=round(init_s, 3),
        short_rows=int((~qm.all(1)).sum()), max_abs_err=errs,
        id_swaps=len(swaps),
        mean_query_terms=float(card_q.mask.sum(1).float().mean()),
        encode_ms_batch64=round(q_ms, 4),
        encode_ms_batch128=round(d_ms, 4),
        doc_batches=ENC_DOC_BATCHES, docs_per_s=round(
            ENC_DOC_BATCHES * ENC_DOC_BATCH / docs_s, 1),
        peak_mb=round(peak / 1e6, 1), serve_ms=round(serve_ms, 3),
        served_clusters_mean=float(served.n_scored_clusters.float().mean()),
        launches=launches, seconds=round(time.perf_counter() - t_phase, 2))
    return {"launches": launches}


# ---------------------------------------------------------------------------
# train_encoder: the encoder's train -> index -> serve pipeline
# ---------------------------------------------------------------------------

TE_STEPS = 300              # the example's default run (batch 24 x 64)
TE_RESUME_AT = 150          # the interrupted run stops after this many
TE_CHECK_BATCH = 8          # card against CPU: 2 steps at this batch
TE_CHECK_STEPS = 2


def step_state(model, loss_fn, opt, tcfg, batches) -> tuple:
    """``make_train_step`` over ``batches`` from a fresh optimizer state:
    (each step's metrics as floats, the final state)."""
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.training.tree import module_tree
    step = make_train_step(loss_fn, opt, tcfg)
    state = opt.init(module_tree(model))
    out = []
    for i, b in enumerate(batches):
        model, state, m = step(model, state, b, i)
        out.append({k: float(v) for k, v in m.items()})
    return out, state


def card_vs_cpu(on_cpu, on_card, loss_fn, opt, tcfg, batches, lr_sum,
                what: str, torch, cancel_floor: float = 0.0) -> dict:
    """The same steps on the CPU and on the card (fp32, TF32 off), from
    the same weights: loss and grad norm each step to rtol 1e-4, the first
    moment (0.1 x the clipped gradient, summed over steps) per tensor to
    rtol 1e-3 and atol 1e-3 x its largest entry (the embedding's
    gradient sums the gathered rows' and the tied head's terms in each
    device's own order, atomics on the card, and cancels near zero: 1.1e-4
    of the largest entry was seen), the parameters to atol 2 x the steps'
    learning rates summed (a first AdamW step moves a weight by about
    lr x sign(g); rounding can tip it where g is near zero). Returns the
    largest differences.

    ``cancel_floor`` > 0: a tensor whose largest first-moment entry on
    the CPU is below ``cancel_floor`` x the model's largest is a gradient
    that is zero in exact arithmetic (DIN's attention logits go through a
    softmax, which ignores a shift, so the attention MLP's output bias
    gets none: 7.3e-12 on the CPU against 0 on the card was seen). Its
    per-tensor scale is rounding noise, so for it both devices must stay
    within ``cancel_floor`` x the model's largest entry of zero."""
    from repro_torch.training.tree import leaves
    t0 = time.perf_counter()
    m_cpu, s_cpu = step_state(on_cpu, loss_fn, opt, tcfg, batches)
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_card, s_card = step_state(on_card, loss_fn, opt, tcfg, batches)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    for i, (a, c) in enumerate(zip(m_card, m_cpu)):
        for k in ("loss", "grad_norm"):
            if not math.isclose(a[k], c[k], rel_tol=1e-4):
                raise AssertionError(f"{what}: step {i} {k} on the card "
                                     f"{a[k]} against {c[k]} on the CPU")
    mu_rel = 0.0
    cancelled = []
    floor = cancel_floor * max(float(c.abs().max())
                               for c in leaves(s_cpu["mu"]))
    for i, (a, c) in enumerate(zip(leaves(s_card["mu"]),
                                   leaves(s_cpu["mu"]))):
        a, top = a.cpu(), float(c.abs().max())
        if top < floor:
            if float(a.abs().max()) > floor:
                raise AssertionError(f"{what}: first moment {i} is zero on "
                                     f"the CPU, not on the card")
            cancelled.append(i)
            continue
        if not torch.allclose(a, c, rtol=1e-3, atol=1e-3 * top):
            raise AssertionError(f"{what}: first moment {i} differs")
        mu_rel = max(mu_rel, float((a - c).abs().max()) / max(top, 1e-30))
    p_err = 0.0
    for a, c in zip(on_card.parameters(), on_cpu.parameters()):
        d = float((a.detach().cpu() - c.detach()).abs().max())
        if d > 2 * lr_sum + 1e-7:
            raise AssertionError(f"{what}: a parameter moved {d} apart")
        p_err = max(p_err, d)
    return dict(loss=[round(m["loss"], 6) for m in m_card],
                loss_rel_err=max(abs(a["loss"] - c["loss"]) / abs(c["loss"])
                                 for a, c in zip(m_card, m_cpu)),
                grad_norm=[round(m["grad_norm"], 6) for m in m_card],
                grad_norm_rel_err=max(
                    abs(a["grad_norm"] - c["grad_norm"]) / c["grad_norm"]
                    for a, c in zip(m_card, m_cpu)),
                mu_err_of_max=mu_rel, param_max_abs_err=p_err,
                **({"cancelled_leaves": cancelled} if cancel_floor else {}),
                param_atol=2 * lr_sum + 1e-7, cpu_s=round(cpu_s, 2),
                card_s=round(card_s, 2))


@contextlib.contextmanager
def deterministic(torch):
    """Deterministic algorithms on (the embedding's backward accumulates
    by atomics otherwise); ``CUBLAS_WORKSPACE_CONFIG`` is set in main.
    Fresh tensors are not filled with NaN (a debugging aid of that mode,
    one more kernel an allocation; it changes no result)."""
    import torch.utils.deterministic as det
    fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        det.fill_uninitialized_memory = fill


def phase_train_encoder(torch) -> dict:
    """The example ``repro_torch.examples.train_sparse_encoder`` at its
    default flags, stage by stage, on the card: 2 steps against the CPU;
    under deterministic algorithms the 300-step fit, timed, and a fit
    stopped at step 150 then resumed to 300, which must equal it bit for
    bit; a checkpoint's save; then the learned index and 16 encoded
    queries through asc_retrieve, counted and held against the plain path
    and (safe mode) brute force."""
    import copy
    import tempfile

    from repro_torch.core.search import asc_retrieve, brute_force_topk
    from repro_torch.examples import train_sparse_encoder as ex
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.sparse_encoder import (contrastive_loss,
                                                   init_params)
    from repro_torch.tools.plain_path import plain_versions, swapped_wrappers
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.tree import module_tree

    t_phase = time.perf_counter()
    cfg, steps, batch, seq = ex.setup(small=False, steps=TE_STEPS)
    opt = ex.make_optimizer(steps)
    sched = ex.schedule(steps)
    lr_sum = sum(float(sched(i)) for i in range(TE_CHECK_STEPS))
    on_cpu = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    check = card_vs_cpu(
        on_cpu, copy.deepcopy(on_cpu).to(DEVICE), contrastive_loss, opt,
        ex.train_config(steps),
        [ex.synth_pairs(cfg.vocab, seq, TE_CHECK_BATCH, s)
         for s in range(TE_CHECK_STEPS)], lr_sum, "train_encoder", torch)
    del on_cpu

    with tempfile.TemporaryDirectory() as tmp, deterministic(torch):
        # the example's run, fit(300) with its checkpoint cadence, timed;
        # under deterministic algorithms it is also the uninterrupted run
        # the resumed one must equal
        lines: list[str] = []
        model = init_params(torch.Generator().manual_seed(0), cfg,
                            device=DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hist = ex.train(model, steps, batch, seq, os.path.join(tmp, "run"),
                        log_fn=lines.append)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_peak = torch.cuda.max_memory_allocated()
        if not hist[-1]["loss"] < hist[0]["loss"]:
            raise AssertionError(f"train_encoder: the loss did not fall: "
                                 f"{lines}")
        span = hist[-1]["step"] - hist[1]["step"]
        step_ms = (hist[-1]["elapsed_s"] - hist[1]["elapsed_s"]) / span * 1e3

        # resume: 150 steps, then a fit to 300 on the same directory
        resumed_lines: list[str] = []
        part = init_params(torch.Generator().manual_seed(0), cfg,
                           device=DEVICE)
        rdir = os.path.join(tmp, "resume")
        ex.train(part, steps, batch, seq, rdir, run_steps=TE_RESUME_AT,
                 log_fn=resumed_lines.append)
        part = init_params(torch.Generator().manual_seed(0), cfg,
                           device=DEVICE)
        ex.train(part, steps, batch, seq, rdir, log_fn=resumed_lines.append)
        if f"[fit] resumed from step {TE_RESUME_AT - 1}" not in resumed_lines:
            raise AssertionError("train_encoder: the second fit did not "
                                 "resume")
        differ = [n for (n, a), b in zip(model.named_parameters(),
                                         part.parameters())
                  if not torch.equal(a, b)]
        if differ:
            raise AssertionError(f"train_encoder: the resumed run differs "
                                 f"from the uninterrupted one in {differ}")
        del part

        # a checkpoint of the trained state: the host copy an async save
        # makes on the training path, then a whole synchronous save
        tree = {"step": steps - 1, "params": model,
                "opt_state": opt.init(module_tree(model))}
        mgr = CheckpointManager(os.path.join(tmp, "save"))
        t0 = time.perf_counter()
        mgr.save(steps - 1, tree, async_save=True)
        snapshot_ms = (time.perf_counter() - t0) * 1e3
        mgr.wait()
        t0 = time.perf_counter()
        mgr.save(steps, tree)
        save_ms = (time.perf_counter() - t0) * 1e3
        ckpt_mb = _dir_mb(os.path.join(tmp, "save", f"step_{steps:010d}"))
        del tree

    # the pipeline on the card, on the timed run's weights
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sparse_mat, dense_mat = ex.encode_corpus(model, seq)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = ex.learned_index(sparse_mat, dense_mat, cfg.vocab, DEVICE)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    queries = ex.encode_queries(model, seq)
    kw = dict(k=10, mu=0.9, eta=1.0, bounds_impl="gemm", device=DEVICE)
    asc_retrieve(index, queries, **kw)                      # warm
    torch.cuda.synchronize()
    k_log, p_log = [], []
    reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_decisions(k_log):
        out = asc_retrieve(index, queries, **kw)
    serve_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    missing = [k for k in ("segment_bound_gemm", "plan_wave", "score_queue")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"train_encoder: asc_retrieve launched no "
                             f"{missing}")
    with swapped_wrappers(plain_versions), recorded_decisions(p_log):
        plain = asc_retrieve(index, queries, **kw)
    rows = [[(0, i)] if k_log else [] for i in range(out.doc_ids.shape[0])]
    flips = check_audited(out, plain, k_log, p_log, rows,
                          "train_encoder: learned index, kernel vs plain")
    oracle = brute_force_topk(index, queries, 10, device=DEVICE)
    safe = asc_retrieve(index, queries, **{**kw, "mu": 1.0})
    check_topk(oracle.doc_ids.cpu(), oracle.scores.cpu(),
               safe.doc_ids.cpu(), safe.scores.cpu(),
               "train_encoder: safe mode vs brute force (16 queries)")
    log("train_encoder", params=model.n_params(), vocab=cfg.vocab,
        d_model=cfg.d_model, layers=cfg.n_layers, steps=steps, batch=batch,
        seq=seq, card_vs_cpu=check,
        loss_first=hist[0]["loss"], loss_last=hist[-1]["loss"],
        train_s=round(train_s, 3), step_ms=round(step_ms, 3),
        timed_under="torch.use_deterministic_algorithms(True)",
        pairs_per_s=round(batch / step_ms * 1e3, 1),
        train_peak_mb=round(train_peak / 1e6, 1),
        fit_lines=len(lines), resumed_equal=True,
        resume_at=TE_RESUME_AT,
        checkpoint=dict(mb=round(ckpt_mb, 2),
                        async_host_copy_ms=round(snapshot_ms, 2),
                        save_ms=round(save_ms, 2)),
        encode_s=round(encode_s, 3), index_s=round(index_s, 3),
        index_mb=round(index.nbytes() / 2**20, 2),
        recall_at_10=ex.recall_at(out, oracle),
        pct_clusters=float(out.n_scored_clusters.float().mean())
        / ex.M_CLUSTERS * 100, serve_ms=round(serve_ms, 3),
        counter_flips=flips, launches=launches,
        seconds=round(time.perf_counter() - t_phase, 2))
    return {"launches": launches}


# ---------------------------------------------------------------------------
# train_lm: OLMo-1B at its published widths
# ---------------------------------------------------------------------------

LM_ARCH = "olmo-1b"
LM_CHECK_DEPTH = 2          # card against CPU at full widths, this depth
LM_CHECK_BATCH, LM_CHECK_SEQ = 2, 128
LM_CHECK_LR = 3e-4
LM_MEMO_STEPS = 10          # then this many more on the same batch
LM_MEMO_DROP = 1.0          # by which the loss must fall (nats)
LM_STEPS, LM_BATCH, LM_SEQ = 10, 8, 512
LM_CHANCE_BAND = 0.1        # the launcher's losses within this of ln V
BF16_FLOP_S = 989e12        # H100 SXM dense bf16 peak (NVIDIA data sheet)


def phase_train_lm(torch) -> dict:
    """OLMo-1B: one step at depth 2 with the full widths (fp32) on the card
    against the CPU, and 10 more on the same batch, over which the loss
    must fall by a nat (the reference smoke test's criterion: it descends
    on a repeated batch); then the training launcher at full width and
    depth (bf16 compute on fp32 masters, remat) as a subprocess: exit 0,
    ten finite losses within 0.1 of ln V. The launcher's synthetic stream
    (the reference's ``lm_batch``) is uniform at three of four positions
    and its bigram rule needs each of 50,304 tokens seen many times, so
    ten steps of 4,096 tokens leave the loss at chance, ln 50304 = 10.826.
    Step ms, tokens/s, MFU against the bf16 peak, peak memory."""
    import copy
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import LMDataSpec, lm_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as tf
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.train_loop import TrainConfig

    t_phase = time.perf_counter()
    full = get_arch(LM_ARCH).config()
    cfg = dataclasses.replace(full, n_layers=LM_CHECK_DEPTH, dtype="float32")
    t0 = time.perf_counter()
    on_cpu = tf.init_params(torch.Generator().manual_seed(5), cfg,
                            device="cpu")
    init_s = time.perf_counter() - t0
    b = {k: v[:, :LM_CHECK_SEQ] for k, v in lm_batch(
        LMDataSpec(cfg.vocab, LM_CHECK_SEQ + 1, LM_CHECK_BATCH), 0).items()}
    on_card = copy.deepcopy(on_cpu).to(DEVICE)
    adam = opt_lib.adamw(opt_lib.constant_schedule(LM_CHECK_LR))
    reset_launch_counts()
    check = card_vs_cpu(on_cpu, on_card, tf.loss_fn, adam, TrainConfig(),
                        [b], LM_CHECK_LR, "train_lm", torch)
    check.update(params=on_cpu.n_params(), init_s=round(init_s, 2))
    del on_cpu
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    memo, _ = step_state(on_card, tf.loss_fn, adam, TrainConfig(),
                         [b] * LM_MEMO_STEPS)
    torch.cuda.synchronize()
    memo_ms = (time.perf_counter() - t0) / LM_MEMO_STEPS * 1e3
    launches = launch_counts()
    memo_loss = [round(m["loss"], 4) for m in memo]
    if not memo_loss[-1] < memo_loss[0] - LM_MEMO_DROP:
        raise AssertionError(f"train_lm: the loss did not fall on a "
                             f"repeated batch: {memo_loss}")
    del on_card
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        metrics = os.path.join(tmp, "train.json")
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               LM_ARCH, "--preset", "full", "--steps", str(LM_STEPS),
               "--batch", str(LM_BATCH), "--seq", str(LM_SEQ),
               "--metrics-json", metrics]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              cwd=ROOT, timeout=600,
                              env={**os.environ, "PYTHONPATH": str(SRC)})
        run_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"train_lm: the launcher exited "
                                 f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        with open(metrics) as f:
            m = json.load(f)
    out = proc.stdout.splitlines()
    if not out or not out[-1].startswith("[train] done: loss"):
        raise AssertionError(f"train_lm: no done line: {out[-3:]}")
    hist = m["history"]
    chance = math.log(full.vocab)
    if len(hist) != LM_STEPS or not all(
            abs(h["loss"] - chance) < LM_CHANCE_BAND for h in hist):
        raise AssertionError(f"train_lm: the launcher's losses are not "
                             f"{LM_STEPS} finite values near ln V = "
                             f"{chance:.4f}: {out}")
    # every step is logged (log_every 1), and logging reads the loss back,
    # so consecutive elapsed times are whole steps; steps 0-1 warm up
    step_s = sorted(b["elapsed_s"] - a["elapsed_s"]
                    for a, b in zip(hist[1:], hist[2:]))
    median_s = step_s[len(step_s) // 2]
    tokens = m["tokens_per_step"]
    flops = 6.0 * m["param_count"] * tokens
    log("train_lm", arch=LM_ARCH, card_vs_cpu=check,
        repeated_batch=dict(losses=memo_loss, step_ms=round(memo_ms, 2)),
        check_shape=dict(layers=cfg.n_layers, d_model=cfg.d_model,
                         d_ff=cfg.d_ff, vocab=cfg.vocab,
                         batch=LM_CHECK_BATCH, seq=LM_CHECK_SEQ),
        launcher=" ".join(cmd[1:]), launcher_s=round(run_s, 2),
        params=m["n_params"], param_count=m["param_count"],
        layers=full.n_layers, d_model=full.d_model, d_ff=full.d_ff,
        vocab=full.vocab, dtype=full.dtype, remat=full.remat,
        tokens_per_step=tokens, losses=[round(h["loss"], 4) for h in hist],
        ln_vocab=round(chance, 4),
        loss_fell=hist[-1]["loss"] < hist[0]["loss"],
        step_ms_median=round(median_s * 1e3, 2),
        step_ms=[round(x * 1e3, 2) for x in step_s],
        tokens_per_s=round(tokens / median_s, 1),
        model_flops_per_step=flops,
        mfu=round(flops / median_s / BF16_FLOP_S, 4),
        mfu_peak="989 TFLOP/s dense bf16 (H100 SXM data sheet)",
        peak_memory_mb=round(m["peak_memory_bytes"] / 1e6, 1),
        launches=launches, seconds=round(time.perf_counter() - t_phase, 2))
    return {"launches": launches, "summary": dict(
        losses=[h["loss"] for h in hist],
        step_ms_median=round(median_s * 1e3, 2),
        tokens_per_s=round(tokens / median_s, 1),
        mfu=round(flops / median_s / BF16_FLOP_S, 4),
        peak_memory_mb=round(m["peak_memory_bytes"] / 1e6, 1))}


# ---------------------------------------------------------------------------
# recsys_asc: BERT4Rec's published catalog served through ASC
# ---------------------------------------------------------------------------

RA_M = 512                  # about 1,953 items a cluster (MS MARCO: 2,148)
RA_D_PAD = 5120             # the example's 2.5x headroom, rounded up to 512
RA_BATCHES = 4              # 64-user batches (K1, the planner, K2)
RA_SMALL = 3                # 2-user batches (the per-query route: K1, K4)
RA_SEED = SEED + 40


def catalog_kernel_times(calls: list, torch) -> dict:
    """Each kernel's first recorded call on the catalog path (K1's first
    at each batch size) timed against its plain version on the same
    inputs, with the shapes the catalog gives it."""
    from repro_torch.tools.plain_path import plain_versions
    first: dict = {}
    for name, fn, a, kw in calls:
        key = (f"{name} Q={a[1].n_queries}" if name == "segment_bound_gemm"
               else name)
        first.setdefault(key, (name, fn, a, kw))
    out = {}
    for key, (name, fn, a, kw) in sorted(first.items()):
        plain = plain_versions(name, fn)
        row = dict(ms=time_ms(lambda: fn(*a, **kw)),
                   plain_ms=time_ms(lambda: plain(*a, **kw)))
        if name == "segment_bound_gemm":
            table, terms = a[0], a[1]
            row["shape"] = dict(S=table.shape[0], V=table.shape[1],
                                Q=terms.n_queries, q_pad=terms.q_pad,
                                nnz=int(terms.count.sum()))
        elif name == "score_admitted":
            terms, plan = a[4], a[5]
            row["shape"] = dict(
                n_q=terms.n_queries, G=plan.cids.shape[0], n_qb=plan.n_qb,
                n_db=plan.n_db, block_q=plan.block_q, block_d=plan.block_d,
                union_terms=terms.n_union.tolist(),
                entries=terms.term_ptr[:, -1].tolist(),
                n_words=terms.n_words, walked_docs=int(plan.walked_docs()))
        elif name == "plan_wave_kernel":
            row["shape"] = dict(n_q=a[2].shape[0], G=a[0].shape[0],
                                n_seg=a[3].shape[-1], block_q=a[4],
                                block_d=a[7])
        elif name == "merge_topk":
            row["shape"] = dict(n_q=a[2].shape[0], wave=a[2][0].numel(),
                                k=a[5])
        else:
            row["shape"] = dict(G=a[4].shape[0], d_pad=a[0].shape[1],
                                t_pad=a[0].shape[2],
                                q_terms=int(a[6].count[a[7]]))
        out[key] = row
    return out


def phase_recsys_asc(torch) -> dict:
    """``repro_torch.examples.bert4rec_asc_retrieval`` at BERT4Rec's
    published config (10^6 items, embed_dim 64, seeded random weights):
    the catalog index (m = 512, d_pad = 5,120, 4 segments) built on the
    card and timed by step; then, counts zeroed, the example's ``serve``
    on 4 batches of 64 users and 3 of 2 (``bert4rec_batch`` at seq 200),
    ASC at mu 1.0 and 0.9 beside brute force and the dense dot product.
    Every kernel of the main path must launch; every ASC result equals
    the on-card plain path (``check_audited``) and rank-safe ASC equals
    brute force. A warm-up batch of each size is held kernel by kernel
    against the plain versions and each kernel is timed at the catalog's
    shapes."""
    from repro_torch.configs import get_arch
    from repro_torch.core.search import asc_retrieve
    from repro_torch.data.pipeline import bert4rec_batch
    from repro_torch.examples import bert4rec_asc_retrieval as ex
    from repro_torch.kernels import (MAIN_PATH, launch_counts,
                                     reset_launch_counts)
    from repro_torch.models.recsys import bert4rec_init
    from repro_torch.tools.plain_path import plain_versions, swapped_wrappers

    t_phase = time.perf_counter()
    cfg = get_arch("bert4rec").config()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = bert4rec_init(torch.Generator(device=DEVICE).manual_seed(RA_SEED),
                          cfg, device=DEVICE)
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3
    build: dict = {}
    index = ex.build_catalog_index(cfg, model, RA_M, RA_D_PAD,
                                   torch.Generator().manual_seed(RA_SEED + 1),
                                   DEVICE, timings=build)
    build_peak = torch.cuda.max_memory_allocated()
    item_emb = ex.item_embeddings(model)
    placed = int(index.doc_mask.sum())
    if placed != cfg.n_items or int(index.cluster_ndocs.max()) > RA_D_PAD:
        raise AssertionError(f"recsys_asc: {placed} items placed of "
                             f"{cfg.n_items}, or a cluster over d_pad")
    batches = ([(f"users64_{i}", bert4rec_batch(cfg, 64, i, seed=RA_SEED))
                for i in range(RA_BATCHES)]
               + [(f"users2_{i}", bert4rec_batch(cfg, 2, 100 + i,
                                                 seed=RA_SEED))
                  for i in range(RA_SMALL)])

    def serve_all(which, record=False):
        out = []
        for name, b in which:
            hidden, queries = ex.encode_users(model, b)
            log_k: list = []
            lines: list = []
            with (recorded_decisions(log_k) if record else
                  contextlib.nullcontext()):
                res = ex.serve(index, queries, hidden, item_emb, DEVICE,
                               log=lines.append)
            out.append((name, hidden, queries, res, log_k, lines))
        return out

    # warm-up, not counted: one batch of each size, every kernel call held
    # against its plain version and recorded for the timings
    calls: list = []
    held = hold_kernels(lambda: serve_all([batches[0], batches[-1]]), torch,
                        calls)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    runs = serve_all(batches, record=True)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = launch_counts()
    missing = [k for k in MAIN_PATH if launches[k] == 0]
    if missing:
        raise AssertionError(f"recsys_asc: kernels never launched on the "
                             f"catalog path: {missing}")

    flips, per_batch = [], []
    for name, hidden, queries, res, k_log, lines in runs:
        n_q = queries.n_queries
        if n_q >= 4 and len(k_log) != len(ex.MUS):
            raise AssertionError(f"recsys_asc {name}: {len(k_log)} walks "
                                 f"recorded for {len(ex.MUS)} searches")
        row = {"batch": name, "n_q": n_q}
        for j, mu in enumerate(ex.MUS):
            got = res["asc"][mu]
            if not (bool(torch.isfinite(got.scores).all())
                    and bool((got.doc_ids >= 0).all())):
                raise AssertionError(f"recsys_asc {name} mu={mu}: "
                                     f"non-finite scores or missing ids")
            p_log: list = []
            with swapped_wrappers(plain_versions), \
                    recorded_decisions(p_log):
                plain = asc_retrieve(index, queries, k=ex.K, mu=mu, eta=1.0,
                                     bounds_impl="gemm", device=DEVICE)
            kl = [k_log[j]] if k_log else []
            rows = [[(0, i)] if kl else [] for i in range(n_q)]
            flips += check_audited(got, plain, kl, p_log, rows,
                                   f"recsys_asc {name} mu={mu}: kernel "
                                   f"vs plain")
            # the batch's time alone (warm), beside what it scored
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            asc_retrieve(index, queries, k=ex.K, mu=mu, eta=1.0,
                         bounds_impl="gemm", device=DEVICE)
            torch.cuda.synchronize()
            row[f"mu{mu}"] = dict(
                ms=round((time.perf_counter() - t0) * 1e3, 3),
                clusters_a_query=float(got.n_scored_clusters.float()
                                       .mean()),
                items_a_query=float(got.n_scored_docs.float().mean()),
                recall_vs_index=res["recall"][mu][0],
                recall_vs_dense=res["recall"][mu][1])
        oracle, safe = res["oracle"], res["asc"][1.0]
        check_topk(oracle.doc_ids.cpu(), oracle.scores.cpu(),
                   safe.doc_ids.cpu(), safe.scores.cpu(),
                   f"recsys_asc {name}: mu = eta = 1 vs brute force")
        per_batch.append(row)
    big = [r for r in per_batch if r["n_q"] == 64]

    def mean(key, mu):
        return float(np.mean([r[f"mu{mu}"][key] for r in big]))

    kernels = catalog_kernel_times(calls, torch)
    log("recsys_asc", items=cfg.n_items, embed_dim=cfg.embed_dim,
        vocab=index.vocab, t_pad=index.t_pad, m=index.m, d_pad=index.d_pad,
        n_seg=index.n_seg, seg_max_shape=list(index.seg_max_stacked.shape),
        index_mb=round(index.nbytes() / 1e6, 1),
        init_ms=round(init_ms, 2),
        build_ms={k: round(v, 2) for k, v in build.items()},
        build_peak_mb=round(build_peak / 1e6, 1),
        items_a_cluster=float(index.cluster_ndocs.float().mean()),
        max_cluster=int(index.cluster_ndocs.max()),
        min_cluster=int(index.cluster_ndocs.min()),
        mean_query_terms=float(runs[0][2].mask.sum(1).float().mean()),
        serve_s=round(serve_s, 3), batches=per_batch,
        summary={f"mu{mu}": dict(
            batch64_ms=mean("ms", mu),
            clusters_a_query=mean("clusters_a_query", mu),
            items_a_query=mean("items_a_query", mu),
            recall_vs_index=mean("recall_vs_index", mu),
            recall_vs_dense=mean("recall_vs_dense", mu))
            for mu in ex.MUS},
        counter_flips=flips, held=held, kernels=kernels, launches=launches,
        seconds=round(time.perf_counter() - t_phase, 2))
    return {"launches": launches, "kernels": kernels}


# ---------------------------------------------------------------------------
# recsys: the four archs at their published configs
# ---------------------------------------------------------------------------

RS_BATCH = 2048             # examples a forward pass
RS_CANDIDATES = 65_536      # the retrieval_cand block
RS_CHECK_BATCH = 16         # card against CPU at the smoke config
RS_SEED = SEED + 50
RS_BATCH_FNS = {"dlrm-mlperf": "dlrm_batch", "din": "din_batch",
                "deepfm": "deepfm_batch", "bert4rec": "bert4rec_batch"}


def rs_retrieval_batch(arch: str, cfg, n_cand: int, seed: int, torch):
    """One user's context (batch row 0 of the arch's batch maker) and a
    block of ``n_cand`` random candidates (CPU tensors)."""
    from repro_torch.data import pipeline as pl
    b = getattr(pl, RS_BATCH_FNS[arch])(cfg, 1, 0, seed=seed)
    g = torch.Generator().manual_seed(seed)
    if arch == "din":
        return {**{k: b[k] for k in ("hist_items", "hist_cates",
                                     "hist_mask")},
                "cand_items": torch.randint(0, cfg.n_items, (n_cand,),
                                            generator=g),
                "cand_cates": torch.randint(0, cfg.n_cates, (n_cand,),
                                            generator=g)}
    if arch == "dlrm-mlperf":
        keep, rows = ("dense", "sparse"), cfg.vocab_per_table
    elif arch == "deepfm":
        keep, rows = ("fields",), cfg.vocab_per_field
    else:
        keep, rows = ("items", "mask"), cfg.n_items
    return {**{k: b[k] for k in keep},
            "cand_ids": torch.randint(0, rows, (n_cand,), generator=g)}


def rs_lookups(arch: str, cfg, n: int, retrieval: bool) -> int:
    """Embedding rows a call gathers: ``n`` examples (or candidates)."""
    if arch == "dlrm-mlperf":
        return n * cfg.n_sparse
    if arch == "din":
        return n * 2 * (cfg.seq_len + 1)
    if arch == "deepfm":
        return n * cfg.n_fields * 2          # the embedding and w1 rows
    return n + cfg.seq_len if retrieval else n * cfg.seq_len


def phase_recsys(torch) -> dict:
    """Each recsys arch: at its smoke config, the forward and a 256-
    candidate retrieval on the card against the CPU on the same weights
    (rtol 1e-4, atol 1e-5); at its published config, weights drawn on the
    card from a CUDA generator (DLRM's 26 x 4M x 128 table is 53.2 GB),
    a forward pass at batch 2,048 and ``*_retrieval`` against 65,536
    candidates, timed, with finite outputs of the right shapes. Reports
    ms, embedding lookups a second and peak memory."""
    import copy

    from repro_torch.configs import get_arch
    from repro_torch.data import pipeline as pl
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.recsys import RECSYS

    t_phase = time.perf_counter()
    reset_launch_counts()
    out = {}
    for i, (arch, (init, fwd, _, retrieval)) in enumerate(RECSYS.items()):
        mod = get_arch(arch)
        make = getattr(pl, RS_BATCH_FNS[arch])
        small = mod.smoke_config()
        on_cpu = init(torch.Generator().manual_seed(RS_SEED + i), small,
                      device="cpu")
        on_card = copy.deepcopy(on_cpu).to(DEVICE)
        b = make(small, RS_CHECK_BATCH, 0, seed=RS_SEED)
        rb = rs_retrieval_batch(arch, small, 256, RS_SEED, torch)
        errs = {}
        with torch.no_grad():
            for what, fn, batch in (("forward", fwd, b),
                                    ("retrieval", retrieval, rb)):
                got, want = fn(on_card, batch).cpu(), fn(on_cpu, batch)
                if not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
                    raise AssertionError(f"recsys {arch}: {what} on the "
                                         f"card differs from the CPU")
                errs[what] = float((got - want).abs().max())
        del on_cpu, on_card

        cfg = mod.config()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = init(torch.Generator(device=DEVICE).manual_seed(RS_SEED + i),
                     cfg, device=DEVICE)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        b = {k: v.to(DEVICE) for k, v in make(cfg, RS_BATCH, 0,
                                             seed=RS_SEED).items()}
        rb = {k: v.to(DEVICE) for k, v in rs_retrieval_batch(
            arch, cfg, RS_CANDIDATES, RS_SEED, torch).items()}
        with torch.no_grad():
            y = fwd(model, b)
            scores = retrieval(model, rb)
            want_y = ((RS_BATCH, cfg.seq_len, cfg.embed_dim)
                      if arch == "bert4rec" else (RS_BATCH,))
            if (tuple(y.shape) != want_y
                    or tuple(scores.shape) != (RS_CANDIDATES,)
                    or not bool(torch.isfinite(y).all())
                    or not bool(torch.isfinite(scores).all())):
                raise AssertionError(f"recsys {arch}: outputs of shape "
                                     f"{tuple(y.shape)}, "
                                     f"{tuple(scores.shape)} or not finite")
            fwd_ms = time_ms(lambda: fwd(model, b))
            ret_ms = time_ms(lambda: retrieval(model, rb))
        peak = torch.cuda.max_memory_allocated()
        out[arch] = dict(
            card_vs_cpu_smoke=errs, params=model.n_params(),
            table_gb=round(sum(p.numel() * 4 for n, p in
                               model.named_parameters()
                               if n in ("tables", "item_emb", "cate_emb",
                                        "emb", "w1")) / 1e9, 2),
            init_s=round(init_s, 3), batch=RS_BATCH,
            forward_ms=round(fwd_ms, 4),
            forward_lookups_per_s=round(
                rs_lookups(arch, cfg, RS_BATCH, False) / fwd_ms * 1e3),
            candidates=RS_CANDIDATES, retrieval_ms=round(ret_ms, 4),
            retrieval_lookups_per_s=round(
                rs_lookups(arch, cfg, RS_CANDIDATES, True) / ret_ms * 1e3),
            candidates_per_s=round(RS_CANDIDATES / ret_ms * 1e3),
            peak_memory_mb=round(peak / 1e6, 1))
        del model, b, rb, y, scores
        torch.cuda.empty_cache()
    launches = launch_counts()
    log("recsys", archs=out, launches=launches,
        seconds=round(time.perf_counter() - t_phase, 2))
    return {"launches": launches}


# ---------------------------------------------------------------------------
# train_recsys and train_gnn: the launcher's recsys and gnn branches
# ---------------------------------------------------------------------------

TR_STEPS = 10
TR_CHECK_LR = 3e-4
TR_CANCEL_FLOOR = 1e-6      # card_vs_cpu: gradients zero in exact arithmetic
# the launcher in a subprocess under deterministic algorithms (the resume
# must equal the uninterrupted run bit for bit); its flags follow
DET_LAUNCH = ("import sys, torch\n"
              "import torch.utils.deterministic as det\n"
              "torch.use_deterministic_algorithms(True)\n"
              "det.fill_uninitialized_memory = False\n"
              "from repro_torch.launch.train import main\n"
              "main(sys.argv[1:])\n")
TR_PRESETS = {"bert4rec": "full", "din": "full", "deepfm": "full",
              # at full width the 53.2 GB table and a dense gradient of the
              # same size pass 80 GB before AdamW's two moments
              "dlrm-mlperf": "smoke", "meshgraphnet": "full",
              # the full MoE presets need 110 GB and more with AdamW state
              "olmoe-1b-7b": "smoke", "llama4-scout-17b-a16e": "smoke"}


def _arrays(step_dir: str) -> list:
    with np.load(os.path.join(step_dir, "arrays.npz")) as z:
        return [z[f"a{i}"] for i in range(len(z.files))]


def launch_and_resume(arch: str, torch) -> dict:
    """``python -m repro_torch.launch.train`` for ``arch`` at its preset
    as a subprocess, 10 steps with a checkpoint directory (saves after
    steps 4 and 9): exit 0, ten finite losses and the done line. Then
    step 9's checkpoint is moved aside and the launcher, called again (in
    this process, deterministic algorithms on), resumes from step 4: its
    steps 5-9 print the first run's lines, and its step-9 checkpoint
    equals the first run's bit for bit."""
    import io
    import tempfile

    from repro_torch.launch import train as t_launch
    preset = TR_PRESETS[arch]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, metrics = os.path.join(tmp, "ckpt"), os.path.join(tmp, "m.json")
        argv = ["--arch", arch, "--preset", preset, "--steps", str(TR_STEPS),
                "--ckpt-dir", ckpt, "--device", DEVICE]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", DET_LAUNCH, *argv, "--metrics-json",
             metrics], capture_output=True, text=True, cwd=ROOT, timeout=600,
            env={**os.environ, "PYTHONPATH": str(SRC)})
        run_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"train {arch}: the launcher exited "
                                 f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        with open(metrics) as f:
            m = json.load(f)
        lines = proc.stdout.splitlines()
        hist = m["history"]
        if (len(hist) != TR_STEPS or not lines[-1].startswith(
                "[train] done: loss")
                or not all(math.isfinite(h["loss"]) for h in hist)):
            raise AssertionError(f"train {arch}: not {TR_STEPS} finite "
                                 f"losses and a done line: {lines[-3:]}")
        last = os.path.join(ckpt, f"step_{TR_STEPS - 1:010d}")
        first = os.path.join(tmp, "first")
        shutil.move(last, first)
        again = io.StringIO()
        t0 = time.perf_counter()
        with deterministic(torch), contextlib.redirect_stdout(again):
            t_launch.main(argv)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        again = again.getvalue().splitlines()
        if again[0] != "[fit] resumed from step 4" or again[1:-1] != \
                lines[5:-1]:
            raise AssertionError(f"train {arch}: the resumed run printed "
                                 f"{again} against {lines}")
        a, b = _arrays(first), _arrays(last)
        differ = [i for i, (x, y) in enumerate(zip(a, b, strict=True))
                  if x.dtype != y.dtype or x.tobytes() != y.tobytes()]
        if differ:
            raise AssertionError(f"train {arch}: the resumed checkpoint "
                                 f"differs from the uninterrupted one in "
                                 f"arrays {differ}")
        ckpt_mb = _dir_mb(first)
    steps = sorted(y["elapsed_s"] - x["elapsed_s"]
                   for x, y in zip(hist[1:], hist[2:]))
    median = steps[len(steps) // 2]
    return dict(preset=preset, launcher_s=round(run_s, 2),
                resume_s=round(resume_s, 2), resumed_equal=True,
                checkpoint_arrays=len(a), checkpoint_mb=round(ckpt_mb, 2),
                n_params=m["n_params"],
                losses=[round(h["loss"], 4) for h in hist],
                step_ms_median=round(median * 1e3, 3),
                per_step={k: v for k, v in m.items() if k.endswith(
                    "_per_step")},
                peak_memory_mb=round(m["peak_memory_bytes"] / 1e6, 1))


def phase_train_recsys(torch) -> dict:
    """The four recsys archs through the training launcher: two AdamW
    steps at the smoke config on the card against the CPU
    (``card_vs_cpu``), then ``launch_and_resume`` at ``TR_PRESETS``
    (DLRM at its smoke preset: at full width its table and a dense
    gradient of the same size pass 80 GB before AdamW's moments)."""
    import copy

    from repro_torch.configs import get_arch
    from repro_torch.data import pipeline as pl
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.recsys import RECSYS
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.train_loop import TrainConfig

    t_phase = time.perf_counter()
    reset_launch_counts()
    out = {}
    for i, (arch, (init, _, loss_fn, _)) in enumerate(RECSYS.items()):
        cfg = get_arch(arch).smoke_config()
        make = getattr(pl, RS_BATCH_FNS[arch])
        on_cpu = init(torch.Generator().manual_seed(RS_SEED + i), cfg,
                      device="cpu")
        check = card_vs_cpu(
            on_cpu, copy.deepcopy(on_cpu).to(DEVICE), loss_fn,
            opt_lib.adamw(opt_lib.constant_schedule(TR_CHECK_LR)),
            TrainConfig(), [make(cfg, RS_CHECK_BATCH, s) for s in range(2)],
            2 * TR_CHECK_LR, f"train_recsys {arch}", torch,
            cancel_floor=TR_CANCEL_FLOOR)
        out[arch] = {"card_vs_cpu_smoke": check,
                     **launch_and_resume(arch, torch)}
        torch.cuda.empty_cache()
    launches = launch_counts()
    log("train_recsys", archs=out, steps=TR_STEPS,
        dlrm_preset_note="smoke: at full width the 53.2 GB table plus a "
        "dense gradient of the same size exceed 80 GB before AdamW's "
        "moments", launches=launches,
        seconds=round(time.perf_counter() - t_phase, 2))
    return {"launches": launches}


GNN_SEEDS = 1024            # NeighborSampler: seeds a subgraph
GNN_FANOUT = (15, 10)
GNN_CSR_NODES = 1_000_000
GNN_CSR_DEGREE = 15


def phase_train_gnn(torch) -> dict:
    """MeshGraphNet (``configs/meshgraphnet.py``): two AdamW steps at the
    smoke config on the card against the CPU, ``launch_and_resume`` at the
    full preset (15 layers, d 128, the launcher's 256-node, 1,024-edge
    graphs), and one forward at full width on a ``NeighborSampler``
    subgraph (fanout 15, 10; 1,024 seeds over a 10^6-node CSR), timed,
    finite, with the sampler's slot geometry."""
    import copy

    from repro_torch.configs import get_arch
    from repro_torch.data import pipeline as pl
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import gnn
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.train_loop import TrainConfig

    t_phase = time.perf_counter()
    reset_launch_counts()
    small = get_arch("meshgraphnet").smoke_config()
    spec = pl.GraphSpec(256, 1024, small.node_in, small.edge_in,
                        small.node_out)
    on_cpu = gnn.init_params(torch.Generator().manual_seed(RS_SEED), small,
                             device="cpu")
    check = card_vs_cpu(
        on_cpu, copy.deepcopy(on_cpu).to(DEVICE), gnn.loss_fn,
        opt_lib.adamw(opt_lib.constant_schedule(TR_CHECK_LR)), TrainConfig(),
        [pl.random_graph(spec, s) for s in range(2)], 2 * TR_CHECK_LR,
        "train_gnn", torch, cancel_floor=TR_CANCEL_FLOOR)
    launched = launch_and_resume("meshgraphnet", torch)

    cfg = get_arch("meshgraphnet").config()
    t0 = time.perf_counter()
    indptr, indices = pl.NeighborSampler.random_csr(
        GNN_CSR_NODES, GNN_CSR_DEGREE, seed=RS_SEED)
    sampler = pl.NeighborSampler(indptr, indices, fanout=GNN_FANOUT,
                                 seed=RS_SEED)
    g = pl.sampled_subgraph_batch(sampler, GNN_SEEDS, cfg.node_in,
                                  cfg.edge_in, cfg.node_out, 0)
    sample_s = time.perf_counter() - t0
    n_nodes = GNN_SEEDS * (1 + GNN_FANOUT[0] + GNN_FANOUT[0] * GNN_FANOUT[1])
    if g["node_feat"].shape[0] != n_nodes:
        raise AssertionError(f"train_gnn: {g['node_feat'].shape[0]} node "
                             f"slots, expected {n_nodes}")
    model = gnn.init_params(torch.Generator().manual_seed(RS_SEED), cfg,
                            device=DEVICE)
    g = {k: v.to(DEVICE) for k, v in g.items()}
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        y = gnn.forward(model, g)
        if tuple(y.shape) != (n_nodes, cfg.node_out) or not bool(
                torch.isfinite(y).all()):
            raise AssertionError("train_gnn: the subgraph forward is not "
                                 "finite or has the wrong shape")
        fwd_ms = time_ms(lambda: gnn.forward(model, g))
    launches = launch_counts()
    log("train_gnn", card_vs_cpu_smoke=check, launcher=launched,
        subgraph=dict(csr_nodes=GNN_CSR_NODES, avg_degree=GNN_CSR_DEGREE,
                      seeds=GNN_SEEDS, fanout=list(GNN_FANOUT),
                      nodes=n_nodes, edges=int(g["senders"].numel()),
                      live_edges=int(g["edge_mask"].sum()),
                      sample_s=round(sample_s, 3),
                      forward_ms=round(fwd_ms, 3),
                      nodes_per_s=round(n_nodes / fwd_ms * 1e3),
                      peak_memory_mb=round(
                          torch.cuda.max_memory_allocated() / 1e6, 1)),
        layers=cfg.n_layers, d_hidden=cfg.d_hidden, params=model.n_params(),
        launches=launches, seconds=round(time.perf_counter() - t_phase, 2))
    return {"launches": launches}


# ---------------------------------------------------------------------------
# moe: the mixture-of-experts LMs served (prefill, decode)
# ---------------------------------------------------------------------------

MOE_ARCH, MOE_LLAMA = "olmoe-1b-7b", "llama4-scout-17b-a16e"
MOE_CHECK_DEPTH = 2          # card against CPU at full widths (fp32)
MOE_CHECK_BATCH, MOE_CHECK_SEQ = 2, 128
MOE_LLAMA_DEPTH = 4          # llama4-scout's 48 layers cut to this many
MOE_BATCH, MOE_SEQ, MOE_DECODE = 8, 512, 32
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 8, 512, 6
MOE_SEED = SEED + 60


@contextlib.contextmanager
def recorded_routing(log: list, probs: bool = True):
    """Record every MoE layer call: the experts ``moe.route`` chose (with
    ``probs``, its probabilities too), on the host, and the capacity and
    the share of picks the dispatch kept."""
    import repro_torch.models.moe as moe_mod
    route, dispatch = moe_mod.route, moe_mod.dispatch

    def rec_route(params, x, cfg):
        out = route(params, x, cfg)
        log.append({"idx": out[2].cpu(),
                    **({"probs": out[0].detach().cpu()} if probs else {})})
        return out

    def rec_dispatch(x, gates, idx, E, C):
        out = dispatch(x, gates, idx, E, C)
        log[-1].update(C=C, kept=float(out[1][3].float().mean()))
        return out

    moe_mod.route, moe_mod.dispatch = rec_route, rec_dispatch
    try:
        yield log
    finally:
        moe_mod.route, moe_mod.dispatch = route, dispatch


def routing_audit(want: list, got: list, K: int,
                  what: str) -> tuple[list, set]:
    """Layer by layer, the tokens whose chosen experts (in order) differ
    between two recorded runs over the same sequences. In the first layer
    where a sequence differs at all, each differing token must be a near
    tie in ``want``: its K-th and (K+1)-th probabilities within 2 x RTOL
    of each other (the two runs' fp32 sums round differently). From that
    layer on the sequence may differ as a consequence, and it is left out
    of what the caller compares. Returns (the flips, the sequences left
    out)."""
    import torch
    if len(want) != len(got):
        raise AssertionError(f"{what}: {len(want)} MoE calls against "
                             f"{len(got)}")
    flips, out = [], set()
    for layer, (w, g) in enumerate(zip(want, got)):
        new = set()
        for b, s in (w["idx"] != g["idx"]).any(-1).nonzero().tolist():
            if b in out:
                continue
            top = torch.sort(w["probs"][b, s], descending=True).values
            gap = float(top[K - 1] - top[K])
            if gap > 2 * RTOL * float(top[K - 1]):
                raise AssertionError(
                    f"{what}: layer {layer}, sequence {b}, token {s} takes "
                    f"experts {g['idx'][b, s].tolist()} against "
                    f"{w['idx'][b, s].tolist()}, at a probability gap of "
                    f"{gap:.3g}")
            flips.append(dict(layer=layer, row=b, token=s, gap=gap))
            new.add(b)
        out |= new
    return flips, out


def set_lm_cfg(model, cfg) -> None:
    model.cfg = cfg
    for layer in model.layers:
        layer.cfg = cfg


def serve_lm(model, tokens, steps: int, torch) -> dict:
    """``prefill`` of ``tokens`` (a warm call, then a timed one: host clock
    around a synchronise), then ``steps`` greedy ``decode_step``s into a
    cache grown to S + steps, each timed, and one step's device time
    (profiler); peak memory over the timed calls. Logits must be
    finite."""
    from repro_torch.models import transformer as tf
    B, S = tokens.shape
    with torch.no_grad():
        tf.prefill(model, tokens)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, cache = tf.prefill(model, tokens)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        grown = tf.init_cache(model.cfg, B, S + steps, device=DEVICE)
        grown["k"][:, :, :S] = cache["k"]
        grown["v"][:, :, :S] = cache["v"]
        grown["len"] = cache["len"]
        del cache
        nxt = logits[:, -1].argmax(-1, keepdim=True)
        step_ms, finite = [], bool(torch.isfinite(logits).all())
        for _ in range(steps):
            t0 = time.perf_counter()
            dec, grown = tf.decode_step(model, grown, nxt)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            finite &= bool(torch.isfinite(dec).all())
            nxt = dec[:, -1].argmax(-1, keepdim=True)
        # the device's share of a step: its kernels and copies summed
        # under the profiler, against the step's wall time
        step_device_ms = device_ms(
            lambda: tf.decode_step(model, grown, nxt), reps=5)
    if not finite or tuple(dec.shape) != (B, 1, model.cfg.vocab):
        raise AssertionError(f"moe: {model.cfg.name}'s logits are not "
                             f"finite or have the wrong shape")
    ordered = sorted(step_ms[1:])
    return dict(prefill_ms=round(prefill_ms, 3),
                prefill_tokens_per_s=round(B * S / prefill_ms * 1e3, 1),
                decode_ms_median=round(ordered[len(ordered) // 2], 3),
                decode_ms_first=round(step_ms[0], 3),
                decode_ms_max=round(ordered[-1], 3),
                decode_device_ms=round(step_device_ms, 3),
                decode_device_busy=round(
                    step_device_ms / ordered[len(ordered) // 2], 3),
                decode_tokens_per_s=round(
                    B / ordered[len(ordered) // 2] * 1e3, 1),
                peak_memory_mb=round(torch.cuda.max_memory_allocated() / 1e6,
                                     1))


def decode_bounds(cfg, n_params: int, batch: int, seq: int) -> dict:
    """The least time of one decode step at the HBM rate, from what the
    code moves: with fp32 masters ``_cast`` reads every weight (4 bytes),
    writes its bf16 copy (2) and the products read that copy (2); with
    bf16 parameters the products read each weight once (2 bytes), the
    embedding aside (only the batch's rows are gathered). Both read the
    KV cache (bf16) once."""
    kv = (cfg.n_layers * batch * seq * cfg.n_kv_heads * cfg.head_dim * 2
          * 2)
    embed = cfg.vocab * cfg.d_model
    return {"fp32_masters": (n_params * 8 + kv) / HBM_BYTES_S * 1e3,
            "bf16_params": ((n_params - embed) * 2 + kv) / HBM_BYTES_S
            * 1e3}


def phase_moe(torch) -> dict:
    """The MoE LMs served: olmoe at depth 2 (full widths, fp32) on the card
    against the CPU on the same weights (logits, aux and every layer's
    routing, near-tie flips audited), and its decode at no-drop capacity
    against a full forward over S + 1; then olmoe at full depth and
    llama4-scout cut to 4 layers, drawn on the card, each from fp32
    masters and from bf16 parameters: prefill of 8 x 512 tokens and 32
    decode steps, timed, with the bounds of a decode step; the two
    parameter dtypes' prefill logits equal bit for bit under
    deterministic algorithms."""
    import copy

    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as tf

    t_phase = time.perf_counter()
    reset_launch_counts()
    full = get_arch(MOE_ARCH).config()
    E, K = full.moe.n_experts, full.moe.top_k
    rng = np.random.default_rng(MOE_SEED)

    # ---- depth 2, fp32: the card against the CPU on the same weights
    cfg = dataclasses.replace(full, n_layers=MOE_CHECK_DEPTH, dtype="float32")
    t0 = time.perf_counter()
    on_cpu = tf.init_params(torch.Generator().manual_seed(MOE_SEED), cfg,
                            device="cpu")
    cpu_init_s = time.perf_counter() - t0
    on_card = copy.deepcopy(on_cpu).to(DEVICE)
    B, S = MOE_CHECK_BATCH, MOE_CHECK_SEQ
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    runs = {}
    with torch.no_grad():
        for name, model in (("cpu", on_cpu), ("card", on_card)):
            routes: list = []
            t0 = time.perf_counter()
            with recorded_routing(routes):
                logits, aux = tf.forward(model, toks)
            runs[name] = (logits.float().cpu(), float(aux), routes,
                          time.perf_counter() - t0)
    del on_cpu
    (lc, ac, rc, cpu_s), (lg, ag, rg, card_s) = runs["cpu"], runs["card"]
    flips, left_out = routing_audit(rc, rg, K, "moe: depth 2, card vs CPU")
    rows = [b for b in range(B) if b not in left_out]
    if not rows:
        raise AssertionError("moe: every sequence left out after a flip")
    atol = 1e-5 * float(lc.abs().max())
    if not torch.allclose(lg[rows], lc[rows], rtol=1e-4, atol=atol):
        raise AssertionError("moe: depth-2 logits on the card differ from "
                             "the CPU's")
    if not flips and not math.isclose(ag, ac, rel_tol=1e-5):
        raise AssertionError(f"moe: aux {ag} on the card against {ac}")
    check = dict(layers=MOE_CHECK_DEPTH, batch=B, seq=S,
                 params=on_card.n_params(), cpu_init_s=round(cpu_init_s, 2),
                 logits_max_abs_err=float((lg[rows] - lc[rows]).abs().max()),
                 logits_atol=atol, aux_card=ag, aux_cpu=ac,
                 aux_gated=not flips,
                 routed_tokens=MOE_CHECK_DEPTH * B * S,
                 routing_flips=flips, rows_left_out=sorted(left_out),
                 capacity=rc[0]["C"], kept=[round(x["kept"], 4) for x in rg],
                 cpu_s=round(runs["cpu"][3], 2), card_s=round(card_s, 3))

    # ---- no-drop capacity: decode equals a full forward over S + 1
    nd = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=E / K))
    set_lm_cfg(on_card, nd)
    toks_d = toks.to(DEVICE)
    pre_log, dec_log, fwd_log = [], [], []
    with torch.no_grad():
        with recorded_routing(pre_log):
            logits, cache = tf.prefill(on_card, toks_d,
                                       cache_dtype=torch.float32)
        nxt = logits[:, -1].argmax(-1, keepdim=True)
        grown = tf.init_cache(nd, B, S + 1, torch.float32, device=DEVICE)
        grown["k"][:, :, :S] = cache["k"]
        grown["v"][:, :, :S] = cache["v"]
        grown["len"] = cache["len"]
        with recorded_routing(dec_log):
            dec, _ = tf.decode_step(on_card, grown, nxt)
        with recorded_routing(fwd_log):
            whole, _ = tf.forward(on_card, torch.cat([toks_d, nxt], 1))
    joined = [{"idx": torch.cat([p["idx"], d["idx"]], 1),
               "probs": torch.cat([p["probs"], d["probs"]], 1)}
              for p, d in zip(pre_log, dec_log)]
    nd_flips, nd_out = routing_audit(fwd_log, joined, K,
                                     "moe: decode vs full forward")
    nd_rows = [b for b in range(B) if b not in nd_out]
    if not nd_rows or not all(x["kept"] == 1.0
                              for x in pre_log + dec_log + fwd_log):
        raise AssertionError("moe: no-drop capacity dropped a pick, or "
                             "every sequence was left out")
    got, want = dec[nd_rows, 0].cpu(), whole[nd_rows, -1].cpu()
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
        raise AssertionError("moe: decode differs from the full forward")
    check["no_drop_decode"] = dict(
        capacity_factor=E / K, prefill_capacity=pre_log[0]["C"],
        decode_capacity=dec_log[0]["C"],
        max_abs_err=float((got - want).abs().max()), flips=nd_flips,
        rows_left_out=sorted(nd_out))
    del on_card, cache, grown
    torch.cuda.empty_cache()

    # ---- olmoe at full depth, llama4-scout cut to 4 layers: prefill
    # 8 x 512 and 32 decode steps, from fp32 masters and bf16 parameters
    served = {}
    for arch, depth in ((MOE_ARCH, None), (MOE_LLAMA, MOE_LLAMA_DEPTH)):
        pub = get_arch(arch).config()
        cfg = pub if depth is None else dataclasses.replace(pub,
                                                            n_layers=depth)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab, (MOE_BATCH, MOE_SEQ))).to(DEVICE)
        out, det = {}, {}
        for pdt in (torch.float32, torch.bfloat16):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = tf.init_params(
                torch.Generator(device=DEVICE).manual_seed(MOE_SEED), cfg,
                device=DEVICE, param_dtype=pdt)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            n_params = model.n_params()
            param_gb = sum(p.numel() * p.element_size()
                           for p in model.parameters()) / 1e9
            with torch.no_grad(), deterministic(torch):
                det[pdt] = tf.prefill(model, toks)[0].float().cpu()
            r = serve_lm(model, toks, MOE_DECODE, torch)
            routes: list = []
            with torch.no_grad(), recorded_routing(routes, probs=False):
                tf.prefill(model, toks)
            r.update(init_s=round(init_s, 3), param_gb=round(param_gb, 2),
                     capacity=routes[0]["C"],
                     kept=[round(x["kept"], 4) for x in routes])
            out["fp32_masters" if pdt == torch.float32
                else "bf16_params"] = r
            del model
            torch.cuda.empty_cache()
        if not torch.equal(det[torch.float32], det[torch.bfloat16]):
            raise AssertionError(f"moe: {arch} from bf16 parameters gives "
                                 f"other prefill logits than from fp32 "
                                 f"masters")
        bounds = decode_bounds(cfg, n_params, MOE_BATCH,
                               MOE_SEQ + MOE_DECODE)
        for key, r in out.items():
            r["decode_bound_ms"] = round(bounds[key], 3)
            r["decode_share_of_bound"] = round(
                bounds[key] / r["decode_ms_median"], 3)
        served[arch] = dict(
            layers=cfg.n_layers, published_layers=pub.n_layers,
            cut=(None if depth is None else
                 f"depth {pub.n_layers} -> {depth} (the full model, "
                 f"{pub.param_count() / 1e9:.1f}B, does not fit one card)"),
            params=n_params, active_params=cfg.active_param_count(),
            d_model=cfg.d_model, experts=cfg.moe.n_experts,
            top_k=cfg.moe.top_k, shared=cfg.moe.n_shared,
            batch=MOE_BATCH, prefill_seq=MOE_SEQ, decode_steps=MOE_DECODE,
            bf16_params_equal_fp32_masters=True, **out)
    launches = launch_counts()
    log("moe", card_vs_cpu=check, served=served,
        serves_from="fp32_masters (the reference's init_params default; "
        "bf16_params timed beside it)", launches=launches,
        seconds=round(time.perf_counter() - t_phase, 2))
    return {"launches": launches}


def phase_train_moe(torch) -> dict:
    """olmoe at its full widths, depth 2: one AdamW step (fp32) on the
    card against the CPU (``card_vs_cpu``; the routing of every call
    audited), 10 more on the same batch (the loss must fall by a nat),
    then 6 steps at batch 8 x 512 in bf16 compute on fp32 masters with
    remat, timed (step ms, tokens/s, MFU on the active parameters, peak
    memory); then the launcher for both MoE archs through
    ``launch_and_resume`` at ``--preset smoke`` (the full presets need
    110 GB and more, and the launcher has no depth flag)."""
    import copy

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import LMDataSpec, lm_batch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import transformer as tf
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    from repro_torch.training.tree import module_tree

    t_phase = time.perf_counter()
    reset_launch_counts()
    full = get_arch(MOE_ARCH).config()
    cfg = dataclasses.replace(full, n_layers=MOE_CHECK_DEPTH, dtype="float32")
    on_cpu = tf.init_params(torch.Generator().manual_seed(MOE_SEED + 1), cfg,
                            device="cpu")
    b = {k: v[:, :MOE_CHECK_SEQ] for k, v in lm_batch(
        LMDataSpec(cfg.vocab, MOE_CHECK_SEQ + 1, MOE_CHECK_BATCH),
        0).items()}
    on_card = copy.deepcopy(on_cpu).to(DEVICE)
    adam = opt_lib.adamw(opt_lib.constant_schedule(LM_CHECK_LR))
    routes: list = []
    try:
        with recorded_routing(routes):
            check = card_vs_cpu(on_cpu, on_card, tf.loss_fn, adam,
                                TrainConfig(), [b], LM_CHECK_LR, "train_moe",
                                torch)
    except AssertionError as e:
        half = len(routes) // 2
        flips, _ = routing_audit(routes[:half], routes[half:],
                                 cfg.moe.top_k, "train_moe")
        raise AssertionError(f"{e} (routing flips at near ties: "
                             f"{flips})") from e
    half = len(routes) // 2
    check["routing_flips"], _ = routing_audit(
        routes[:half], routes[half:], cfg.moe.top_k, "train_moe")
    check.update(moe_calls=half, params=on_cpu.n_params())
    del on_cpu
    memo, _ = step_state(on_card, tf.loss_fn, adam, TrainConfig(),
                         [b] * LM_MEMO_STEPS)
    memo_loss = [round(m["loss"], 4) for m in memo]
    if not memo_loss[-1] < memo_loss[0] - LM_MEMO_DROP:
        raise AssertionError(f"train_moe: the loss did not fall on a "
                             f"repeated batch: {memo_loss}")
    del on_card
    torch.cuda.empty_cache()

    # timed: bf16 compute on fp32 masters (the published dtype), remat
    tcfg = dataclasses.replace(full, n_layers=MOE_CHECK_DEPTH)
    model = tf.init_params(
        torch.Generator(device=DEVICE).manual_seed(MOE_SEED + 1), tcfg,
        device=DEVICE)
    spec = LMDataSpec(tcfg.vocab, MOE_TRAIN_SEQ + 1, MOE_TRAIN_BATCH)
    batches = [{k: v[:, :MOE_TRAIN_SEQ].to(DEVICE)
                for k, v in lm_batch(spec, s).items()}
               for s in range(MOE_TRAIN_STEPS)]
    opt = opt_lib.adamw(opt_lib.constant_schedule(LM_CHECK_LR))
    step = make_train_step(tf.loss_fn, opt, TrainConfig())
    state = opt.init(module_tree(model))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s, losses = [], []
    for i, bt in enumerate(batches):
        t0 = time.perf_counter()
        model, state, m = step(model, state, bt, i)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train_moe: losses {losses}")
    timed = sorted(step_s[2:])
    median = timed[len(timed) // 2]
    tokens = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
    flops = 6.0 * tcfg.active_param_count() * tokens
    del model, state
    torch.cuda.empty_cache()
    launched = {arch: launch_and_resume(arch, torch)
                for arch in (MOE_ARCH, MOE_LLAMA)}
    launches = launch_counts()
    log("train_moe", arch=MOE_ARCH, card_vs_cpu=check,
        repeated_batch=dict(losses=memo_loss),
        check_shape=dict(layers=cfg.n_layers, d_model=cfg.d_model,
                         experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
                         batch=MOE_CHECK_BATCH, seq=MOE_CHECK_SEQ),
        timed=dict(layers=tcfg.n_layers, dtype=tcfg.dtype, remat=tcfg.remat,
                   batch=MOE_TRAIN_BATCH, seq=MOE_TRAIN_SEQ,
                   params=tcfg.param_count(),
                   active_params=tcfg.active_param_count(),
                   losses=[round(x, 4) for x in losses],
                   step_ms_median=round(median * 1e3, 2),
                   step_ms=[round(x * 1e3, 2) for x in step_s],
                   tokens_per_s=round(tokens / median, 1),
                   model_flops_per_step=flops,
                   mfu=round(flops / median / BF16_FLOP_S, 4),
                   mfu_peak="989 TFLOP/s dense bf16 (H100 SXM data sheet)",
                   peak_memory_mb=round(peak / 1e6, 1)),
        launcher=launched,
        launcher_preset_note="smoke: --preset full needs 110 GB and more "
        "(olmoe's 6.9B parameters with AdamW state; llama4-scout 107.8B) "
        "and the launcher has no depth flag",
        launches=launches, seconds=round(time.perf_counter() - t_phase, 2))
    return {"launches": launches}


# ---------------------------------------------------------------------------
# train_sharded: sharded training over ranks that share the card
# ---------------------------------------------------------------------------

TS_ARCH = "olmo-1b"
TS_LAYERS = 2               # of 16: a cut for time (widths published)
TS_DEVICES = 2              # the launcher's (2, 1) mesh: FSDP over "data"
TS_STEPS, TS_BATCH, TS_SEQ = 10, 8, 512
TS_RESUME_AT = 4            # the launcher checkpoints every 5 steps
TS_LOSS_RTOL = 1e-3         # bf16 compute: the ranks' sums run in other orders
TS_SEED = SEED + 70
TS_DLRM_BATCH = 2048
TS_DLRM_SLICE = 65_536      # rows around the shard boundary held whole
TS_DLRM_REPS = 20
TS_MEM_POLL_S = 0.5


def _card_memory_mb(stop=None, out: list | None = None) -> list | None:
    """Each card's used memory in MB, in card order (every process's:
    ``nvidia-smi``; in a container its per-process list can show the
    card's total for each process, so it does not part ranks that share
    a card). With ``stop`` and ``out``, poll it into ``out`` until
    ``stop`` is set."""
    while True:
        try:
            got = subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, timeout=10).stdout.split()
            mb = [float(x) for x in got] or None
        except (OSError, subprocess.SubprocessError, ValueError):
            mb = None
        if stop is None:
            return mb
        if mb is not None:
            out.append(mb)
        if stop.wait(TS_MEM_POLL_S):
            return None


def _mb(n: float | None) -> float | None:
    return None if n is None else round(n / 1e6, 1)


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_mb(dev) -> float | None:
    import torch
    if dev.type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(dev) / 1e6, 1)


def _ts_dlrm_rank(rank: int, device_type: str, cfg, n_slice: int,
                  n_ranks: int) -> dict:
    """One rank of the (1, ``n_ranks``) mesh holding its block of DLRM's
    table (its rows over 'model'): the lookup of a batch of 2,048
    examples, timed, and of ids in a slice of rows across the middle
    shard boundary against the slice gathered whole (each rank adds its
    rows of the slice into zeros, one all-reduce: exact)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.data import pipeline as pl
    from repro_torch.distributed import parallelize as par
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh, rank_device
    from repro_torch.models.embedding import embedding_init, embedding_lookup
    dev = rank_device(rank, device_type)
    mesh = make_host_mesh((1, n_ranks), ("data", "model"), dev.type)
    rules = sh.recsys_rules(mesh)
    rows = cfg.n_sparse * cfg.vocab_per_table
    spec = sh.divisible_spec(rules, ("table_rows", "embed"),
                             (rows, cfg.embed_dim))
    pl_ = sh.placements(mesh, spec)
    local_rows = rows // n_ranks
    t0 = time.perf_counter()
    block = embedding_init(torch.Generator(device=dev).manual_seed(
        TS_SEED + rank), local_rows, cfg.embed_dim, device=dev)
    table = DTensor.from_local(block, mesh, pl_, run_check=False,
                               shape=(rows, cfg.embed_dim),
                               stride=(cfg.embed_dim, 1))
    _sync(dev)
    draw_s = time.perf_counter() - t0
    b = pl.dlrm_batch(cfg, TS_DLRM_BATCH, 0)
    ids = (b["sparse"].long() + torch.arange(cfg.n_sparse)[None, :]
           * cfg.vocab_per_table).to(dev)
    layout = par.Layout(rules, par.batch_axes_of(rules))
    with par.use_layout(layout), torch.no_grad():
        emb = embedding_lookup(table, ids)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(TS_DLRM_REPS):
            emb = embedding_lookup(table, ids)
        _sync(dev)
        lookup_ms = (time.perf_counter() - t0) / TS_DLRM_REPS * 1e3
        # ids in [lo, lo + n_slice), across the middle shard boundary
        lo = rows // 2 - n_slice // 2
        g = torch.Generator().manual_seed(TS_SEED)
        sl_ids = (torch.randint(0, n_slice, ids.shape, generator=g)
                  + lo).to(dev)
        got = embedding_lookup(table, sl_ids)
        start = rank * local_rows
        a, b_ = max(lo, start), min(lo + n_slice, start + local_rows)
        whole = torch.zeros((n_slice, cfg.embed_dim), device=dev)
        if b_ > a:
            whole[a - lo:b_ - lo] = block[a - start:b_ - start]
        dist.all_reduce(whole)
        same = bool(torch.equal(got, whole[sl_ids - lo]))
    return dict(rank=rank, device=str(dev), backend=dist.get_backend(),
                rows=rows, local_rows=block.shape[0],
                local_gb=round(block.numel() * 4 / 1e9, 2),
                placements=[str(p) for p in pl_], draw_s=round(draw_s, 2),
                lookup_ms=round(lookup_ms, 3), slice_equal=same,
                finite=bool(torch.isfinite(emb).all()),
                out_shape=list(emb.shape), peak_mb=_peak_mb(dev))


def ts_olmo(torch, layers: int, devices: int, resume_rtol: float) -> dict:
    """OLMo-1B at its published widths, cut to ``layers`` layers, through
    ``python -m repro_torch.launch.train --preset full --layers <layers>
    --devices <devices> --steps 10`` (mesh ``mesh_shape(devices)``, FSDP
    over "data", 8 x 512), stopped (its process group killed) once the
    step-4 checkpoint it writes after step 4 is on disk: a preemption at
    step 5. The launcher's ten steps run here on one device,
    uninterrupted (its seed, batches and optimizer); the mesh's steps 0-4
    within ``TS_LOSS_RTOL`` of them, and the checkpoint (whole tensors)
    resumed on one device for steps 5-9 within ``resume_rtol``. Step ms
    (from the times rank 0's step lines arrive), tokens/s, MFU, the
    backend the launcher reports, each card's used memory before and at
    its peak (``nvidia-smi``, polled) and the cards the ranks took."""
    import signal
    import tempfile
    import threading

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import LMDataSpec, lm_batch
    from repro_torch.models import transformer as tf
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    from repro_torch.training.tree import module_tree

    full = dataclasses.replace(get_arch(TS_ARCH).config(), n_layers=layers)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        step_dir = os.path.join(ckpt, f"step_{TS_RESUME_AT:010d}")
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               TS_ARCH, "--preset", "full", "--layers", str(layers),
               "--devices", str(devices),
               "--steps", str(TS_STEPS), "--batch", str(TS_BATCH), "--seq",
               str(TS_SEQ), "--ckpt-dir", ckpt]
        stop, card = threading.Event(), []
        before_mb = _card_memory_mb()
        poll = threading.Thread(target=_card_memory_mb, args=(stop, card),
                                daemon=True)
        lines: list[tuple[float, str]] = []
        with open(os.path.join(tmp, "stderr"), "w+") as err:
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=err,
                                    text=True, cwd=ROOT,
                                    start_new_session=True,
                                    env={**os.environ, "PYTHONPATH": str(SRC)})
            reader = threading.Thread(target=lambda: lines.extend(
                (time.perf_counter(), ln.rstrip()) for ln in proc.stdout),
                daemon=True)
            reader.start()
            poll.start()
            try:
                while not os.path.isdir(step_dir):
                    if proc.poll() is not None:
                        err.seek(0)
                        raise AssertionError(
                            f"train_sharded: the launcher exited "
                            f"{proc.returncode} before its step-"
                            f"{TS_RESUME_AT} checkpoint:\n"
                            f"{err.read()[-3000:]}")
                    if time.perf_counter() - t0 > 900:
                        raise AssertionError("train_sharded: no step-"
                                             f"{TS_RESUME_AT} checkpoint "
                                             f"in 900 s")
                    time.sleep(0.2)
                run_s = time.perf_counter() - t0
            finally:
                # the preemption: the launcher and its ranks, all at once
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
                reader.join(timeout=10)
                stop.set()
                poll.join()
        steps = {int(m[1]): (t, float(m[2])) for t, ln in lines
                 for m in [re.match(r"\[fit\] step (\d+): loss=(\S+)", ln)]
                 if m}
        text = [ln for _, ln in lines]
        shape = (devices, 1)
        want_mesh = f"[train] mesh: {{'data': {devices}, 'model': 1}}"
        ranks_line = re.match(rf"\[train\] {devices} ranks over (\w+) on ",
                              text[1]) if len(text) > 1 else None
        if not text or text[0] != want_mesh or ranks_line is None \
                or sorted(steps)[:TS_RESUME_AT + 1] != list(
                    range(TS_RESUME_AT + 1)):
            raise AssertionError(f"train_sharded: the launcher's lines: "
                                 f"{text[:8]}")
        losses = [steps[i][1] for i in range(TS_RESUME_AT + 1)]
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"train_sharded: losses {losses}")
        # wait for the killed ranks' memory to come back to the card
        free_by = time.perf_counter() + 60
        while (torch.cuda.mem_get_info()[0] < 0.8 * torch.cuda.mem_get_info()[1]
               and time.perf_counter() < free_by):
            time.sleep(0.5)

        # one device, here: the launcher's init (seed 0), its batches and
        # optimizer, all ten steps uninterrupted
        spec = LMDataSpec(full.vocab, TS_SEQ + 1, TS_BATCH)

        def batch(step: int) -> dict:
            return {k: v[:, :TS_SEQ].to(DEVICE)
                    for k, v in lm_batch(spec, step).items()}

        def launcher_init():
            return tf.init_params(torch.Generator().manual_seed(0), full,
                                  device=DEVICE)

        opt = opt_lib.adamw(opt_lib.cosine_schedule(
            3e-4, warmup=max(1, TS_STEPS // 10), total=TS_STEPS))
        step = make_train_step(tf.loss_fn, opt, TrainConfig(steps=TS_STEPS))
        t0 = time.perf_counter()
        model = launcher_init()
        init_s = time.perf_counter() - t0
        state, want, one_ms = opt.init(module_tree(model)), [], []
        for s in range(TS_STEPS):
            b = batch(s)
            _sync(torch.device(DEVICE))
            t0 = time.perf_counter()
            model, state, mm = step(model, state, b, s)
            want.append(float(mm["loss"]))
            one_ms.append((time.perf_counter() - t0) * 1e3)
        del model, state, mm
        # the mesh's step-4 checkpoint resumed on one device
        model = launcher_init()
        state = opt.init(module_tree(model))
        mgr = CheckpointManager(ckpt)
        t0 = time.perf_counter()
        restored = mgr.restore_into(TS_RESUME_AT, {
            "step": 0, "params": model, "opt_state": state})
        model = mgr.cast_like(restored["params"], model)
        state = mgr.cast_like(restored["opt_state"], state)
        del restored
        restore_s = time.perf_counter() - t0
        ckpt_mb = sum(os.path.getsize(os.path.join(step_dir, fn))
                      for fn in os.listdir(step_dir)) / 1e6
        resumed = []
        for s in range(TS_RESUME_AT + 1, TS_STEPS):
            model, state, mm = step(model, state, batch(s), s)
            resumed.append(float(mm["loss"]))
        del model, state, mm
        torch.cuda.empty_cache()
    resume_err = [abs(a - b) / abs(b) for a, b in
                  zip(resumed, want[TS_RESUME_AT + 1:])]
    mesh_err = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
    for s, e in enumerate(resume_err, TS_RESUME_AT + 1):
        if e > resume_rtol:
            raise AssertionError(f"train_sharded: resumed step {s}'s loss "
                                 f"{resumed[s - TS_RESUME_AT - 1]} against "
                                 f"one device's uninterrupted {want[s]} "
                                 f"(rtol {resume_rtol})")
    for s, e in enumerate(mesh_err):
        if e > TS_LOSS_RTOL:
            raise AssertionError(f"train_sharded: step {s}'s loss "
                                 f"{losses[s]} on the mesh against one "
                                 f"device's {want[s]}")
    # steps 1-4: the times between rank 0's step lines (step 0 warms up;
    # the checkpoint comes after step 4's line)
    step_s = sorted(steps[i][0] - steps[i - 1][0]
                    for i in range(2, TS_RESUME_AT + 1))
    median_s = step_s[len(step_s) // 2]
    tokens = TS_BATCH * TS_SEQ
    flops = 6.0 * full.param_count() * tokens
    one_s = sorted(one_ms[1:])[len(one_ms[1:]) // 2] / 1e3
    peak = ([max(c[i] for c in card) for i in range(len(card[0]))]
            if card else None)
    gained = ([round(p - b, 1) for p, b in zip(peak, before_mb)]
              if peak and before_mb else None)
    # the cards whose used memory rose by more than a GB while the
    # launcher ran: where its ranks sat
    used = [i for i, g in enumerate(gained or []) if g > 1000]
    return dict(
        launcher=" ".join(cmd[1:]), mesh=dict(zip(("data", "model"), shape)),
        layers=layers, depth_cut=f"{layers} of "
        f"{get_arch(TS_ARCH).config().n_layers} layers",
        backend=ranks_line[1], launcher_line=text[1],
        stopped_after_s=round(run_s, 2),
        losses=[round(x, 4) for x in losses], loss_rel_err=mesh_err,
        one_device_loss0=round(want[0], 4),
        one_device_init_s=round(init_s, 2),
        resumed_at=TS_RESUME_AT,
        resumed_losses=[round(x, 4) for x in resumed],
        resumed_rel_err=resume_err,
        one_device_losses=[round(x, 4) for x in want],
        checkpoint_mb=round(ckpt_mb, 1), restore_s=round(restore_s, 2),
        loss_rtol=TS_LOSS_RTOL, resume_rtol=resume_rtol,
        step_ms_median=round(median_s * 1e3, 2),
        step_ms=[round(x * 1e3, 2) for x in step_s],
        tokens_per_s=round(tokens / median_s, 1),
        # against the bf16 peak of the cards the ranks took
        mfu=round(flops / median_s / (BF16_FLOP_S * max(1, len(used))), 4),
        one_device_step_ms_median=round(one_s * 1e3, 2),
        one_device_mfu=round(flops / one_s / BF16_FLOP_S, 4),
        card_used_mb_before=before_mb, card_used_mb_max=peak,
        card_gained_mb=gained, cards_used=used)


def ts_dlrm(torch, devices: int, backend: str) -> dict:
    """DLRM's 53.25 GB table row-sharded over ``devices`` ranks on a
    (1, ``devices``) mesh (``_ts_dlrm_rank``): every rank's lookup finite
    and its slice across the middle boundary equal to the rows gathered
    whole."""
    from repro_torch.configs import dlrm_mlperf
    from repro_torch.launch.mesh import spawn_ranks
    t0 = time.perf_counter()
    dl = spawn_ranks(_ts_dlrm_rank, devices,
                     (DEVICE, dlrm_mlperf.config(), TS_DLRM_SLICE, devices),
                     backend=backend, timeout_s=900.0)
    ranks_s = time.perf_counter() - t0
    if not all(r["slice_equal"] and r["finite"] for r in dl):
        raise AssertionError(f"train_sharded: the row-sharded lookup: {dl}")
    return dict(ranks=dl, backend=ranks_backend(dl, "dlrm lookup"),
                lookup_s=round(ranks_s, 2))


def phase_train_sharded(torch, tl: dict) -> dict:
    """Sharded training with its ranks sharing the card (gloo): OLMo-1B at
    its published widths, cut to ``TS_LAYERS`` layers, on ``TS_DEVICES``
    ranks through the launcher, preempted after its step-4 checkpoint and
    resumed on one device (``ts_olmo``), beside train_lm's numbers (the
    card's peak memory polled; each rank holds half of what the card
    gained while the two symmetric ranks ran). Then DLRM's 53.25 GB table
    row-sharded over the two ranks (``ts_dlrm``): a 2,048-example
    lookup, timed, and ids across the shard boundary against the rows
    gathered whole. (olmoe's all-to-all runs in the model_axis phase.)"""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    reset_launch_counts()
    olmo = ts_olmo(torch, TS_LAYERS, TS_DEVICES, TS_LOSS_RTOL)
    gained = olmo["card_gained_mb"]
    olmo.update(
        rank_used_mb=(round(gained[0] / TS_DEVICES, 1) if gained else None),
        train_lm={k: v for k, v in tl["summary"].items() if k != "losses"})
    out = {"olmo": olmo}
    dl = ts_dlrm(torch, TS_DEVICES, "gloo")
    out["dlrm_lookup"] = dict(ranks=dl["ranks"], backend=dl["backend"])
    out["lookup_s"] = dl["lookup_s"]
    launches = launch_counts()
    log("train_sharded", **out, launches=launches,
        seconds=round(time.perf_counter() - t_phase, 2))
    return {"launches": launches}


# ---------------------------------------------------------------------------
# model_axis: the LM's 'model' axis on two ranks that share the card
# ---------------------------------------------------------------------------

MA_ARCH = "olmo-1b"
MA_DEPTH = 4                # of 16 layers: a cut for time (widths published)
MA_MESH = (1, 2)            # ("data", "model")
MA_STEPS, MA_BATCH, MA_SEQ = 2, 2, 1024
MA_DECODE = 4
MA_SLOTS = MA_SEQ + 8       # the decode cache: the prompt and 8 more slots
MA_LR = 3e-4
MA_RTOL = 1e-4              # losses and logits against one device
# serving runs in both (the KV cache in the compute dtype): bf16 decode's
# tensor-parallel sums (the MLP's down product, the flash-decode combine,
# the vocab blocks' head) round at other points than one device's, so its
# logits are held to bf16's rounding (4 ulps, in norm) and its greedy
# tokens exactly; fp32 decode holds MA_RTOL and so carries the tight decode
# check (a fault of a few 1e-3 in norm can pass in bf16)
MA_SERVE_DTYPES = ("bfloat16", "float32")
MA_BF16_L2 = 4 * 2.0 ** -8
# a routing flip between bf16 runs must be a near tie: the probabilities
# of the first differing pick's rank and the next within this (as
# tests/test_torch_moe_bf16.py bounds one); its row is then left out
MA_BF16_TIE = 1e-2
MA_GRAD_RTOL = 1e-4         # fp32 gradients, of each leaf's largest entry
MA_SEED = SEED + 90
MA_MOE_BATCH, MA_MOE_SEQ = 2, 128
# olmoe served on the mesh (the experts split over 'model' in decode):
# prefill of MA_MOE_BATCH x MA_MOE_SEQ, the cache grown by 8 slots
MA_MOE_SLOTS = MA_MOE_SEQ + 8
# MeshGraphNet at its published widths on full_graph_sm's Cora geometry,
# its nodes and edges over the mesh as gnn_rules lay them
MA_GNN_SHAPE = "full_graph_sm"
MA_GNN_STEPS = 2
MA_GNN_LOSS_RTOL = 1e-5


def _ma_cfg():
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(MA_ARCH).config(), n_layers=MA_DEPTH)


def _ma_batch(vocab: int, step: int, batch: int = MA_BATCH,
              seq: int = MA_SEQ) -> dict:
    from repro_torch.data.pipeline import LMDataSpec, lm_batch
    return {k: v[:, :seq] for k, v in lm_batch(
        LMDataSpec(vocab, seq + 1, batch), step).items()}


def ma_run(dev, cfg, mesh=None) -> dict:
    """OLMo-1B's ``cfg`` (``_ma_cfg``: its published widths, ``MA_DEPTH``
    layers, bf16 compute on fp32 masters, remat), drawn on ``dev`` from
    ``MA_SEED``:
    ``MA_STEPS`` AdamW steps on ``MA_BATCH`` x ``MA_SEQ``, then a fresh
    draw serves: prefill of batch ``MA_STEPS``'s tokens, the cache grown
    to ``MA_SLOTS`` slots, ``MA_DECODE`` greedy decode steps. On ``mesh``
    (this rank's part of it, under ``lm_rules``: the sequence over 'model'
    in training and prefill, the MLP, the vocab and the cache's slots over
    it in decode), else on one device. Losses, logits (on the host), the
    greedy tokens, whether the decode cache kept its storage, times and
    peak memory."""
    import torch

    from repro_torch.distributed import parallelize as par
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer as tf
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    from repro_torch.training.tree import module_tree

    def draw():
        return tf.init_params(torch.Generator(device=dev).manual_seed(
            MA_SEED), cfg, device=dev)

    model, layout = draw(), None
    if mesh is not None:
        rules = sh.lm_rules(mesh)
        par.shard_module(model, rules, tf.param_axes(cfg))
        layout = par.Layout(rules, par.batch_axes_of(rules))
    opt = opt_lib.adamw(opt_lib.constant_schedule(MA_LR))
    state = opt.init(module_tree(model))
    step = make_train_step(tf.loss_fn, opt, TrainConfig(), layout=layout)
    losses, step_ms = [], []
    for i in range(MA_STEPS):
        b = {k: v.to(dev) for k, v in _ma_batch(cfg.vocab, i).items()}
        _sync(dev)
        t0 = time.perf_counter()
        model, state, m = step(model, state, b, i)
        losses.append(float(m["loss"]))
        step_ms.append(round((time.perf_counter() - t0) * 1e3, 2))
    out = {"train": dict(losses=losses, step_ms=step_ms,
                         peak_mb=_peak_mb(dev))}
    del model, state, step, m
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    out["serve"] = {dt: ma_serve(dev, dataclasses.replace(cfg, dtype=dt),
                                 mesh) for dt in MA_SERVE_DTYPES}
    return out


def ma_serve(dev, cfg, mesh=None, batch: int = MA_BATCH,
             seq: int = MA_SEQ, slots: int = MA_SLOTS,
             keep_state: bool = False, start: dict | None = None) -> dict:
    """``ma_run``'s serving half in ``cfg``'s compute dtype, the KV cache
    in the same dtype: a fresh draw, prefill of ``batch`` x ``seq``, the
    cache grown to ``slots``, greedy decode steps; for an MoE, the expert
    weights each rank holds (bytes) and each decode step's widths (the
    experts a layer computes with) and gathered bytes. ``keep_state``
    returns the prefill's whole cache and logits (``state``, on the
    host); decode then starts from ``start`` (such a state) in place of
    this run's own prefill. On a mesh whose "data" axis splits the batch,
    every per-row result holds this rank's rows, ``rows`` (lo, hi) of the
    batch."""
    import torch

    from repro_torch.distributed import parallelize as par
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = tf.init_params(torch.Generator(device=dev).manual_seed(MA_SEED),
                           cfg, device=dev)
    pre = dec = None
    if mesh is not None:
        rules = sh.lm_rules(mesh, training=False)
        par.shard_module(model, rules, tf.param_axes(cfg))
        pre = par.Layout(rules, par.batch_axes_of(rules))
        drules = sh.lm_rules(mesh, training=False, decode=True)
        dec = par.Layout(drules, par.batch_axes_of(drules))
    expert_bytes = sum(
        (p.to_local() if hasattr(p, "to_local") else p).nbytes
        for name, p in model.named_parameters()
        if name.split(".")[-2:] in (["moe", k] for k in moe.EXPERT_KEYS))
    toks = {"tokens": _ma_batch(cfg.vocab, MA_STEPS, batch, seq)[
        "tokens"].to(dev)}
    with torch.no_grad():
        with par.use_layout(pre):
            row_lo = 0
            if pre is not None:
                toks, split = par.local_batch(toks, pre)
                if split:
                    row_lo = (par.line_index(mesh, split)
                              * toks["tokens"].shape[0])
            rows = (row_lo, row_lo + toks["tokens"].shape[0])
            offset = par.seq_offset(toks["tokens"].shape[1])
            pre_routes: list = []
            _sync(dev)
            t0 = time.perf_counter()
            with recorded_routing(pre_routes):
                logits, cache = tf.prefill(model, toks["tokens"],
                                           cache_dtype=cfg.compute_dtype)
            _sync(dev)
            prefill_ms = (time.perf_counter() - t0) * 1e3
            # each rank's block gathered along the sequence: the whole
            # prompt's cache, from which each decode block takes its slots
            g = par.seq_group()
            whole = {kv: par.gather(cache[kv], 2, g) for kv in ("k", "v")}
            n = int(cache["len"])
            prefill_block = list(cache["k"].shape)
            del cache
            first = logits
            state = None
            if keep_state:
                state = dict(len=n, logits=logits.float().cpu().numpy(),
                             **{kv: _host_bits(whole[kv]) for kv in whole})
            if start is not None:
                n = start["len"]
                first = torch.from_numpy(start["logits"]).to(dev)
                whole = {kv: _device_bits(start[kv], cfg.compute_dtype, dev)
                         for kv in ("k", "v")}
        with par.use_layout(dec):
            grown = tf.init_cache(cfg, batch, slots,
                                  cfg.compute_dtype, device=dev)
            blk = grown["k"].shape[2]
            axes = par.split_axes("batch", "cache_seq")
            lo = par.line_index(mesh, axes) * blk if axes else 0
            hi = min(lo + blk, n)
            for kv in ("k", "v"):
                if hi > lo:
                    grown[kv][:, :, :hi - lo] = whole[kv][:, :, lo:hi]
            del whole
            grown["len"] = torch.tensor(n, dtype=torch.int32, device=dev)
            ptrs = (grown["k"].data_ptr(), grown["v"].data_ptr())
            nxt = first[:, -1].argmax(-1, keepdim=True)
            dec_logits, tokens, dec_ms, widths, gathered = [], [], [], [], []
            dec_routes: list = []
            real_ffn, real_gather = moe._expert_ffn, par._gather_dim

            def ffn(params, x, act):
                widths[-1].append(int(params["w_up"].shape[0]))
                return real_ffn(params, x, act)

            def gather_dim(t, dim, g):
                out = real_gather(t, dim, g)
                gathered[-1] += out.numel() * out.element_size()
                return out

            moe._expert_ffn, par._gather_dim = ffn, gather_dim
            try:
                for _ in range(MA_DECODE):
                    widths.append([])
                    gathered.append(0)
                    dec_routes.append([])
                    _sync(dev)
                    t0 = time.perf_counter()
                    with recorded_routing(dec_routes[-1]):
                        d, grown = tf.decode_step(model, grown, nxt)
                    _sync(dev)
                    dec_ms.append(round((time.perf_counter() - t0) * 1e3, 2))
                    nxt = d[:, -1].argmax(-1, keepdim=True)
                    dec_logits.append(d.float().cpu().numpy())
                    tokens.append(nxt.cpu().numpy())
            finally:
                moe._expert_ffn, par._gather_dim = real_ffn, real_gather
            kept = (grown["k"].data_ptr(), grown["v"].data_ptr()) == ptrs
    out = dict(
        prefill_logits=logits.float().cpu().numpy(),
        decode_logits=dec_logits,
        tokens=tokens, storage_kept=kept, len=int(grown["len"]),
        prefill_block=prefill_block, decode_block=list(grown["k"].shape),
        prefill_ms=round(prefill_ms, 2), decode_ms=dec_ms,
        expert_bytes_held=expert_bytes, decode_expert_widths=widths,
        decode_gathered_bytes=gathered, prefill_offset=offset,
        prefill_routing=_host_routes(pre_routes),
        decode_routing=[_host_routes(r) for r in dec_routes],
        state=state, rows=rows, peak_mb=_peak_mb(dev))
    del model, grown
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _ma_moe_cfg(capacity_factor: float | None = None):
    """olmoe at its published widths, depth 2, fp32; capacity factor E / K
    (no pick dropped) unless given."""
    from repro_torch.configs import get_arch
    full = get_arch(MOE_ARCH).config()
    moe = full.moe
    cf = moe.n_experts / moe.top_k if capacity_factor is None \
        else capacity_factor
    return dataclasses.replace(
        full, n_layers=MOE_CHECK_DEPTH, dtype="float32",
        moe=dataclasses.replace(moe, capacity_factor=cf))


def _ma_grads(model, batch, torch, layout=None) -> tuple:
    """The whole batch's loss and this rank's gradients, as the sharded
    train step takes them (``layout``: ``batch`` is this rank's block)."""
    from repro_torch.distributed import parallelize as par
    from repro_torch.models import transformer as tf
    from repro_torch.training.tree import leaves, module_tree
    with par.use_layout(layout):
        loss = tf.loss_fn(model, batch)
        whole = par.batch_sum(loss.detach())
    grads = torch.autograd.grad(loss, leaves(module_tree(model)))
    return float(whole), grads


def _ma_moe_rank(rank: int, dev, mesh, cfgs: dict, batch: dict
                 ) -> tuple[dict, list | None]:
    """olmoe at depth 2 with the experts split over 'model' (the
    all-to-all on each rank's chunk of the sequence), at no-drop capacity
    (``cfgs["no_drop"]``), then at capacity 1.25 (``cfgs["cf_1.25"]``).
    Returns the rows and, on rank 0, the no-drop run's whole gradients
    (on the host)."""
    import torch

    from repro_torch.distributed import parallelize as par
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    rules = sh.lm_rules(mesh)
    out, whole = {}, None
    rows, axes = par.local_batch({k: v.to(dev) for k, v in batch.items()},
                                 par.Layout(rules, par.batch_axes_of(rules)))
    layout = par.Layout(rules, axes)
    model = tf.init_params(torch.Generator(device=dev).manual_seed(
        MA_SEED), cfgs["no_drop"], device=dev)
    par.shard_module(model, rules, tf.param_axes(model.cfg))
    for name, cfg in cfgs.items():
        set_lm_cfg(model, cfg)
        calls, kept = [], []
        real_a2a, real_dispatch = par.all_to_all, moe.dispatch

        def a2a(x, g):
            calls.append(tuple(x.shape))
            return real_a2a(x, g)

        def dispatch(x, gates, idx, E, C):
            res = real_dispatch(x, gates, idx, E, C)
            kept.append(float(res[1][3].float().mean()))
            return res

        par.all_to_all, moe.dispatch = a2a, dispatch
        try:
            _sync(dev)
            t0 = time.perf_counter()
            loss, grads = _ma_grads(model, rows, torch, layout)
            _sync(dev)
            fb_ms = (time.perf_counter() - t0) * 1e3
        finally:
            par.all_to_all, moe.dispatch = real_a2a, real_dispatch
        row = dict(loss=loss, a2a_calls=len(calls), kept=kept,
                   fwd_bwd_ms=round(fb_ms, 1), peak_mb=_peak_mb(dev))
        if name == "no_drop":
            # collectives: both ranks gather, rank 0 keeps them
            full = [par.full(g).cpu() for g in grads]
            whole = full if rank == 0 else None
            del full
        out[name] = row
        del grads
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out, whole


def _ma_reference(cfg, batch: dict, dev, got: list) -> dict:
    """``cfg``'s draw on one device (no mesh) on ``batch``: its loss and
    each gradient's largest difference to ``got`` (the mesh's, whole)
    over its largest entry."""
    import torch

    from repro_torch.models import transformer as tf
    model = tf.init_params(torch.Generator(device=dev).manual_seed(
        MA_SEED), cfg, device=dev)
    loss, grads = _ma_grads(
        model, {k: v.to(dev) for k, v in batch.items()}, torch)
    errs = [float((g.cpu() - w).abs().max()) / (float(w.abs().max()) or 1.0)
            for w, g in zip(got, grads)]
    del model, grads
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"ref_loss": loss, "grad_rel_err_max": max(errs),
            "grad_rel_err": errs}


def _ma_olmo_grads(rank: int, dev, cfg, mesh) -> dict | None:
    """The first train step's gradients of OLMo (``cfg`` in fp32: under
    bf16 the two chunks' partial sums round elsewhere than one device's
    whole sum) on ``MA_BATCH`` x ``MA_SEQ``, sequence-parallel over the
    mesh, gathered whole; rank 0 then runs one device (``_ma_reference``).
    The losses of ``ma_run`` barely see the backward: step 0's does not,
    and AdamW's first update is about lr * sign(g)."""
    import torch

    from repro_torch.distributed import parallelize as par
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(cfg, dtype="float32")
    batch = _ma_batch(cfg.vocab, 0)
    rules = sh.lm_rules(mesh)
    rows, axes = par.local_batch({k: v.to(dev) for k, v in batch.items()},
                                 par.Layout(rules, par.batch_axes_of(rules)))
    model = tf.init_params(torch.Generator(device=dev).manual_seed(
        MA_SEED), cfg, device=dev)
    par.shard_module(model, rules, tf.param_axes(cfg))
    _sync(dev)
    t0 = time.perf_counter()
    loss, grads = _ma_grads(model, rows, torch, par.Layout(rules, axes))
    _sync(dev)
    fb_ms = (time.perf_counter() - t0) * 1e3
    # collectives: both ranks gather, rank 0 keeps them
    whole = [par.full(g).cpu() for g in grads]
    del model, grads
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if rank != 0:
        return None
    out = dict(loss=loss, leaves=len(whole), fwd_bwd_ms=round(fb_ms, 1),
               **_ma_reference(cfg, batch, dev, whole))
    return out


def _ma_gnn_cfg():
    """MeshGraphNet's published config (15 layers, d 128) at
    ``MA_GNN_SHAPE``'s feature widths, and the shape."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.cells import GNN_SHAPES
    spec = GNN_SHAPES[MA_GNN_SHAPE]
    return get_arch("meshgraphnet").config(
        node_in=spec["d_feat"], edge_in=spec["d_edge"],
        node_out=spec["node_out"]), spec


def ma_gnn(dev, cfg, spec: dict, mesh=None, steps: int = MA_GNN_STEPS,
           float64: bool = False) -> dict:
    """MeshGraphNet ``cfg`` drawn on ``dev`` from ``MA_SEED`` on a random
    graph of ``spec``'s geometry (fp32, or the same draw in float64):
    step 0's loss and gradients (whole, on the host), then ``steps``
    AdamW steps, each on the step's graph. On ``mesh`` (``gnn_rules``)
    each rank holds its block of the graph's node rows and edge rows,
    padded to the ranks."""
    import torch

    from repro_torch.data.pipeline import GraphSpec, random_graph
    from repro_torch.distributed import parallelize as par
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import gnn
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    from repro_torch.training.tree import leaves, module_tree
    gspec = GraphSpec(spec["n_nodes"], spec["n_edges"], spec["d_feat"],
                      spec["d_edge"], spec["node_out"], seed=MA_SEED)
    model = gnn.init_params(torch.Generator(device=dev).manual_seed(
        MA_SEED), cfg, device=dev)
    if float64:
        model = model.double()
    layout, parts = None, 1
    if mesh is not None:
        rules = sh.gnn_rules(mesh)
        par.shard_module(model, rules, gnn.param_axes(cfg))
        layout, parts = par.Layout(rules, par.batch_axes_of(rules)), \
            mesh.size()

    def graph(step: int) -> dict:
        return gnn.pad_graph({k: v.to(dev, torch.float64) if float64
                              and v.is_floating_point() else v.to(dev)
                              for k, v in random_graph(gspec, step).items()},
                             parts)

    block = graph(0)
    if layout is not None:
        block, _ = par.local_batch(block, layout)
    _sync(dev)
    t0 = time.perf_counter()
    with par.use_layout(layout):
        local = gnn.loss_fn(model, block)
        loss0 = float(par.batch_sum(local.detach()))
    grads = torch.autograd.grad(local, leaves(module_tree(model)))
    _sync(dev)
    fb_ms = (time.perf_counter() - t0) * 1e3
    # collectives: every rank gathers
    whole = [par.full(g).cpu() for g in grads]
    del grads, local
    opt = opt_lib.adamw(opt_lib.constant_schedule(MA_LR))
    state = opt.init(module_tree(model))
    step = make_train_step(gnn.loss_fn, opt, TrainConfig(), layout=layout)
    losses, step_ms = [], []
    for i in range(steps):
        b = graph(i)
        _sync(dev)
        t0 = time.perf_counter()
        model, state, m = step(model, state, b, i)
        losses.append(float(m["loss"]))
        _sync(dev)
        step_ms.append(round((time.perf_counter() - t0) * 1e3, 2))
    out = dict(loss0=loss0, grads=whole, losses=losses, step_ms=step_ms,
               fwd_bwd_ms=round(fb_ms, 2),
               block_rows=dict(nodes=int(block["node_feat"].shape[0]),
                               edges=int(block["senders"].shape[0])),
               peak_mb=_peak_mb(dev))
    del model, state, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _ma_gnn_rank(rank: int, dev, mesh, cfg, spec: dict) -> dict:
    """``ma_gnn`` on the mesh in fp32 and in float64 (``apply_norm``
    computes in float32 whatever the dtype): step 0's gradients, then the
    AdamW steps; rank 0 then runs both on one device and returns the
    differences of the losses and of each gradient (over the leaf's
    largest entry) between the mesh and one device in each dtype, and of
    the fp32 gradients from the float64 run. In fp32 this model at these
    widths is not conditioned for 1e-4: one device's own gradients lie up
    to about 1e-3 of a leaf's largest entry from the float64 run of the
    same step, the mesh's as far on other leaves, and AdamW's first update
    carries that into the next loss at about 1e-5 (the first card runs
    and the CPU, PERF.md)."""
    got = ma_gnn(dev, cfg, spec, mesh)
    whole = got.pop("grads")
    got64 = ma_gnn(dev, cfg, spec, mesh, float64=True)
    if rank != 0:
        return got
    one = ma_gnn(dev, cfg, spec)
    one64 = ma_gnn(dev, cfg, spec, float64=True)

    def rel(a, b):
        return [float((x.double() - y.double()).abs().max())
                / (float(y.abs().max()) or 1.0) for x, y in zip(a, b)]

    def losses(r):
        return [r["loss0"], *r["losses"]]
    errs64 = rel(got64["grads"], one64["grads"])
    errs = rel(whole, one["grads"])
    got.update(one_device=dict(loss0=one["loss0"], losses=one["losses"],
                               step_ms=one["step_ms"],
                               fwd_bwd_ms=one["fwd_bwd_ms"],
                               peak_mb=one["peak_mb"]),
               loss_rel_err=[abs(a - b) / abs(b) for a, b in zip(
                   losses(got), losses(one))],
               loss64_rel_err=[abs(a - b) / abs(b) for a, b in zip(
                   losses(got64), losses(one64))],
               grad64_rel_err=errs64, grad64_rel_err_max=max(errs64),
               grad_rel_err=errs, grad_rel_err_max=max(errs),
               fp32_mesh_vs_float64=rel(whole, one64["grads"]),
               fp32_one_device_vs_float64=rel(one["grads"], one64["grads"]),
               leaves=len(errs))
    return got


def _ma_rank(rank: int, device_type: str, cfg, cfgs: dict,
             batch: dict, gnn: tuple, shape: tuple = MA_MESH) -> dict:
    """One rank of the ``shape`` ("data", "model") mesh: OLMo
    (``ma_run``), OLMo's fp32 gradients (``_ma_olmo_grads``), then olmoe
    through the all-to-all (rank 0 then runs olmoe's no-drop step on one
    device against the gathered gradients), olmoe served with its experts
    split over 'model' in decode, and MeshGraphNet's nodes and edges over
    the mesh (``_ma_gnn_rank``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh, rank_device
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = rank_device(rank, device_type)
    mesh = make_host_mesh(shape, ("data", "model"), dev.type)
    out = {"device": str(dev), "backend": dist.get_backend(),
           "olmo": ma_run(dev, cfg, mesh),
           "olmo_grads": _ma_olmo_grads(rank, dev, cfg, mesh)}
    moe, whole = _ma_moe_rank(rank, dev, mesh, cfgs, batch)
    if rank == 0:
        moe["no_drop"].update(_ma_reference(cfgs["no_drop"], batch, dev,
                                            whole))
    out["olmoe"] = moe
    out["olmoe_serve"] = {
        dt: ma_serve(dev, dataclasses.replace(cfgs["no_drop"], dtype=dt),
                     mesh, MA_MOE_BATCH, MA_MOE_SEQ, MA_MOE_SLOTS,
                     keep_state=dt == "bfloat16")
        for dt in MA_SERVE_DTYPES}
    out["gnn"] = _ma_gnn_rank(rank, dev, mesh, *gnn)
    return out


def _host_bits(t) -> np.ndarray:
    """A tensor's bits on the host (a 16-bit float as int16: numpy has no
    bfloat16)."""
    import torch
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.view(torch.int16)
    return t.cpu().numpy()


def _device_bits(a: np.ndarray, dtype, dev):
    """``_host_bits``' array back on ``dev`` as ``dtype``."""
    import torch
    t = torch.from_numpy(a).to(dev)
    return t.view(dtype) if t.dtype == torch.int16 else t


def _host_routes(log: list) -> list:
    """``recorded_routing``'s picks and probabilities as numpy arrays (a
    spawned rank returns no tensor: its storage leaves with the rank)."""
    return [{"idx": r["idx"].numpy(), "probs": r["probs"].numpy()}
            for r in log]


def _ma_flips(got: list, want: list, offset: int, out: set) -> list:
    """The rows whose MoE picks differ between two recorded runs of the
    same layers (``recorded_routing``; ``got``'s tokens are ``want``'s
    from ``offset`` on), rows in ``out`` skipped: each must be a near tie
    in ``want`` (``MA_BF16_TIE``) and is added to ``out``. Returns the
    flips."""
    K = want[0]["idx"].shape[-1] if want else 0
    flips = []
    for layer, (g, w) in enumerate(zip(got, want)):
        w_idx = w["idx"][:, offset:offset + g["idx"].shape[1]]
        w_p = w["probs"][:, offset:offset + g["idx"].shape[1]]
        for b, t in zip(*np.nonzero((g["idx"] != w_idx).any(-1))):
            b, t = int(b), int(t)
            if b in out:
                continue
            r = int(np.argmax(g["idx"][b, t] != w_idx[b, t]))
            top = np.sort(w_p[b, t])[::-1]
            gap = float(top[r] - top[r + 1])
            if r >= K or gap > MA_BF16_TIE:
                raise AssertionError(
                    f"model_axis: layer {layer}, row {b}, token "
                    f"{t + offset} picks {g['idx'][b, t].tolist()} against "
                    f"{w_idx[b, t].tolist()} at a probability gap of "
                    f"{gap:.3g}")
            flips.append(dict(layer=layer, row=b, token=t + offset,
                              gap=gap))
            out.add(b)
    return flips


def _ma_serve_check(sv: dict, want: dict, dt: str, seq: int,
                    bf16_prefill: bool = False, prefill: bool = True,
                    decode: bool = True) -> tuple[dict, bool]:
    """A rank's ``ma_serve`` against one device's in compute dtype ``dt``:
    the prefill's logits within ``MA_RTOL`` (in bf16 with
    ``bf16_prefill``, within ``MA_BF16_L2`` in norm: an MoE's all-to-all
    rounds elsewhere than one device), decode's within ``MA_RTOL`` in
    fp32 and ``MA_BF16_L2`` in norm in bf16, the greedy tokens equal, the
    cache's storage kept. In bf16 an MoE's routing may flip at a near tie
    (``_ma_flips``): the row is left out of what is compared from then
    on, and where every row flipped, the audit of the flips (each a near
    tie) is all the bf16 run is held to; the fp32 run carries the tight
    check. ``prefill`` or ``decode`` False leaves that half out (decode
    against a run that started from this rank's prefill state). (the
    row, whether it passed)"""
    bf16 = dt == "bfloat16"
    out: set = set()
    flips = []
    if bf16 and prefill:
        flips += _ma_flips(sv["prefill_routing"], want["prefill_routing"],
                           sv["prefill_offset"], out)
    rows = [b for b in range(want["prefill_logits"].shape[0])
            if b not in out]
    pre_err = pre_l2 = None
    ok = True
    if rows and prefill:
        pre_err = _rel(sv["prefill_logits"][rows],
                       want["prefill_logits"][rows])
        pre_l2 = _l2_rel(sv["prefill_logits"][rows],
                         want["prefill_logits"][rows])
        ok = (pre_l2 <= MA_BF16_L2 if bf16 and bf16_prefill
              else pre_err <= MA_RTOL)
    dec_err, dec_l2, differing, same_tokens = [], [], [], True
    for i, (a, b) in enumerate(zip(sv["decode_logits"],
                                   want["decode_logits"]) if decode else ()):
        if bf16:
            flips += _ma_flips(sv["decode_routing"][i],
                               want["decode_routing"][i], 0, out)
        rows = [r for r in range(b.shape[0]) if r not in out]
        if not rows:
            break
        dec_err.append(_rel(a[rows], b[rows]))
        dec_l2.append(_l2_rel(a[rows], b[rows]))
        differing.append(float(np.mean(a[rows] != b[rows])))
        same_tokens &= np.array_equal(sv["tokens"][i][rows],
                                      want["tokens"][i][rows])
    ok &= (same_tokens and sv["storage_kept"] and want["storage_kept"]
           and sv["len"] == seq + MA_DECODE
           and all(e <= (MA_BF16_L2 if bf16 else MA_RTOL)
                   for e in (dec_l2 if bf16 else dec_err)))
    return dict(
        prefill_logit_rel_err=pre_err, prefill_logit_l2_rel_err=pre_l2,
        decode_logit_rel_err=dec_err, decode_logit_l2_rel_err=dec_l2,
        decode_logits_differing=differing,
        greedy_tokens_equal=same_tokens, routing_flips=flips,
        rows_left_out=sorted(out),
        decode_storage_kept=sv["storage_kept"],
        prefill_block=sv["prefill_block"], decode_block=sv["decode_block"],
        prefill_ms=sv["prefill_ms"], decode_ms=sv["decode_ms"],
        serve_peak_mb=sv["peak_mb"]), ok


def _ma_rows(sv: dict, rows: tuple) -> dict:
    """``ma_serve``'s result cut to the batch rows ``rows`` (lo, hi): what
    a rank whose "data" coordinate holds those rows returns."""
    lo, hi = rows

    def cut(routes: list) -> list:
        return [{k: v[lo:hi] for k, v in r.items()} for r in routes]
    return dict(sv, prefill_logits=sv["prefill_logits"][lo:hi],
                decode_logits=[a[lo:hi] for a in sv["decode_logits"]],
                tokens=[a[lo:hi] for a in sv["tokens"]],
                prefill_routing=cut(sv["prefill_routing"]),
                decode_routing=[cut(r) for r in sv["decode_routing"]],
                rows=rows)


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    """The largest difference over the largest entry of ``b``."""
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) or 1.0)


def _l2_rel(a: np.ndarray, b: np.ndarray) -> float:
    """The norm of the difference over the norm of ``b``."""
    return float(np.linalg.norm(a - b)) / (float(np.linalg.norm(b)) or 1.0)


def phase_model_axis(torch) -> dict:
    """The model_axis phase: ``model_axis_run`` on two gloo ranks that
    share the card, a ("data" 1, "model" 2) mesh."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    reset_launch_counts()
    out = model_axis_run(torch, MA_MESH, "gloo")
    launches = launch_counts()
    log("model_axis", **out, launches=launches,
        seconds=round(time.perf_counter() - t_phase, 2))
    return {"launches": launches}


def model_axis_run(torch, shape: tuple, backend: str) -> dict:
    """The LM's 'model' axis as ``lm_rules`` lays it, on the ranks of a
    ``shape`` ("data", "model") mesh over ``backend`` (the model_axis
    phase: (1, 2), two gloo ranks on the card): OLMo-1B at its
    published widths, cut to ``MA_DEPTH`` layers (``ma_run``): two AdamW
    steps sequence-parallel (each 'model' rank its chunk of the 1,024
    positions, each "data" rank its rows, K/V gathered,
    weights gathered at use and their gradients reduce-scattered), a
    2 x 1,024 prefill (each rank's K/V chunk its cache block, the last
    token's logits on both), the cache regrown to ``MA_SLOTS`` slots split
    over 'model' and four greedy decode steps (the MLP and the vocab split
    over 'model', flash-decode over the cache's blocks, written in place).
    Then this process runs the same on one device: the losses and the
    prefill's logits within ``MA_RTOL`` (each logit's difference over the
    largest), the greedy tokens equal, the decode cache's storage
    unchanged on both; decode's logits within ``MA_RTOL`` in fp32, and in
    bf16 within ``MA_BF16_L2`` in norm (the difference's norm over the
    logits'): the tensor-parallel sums round bf16 elsewhere than one
    device, so the fp32 run carries the tight decode check. The first
    step's gradients in fp32 (``_ma_olmo_grads``), gathered whole: each
    within ``MA_GRAD_RTOL`` of its largest entry against one device's.
    Then olmoe at its published widths, depth 2, through the
    expert-parallel all-to-all on each rank's chunk of the sequence (fp32,
    2 x 128 tokens): at no-drop capacity the loss (rtol 1e-5) and every
    gradient (``MA_GRAD_RTOL``) against one device, and at capacity 1.25
    the kept share of picks of each source shard. Then olmoe served
    (``ma_serve`` at depth 2, no-drop capacity, 2 x ``MA_MOE_SEQ``): the
    prefill through the all-to-all, decode with each rank's experts only
    (64 / 'model' of the 64 a layer, the partial outputs summed over
    'model'), against
    one device as OLMo's serving is (the prefill too within
    ``MA_BF16_L2`` in bf16, and a row whose routing flips at a near tie
    in bf16 left out, ``_ma_flips``; in bf16 the prompt's 256 tokens
    route at enough near ties that decode is held against one device's
    decode from the rank's own prefill state, ``keep_state``/``start``);
    each rank's expert bytes and each decode step's expert widths and
    gathered bytes. Then MeshGraphNet at its
    published widths on ``MA_GNN_SHAPE``'s Cora geometry, its nodes and
    edges over the mesh (``ma_gnn``, ``_ma_gnn_rank``), each rank holding
    its block of the rows, in fp32 and in float64: step 0's fp32 loss and the
    float64 losses of step 0 and ``MA_GNN_STEPS`` AdamW steps within
    ``MA_GNN_LOSS_RTOL`` of one device's, step 0's float64 gradients each
    within ``MA_GRAD_RTOL`` of its leaf's largest entry of one device's
    (the fp32 gradients and the losses after fp32 updates reported: fp32
    rounding alone puts leaves of either side 1e-3 of their largest entry
    from the float64 run at these widths). Returns the fields of the
    phase's line."""
    from repro_torch.launch.mesh import spawn_ranks

    world = shape[0] * shape[1]
    cfgs = {"no_drop": _ma_moe_cfg(), "cf_1.25": _ma_moe_cfg(1.25)}
    vocab = cfgs["no_drop"].vocab
    moe_batch = _ma_batch(vocab, 0, MA_MOE_BATCH, MA_MOE_SEQ)
    t0 = time.perf_counter()
    olmo = _ma_cfg()
    gcfg, gspec = _ma_gnn_cfg()
    ranks = spawn_ranks(_ma_rank, world, (DEVICE, olmo, cfgs, moe_batch,
                                          (gcfg, gspec), shape),
                        backend=backend, timeout_s=900.0)
    ranks_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = ma_run(torch.device(DEVICE), olmo)
    one_s = time.perf_counter() - t0
    bad, out_ranks = [], []
    for r, res in enumerate(ranks):
        got = res["olmo"]["train"]
        loss_err = [abs(a - b) / abs(b) for a, b in
                    zip(got["losses"], one["train"]["losses"])]
        row = dict(rank=r, losses=got["losses"], loss_rel_err=loss_err,
                   train_step_ms=got["step_ms"],
                   train_peak_mb=got["peak_mb"])
        ok = max(loss_err) <= MA_RTOL
        for dt in MA_SERVE_DTYPES:
            sv = res["olmo"]["serve"][dt]
            row[dt], good = _ma_serve_check(
                sv, _ma_rows(one["serve"][dt], sv["rows"]), dt, MA_SEQ)
            ok &= good
        if not ok:
            bad.append(r)
        out_ranks.append(row)
    if bad:
        raise AssertionError(
            f"model_axis: ranks {bad} against one device (rtol {MA_RTOL}, "
            f"bf16 decode {MA_BF16_L2} in norm): {out_ranks}")
    # olmoe served, its experts split over 'model' in decode
    E = cfgs["no_drop"].moe.n_experts
    half = E // shape[1]
    moe_one = {dt: ma_serve(torch.device(DEVICE), dataclasses.replace(
        cfgs["no_drop"], dtype=dt), None, MA_MOE_BATCH, MA_MOE_SEQ,
        MA_MOE_SLOTS) for dt in MA_SERVE_DTYPES}
    moe_rows = []
    for r, res in enumerate(ranks):
        row, ok = dict(rank=r), True
        for dt in MA_SERVE_DTYPES:
            sv = res["olmoe_serve"][dt]
            cfg_dt = dataclasses.replace(cfgs["no_drop"], dtype=dt)
            if dt == "bfloat16":
                # the prompt's 256 tokens route at many near ties, and a
                # bf16 flip there moves a row's state: decode is held
                # against one device's decode from this rank's prefill
                # state (its whole cache and last logits)
                row[dt], good = _ma_serve_check(
                    sv, _ma_rows(moe_one[dt], sv["rows"]), dt, MA_MOE_SEQ,
                    bf16_prefill=True, decode=False)
                cont = ma_serve(torch.device(DEVICE), cfg_dt, None,
                                sv["rows"][1] - sv["rows"][0], MA_MOE_SEQ,
                                MA_MOE_SLOTS, start=sv["state"])
                dec, good_dec = _ma_serve_check(sv, cont, dt, MA_MOE_SEQ,
                                                prefill=False)
                good &= good_dec
                row[dt].update({k: dec[k] for k in (
                    "decode_logit_rel_err", "decode_logit_l2_rel_err",
                    "decode_logits_differing", "greedy_tokens_equal")},
                    decode_routing_flips=dec["routing_flips"],
                    decode_rows_left_out=dec["rows_left_out"],
                    decode_against="one device from this rank's prefill "
                                   "state")
            else:
                row[dt], good = _ma_serve_check(
                    sv, _ma_rows(moe_one[dt], sv["rows"]), dt, MA_MOE_SEQ)
            widths = sv["decode_expert_widths"]
            row[dt].update(expert_bytes_held=sv["expert_bytes_held"],
                           one_device_expert_bytes=moe_one[dt][
                               "expert_bytes_held"],
                           decode_expert_widths=widths,
                           decode_gathered_bytes=sv["decode_gathered_bytes"],
                           one_device_decode_ms=moe_one[dt]["decode_ms"])
            ok &= good and all(w == [half] * cfgs["no_drop"].n_layers
                               for w in widths)
        if not ok:
            bad.append(r)
        moe_rows.append(row)
    if bad:
        raise AssertionError(
            f"model_axis: olmoe served with its experts split over 'model', "
            f"ranks {bad} against one device (fp32 rtol {MA_RTOL}, bf16 "
            f"{MA_BF16_L2} in norm, {half} experts a layer): {moe_rows}")
    # MeshGraphNet's nodes and edges over the mesh
    gnn_res = [res["gnn"] for res in ranks]
    g0 = gnn_res[0]
    n_rows = -(-gspec["n_nodes"] // world), -(-gspec["n_edges"] // world)
    if not (g0["loss_rel_err"][0] <= MA_GNN_LOSS_RTOL
            and max(g0["loss64_rel_err"]) <= MA_GNN_LOSS_RTOL
            and g0["grad64_rel_err_max"] <= MA_GRAD_RTOL
            and all((g["block_rows"]["nodes"], g["block_rows"]["edges"])
                    == n_rows for g in gnn_res)):
        raise AssertionError(f"model_axis: MeshGraphNet partitioned over "
                             f"the mesh against one device: {gnn_res}")
    grads = ranks[0]["olmo_grads"]
    if not (math.isclose(grads["loss"], grads["ref_loss"], rel_tol=1e-5)
            and grads["grad_rel_err_max"] < MA_GRAD_RTOL):
        raise AssertionError(f"model_axis: OLMo's fp32 gradients on the "
                             f"mesh against one device: {grads}")
    res = [r["olmoe"] for r in ranks]
    nd = res[0]["no_drop"]
    if not (all(r[k]["a2a_calls"] > 0 for r in res for k in r)
            and math.isclose(nd["loss"], nd["ref_loss"], rel_tol=1e-5)
            and nd["grad_rel_err_max"] < MA_GRAD_RTOL):
        raise AssertionError(f"model_axis: the all-to-all MoE against one "
                             f"device: {res}")
    cfg = cfgs["no_drop"]
    from repro_torch.configs import get_arch
    return dict(
        arch=MA_ARCH, depth=olmo.n_layers,
        depth_cut=f"{olmo.n_layers} of {get_arch(MA_ARCH).config().n_layers}"
        " layers, for time", d_model=olmo.d_model, d_ff=olmo.d_ff,
        vocab=olmo.vocab, dtype=olmo.dtype,
        mesh=dict(zip(("data", "model"), shape)),
        backend=ranks_backend(ranks, "model_axis"),
        rank_devices=[r["device"] for r in ranks], batch=MA_BATCH,
        seq=MA_SEQ, steps=MA_STEPS,
        decode_steps=MA_DECODE, cache_slots=MA_SLOTS, rtol=MA_RTOL,
        bf16_decode_l2=MA_BF16_L2,
        ranks=out_ranks,
        one_device=dict(losses=one["train"]["losses"],
                        train_step_ms=one["train"]["step_ms"],
                        train_peak_mb=one["train"]["peak_mb"],
                        serve={dt: dict(
                            prefill_ms=sv["prefill_ms"],
                            decode_ms=sv["decode_ms"],
                            serve_peak_mb=sv["peak_mb"],
                            tokens=[t.flatten().tolist()
                                    for t in sv["tokens"]])
                            for dt, sv in one["serve"].items()},
                        seconds=round(one_s, 2)),
        olmo_fp32_grads=dict(
            loss=grads["loss"], one_device_loss=grads["ref_loss"],
            leaves=grads["leaves"],
            grad_rel_err_max=grads["grad_rel_err_max"],
            grad_rel_err=grads["grad_rel_err"],
            tolerance=dict(loss_rtol=1e-5, grad_err_over_max=MA_GRAD_RTOL),
            fwd_bwd_ms_rank0=grads["fwd_bwd_ms"]),
        olmoe_a2a=dict(
            depth=cfg.n_layers, d_model=cfg.d_model,
            experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
            batch=MA_MOE_BATCH, seq=MA_MOE_SEQ,
            no_drop_capacity_factor=cfg.moe.capacity_factor,
            loss=round(nd["loss"], 6), one_device_loss=round(nd["ref_loss"],
                                                             6),
            grad_rel_err_max=nd["grad_rel_err_max"], tolerance=dict(
                loss_rtol=1e-5, grad_err_over_max=MA_GRAD_RTOL),
            a2a_calls=[r["no_drop"]["a2a_calls"] for r in res],
            fwd_bwd_ms=[r["no_drop"]["fwd_bwd_ms"] for r in res],
            cf_1_25=dict(loss=round(res[0]["cf_1.25"]["loss"], 6),
                         kept=[[round(k, 4) for k in r["cf_1.25"]["kept"]]
                               for r in res],
                         fwd_bwd_ms=[r["cf_1.25"]["fwd_bwd_ms"]
                                     for r in res]),
            rank_peak_mb=[r["cf_1.25"]["peak_mb"] for r in res]),
        olmoe_decode_split=dict(
            depth=cfg.n_layers, experts=E, experts_a_rank=half,
            batch=MA_MOE_BATCH, seq=MA_MOE_SEQ, cache_slots=MA_MOE_SLOTS,
            capacity_factor=cfg.moe.capacity_factor,
            tolerance=dict(fp32_rtol=MA_RTOL, bf16_l2=MA_BF16_L2),
            ranks=moe_rows,
            one_device={dt: dict(prefill_ms=sv["prefill_ms"],
                                 decode_ms=sv["decode_ms"],
                                 serve_peak_mb=sv["peak_mb"],
                                 tokens=[t.flatten().tolist()
                                         for t in sv["tokens"]])
                        for dt, sv in moe_one.items()}),
        meshgraphnet=dict(
            shape=MA_GNN_SHAPE, n_nodes=gspec["n_nodes"],
            n_edges=gspec["n_edges"], d_feat=gspec["d_feat"],
            layers=gcfg.n_layers, d_hidden=gcfg.d_hidden, dtype=gcfg.dtype,
            steps=MA_GNN_STEPS, tolerance=dict(
                fp32_step0_loss_rtol=MA_GNN_LOSS_RTOL,
                float64_loss_rtol=MA_GNN_LOSS_RTOL,
                float64_grad_err_over_max=MA_GRAD_RTOL),
            ranks=[{k: v for k, v in g.items() if not isinstance(v, list)
                    or k in ("losses", "step_ms", "loss_rel_err",
                             "loss64_rel_err")}
                   for g in gnn_res],
            **{k: g0[k] for k in (
                "grad64_rel_err", "grad_rel_err", "fp32_mesh_vs_float64",
                "fp32_one_device_vs_float64")}),
        ranks_s=round(ranks_s, 2))


# ---------------------------------------------------------------------------
# nccl: the meshes across four cards, one rank a card
# ---------------------------------------------------------------------------

NC_WORLD = 4
NC_LAYERS = 16              # OLMo-1B whole (TS_LAYERS cuts it for gloo)
NC_RESUME_RTOL = 1e-4       # the resumed run against one device's
NC_MESH = (2, 2)            # model_axis's ranks: both axes cross cards
NC_BW_BYTES = 1 << 30       # the all-gather's output: 1 GiB of bf16
NC_BW_REPS = 20
NVLINK_BYTES_S = 450e9      # each way (the hopper-kernels guide's table)
NC_FULL_M = 4096            # the launcher at MS MARCO's full m
NC_FULL_PARTS = 16          # make_corpus_fast's parallel blocks there
NC_FULL_BATCHES = 8


def _nccl_bw_rank(rank: int, device_type: str, n_bytes: int,
                  reps: int) -> dict:
    """One rank of an all-gather of ``n_bytes`` of bf16 (each rank's
    block ``n_bytes / world``), timed on the host clock to a synchronize
    over ``reps`` after three warm-up calls; the result checked block by
    block."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import rank_device
    dev = rank_device(rank, device_type)
    n = dist.get_world_size()
    x = torch.full((n_bytes // 2 // n,), rank, dtype=torch.bfloat16,
                   device=dev)
    out = torch.empty(n_bytes // 2, dtype=torch.bfloat16, device=dev)
    for _ in range(3):
        dist.all_gather_into_tensor(out, x)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        dist.all_gather_into_tensor(out, x)
    _sync(dev)
    ms = (time.perf_counter() - t0) / reps * 1e3
    blocks = out.view(n, -1)
    ok = bool(torch.equal(blocks, torch.arange(n, device=dev).to(
        torch.bfloat16)[:, None].expand_as(blocks)))
    return dict(rank=rank, device=str(dev), backend=dist.get_backend(),
                ms=ms, ok=ok)


def one_device_ms(index, batches) -> dict:
    """Each of ``dist_batches``' batches served by ``retrieve`` on one
    device, as a rank times its own (a warm-up 64- and 2-query batch,
    then each batch on the host clock to a synchronize)."""
    import torch

    from repro_torch.core.search import SearchConfig, retrieve
    dev = torch.device(DEVICE)
    for name, q, kw in batches:
        if name in ("b0", "q2"):
            retrieve(index, q, SearchConfig(**kw), device=DEVICE)
    out = {}
    for name, q, kw in batches:
        _sync(dev)
        t0 = time.perf_counter()
        retrieve(index, q, SearchConfig(**kw), device=DEVICE)
        _sync(dev)
        out[name] = round((time.perf_counter() - t0) * 1e3, 3)
    return out


def _own_cards(ranks: list, what: str) -> list:
    """The ranks' devices, each rank on a card of its own (rank r on
    cuda:r)."""
    got = [r["device"] for r in ranks]
    if got != [f"cuda:{i}" for i in range(len(ranks))]:
        raise AssertionError(f"{what}: the ranks sat on {got}")
    return got


def phase_nccl(geo, index, queries, saved, torch) -> dict | None:
    """The port's meshes across ``NC_WORLD`` cards over nccl, rank r on
    cuda:r (on a machine with fewer cards: a line saying so, nothing
    held). Sharded retrieval (``_dist_rank``) on the (2, 2) mesh over
    nccl: every batch of ``dist_batches`` equal to the one-process
    kernel-path merge bit for bit and audited against the plain path
    (``dist_check``), K1, the planner and K2 (K4 on the 2-query batch)
    launched on every card; the same ranks over gloo on one card, equal
    to the nccl ranks bit for bit; rank 0's batch ms of both beside one
    device's, timed in turns (one device, nccl, gloo, one device); the
    launcher's ``--devices 4`` on the saved world (``4 ranks over nccl
    on 4 card(s)``). Then an all-gather of 1 GiB of bf16 over the four
    cards, timed (bus bandwidth against NVLink's 450 GB/s each way);
    ``model_axis_run`` on the (2, 2) mesh over nccl (OLMo-1B at
    ``MA_DEPTH``, olmoe's all-to-all and split-expert decode,
    MeshGraphNet on Cora) at the model_axis phase's tolerances; OLMo-1B
    at all 16 layers through the training launcher's ``--devices 4``
    ((4, 1), FSDP over nccl; ``ts_olmo``): the mesh's losses within
    ``TS_LOSS_RTOL`` of one device's, the step-4 checkpoint resumed on
    one device within ``NC_RESUME_RTOL`` of the uninterrupted run, step
    ms, MFU and each card's memory; and DLRM's 53.25 GB table
    row-sharded over the four cards (``ts_dlrm``). Each part prints its
    line as it ends, then the ``nccl`` line sums them up. Any failure, of
    nccl's init or a collective too, fails the phase; nothing is retried
    over gloo."""
    import tempfile

    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.serving.engine import stage_index

    cards = torch.cuda.device_count()
    if cards < NC_WORLD:
        log("nccl", ran=False, cards=cards,
            reason=f"needs {NC_WORLD} cards, one a rank (nccl never puts "
                   f"two ranks on one card); this machine has {cards}")
        return None
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    # sharded retrieval: one device, nccl on four cards, gloo on one card,
    # one device again
    batches = dist_batches(geo, queries)
    arrays = dist_arrays(batches)
    one_ms = [one_device_ms(index, batches)]
    with tempfile.TemporaryDirectory() as staged:
        stage_index(index, staged)
        t0 = time.perf_counter()
        over_nccl = spawn_ranks(_dist_rank, NC_WORLD,
                                (staged, arrays, DEVICE), backend="nccl",
                                timeout_s=600)
        nccl_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_one = spawn_ranks(_dist_rank, NC_WORLD,
                             (staged, arrays, DEVICE, 1), backend="gloo",
                             timeout_s=600)
        gloo_s = time.perf_counter() - t0
    one_ms.append(one_device_ms(index, batches))
    if ranks_backend(over_nccl, "nccl dist") != "nccl" \
            or ranks_backend(on_one, "gloo dist") != "gloo":
        raise AssertionError("nccl dist: the ranks ran over another backend")
    devices = _own_cards(over_nccl, "nccl dist")
    if {r["device"] for r in on_one} != {"cuda:0"}:
        raise AssertionError(f"nccl dist: the gloo ranks sat on "
                             f"{[r['device'] for r in on_one]}")
    held, flips, launches = dist_check(index, batches, over_nccl,
                                       "nccl dist")
    for i, (name, _, _) in enumerate(batches):
        for f, v in over_nccl[0]["batches"][i]["fields"].items():
            if not np.array_equal(v, on_one[0]["batches"][i]["fields"][f]):
                raise AssertionError(f"nccl dist {name}: {f} over nccl "
                                     f"differs from gloo on one card")
    cli = dist_cli(index, saved, "nccl", torch)
    out = {}
    out["dist"] = part = dict(
        mesh={"data": DIST_SHAPE[0], "model": DIST_SHAPE[1]},
        rank_devices=devices, held=held, counter_flips_vs_plain=flips,
        equal_to_gloo_on_one_card=True,
        batch_ms_rank0={"nccl": {b["name"]: round(b["ms"], 3)
                                 for b in over_nccl[0]["batches"]},
                        "gloo_one_card": {b["name"]: round(b["ms"], 3)
                                          for b in on_one[0]["batches"]},
                        "one_device": one_ms},
        peak_mb={"nccl": [round(r["peak_mb"], 1) for r in over_nccl],
                 "gloo_one_card": [round(r["peak_mb"], 1) for r in on_one]},
        setup_s=[round(r["setup_s"], 2) for r in over_nccl],
        ranks_s={"nccl": round(nccl_s, 2), "gloo_one_card": round(gloo_s, 2)},
        launches=launches, **cli)
    # each part's line as it ends: a later part's failure keeps them
    log("nccl_dist", **part)

    bw = spawn_ranks(_nccl_bw_rank, NC_WORLD,
                     (DEVICE, NC_BW_BYTES, NC_BW_REPS), backend="nccl",
                     timeout_s=300)
    if not all(r["ok"] for r in bw):
        raise AssertionError(f"nccl all-gather: {bw}")
    ms = max(r["ms"] for r in bw)
    bus = NC_BW_BYTES * (NC_WORLD - 1) / NC_WORLD / (ms / 1e3)
    out["all_gather"] = part = dict(
        bytes=NC_BW_BYTES, dtype="bfloat16", reps=NC_BW_REPS,
        rank_devices=_own_cards(bw, "nccl all-gather"),
        ms=[round(r["ms"], 4) for r in bw],
        alg_gb_s=round(NC_BW_BYTES / (ms / 1e3) / 1e9, 1),
        bus_gb_s=round(bus / 1e9, 1),
        nvlink_each_way_gb_s=NVLINK_BYTES_S / 1e9,
        bus_share_of_nvlink=round(bus / NVLINK_BYTES_S, 3))
    log("nccl_all_gather", **part)

    torch.cuda.empty_cache()
    out["model_axis"] = ma = model_axis_run(torch, NC_MESH, "nccl")
    if ma["backend"] != "nccl" or ma["rank_devices"] != [
            f"cuda:{i}" for i in range(NC_WORLD)]:
        raise AssertionError(f"nccl model_axis: {ma['backend']} on "
                             f"{ma['rank_devices']}")
    log("nccl_model_axis", **ma)
    torch.cuda.empty_cache()
    olmo = ts_olmo(torch, NC_LAYERS, NC_WORLD, NC_RESUME_RTOL)
    if olmo["backend"] != "nccl" or olmo["cards_used"] != list(
            range(NC_WORLD)):
        raise AssertionError(f"nccl train: {olmo['launcher_line']}, cards "
                             f"used {olmo['cards_used']}")
    # one rank a card: each card's gain is its rank's
    olmo["rank_used_mb"] = olmo["card_gained_mb"][:NC_WORLD]
    out["train"] = olmo
    log("nccl_train", **olmo)
    out["dlrm_lookup"] = dl = ts_dlrm(torch, NC_WORLD, "nccl")
    _own_cards(dl["ranks"], "nccl dlrm lookup")
    log("nccl_dlrm", **dl)
    d, t = out["dist"], out["train"]
    log("nccl", ran=True, cards=cards, ranks=NC_WORLD,
        dist=dict(mesh=d["mesh"], rank_devices=d["rank_devices"],
                  held_bit_for_bit=d["held"],
                  audited_against_plain=d["held"],
                  counter_flips_vs_plain=d["counter_flips_vs_plain"],
                  equal_to_gloo_on_one_card=True, launches=d["launches"],
                  batch_ms_rank0=d["batch_ms_rank0"],
                  launcher=d["cli"]),
        all_gather_bus_gb_s=out["all_gather"]["bus_gb_s"],
        train=dict(layers=t["layers"], mesh=t["mesh"], backend=t["backend"],
                   cards_used=t["cards_used"], loss_rel_err=t["loss_rel_err"],
                   loss_rtol=t["loss_rtol"],
                   resumed_rel_err=t["resumed_rel_err"],
                   resume_rtol=t["resume_rtol"],
                   step_ms_median=t["step_ms_median"], mfu=t["mfu"],
                   rank_used_mb=t["rank_used_mb"]),
        dlrm_lookup_ms=[r["lookup_ms"] for r in dl["ranks"]],
        model_axis=dict(
            mesh=ma["mesh"], rank_devices=ma["rank_devices"],
            olmo_loss_rel_err=[r["loss_rel_err"] for r in ma["ranks"]],
            olmo_fp32_grad_rel_err_max=ma["olmo_fp32_grads"][
                "grad_rel_err_max"],
            olmoe_a2a_grad_rel_err_max=ma["olmoe_a2a"]["grad_rel_err_max"],
            meshgraphnet_grad64_rel_err_max=max(
                ma["meshgraphnet"]["grad64_rel_err"])),
        seconds=round(time.perf_counter() - t_phase, 2))
    return {"launches": launches}


def phase_nccl_full(torch) -> None:
    """The serving launcher at MS MARCO's full m (``NC_FULL_M`` = 4,096
    clusters, about 8.8M docs) over nccl on four cards: the world drawn
    (``make_corpus_fast`` in ``NC_FULL_PARTS`` blocks) and built on the
    card, saved, and served by ``python -m repro_torch.launch.serve
    --devices 4 --load-dir`` (two cluster shards of m / 2, two query
    halves): exit 0, its mesh, ``4 ranks over nccl on 4 card(s)``, the
    summary and funnel lines; each card's used memory (polled) while it
    ran; one device's batch ms on the same index beside it (64-query
    batches of the world's own queries)."""
    import tempfile
    import threading

    from repro_torch.lifecycle import save_index

    cards = torch.cuda.device_count()
    if cards < NC_WORLD:
        raise AssertionError(f"nccl_full: needs {NC_WORLD} cards, one a "
                             f"rank; this machine has {cards}")
    t_phase = time.perf_counter()
    geo, index, queries, docs, _ = scale_world(NC_FULL_M, NC_FULL_PARTS)
    del docs
    batches = [b for b in dist_batches(geo, queries) if b[0] != "safe"]
    one_ms = one_device_ms(index, batches)
    log("nccl_full_one_device", m=NC_FULL_M, batch_ms=one_ms)
    with tempfile.TemporaryDirectory() as tmp:
        saved = os.path.join(tmp, "index")
        t0 = time.perf_counter()
        save_index(saved, index, epoch=0)
        save_s = time.perf_counter() - t0
        vocab, index_mb = index.vocab, index.nbytes() / 1e6
        del index
        torch.cuda.empty_cache()
        stop, card = threading.Event(), []
        before = _card_memory_mb()
        poll = threading.Thread(target=_card_memory_mb, args=(stop, card),
                                daemon=True)
        poll.start()
        t0 = time.perf_counter()
        try:
            run = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.serve",
                 "--device", DEVICE, "--devices", str(NC_WORLD),
                 "--load-dir", saved, "--vocab", str(vocab), "--n-docs",
                 "2000", "--batch-size", "64", "--batches",
                 str(NC_FULL_BATCHES), "--metrics-json",
                 os.path.join(tmp, "m.json")],
                env={**os.environ, "PYTHONPATH": str(SRC)}, cwd=tmp,
                capture_output=True, text=True, timeout=1500)
        finally:
            stop.set()
            poll.join()
        cli_s = time.perf_counter() - t0
    out = run.stdout
    if run.returncode != 0:
        raise AssertionError(f"nccl_full: exit code {run.returncode}:\n"
                             f"{out}{run.stderr[-3000:]}")
    for want in ("[serve] sharded over {'data': 2, 'model': 2}",
                 f"[serve] {NC_WORLD} ranks over nccl on {cards} card(s)",
                 f"[serve] {64 * NC_FULL_BATCHES} queries in "
                 f"{NC_FULL_BATCHES} batches", "[serve] funnel"):
        if want not in out:
            raise AssertionError(f"nccl_full: no {want!r} line:\n{out}")
    peak = ([max(c[i] for c in card) for i in range(len(card[0]))]
            if card else None)
    log("nccl_full", m=NC_FULL_M, n_docs=NC_FULL_M * DOCS_PER_CLUSTER,
        index_mb=round(index_mb, 1), shards=DIST_SHAPE[0],
        save_s=round(save_s, 1), launcher_s=round(cli_s, 1),
        lines=[ln for ln in out.splitlines() if ln.startswith("[serve]")],
        one_device_batch_ms=one_ms, card_used_mb_before=before,
        card_used_mb_max=peak,
        seconds=round(time.perf_counter() - t_phase, 1))


# ---------------------------------------------------------------------------
# examples: the root quickstart and serving examples on the card
# ---------------------------------------------------------------------------

def phase_examples(torch) -> dict:
    """``repro_torch.examples.quickstart`` and ``serve_retrieval`` on the
    card: stage by stage in this process (counts zeroed before their
    searches, read after: the planner and K2 must launch; rank-safe ASC's
    recall@10 must be 1.000), every result replayed against the on-card
    plain path (``check_audited``; each served batch first replayed on
    the kernel path, bit for bit), safe mode against brute force; then
    each example as ``python -m`` with no flag: exit 0, the reference's
    lines."""
    from repro_torch.core.search import (asc_retrieve, brute_force_topk,
                                         retrieve)
    from repro_torch.examples import quickstart as qs
    from repro_torch.examples import serve_retrieval as sr
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.tools.plain_path import plain_versions, swapped_wrappers

    t_phase = time.perf_counter()
    q_lines: list[str] = []
    s_lines: list[str] = []
    docs, queries = qs.corpus(log=q_lines.append)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = qs.index(docs, qs.cluster(docs, torch.Generator().manual_seed(0),
                                    DEVICE), DEVICE, log=q_lines.append)
    torch.cuda.synchronize()
    qs_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx2, doc_topic = sr.build(torch.Generator().manual_seed(0), DEVICE)
    torch.cuda.synchronize()
    sr_build_s = time.perf_counter() - t0

    k_log: list = []
    reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_decisions(k_log):
        res = qs.retrieve_all(idx, queries, DEVICE, log=q_lines.append)
    torch.cuda.synchronize()
    qs_ms = (time.perf_counter() - t0) * 1e3
    eng, unbudgeted = sr.serve_unbudgeted(idx2, doc_topic, DEVICE,
                                          log=s_lines.append)
    budgeted = sr.serve_budgeted(idx2, doc_topic, eng.stats.mean_ms, DEVICE,
                                 log=s_lines.append)
    launches = launch_counts()
    missing = [k for k in ("plan_wave", "score_queue") if launches[k] == 0]
    if missing:
        raise AssertionError(f"examples: the serving launched no {missing}")
    if res["recall"][1.0, 1.0] != 1.0:
        raise AssertionError(f"examples: rank-safe recall@10 is "
                             f"{res['recall'][1.0, 1.0]}")
    if len(k_log) != len(qs.SETTINGS):
        raise AssertionError(f"examples: {len(k_log)} batched walks")

    rows = [[(0, r)] for r in range(queries.n_queries)]
    flips = []
    for walk, (key, out) in zip(k_log, res["asc"].items()):
        p_log: list = []
        with swapped_wrappers(plain_versions), recorded_decisions(p_log):
            plain = asc_retrieve(idx, queries, k=qs.K, mu=key[0], eta=key[1],
                                 device=DEVICE)
        flips += check_audited(out, plain, [walk], p_log, rows,
                               f"examples: quickstart (mu, eta) = {key}")
    oracle = brute_force_topk(idx, queries, qs.K, device=DEVICE)
    safe = res["asc"][1.0, 1.0]
    check_topk(oracle.doc_ids.cpu(), oracle.scores.cpu(),
               safe.doc_ids.cpu(), safe.scores.cpu(),
               "examples: quickstart safe mode vs brute force")
    for j, bt in enumerate(unbudgeted + budgeted):
        budget = idx2.m + 1 if bt["budget"] is None else bt["budget"]
        k_walk, p_walk = [], []
        with recorded_decisions(k_walk):
            again = retrieve(idx2, bt["queries"], sr.CFG, budget=budget,
                             device=DEVICE)
        check_identical(again, bt["out"], f"examples: serve batch {j}, "
                        f"kernel replay")
        with swapped_wrappers(plain_versions), recorded_decisions(p_walk):
            plain = retrieve(idx2, bt["queries"], sr.CFG, budget=budget,
                             device=DEVICE)
        flips += check_audited(again, plain, k_walk, p_walk, rows,
                               f"examples: serve batch {j} (budget "
                               f"{budget})")

    runs = {}
    for name in ("quickstart", "serve_retrieval"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"repro_torch.examples.{name}"],
            capture_output=True, text=True, cwd=ROOT, timeout=300,
            env={**os.environ, "PYTHONPATH": str(SRC)})
        if proc.returncode != 0:
            raise AssertionError(f"examples: {name} exited "
                                 f"{proc.returncode}:\n{proc.stderr[-3000:]}")
        runs[name] = dict(seconds=round(time.perf_counter() - t0, 2),
                          lines=proc.stdout.splitlines())
    q_run = runs["quickstart"]["lines"]
    if len(q_run) != 7 or "recall@10=1.000" not in q_run[2] or len(
            runs["serve_retrieval"]["lines"]) != 13:
        raise AssertionError(f"examples: the runs printed {runs}")
    log("examples", quickstart=dict(
            lines=q_lines, build_s=round(qs_build_s, 3),
            serve_ms=round(qs_ms, 3), m=qs.M, n_seg=qs.N_SEG,
            d_pad=qs.D_PAD, vocab=qs.SPEC.vocab,
            queries=queries.n_queries),
        serve_retrieval=dict(
            lines=s_lines, build_s=round(sr_build_s, 3),
            batches=len(unbudgeted) + len(budgeted),
            budgets=[bt["budget"] for bt in budgeted],
            mean_ms_per_query=round(eng.stats.mean_ms, 4)),
        counter_flips=flips, launches=launches, subprocess=runs,
        seconds=round(time.perf_counter() - t_phase, 2))
    return {"launches": launches}


# dryrun phase: a subset of the dry-run on meta (one cell an arch, and
# each cell the card runs), the memory model's two training cells, the
# retrieval cell's shards
DR_CELLS = (
    ("asc-splade", "serve_k10", "single"), ("asc-splade", "serve_k10",
                                            "multi"),
    ("bert4rec", "serve_p99", "single"), ("deepfm", "serve_p99", "single"),
    ("din", "serve_p99", "single"),
    ("dlrm-mlperf", "train_batch", "single"),
    ("llama4-scout-17b-a16e", "decode_32k", "single"),
    ("meshgraphnet", "molecule", "single"),
    ("meshgraphnet", "ogb_products", "single"),
    ("olmo-1b", "decode_32k", "single"), ("olmo-1b", "train_4k", "multi"),
    ("olmoe-1b-7b", "decode_32k", "single"),
    ("qwen3-14b", "decode_32k", "single"),
    ("stablelm-3b", "decode_32k", "single"))
# the memory model's cells, each arch's first that its record says fits
# (a candidate outside DR_CELLS gets its meta record here)
DR_TRAIN = {"olmo-1b": (("train_4k", "multi"), ("train_4k", "single")),
            "dlrm-mlperf": (("train_batch", "single"),
                            ("train_batch", "multi")),
            # the graph partitioned: 4,258.8 GiB a rank whole
            "meshgraphnet": (("ogb_products", "single"),)}
DR_FIT_BYTES = 70e9
# the serving cells the memory model runs on the card at their production
# blocks (the decode cache's sequence over 'model'; olmoe's experts too)
DR_SERVE = (("olmo-1b", "decode_32k", "single"),
            ("olmoe-1b-7b", "decode_32k", "single"))
# predicted peak against the card's: 10% or 512 MiB, whichever is larger
DR_REL, DR_ABS = 0.10, 512 * 2 ** 20
DR_RETRIEVAL = ("asc-splade", "serve_k10")
DR_STEPS = 1


def _predicted(rec: dict) -> int:
    mem = rec["memory"]
    return mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]


def _checked(rec: dict, what: str) -> dict:
    if rec["status"] != "ok":
        raise AssertionError(f"dryrun: {what} failed: {rec['error']}\n"
                             f"{rec.get('traceback', '')}")
    return rec


def gc_collect(torch) -> None:
    """Collect Python's garbage and return the cache to the card, so the
    next allocation peak starts from live tensors alone."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def production_shard(index, n: int, torch):
    """Rank 0's shard of a retrieval cell from the scale world: its first
    ``n`` clusters (the fine fields at the production per-rank shapes:
    m = 4096 over 16 or 32 cluster shards) copied so the shard owns its
    memory, and the replicated coarse tables zero-filled at the production
    geometry (S = 64 superblocks of 64: the distributed path is
    single-level and never reads them)."""
    from repro_torch.configs.asc_splade import config
    from repro_torch.core.types import INDEX_FIELDS, ClusterIndex
    from repro_torch.launch.cells import coarse_geometry
    S, cap = coarse_geometry(config().m)
    coarse = {"super_members": torch.full((S, cap), -1, dtype=torch.int32,
                                          device=DEVICE),
              "super_max_stacked": torch.zeros(
                  (S, index.n_seg + 1, index.vocab), dtype=torch.uint8,
                  device=DEVICE)}
    fields = {f: coarse[f] if f in coarse else (
        getattr(index, f).clone() if f == "scale"
        else getattr(index, f)[:n].clone()) for f in INDEX_FIELDS}
    return ClusterIndex(**fields, vocab=index.vocab, n_seg=index.n_seg)


def memory_check(meta: dict, torch) -> dict:
    """The memory model on the card for ``meta``'s cell: built on meta and
    sharded there, only rank 0's blocks drawn on the card, one step under
    the production mesh's fake group; the predicted peak (meta: arguments
    + temp) within 10% or 512 MiB of ``max_memory_allocated`` over the
    card's allocation before, FLOPs and collectives equal to the meta
    record's; then the step again, timed (rank 0's compute: the fake
    collectives move nothing)."""
    from repro_torch.launch import dryrun
    arch, shape, mk = meta["arch"], meta["shape"], meta["mesh"]
    gc_collect(torch)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    card = _checked(dryrun.run_cell(arch, shape, mk, save=False,
                                    device=DEVICE, repeat=DR_STEPS),
                    f"{arch} {shape} {mk} on the card")
    measured = torch.cuda.max_memory_allocated() - base
    pred = _predicted(meta)
    tol = max(DR_REL * measured, DR_ABS)
    row = dict(arch=arch, shape=shape, mesh=mk, mode=meta["mode"],
               predicted_bytes=pred, measured_bytes=measured,
               rel_err=(pred - measured) / measured, tol_bytes=tol,
               argument_bytes=meta["memory"]["argument_size_in_bytes"],
               temp_bytes=meta["memory"]["temp_size_in_bytes"],
               card_tracker_temp_bytes=card["memory"]["temp_size_in_bytes"],
               flops=card["flops"],
               rank0_compute_ms_no_communication=card["step_ms"],
               build_s=card["build_s"])
    if abs(pred - measured) > tol:
        raise AssertionError(f"dryrun: {arch} {shape} {mk}: predicted "
                             f"{pred} B, the card peaked at {measured} B: "
                             f"{row}")
    for key in ("flops", "collectives"):
        if card[key] != meta[key]:
            raise AssertionError(f"dryrun: {arch} {shape} {mk}: {key} on "
                                 f"the card {card[key]} != meta "
                                 f"{meta[key]}")
    del card
    gc_collect(torch)
    return row


def phase_dryrun(index, torch) -> dict:
    """The production dry-run (``repro_torch.launch.dryrun``).

    (a) torch's fake process group on this torch: one collective on a
    card tensor. (b) ``python -m repro_torch.launch.dryrun`` on meta for
    ``DR_CELLS`` (a subprocess; every record ok). (c) The memory model on
    the card: each ``DR_TRAIN`` cell (and ``DR_SERVE`` cell), built on
    meta and sharded there, with
    only rank 0's blocks made real on the card, runs one step under the
    same fake group: its predicted peak (meta: arguments + temp) within
    10% or 512 MiB of ``max_memory_allocated`` over the card's allocation
    before, FLOPs and collectives equal to the meta record's; then the
    step again, timed (rank 0's compute, no communication). (d) The
    retrieval cell on each mesh on a real shard (``production_shard``),
    counts zeroed before and read after: K1, the planner and K2 launch;
    every kernel call held against its plain version (``hold_kernels``);
    arguments and collectives equal the shard-less record's. (e)
    ``python -m repro_torch.examples.multipod_launch`` (run beside (b):
    both are host-only): its numbers equal its record's."""
    import tempfile

    import torch.distributed as dist
    from torch.testing._internal.distributed import fake_pg  # noqa: F401

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world

    t_phase = time.perf_counter()
    if dist.is_initialized():
        raise AssertionError("dryrun: a process group is already joined")
    # (a), and whether CommDebugMode sees a raw collective on this torch
    from torch.distributed.tensor.debug import CommDebugMode
    with fake_world(4):
        x = torch.ones(8, device=DEVICE)
        comm = CommDebugMode()
        with comm:
            dist.all_reduce(x)
        torch.cuda.synchronize()
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    # (b), with (e)'s subprocess beside it: both run on the host alone
    example = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.examples.multipod_launch"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env=env)
    with tempfile.TemporaryDirectory() as out_dir:
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--force",
                "--out-dir", out_dir]
        for cell in DR_CELLS:
            argv += ["--cell", *cell]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(argv, capture_output=True, text=True,
                                  cwd=ROOT, timeout=600, env=env)
            ex_out, ex_err = example.communicate(timeout=300)
        finally:
            if example.poll() is None:
                example.kill()
                example.wait()
        meta_s = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or lines[-1] != (
                f"done: ok={len(DR_CELLS)} fail=0 skipped=0"):
            raise AssertionError(f"dryrun: the meta run exited "
                                 f"{proc.returncode}:\n{proc.stdout}\n"
                                 f"{proc.stderr[-3000:]}")
        recs = {}
        for a, s, mk in DR_CELLS:
            with open(os.path.join(out_dir, f"{a}__{s}__{mk}.json")) as f:
                recs[a, s, mk] = _checked(json.load(f), f"{a} {s} {mk}")

    # (c)
    memory = []
    for arch, cands in DR_TRAIN.items():
        for shape, mk in cands:
            if (arch, shape, mk) not in recs:
                recs[arch, shape, mk] = _checked(
                    dryrun.run_cell(arch, shape, mk, save=False),
                    f"{arch} {shape} {mk}")
            if _predicted(recs[arch, shape, mk]) <= DR_FIT_BYTES:
                break
        else:
            raise AssertionError(f"dryrun: no training cell of {arch} is "
                                 f"predicted under {DR_FIT_BYTES:.0f} B")
        row = memory_check(recs[arch, shape, mk], torch)
        row["chosen_over"] = [list(c) for c in cands[:cands.index(
            (shape, mk))]]
        memory.append(row)
    for cell in DR_SERVE:
        memory.append(memory_check(recs[cell], torch))

    # (d)
    counted = {name: 0 for name in launch_counts()}
    retrieval = []
    for mk in ("single", "multi"):
        meta = recs[(*DR_RETRIEVAL, mk)]
        n = 4096 // (16 if mk == "single" else 32)
        shard = production_shard(index, n, torch)
        reset_launch_counts()
        card = _checked(dryrun.run_cell(*DR_RETRIEVAL, mk, save=False,
                                        device=DEVICE, index=shard,
                                        repeat=DR_STEPS),
                        f"{DR_RETRIEVAL} {mk} on the card")
        got = launch_counts()
        for name, c in got.items():
            counted[name] += c
        missing = [k for k in ("segment_bound_gemm", "plan_wave",
                               "score_queue") if got[k] == 0]
        if missing:
            raise AssertionError(f"dryrun: {mk} retrieval launched no "
                                 f"{missing}")
        held = hold_kernels(lambda: _checked(dryrun.run_cell(
            *DR_RETRIEVAL, mk, save=False, device=DEVICE, index=shard),
            "retrieval replay"), torch)
        for key in ("collectives",):
            if card[key] != meta[key]:
                raise AssertionError(f"dryrun: retrieval {mk}: {key} on "
                                     f"the card {card[key]} != "
                                     f"{meta[key]}")
        if card["memory"]["argument_size_in_bytes"] != \
                meta["memory"]["argument_size_in_bytes"]:
            raise AssertionError(f"dryrun: retrieval {mk}: arguments "
                                 f"{card['memory']} != {meta['memory']}")
        retrieval.append(dict(
            mesh=mk, clusters=n, launches=got, held=held,
            argument_bytes=card["memory"]["argument_size_in_bytes"],
            temp_bytes=card["memory"]["temp_size_in_bytes"],
            batch_ms=card["step_ms"], flops=card["flops"],
            collectives=card["collectives"]))
        del shard
        gc_collect(torch)

    # (e)
    if example.returncode != 0:
        raise AssertionError(f"dryrun: multipod_launch exited "
                             f"{example.returncode}:\n{ex_err[-3000:]}")
    rec = recs["olmo-1b", "train_4k", "multi"]
    gib = dryrun.per_device_gib(rec)
    want = [f"  memory/device       {gib:.2f} GiB (fits an 80 GB H100: "
            f"{gib * 2 ** 30 < 80e9})",
            f"  FLOPs/device        {rec['flops_total']:.3e}"] + [
        f"    {k:20s} x{v['count']:<4d} {v['bytes'] / 2**20:10.1f} MiB"
        for k, v in rec["collectives"].items() if v["count"]]
    ex_lines = ex_out.splitlines()
    lost = [w for w in want if w not in ex_lines]
    if lost:
        raise AssertionError(f"dryrun: multipod_launch's lines {ex_lines} "
                             f"lack {lost}")

    log("dryrun", torch=torch.__version__, fake_collective_on_card=True,
        comm_debug_mode_raw_all_reduce=comm.get_total_counts(),
        meta=dict(seconds=round(meta_s, 2), lines=lines[:-1]),
        memory=memory, retrieval=retrieval,
        example=dict(lines=ex_lines),
        seconds=round(time.perf_counter() - t_phase, 2))
    return {"launches": counted}


def phase_profile(engine, queries, torch) -> None:
    """``--profile``: one 64-query batch under torch.profiler — wall time,
    device time summed over kernels and copies (the busy time on one
    stream; on the pipelined engine's two streams an upper bound of it),
    the device's busy share, and the top consumers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    q = _slice(queries, 0, 64)
    engine.search(q)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.search(q)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, fills): a CPU op's own
    # device time repeats its kernels'
    dev = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda r: -r[1])
    device_ms = sum(ms for _, ms, _ in dev)
    log("profile", engine=engine.cfg.engine, batch=64,
        wall_ms=round(wall_ms, 3),
        device_ms=round(device_ms, 3),
        device_busy_share=round(device_ms / wall_ms, 4),
        device_events=sum(n for _, _, n in dev),
        waves=engine.last_run["waves"],
        top=[[k[:80], round(ms, 3), n] for k, ms, n in dev[:12]])


def superblock_plan_times(args, torch) -> dict:
    """The planner call of the first superblock wave (G = cap), timed
    against the plain planner on the same inputs."""
    from repro_torch.core.plan import plan_wave
    from repro_torch.kernels.plan_wave.compact import compact_front_plain
    a, kw = _plan_call(args)
    return dict(ms=time_ms(lambda: plan_wave(*a, **kw)),
                device_ms=device_ms(lambda: plan_wave(*a, **kw)),
                plain_ms=time_ms(lambda: plan_wave(
                    *a, **kw, _compact=compact_front_plain)),
                shape=dict(n_q=a[2].shape[0], G=a[0].shape[0]))


def phase_kernels(index, queries, captured, launches, sb, pl, lc, fe, dist,
                  torch) -> list[dict]:
    """Each kernel against its plain version at the main path's inputs
    (plus ragged shapes), with kernel, plain and library times; ``sb``
    (the superblock phase) adds K1's level-0 shape and K2 and K3 at the
    superblock wave width. It runs before the model phases, so its
    profiler pass (``device_ms``) is the process's first after the
    retrieval phases. Each row's ``launches`` is the serve phase's count,
    ``path_launches`` the phases' before it; :func:`finish_kernel_rows`
    adds the later phases' launches and the catalog's times."""
    from repro_torch.kernels.plan_wave.compact import (compact_front,
                                                       compact_front_plain)
    from repro_torch.kernels.score_cluster_batch.ops import score_admitted
    from repro_torch.kernels.score_cluster_batch.ref import NEG
    from repro_torch.kernels.score_docs.ops import score_clusters, score_docs
    from repro_torch.kernels.score_docs.ref import score_docs_ref
    from repro_torch.kernels.segment_bound.ops import segment_bound_gemm
    from repro_torch.kernels.segment_bound.ref import segment_bound_gemm_ref
    from repro_torch.core.plan import PLAN_FIELDS, plan_wave
    from repro_torch.core.types import QueryBatch, take_rows, widen_tids
    from repro_torch.kernels.query_terms import query_terms
    from repro_torch.tools.plain_path import (PLANNED, score_admitted_plain,
                                              score_clusters_plain)
    from repro_torch.tools.plan_cases import plan_cases

    rows = []

    def close(got, want, what, neg=None):
        if neg is not None:
            if not bool(torch.equal(got == NEG, neg)):
                raise AssertionError(f"{what}: NEG positions differ")
            got, want = got[~neg], want[~neg]
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"{what}: kernel disagrees with its plain "
                                 f"version beyond rtol {RTOL}")
        return float((got - want).abs().max()) if got.numel() else 0.0

    from repro_torch.kernels.segment_bound.ops import k1_blocking

    def path_launches(name):
        return {"serve": launches[name],
                "superblock": sb["launches"][name],
                "pipelined": pl["launches"][name],
                "lifecycle": lc["launches"][name],
                "frontend": fe["launches"][name],
                "dist": [r[name] for r in dist["launches"]],
                "_name": name}

    def catalog(*keys):
        return {"_keys": keys}

    # ---- K1: the segment bounds, at both batch sizes of the main path
    # and at the two-level walk's level 0 ----
    level0 = next(a for a in sb["captured"]["segment_bound_gemm"]
                  if a[0].data_ptr() == index.super_max_stacked.data_ptr())
    k1 = {}
    for what, (table, terms, scale) in [
            (f"Q={Q}", args) for Q, args in sorted(
                captured["segment_bound_gemm"].items(), reverse=True)] + [
            ("level0", level0)]:
        S, V = table.shape
        Q = terms.n_queries
        err = close(segment_bound_gemm(table, terms, scale),
                    segment_bound_gemm_ref(table, terms, scale), f"K1 {what}")
        qmap = terms.qmaps[:, :V]
        nnz = int(terms.count.sum())
        union = int(torch.unique(terms.tids[terms.tids < V]).numel())
        # the work these queries need: one FMA per (query term, row) and
        # each table byte of the batch's union of terms read once
        b_ms, b_by = bound(union * S + terms.tids.numel() * 8 + Q * 4
                           + Q * S * 4, 2.0 * nnz * S)
        k1[what] = dict(
            max_abs_err=err,
            ms=time_ms(lambda: segment_bound_gemm(table, terms, scale)),
            device_ms=device_ms(
                lambda: segment_bound_gemm(table, terms, scale)),
            plain_ms=time_ms(
                lambda: segment_bound_gemm_ref(table, terms, scale)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: (qmap @ table.float().T) * scale),
            dense_bound_ms=bound(S * V + Q * V * 4 + Q * S * 4,
                                 2.0 * Q * S * V)[0],
            table_stream_ms=S * V / HBM_BYTES_S * 1e3,
            shape=dict(S=S, Q=Q, V=V, q_pad=terms.q_pad, nnz=nnz,
                       union_terms=union))
    # ragged: rows of every alignment (V = 777), 70 queries (two query
    # blocks), one with more than q_pad = 32 terms and one with none
    rng = np.random.default_rng(SEED)
    n_terms = [40, 0] + [23] * 68
    r_tids = np.full((70, 48), -1, np.int32)
    r_tw = np.zeros((70, 48), np.float32)
    for r, k in enumerate(n_terms):
        r_tids[r, :k] = rng.choice(777, k, replace=False)
        r_tw[r, :k] = rng.random(k) + 0.05
    r_terms = query_terms(QueryBatch(
        tids=torch.from_numpy(r_tids), tw=torch.from_numpy(r_tw),
        mask=torch.from_numpy(r_tids >= 0), vocab=777).to(DEVICE))
    r_table = torch.randint(0, 256, (1001, 777), dtype=torch.uint8,
                            device=DEVICE)
    close(segment_bound_gemm(r_table, r_terms, scale),
          segment_bound_gemm_ref(r_table, r_terms, scale), "K1 ragged")
    big, small, lvl = k1.pop("Q=64"), k1.pop("Q=2"), k1.pop("level0")
    S0 = lvl["shape"]["S"]
    qblk, rows_blk, _, smem = k1_blocking(
        S0, lvl["shape"]["Q"], lvl["shape"]["V"], lvl["shape"]["q_pad"],
        torch.cuda.get_device_properties(0).multi_processor_count)
    lvl["blocking"] = dict(queries_a_block=qblk, rows_a_block=rows_blk,
                           blocks=-(-lvl["shape"]["Q"] // qblk)
                           * -(-S0 // rows_blk), smem_bytes=smem)
    rows.append(dict(
        name="segment_bound_gemm", route="cuda",
        source="src/repro_torch/kernels/csrc/segment_bound.cu",
        replaces="src/repro/kernels/segment_bound/segment_bound.py:54",
        launches=launches["segment_bound_gemm"],
        path_launches=path_launches("segment_bound_gemm"),
        **{k: big[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "device_ms")},
        dense_bound_ms=big["dense_bound_ms"],
        table_stream_ms=big["table_stream_ms"], shape=big["shape"],
        small_batch=small, level0=lvl,
        catalog=catalog("segment_bound_gemm Q=64",
                        "segment_bound_gemm Q=2")))

    # ---- K2: the executor ------------------------------------------------
    (tids, tw, dseg, dmask, terms, plan, scale), kw = \
        captured["score_admitted"]

    def k2():
        return score_admitted(tids, tw, dseg, dmask, terms, plan, scale, **kw)

    def k2_plain():
        return score_admitted_plain(tids, tw, dseg, dmask, terms, plan, scale)

    want = k2_plain()
    err = close(k2(), want, "K2", neg=(want == NEG))
    # ragged: a partial query block (37 of 48), five tiles, 128-doc
    # sub-tiles, random segment admission; then the same over the
    # collapsed (n_seg == 1) table
    rcids = plan.tile_cids[:5]
    rl = rcids.long()
    q37 = query_terms(_slice(queries, 0, 37).to(DEVICE), 16)
    for n_seg in (index.n_seg, 1):
        seg = torch.rand((37, 5, n_seg), device=DEVICE) < 0.3
        rplan = plan_wave(rcids, torch.ones(5, dtype=torch.bool,
                                            device=DEVICE),
                          seg.any(-1), seg, 16, index.doc_seg_mod[rl],
                          index.doc_mask[rl], block_d=128,
                          seg_offsets=index.seg_offsets[rl],
                          sorted_upto=index.sorted_upto[rl])
        rargs = (index.doc_seg_mod[rl], index.doc_mask[rl], q37, rplan,
                 scale)
        rwant = score_admitted_plain(tids, tw, *rargs)
        close(score_admitted(tids, tw, *rargs), rwant,
              f"K2 ragged (n_seg {n_seg})", neg=(rwant == NEG))
    # work this wave's data needs: each walked (query, doc) pair applies
    # one FMA per doc term its query holds; each walked doc sub-tile and
    # the used blocks' layouts are read once, the output written once
    G, n_qb, n_db = plan.dblock.shape
    bd, bq, n_q = plan.block_d, plan.block_q, terms.n_queries
    V1, dp, tp = terms.vocab + 1, index.d_pad, index.t_pad
    live = (torch.arange(n_db, device=DEVICE)[None, None]
            < plan.n_dblock[:, :, None]).to(torch.uint8)
    visited = torch.zeros((G, n_qb, n_db), dtype=torch.uint8, device=DEVICE)
    visited = visited.scatter_reduce_(2, plan.dblock.long(), live,
                                      reduce="amax").bool()
    visited &= (torch.arange(G, device=DEVICE) < plan.n_tiles)[:, None, None]
    n_blk = terms.bitmap.shape[0]
    qm = torch.zeros((n_blk * bq, V1), device=DEVICE)
    qm[:n_q] = terms.qmaps
    per_term = (qm.reshape(n_blk, bq, V1) != 0).sum(1)       # (n_blk, V1)
    tcl = plan.tile_cids.long()
    tid_t = widen_tids(take_rows(tids, tcl)).reshape(G, 1, dp * tp)
    nz = (tw[tcl] != 0).reshape(G, 1, dp * tp)
    qbl = plan.qblock.long()
    per_slot = torch.gather(per_term[qbl], 2,
                            tid_t.expand(G, n_qb, dp * tp)) * nz
    fma = per_slot.reshape(G, n_qb, n_db, bd * tp).sum(-1)
    hit = (per_slot > 0).reshape(G, n_qb, n_db, bd * tp).sum(-1)
    slots = nz.reshape(G, 1, n_db, bd * tp).sum(-1).expand(G, n_qb, n_db)
    blocks = []
    for b in sorted(set(qbl[visited.any(-1)].tolist())):
        sel = visited & (qbl == b)[..., None]
        blocks.append(dict(
            block=b, union_terms=int(terms.n_union[b]),
            entries=int(terms.term_ptr[b, -1]),
            walked_doc_terms=int(slots[sel].sum()),
            hit_fraction=float(hit[sel].sum()) / max(int(slots[sel].sum()),
                                                     1)))
    log("k2_blocks", wave=0, block_q=bq, blocks=blocks)
    walked_sub = int((visited.any(1)).sum())
    layout = sum(8 * terms.n_words + 4 * (d["union_terms"] + 1)
                 + 8 * d["entries"] for d in blocks)
    b_ms, b_by = bound(walked_sub * bd * tp * (tids.element_size() + 1)
                       + layout + n_q * G * dp * 4
                       + plan.seg_admit.numel() + G * dp * 5,
                       2.0 * float((fma * visited).sum()))
    rows.append(dict(
        name="score_queue", route="cuda",
        source="src/repro_torch/kernels/csrc/score_queue.cu",
        replaces=("src/repro/kernels/score_cluster_batch/"
                  "score_cluster_batch.py:146"),
        launches=launches["score_queue"], max_abs_err=err,
        ms=time_ms(k2), plain_ms=time_ms(k2_plain), bound_ms=b_ms,
        bound_by=b_by, library_ms=None, timed="the wrapper (NEG fill and "
        "one launch)", device_ms=device_ms(k2),
        shape=dict(n_q=n_q, G=G, n_qb=n_qb, n_db=n_db, block_q=bq,
                   block_d=bd, n_tiles=int(plan.n_tiles),
                   n_blocks=int(plan.n_blocks),
                   walked_docs=int(plan.walked_docs())),
        path_launches=path_launches("score_queue"),
        catalog=catalog("score_admitted")))
    # the first walked superblock's wave: G = cap member tiles
    (s_args, s_kw) = sb["captured"]["score_admitted"]
    s_plan = s_args[5]

    def k2_sb():
        return score_admitted(*s_args, **s_kw)

    def k2_sb_plain():
        return score_admitted_plain(*s_args)
    s_want = k2_sb_plain()
    rows[-1]["superblock"] = dict(
        max_abs_err=close(k2_sb(), s_want, "K2 superblock wave",
                          neg=(s_want == NEG)),
        ms=time_ms(k2_sb), device_ms=device_ms(k2_sb),
        plain_ms=time_ms(k2_sb_plain),
        shape=dict(n_q=s_args[4].n_queries, G=s_plan.cids.shape[0],
                   n_qb=s_plan.n_qb, n_db=s_plan.n_db,
                   n_tiles=int(s_plan.n_tiles),
                   n_blocks=int(s_plan.n_blocks),
                   walked_docs=int(s_plan.walked_docs())))

    # ---- K3: the wave planner, on every wave of a 64-query batch of each
    # walk ----------------------------------------------------------------
    waves = captured["plan_wave_kernel"]
    sb_waves = sb["captured"]["plan_wave_kernel"]
    edge = [(c.name, c.args(DEVICE)) for c in plan_cases()]
    for what, (a, kw) in ([(f"wave {w}", _plan_call(args))
                           for w, args in enumerate(waves)]
                          + [(f"superblock wave {w}", _plan_call(args))
                             for w, args in enumerate(sb_waves)] + edge):
        got = plan_wave(*a, **kw)
        want = plan_wave(*a, **kw, _compact=compact_front_plain)
        for f in PLAN_FIELDS:
            x, y = getattr(got, f), getattr(want, f)
            if x.dtype != y.dtype or not torch.equal(x, y):
                raise AssertionError(f"K3 planner: {f} differs at {what}")
    a, kw = _plan_call(waves[0])
    # the op-by-op planner's six compactions of wave 0, and ragged rows
    masks = []

    def rec(keep):
        masks.append(keep.clone())
        return compact_front(keep)
    plan_wave(*a, **kw, _compact=rec)
    for keep in masks + [torch.rand((5, 1289), device=DEVICE) < 0.3,
                         torch.zeros((3, 7), dtype=torch.bool,
                                     device=DEVICE),
                         torch.ones((2, 130), dtype=torch.bool,
                                    device=DEVICE)]:
        got, ref = compact_front(keep), compact_front_plain(keep)
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise AssertionError(f"compact_front differs at "
                                 f"{tuple(keep.shape)}")
    # bound: the wave's planner inputs read once and the plan written once
    plan = plan_wave(*a, **kw)
    ins = [t for t in a if isinstance(t, torch.Tensor)] + [
        kw["seg_offsets"], kw["sorted_upto"]]
    io_bytes = (sum(t.numel() * t.element_size() for t in ins)
                + sum(getattr(plan, f).numel()
                      * getattr(plan, f).element_size() for f in PLANNED))
    b_ms, b_by = bound(io_bytes, 0.0)

    def fused():
        return plan_wave(*a, **kw)

    def op_by_op():
        return plan_wave(*a, **kw, _compact=compact_front)

    def plain():
        return plan_wave(*a, **kw, _compact=compact_front_plain)
    rows.append(dict(
        name="plan_wave", route="cuda",
        source="src/repro_torch/kernels/csrc/plan_wave.cu",
        replaces="src/repro/kernels/plan_wave/compact.py:90",
        launches=launches["plan_wave"], max_abs_err=0.0,
        ms=time_ms(fused), device_ms=device_ms(fused),
        plain_ms=time_ms(plain), bound_ms=b_ms, bound_by=b_by,
        library_ms=None, timed="plan_wave on wave 0: one call, two kernels",
        op_by_op_ms=time_ms(op_by_op), op_by_op_device_ms=device_ms(op_by_op),
        plain_device_ms=device_ms(plain),
        waves_checked=len(waves), edge_cases=[n for n, _ in edge],
        shape=dict(n_q=plan.admit.shape[0], G=plan.cids.shape[0],
                   n_seg=plan.seg_admit.shape[-1], d_pad=plan.d_pad,
                   block_q=plan.block_q, block_d=plan.block_d,
                   n_qb=plan.n_qb, run_slots=plan.drun_start.shape[-1],
                   n_tiles=int(plan.n_tiles), io_bytes=io_bytes),
        path_launches=path_launches("plan_wave"),
        catalog=catalog("plan_wave_kernel"),
        superblock={**superblock_plan_times(sb_waves[0], torch),
                    "waves_checked": len(sb_waves)},
        compact_front=dict(
            source="src/repro_torch/kernels/csrc/compact_front.cu",
            launches=launches["compact_front"],
            ms=time_ms(lambda: [compact_front(k) for k in masks]),
            plain_ms=time_ms(lambda: [compact_front_plain(k)
                                      for k in masks]),
            calls_per_wave=len(masks),
            masks=[list(k.shape) for k in masks])))

    # ---- K4: per-query scoring by cluster id, the admission fused -------
    (dt, dw, dseg4, dmask4, cids4, seg4, terms4, i4, scale4), _ = \
        captured["score_clusters"]

    def k4():
        return score_clusters(dt, dw, dseg4, dmask4, cids4, seg4, terms4,
                              i4, scale4)

    def k4_plain():
        return score_clusters_plain(dt, dw, dseg4, dmask4, cids4, seg4,
                                    terms4, i4, scale4)
    qmap1 = terms4.qmaps[i4]
    cl4 = cids4.long()

    def gathered():
        return take_rows(dt, cl4), dw[cl4]

    def k4_old():
        # the sequence K4 replaced: gather the tiles, the flat kernel on a
        # dense map, then the admission mask
        tiles, wts = gathered()
        scores = score_docs(tiles, wts, qmap1, scale4)
        ok = (seg4[:, :1] if seg4.shape[1] == 1
              else torch.gather(seg4, 1, dseg4[cl4].long()))
        return torch.where(dmask4[cl4] & ok, scores, NEG)

    want = k4_plain()
    neg4 = want == NEG
    err = close(k4(), want, "K4", neg=neg4)
    close(k4_old(), want, "K4 (gather + flat kernel)", neg=neg4)
    # ragged: the collapsed table, int32 ids, one cluster admitting nothing
    r_cids = cids4[:5].to(torch.int32)
    r_seg = torch.rand((5, 1), device=DEVICE) < 0.7
    r_seg[1] = False
    r_args = (dt, dw, dseg4, dmask4, r_cids, r_seg, terms4, i4, scale4)
    r_want = score_clusters_plain(*r_args)
    close(score_clusters(*r_args), r_want, "K4 ragged", neg=r_want == NEG)
    tiles, wts = gathered()
    flat_err = close(score_docs(tiles, wts, qmap1, scale4),
                     score_docs_ref(tiles, wts, qmap1, scale4), "K4 flat")
    G4, D4 = neg4.shape
    T4 = dt.shape[-1]
    n_adm = int((~neg4).sum())
    # work this query's data needs: each admitted doc row read once, one
    # FMA per admitted doc term the query holds, the liveness, segments
    # and output of every slot once
    adm_t = widen_tids(tiles)[~neg4]
    hits = float(((qmap1[adm_t] != 0) & (wts[~neg4] != 0)).sum())
    b_ms, b_by = bound(n_adm * T4 * (dt.element_size() + 1)
                       + G4 * D4 * (1 + 4 + 4) + seg4.numel()
                       + terms4.q_pad * 8, 2.0 * hits)
    wide = widen_tids(tiles).reshape(-1, T4)
    wts_f = wts.reshape(-1, T4).float()
    emb = qmap1[:, None]
    rows.append(dict(
        name="score_clusters", route="cuda",
        source="src/repro_torch/kernels/csrc/score_docs.cu",
        replaces="src/repro/kernels/score_docs/score_docs.py:40",
        launches=launches["score_clusters"], max_abs_err=err,
        path_launches=path_launches("score_clusters"),
        catalog=catalog("score_clusters"),
        ms=time_ms(k4), device_ms=device_ms(k4), plain_ms=time_ms(k4_plain),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.nn.functional.embedding_bag(
            wide, emb, per_sample_weights=wts_f, mode="sum") * scale4),
        library="embedding_bag over the gathered tiles, unmasked",
        old_sequence_ms=time_ms(k4_old),
        old_sequence_device_ms=device_ms(k4_old),
        shape=dict(G=G4, d_pad=D4, t_pad=T4, admitted_docs=n_adm,
                   hit_terms=int(hits), q_terms=int(terms4.count[i4])),
        score_docs=dict(
            launches=launches["score_docs"], max_abs_err=flat_err,
            ms=time_ms(lambda: score_docs(tiles, wts, qmap1, scale4)),
            device_ms=device_ms(lambda: score_docs(tiles, wts, qmap1,
                                                   scale4)),
            plain_ms=time_ms(lambda: score_docs_ref(tiles, wts, qmap1,
                                                    scale4)))))

    # ---- the wave's merge ------------------------------------------------
    rows.append(dict(**merge_row(torch, captured["merge_topk"][0]),
                     launches=launches["merge_topk"],
                     path_launches=path_launches("merge_topk"),
                     catalog=catalog("merge_topk")))
    return rows


def merge_row(torch, wave64: tuple | None = None) -> dict:
    """The wave's merge against its plain sort path, bit for bit, on every
    case of ``tools/merge_cases.py``, at k = 1,000 and 20,000 (a workspace
    in global memory) and at the benchmark's wave (256 x 32 x 2,560, k =
    10); kernel, device, plain and ``torch.topk`` times there (a later
    wave, few scores above theta; and a first wave, theta NEG), at
    ``wave64`` (a captured 64-query wave's arguments; None: a synthetic
    first wave) and at the benchmark's wave with k = 1,000, with the
    bound: every score read once, the running top-k read and the new one
    written."""
    from repro_torch.kernels.merge_topk.ops import (MERGE_SHARED_KEYS,
                                                    merge_cluster,
                                                    merge_keys, merge_topk)
    from repro_torch.kernels.merge_topk.ref import merge_wave_ref
    from repro_torch.tools.merge_cases import (CASES, KS, N_QS, NEG,
                                               case_args, merge_case)
    checked = 0
    for name in CASES:
        for k in KS:
            for n_q in N_QS:
                a = case_args(merge_case(name, n_q, k, seed=SEED), DEVICE, k)
                check_merge(merge_topk(*a), merge_wave_ref(*a),
                            f"merge {name} k={k} n_q={n_q}")
                checked += 1
    for k, n_q, width in ((1000, 64, (4, 3000)), (20000, 4, (8, 6000))):
        for name in ("random", "first_wave", "ties"):
            a = case_args(merge_case(name, n_q, k, seed=SEED, width=width),
                          DEVICE, k)
            check_merge(merge_topk(*a), merge_wave_ref(*a),
                        f"merge {name} k={k} n_q={n_q}")
            checked += 1
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    if wave64 is None:
        wave64 = case_args(merge_case("first_wave", 64, 10, seed=SEED,
                                      width=(32, 2560)), DEVICE, 10)
    shapes = {what: case_args(merge_case(name, 256, k, seed=SEED,
                                         width=(32, 2560)), DEVICE, k)
              for what, name, k in (("benchmark", "steady", 10),
                                    ("first_wave", "first_wave", 10),
                                    ("deep", "steady", 1000),
                                    ("deep_first_wave", "first_wave", 1000))}
    shapes["wave64"] = wave64
    out = {}
    for what, a in shapes.items():
        _, _, scores, _, _, k = a
        check_merge(merge_topk(*a), merge_wave_ref(*a), f"merge {what}")
        n_q, L = scores.shape[0], scores[0].numel()
        flat = scores.reshape(n_q, L)
        b_ms, b_by = bound(n_q * L * 4 + n_q * 4 + n_q * k * (8 + 8 + 4),
                           0.0)
        out[what] = dict(
            ms=time_ms(lambda: merge_topk(*a)),
            device_ms=device_ms(lambda: merge_topk(*a)),
            plain_ms=time_ms(lambda: merge_wave_ref(*a)),
            plain_device_ms=device_ms(lambda: merge_wave_ref(*a)),
            library_ms=time_ms(lambda: torch.topk(flat, k, dim=1)),
            bound_ms=b_ms, bound_by=b_by,
            shape=dict(n_q=n_q, G=scores.shape[1], d_pad=scores.shape[2],
                       k=k, blocks_a_row=merge_cluster(n_q, L, k, n_sm),
                       workspace_keys=merge_keys(k),
                       workspace_shared=merge_keys(k) <= MERGE_SHARED_KEYS,
                       survivors=int((scores > a[3][:, None, None]).sum()),
                       first_wave_rows=int((a[3] == NEG).sum())))
    big = out.pop("benchmark")
    return dict(
        name="merge_topk", route="cuda",
        source="src/repro_torch/kernels/csrc/merge_topk.cu",
        replaces="none (the JAX package merges with lax.top_k under XLA)",
        bit_exact=True, cases_checked=checked,
        library="torch.topk over the wave's rows, unfiltered, unmerged",
        timed="one call: the filter, the top-k and the 2k -> k merge",
        **{key: big[key] for key in ("ms", "device_ms", "plain_ms",
                                     "plain_device_ms", "library_ms",
                                     "bound_ms", "bound_by", "shape")},
        first_wave=out["first_wave"], wave64=out["wave64"],
        deep=out["deep"], deep_first_wave=out["deep_first_wave"])


def finish_kernel_rows(rows: list[dict], later: dict, ra: dict) -> None:
    """Add the phases after the kernels phase to each row's
    ``path_launches`` (``later``: phase name -> its result) and the
    recsys_asc phase's times at the catalog's shapes."""
    for row in rows:
        name = row["path_launches"].pop("_name")
        row["path_launches"].update(
            {phase: res["launches"][name] for phase, res in later.items()})
        keys = row["catalog"].pop("_keys")
        row["catalog"] = {k: ra["kernels"][k] for k in keys
                          if k in ra["kernels"]}


PHASE_SETS = ("all", "nccl", "nccl_full", "merge")


def selected_phases(argv: list) -> str:
    """``--phases`` (one of ``PHASE_SETS``; default ``all``)."""
    if "--phases" not in argv:
        return "all"
    i = argv.index("--phases")
    got = argv[i + 1] if i + 1 < len(argv) else None
    if got not in PHASE_SETS:
        raise SystemExit(f"chip_smoke: --phases takes one of {PHASE_SETS}, "
                         f"not {got!r}")
    return got


def card_lines(card: str, torch) -> None:
    """The contract's last two lines: the card's name and power limit,
    then the result."""
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main() -> int:
    t_script = time.perf_counter()
    phases = selected_phases(sys.argv[1:])
    # cuBLAS reads this when it first makes its handle; the train_encoder
    # phase's deterministic resume check needs it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir() or not GOLDEN.is_file():
        print(f"chip_smoke: the repo's src/repro_torch and {GOLDEN.name} "
              f"must sit beside this script", file=sys.stderr)
        return 2
    if phases.startswith("nccl") and torch.cuda.device_count() < NC_WORLD:
        print(f"chip_smoke: --phases {phases} needs {NC_WORLD} cards; this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # full fp32 for every GEMM (K1's plain version refuses TF32, and the
    # library yardstick must compute the same bound)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = phase_build(torch)
    import tempfile
    if phases == "nccl":
        geo, index, queries, docs, _ = scale_world()
        del docs
        from repro_torch.lifecycle import save_index
        with tempfile.TemporaryDirectory() as world_dir:
            saved = os.path.join(world_dir, "index")
            save_index(saved, index, epoch=0)
            phase_nccl(geo, index, queries, saved, torch)
    elif phases == "nccl_full":
        phase_nccl_full(torch)
    elif phases == "merge":
        print(json.dumps({"kernels": [merge_row(torch)]}), flush=True)
    if phases != "all":
        log("total", phases=phases,
            seconds=round(time.perf_counter() - t_script, 1))
        card_lines(card, torch)
        return 0
    phase_golden()
    geo, index, queries, docs, fe_queries = scale_world()
    engine, launches, captured, fresh_ms = phase_serve(geo, index, queries,
                                                       torch)
    sb = phase_superblock(geo, index, queries, torch)
    pl = phase_pipelined(geo, index, queries, torch)
    lc = phase_lifecycle(geo, index, queries, fresh_ms, torch)
    fe = phase_frontend(geo, engine, index, fe_queries, torch)
    phase_cluster(geo, index, queries, docs, torch)
    del docs
    with tempfile.TemporaryDirectory() as world_dir:
        saved = os.path.join(world_dir, "index")
        phase_cli(index, fe, saved, torch)
        dist = phase_dist(geo, index, queries, fresh_ms, saved, torch)
        # on fewer than four cards: a line saying it did not run
        phase_nccl(geo, index, queries, saved, torch)
    # before any model phase: its profiler pass is then the process's
    # first since the retrieval phases (the moe phase profiles decode)
    rows = phase_kernels(index, queries, captured, launches, sb, pl, lc, fe,
                         dist, torch)
    later = {"encoder": phase_encoder(engine, index, torch),
             "train_encoder": phase_train_encoder(torch)}
    later["train_lm"] = tl = phase_train_lm(torch)
    later["recsys_asc"] = ra = phase_recsys_asc(torch)
    later["recsys"] = phase_recsys(torch)
    later["train_recsys"] = phase_train_recsys(torch)
    later["train_gnn"] = phase_train_gnn(torch)
    later["moe"] = phase_moe(torch)
    later["train_moe"] = phase_train_moe(torch)
    later["train_sharded"] = phase_train_sharded(torch, tl)
    later["model_axis"] = phase_model_axis(torch)
    later["examples"] = phase_examples(torch)
    later["dryrun"] = phase_dryrun(index, torch)
    finish_kernel_rows(rows, later, ra)
    if "--profile" in sys.argv[1:]:
        phase_profile(engine, queries, torch)
        phase_profile(pl["engine"], queries, torch)
    log("total", seconds=round(time.perf_counter() - t_script, 1))
    print(json.dumps({"kernels": rows}), flush=True)
    card_lines(card, torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
