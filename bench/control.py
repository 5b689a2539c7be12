"""The control of the comparison that decides ``correct``: the reference
put in the program's place, computed one precision lower than the
configuration states (bfloat16 bounds and scores for fp32), at a cell's
own size and batch, judged by the same numbers against the same
float64 reference. A limit is sound only if this reads above it.

    python3 bench/control.py --workload <name> --seeds <n> [<n> ...]

prints one JSON line a seed with the numbers and the limits; it needs a
CUDA card (``--device cpu`` for a small cell in the tests).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control(root: Path, workload: str, seed: int, device,
            dtype=None) -> dict:
    import torch

    from bench import check, harness, world
    from bench.reference import asc

    dtype = dtype or torch.bfloat16
    _, _, cfg, mix = harness.load_cell(root, workload)
    query_spec = dict(mix["queries"], q_pad=cfg["queries"]["q_pad"])
    tids, tw, mask, assign, pool_t, pool_w = harness.draw_world(
        cfg, query_spec, seed, device)
    ix = cfg["index"]
    ref_ix = asc.derive_index(tids, tw, mask, assign, ix["m"], ix["n_seg"],
                              ix["d_pad"], world.sub_seed(seed, "index"),
                              cfg["corpus"]["vocab"], device)
    pool = harness.Pool.seeded(pool_t, pool_w, cfg["corpus"]["vocab"],
                               mix["batch"], seed)
    s = cfg["search"]
    batches = list(range(mix["check_batches"]))
    ids, scores = [], []
    for b in batches:
        r = pool.rows(b)
        low = asc.search(ref_ix, pool_t[r], pool_w[r], mix["k"], s["mu"],
                         s["eta"], s["group_size"], dtype=dtype)
        ids.append(low["ids"])
        scores.append(low["scores"])
    numbers, read_from = harness.compare(
        ref_ix, pool, batches, torch.stack(ids), torch.stack(scores),
        mix["k"], s["mu"], s["eta"], s["group_size"])
    correct, checks = check.verdict(numbers)
    return {"workload": workload, "seed": seed, "dtype": str(dtype),
            "correct": correct, "checks": checks, "checked": read_from}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]
    for seed in args.seeds:
        print(json.dumps(control(ROOT, args.workload, seed, args.device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
