"""Real-crash recovery of the port's write plane: SIGKILL a churning port
writer subprocess mid-stream, recover from its durable directory, finish
the op stream, and re-pass the committed golden ``churned`` entries on
the recovered index (tests/test_crash_recovery.py's test, for
``repro_torch``).

The child imports only ``repro_torch`` (and numpy): the golden base
world and the concrete op stream come from
``repro_torch.tools.golden_world``. The parent holds the recovered
writer to the same ops the JAX package's crash test uses.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import test_crash_recovery as tc
import test_golden_regression as tg
from repro_torch.core.search import brute_force_topk, retrieve
from repro_torch.core.types import TOPK_FIELDS
from repro_torch.lifecycle import MutableIndex
from repro_torch.tools.golden_world import (WRITER_SEED, apply_op,
                                            golden_churn_ops, golden_world)
from test_torch_search import port_cfg

KILL_AFTER = tc.KILL_AFTER
WAL_KW = tc.WAL_KW

_CHILD = r"""
import json, os, sys
from repro_torch.lifecycle import MutableIndex
from repro_torch.lifecycle.wal import WAL_SUBDIR, WriteAheadLog
from repro_torch.tools.golden_world import (WRITER_SEED, apply_op,
                                            golden_world)

durable_dir = sys.argv[1]
with open(os.path.join(durable_dir, "ops.json")) as f:
    ops = json.load(f)
wal_kw = json.loads(sys.argv[2])
index, _ = golden_world("cpu")
wal = WriteAheadLog(os.path.join(durable_dir, WAL_SUBDIR), **wal_kw)
mi = MutableIndex(index, seed=WRITER_SEED, wal=wal)
mi.checkpoint(durable_dir)
for i, op in enumerate(ops):
    apply_op(mi, op)
    print(f"OP {i + 1}", flush=True)
print("DONE", flush=True)
"""


@pytest.mark.slow
def test_sigkill_mid_churn_recovers_and_repasses_golden(tmp_path):
    durable_dir = str(tmp_path / "durable")
    os.makedirs(durable_dir)
    ops = golden_churn_ops()
    assert ops == tc._record_golden_ops()
    assert len(ops) > KILL_AFTER + 20
    with open(os.path.join(durable_dir, "ops.json"), "w") as f:
        json.dump(ops, f)

    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    # the child sees the port and nothing of the tests or the JAX package
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = src
    child = subprocess.Popen(
        [sys.executable, "-c", _CHILD, durable_dir, json.dumps(WAL_KW)],
        stdout=subprocess.PIPE, text=True, env=env)
    try:
        applied = 0
        deadline = time.monotonic() + 240
        for line in child.stdout:
            if line.startswith("OP "):
                applied = int(line.split()[1])
                if applied >= KILL_AFTER:
                    break
            assert not line.startswith("DONE"), \
                "child finished before the kill — raise KILL_AFTER"
            assert time.monotonic() < deadline
        else:
            pytest.fail(f"child exited early (rc={child.poll()}) after "
                        f"{applied} ops")
        child.kill()                           # SIGKILL: no cleanup runs
        child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
        child.stdout.close()

    rec, stats = MutableIndex.recover(durable_dir, attach_wal=False)
    assert 0 < rec.op_seq <= len(ops)
    assert rec.op_seq >= applied - WAL_KW["sync_every_n"]
    assert stats["n_replayed"] == rec.op_seq
    for op in ops[rec.op_seq:]:
        apply_op(rec, op)

    with open(tg.GOLDEN_PATH) as f:
        golden = json.load(f)["churned"]
    snap = rec.snapshot("cpu")
    _, queries = golden_world("cpu")

    def entry(r):
        return tg._topk_entry(r.__class__(
            *(getattr(r, f).numpy() for f in TOPK_FIELDS)))
    for name, jcfg in tg.CHURNED_ENGINES.items():
        got = retrieve(snap, queries, port_cfg(jcfg), device="cpu")
        tg._check_entry(golden[name], entry(got), f"recovered:{name}")
    got = brute_force_topk(snap, queries, tg.K, device="cpu")
    tg._check_entry(golden["brute_force"], entry(got),
                    "recovered:brute_force")
    # and the recovered writer is the uncrashed one
    oracle = MutableIndex(golden_world("cpu")[0], seed=WRITER_SEED)
    for op in ops:
        apply_op(oracle, op)
    for f in ("doc_ids", "doc_tids", "doc_tw", "seg_max_stacked",
              "sorted_upto"):
        np.testing.assert_array_equal(getattr(rec, f), getattr(oracle, f))
    assert rec._rng.bit_generator.state == oracle._rng.bit_generator.state
