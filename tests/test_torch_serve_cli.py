"""The port's serving launcher (``python -m repro_torch.launch.serve``) on
the CPU, and held against the JAX package's launcher.

  * the default build (k-means over the projection, balanced assignment)
    and offline batches with ``--device cpu``;
  * SIGTERM while ``--frontend closed --churn --durable-dir`` serves: the
    front-end drains, then the final checkpoint is written, the process
    exits 0, and a restart recovers at that checkpoint's op_seq;
  * both launchers on a checkpoint the JAX package wrote, with churn, a
    durable write plane and the metrics dump, give the same non-timing
    counters;
  * the refusals: ``--devices``, and no card without ``--device cpu``.
"""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import serve as t_serve
from repro_torch.lifecycle import load_index, read_manifest
from repro_torch.lifecycle.wal import SNAPSHOT_SUBDIR

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--n-docs", "600", "--vocab", "256", "--clusters", "8",
         "--segments", "2", "--batch-size", "8"]

# instruments that read the wall clock or depend on fsync timing
TIMED = ("serve_batch_latency_ms", "serve_time_seconds_total",
         "lifecycle_max_epoch_lifetime_seconds", "wal_fsyncs_total",
         "index_compaction_duration_seconds",
         "index_recovery_duration_seconds", "funnel_doc_compaction_ratio",
         "funnel_tile_compaction_ratio")


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_default_build_and_offline_batches(tmp_path, capsys):
    t_serve.main(["--device", "cpu", *SMALL, "--batches", "3",
                  "--save-dir", str(tmp_path / "saved")])
    out = capsys.readouterr().out
    assert "[serve] index: 8x2" in out
    assert re.search(r"\[serve\] 24 queries in 3 batches: mean [\d.]+ ms/q, "
                     r"batch p50 [\d.]+ ms, p99 [\d.]+ ms", out)
    assert re.search(r"\[serve\] last batch scored [\d.]+/8 clusters", out)
    # the built index: k-means + balanced assignment placed every doc
    # once, and no cluster beyond d_pad = 2 * 600 / 8
    index, _ = load_index(str(tmp_path / "saved"), device="cpu")
    ids = index.doc_ids[index.doc_mask]
    assert sorted(ids.tolist()) == list(range(600))
    assert index.d_pad == 150
    assert int(index.cluster_ndocs.max()) <= 150


def test_refuses_devices_and_a_missing_card(capsys):
    with pytest.raises(SystemExit, match="ROADMAP A.13"):
        t_serve.main(["--devices", "4", *SMALL])
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit, match="--device cpu"):
        t_serve.main(SMALL)


def _wait_for(pred, timeout_s: float, proc) -> None:
    t0 = time.monotonic()
    while not pred():
        if proc.poll() is not None:
            raise AssertionError(f"launcher exited early: "
                                 f"{proc.stdout.read()}")
        if time.monotonic() - t0 > timeout_s:
            proc.kill()
            raise AssertionError("timed out waiting for the launcher")
        time.sleep(0.05)


def _checkpoint_epoch(durable: Path) -> int:
    try:
        return int(read_manifest(str(durable / SNAPSHOT_SUBDIR),
                                 verify=False)["epoch"])
    except (OSError, ValueError, KeyError, RuntimeError):
        return -1


def test_sigterm_drains_checkpoints_and_restart_recovers(tmp_path):
    durable = tmp_path / "durable"
    args = [sys.executable, "-m", "repro_torch.launch.serve", "--device",
            "cpu", *SMALL, "--frontend", "closed", "--churn", "20",
            "--durable-dir", str(durable), "--checkpoint-every", "2"]
    proc = subprocess.Popen(args + ["--batches", "100000"], env=_env(),
                            cwd=tmp_path, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        # a periodic checkpoint after commit 2: rounds were served
        _wait_for(lambda: _checkpoint_epoch(durable) >= 2, 120, proc)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out
    lines = out.splitlines()
    at = {key: next(i for i, ln in enumerate(lines) if ln.startswith(key))
          for key in ("[serve] interrupted", "[serve] frontend drained",
                      "[serve] final checkpoint")}
    assert (at["[serve] interrupted"] < at["[serve] frontend drained"]
            < at["[serve] final checkpoint"]), out
    assert "'balanced': True" in lines[at["[serve] frontend drained"]]
    manifest = read_manifest(str(durable / SNAPSHOT_SUBDIR))
    op_seq = int(manifest["extra"]["writer"]["op_seq"])
    assert op_seq > 0

    again = subprocess.run(args + ["--batches", "2"], env=_env(),
                           cwd=tmp_path, capture_output=True, text=True,
                           timeout=180)
    assert again.returncode == 0, again.stdout + again.stderr
    rec = next(ln for ln in again.stdout.splitlines()
               if ln.startswith("[serve] recovered write plane"))
    assert f"'checkpoint_op_seq': {op_seq}," in rec
    assert f"'op_seq': {op_seq}," in rec
    assert "'n_replayed': 0," in rec
    assert re.search(r"\[serve\] 16 queries in 2 batches", again.stdout)
    assert "[serve] final checkpoint" in again.stdout


def _reference_main(argv) -> None:
    """The JAX package's launcher in this process (it reads sys.argv and
    leaves its SIGTERM handler installed; both are restored)."""
    from repro.launch import serve as j_serve
    saved_argv, saved_handler = sys.argv, signal.getsignal(signal.SIGTERM)
    sys.argv = ["serve", *argv]
    try:
        j_serve.main()
    finally:
        sys.argv = saved_argv
        signal.signal(signal.SIGTERM, saved_handler)


def test_counters_match_reference_on_its_checkpoint(tmp_path, capsys):
    from repro.core.index import build_index
    from repro.data.synthetic import CorpusSpec, make_corpus
    from repro.lifecycle import save_index

    spec = CorpusSpec(n_docs=600, vocab=256, n_topics=8)
    docs, doc_topic = make_corpus(spec)
    save_index(str(tmp_path / "ckpt"), build_index(
        docs, doc_topic % 8, m=8, n_seg=2, d_pad=128, seed=5), epoch=3)
    common = [*SMALL, "--load-dir", str(tmp_path / "ckpt"), "--batches", "4",
              "--churn", "30", "--checkpoint-every", "2"]
    _reference_main([*common, "--durable-dir", str(tmp_path / "ref_d"),
                     "--metrics-json", str(tmp_path / "ref.json")])
    ref_out = capsys.readouterr().out
    # the port's launcher bounds clusters by the segment-bound GEMM, the
    # reference's by its default gather: the counters must still agree
    t_serve.main(["--device", "cpu", *common,
                  "--durable-dir", str(tmp_path / "port_d"),
                  "--metrics-json", str(tmp_path / "port.json")])
    port_out = capsys.readouterr().out

    ref = json.loads((tmp_path / "ref.json").read_text())
    port = json.loads((tmp_path / "port.json").read_text())
    for name in TIMED:
        ref.pop(name, None)
        port.pop(name, None)
    assert sorted(port) == sorted(ref)
    assert port == ref
    assert port["serve_queries_total"] == 32
    assert port["lifecycle_epoch"] == 4                # one a round
    assert port["wal_records_appended_total"] > 0
    # the printed funnel and lifecycle lines carry no timing
    for key in ("[serve] funnel", "[serve] lifecycle", "[serve] cold start"):
        want = [ln for ln in ref_out.splitlines() if ln.startswith(key)]
        got = [ln for ln in port_out.splitlines() if ln.startswith(key)]
        assert got == want and got, key
    # both write planes hold the same final state
    ref_m = read_manifest(str(tmp_path / "ref_d" / SNAPSHOT_SUBDIR))
    port_m = read_manifest(str(tmp_path / "port_d" / SNAPSHOT_SUBDIR))
    assert port_m["extra"]["writer"]["op_seq"] == \
        ref_m["extra"]["writer"]["op_seq"]
    a, _ = load_index(str(tmp_path / "ref_d" / SNAPSHOT_SUBDIR),
                      device="cpu")
    b, _ = load_index(str(tmp_path / "port_d" / SNAPSHOT_SUBDIR),
                      device="cpu")
    np.testing.assert_array_equal(a.doc_ids.numpy(), b.doc_ids.numpy())
    np.testing.assert_array_equal(a.doc_tw.numpy(), b.doc_tw.numpy())
