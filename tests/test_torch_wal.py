"""The port's write-ahead log and fault injection
(``repro_torch.lifecycle.wal`` / ``faults``) against the JAX package's.

The two packages must share one on-disk format, so everything here is
held byte for byte:

  * every record type encodes to the same bytes from the same inputs and
    decodes in the other package to the same record;
  * a log written through either package's ``WriteAheadLog`` (segment
    rotation, every fsync policy) is the same files, byte for byte, and
    ``read_wal`` of either package returns the same records and stats;
  * a torn tail, a bit flip mid-log and a destroyed segment header are
    read, repaired and reclaimed the same way, and ``truncate_upto``
    retires the same segments;
  * the fault harness behaves as the reference's (nth-hit firing,
    validation, exclusive install, the seeded corrupt actions damage the
    same bytes), and a schedule fires only in the package it is
    installed in.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import pytest

from repro.lifecycle import faults as jfaults
from repro.lifecycle import wal as jwal
from repro_torch.lifecycle import faults as tfaults
from repro_torch.lifecycle import wal as twal

PKGS = {"port": (twal, tfaults), "ref": (jwal, jfaults)}


def _insert_args(rng, op_seq):
    nnz = int(rng.integers(1, 12))
    tids = np.sort(rng.choice(200, nnz, replace=False)).astype(np.int64)
    tw = rng.lognormal(0.0, 0.5, nnz).astype(np.float32)
    return dict(op_seq=op_seq, doc_id=int(rng.integers(0, 10_000)),
                c=int(rng.integers(8)), slot=int(rng.integers(64)),
                seg=int(rng.integers(4)), tids=tids, tw=tw)


def _records(rng) -> list[tuple[str, tuple]]:
    """One of each record kind, as (encoder name, arguments)."""
    a = _insert_args(rng, 7)
    b = _insert_args(rng, 8)
    dense = rng.normal(size=16).astype(np.float32)
    state = np.random.default_rng(1).bit_generator.state
    return [
        ("encode_insert", (a["op_seq"], a["doc_id"], a["c"], a["slot"],
                           a["seg"], a["tids"], a["tw"], None)),
        ("encode_insert", (b["op_seq"], b["doc_id"], b["c"], b["slot"],
                           b["seg"], b["tids"], b["tw"], dense)),
        ("encode_delete", (3, 42)),
        ("encode_compact", (11, True, False, state)),
        ("encode_compact", (12, False, True, state)),
        ("encode_epoch", (9, 5)),
    ]


def _same_record(x: dict, y: dict) -> None:
    assert x.keys() == y.keys()
    for k in x:
        if isinstance(x[k], np.ndarray):
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])
        else:
            assert x[k] == y[k], k


@pytest.mark.parametrize("i", range(6))
def test_records_byte_equal_and_cross_decode(i):
    name, args = _records(np.random.default_rng(0))[i]
    mine = getattr(twal, name)(*args)
    ref = getattr(jwal, name)(*args)
    assert mine == ref
    _same_record(twal.decode_record(ref), jwal.decode_record(mine))


def test_unknown_opcode_rejected_by_both():
    for mod in (twal, jwal):
        with pytest.raises(ValueError, match="opcode"):
            mod.decode_record(b"\xff rest")


def _write_log(mod, d, fsync, n=200, segment_bytes=1 << 10, seed=1):
    wal = mod.WriteAheadLog(d, fsync=fsync, segment_bytes=segment_bytes)
    rng = np.random.default_rng(seed)
    for i in range(n):
        kind = i % 3
        if kind == 0:
            wal.append_insert(dense_rep=None, **_insert_args(rng, i + 1))
        elif kind == 1:
            wal.append_delete(i + 1, i)
        else:
            wal.append_epoch(i + 1, i // 3)
    wal.close()
    return sorted(glob.glob(os.path.join(d, "wal-*.log")))


def _same_files(a: list[str], b: list[str]) -> None:
    assert [os.path.basename(p) for p in a] == \
        [os.path.basename(p) for p in b]
    for pa, pb in zip(a, b):
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            assert fa.read() == fb.read(), os.path.basename(pa)


def _same_read(d: str, from_lsn: int = 0) -> tuple[list, dict]:
    mine, mine_stats = twal.read_wal(d, from_lsn)
    ref, ref_stats = jwal.read_wal(d, from_lsn)
    assert mine_stats == ref_stats
    assert len(mine) == len(ref)
    for x, y in zip(mine, ref):
        _same_record(x, y)
    return mine, mine_stats


@pytest.mark.parametrize("fsync", twal.FSYNC_POLICIES)
def test_logs_are_the_same_files_and_read_alike(tmp_path, fsync):
    mine = _write_log(twal, str(tmp_path / "port"), fsync)
    ref = _write_log(jwal, str(tmp_path / "ref"), fsync)
    assert len(mine) > 3                      # rotated
    _same_files(mine, ref)
    for d in ("port", "ref"):
        records, stats = _same_read(str(tmp_path / d))
        assert stats["end_lsn"] == 200 and not stats["torn"]
        assert [r["lsn"] for r in records] == list(range(200))
        _same_read(str(tmp_path / d), from_lsn=77)


def test_reopen_continues_lsn_across_packages(tmp_path):
    d = str(tmp_path / "wal")
    _write_log(jwal, d, "off", n=10)
    wal = twal.WriteAheadLog(d, fsync="off")
    assert wal.lsn == 10
    wal.append_delete(11, 99)
    wal.close()
    records, _ = _same_read(d)
    assert records[-1]["doc_id"] == 99 and records[-1]["lsn"] == 10


def _damage(paths: list[str], how: str) -> None:
    if how == "torn_tail":
        os.truncate(paths[-1], os.path.getsize(paths[-1]) - 3)
    elif how == "bitflip_mid_log":
        victim = paths[1]
        with open(victim, "r+b") as f:
            f.seek(os.path.getsize(victim) // 2)
            b = f.read(1)[0]
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([b ^ 0x40]))
    elif how == "dead_header":
        with open(paths[1], "r+b") as f:
            f.write(b"XXXX")


@pytest.mark.parametrize("how", ["torn_tail", "bitflip_mid_log",
                                 "dead_header"])
def test_damage_is_read_and_repaired_alike(tmp_path, how):
    """The same damage to the same log: both readers stop at the same
    frame, and re-opening for append repairs it to the same files and
    the same next lsn in either package."""
    logs = {}
    for pkg in ("port", "ref"):
        d = str(tmp_path / pkg)
        paths = _write_log(PKGS[pkg][0], d, "off", n=60,
                           segment_bytes=1 << 9)
        assert len(paths) > 2
        _damage(paths, how)
        logs[pkg] = d
    records, stats = _same_read(logs["port"])
    assert stats["torn"] and 0 < stats["n_records"] < 60
    lsns = {}
    for pkg, d in logs.items():
        wal = PKGS[pkg][0].WriteAheadLog(d, fsync="off")
        lsns[pkg] = wal.lsn
        wal.append_delete(wal.lsn + 1, 555)
        wal.close()
    assert lsns["port"] == lsns["ref"]
    _same_files(sorted(glob.glob(os.path.join(logs["port"], "wal-*.log"))),
                sorted(glob.glob(os.path.join(logs["ref"], "wal-*.log"))))
    records, stats = _same_read(logs["port"])
    assert not stats["torn"] and records[-1]["doc_id"] == 555


def test_truncate_upto_retires_the_same_segments(tmp_path):
    removed = {}
    for pkg in ("port", "ref"):
        d = str(tmp_path / pkg)
        wal = PKGS[pkg][0].WriteAheadLog(d, fsync="off",
                                         segment_bytes=1 << 9)
        for i in range(60):
            wal.append_delete(i + 1, i)
        wal.flush(fsync=False)
        removed[pkg] = wal.truncate_upto(37)
        wal.append_delete(61, 999)
        wal.close()
    assert removed["port"] == removed["ref"] > 0
    _same_files(sorted(glob.glob(str(tmp_path / "port" / "wal-*.log"))),
                sorted(glob.glob(str(tmp_path / "ref" / "wal-*.log"))))
    records, _ = _same_read(str(tmp_path / "port"))
    assert records[-1]["doc_id"] == 999


# ---------------------------------------------------------------------------
# the fault harness
# ---------------------------------------------------------------------------

def test_schedule_fires_on_nth_hit_as_the_reference():
    fired = {}
    for pkg in ("port", "ref"):
        f = PKGS[pkg][1]
        sched = f.FaultSchedule([("p", 3, "raise")])
        with f.install(sched):
            f.fault_point("p")
            f.fault_point("p")
            with pytest.raises(f.FaultInjected) as ei:
                f.fault_point("p")
            f.fault_point("p")                  # fires once, then disarms
        assert ei.value.point == "p"
        fired[pkg] = (dict(sched.hits), list(sched.fired))
    assert fired["port"] == fired["ref"] == ({"p": 4}, [("p", "raise")])


@pytest.mark.parametrize("plan,match", [([("p", 1, "explode")], "action"),
                                        ([("p", 0, "raise")], "1-based"),
                                        ([("p", 1, "delay")], "ms")])
def test_schedule_validation_matches(plan, match):
    for pkg in ("port", "ref"):
        with pytest.raises(ValueError, match=match):
            PKGS[pkg][1].FaultSchedule(plan)


def test_install_is_exclusive_and_per_package(tmp_path):
    """A schedule lives in the module it is installed in: one installed
    in the JAX package's ``faults`` never fires in the port's WAL, and
    the other way round."""
    with tfaults.install(tfaults.FaultSchedule([])):
        with pytest.raises(RuntimeError, match="already installed"):
            with tfaults.install(tfaults.FaultSchedule([])):
                pass
    tfaults.fault_point("p")
    for installed, other in (("ref", "port"), ("port", "ref")):
        f = PKGS[installed][1]
        wal = PKGS[other][0].WriteAheadLog(str(tmp_path / installed),
                                           fsync="always")
        sched = f.FaultSchedule([("wal.append.pre_write", 1, "raise")])
        with f.install(sched):
            wal.append_delete(1, 1)           # the other package: no fire
        wal.close()
        assert sched.hits == {} and sched.fired == []


@pytest.mark.parametrize("action", tfaults.CORRUPT_ACTIONS)
def test_corrupt_actions_damage_the_same_bytes(tmp_path, action):
    """The seeded corrupt actions, each installed in its own package,
    leave byte-identical damaged logs that both packages read and repair
    alike."""
    for pkg in ("port", "ref"):
        w, f = PKGS[pkg]
        wal = w.WriteAheadLog(str(tmp_path / pkg), fsync="always")
        for i in range(20):
            wal.append_delete(i + 1, i)
        with f.install(f.FaultSchedule(
                [("wal.append.pre_fsync", 1, action)], seed=3)):
            with pytest.raises(f.FaultInjected):
                wal.append_delete(21, 20)
        wal.close()
    port = sorted(glob.glob(str(tmp_path / "port" / "wal-*.log")))
    _same_files(port, sorted(glob.glob(str(tmp_path / "ref" /
                                           "wal-*.log"))))
    records, stats = _same_read(str(tmp_path / "port"))
    assert [r["doc_id"] for r in records] == \
        list(range(stats["n_records"]))


def test_corrupt_action_requires_path():
    with tfaults.install(tfaults.FaultSchedule([("nopath", 1,
                                                 "truncate")])):
        with pytest.raises(ValueError, match="path"):
            tfaults.fault_point("nopath", None)
