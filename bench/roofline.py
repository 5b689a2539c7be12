"""Peaks of the card and the work each stage's inputs need.

A stage's share of its roofline is the least time its work needs on the
card, divided by the device time of every kernel launched inside the
stage's ranges. The least time is the larger of the bytes over the HBM
bandwidth and the operations over the matching peak; every input byte is
counted read once and every output byte written once, whatever the
kernels read again, and where the work depends on the data it is what
these inputs need, not the most they could. The bound arithmetic is
``chip_smoke.py``'s (``bound``, the K1 row of ``phase_kernels``).
"""

from __future__ import annotations

# One NVIDIA H100 SXM5 80GB, NVIDIA's data sheet, dense, at the full
# 700 W power limit (each run records the card's own limit beside its
# numbers): HBM3 bytes/s and fp32 FMA outside the tensor cores.
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12


def least_time(bytes_moved: float, ops: float,
               op_peak: float = FP32_FLOP_S) -> tuple[float, str]:
    """(seconds, "bytes" or "ops"): the bound that binds."""
    t_bytes = bytes_moved / HBM_BYTES_S
    t_ops = ops / op_peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "ops")


def share(work: dict) -> tuple[float, str] | None:
    """(percent of the roofline, the bound) of a stage's recorded work and
    device time; None where the stage ran no kernel."""
    if not work or work.get("device_s", 0.0) <= 0.0:
        return None
    t, by = least_time(work["bytes"], work["ops"])
    return 100.0 * t / work["device_s"], by


def bounds_work(rows: int, n_q: int, q_pad: int, union: int,
                nnz: int) -> tuple[float, float]:
    """K1 over a ``rows``-row uint8 table: the union terms' columns of the
    table read once, the queries' term lists (id and weight, 8 bytes a
    slot) and counts, the (n_q, rows) fp32 bounds written; one FMA per
    (query term, row)."""
    return (union * rows + n_q * q_pad * 8 + n_q * 4 + n_q * rows * 4,
            2.0 * nnz * rows)


def plan_work(in_bytes: int, out_bytes: int) -> tuple[float, float]:
    """The planner: its masks and segment tables read once, its queues
    written once (their sizes as allocated); no arithmetic counted."""
    return float(in_bytes + out_bytes), 0.0


def score_work(union_docs: int, t_pad: int, tid_bytes: int, pairs: int,
               n_q: int, q_pad: int, calls: int) -> tuple[float, float]:
    """The executor: each document some query admitted read once a wave
    (its padded row of term ids and uint8 weights), the queries' term
    lists once a wave, one fp32 score written per admitted (query,
    document) pair. The multiply-adds are not counted (a pair's matching
    terms are few; bytes bind)."""
    return (union_docs * t_pad * (tid_bytes + 1) + calls * n_q * q_pad * 8
            + pairs * 4), 0.0


def merge_work(pairs: int, n_q: int, k: int, calls: int
               ) -> tuple[float, float]:
    """The merge: the admitted pairs' scores read once, each wave's
    running top-k (score and id) read and written, the new top-k's ids
    gathered; no arithmetic counted."""
    return float(pairs * 4 + calls * n_q * k * (8 + 8 + 4)), 0.0
