"""Edge cases of the wave planner (``core/plan.py::plan_wave``), made with
numpy from fixed seeds.

Each case is one wave: admission masks and the wave's gathered tile
metadata (segment map, liveness, segment-major prefix table), plus the
planner's static arguments. Together they reach every branch of the
planner that the port's callers can: both union scopes, the collapsed
``n_seg == 1`` table, no layout metadata, a dirty unsorted tail, a query
count that is not a multiple of ``block_q``, a last wave with dead
positions, an all-empty wave, whole-tile doc blocking, tile slots past
``n_tiles`` and dead query-block slots, more than 32 positions and query
blocks, and a d_pad that is not a multiple of 32.

The CPU tests hold the port's plain planner to the JAX package's on these
cases; the ``gpu`` test and ``chip_smoke.py`` hold the planner kernel to
the plain planner on the same cases.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PlanCase:
    """One wave: ``arrays`` holds cids (G,) int32, live (G,) bool, admit
    (n_q, G) bool, seg_admit (n_q, G, n_seg) bool, doc_seg_mod (G, d_pad)
    int32, doc_mask (G, d_pad) bool, seg_offsets (G, n_seg + 1) int32 and
    sorted_upto (G,) int32 (both None: no layout metadata)."""

    name: str
    arrays: dict
    block_q: int
    block_d: int | None
    union_scope: str = "qblock"

    def args(self, device) -> tuple[tuple, dict]:
        """(positional, keyword) arguments of ``plan_wave`` on ``device``."""
        t = {k: None if v is None else torch.from_numpy(v).to(device)
             for k, v in self.arrays.items()}
        return ((t["cids"], t["live"], t["admit"], t["seg_admit"],
                 self.block_q, t["doc_seg_mod"], t["doc_mask"]),
                dict(block_d=self.block_d, seg_offsets=t["seg_offsets"],
                     sorted_upto=t["sorted_upto"],
                     union_scope=self.union_scope))


def _wave(seed: int, G: int, n_q: int, n_seg: int, d_pad: int, *,
          dirty: bool = False, p_admit: float = 0.6,
          p_seg: float = 0.4) -> dict:
    """Random tiles in the segment-major layout (a sorted prefix grouped
    by segment, then, when ``dirty``, an unsorted tail), about 10% of the
    docs tombstoned, and random admission."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((G, d_pad), np.int32)
    mask = np.zeros((G, d_pad), bool)
    off = np.zeros((G, n_seg + 1), np.int32)
    su = np.zeros(G, np.int32)
    for g in range(G):
        nc = int(rng.integers(d_pad // 2, d_pad + 1))
        prefix = int(rng.integers(0, nc + 1)) if dirty and g % 2 else nc
        seg[g, :prefix] = np.sort(rng.integers(0, n_seg, prefix))
        seg[g, prefix:nc] = rng.integers(0, n_seg, nc - prefix)
        mask[g, :nc] = rng.random(nc) >= 0.1
        off[g, 1:] = np.cumsum(np.bincount(seg[g, :prefix],
                                           minlength=n_seg))
        su[g] = prefix
    admit = rng.random((n_q, G)) < p_admit
    seg_admit = (rng.random((n_q, G, n_seg)) < p_seg) & admit[..., None]
    return dict(cids=rng.permutation(4 * G)[:G].astype(np.int32),
                live=np.ones(G, bool), admit=admit, seg_admit=seg_admit,
                doc_seg_mod=seg, doc_mask=mask, seg_offsets=off,
                sorted_upto=su)


def _with(arrays: dict, **changes) -> dict:
    return {**arrays, **changes}


def plan_cases() -> list[PlanCase]:
    """The planner's edge cases, each one wave."""
    base = _wave(1, G=8, n_q=12, n_seg=4, d_pad=64)
    few = _wave(2, G=8, n_q=12, n_seg=4, d_pad=64, p_admit=0.15)
    few["admit"][:, 2:7] = False       # two tiles admitted of eight
    few["seg_admit"] &= few["admit"][..., None]
    partial = _with(base, live=np.arange(8) < 5)
    empty = _with(base, admit=np.zeros_like(base["admit"]),
                  seg_admit=np.zeros_like(base["seg_admit"]))
    serve = _wave(5, G=32, n_q=64, n_seg=8, d_pad=256, p_admit=0.8,
                  p_seg=0.3)
    return [
        PlanCase("qblock", base, 4, 8),
        PlanCase("batch_union", base, 4, 8, "batch"),
        PlanCase("collapsed_table", _with(
            base, seg_admit=base["seg_admit"].any(-1, keepdims=True)), 4, 8),
        PlanCase("no_layout", _with(base, seg_offsets=None,
                                    sorted_upto=None), 4, 16),
        PlanCase("dirty_tail", _wave(3, G=8, n_q=12, n_seg=4, d_pad=64,
                                     dirty=True), 4, 8),
        PlanCase("ragged_query_blocks", _wave(4, G=8, n_q=37, n_seg=4,
                                              d_pad=64, dirty=True), 16, 8),
        PlanCase("partial_last_wave", partial, 4, 8),
        PlanCase("empty_wave", empty, 4, 8),
        PlanCase("whole_tile", base, 4, None),
        PlanCase("dead_slots", few, 2, 8),
        PlanCase("wide", _wave(6, G=40, n_q=40, n_seg=5, d_pad=100,
                               dirty=True, p_admit=0.3), 1, 25, "batch"),
        PlanCase("serve_like", serve, 64, 32),
    ]
