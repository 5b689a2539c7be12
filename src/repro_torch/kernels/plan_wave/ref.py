"""Reference the planner's compaction is pinned against."""

from __future__ import annotations

import torch


def compact_front_ref(keep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Argsort-based stable front-compaction — the planner's original
    formulation (``repro/kernels/plan_wave/ref.py``). keep (..., n) bool ->
    (idx (..., n) int32, count (...,) int32), tail clamped to the last
    True position (0 for an empty row)."""
    n = keep.shape[-1]
    order = torch.argsort((~keep).to(torch.uint8), dim=-1, stable=True)
    count = keep.sum(dim=-1, dtype=torch.int32)
    slot = torch.arange(n, dtype=torch.int32, device=keep.device)
    clamp = torch.minimum(slot, (count[..., None] - 1).clamp_min(0))
    idx = torch.gather(order, -1, clamp.long()).to(torch.int32)
    return idx, count
