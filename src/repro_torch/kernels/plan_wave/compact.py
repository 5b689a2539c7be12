"""Queue compaction: stable front-compaction of boolean admission rows.

This is the scan behind every planner queue (tile, query block, doc run,
doc sub-tile): "indices of the True entries of a mask, moved to the front
in order, tail clamped to the last True entry", plus the True count.

  * :func:`compact_front_plain` — the plain PyTorch version: inclusive
    rank by ``cumsum``, then the position of the (j+1)-th True entry by a
    row-wise ``searchsorted`` over the monotone cumsum at the clamped slot
    targets (the formulation of the reference's XLA ``compact_front``);
  * :func:`compact_front` — the dispatch: a CPU tensor goes to the plain
    version, a CUDA tensor to the CUDA kernel ``csrc/compact_front.cu``
    (K3), which replaces the Pallas kernel
    ``repro/kernels/plan_wave/compact.py::compact_front_pallas``.

Both are bit-identical to ``ref.py::compact_front_ref`` and to the
reference's three backends, empty rows (index 0) and full rows included.
"""

from __future__ import annotations

import torch

from repro_torch.device import launch


def compact_front_plain(keep: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """keep (..., n) bool -> (idx (..., n) int32, count (...,) int32)."""
    n = keep.shape[-1]
    lead = keep.shape[:-1]
    keep2 = keep.reshape(-1, n)
    cs = torch.cumsum(keep2.to(torch.int32), dim=-1, dtype=torch.int32)
    count = cs[:, -1]
    pos = torch.arange(n, dtype=torch.int32, device=keep.device)
    # clamp the slot targets first, then binary-search: the position of
    # the t-th True entry (1-based) is the first p with cs[p] >= t
    tgt = torch.minimum(pos[None], (count[:, None] - 1).clamp_min(0)) + 1
    idx = torch.searchsorted(cs, tgt, side="left")
    idx = torch.where(count[:, None] > 0, idx, 0).to(torch.int32)
    return idx.reshape(*lead, n), count.reshape(lead)


def compact_front(keep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatching front-compaction; same contract as
    :func:`compact_front_plain`."""
    if keep.device.type == "cpu":
        return compact_front_plain(keep)
    if keep.dtype != torch.bool:
        raise TypeError(f"keep must be bool, got {keep.dtype}")
    n = keep.shape[-1]
    lead = keep.shape[:-1]
    keep2 = keep.reshape(-1, n).contiguous()
    rows = keep2.shape[0]
    idx = torch.empty((rows, n), dtype=torch.int32, device=keep.device)
    count = torch.empty((rows,), dtype=torch.int32, device=keep.device)
    if rows and n:
        launch("compact_front", keep2.data_ptr(), idx.data_ptr(),
               count.data_ptr(), rows, n)
        compact_front.launches += 1
    return idx.reshape(*lead, n), count.reshape(lead)


compact_front.launches = 0
