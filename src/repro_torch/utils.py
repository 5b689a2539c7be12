"""Small shared helpers (PyTorch port of ``repro/utils.py``).

Only ``rank_within_run`` has a counterpart here. The reference's
``shard_map`` wrapper and its Pallas helpers have none: the port shards
nothing through them and runs no Pallas.
"""

from __future__ import annotations

import torch


def rank_within_run(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Position of each element within its run of equal keys (int64).

    ``sorted_keys`` must be sorted; used for balanced/capacity placement
    (k-means balancing, MoE expert dispatch). The reference scans the run
    starts with ``lax.associative_scan(jnp.maximum)``; ``cummax`` is the
    same running maximum."""
    n = sorted_keys.shape[0]
    idx = torch.arange(n, device=sorted_keys.device)
    new_run = torch.ones((n,), dtype=torch.bool, device=sorted_keys.device)
    new_run[1:] = sorted_keys[1:] != sorted_keys[:-1]
    run_start = torch.cummax(torch.where(new_run, idx, 0), dim=0).values
    return idx - run_start
