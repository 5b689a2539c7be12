"""The port's one top-k order, shared by retrieval and the models."""

from __future__ import annotations

import torch


def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, value descending and index ascending on
    ties — ``jax.lax.top_k``'s order, which ``torch.topk`` does not keep."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
