"""Uint8 term-weight quantization (PyTorch port of
``repro/core/quantization.py``).

Document weights are quantized with one global scale and the segment
maxima are taken from the quantized weights, so ``seg_max[i, j, t] >=
w_u8(t, d)`` holds exactly for every doc in segment (i, j) and every
rank-safety proposition holds exactly in quantized score space
(DESIGN.md §2). ``torch.round`` rounds half to even, as ``jnp.round``
does.
"""

from __future__ import annotations

import torch


def weight_scale(tw: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Global scale so the max live weight maps to 255."""
    mx = torch.where(mask, tw, 0.0).max()
    return torch.clamp(mx, min=1e-6) / 255.0


def quantize(tw: torch.Tensor, scale: torch.Tensor | float) -> torch.Tensor:
    """Round-to-nearest uint8 quantization of nonnegative weights."""
    return torch.clamp(torch.round(tw / scale), 0, 255).to(torch.uint8)


def dequantize(q: torch.Tensor, scale: torch.Tensor | float) -> torch.Tensor:
    return q.to(torch.float32) * scale
