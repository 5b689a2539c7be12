"""Gradient compression for thin links (PyTorch port of
``repro/training/compression.py``).

int8 quantized mean-all-reduce with error feedback: each tensor is scaled
to int8 by the group's absmax (one ``MAX`` all-reduce of a scalar, so the
payloads sum exactly), the int32 payloads are summed over the
``torch.distributed`` group, dequantized and divided by the group's size,
and the quantization residual is carried to the next step. Rounding is
half to even, as ``jnp.round``'s.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.training.tree import leaves, structure, tree_map, unflatten


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_mean(grads, ef_state, group=None):
    """Mean over the ranks of ``group`` (None: the default group) of
    int8-compressed grads, with error feedback. Every rank of the group
    calls it with trees of the same structure. Returns (mean grads, new
    error-feedback state)."""
    if ef_state is None:
        ef_state = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                            grads)
    n = float(dist.get_world_size(group))

    def one(g, ef):
        g32 = g.float() + ef
        amax = torch.max(torch.abs(g32))
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = (amax + 1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        ef_new = g32 - q.float() * scale
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        mean = total.float() * scale / n
        return mean.to(g.dtype), ef_new

    outs = [one(g, ef) for g, ef in zip(leaves(grads), leaves(ef_state))]
    struct = structure(grads)
    return (unflatten(struct, [o[0] for o in outs]),
            unflatten(struct, [o[1] for o in outs]))
