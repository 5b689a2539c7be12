"""Dispatch wrapper for the segment-bound GEMM (K1).

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the CUDA kernel ``csrc/segment_bound.cu``, which replaces the Pallas
kernel ``repro/kernels/segment_bound/segment_bound.py::segment_bound_gemm``.
"""

from __future__ import annotations

import torch

from repro_torch.device import launch, require
from repro_torch.kernels.segment_bound.ref import segment_bound_gemm_ref


def segment_bound_gemm(table: torch.Tensor, qmap: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """table (S, V) uint8, qmap (Q, V) float32, scale () float32 ->
    (Q, S) float32 bounds. ``qmap`` may be a column slice of a wider map
    (the ``[:, :V]`` view of the (Q, V + 1) query maps): the kernel takes
    its row stride, so no copy is made."""
    if table.device.type == "cpu":
        return segment_bound_gemm_ref(table, qmap, scale)
    S, V = table.shape
    Q = qmap.shape[0]
    require(table, "table", (torch.uint8,))
    if qmap.shape != (Q, V) or qmap.dtype != torch.float32 \
            or qmap.device != table.device or qmap.stride(1) != 1:
        raise ValueError(f"qmap must be ({Q}, {V}) float32 with unit column "
                         f"stride on {table.device}")
    require(scale, "scale", (torch.float32,), ())
    out = torch.empty((Q, S), dtype=torch.float32, device=table.device)
    if Q and S:
        launch("segment_bound_gemm", table.data_ptr(), qmap.data_ptr(),
               qmap.stride(0), scale.data_ptr(), out.data_ptr(), S, Q, V)
        segment_bound_gemm.launches += 1
    return out


segment_bound_gemm.launches = 0
