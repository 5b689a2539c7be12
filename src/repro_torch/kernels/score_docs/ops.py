"""Dispatch wrapper for per-query document scoring (K4).

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the CUDA kernel ``csrc/score_docs.cu``, which replaces the Pallas kernel
``repro/kernels/score_docs/score_docs.py::score_docs_kernel``. Accepts the
search layer's (..., d_pad, t_pad) cluster blocks and flattens them.
"""

from __future__ import annotations

import torch

from repro_torch.device import launch, require
from repro_torch.kernels.score_docs.ref import score_docs_ref

# dynamic shared memory one block may use on the H100 (after the opt-in)
MAX_SMEM_BYTES = 232448


def score_docs(doc_tids: torch.Tensor, doc_tw: torch.Tensor,
               qmap: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """doc_tids/doc_tw: (..., t_pad); qmap: (V + 1,). Returns (...,)."""
    if doc_tids.device.type == "cpu":
        return score_docs_ref(doc_tids, doc_tw, qmap, scale)
    lead = doc_tids.shape[:-1]
    t = doc_tids.shape[-1]
    tids = doc_tids.reshape(-1, t).contiguous()
    tw = doc_tw.reshape(-1, t).contiguous()
    require(tids, "doc_tids", (torch.uint16, torch.int32))
    require(tw, "doc_tw", (torch.uint8,), tids.shape)
    require(qmap, "qmap", (torch.float32,))
    require(scale, "scale", (torch.float32,), ())
    if qmap.numel() * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"a query map of {qmap.numel()} floats does not fit "
                         f"the {MAX_SMEM_BYTES} bytes of shared memory a "
                         f"block may use")
    out = torch.empty((tids.shape[0],), dtype=torch.float32,
                      device=doc_tids.device)
    if tids.shape[0]:
        launch("score_docs", tids.data_ptr(), tids.element_size(),
               tw.data_ptr(), qmap.data_ptr(), scale.data_ptr(),
               out.data_ptr(), tids.shape[0], t, qmap.shape[0])
        score_docs.launches += 1
    return out.reshape(lead)


score_docs.launches = 0
