"""The one-call wave planner on the card (K3).

:func:`plan_wave_kernel` launches ``csrc/plan_wave.cu``, which turns one
wave's admission masks into every queue field of ``core/plan.py::
WavePlan`` with no host read: the counterpart of the reference's
``repro/kernels/plan_wave/ops.py::plan_wave_device``, whose six
``compact_front_pallas`` calls it replaces. ``core/plan.py::plan_wave``
calls it for CUDA tensors when no ``_compact`` backend is injected; its
plain version is that function's op-by-op code (CPU tensors, or an
explicit ``_compact``). CUDA tensors only: this module has no CPU path.

The outputs are carved out of one int32 buffer a wave (one allocation,
one split), as contiguous views.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.device import launch, require

_I32 = (torch.int32,)
_BOOL = (torch.bool,)

# WavePlan fields the kernel writes, in the buffer's order, with their
# shapes in (G, n_qb, R, n_db)
_FIELDS = (("tile_cids", "G"), ("tile_pos", "G"), ("n_tiles", ""),
           ("qblock", "G q"), ("n_qblock", "G"), ("n_blocks", ""),
           ("drun_start", "G q R"), ("drun_len", "G q R"),
           ("n_drun", "G q"), ("dblock", "G q D"), ("n_dblock", "G q"))


def plan_wave_kernel(cids: torch.Tensor, live: torch.Tensor,
                     admit: torch.Tensor, seg_admit: torch.Tensor,
                     block_q: int, doc_seg_mod: torch.Tensor,
                     doc_mask: torch.Tensor, block_d: int,
                     seg_offsets: torch.Tensor | None,
                     sorted_upto: torch.Tensor | None,
                     union_scope: str) -> dict:
    """The WavePlan queue fields of one wave (``plan_wave``'s arguments,
    ``block_d`` already resolved to a divisor of d_pad) as a dict of
    views: tile_cids, tile_pos, n_tiles, qblock, n_qblock, n_blocks,
    drun_start, drun_len, n_drun, dblock, n_dblock, dmask_union."""
    dev = admit.device
    n_q, G = admit.shape
    dp = doc_mask.shape[-1]
    ns = seg_admit.shape[-1]
    n_qb = -(-n_q // block_q)
    n_db = dp // block_d
    R = ns + dp // 2 + 1
    if not 1 <= ns <= 32:
        raise ValueError(f"the planner kernel keeps a segment set in 32 "
                         f"bits; got {ns} segments")
    if dp % block_d:
        raise ValueError(f"block_d {block_d} does not divide d_pad {dp}")
    admit, seg_admit = admit.contiguous(), seg_admit.contiguous()
    doc_seg_mod, doc_mask = doc_seg_mod.contiguous(), doc_mask.contiguous()
    require(cids, "cids", _I32, (G,))
    require(live, "live", _BOOL, (G,))
    require(admit, "admit", _BOOL, (n_q, G))
    require(seg_admit, "seg_admit", _BOOL, (n_q, G, ns))
    require(doc_seg_mod, "doc_seg_mod", _I32, (G, dp))
    require(doc_mask, "doc_mask", _BOOL, (G, dp))
    off_ptr = su_ptr = None
    off_w = 0
    if seg_offsets is not None and sorted_upto is not None:
        seg_offsets = seg_offsets.contiguous()
        off_w = seg_offsets.shape[-1]
        require(seg_offsets, "seg_offsets", _I32,
                (G, off_w if ns == 1 else ns + 1))
        require(sorted_upto, "sorted_upto", _I32, (G,))
        off_ptr, su_ptr = seg_offsets.data_ptr(), sorted_upto.data_ptr()

    sizes, shapes = _layout(G, n_qb, R, n_db, dp)
    parts = torch.empty(sum(sizes), dtype=torch.int32,
                        device=dev).split_with_sizes(sizes)
    out = {name: part.view(shape) if len(shape) != 1 else part
           for (name, _), part, shape in zip(_FIELDS, parts, shapes)}
    scratch = parts[len(_FIELDS)]
    out["dmask_union"] = (parts[-1].view(torch.uint8)[:G * n_qb * dp]
                          .view(torch.bool).view(G, n_qb, dp))
    launch("plan_wave", cids.data_ptr(), live.data_ptr(), admit.data_ptr(),
           seg_admit.data_ptr(), doc_seg_mod.data_ptr(), doc_mask.data_ptr(),
           off_ptr, off_w, su_ptr, scratch.data_ptr(),
           *(out[name].data_ptr() for name, _ in _FIELDS),
           out["dmask_union"].data_ptr(), n_q, G, ns, dp, block_q, n_qb,
           block_d, n_db, R, int(union_scope == "batch"))
    plan_wave_kernel.launches += 2          # the per-tile, then per-slot phase
    return out


plan_wave_kernel.launches = 0


@functools.lru_cache(maxsize=64)
def _layout(G: int, n_qb: int, R: int, n_db: int, dp: int
            ) -> tuple[list[int], list[tuple]]:
    """(int32 sizes, shapes) of the wave's buffer: the fields of _FIELDS,
    the scratch the first kernel hands the second (1 + 2 * n_qb ints a
    wave position), and the union mask's bytes rounded up to ints."""
    dims = {"G": G, "q": n_qb, "R": R, "D": n_db}
    shapes = [tuple(dims[k] for k in spec.split()) for _, spec in _FIELDS]
    sizes = [math.prod(s) for s in shapes]
    return sizes + [G * (1 + 2 * n_qb), -(-G * n_qb * dp // 4)], shapes
