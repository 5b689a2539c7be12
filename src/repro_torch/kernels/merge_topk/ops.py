"""Dispatch wrapper for the wave's merge.

A CPU tensor goes to the plain version (``ref.py``, the sort path); a
CUDA tensor goes to the CUDA kernel ``csrc/merge_topk.cu``, at every k,
which replaces no Pallas kernel (the JAX package merges with ``lax.top_k``
under XLA). Both give the same scores and ids bit for bit.
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import launch, require
from repro_torch.kernels.merge_topk.ref import merge_wave_ref

MERGE_MAX_CLUSTER = 8     # blocks a row, at most (kMaxCluster)
MERGE_BLOCKS_AN_SM = 4    # blocks the grid aims at for each SM
MERGE_MIN_SLICE = 4096    # scores a block reads, at least, where it splits
MERGE_BUFFER = 2048       # keys a block buffers behind its list (kBuf)
MERGE_SHARED_KEYS = 16384  # the deepest workspace kept in shared memory


def merge_keys(k: int) -> int:
    """Keys in a block's workspace: the power of two that holds the list
    and its buffer, and, in a cluster's first block, two lists at least
    (its own and the running top-k)."""
    need = max(k + MERGE_BUFFER, 2 * k)
    return 1 << (need - 1).bit_length()


def merge_cluster(n_q: int, L: int, k: int, n_sm: int) -> int:
    """Blocks that share one row (a power of two): enough for about
    ``MERGE_BLOCKS_AN_SM`` blocks an SM over ``n_q`` rows, while each
    keeps a slice of at least ``MERGE_MIN_SLICE`` scores; no more than the
    first block's workspace holds lists of, beside the running top-k."""
    want = min(-(-MERGE_BLOCKS_AN_SM * n_sm // max(n_q, 1)),
               MERGE_MAX_CLUSTER, max(1, L // MERGE_MIN_SLICE))
    cs = 1
    while cs < want:
        cs *= 2
    while (cs + 1) * k > merge_keys(k):
        cs //= 2
    return min(cs, MERGE_MAX_CLUSTER)


def merge_topk(top_scores: torch.Tensor, top_ids: torch.Tensor,
               scores: torch.Tensor, theta: torch.Tensor,
               ids_flat: torch.Tensor, k: int) -> tuple:
    """One wave's (n_q, G, d_pad) float32 scores merged into the running
    (n_q, k) top-k: the scores above ``theta`` (n_q,), joined with
    ``top_scores``/``top_ids``, the k best kept, a wave entry's id from
    ``ids_flat`` (G * d_pad,) int32 (-1 at NEG). Returns the new
    (top_scores, top_ids); ``theta`` may be a strided column view."""
    if scores.device.type == "cpu":
        return merge_wave_ref(top_scores, top_ids, scores, theta, ids_flat,
                              k)
    if k < 1:
        raise ValueError(f"the merge keeps at least one entry a row, not "
                         f"k = {k}")
    n_q, L = scores.shape[0], math.prod(scores.shape[1:])
    if L + k >= 2 ** 31:
        raise ValueError(f"a wave of {L} scores a row is too wide")
    require(scores, "scores", (torch.float32,))
    require(top_scores, "top_scores", (torch.float32,), (n_q, k))
    require(top_ids, "top_ids", (torch.int32,), (n_q, k))
    require(ids_flat, "ids_flat", (torch.int32,), (L,))
    if theta.device.type != "cuda" or theta.dtype != torch.float32 \
            or tuple(theta.shape) != (n_q,):
        raise ValueError(f"theta must be a ({n_q},) float32 CUDA tensor")
    out_s = torch.empty((n_q, k), dtype=torch.float32, device=scores.device)
    out_i = torch.empty((n_q, k), dtype=torch.int32, device=scores.device)
    if n_q:
        n_sm = torch.cuda.get_device_properties(
            scores.device).multi_processor_count
        cs, cap = merge_cluster(n_q, L, k, n_sm), merge_keys(k)
        work = None if cap <= MERGE_SHARED_KEYS else torch.empty(
            n_q * cs * cap, dtype=torch.int64, device=scores.device)
        vec = L % 4 == 0 and scores.data_ptr() % 16 == 0
        launch("merge_topk", scores.data_ptr(), theta.data_ptr(),
               theta.stride(0), top_scores.data_ptr(), top_ids.data_ptr(),
               ids_flat.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
               None if work is None else work.data_ptr(), n_q, L, k, cs,
               cap, int(vec))
        merge_topk.launches += 1
    return out_s, out_i


merge_topk.launches = 0
