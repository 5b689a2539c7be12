"""The main path with its kernels swapped out, on whatever device the
index lives on.

:func:`swapped_wrappers` replaces the five kernel wrappers where the
engines look them up; with :func:`plain_versions` as the stand-in every
engine runs each kernel's plain PyTorch version on the same (card)
tensors, which is what ``chip_smoke.py`` and the ``gpu`` tests hold the
kernel path against. The stand-ins are called as the wrappers are.
"""

from __future__ import annotations

import contextlib

# the WavePlan fields the planner kernel writes
PLANNED = ("tile_cids", "tile_pos", "n_tiles", "qblock", "n_qblock",
           "n_blocks", "drun_start", "drun_len", "n_drun", "dblock",
           "n_dblock", "dmask_union")


@contextlib.contextmanager
def swapped_wrappers(make):
    """Replace the five kernel wrappers where the main path looks them up
    (``make(name, wrapper)`` gives the stand-in); restore them on exit."""
    import repro_torch.core.bounds as bounds_mod
    import repro_torch.core.plan as plan_mod
    import repro_torch.core.search as search_mod

    sites = [(bounds_mod, "segment_bound_gemm"),
             (search_mod, "score_admitted"), (search_mod, "score_clusters"),
             (plan_mod, "plan_wave_kernel"), (search_mod, "merge_topk")]
    originals = [(mod, name, getattr(mod, name)) for mod, name in sites]
    try:
        for mod, name, fn in originals:
            setattr(mod, name, make(name, fn))
        yield
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)


def score_admitted_plain(tids, tw, dseg, dmask, terms, plan, scale, **_):
    """K2's plain version over the wave's gathered tiles and the batch's
    dense maps, called as the wrapper is (full index arrays and the term
    layout; block_v/impl do not change values)."""
    from repro_torch.core.types import take_rows
    from repro_torch.kernels.score_cluster_batch.ref import score_admitted_ref
    cl = plan.cids.long()
    return score_admitted_ref(take_rows(tids, cl), tw[cl], dseg, dmask,
                              terms.qmaps, plan, scale)


def plan_wave_plain(cids, live, admit, seg_admit, block_q, doc_seg_mod,
                    doc_mask, block_d, seg_offsets, sorted_upto,
                    union_scope):
    """The planner kernel's plain version, called as the kernel's wrapper
    is: the op-by-op planner on the plain compaction, its queue fields."""
    from repro_torch.core.plan import plan_wave
    from repro_torch.kernels.plan_wave.compact import compact_front_plain
    plan = plan_wave(cids, live, admit, seg_admit, block_q, doc_seg_mod,
                     doc_mask, block_d=block_d, seg_offsets=seg_offsets,
                     sorted_upto=sorted_upto, union_scope=union_scope,
                     _compact=compact_front_plain)
    return {f: getattr(plan, f) for f in PLANNED}


def score_clusters_plain(tids, tw, dseg, dmask, cids, seg_admit, terms, i,
                         scale):
    """K4's plain version, called as its wrapper is: the gathered tiles
    against the query's dense map, masked."""
    from repro_torch.kernels.score_docs.ref import score_clusters_ref
    return score_clusters_ref(tids, tw, dseg, dmask, cids, seg_admit,
                              terms.qmaps[i], scale)


def plain_versions(name, _):
    """Stand-ins for :func:`swapped_wrappers`: each kernel's plain
    PyTorch version on the same tensors."""
    from repro_torch.kernels.merge_topk.ref import merge_wave_ref
    from repro_torch.kernels.segment_bound.ref import segment_bound_gemm_ref
    return {"segment_bound_gemm": segment_bound_gemm_ref,
            "score_admitted": score_admitted_plain,
            "score_clusters": score_clusters_plain,
            "plan_wave_kernel": plan_wave_plain,
            "merge_topk": merge_wave_ref}[name]
