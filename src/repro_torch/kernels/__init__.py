"""Hand-written CUDA kernels (``csrc/``) with a plain PyTorch version and
a dispatch wrapper beside each.

Each wrapper carries a plain integer ``launches`` counter that it bumps
where it launches its kernel, and nowhere else, so a run can show that
the main path went through the kernels.
"""

from __future__ import annotations

# the kernels the main path launches: the bounds (K1), the executor (K2),
# the wave planner (K3), the per-query scorer (K4) and the wave's merge.
# compact_front (one compaction) and score_docs (a flat batch on a dense
# map) are entry points of their own that the main path no longer calls.
MAIN_PATH = ("segment_bound_gemm", "score_queue", "plan_wave",
             "score_clusters", "merge_topk")


def wrappers() -> dict:
    """Kernel name -> its dispatch wrapper (the launch counters live on
    these functions)."""
    from repro_torch.kernels.merge_topk.ops import merge_topk
    from repro_torch.kernels.plan_wave.compact import compact_front
    from repro_torch.kernels.plan_wave.ops import plan_wave_kernel
    from repro_torch.kernels.score_cluster_batch.ops import score_admitted
    from repro_torch.kernels.score_docs.ops import score_clusters, score_docs
    from repro_torch.kernels.segment_bound.ops import segment_bound_gemm
    return {"segment_bound_gemm": segment_bound_gemm,
            "score_queue": score_admitted,
            "plan_wave": plan_wave_kernel,
            "compact_front": compact_front,
            "score_clusters": score_clusters,
            "score_docs": score_docs,
            "merge_topk": merge_topk}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0
