"""Share of its roofline of the executor (K2,
`kernels/score_cluster_batch`): the admitted documents' rows and scores
(bench/roofline.py), over the device time of the kernels launched inside
the ``bench.score`` ranges of the traced batches."""

from bench import roofline


def read(rec: dict):
    got = roofline.share((rec["trace"] or {}).get("stages", {}).get("score"))
    if got is None:
        return None
    return {"value": got[0], "bound_by": got[1]}
