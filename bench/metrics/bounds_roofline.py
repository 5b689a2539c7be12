"""Share of its roofline of the bound pass (K1, `kernels/segment_bound`):
the union terms' columns of the segment-max table (bench/roofline.py),
over the device time of the kernels launched inside the ``bench.bounds``
ranges of the traced batches."""

from bench import roofline


def read(rec: dict):
    got = roofline.share((rec["trace"] or {}).get("stages", {}).get("bounds"))
    if got is None:
        return None
    return {"value": got[0], "bound_by": got[1]}
