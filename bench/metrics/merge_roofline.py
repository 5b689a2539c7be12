"""Share of its roofline of the merge (`core/search.py::_merge_wave`): the
admitted scores read, the top-k written (bench/roofline.py), over the
device time of the kernels launched inside the ``bench.merge`` ranges of
the traced batches."""

from bench import roofline


def read(rec: dict):
    got = roofline.share((rec["trace"] or {}).get("stages", {}).get("merge"))
    if got is None:
        return None
    return {"value": got[0], "bound_by": got[1]}
