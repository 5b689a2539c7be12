"""Share of its roofline of the wave planner (K3, `kernels/plan_wave`): its
masks and queues (bench/roofline.py), over the device time of the
kernels launched inside the ``bench.plan`` ranges of the traced batches."""

from bench import roofline


def read(rec: dict):
    got = roofline.share((rec["trace"] or {}).get("stages", {}).get("plan"))
    if got is None:
        return None
    return {"value": got[0], "bound_by": got[1]}
