"""Share of the traced window in which no operation ran on the card:
1 minus the union of the device operations' intervals over the window.
The window is traced, so the share includes the profiler's own host
cost (traced batches run slower than untraced ones); the benchmark's
ranges add nothing on the device."""


def read(rec: dict):
    tr = rec["trace"]
    if not tr or tr["busy_s"] <= 0.0 or tr["window_s"] <= 0.0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
