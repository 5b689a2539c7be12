"""Waves a batch walks (``engine.last_run["waves"]``), mean over the
window's batches: the wave loop of ``core/search.py::_search_batch``."""


def read(rec: dict):
    waves = rec["batches"]["waves"]
    return sum(waves) / len(waves) if waves else None
