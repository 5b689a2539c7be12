"""Seconds of ``repro_torch.core.index.build_index`` in the run's set-up
(host clock around the call, to a synchronize)."""


def read(rec: dict):
    return rec["build_index_s"]
