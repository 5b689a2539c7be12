"""Architecture registry: ``--arch <id>`` resolution (PyTorch port of
``repro/configs/__init__.py``).

All eleven architectures of the reference are named. Those whose model is
ported resolve to their config module; for the others ``get_arch`` raises
an error naming the module still to port, and ``arch_kind`` answers from
the table below without importing anything.
"""

from __future__ import annotations

import importlib

ARCHS = {
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "asc-splade": "repro_torch.configs.asc_splade",
}

# id -> (kind, the port module its model needs)
NOT_PORTED = {
    "llama4-scout-17b-a16e": ("lm", "repro_torch/models/moe.py"),
    "olmoe-1b-7b": ("lm", "repro_torch/models/moe.py"),
    "meshgraphnet": ("gnn", "repro_torch/models/gnn.py"),
    "dlrm-mlperf": ("recsys", "repro_torch/models/recsys.py"),
    "din": ("recsys", "repro_torch/models/recsys.py"),
    "deepfm": ("recsys", "repro_torch/models/recsys.py"),
    "bert4rec": ("recsys", "repro_torch/models/recsys.py"),
}


def missing_module(name: str) -> str | None:
    """The port module ``name``'s model still needs, or None."""
    _known(name)
    return NOT_PORTED[name][1] if name in NOT_PORTED else None


def _known(name: str) -> None:
    if name not in ARCHS and name not in NOT_PORTED:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")


def get_arch(name: str):
    missing = missing_module(name)
    if missing:
        raise NotImplementedError(
            f"arch {name!r} needs {missing}, which is not ported to "
            f"repro_torch yet")
    return importlib.import_module(ARCHS[name])


def arch_kind(name: str) -> str:
    _known(name)
    if name in NOT_PORTED:
        return NOT_PORTED[name][0]
    return get_arch(name).KIND


def list_archs() -> list[str]:
    return sorted({**ARCHS, **NOT_PORTED})
