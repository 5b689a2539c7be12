"""Architecture registry: ``--arch <id>`` resolution (PyTorch port of
``repro/configs/__init__.py``).

All eleven architectures of the reference resolve to their config module.
``NOT_PORTED`` would name an architecture whose model still has a module
to port (``get_arch`` then raises naming it, and ``arch_kind`` answers
without importing anything); it is empty.
"""

from __future__ import annotations

import importlib

ARCHS = {
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "asc-splade": "repro_torch.configs.asc_splade",
    "meshgraphnet": "repro_torch.configs.meshgraphnet",
    "dlrm-mlperf": "repro_torch.configs.dlrm_mlperf",
    "din": "repro_torch.configs.din",
    "deepfm": "repro_torch.configs.deepfm",
    "bert4rec": "repro_torch.configs.bert4rec",
}

# id -> (kind, the port module its model needs)
NOT_PORTED: dict[str, tuple[str, str]] = {}


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
