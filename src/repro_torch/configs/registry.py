"""Architecture registry: ``--arch <id>`` resolution for the port.

Every arch id of :mod:`repro.configs.registry` is known here, but only the
ones in :data:`PORTED` have a module in the port yet; the others raise a
clear "not ported yet" error instead of a ``KeyError``.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

# the reference's arch ids, in its order
ARCH_IDS = (
    "internvl2-2b", "minitron-8b", "granite-20b", "qwen2-7b", "llama3.2-1b",
    "deepseek-v2-lite-16b", "deepseek-v3-671b", "falcon-mamba-7b",
    "whisper-small", "recurrentgemma-2b",
)

_MODULES: Dict[str, str] = {
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
}

PORTED = tuple(_MODULES)


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {list(ARCH_IDS)}")
    if arch not in _MODULES:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet; repro_torch serves "
            f"{list(PORTED)}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
