"""Architecture registry: ``--arch <id>`` resolution for the port.

Every arch id of :mod:`repro.configs.registry` has a module in the port
(:data:`PORTED`): the dense decoders (llama3.2-1b, qwen2-7b, minitron-8b,
granite-20b), deepseek-v2-lite-16b and deepseek-v3-671b (MLA + MoE; v3
with a low-rank Q and the MTP head), falcon-mamba-7b (Mamba-1),
recurrentgemma-2b (RG-LRU + rolling-window MQA), whisper-small
(encoder-decoder) and internvl2-2b (a dense decoder behind precomputed
patch embeddings). An unknown id raises a ``KeyError``.
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
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "whisper-small": "repro_torch.configs.whisper_small",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
}

PORTED = tuple(_MODULES)


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {list(ARCH_IDS)}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
