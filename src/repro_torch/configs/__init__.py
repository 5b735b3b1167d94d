"""Assigned architecture registry (``--arch <id>``).

Each module defines ``CONFIG`` (the exact published configuration) and
``SMOKE_CONFIG`` (a reduced same-family configuration for CPU smoke tests).
Data only: a copy of the reference package's ``configs/``.  The port builds
models of the dense, ssm and hybrid families; building an MoE model
(``granite_moe_3b_a800m``, ``kimi_k2_1t_a32b``) raises
``NotImplementedError`` in ``repro_torch.models.model``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ArchConfig

ARCH_IDS: List[str] = [
    "phi_3_vision_4_2b",
    "kimi_k2_1t_a32b",
    "granite_moe_3b_a800m",
    "musicgen_large",
    "starcoder2_15b",
    "deepseek_7b",
    "internlm2_20b",
    "llama3_405b",
    "hymba_1_5b",
    "falcon_mamba_7b",
]

# public (dashed) ids as given in the assignment
PUBLIC_IDS = {
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "musicgen-large": "musicgen_large",
    "starcoder2-15b": "starcoder2_15b",
    "deepseek-7b": "deepseek_7b",
    "internlm2-20b": "internlm2_20b",
    "llama3-405b": "llama3_405b",
    "hymba-1.5b": "hymba_1_5b",
    "falcon-mamba-7b": "falcon_mamba_7b",
}


def _module(arch: str):
    mod = PUBLIC_IDS.get(arch, arch).replace("-", "_").replace(".", "_")
    return importlib.import_module(f".{mod}", __name__)


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    return _module(arch).SMOKE_CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
