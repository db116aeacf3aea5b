"""Architecture registry: ``--arch <id>`` -> config.

Counterpart of ``repro/configs/__init__.py``: every architecture of the
reference, its configs as data (the dense, MoE, SSM and hybrid
families, the enc-dec family and the embeddings frontend).  (The
reference's ``configs/base.py`` holds the dry-run's shape cells and JAX
input stand-ins; the trainer needs none of it.)
"""

from __future__ import annotations

import importlib

from repro_torch.models.common import ArchConfig

_MODULES = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "grok-1-314b": "grok1_314b",
    "llama3.2-1b": "llama32_1b",
    "tinyllama-1.1b": "tinyllama_11b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen1.5-0.5b": "qwen15_05b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-large-v3": "whisper_large_v3",
    "qwen2-vl-2b": "qwen2_vl_2b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.ARCH


__all__ = ["ARCH_NAMES", "get_config"]
