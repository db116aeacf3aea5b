"""Architecture registry: ``--arch <id>`` -> config.

Counterpart of ``repro/configs/__init__.py`` for the dense, MoE, SSM
and hybrid families the port runs (the configs are the reference's, as
data).  The reference's other architectures belong to later slices and
raise ``NotImplementedError`` naming their ROADMAP item.  (The reference's
``configs/base.py`` holds the dry-run's shape cells and JAX input
stand-ins; the trainer needs none of it.)
"""

from __future__ import annotations

import importlib

from repro_torch.models.common import ArchConfig

_MODULES = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "grok-1-314b": "grok1_314b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "llama3.2-1b": "llama32_1b",
    "tinyllama-1.1b": "tinyllama_11b",
    "qwen1.5-0.5b": "qwen15_05b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}

#: architectures of the reference that later slices of the port carry
#: over, and the ROADMAP item of each
LATER_ARCHS = {
    "whisper-large-v3": "the enc-dec family (ROADMAP queue 1, item 6)",
    "qwen2-vl-2b": "the embeddings frontend (ROADMAP queue 1, item 6)",
    "starcoder2-3b": ("the layernorm / gelu / sliding-window dense block "
                      "(ROADMAP queue 1, item 6)"),
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name in LATER_ARCHS:
        raise NotImplementedError(
            f"--arch {name} is not ported yet: it belongs to "
            f"{LATER_ARCHS[name]} of the PyTorch port")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.ARCH


__all__ = ["ARCH_NAMES", "LATER_ARCHS", "get_config"]
