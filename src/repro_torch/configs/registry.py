"""Architecture registry, the counterpart of ``repro/configs/registry.py``.

``get_config(arch_id)`` resolves ``--arch`` flags.  The reference's
``input_specs`` and ``cells`` feed its dry run only and are not here.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

__all__ = ["ARCH_IDS", "get_config"]

_MODULES = {
    "phi-3-vision-4.2b": "repro_torch.configs.phi3_vision_4p2b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2p7b",
}
ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        # allow filename-style ids (underscores) too
        alt = {k.replace("-", "_").replace(".", "p"): k for k in _MODULES}
        arch_id = alt.get(arch_id, arch_id)
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG
