"""Architecture registry of the port: the archs it carries."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

# archs whose config and model path the port carries: all ten of the
# reference's (seamless-m4t-medium through ``models.encdec``, the rest
# through ``models.transformer``)
PORTED_ARCHS = ("qwen3-0.6b", "olmoe-1b-7b", "qwen3-moe-30b-a3b",
                "mamba2-130m", "recurrentgemma-2b", "llama3.2-3b",
                "gemma3-4b", "gemma3-12b", "internvl2-26b",
                "seamless-m4t-medium")


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    if arch_id not in PORTED_ARCHS:
        raise KeyError(f"unknown arch {arch_id!r} (the port carries: "
                       f"{', '.join(PORTED_ARCHS)})")
    mod = importlib.import_module(
        f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.REDUCED if reduced else mod.CONFIG
