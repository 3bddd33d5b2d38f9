"""Architecture registry of the port: ``get_config(name)`` / ``--arch``.

Port of ``repro/configs/__init__.py``.  Each ported module defines
``CONFIG`` (the published full-size config) and ``smoke_config()`` (a
reduced same-family config for CPU tests); ``pim_ml`` holds the paper's
own workloads.  Every architecture of the JAX package is here.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.common import ModelConfig

_ARCHS: Dict[str, str] = {
    "phi4-mini-3.8b": "phi4_mini",
    "minitron-8b": "minitron_8b",
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen1.5-110b": "qwen15_110b",
    "mamba2-370m": "mamba2_370m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "whisper-tiny": "whisper_tiny",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
}


def list_archs() -> List[str]:
    """The architectures the port trains and serves."""
    return list(_ARCHS)


def _module(name: str):
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {list(_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCHS[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()
