"""Architecture registry of the port: ``get_config(name)`` / ``--arch``.

Port of ``repro/configs/__init__.py``.  Each ported module defines
``CONFIG`` (the published full-size config) and ``smoke_config()`` (a
reduced same-family config for CPU tests); ``pim_ml`` holds the paper's
own workloads.  The JAX package's other architectures need model
families the port does not have yet: asking for one raises
``NotImplementedError`` naming its ROADMAP item.
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
}
# arch -> the ROADMAP item whose model family it needs
_PENDING: Dict[str, str] = {
    "qwen3-moe-235b-a22b": "A18.3 (MoE)",
    "phi3.5-moe-42b-a6.6b": "A18.3 (MoE)",
}


def list_archs() -> List[str]:
    """The architectures the port trains and serves."""
    return list(_ARCHS)


def _module(name: str):
    if name in _PENDING:
        raise NotImplementedError(
            f"{name!r} is not ported yet: ROADMAP queue A, item "
            f"{_PENDING[name]}")
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {list(_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCHS[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()
