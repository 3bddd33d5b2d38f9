"""minitron-8b [dense]: 32L, d_model=4096, 32H (GQA kv=8), d_ff=16384,
vocab=256000 — pruned Nemotron-4.  [arXiv:2407.14679]

A copy of ``repro/configs/minitron_8b.py``, field for field.
"""

import dataclasses

from repro_torch.models.common import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    act="swiglu",
    block_pattern=(ATTN,) * 32,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192,
        vocab_size=256, block_pattern=(ATTN,) * 2, dtype="float32")
