"""phi4-mini-3.8b [dense]: 32L, d_model=3072, 24H (GQA kv=8), d_ff=8192,
vocab=200064 — RoPE (partial) + SwiGLU + GQA.  [arXiv:2412.08905]

A copy of ``repro/configs/phi4_mini.py``, field for field.
"""

import dataclasses

from repro_torch.models.common import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    act="swiglu",
    rope_dim=96,                  # partial rotary factor 0.75 of hd=128
    block_pattern=(ATTN,) * 32,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=96, n_heads=3, n_kv_heads=1, d_ff=256,
        vocab_size=256, rope_dim=24, block_pattern=(ATTN,) * 2,
        dtype="float32")
