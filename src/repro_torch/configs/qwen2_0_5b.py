"""qwen2-0.5b [dense]: 24L, d_model=896, 14H (GQA kv=2), d_ff=4864,
vocab=151936 — GQA with QKV bias, tied embeddings.  [arXiv:2407.10671]

A copy of ``repro/configs/qwen2_0_5b.py``, field for field.
"""

import dataclasses

from repro_torch.models.common import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    act="swiglu",
    qkv_bias=True,
    tie_embeddings=True,
    rope_base=1000000.0,
    block_pattern=(ATTN,) * 24,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
        vocab_size=256, block_pattern=(ATTN,) * 2, dtype="float32")
