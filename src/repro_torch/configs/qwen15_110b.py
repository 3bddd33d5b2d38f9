"""qwen1.5-110b [dense]: 80L, d_model=8192, 64H (GQA kv=8), d_ff=49152,
vocab=152064 — QKV bias.  [hf:Qwen/Qwen1.5-110B]

A copy of ``repro/configs/qwen15_110b.py``, field for field.
"""

import dataclasses

from repro_torch.models.common import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    act="swiglu",
    qkv_bias=True,
    rope_base=1000000.0,
    block_pattern=(ATTN,) * 80,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192,
        vocab_size=256, block_pattern=(ATTN,) * 2, dtype="float32")
