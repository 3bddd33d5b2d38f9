"""qwen3-moe-235b-a22b [moe]: 94L, d_model=4096, 64H (GQA kv=4),
d_ff(expert)=1536, vocab=151936, MoE 128 experts top-8.
[hf:Qwen/Qwen3-235B-A22B family]

A copy of ``repro/configs/qwen3_moe_235b.py``, field for field.
"""

import dataclasses

from repro_torch.models.common import ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,                    # expert hidden size
    vocab_size=151936,
    act="swiglu",
    rope_base=1000000.0,
    block_pattern=(ATTN,) * 94,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff=1536),
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=96, vocab_size=256, block_pattern=(ATTN,) * 2,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=96), dtype="float32")
