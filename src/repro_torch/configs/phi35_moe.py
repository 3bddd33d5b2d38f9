"""phi3.5-moe-42b-a6.6b [moe]: 32L, d_model=4096, 32H (GQA kv=8),
d_ff(expert)=6400, vocab=32064, MoE 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct]

A copy of ``repro/configs/phi35_moe.py``, field for field.
"""

import dataclasses

from repro_torch.models.common import ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    act="swiglu",
    block_pattern=(ATTN,) * 32,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=6400),
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, block_pattern=(ATTN,) * 2,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=128), dtype="float32")
