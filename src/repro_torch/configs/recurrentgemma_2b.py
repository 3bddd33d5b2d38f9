"""recurrentgemma-2b [hybrid]: 26L, d_model=2560, 10H (GQA kv=1),
d_ff=7680 (GeGLU), vocab=256000 — RG-LRU + local attention (window 2048)
in 1:2 ratio: pattern (rglru, rglru, local_attn) x 8 + (rglru, rglru).
The decode state is the LRU's and a 2048-slot ring of keys and values.
[arXiv:2402.19427]

A copy of ``repro/configs/recurrentgemma_2b.py``, field for field.
"""

import dataclasses

from repro_torch.models.common import (LOCAL_ATTN, RGLRU, ModelConfig,
                                       RGLRUConfig)

_PATTERN = (RGLRU, RGLRU, LOCAL_ATTN) * 8 + (RGLRU, RGLRU)

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    act="geglu",
    window=2048,
    tie_embeddings=True,
    emb_scale=True,
    block_pattern=_PATTERN,
    rglru=RGLRUConfig(lru_width=2560, conv_width=4, c=8.0),
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=5, d_model=64, n_heads=2, n_kv_heads=1,
        head_dim=32, d_ff=128, vocab_size=256, window=8,
        block_pattern=(RGLRU, RGLRU, LOCAL_ATTN, RGLRU, RGLRU),
        rglru=RGLRUConfig(lru_width=64, conv_width=4, c=8.0),
        dtype="float32")
