"""llava-next-mistral-7b [vlm]: 32L, d_model=4096, 32H (GQA kv=8),
d_ff=14336, vocab=32000 — Mistral-7B backbone; anyres vision tiling
STUBBED (input_specs provides precomputed patch embeddings prepended to
the token stream).  [hf:llava-hf/llava-v1.6-mistral-7b-hf]

A copy of ``repro/configs/llava_next_mistral_7b.py``, field for field.
"""

import dataclasses

from repro_torch.models.common import ATTN, ModelConfig

# anyres 2x2 tiles + base: 5 x 576 patches -> 2880 prefix embeddings
N_PATCH_EMBEDS = 2880

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    act="swiglu",
    block_pattern=(ATTN,) * 32,
    n_prefix_embeds=N_PATCH_EMBEDS,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, block_pattern=(ATTN,) * 2, n_prefix_embeds=8,
        dtype="float32")
