"""whisper-tiny [audio]: 4L enc + 4L dec, d_model=384, 6H (kv=6),
d_ff=1536, vocab=51865 — enc-dec, conv/audio frontend STUBBED
(input_specs provides precomputed frame embeddings).  [arXiv:2212.04356]

A copy of ``repro/configs/whisper_tiny.py``, field for field.
"""

import dataclasses

from repro_torch.models.common import ATTN, EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    n_layers=4,                    # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    act="gelu",
    norm="layernorm",
    qkv_bias=True,
    pos_emb="absolute",
    tie_embeddings=True,
    block_pattern=(ATTN,) * 4,
    encoder=EncoderConfig(n_layers=4, n_ctx=1500),
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
        vocab_size=256, block_pattern=(ATTN,) * 2,
        encoder=EncoderConfig(n_layers=2, n_ctx=16), dtype="float32")
