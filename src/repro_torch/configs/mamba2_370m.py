"""mamba2-370m [ssm]: 48L, d_model=1024, attention-free, vocab=50280,
ssm_state=128 — SSD (state-space duality).  The decode state is O(1) in
the context length.  [arXiv:2405.21060]

A copy of ``repro/configs/mamba2_370m.py``, field for field.
"""

import dataclasses

from repro_torch.models.common import MAMBA2, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    n_layers=48,
    d_model=1024,
    n_heads=1,                    # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,                       # no channel mixer (pure mamba stack)
    vocab_size=50280,
    tie_embeddings=True,
    norm="rmsnorm",
    block_pattern=(MAMBA2,) * 48,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1,
                  conv_width=4, chunk=128),
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab_size=256,
        block_pattern=(MAMBA2,) * 2,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, n_groups=1,
                      conv_width=4, chunk=8), dtype="float32")
