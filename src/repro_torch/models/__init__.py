"""LM architectures of the port: dense decoder-only attention stacks
behind one ``Model`` facade (port of ``repro/models``)."""

from repro_torch.models.common import (  # noqa: F401
    ATTN, LOCAL_ATTN, MAMBA2, RGLRU, EncoderConfig, ModelConfig, MoEConfig,
    RGLRUConfig, SSMConfig,
)
from repro_torch.models.model_api import Model, build  # noqa: F401
