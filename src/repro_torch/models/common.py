"""Model-config schema, norms, RoPE and init helpers.

Port of ``repro/models/common.py``.  The config dataclasses are the JAX
package's, field for field, so a config reads the same in both packages;
``ModelConfig.compute_dtype`` returns a ``torch.dtype``.  JAX's
``scan_groups`` and ``remat`` only serve ``lax.scan`` and
``jax.checkpoint``: the port loops over its layers, so it has neither
(``remat`` stays as a field, read by nothing).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.distributed.sharding import shard_hint

# block kinds
ATTN = "attn"             # full (causal for decoder) attention + channel mixer
LOCAL_ATTN = "local_attn"  # sliding-window attention + channel mixer
MAMBA2 = "mamba2"          # SSD mixer (no separate channel mixer)
RGLRU = "rglru"            # RG-LRU recurrent block + channel mixer

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden size
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 128
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0             # 0 -> d_model
    conv_width: int = 4
    c: float = 8.0                 # the fixed RG-LRU exponent scale


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder; inputs arrive as precomputed frame
    embeddings (B, n_ctx, d_model)."""
    n_layers: int
    n_ctx: int                     # e.g. 1500 audio frames


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    block_pattern: Tuple[str, ...] = ()   # () -> (ATTN,) * n_layers
    act: str = "swiglu"            # "swiglu" | "gelu"
    norm: str = "rmsnorm"          # "rmsnorm" | "layernorm"
    qkv_bias: bool = False
    rope_base: float = 10000.0
    rope_dim: int = 0              # 0 -> head_dim (partial RoPE if smaller)
    window: int = 0                # sliding window for LOCAL_ATTN layers
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    emb_scale: bool = False        # gemma-style sqrt(d_model) embed scaling
    pos_emb: str = "rope"          # "rope" | "absolute" (whisper)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    # >0: precomputed embeddings of this many positions prepended to the
    # token stream (vision patches for llava)
    n_prefix_embeds: int = 0
    dtype: str = "bfloat16"
    # runtime knobs
    attn_chunk: int = 1024         # q/kv block size of mha's chunked path
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def pattern(self) -> Tuple[str, ...]:
        return self.block_pattern or (ATTN,) * self.n_layers

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    """``x * rsqrt(mean(x²) + eps) * (1 + scale)`` in float32, cast back
    to ``x``'s dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The config's norm of ``x`` (B, S, d), hinted whole along the
    sequence: under sharding rules the residual stream between blocks is
    sequence-parallel (``seq_act``), and each block's input is gathered
    here (GSPMD inserts that all-gather itself; DTensor cannot run the
    projections on a sequence-sharded, batch-flattened input)."""
    if cfg.norm == "rmsnorm":
        out = rmsnorm(x, p["scale"], cfg.norm_eps)
    else:
        out = layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    return shard_hint(out, "batch", "seq", "embed_act")


def init_norm(cfg: ModelConfig, device) -> dict:
    dt = cfg.compute_dtype
    if cfg.norm == "rmsnorm":
        return {"scale": torch.zeros(cfg.d_model, dtype=dt, device=device)}
    return {"scale": torch.ones(cfg.d_model, dtype=dt, device=device),
            "bias": torch.zeros(cfg.d_model, dtype=dt, device=device)}


def rope(x: torch.Tensor, positions: torch.Tensor, base: float,
         rope_dim: int = 0) -> torch.Tensor:
    """Rotary embedding on the last dim of ``x`` (B, S, H, Dh) at integer
    ``positions`` (B, S), in float32, cast back to ``x``'s dtype.

    ``rope_dim < Dh`` applies partial RoPE: only the first ``rope_dim``
    channels rotate."""
    dh = x.shape[-1]
    rd = rope_dim or dh
    half = rd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    # base filled on the device: torch.tensor(base, device=...) would copy
    # from the host and wait for the card
    freq = torch.pow(torch.full((), base, dtype=torch.float32,
                                device=x.device), exps)
    ang = positions[..., None].float() * freq                  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr = x[..., :rd].float()
    x1, x2 = xr[..., :half], xr[..., half:]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if rd < dh:
        rot = torch.cat([rot, x[..., rd:].float()], dim=-1)
    return rot.to(x.dtype)


def sinusoidal_pos_emb(n_pos: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style absolute sinusoidal embeddings ``(n_pos, d)`` in
    float32 (cast at use): ``[sin(p·f), cos(p·f)]`` with ``f =
    exp(−log(1e4)·i / (d/2 − 1))``, the products in JAX's order."""
    half = d // 2
    i = torch.arange(half, dtype=torch.float32, device=device)
    freq = torch.exp(-math.log(10000.0) * i / (half - 1))
    ang = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None] \
        * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
               fan_in: int | None = None) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights (``fan_in`` defaults to ``shape[0]``),
    drawn in float32 from ``gen`` on its device and cast to ``dtype``."""
    fan_in = fan_in if fan_in is not None else shape[0]
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * (1.0 / math.sqrt(fan_in))).to(dtype)
