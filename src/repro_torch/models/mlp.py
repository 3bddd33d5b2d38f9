"""Channel mixers: SwiGLU / GEGLU / GELU MLP.

Port of ``repro/models/mlp.py``, with JAX's ``shard_hint`` sites (no-ops
unless sharding rules are active).  GELU is the tanh
approximation, ``jax.nn.gelu``'s default.  The LUT activation override
waits for queue A's LUT items.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import shard_hint
from repro_torch.models import common as cm


def init_mlp(cfg: cm.ModelConfig, gen: torch.Generator,
             d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.compute_dtype
    if cfg.act in ("swiglu", "geglu"):
        return {
            "w_gate": cm.dense_init(gen, (d, f), dt),
            "w_up": cm.dense_init(gen, (d, f), dt),
            "w_down": cm.dense_init(gen, (f, d), dt, fan_in=f),
        }
    return {
        "w_up": cm.dense_init(gen, (d, f), dt),
        "b_up": torch.zeros(f, dtype=dt, device=gen.device),
        "w_down": cm.dense_init(gen, (f, d), dt, fan_in=f),
        "b_down": torch.zeros(d, dtype=dt, device=gen.device),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def mlp(cfg: cm.ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.act in ("swiglu", "geglu"):
        act = F.silu if cfg.act == "swiglu" else _gelu
        h = act(shard_hint(x @ p["w_gate"], "batch", "seq", "ff")) * \
            shard_hint(x @ p["w_up"], "batch", "seq", "ff")
    else:
        h = shard_hint(x @ p["w_up"] + p["b_up"], "batch", "seq", "ff")
        h = _gelu(h)
    y = h @ p["w_down"]
    if "b_down" in p:
        y = y + p["b_down"]
    return shard_hint(y, "batch", "seq", "embed_act")
