"""RG-LRU recurrent block (Griffin / RecurrentGemma temporal mixer).

Port of ``repro/models/rglru.py``, with JAX's ``shard_hint`` sites
(no-ops unless sharding rules are active).  The recurrence (De et
al., 2024):

    r_t = sigma(W_a x_t + b_a)                  (recurrence gate)
    i_t = sigma(W_x x_t + b_x)                  (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)      (diagonal decay, c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Parameters keep JAX's names, shapes and dtypes (``b_a``, ``b_i`` and
``lambda`` are float32 in a model of any compute dtype).  The gate
products go to float32 after the matmul, the square root is taken of
``clip(1 - a^2, 1e-12, 1)``, and the conv has no activation (unlike
Mamba-2's).  GELU is the tanh approximation, ``jax.nn.gelu``'s default.

Training and prefill scan the linear recurrence over time in log depth:
the combine ``(a2 a1, a2 b1 + b2)`` applied at doubling strides, as
``jax.lax.associative_scan`` applies it in another tree (the same
recurrence in another float32 order).  Under autograd each of the
``log2 S`` levels keeps its (B, S, w) float32 operands.  Decode is the
single-step update, written into the cache tensors in place.  No TPU
kernel lies on this path.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.distributed.sharding import shard_hint
from repro_torch.models import common as cm
from repro_torch.models.mlp import _gelu
from repro_torch.models.ssm import conv_step, softplus


def _width(cfg: cm.ModelConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def init_rglru(cfg: cm.ModelConfig, gen: torch.Generator) -> dict:
    d, w, rc = cfg.d_model, _width(cfg), cfg.rglru
    dt, dev = cfg.compute_dtype, gen.device
    # Lambda so that a^c lies in (0.9, 0.999) roughly (the paper's init)
    lo, hi = 0.9 ** 2, 0.999 ** 2
    lam = torch.rand((w,), generator=gen, dtype=torch.float32,
                     device=dev) * (hi - lo) + lo
    lam = torch.log(torch.expm1(-torch.log(lam) / rc.c))  # softplus inverse
    return {
        "w_x": cm.dense_init(gen, (d, w), dt),          # input branch
        "w_gate": cm.dense_init(gen, (d, w), dt),       # GeLU gate branch
        "conv_w": cm.dense_init(gen, (rc.conv_width, w), dt,
                                fan_in=rc.conv_width),
        "conv_b": torch.zeros(w, dtype=dt, device=dev),
        "w_a": cm.dense_init(gen, (w, w), dt),
        "b_a": torch.zeros(w, dtype=torch.float32, device=dev),
        "w_i": cm.dense_init(gen, (w, w), dt),
        "b_i": torch.zeros(w, dtype=torch.float32, device=dev),
        "lambda": lam,
        "w_out": cm.dense_init(gen, (w, d), dt, fan_in=w),
    }


def _gates(cfg, p, xb: torch.Tensor):
    """(a, the gated input) in float32 of the conv's output ``xb``."""
    r = torch.sigmoid((xb @ p["w_a"]).float() + p["b_a"])
    i = torch.sigmoid((xb @ p["w_i"]).float() + p["b_i"])
    log_a = -cfg.rglru.c * softplus(p["lambda"]) * r      # (B,S,w)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, 1e-12, 1.0))
    return a, beta * i * xb.float()


def _causal_conv(p, x: torch.Tensor, width: int) -> torch.Tensor:
    S = x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, width - 1, 0))
    out = pad[:, 0:S] * p["conv_w"][0]
    for i in range(1, width):
        out = out + pad[:, i:i + S] * p["conv_w"][i]
    return out + p["conv_b"]


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` over dim 1 from ``h_{-1} = 0``, in
    ``ceil(log2 S)`` levels: at stride ``k`` every position ``t >= k``
    takes the combine of ``t - k`` and ``t``, ``(a_t a_{t-k}, a_t
    b_{t-k} + b_t)``."""
    S, k = a.shape[1], 1
    while k < S:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        if 2 * k < S:
            a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return b


def rglru_forward(cfg: cm.ModelConfig, p: dict, x: torch.Tensor
                  ) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    xb = shard_hint(x @ p["w_x"], "batch", "seq", "lru")
    gate = shard_hint(_gelu(x @ p["w_gate"]), "batch", "seq", "lru")
    xb = _causal_conv(p, xb, cfg.rglru.conv_width)
    a, b = _gates(cfg, p, xb)
    h = linear_scan(a, b)
    return shard_hint((h.to(x.dtype) * gate) @ p["w_out"], "batch", "seq",
                      "embed_act")


def init_rglru_cache(cfg: cm.ModelConfig, batch: int, device) -> dict:
    """The decode state of one layer: ``conv`` (batch, width - 1, w) in
    the compute dtype and ``h`` (batch, w) in float32; zeros."""
    w = _width(cfg)
    return {
        "conv": torch.zeros((batch, cfg.rglru.conv_width - 1, w),
                            dtype=cfg.compute_dtype, device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }


def rglru_decode(cfg: cm.ModelConfig, p: dict, x: torch.Tensor,
                 cache: dict) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, d).  The cache is updated in place."""
    xb = x @ p["w_x"]                                     # (B,1,w)
    gate = _gelu(x @ p["w_gate"])
    hist = torch.cat([cache["conv"], xb], dim=1)
    conv = conv_step(hist, p["conv_w"]) + p["conv_b"]
    a, b = _gates(cfg, p, conv[:, None, :])
    h = a[:, 0] * cache["h"] + b[:, 0]                    # (B,w)
    out = (h[:, None, :].to(x.dtype) * gate) @ p["w_out"]
    cache["conv"].copy_(hist[:, 1:])
    cache["h"].copy_(h)
    return out, cache
