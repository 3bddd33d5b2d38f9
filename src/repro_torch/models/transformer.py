"""Decoder-only LM stack: the training loss, prefill and single-token
decode over dense attention layers.

Port of ``repro/models/transformer.py`` for one device.  JAX
``lax.scan``s the smallest repeating unit of the layer pattern and
rematerialises it; the port keeps the parameters as a list with one dict
per layer and loops over it, and caches mirror that list.  Autograd
keeps every layer's activations (no rematerialisation); the attention's
gradient is the ``flash_attention_bwd`` kernel
(``kernels.dispatch.FlashAttention``).  Only dense ``ATTN`` layers are
ported: ``LOCAL_ATTN``, ``MAMBA2``, ``RGLRU`` and MoE channel mixers
raise ``NotImplementedError`` naming their ROADMAP items.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import attention as att
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_mod

_PENDING = {
    cm.LOCAL_ATTN: "A18.2 (LOCAL_ATTN ring buffer)",
    cm.MAMBA2: "A18.4 (Mamba-2)",
    cm.RGLRU: "A18.5 (RG-LRU)",
}


def check_supported(cfg: cm.ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config the port cannot run."""
    for kind in cfg.pattern:
        if kind in _PENDING:
            raise NotImplementedError(
                f"{cfg.name}: {kind!r} layers are not ported yet: ROADMAP "
                f"queue A, item {_PENDING[kind]}")
        if kind != cm.ATTN:
            raise ValueError(kind)
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE layers are not ported "
                                  "yet: ROADMAP queue A, item A18.3 (MoE)")
    if cfg.encoder is not None or cfg.n_prefix_embeds:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and prefix-embedding models are "
            "not ported yet: ROADMAP queue A, item A18.6 (enc-dec and VLM "
            "prefix)")


# ---------------------------------------------------------------------------
# single layer
# ---------------------------------------------------------------------------

def init_layer(cfg: cm.ModelConfig, gen: torch.Generator) -> dict:
    return {"norm1": cm.init_norm(cfg, gen.device),
            "norm2": cm.init_norm(cfg, gen.device),
            "mixer": att.init_attn(cfg, gen),
            "mlp": mlp_mod.init_mlp(cfg, gen)}


def _channel_mix(cfg, p, x):
    return mlp_mod.mlp(cfg, p["mlp"], cm.apply_norm(cfg, p["norm2"], x))


def layer_forward(cfg: cm.ModelConfig, p: dict, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence layer: causal attention, then the MLP, each on a
    residual branch."""
    h = cm.apply_norm(cfg, p["norm1"], x)
    x = x + att.attn_full(cfg, p["mixer"], h, positions, causal=True)
    return x + _channel_mix(cfg, p, x)


def init_layer_cache(cfg: cm.ModelConfig, batch: int, max_len: int,
                     device) -> dict:
    return att.init_cache(cfg, batch, max_len, device)


def layer_decode(cfg: cm.ModelConfig, p: dict, x: torch.Tensor, cache: dict,
                 pos) -> Tuple[torch.Tensor, dict]:
    h = cm.apply_norm(cfg, p["norm1"], x)
    mix, cache = att.attn_decode(cfg, p["mixer"], h, cache, pos)
    x = x + mix
    return x + _channel_mix(cfg, p, x), cache


# ---------------------------------------------------------------------------
# LM: embeddings + stack + head, prefill / decode
# ---------------------------------------------------------------------------

def padded_vocab(cfg: cm.ModelConfig) -> int:
    return -(-cfg.vocab_size // 128) * 128


def init_lm(cfg: cm.ModelConfig, gen: torch.Generator) -> dict:
    """Parameters drawn from ``gen`` on its device: ``embed`` (Vp, d),
    ``layers`` (one dict per layer), ``final_norm`` and, untied,
    ``head`` (d, Vp)."""
    check_supported(cfg)
    V = padded_vocab(cfg)
    params = {
        "embed": cm.dense_init(gen, (V, cfg.d_model), cfg.compute_dtype,
                               fan_in=cfg.d_model),
        "layers": [init_layer(cfg, gen) for _ in range(cfg.n_layers)],
        "final_norm": cm.init_norm(cfg, gen.device),
    }
    if not cfg.tie_embeddings:
        params["head"] = cm.dense_init(gen, (cfg.d_model, V),
                                       cfg.compute_dtype)
    return params


def _embed(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    # a gather whose gradient on the card sums a token's rows in a fixed
    # order (index_select's backward adds them with atomics)
    x = F.embedding(tokens, params["embed"])
    if cfg.emb_scale:
        x = x * torch.sqrt(torch.tensor(float(cfg.d_model))).to(x.dtype)
    return x


def _head(cfg, params, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["head"]
    V, Vp = cfg.vocab_size, padded_vocab(cfg)
    if Vp != V:  # mask pad columns out of the softmax
        pad = torch.arange(Vp, device=x.device) < V
        logits = logits + torch.where(pad, 0.0, -1e9).to(logits.dtype)
    return logits


def _stack(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    x = _embed(cfg, params, tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    for p in params["layers"]:
        x = layer_forward(cfg, p, x, positions)
    return x


def lm_forward(cfg: cm.ModelConfig, params: dict, tokens: torch.Tensor
               ) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, Vp)."""
    x = _stack(cfg, params, tokens)
    return _head(cfg, params, cm.apply_norm(cfg, params["final_norm"], x))


def lm_loss(cfg: cm.ModelConfig, params: dict, batch: dict,
            aux_weight: float = 0.01) -> Tuple[torch.Tensor, dict]:
    """``batch["tokens"]`` (B, S) -> ``(loss, {"ce", "aux"})``: next-token
    cross entropy over the full logits, ``loss = ce + aux_weight · aux``
    with ``aux`` a float32 zero (dense stacks have no router loss), as
    ``repro/models/transformer.py::lm_loss``."""
    tokens = batch["tokens"]
    logits = lm_forward(cfg, params, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    ce = cross_entropy(logits, tokens)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def cross_entropy(logits: torch.Tensor, tokens: torch.Tensor
                  ) -> torch.Tensor:
    """Next-token CE in float32: the mean over the ``B·(S−1)`` predicted
    positions of ``logsumexp(logits) − logits[gold]``.  JAX reads the
    gold logit through a one-hot contraction, a sharding choice; the
    gather is the same function (one index a row, so its gradient has no
    sums to order)."""
    lg = logits[:, :-1].float()
    tg = tokens[:, 1:].long()
    lse = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, tg[..., None])[..., 0]
    return (lse - gold).mean()


def lm_prefill(cfg: cm.ModelConfig, params: dict, tokens: torch.Tensor
               ) -> torch.Tensor:
    """Full-sequence forward returning the last position's logits (B, 1,
    Vp).  Only that position goes through the final norm and the head:
    the (B, S, Vp) logits are never made."""
    x = _stack(cfg, params, tokens)[:, -1:]
    return _head(cfg, params, cm.apply_norm(cfg, params["final_norm"], x))


def lm_init_cache(cfg: cm.ModelConfig, batch: int, max_len: int,
                  device) -> List[dict]:
    return [init_layer_cache(cfg, batch, max_len, device)
            for _ in range(cfg.n_layers)]


def lm_decode_step(cfg: cm.ModelConfig, params: dict, cache: List[dict],
                   token: torch.Tensor, pos
                   ) -> Tuple[torch.Tensor, List[dict]]:
    """token (B, 1) at absolute position ``pos`` (a 0-dim int32 tensor on
    the device, as JAX's traced ``pos``, or an int) -> (logits (B, 1,
    Vp), cache).  The cache is updated in place."""
    x = _embed(cfg, params, token)
    pos = att.decode_pos(pos, x.device)
    for i, p in enumerate(params["layers"]):
        x, cache[i] = layer_decode(cfg, p, x, cache[i], pos)
    x = cm.apply_norm(cfg, params["final_norm"], x)
    return _head(cfg, params, x), cache
