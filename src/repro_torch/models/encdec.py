"""Whisper-style encoder-decoder.

Port of ``repro/models/encdec.py``, with JAX's ``shard_hint`` sites
(no-ops unless sharding rules are active).  The audio frontend
(the mel conv stack) is a stub, as in JAX: the encoder takes
precomputed frame embeddings (B, n_ctx, d_model).  The encoder is a
non-causal transformer over them, with sinusoidal positions; the decoder
is causal self-attention, cross-attention into the encoder's output and
an MLP a layer, with a learned position table and a tied head.  JAX
stacks each side's layers and ``lax.scan``s them; the port keeps a list
of layer dicts in model order, as ``transformer``.  Both self-attentions
go to the flash kernel (``attention.attn_full``: full in the encoder,
causal in the decoder); cross-attention and decode run ``mha``.

The decode cache is ``{"self": [...], "cross": [...]}``, one ``{"k",
"v"}`` dict a decoder layer on each side: the self-attention's KV cache,
written in place by :func:`encdec_decode_step`, and the encoder's K/V
(B, n_ctx, Kh, Dh), written in place by :func:`encdec_build_cross`, so a
step captured on the cache reads whatever the last build wrote.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import shard_hint
from repro_torch.models import attention as att
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import transformer as tfm

# rows of the decoder's learned position table (JAX's 4096 * 16)
POS_ROWS = 4096 * 16


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def init_encoder(cfg: cm.ModelConfig, gen: torch.Generator) -> dict:
    dev = gen.device
    layers = [{"norm1": cm.init_norm(cfg, dev),
               "attn": att.init_attn(cfg, gen),
               "norm2": cm.init_norm(cfg, dev),
               "mlp": mlp_mod.init_mlp(cfg, gen)}
              for _ in range(cfg.encoder.n_layers)]
    return {"layers": layers, "final_norm": cm.init_norm(cfg, dev)}


def encode(cfg: cm.ModelConfig, params: dict, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames (B, n_ctx, d) stub embeddings -> encoder states (B, n_ctx,
    d) in the compute dtype.  The sinusoidal table is added in the
    compute dtype, as JAX adds its (n_ctx, d) table: the frames must
    number exactly ``n_ctx``."""
    n_ctx = cfg.encoder.n_ctx
    if frames.dim() != 3 or frames.shape[1:] != (n_ctx, cfg.d_model):
        raise ValueError(f"{cfg.name}: frames must be (B, {n_ctx}, "
                         f"{cfg.d_model}), got {tuple(frames.shape)}")
    x = frames.to(cfg.compute_dtype)
    x = x + cm.sinusoidal_pos_emb(n_ctx, cfg.d_model, x.device).to(x.dtype)
    x = shard_hint(x, "batch", "seq", "embed_act")
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    for p in params["layers"]:
        h = cm.apply_norm(cfg, p["norm1"], x)
        x = x + att.attn_full(cfg, p["attn"], h, positions, causal=False)
        h = cm.apply_norm(cfg, p["norm2"], x)
        x = shard_hint(x + mlp_mod.mlp(cfg, p["mlp"], h), "batch", "seq_act",
                       None)
    return cm.apply_norm(cfg, params["final_norm"], x)


# ---------------------------------------------------------------------------
# decoder (causal self-attn + cross-attn + mlp per layer)
# ---------------------------------------------------------------------------

def init_decoder(cfg: cm.ModelConfig, gen: torch.Generator) -> dict:
    dev = gen.device
    layers = [{"norm1": cm.init_norm(cfg, dev),
               "self_attn": att.init_attn(cfg, gen),
               "norm_x": cm.init_norm(cfg, dev),
               "cross_attn": att.init_attn(cfg, gen),
               "norm2": cm.init_norm(cfg, dev),
               "mlp": mlp_mod.init_mlp(cfg, gen)}
              for _ in range(cfg.n_layers)]
    return {"layers": layers}


def _dec_layer(cfg, p, x, positions, enc_out):
    h = cm.apply_norm(cfg, p["norm1"], x)
    x = x + att.attn_full(cfg, p["self_attn"], h, positions, causal=True)
    h = cm.apply_norm(cfg, p["norm_x"], x)
    cc = att.cross_cache(cfg, p["cross_attn"], enc_out)
    x = x + att.cross_attend(cfg, p["cross_attn"], h, cc)
    h = cm.apply_norm(cfg, p["norm2"], x)
    return shard_hint(x + mlp_mod.mlp(cfg, p["mlp"], h), "batch", "seq_act",
                      None)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def init_encdec(cfg: cm.ModelConfig, gen: torch.Generator) -> dict:
    """Parameters drawn from ``gen`` on its device: ``encoder``
    (``layers``, ``final_norm``), ``decoder`` (``layers``), the tied
    ``embed`` (Vp, d), the learned ``pos_emb`` (65,536, d) and
    ``final_norm``."""
    V = tfm.padded_vocab(cfg)
    return {
        "encoder": init_encoder(cfg, gen),
        "decoder": init_decoder(cfg, gen),
        "embed": cm.dense_init(gen, (V, cfg.d_model), cfg.compute_dtype,
                               fan_in=cfg.d_model),
        "pos_emb": cm.dense_init(gen, (POS_ROWS, cfg.d_model),
                                 cfg.compute_dtype),
        "final_norm": cm.init_norm(cfg, gen.device),
    }


def _dec_embed(cfg, params, tokens: torch.Tensor, pos=None) -> torch.Tensor:
    """Token embeddings plus the learned positions from ``pos``: None for
    a sequence from position 0, else a 0-dim int32 tensor on the device
    (one decode token), read by ``index_select`` so a captured step takes
    it from the card."""
    x = F.embedding(tokens, params["embed"])
    S = tokens.shape[1]
    if pos is None:
        pe = params["pos_emb"][:S]
    else:
        pe = params["pos_emb"].index_select(0, pos.reshape(1).long())
    return shard_hint(x + pe[None], "batch", "seq", "embed_act")


def _dec_head(cfg, params, x: torch.Tensor) -> torch.Tensor:
    logits = x @ params["embed"].T                     # tied (whisper)
    V, Vp = cfg.vocab_size, tfm.padded_vocab(cfg)
    if Vp != V:
        pad = torch.arange(Vp, device=x.device) < V
        logits = logits + torch.where(pad, 0.0, -1e9).to(logits.dtype)
    return shard_hint(logits, "batch", "seq", "vocab")


def _decoder(cfg, params, tokens, frames) -> torch.Tensor:
    """The decoder's output before the final norm (B, S, d)."""
    enc_out = encode(cfg, params["encoder"], frames)
    x = _dec_embed(cfg, params, tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    for p in params["decoder"]["layers"]:
        x = _dec_layer(cfg, p, x, positions, enc_out)
    return x


def encdec_forward(cfg: cm.ModelConfig, params: dict, tokens: torch.Tensor,
                   frames: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) and frames (B, n_ctx, d) -> logits (B, S, Vp)."""
    x = _decoder(cfg, params, tokens, frames)
    return _dec_head(cfg, params, cm.apply_norm(cfg, params["final_norm"],
                                                x))


def encdec_prefill(cfg: cm.ModelConfig, params: dict, tokens: torch.Tensor,
                   frames: torch.Tensor) -> torch.Tensor:
    """The last position's logits (B, 1, Vp), JAX's
    ``encdec_forward(...)[:, -1:]``: only that position goes through the
    final norm and the head, which act on each position alone."""
    x = _decoder(cfg, params, tokens, frames)[:, -1:]
    return _dec_head(cfg, params, cm.apply_norm(cfg, params["final_norm"],
                                                x))


def encdec_loss(cfg: cm.ModelConfig, params: dict, batch: dict
                ) -> Tuple[torch.Tensor, dict]:
    """batch: ``{"tokens": (B, S), "frames": (B, n_ctx, d)}`` -> ``(ce,
    {"ce", "aux"})``, next-token cross entropy and a float32 zero."""
    logits = encdec_forward(cfg, params, batch["tokens"], batch["frames"])
    ce = tfm.cross_entropy(logits, batch["tokens"])
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=logits.device)}


# -- serving ---------------------------------------------------------------

def encdec_init_cache(cfg: cm.ModelConfig, batch: int, max_len: int,
                      device) -> dict:
    """``{"self": [...], "cross": [...]}``, a ``{"k", "v"}`` dict of zeros
    in the compute dtype a decoder layer: the self-attention's (batch,
    max_len, Kh, Dh) and the encoder's (batch, n_ctx, Kh, Dh), which
    :func:`encdec_build_cross` fills."""
    shape = (batch, cfg.encoder.n_ctx, cfg.n_kv_heads, cfg.hd)
    return {"self": [att.init_cache(cfg, batch, max_len, device)
                     for _ in range(cfg.n_layers)],
            "cross": [{name: torch.zeros(shape, dtype=cfg.compute_dtype,
                                         device=device)
                       for name in ("k", "v")}
                      for _ in range(cfg.n_layers)]}


def encdec_build_cross(cfg: cm.ModelConfig, params: dict,
                       frames: torch.Tensor, cache: dict) -> dict:
    """Run the encoder once on ``frames`` and write each layer's cross
    K/V into ``cache["cross"]`` in place; returns ``cache``."""
    enc_out = encode(cfg, params["encoder"], frames)
    for p, cross in zip(params["decoder"]["layers"], cache["cross"]):
        cc = att.cross_cache(cfg, p["cross_attn"], enc_out)
        cross["k"].copy_(cc["k"])
        cross["v"].copy_(cc["v"])
    return cache


def encdec_decode_step(cfg: cm.ModelConfig, params: dict, cache: dict,
                       token: torch.Tensor, pos
                       ) -> Tuple[torch.Tensor, dict]:
    """token (B, 1) at absolute position ``pos`` (a 0-dim int32 tensor on
    the device, or an int) -> (logits (B, 1, Vp), cache): the
    self-attention caches are written in place, the cross K/V read."""
    pos = att.decode_pos(pos, token.device)
    x = _dec_embed(cfg, params, token, pos)
    selfc: List[dict] = cache["self"]
    for i, (p, cross) in enumerate(zip(params["decoder"]["layers"],
                                       cache["cross"])):
        h = cm.apply_norm(cfg, p["norm1"], x)
        mix, selfc[i] = att.attn_decode(cfg, p["self_attn"], h, selfc[i],
                                        pos)
        x = x + mix
        h = cm.apply_norm(cfg, p["norm_x"], x)
        x = x + att.cross_attend(cfg, p["cross_attn"], h, cross)
        h = cm.apply_norm(cfg, p["norm2"], x)
        x = x + mlp_mod.mlp(cfg, p["mlp"], h)
    x = cm.apply_norm(cfg, params["final_norm"], x)
    return _dec_head(cfg, params, x), cache
