"""Decoder-only LM stack: the training loss, prefill and single-token
decode over layers dispatched by kind.

Port of ``repro/models/transformer.py``, with JAX's ``shard_hint`` sites
(no-ops unless sharding rules are active).  JAX
``lax.scan``s the smallest repeating unit of the layer pattern and
rematerialises it; the port keeps the parameters as a list with one dict
per layer, in model order, and loops over it, and caches mirror that
list (a dict of tensors a layer, written in place by decode).  Autograd
keeps every layer's activations (no rematerialisation); the dense
attention's gradient is the ``flash_attention_bwd`` kernel
(``kernels.dispatch.FlashAttention``).

A layer is one of the pattern's kinds: ``ATTN`` (causal attention and
the MLP), ``LOCAL_ATTN`` (sliding-window attention, a ring-buffer cache,
and the MLP), ``MAMBA2`` (the SSD mixer alone: no channel mixer, no
``norm2``) and ``RGLRU`` (the RG-LRU block and the MLP).  A prefix of
precomputed embeddings (llava's image patches, ``n_prefix_embeds``)
enters before the token embeddings; the encoder-decoder is
``models.encdec``.  With ``cfg.moe`` every layer's channel mixer is the
Mixture-of-Experts (``models.moe``) in place of the MLP, and the stack
sums its layers' router losses into the training loss.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import is_dtensor, shard_hint
from repro_torch.models import attention as att
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod

_KINDS = (cm.ATTN, cm.LOCAL_ATTN, cm.MAMBA2, cm.RGLRU)


def check_supported(cfg: cm.ModelConfig) -> None:
    """Raise ``ValueError`` for a layer kind the stack does not know."""
    for kind in cfg.pattern:
        if kind not in _KINDS:
            raise ValueError(kind)


# ---------------------------------------------------------------------------
# single layer
# ---------------------------------------------------------------------------

def init_layer(cfg: cm.ModelConfig, kind: str, gen: torch.Generator
               ) -> dict:
    dev = gen.device
    if kind == cm.MAMBA2:
        return {"norm1": cm.init_norm(cfg, dev),
                "mixer": ssm_mod.init_mamba2(cfg, gen)}
    p = {"norm1": cm.init_norm(cfg, dev), "norm2": cm.init_norm(cfg, dev)}
    if kind in (cm.ATTN, cm.LOCAL_ATTN):
        p["mixer"] = att.init_attn(cfg, gen)
    elif kind == cm.RGLRU:
        p["mixer"] = rglru_mod.init_rglru(cfg, gen)
    else:
        raise ValueError(kind)
    if cfg.moe is not None:
        p["moe"] = moe_mod.init_moe(cfg, gen)
    else:
        p["mlp"] = mlp_mod.init_mlp(cfg, gen)
    return p


def _channel_mix(cfg, p, x):
    """The second residual branch: ``(delta, aux)``, ``aux`` the MoE's
    router loss, ``None`` for an MLP (no router, JAX's float32 zero)."""
    h = cm.apply_norm(cfg, p["norm2"], x)
    if cfg.moe is not None:
        return moe_mod.moe_ffn(cfg, p["moe"], h)
    return mlp_mod.mlp(cfg, p["mlp"], h), None


def layer_forward(cfg: cm.ModelConfig, kind: str, p: dict, x: torch.Tensor,
                  positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor | None]:
    """Full-sequence layer: the mixer of ``kind`` on a residual branch,
    then (but for ``MAMBA2``) the channel mixer on another.  Returns
    ``(x, aux)``, ``aux`` as :func:`_channel_mix` gives it."""
    h = cm.apply_norm(cfg, p["norm1"], x)
    if kind == cm.ATTN:
        mix = att.attn_full(cfg, p["mixer"], h, positions, causal=True)
    elif kind == cm.LOCAL_ATTN:
        mix = att.attn_full(cfg, p["mixer"], h, positions, causal=True,
                            window=cfg.window)
    elif kind == cm.MAMBA2:
        return x + ssm_mod.mamba2_forward(cfg, p["mixer"], h), None
    elif kind == cm.RGLRU:
        mix = rglru_mod.rglru_forward(cfg, p["mixer"], h)
    else:
        raise ValueError(kind)
    x = x + mix
    delta, aux = _channel_mix(cfg, p, x)
    return x + delta, aux


def init_layer_cache(cfg: cm.ModelConfig, kind: str, batch: int,
                     max_len: int, device) -> dict:
    if kind == cm.ATTN:
        return att.init_cache(cfg, batch, max_len, device)
    if kind == cm.LOCAL_ATTN:
        return att.init_cache(cfg, batch, max_len, device, window=cfg.window)
    if kind == cm.MAMBA2:
        return ssm_mod.init_mamba2_cache(cfg, batch, device)
    if kind == cm.RGLRU:
        return rglru_mod.init_rglru_cache(cfg, batch, device)
    raise ValueError(kind)


def layer_decode(cfg: cm.ModelConfig, kind: str, p: dict, x: torch.Tensor,
                 cache: dict, pos) -> Tuple[torch.Tensor, dict]:
    h = cm.apply_norm(cfg, p["norm1"], x)
    if kind == cm.ATTN:
        mix, cache = att.attn_decode(cfg, p["mixer"], h, cache, pos)
    elif kind == cm.LOCAL_ATTN:
        mix, cache = att.attn_decode(cfg, p["mixer"], h, cache, pos,
                                     window=cfg.window)
    elif kind == cm.MAMBA2:
        mix, cache = ssm_mod.mamba2_decode(cfg, p["mixer"], h, cache)
        return x + mix, cache
    elif kind == cm.RGLRU:
        mix, cache = rglru_mod.rglru_decode(cfg, p["mixer"], h, cache)
    else:
        raise ValueError(kind)
    x = x + mix
    delta, _ = _channel_mix(cfg, p, x)          # decode drops the router loss
    return x + delta, cache


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
        "layers": [init_layer(cfg, kind, gen) for kind in cfg.pattern],
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
    return shard_hint(x, "batch", "seq_act", "embed_act")


def _head(cfg, params, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["head"]
    logits = shard_hint(logits, "batch", "seq", "vocab")
    V, Vp = cfg.vocab_size, padded_vocab(cfg)
    if Vp != V:  # mask pad columns out of the softmax
        pad = torch.arange(Vp, device=x.device) < V
        logits = logits + torch.where(pad, 0.0, -1e9).to(logits.dtype)
    return logits


def _stack(cfg, params, tokens: torch.Tensor,
           prefix_embeds: torch.Tensor | None = None
           ) -> Tuple[torch.Tensor, torch.Tensor | None]:
    """``(x, aux)``: the layers' output (B, P + S, d), ``prefix_embeds``
    (B, P, d), cast to the compute dtype, before the token embeddings, and
    positions over the whole sequence, as JAX's ``lm_forward``; ``aux``
    the MoE layers' router losses summed in layer order (``None``
    without MoE layers)."""
    x = _embed(cfg, params, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    aux = None
    for kind, p in zip(cfg.pattern, params["layers"]):
        x, a = layer_forward(cfg, kind, p, x, positions)
        # the sequence-parallel residual stream (JAX hints its scanned
        # layers; the port's loop hints every layer)
        x = shard_hint(x, "batch", "seq_act", None)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def lm_forward(cfg: cm.ModelConfig, params: dict, tokens: torch.Tensor,
               prefix_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """tokens (B, S) [+ prefix (B, P, d) precomputed embeddings] ->
    logits (B, P + S, Vp)."""
    x, _ = _stack(cfg, params, tokens, prefix_embeds)
    return _head(cfg, params, cm.apply_norm(cfg, params["final_norm"], x))


def lm_loss(cfg: cm.ModelConfig, params: dict, batch: dict,
            aux_weight: float = 0.01) -> Tuple[torch.Tensor, dict]:
    """``batch["tokens"]`` (B, S) [+ ``"prefix_embeds"`` (B, P, d)] ->
    ``(loss, {"ce", "aux"})``: next-token cross entropy over the token
    positions' logits, ``loss = ce + aux_weight · aux`` with ``aux`` the
    MoE layers' summed router losses (a float32 zero for a stack without
    them), as ``repro/models/transformer.py::lm_loss``.  JAX computes the
    prefix positions' logits too and slices them off; the port drops the
    prefix positions' hidden states before the final norm and the head, which
    act on each position alone: the same function, without the (B, P,
    Vp) logits."""
    tokens = batch["tokens"]
    x, aux = _stack(cfg, params, tokens, batch.get("prefix_embeds"))
    x = x[:, x.shape[1] - tokens.shape[1]:]
    logits = _head(cfg, params, cm.apply_norm(cfg, params["final_norm"], x))
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    ce = cross_entropy(logits, tokens)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def _vocab_split(t: torch.Tensor) -> bool:
    """Whether ``t`` is a ``DTensor`` whose last dim is split over a mesh
    dim of more than one rank."""
    if not is_dtensor(t):
        return False
    return any(p.is_shard(t.ndim - 1) and t.device_mesh.size(i) > 1
               for i, p in enumerate(t.placements))


def _gold_vocab_parallel(lg: torch.Tensor, tg: torch.Tensor
                         ) -> torch.Tensor:
    """``lg.gather(-1, tg)`` of vocab-sharded logits, a rank at a time:
    each rank reads the gold logits that fall in its vocab slice (zero
    elsewhere) and one all-reduce of (B, S - 1) over the vocab's shards
    adds them.  (DTensor's own gather would gather the whole logits.)"""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, lg_pl, last = lg.device_mesh, tuple(lg.placements), lg.ndim - 1
    tg_pl = tuple(Replicate() if p.is_shard(last) else p for p in lg_pl)
    groups = [mesh.get_group(i) for i, p in enumerate(lg_pl)
              if p.is_shard(last)]
    r, _ = sharding.shard_coordinate(mesh, lg_pl, last)

    def local(lgl, tgl):
        v = lgl.shape[-1]
        idx = tgl - r * v
        ok = (idx >= 0) & (idx < v)
        got = lgl.gather(-1, idx.clamp(0, v - 1)[..., None])[..., 0]
        got = torch.where(ok, got, 0.0)
        for g in groups:
            got = sharding.all_sum(got, g)
        return got

    return local_map(local, out_placements=list(tg_pl),
                     in_placements=(lg_pl, tg_pl),
                     in_grad_placements=(lg_pl, tg_pl), device_mesh=mesh,
                     redistribute_inputs=True)(lg, tg)


def cross_entropy(logits: torch.Tensor, tokens: torch.Tensor
                  ) -> torch.Tensor:
    """Next-token CE in float32: the mean over the ``B·(S−1)`` predicted
    positions of ``logsumexp(logits) − logits[gold]``.  JAX reads the
    gold logit through a one-hot contraction, a sharding choice; the
    gather is the same function (one index a row, so its gradient has no
    sums to order)."""
    lg = logits[:, :-1].float()
    tg = tokens[:, 1:].long()
    if _vocab_split(lg):
        # vocab-parallel: DTensor's logsumexp would gather the whole
        # vocab on every rank; the max and the sum over the vocab shards
        # are all-reduces of (B, S - 1), held whole over the vocab's
        # shards (and so their gradients, which then meet the logits'
        # shards where they lie)
        m = shard_hint(lg.detach().amax(-1, keepdim=True), "batch", "seq",
                       None)
        s = shard_hint(torch.exp(lg - m).sum(-1), "batch", "seq")
        lse = torch.log(s) + m[..., 0]
    else:
        lse = torch.logsumexp(lg, dim=-1)
    if _vocab_split(lg):
        gold = _gold_vocab_parallel(lg, tg)
    else:
        gold = lg.gather(-1, tg[..., None])[..., 0]
    return (lse - gold).mean()


def lm_prefill(cfg: cm.ModelConfig, params: dict, tokens: torch.Tensor,
               prefix_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence forward (``prefix_embeds`` first, as
    :func:`lm_forward`) returning the last position's logits (B, 1, Vp).
    Only that position goes through the final norm and the head: the (B,
    S, Vp) logits are never made."""
    x = _stack(cfg, params, tokens, prefix_embeds)[0][:, -1:]
    return _head(cfg, params, cm.apply_norm(cfg, params["final_norm"], x))


def lm_init_cache(cfg: cm.ModelConfig, batch: int, max_len: int,
                  device) -> List[dict]:
    """One cache dict a layer, in model order."""
    return [init_layer_cache(cfg, kind, batch, max_len, device)
            for kind in cfg.pattern]


def lm_decode_step(cfg: cm.ModelConfig, params: dict, cache: List[dict],
                   token: torch.Tensor, pos
                   ) -> Tuple[torch.Tensor, List[dict]]:
    """token (B, 1) at absolute position ``pos`` (a 0-dim int32 tensor on
    the device, as JAX's traced ``pos``, or an int) -> (logits (B, 1,
    Vp), cache).  The cache is updated in place."""
    x = _embed(cfg, params, token)
    pos = att.decode_pos(pos, x.device)
    for i, (kind, p) in enumerate(zip(cfg.pattern, params["layers"])):
        x, cache[i] = layer_decode(cfg, kind, p, x, cache[i], pos)
    x = cm.apply_norm(cfg, params["final_norm"], x)
    return _head(cfg, params, x), cache
