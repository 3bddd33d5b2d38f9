"""Attention: GQA + RoPE + optional QKV bias + sliding window, with a KV
cache for serving.

Port of ``repro/models/attention.py``, with JAX's ``shard_hint`` sites
(no-ops unless sharding rules are active).  Parameters keep JAX's
shapes: ``wq`` (d, H, Dh), ``wk``/``wv`` (d, Kh, Dh), ``wo`` (H, Dh, d),
biases (H|Kh, Dh).  Under rules, ``DTensor`` attention runs a rank's
heads at a time (``distributed.sharding.map_heads``) and a decode cache
split along its sequence is written by the rank holding the slot
(:func:`write_slot`).

``mha`` is the plain path, with JAX's direct softmax and its chunked
online-softmax branch (one function; the chunked branch only bounds
memory).  ``attn_full`` sends self-attention without a window, causal
(every prefill and training layer of a decoder) or full (an encoder's
layers), to ``kernels.dispatch.flash_attention``, the CUDA kernel that
replaces the TPU kernel this module is the reference of, which takes
both (``_flash_kernel``'s ``causal`` flag); decode (``kv_valid_len``),
windows and cross-attention (queries and keys of different lengths,
``cross_cache`` / ``cross_attend``) stay on ``mha``, as the TPU kernel
computes none of them.  A local-attention layer decodes into a ring
buffer of ``window`` slots (``init_cache(..., window=)``,
``attn_decode(..., window=)``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.distributed.sharding import (is_dtensor, map_heads,
                                               shard_coordinate, shard_hint)
from repro_torch.kernels import dispatch
from repro_torch.models import common as cm


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_attn(cfg: cm.ModelConfig, gen: torch.Generator) -> dict:
    d, H, Kh, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.compute_dtype
    p = {
        "wq": cm.dense_init(gen, (d, H, Dh), dt, fan_in=d),
        "wk": cm.dense_init(gen, (d, Kh, Dh), dt, fan_in=d),
        "wv": cm.dense_init(gen, (d, Kh, Dh), dt, fan_in=d),
        "wo": cm.dense_init(gen, (H, Dh, d), dt, fan_in=H * Dh),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", H), ("bk", Kh), ("bv", Kh)):
            p[name] = torch.zeros((heads, Dh), dtype=dt, device=gen.device)
    return p


# ---------------------------------------------------------------------------
# core softmax attention (direct + chunked/online)
# ---------------------------------------------------------------------------

def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
               window: int, kv_valid_len=None) -> torch.Tensor:
    """Additive mask bias (0 / -inf) of shape (q, k) in float32."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    if kv_valid_len is not None:
        ok &= k_pos[None, :] < kv_valid_len
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, -torch.inf)


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``einsum("bqhd,bshd->bhqs")`` with float32 products and sums."""
    return torch.matmul(q.float().transpose(1, 2),
                        k.float().permute(0, 2, 3, 1))


def _weighted(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``einsum("bhqs,bshd->bhqd")`` of ``p`` rounded to ``v``'s dtype,
    float32 sums."""
    return torch.matmul(p.to(v.dtype).float(), v.float().transpose(1, 2))


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
        window: int = 0, q_offset=0, kv_valid_len=None,
        chunk: int = 0) -> torch.Tensor:
    """Grouped-query attention.

    q: (B, Sq, H, Dh); k/v: (B, Skv, Kh, Dh); returns (B, Sq, H, Dh).
    ``q_offset`` is the absolute position of q[0] (decode / windowed).
    ``chunk`` > 0 and Skv > chunk selects the online-softmax path.
    """
    if is_dtensor(q):                   # a rank's heads at a time
        return map_heads(lambda ql, kl, vl: mha(
            ql, kl, vl, causal=causal, window=window, q_offset=q_offset,
            kv_valid_len=kv_valid_len, chunk=chunk), q, k, v)
    B, Sq, H, Dh = q.shape
    G = H // k.shape[2]
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    k = shard_hint(k, "batch", None, "heads", None)
    v = shard_hint(v, "batch", None, "heads", None)
    dev = q.device
    # 1/sqrt(Dh) in float32 as JAX rounds it, as a Python float: a tensor
    # made on the card from a host value would wait for the card
    scale = (1.0 / torch.sqrt(torch.tensor(Dh, dtype=torch.float32))).item()
    q_pos = q_offset + torch.arange(Sq, device=dev)
    Skv = k.shape[1]

    if not chunk or Skv <= chunk:
        bias = _mask_bias(q_pos, torch.arange(Skv, device=dev),
                          causal=causal, window=window,
                          kv_valid_len=kv_valid_len)
        s = _scores(q, k) * scale + bias
        p = torch.softmax(s, dim=-1)
        return _weighted(p, v).transpose(1, 2).to(q.dtype)

    # online softmax: q blocks in turn, each over the kv blocks in turn;
    # memory O(B·H·cq·ck) whatever S
    out = torch.empty((B, Sq, H, Dh), dtype=q.dtype, device=dev)
    for q0 in range(0, Sq, chunk):
        qi = q[:, q0:q0 + chunk]
        qp = q_pos[q0:q0 + chunk]
        cq = qi.shape[1]
        m = torch.full((B, H, cq), -torch.inf, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, H, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, cq, Dh), dtype=torch.float32, device=dev)
        for k0 in range(0, Skv, chunk):
            kj, vj = k[:, k0:k0 + chunk], v[:, k0:k0 + chunk]
            bias = _mask_bias(qp, torch.arange(k0, k0 + kj.shape[1],
                                               device=dev),
                              causal=causal, window=window,
                              kv_valid_len=kv_valid_len)
            s = _scores(qi, kj) * scale + bias
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard all-masked rows: exp(-inf - -inf)
            m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            corr = torch.exp(torch.where(torch.isneginf(m), m_safe, m)
                             - m_safe)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + _weighted(p, vj)
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, q0:q0 + cq] = o.transpose(1, 2).to(q.dtype)
    return out


# ---------------------------------------------------------------------------
# block-level forward (projections + rope + cache plumbing)
# ---------------------------------------------------------------------------

def _project(x: torch.Tensor, w: torch.Tensor, heads: str) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")``: one matmul over the flattened heads.
    ``heads`` (``"heads"`` or ``"kv_heads"``) names the logical axis of
    the flattened dim, so that under sharding rules the product is split
    only between whole heads before it is viewed per head."""
    B, S, _ = x.shape
    y = shard_hint(x @ w.reshape(w.shape[0], -1), "batch", "seq", heads)
    return y.view(B, S, *w.shape[1:])


def qkv_proj(cfg: cm.ModelConfig, p: dict, x: torch.Tensor,
             kv_x: torch.Tensor | None = None):
    kv_x = x if kv_x is None else kv_x
    q = _project(x, p["wq"], "heads")
    k = _project(kv_x, p["wk"], "kv_heads")
    v = _project(kv_x, p["wv"], "kv_heads")
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = shard_hint(q, "batch", "seq", "heads", "head_dim")
    k = shard_hint(k, "batch", "seq", "kv_heads", "head_dim")
    v = shard_hint(v, "batch", "seq", "kv_heads", "head_dim")
    return q, k, v


def out_proj(p: dict, o: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")``."""
    B, S = o.shape[:2]
    wo = p["wo"]
    o = shard_hint(o.reshape(B, S, -1), "batch", "seq", "heads")
    y = o @ wo.reshape(-1, wo.shape[-1])
    return shard_hint(y, "batch", "seq", "embed_act")


def attn_full(cfg: cm.ModelConfig, p: dict, x: torch.Tensor,
              positions: torch.Tensor, *, causal: bool = True,
              window: int = 0, kv_x: torch.Tensor | None = None,
              kv_positions: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence attention (prefill, training, an encoder).
    Self-attention without a window, causal or full, goes to the flash
    kernel; the rest to ``mha``."""
    q, k, v = qkv_proj(cfg, p, x, kv_x)
    if cfg.pos_emb == "rope":
        q = cm.rope(q, positions, cfg.rope_base, cfg.rope_dim)
        kp = positions if kv_positions is None else kv_positions
        k = cm.rope(k, kp, cfg.rope_base, cfg.rope_dim)
    if window == 0 and kv_x is None:
        o = dispatch.flash_attention(q, k, v, causal=causal)
    else:
        o = mha(q, k, v, causal=causal, window=window,
                chunk=cfg.attn_chunk if k.shape[1] > cfg.attn_chunk else 0)
    return out_proj(p, o)


def init_cache(cfg: cm.ModelConfig, batch: int, max_len: int, device, *,
               window: int = 0) -> dict:
    """KV cache of one attention layer: ``k``/``v`` (batch, size, Kh,
    Dh), zeros in the compute dtype.  ``size`` is ``max_len``, or with
    ``window > 0`` a ring buffer of ``min(window, max_len)`` slots (local
    attention: O(window) state however long the decode)."""
    size = min(window, max_len) if window > 0 else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.hd)
    return {name: torch.zeros(shape, dtype=cfg.compute_dtype, device=device)
            for name in ("k", "v")}


def decode_pos(pos, device) -> torch.Tensor:
    """A decode position as JAX's traced ``pos``: a 0-dim int32 tensor on
    ``device``.  A Python int is filled there (a fill, not a copy from
    host memory), so eager callers may pass one."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32).reshape(())
    return torch.full((), int(pos), dtype=torch.int32, device=device)


def write_slot(cache: torch.Tensor, slot: torch.Tensor, new: torch.Tensor
               ) -> None:
    """``cache[:, slot] = new[:, 0]`` in place: ``cache`` (B, S, Kh, D),
    ``slot`` a 1-element long tensor on the device, ``new`` (B, 1, Kh, D).
    A ``DTensor`` cache whose sequence is split (``kv_seq``) is written a
    rank at a time: the rank holding ``slot`` writes it, the others write
    back what they hold, with no read of ``slot`` on the host."""
    if not is_dtensor(cache):
        cache.index_copy_(1, slot, new)
        return
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, pl = cache.device_mesh, tuple(cache.placements)
    r, _ = shard_coordinate(mesh, pl, 1)
    new_pl = tuple(Replicate() if p.is_shard(1) else p for p in pl)

    def local(cl, nl):
        size = cl.shape[1]
        at = slot.to(cl.device) - r * size
        idx = at.clamp(0, size - 1)
        ok = ((at >= 0) & (at < size)).reshape(1, 1, 1, 1)
        cl.index_copy_(1, idx, torch.where(ok, nl, cl.index_select(1, idx)))
        return cl

    local_map(local, out_placements=list(pl), in_placements=(pl, new_pl),
              device_mesh=mesh, redistribute_inputs=True)(cache, new)


def attn_decode(cfg: cm.ModelConfig, p: dict, x: torch.Tensor, cache: dict,
                pos, *, window: int = 0) -> Tuple[torch.Tensor, dict]:
    """One-token decode: x (B, 1, d) at absolute position ``pos``, a 0-dim
    int32 tensor on the device (JAX's traced ``pos``; an int is filled
    there), so a captured decode step reads it from the card.

    RoPE is applied before insertion, so every entry carries its absolute
    rotation.  The new key and value are written into the cache in place
    (``index_copy_``; JAX returns an updated copy) at slot ``pos``, or
    with ``window > 0`` at ``pos % size`` of the ring buffer.  The query
    attends over the whole cache with slots ``>= pos + 1`` masked, as JAX
    does; in a ring buffer every filled slot is a past position within
    the window, so only the ``min(pos + 1, size)`` filled slots count,
    without a causal mask."""
    B = x.shape[0]
    pos = decode_pos(pos, x.device)
    q, k, v = qkv_proj(cfg, p, x)
    posb = pos.reshape(1, 1).expand(B, 1)
    if cfg.pos_emb == "rope":
        q = cm.rope(q, posb, cfg.rope_base, cfg.rope_dim)
        k = cm.rope(k, posb, cfg.rope_base, cfg.rope_dim)
    size = cache["k"].shape[1]
    if window > 0:
        slot, valid = torch.remainder(pos, size), torch.clamp(pos + 1,
                                                              max=size)
    else:
        slot, valid = pos, pos + 1
    slot = slot.reshape(1).long()
    write_slot(cache["k"], slot, k)
    write_slot(cache["v"], slot, v)
    ck = shard_hint(cache["k"], "batch", "kv_seq", "kv_heads", "head_dim")
    cv = shard_hint(cache["v"], "batch", "kv_seq", "kv_heads", "head_dim")
    o = mha(q, ck, cv, causal=False, kv_valid_len=valid)
    return out_proj(p, o), cache


def cross_cache(cfg: cm.ModelConfig, p: dict, enc_out: torch.Tensor
                ) -> dict:
    """The encoder's keys and values of one cross-attention layer,
    ``k``/``v`` (B, n_ctx, Kh, Dh), computed once (whisper's decoder)."""
    k = _project(enc_out, p["wk"], "kv_heads")
    v = _project(enc_out, p["wv"], "kv_heads")
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return {"k": k, "v": v}


def cross_attend(cfg: cm.ModelConfig, p: dict, x: torch.Tensor,
                 cc: dict) -> torch.Tensor:
    """Queries of ``x`` (B, S, d) over every key of ``cc`` (no mask), on
    ``mha``'s direct softmax as JAX's, then the output projection."""
    q = _project(x, p["wq"], "heads")
    if cfg.qkv_bias:
        q = q + p["bq"]
    o = mha(q, cc["k"], cc["v"], causal=False)
    return out_proj(p, o)
