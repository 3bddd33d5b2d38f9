"""Mixture-of-Experts channel mixer: a float32 router, top-k experts under
a Switch-style fixed capacity, and one batched SwiGLU over the experts.

Port of ``repro/models/moe.py`` for one device.  Every shape is static,
as JAX's: a layer's ``T`` tokens fill an ``(E_local, C, d)`` buffer with
``C = max(1, int(T·k·capacity_factor / E))`` slots an expert, so a
(token, choice) pair past its expert's capacity is dropped (its weight is
0 and the token keeps its residual stream), and which pairs are dropped
depends on the whole batch: ``C`` is computed from the ``T`` of each call
(``B·S`` in prefill and training, ``B`` at decode).  Nothing reads a
value on the host, so the decode step can be captured in a CUDA graph.

The slots are JAX's: a cumsum over the token-major ``(T·k, E)`` one-hot
gives each pair its place in its expert.  JAX scatters with ``.add``, its
dropped pairs adding zeros at a clipped slot; the port gathers instead,
every slot reading the one token routed to it (:func:`dispatch`), so no
two contributions meet in one place and the forward and its gradient
are deterministic (``F.embedding``'s gradient sums a row's uses in a
fixed order).  The combine is JAX's: for j = 0…k−1, ``y = y + got·w`` in
the compute dtype, ``got`` read at the (clipped) slot and ``w`` 0 for a
dropped pair.  The expert products stay cuBLAS batched GEMMs, as JAX's
``jnp.einsum``: no TPU kernel lies on this path.

``moe_body`` keeps JAX's expert-shard arguments (``e_offset``,
``n_local``): its partial outputs over the shards sum to the whole.
``moe_ffn`` runs all experts on one device; JAX's ``shard_map`` + ``psum``
branch waits for ROADMAP item A18.8 (``distributed/sharding.py``).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm

# the lists that moe_body appends its routes to (see log_routes)
_ROUTE_LOGS: List[list] = []


def init_moe(cfg: cm.ModelConfig, gen: torch.Generator) -> dict:
    """``router`` (d, E) float32 whatever the compute dtype; ``w_gate``,
    ``w_up`` (E, d, f) and ``w_down`` (E, f, d) in the compute dtype, with
    ``dense_init``'s default ``fan_in = shape[0]`` (E for the gate and up
    weights), as JAX's."""
    mc = cfg.moe
    d, f, E = cfg.d_model, mc.d_ff, mc.n_experts
    dt = cfg.compute_dtype
    return {
        "router": cm.dense_init(gen, (d, E), torch.float32),
        "w_gate": cm.dense_init(gen, (E, d, f), dt),
        "w_up": cm.dense_init(gen, (E, d, f), dt),
        "w_down": cm.dense_init(gen, (E, f, d), dt, fan_in=f),
    }


def capacity(cfg: cm.ModelConfig, T: int) -> int:
    """Slots an expert for ``T`` tokens: JAX's expression."""
    mc = cfg.moe
    return max(1, int(T * mc.top_k * mc.capacity_factor / mc.n_experts))


def route(cfg: cm.ModelConfig, p: dict, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (T, d) -> ``(probs, topw, topi, pos)``: the float32 router
    softmax (T, E); the top-k probabilities renormalised (floor 1e-9) and
    their experts (T, k), largest first; each pair's place in its expert,
    counted over the token-major flattened pairs."""
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    T = x.shape[0]
    logits = (x.float() @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    # JAX's (T·k, E) one-hot, held expert-major: the cumsum over the
    # pairs then runs along the inner dim, which the card scans in
    # parallel (along the outer dim it walks the T·k rows in turn)
    onehot = (torch.arange(E, device=x.device)[:, None]
              == topi.reshape(1, -1)).to(torch.int32)           # (E, T·k)
    pos = (torch.cumsum(onehot, dim=1, dtype=torch.int32) * onehot).sum(0)
    return probs, topw, topi, (pos - 1).reshape(T, k)


def aux_loss(probs: torch.Tensor, topi: torch.Tensor) -> torch.Tensor:
    """The Switch load-balance loss from the first choice: ``E · Σ_e
    (share of tokens whose first expert is e) · (mean probability of
    e)``."""
    E = probs.shape[-1]
    sel = (topi[:, :1] == torch.arange(E, device=probs.device)).float()
    return E * torch.sum(sel.mean(0) * probs.mean(0))


def slots(topi: torch.Tensor, pos: torch.Tensor, C: int, e_offset: int,
          n_local: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(kept, slot)`` (T, k): whether a pair's expert is local and its
    place under ``C``, and its flat slot ``local expert · C + place``,
    clipped as JAX clips it."""
    local = (topi >= e_offset) & (topi < e_offset + n_local)
    kept = local & (pos < C)
    le = torch.clamp(topi - e_offset, 0, n_local - 1)
    return kept, le * C + torch.clamp(pos, 0, C - 1)


def dispatch(x: torch.Tensor, kept: torch.Tensor, slot: torch.Tensor,
             n_local: int, C: int) -> torch.Tensor:
    """The (n_local, C, d) buffer: each slot holds the token routed to it,
    zeros where none is.  The token of every slot is found first (an
    integer scatter; a dropped pair writes a place of its own past the
    slots), then one gather reads the rows: row T of the padded ``x`` is
    the zero row of an empty slot."""
    T, d = x.shape
    n_slots = n_local * C
    pairs = slot.numel()
    dest = torch.where(kept, slot, n_slots + torch.arange(
        pairs, device=x.device).reshape(slot.shape))
    src = torch.full((n_slots + pairs,), T, dtype=torch.long,
                     device=x.device)
    tok = torch.arange(T, device=x.device)[:, None].expand_as(slot)
    src.scatter_(0, dest.reshape(-1), tok.reshape(-1))
    return F.embedding(src[:n_slots], F.pad(x, (0, 0, 0, 1))).reshape(
        n_local, C, d)


def experts(p: dict, buf: torch.Tensor) -> torch.Tensor:
    """The batched SwiGLU of each expert on its slots: (E, C, d) ->
    (E, C, d)."""
    g = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    return torch.bmm(F.silu(g) * u, p["w_down"])


def combine(out: torch.Tensor, kept: torch.Tensor, slot: torch.Tensor,
            topw: torch.Tensor) -> torch.Tensor:
    """y (T, d) in ``out``'s dtype: ``y = y + got·w`` for j = 0…k−1, ``got``
    the expert output at the pair's slot and ``w`` its weight, 0 for a
    dropped pair."""
    flat = out.reshape(-1, out.shape[-1])
    y = torch.zeros((slot.shape[0], flat.shape[1]), dtype=out.dtype,
                    device=out.device)
    for j in range(slot.shape[1]):
        got = F.embedding(slot[:, j], flat)
        w = torch.where(kept[:, j], topw[:, j], 0.0).to(out.dtype)
        y = y + got * w[:, None]
    return y


def moe_body(cfg: cm.ModelConfig, p: dict, x: torch.Tensor, e_offset: int,
             n_local: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) local tokens, ``p`` holding experts ``e_offset`` …
    ``e_offset + n_local − 1`` (the router whole) -> ``(partial y (T, d),
    aux)``, as ``repro/models/moe.py::_moe_body``."""
    C = capacity(cfg, x.shape[0])
    probs, topw, topi, pos = route(cfg, p, x)
    aux = aux_loss(probs, topi)
    kept, slot = slots(topi, pos, C, e_offset, n_local)
    for log in _ROUTE_LOGS:
        log.append((topi.detach(), kept))
    y = combine(experts(p, dispatch(x, kept, slot, n_local, C)), kept, slot,
                topw)
    return y, aux


def moe_ffn(cfg: cm.ModelConfig, p: dict, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> ``(y (B, S, d), aux)``: all experts on this device,
    the tokens of the whole batch routed together.  JAX's expert-parallel
    branch (``shard_map`` over the ``experts`` mesh axis, ``psum`` of the
    partials) is ROADMAP item A18.8."""
    B, S, d = x.shape
    y, aux = moe_body(cfg, p, x.reshape(B * S, d), 0, cfg.moe.n_experts)
    return y.reshape(B, S, d), aux


@contextlib.contextmanager
def log_routes() -> Iterator[list]:
    """Within the block, every ``moe_body`` call appends ``(topi, kept)``
    (T, k), its experts and whether capacity kept each pair, to the
    yielded list, on the device and unread: the routes and drops of a
    prefill or a decode, read afterwards.  Calls inside a captured graph's
    replays run no Python and append nothing."""
    log: list = []
    _ROUTE_LOGS.append(log)
    try:
        yield log
    finally:
        _ROUTE_LOGS[:] = [other for other in _ROUTE_LOGS
                          if other is not log]
