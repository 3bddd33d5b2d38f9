"""Mixture-of-Experts channel mixer: a float32 router, top-k experts under
a Switch-style fixed capacity, and one batched SwiGLU over the experts.

Port of ``repro/models/moe.py``.  Every shape is static,
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
``moe_ffn`` runs all experts on one device, unless sharding rules are
active (``distributed.sharding``) that put ``experts`` on a mesh axis
whose size ``m`` divides ``E``: then each rank runs its ``E / m`` experts
on its batch shard (``local_map``), the partial outputs are summed over
that axis and the router loss averaged, as JAX's ``shard_map`` + ``psum``
branch (:func:`_moe_expert_parallel`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
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
    """x (B, S, d) -> ``(y (B, S, d), aux)``.  With no rules active: all
    experts here, the tokens of the whole batch routed together.  Under
    rules that put ``experts`` on a mesh axis dividing ``E``: the
    expert-parallel branch (:func:`_moe_expert_parallel`); otherwise, on
    a ``DTensor`` ``x``, the same branch with every expert on every rank
    (JAX's fallback to all experts local)."""
    rules = sharding.current_rules()
    ep_axis = rules.table.get("experts") if rules is not None else None
    if ep_axis is not None and \
            cfg.moe.n_experts % rules.axis_size(ep_axis):
        ep_axis = None
    if ep_axis is not None or (rules is not None and
                               sharding.is_dtensor(x)):
        return _moe_expert_parallel(cfg, rules, ep_axis, p, x)
    B, S, d = x.shape
    y, aux = moe_body(cfg, p, x.reshape(B * S, d), 0, cfg.moe.n_experts)
    return y.reshape(B, S, d), aux


def _moe_expert_parallel(cfg: cm.ModelConfig, rules, ep_axis: str, p: dict,
                         x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``shard_map`` branch of ``moe_ffn``: the experts' weights
    sharded over ``ep_axis`` (size ``m``; None: m = 1, every expert on
    every rank) and whole over the other axes,
    the router replicated, ``x`` over the data axes by batch.  Each rank
    runs ``moe_body`` on its ``E / m`` experts (``e_offset = rank · E /
    m``) and its tokens; ``y`` is summed over ``ep_axis`` and ``aux``
    summed over it and divided by ``m``, then averaged over the data
    axes.  The sums run in the compute dtype (``y``) and float32
    (``aux``).  ``x`` may be a ``DTensor`` or, with ``p`` too, a plain
    tensor, which is taken as replicated (and then ``y`` and ``aux``
    come back whole, as plain tensors)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = rules.mesh
    m = rules.axis_size(ep_axis)           # 1 for None
    n_local = cfg.moe.n_experts // m
    B, S, d = x.shape
    dp = rules.table.get("batch") or ()
    dp = dp if isinstance(dp, tuple) else (dp,)
    x_pl = rules.placements("batch", None, None, shape=(B, S, d))
    w_pl = sharding.placements_of(rules, (ep_axis, None, None))
    rep = (Replicate(),) * mesh.ndim
    names = sorted(p)
    # JAX pmeans aux over the whole data axes, whether or not they split
    # this batch
    dp_size = math.prod(rules.axis_size(a) for a in dp)
    ep_group = mesh.get_group(ep_axis) if ep_axis else None
    dp_groups = [mesh.get_group(a) for a in dp]
    offset = mesh.get_local_rank(ep_axis) * n_local if ep_axis else 0

    def body(xl, *leaves):
        Bl, Sl, _ = xl.shape
        y, aux = moe_body(cfg, dict(zip(names, leaves)),
                          xl.reshape(Bl * Sl, d), offset, n_local)
        if ep_group is not None:
            y = sharding.all_sum(y, ep_group)
            aux = sharding.all_sum(aux, ep_group) / m
        for g in dp_groups:
            aux = sharding.all_sum(aux, g)
        if dp_size > 1:
            aux = aux / dp_size
        return y.reshape(Bl, Sl, d), aux

    def placed(t):
        return t if isinstance(t, DTensor) else DTensor.from_local(
            t, mesh, rep, run_check=False)

    # the gradients: a rank's share of x's and the router's over
    # ep_axis (its experts' part) and of every weight's over the mesh
    # dims that split the batch; whole where the ranks ran the same work
    ep_dim = rules.mesh_dim(ep_axis) if ep_axis else None
    x_grad = tuple(Partial() if i == ep_dim else pl
                   for i, pl in enumerate(x_pl))
    w_grad = tuple(Partial() if x_pl[i].is_shard() else w_pl[i]
                   for i in range(mesh.ndim))
    r_grad = tuple(Partial() if i == ep_dim or x_pl[i].is_shard()
                   else Replicate() for i in range(mesh.ndim))
    y, aux = local_map(
        body, out_placements=(x_pl, rep),
        in_placements=(x_pl,) + tuple(rep if k == "router" else w_pl
                                      for k in names),
        in_grad_placements=(x_grad,) + tuple(
            r_grad if k == "router" else w_grad for k in names),
        device_mesh=mesh, redistribute_inputs=True,
    )(placed(x), *(placed(p[k]) for k in names))
    if not isinstance(x, DTensor):          # plain in, plain out
        return y.full_tensor(), aux.full_tensor()
    return y, aux


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
