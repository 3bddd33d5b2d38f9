"""Mamba-2 SSD (state-space duality) mixer: the chunked parallel form for
training and prefill, the O(1)-state recurrence for decode.

Port of ``repro/models/ssm.py``, with JAX's ``shard_hint`` sites
(no-ops unless sharding rules are active).  Parameters keep JAX's
names, shapes and dtypes: ``A_log``, ``dt_bias`` and ``D`` are float32
inside a model of any compute dtype, and all the decay math
(``softplus(dt + dt_bias)``, ``A = -exp(A_log)``, the cumulative sums and
every ``exp``) runs in float32, as JAX has it.  The rounding points of
the compute dtype are JAX's: the conv is a sum of ``conv_width`` shifted
products in JAX's order, then ``+ conv_b``, then SiLU; ``y`` is cast to
the input's dtype before the gate; the gate ``y * silu(z)`` comes before
the RMS norm with ``(1 + scale)``.

Two places compute JAX's function in another float32 order: the
three-operand contractions are done as two products (PyTorch picks no
order of its own), and the ``n_groups`` B and C are broadcast to their
heads instead of materialised by ``jnp.repeat`` (head ``h`` reads group
``h // (H / G)``, as the repeat lays them out).  The intra-chunk decay
``exp(cs_q - cs_s)`` is taken of the segment sums with the upper triangle
set to ``-inf`` first: the same values as JAX's ``where(tri, exp(seg),
0)``, whose gradient is NaN once an upper-triangle ``exp`` overflows
float32 (long chunks at large ``A``), where this one's is 0.

No TPU kernel lies on this path; it runs PyTorch as JAX runs ``jnp``.
Decode writes the ``conv`` and ``ssm`` state into the cache tensors in
place (JAX returns new arrays), so a captured decode step
(``launch.serve_lm.DecodeStep``) replays on static buffers.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (is_dtensor, shard_coordinate,
                                               shard_hint)
from repro_torch.models import common as cm


def _dims(cfg: cm.ModelConfig):
    sc = cfg.ssm
    d_in = sc.expand * cfg.d_model
    H = d_in // sc.head_dim
    return sc, d_in, H, sc.head_dim, sc.d_state, sc.n_groups


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def init_mamba2(cfg: cm.ModelConfig, gen: torch.Generator) -> dict:
    sc, d_in, H, Pd, N, G = _dims(cfg)
    d, dt, dev = cfg.d_model, cfg.compute_dtype, gen.device
    conv_ch = d_in + 2 * G * N
    u = torch.rand((H,), generator=gen, dtype=torch.float32, device=dev)
    dt_init = torch.exp(u * (math.log(sc.dt_max) - math.log(sc.dt_min))
                        + math.log(sc.dt_min))
    return {
        # fused input projection: [z, x, B, C, dt]
        "w_in": cm.dense_init(gen, (d, 2 * d_in + 2 * G * N + H), dt),
        "conv_w": cm.dense_init(gen, (sc.conv_width, conv_ch), dt,
                                fan_in=sc.conv_width),
        "conv_b": torch.zeros(conv_ch, dtype=dt, device=dev),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=dev)),
        "dt_bias": torch.log(torch.expm1(dt_init)),     # softplus inverse
        "D": torch.ones(H, dtype=torch.float32, device=dev),
        "norm_scale": torch.zeros(d_in, dtype=dt, device=dev),
        "w_out": cm.dense_init(gen, (d_in, d), dt, fan_in=d_in),
    }


def _split_proj(cfg, p, x):
    sc, d_in, H, Pd, N, G = _dims(cfg)
    return torch.split(x @ p["w_in"], [d_in, d_in + 2 * G * N, H], dim=-1)


def _causal_conv(p, xbc: torch.Tensor, width: int) -> torch.Tensor:
    """Depthwise causal conv over the sequence of (B, S, C), then SiLU."""
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = pad[:, 0:S] * p["conv_w"][0]
    for i in range(1, width):
        out = out + pad[:, i:i + S] * p["conv_w"][i]
    return F.silu(out + p["conv_b"])


def _gate_norm(cfg, p, y, z):
    return cm.rmsnorm(y * F.silu(z), p["norm_scale"], cfg.norm_eps)


def ssd(chunk: int, G: int, xs: torch.Tensor, dtr: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, A_log: torch.Tensor,
        dt_bias: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """The SSD scan of one layer: ``xs`` (B, S, H, P), the raw step sizes
    ``dtr`` (B, S, H), ``Bm``/``Cm`` (B, S, G·N) of ``G`` groups and the
    heads' ``A_log``, ``dt_bias`` and ``D`` (H,) -> y (B, S, H, P) in
    float32, chunk by chunk (intra-chunk products, chunk end states, the
    inter-chunk recurrence, the states' outputs).  Heads are independent
    given their group's B and C, so ``DTensor`` inputs run a rank's heads
    at a time (:func:`_ssd_sharded`)."""
    if is_dtensor(xs):
        return _ssd_sharded(chunk, G, xs, dtr, Bm, Cm, A_log, dt_bias, D)
    B, S, H, Pd = xs.shape
    N = Bm.shape[-1] // G
    Q = min(chunk, S)
    assert S % Q == 0, f"seq {S} not divisible by ssd chunk {Q}"
    nc, rep = S // Q, H // G
    dev = xs.device

    dt = softplus(dtr.float() + dt_bias)                    # (B,S,H)
    A = -torch.exp(A_log)                                   # (H,)
    a_dt = (dt * A).reshape(B, nc, Q, H)
    xd = (xs.float() * dt[..., None]).reshape(B, nc, Q, H, Pd)
    Bc = Bm.float().reshape(B, nc, Q, G, N)
    Cc = Cm.float().reshape(B, nc, Q, G, N)

    cs = torch.cumsum(a_dt, dim=2)                   # inclusive (B,nc,Q,H)
    # 1. intra-chunk: L[q,s] = exp(cs_q - cs_s) for s <= q, else 0
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]   # (B,nc,Q,Q,H)
    upper = ~torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=dev))
    L = torch.exp(seg.masked_fill(upper[:, :, None], -torch.inf))
    scores = torch.einsum("bcqgn,bcsgn->bcqsg", Cc, Bc)  # (B,nc,Q,Q,G)
    M = (scores[..., None] * L.view(B, nc, Q, Q, G, rep)).reshape(
        B, nc, Q, Q, H)
    y_diag = torch.einsum("bcqsh,bcshp->bcqhp", M, xd)

    # 2. per-chunk end states: sum_s exp(cs_last - cs_s) B_s (x) xd_s
    decay_end = torch.exp(cs[:, :, -1:, :] - cs)                 # (B,nc,Q,H)
    states = torch.einsum(
        "bcsgrp,bcsgn->bcgrpn",
        (xd * decay_end[..., None]).reshape(B, nc, Q, G, rep, Pd), Bc
    ).reshape(B, nc, H, Pd, N)

    # 3. inter-chunk recurrence, chunk by chunk: the state before each
    chunk_decay = torch.exp(cs[:, :, -1, :])                     # (B,nc,H)
    h = torch.zeros((B, H, Pd, N), dtype=torch.float32, device=dev)
    prev = []
    for c in range(nc):
        prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                              # (B,nc,H,P,N)

    # 4. state -> output within chunk: C_q . prev * exp(cs_q)
    y_off = torch.einsum("bcqgn,bcgrpn->bcqgrp", Cc,
                         prev.reshape(B, nc, G, rep, Pd, N)).reshape(
        B, nc, Q, H, Pd) * torch.exp(cs)[..., None]
    y = (y_diag + y_off).reshape(B, S, H, Pd)
    y = y + D[None, None, :, None] * xs.float()
    return y


def _ssd_sharded(chunk, G, xs, dtr, Bm, Cm, A_log, dt_bias, D):
    """:func:`ssd` of ``DTensor``s by ``local_map``: each rank runs the
    heads ``xs`` holds (its heads dim as placed), with their groups' B and
    C and their entries of the (replicated) per-head parameters; the
    ranks' gradients of B, C and those parameters are then summed."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, xs_pl = xs.device_mesh, tuple(xs.placements)
    r, ways = shard_coordinate(mesh, xs_pl, 2)
    H = xs.shape[2]
    Hl, rep, N = H // ways, H // G, Bm.shape[-1] // G
    if Hl % rep and rep % Hl:
        raise ValueError(f"{Hl} local heads do not cover whole groups of "
                         f"{rep}")
    g_lo, g_hi = r * Hl // rep, (r * Hl + Hl - 1) // rep + 1
    bc_pl = tuple(Replicate() if p.is_shard(2) else p for p in xs_pl)
    bc_grad = tuple(Partial() if p.is_shard(2) else b
                    for p, b in zip(xs_pl, bc_pl))
    rep_pl = (Replicate(),) * mesh.ndim
    par_grad = tuple(Partial() if p.is_shard(2) else Replicate()
                     for p in xs_pl)

    def local(xl, dl, bl, cl, al, tl, dd):
        heads, groups = slice(r * Hl, (r + 1) * Hl), slice(g_lo * N, g_hi * N)
        return ssd(chunk, g_hi - g_lo, xl, dl, bl[..., groups],
                   cl[..., groups], al[heads], tl[heads], dd[heads])

    return local_map(
        local, out_placements=list(xs_pl),
        in_placements=(xs_pl, xs_pl, bc_pl, bc_pl, rep_pl, rep_pl, rep_pl),
        in_grad_placements=(xs_pl, xs_pl, bc_grad, bc_grad, par_grad,
                            par_grad, par_grad),
        device_mesh=mesh, redistribute_inputs=True,
    )(xs, dtr, Bm, Cm, A_log, dt_bias, D)


def mamba2_forward(cfg: cm.ModelConfig, p: dict, x: torch.Tensor
                   ) -> torch.Tensor:
    """Full-sequence SSD. x: (B, S, d) -> (B, S, d)."""
    sc, d_in, H, Pd, N, G = _dims(cfg)
    B, S, _ = x.shape

    z, xbc, dtr = _split_proj(cfg, p, x)
    xbc = _causal_conv(p, xbc, sc.conv_width)
    xs, Bm, Cm = torch.split(xbc, [d_in, G * N, G * N], dim=-1)
    xs = shard_hint(xs.reshape(B, S, H, Pd), "batch", "seq", "heads", None)

    y = ssd(sc.chunk, G, xs, dtr, Bm, Cm, p["A_log"], p["dt_bias"], p["D"])
    y = y.reshape(B, S, d_in).to(x.dtype)
    return shard_hint(_gate_norm(cfg, p, y, z) @ p["w_out"], "batch", "seq",
                      "embed_act")


def init_mamba2_cache(cfg: cm.ModelConfig, batch: int, device) -> dict:
    """The decode state of one layer: ``conv`` (batch, width - 1, C), the
    last inputs of the conv in the compute dtype, and ``ssm`` (batch, H,
    P, N) in float32; zeros."""
    sc, d_in, H, Pd, N, G = _dims(cfg)
    conv_ch = d_in + 2 * G * N
    return {
        "conv": torch.zeros((batch, sc.conv_width - 1, conv_ch),
                            dtype=cfg.compute_dtype, device=device),
        "ssm": torch.zeros((batch, H, Pd, N), dtype=torch.float32,
                           device=device),
    }


def conv_step(hist: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bwc,wc->bc", hist, w)`` in the compute dtype: float32
    products and sums, rounded once, as a dot of that dtype is."""
    return (hist.float() * w.float()).sum(dim=1).to(hist.dtype)


def mamba2_decode(cfg: cm.ModelConfig, p: dict, x: torch.Tensor,
                  cache: dict) -> Tuple[torch.Tensor, dict]:
    """Single-token recurrence. x: (B, 1, d).  The cache is updated in
    place.  No position is read: the state alone carries the past."""
    sc, d_in, H, Pd, N, G = _dims(cfg)
    B, rep = x.shape[0], H // G
    z, xbc, dtr = _split_proj(cfg, p, x)                     # (B,1,.)
    # conv window: the last width - 1 inputs and this one
    hist = torch.cat([cache["conv"], xbc], dim=1)            # (B,w,C)
    conv = F.silu(conv_step(hist, p["conv_w"]) + p["conv_b"])

    xs, Bm, Cm = torch.split(conv, [d_in, G * N, G * N], dim=-1)
    xs = xs.reshape(B, H, Pd)
    Bh = Bm.float().reshape(B, G, 1, N)
    Ch = Cm.float().reshape(B, G, 1, N)

    dt = softplus(dtr[:, 0].float() + p["dt_bias"])          # (B,H)
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A)
    xd = xs.float() * dt[..., None]                           # (B,H,P)
    outer = (xd.reshape(B, G, rep, Pd, 1) * Bh[:, :, :, None, :]).reshape(
        B, H, Pd, N)
    new_ssm = cache["ssm"] * a[:, :, None, None] + outer
    y = torch.einsum("bgrpn,bgn->bgrp", new_ssm.reshape(B, G, rep, Pd, N),
                     Ch[:, :, 0]).reshape(B, H, Pd)
    y = y + p["D"][None, :, None] * xs.float()
    y = y.reshape(B, 1, d_in).to(x.dtype)
    out = _gate_norm(cfg, p, y, z) @ p["w_out"]
    cache["conv"].copy_(hist[:, 1:])
    cache["ssm"].copy_(new_ssm)
    return out, cache
