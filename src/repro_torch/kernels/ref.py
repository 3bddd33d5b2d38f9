"""Plain PyTorch versions of the kernels.

The CPU path of every wrapper, and the oracle ``chip_smoke.py`` holds
each CUDA kernel against on the card.  They repeat the kernels'
arithmetic and are no yardstick of speed.
"""

from __future__ import annotations

import torch

from repro_torch.core import lut as lut_mod
from repro_torch.core import quantize as qz


def fxp_matmul_ref(a: torch.Tensor, b: torch.Tensor, *,
                   k_chunk: int = 4096) -> torch.Tensor:
    """The function of the ``fxp_matmul`` kernel, ``quantize.hybrid_dot``:
    ``(..., M, K) x (..., K, N)`` int8/int16 -> float32 ``(..., M, N)``.
    Both operands split into int8-range limbs; every (limb pair, K-chunk)
    partial is an exact integer (a float64 product), converted to float32;
    the chunks sum in order, each pair's sum is scaled by its limb weights,
    and the pairs sum in order from the first term."""
    return qz.hybrid_dot(a, b, k_chunk=k_chunk)


def fxp_matmul_int32_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The int32 product of int8 ``a`` ``(..., M, K)`` and ``b`` ``(..., K,
    N)``, as an int32 accumulator gives it (the TPU kernel's output): the
    exact sum, wrapped to int32.  On the CPU in int64; on the card, where
    no integer matmul exists, in float64, exact while K < 2^38."""
    if a.device.type == "cpu":
        exact = torch.matmul(a.long(), b.long())
    else:
        exact = torch.matmul(a.double(), b.double()).long()
    return exact.to(torch.int32)


def lut_activation_ref(x: torch.Tensor, table: torch.Tensor, x_min: float,
                       x_max: float) -> torch.Tensor:
    """Nearest-entry lookup, ``repro_torch.core.lut.lut_lookup``."""
    return lut_mod.lut_lookup(lut_mod.LutTable(table, x_min, x_max), x)


def kmeans_assign_ref(x: torch.Tensor, centroids: torch.Tensor,
                      w: torch.Tensor, x_scale: torch.Tensor | None = None,
                      *, return_assign: bool = False):
    """Per-lane K-means partials: ``x`` ``(L, R, D)`` float32, int16 or
    int8 (dequantized as ``x.float() * x_scale``), ``centroids`` ``(K, D)``
    shared or ``(L, K, D)`` per lane, ``w`` ``(L, R)`` -> ``sums (L, K,
    D)``, ``counts (L, K)``, ``sse (L,)`` (and the int32 assignments
    ``(L, R)`` with ``return_assign``).

    ``x·c`` and ``|c|²`` are summed over ``j = 0..D-1`` in order with
    one elementwise product and one add per term, as the kernel does, so
    the assignments (first index on ties) are the kernel's bit for bit;
    a matmul would sum in its own order.  The sums over rows and the sse
    accumulate in float64 and round once: a float32 matmul sums each cell
    along the rows one after another, and where int8 rows repeat a value
    thousands of times its rounding drifts to ~1e-4 of the cell's mass.
    """
    xf = x.float()
    if x_scale is not None:
        xf = xf * x_scale.reshape(-1)
    c = centroids.float()
    c = c if c.dim() == 3 else c.unsqueeze(0)                 # (L|1, K, D)
    K = c.shape[-2]
    xc = xf.new_zeros(xf.shape[:-1] + (K,))
    c2 = c.new_zeros(c.shape[:-1])
    x2 = xf.new_zeros(xf.shape[:-1])
    for j in range(xf.shape[-1]):
        xj, cj = xf[..., j], c[..., j]
        xc = xc + xj[..., None] * cj[:, None, :]
        c2 = c2 + cj * cj
        x2 = x2 + xj * xj
    d = c2[:, None, :] - 2.0 * xc                             # (L, R, K)
    a = torch.argmin(d, dim=-1)
    best = d.gather(-1, a[..., None])[..., 0]
    onehot = (a[..., None] == torch.arange(K, device=x.device)).float() \
        * w[..., None]
    sums = torch.matmul(onehot.transpose(-1, -2).double(), xf.double())
    sse = ((best + x2) * w).double().sum(dim=-1)
    out = (sums.float(), onehot.sum(dim=-2), sse.float())
    return out + (a.to(torch.int32),) if return_assign else out


def split_hist_ref(node: torch.Tensor, xbin: torch.Tensor, y: torch.Tensor,
                   w: torch.Tensor, *, n_nodes: int, n_bins: int,
                   n_classes: int) -> torch.Tensor:
    """Per-lane weighted split histogram: ``node`` ``(L, R)``, ``xbin``
    ``(L, R, F)``, ``y`` ``(L, R)``, ``w`` ``(L, R)`` -> ``H (L, n_nodes,
    F, n_bins, n_classes)`` float32.  Elements whose node, bin or class
    lies outside its range add nothing (as the kernel)."""
    L, R, F = xbin.shape
    nd, yc, b = node.long()[..., None], y.long()[..., None], xbin.long()
    ok = ((nd >= 0) & (nd < n_nodes) & (yc >= 0) & (yc < n_classes)
          & (b >= 0) & (b < n_bins))
    lane = torch.arange(L, device=xbin.device)[:, None, None]
    f = torch.arange(F, device=xbin.device)
    flat = ((((lane * n_nodes + nd) * F + f) * n_bins + b) * n_classes + yc)
    flat = torch.where(ok, flat, 0)
    inc = torch.where(ok, w.float()[..., None], 0.0)
    H = torch.zeros(L * n_nodes * F * n_bins * n_classes,
                    dtype=torch.float32, device=xbin.device)
    H.index_add_(0, flat.reshape(-1), inc.reshape(-1))
    return H.reshape(L, n_nodes, F, n_bins, n_classes)


FLASH_TILE = 64               # keys per tile, as the mma.sync kernel walks them
FLASH_NEG_INF = -1e30         # the TPU kernel's mask value


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, return_lse: bool = False):
    """Online-softmax attention over 64-key tiles, in float32 throughout
    as the TPU kernel computes it: ``q`` ``(B, H, S, D)``, ``k``/``v``
    ``(B, Kh, S, D)`` with ``H % Kh == 0`` (query head ``h`` reads key
    head ``h // (H / Kh)``) -> ``(B, H, S, D)`` in ``q``'s dtype.

    q, k and v are upcast to float32 before any product, as
    ``repro/kernels/flash_attention.py:43-45`` does, so ``p = exp(s −
    m_new)`` enters ``p·v`` in float32 and the one rounding to a narrower
    dtype is the output's.  Hence the bf16 result equals this function on
    ``q.float(), k.float(), v.float()`` rounded once to bf16, bit for
    bit.  Scores ``q·kᵀ · (1/√D)`` (the scale is the Python float rounded
    once, as the TPU kernel has it); masked scores are ``-1e30`` and
    their ``p`` is 0; the output is ``acc / max(l, 1e-30)``, a division,
    so a row with no unmasked key gives 0.

    With ``return_lse`` it returns ``(out, lse)``, ``lse = m + log(l)``
    the float32 row log-sum-exp of the scaled scores ``(B, H, S)``, which
    the backward (:func:`flash_attention_bwd_ref`) takes."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    kx = k.repeat_interleave(G, dim=1) if G > 1 else k
    vx = v.repeat_interleave(G, dim=1) if G > 1 else v
    scale = torch.tensor(1.0 / D ** 0.5, dtype=torch.float32).item()
    qf = q.float()
    rows = torch.arange(S, device=q.device)
    m = torch.full((B, H, S), FLASH_NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, S, FLASH_TILE):
        k1 = min(S, k0 + FLASH_TILE)
        cols = torch.arange(k0, k1, device=q.device)
        s = torch.matmul(qf, kx[:, :, k0:k1].float().transpose(-1, -2)
                         ) * scale
        ok = cols[None, :] <= rows[:, None] if causal else \
            torch.ones((S, cols.numel()), dtype=torch.bool, device=q.device)
        s = torch.where(ok, s, FLASH_NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.matmul(p, vx[:, :, k0:k1].float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return (out, m + torch.log(l)) if return_lse else out


FLASH_BWD_ROWS = 512          # query rows a pass of the plain backward


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor, *,
                            causal: bool = True):
    """The gradient of :func:`flash_attention_ref` from its output ``o``,
    the output's gradient ``do`` (both ``(B, H, S, D)``) and the forward's
    row log-sum-exp ``lse`` ``(B, H, S)``: ``(dq, dk, dv)`` in the
    inputs' dtype, shaped as ``q``, ``k`` and ``v``.

    FlashAttention-2's formulas in float32, not autograd: with ``s = q·kᵀ
    · scale`` (the forward's float32 scale) and ``p = exp(s − lse)`` (0
    where masked),

        Δ  = rowsum(dO ∘ O)          dv = pᵀ·dO
        dp = dO·vᵀ                   ds = p ∘ (dp − Δ)
        dq = scale · ds·k            dk = scale · dsᵀ·q

    and a key head's dk and dv sum over the ``H / Kh`` query heads that
    read it.  Query rows go in passes of ``FLASH_BWD_ROWS``, so the
    float32 scores of one pass are all that is held."""
    B, H, S, D = q.shape
    Kh = k.shape[1]
    G = H // Kh
    kx = (k.repeat_interleave(G, dim=1) if G > 1 else k).float()
    vx = (v.repeat_interleave(G, dim=1) if G > 1 else v).float()
    scale = torch.tensor(1.0 / D ** 0.5, dtype=torch.float32).item()
    qf, dof = q.float(), do.float()
    delta = (dof * o.float()).sum(dim=-1)                      # (B, H, S)
    keys = torch.arange(S, device=q.device)
    dq = torch.empty((B, H, S, D), dtype=torch.float32, device=q.device)
    dkx = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    dvx = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    for r0 in range(0, S, FLASH_BWD_ROWS):
        r1 = min(S, r0 + FLASH_BWD_ROWS)
        s = torch.matmul(qf[:, :, r0:r1], kx.transpose(-1, -2)) * scale
        p = torch.exp(s - lse[:, :, r0:r1, None])
        if causal:
            rows = torch.arange(r0, r1, device=q.device)
            p = torch.where(keys[None, :] <= rows[:, None], p, 0.0)
        dvx += torch.matmul(p.transpose(-1, -2), dof[:, :, r0:r1])
        dp = torch.matmul(dof[:, :, r0:r1], vx.transpose(-1, -2))
        ds = p * (dp - delta[:, :, r0:r1, None])
        dq[:, :, r0:r1] = torch.matmul(ds, kx) * scale
        dkx += torch.matmul(ds.transpose(-1, -2), qf[:, :, r0:r1])
    dk = (dkx * scale).view(B, Kh, G, S, D).sum(dim=2)
    dv = dvx.view(B, Kh, G, S, D).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
