"""Public entry points of the five kernels, at the JAX package's
signatures and returns (port of ``repro.kernels.ops``).

Each takes the JAX function's shapes (no lane axis), runs its kernel on
a CUDA tensor and its plain version on a CPU tensor, and, where JAX's
asks ``tuning.autotune.block_shapes`` for its blocks, asks for the
port's (``fxp_matmul``, ``kmeans_assign``, ``split_hist``; a one-lane
key).  The mlalgos go through ``kernels.dispatch``, which takes their
lanes; these are for a user who calls one kernel.

>>> import torch
>>> from repro_torch.kernels import ops
>>> a = torch.full((4, 8), 100, dtype=torch.int8)
>>> ops.fxp_matmul(a, torch.full((8, 3), -100, dtype=torch.int8))[0]
tensor([-80000, -80000, -80000], dtype=torch.int32)
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fxp_matmul as _fxp
from repro_torch.kernels import kmeans_assign as _km
from repro_torch.kernels import lut_activation as _lut
from repro_torch.kernels import split_hist as _sh
from repro_torch.tuning import autotune as _at


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """``q`` ``(B, H, S, D)``, ``k``/``v`` ``(B, Kh, S, D)``, ``H % Kh ==
    0`` -> ``(B, H, S, D)`` in ``q``'s dtype, p in float32.  It takes no
    ``block_q``/``block_k``: the kernel's route (``kernels.
    flash_attention.route``: ``wgmma`` at bf16 D = 64/128, ``mma.sync``
    at D = 32, the CUDA cores in float32) fixes its tiles, and any S
    works."""
    return _fa.flash_attention(q, k, v, causal=causal)


def lut_activation(x: torch.Tensor, table: torch.Tensor, *, x_min: float,
                   x_max: float) -> torch.Tensor:
    """Nearest-entry lookup of float32 ``x`` (any shape) in ``table``
    spanning ``[x_min, x_max]``."""
    return _lut.lut_activation(x.contiguous(), table, x_min=x_min,
                               x_max=x_max)


def fxp_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 ``a`` ``(M, K)`` x int8 ``b`` ``(K, N)`` -> int32 ``(M, N)``,
    for any N: the int32 sums themselves, as JAX's kernel returns them
    (exact wherever an int32 accumulator is; it wraps where that
    does).  A launch for each ``block_n`` columns."""
    blocks = _at.block_shapes("fxp_matmul", a.dtype,
                              (1, *a.shape, b.shape[-1]), device=a.device)
    return _fxp.grouped(a, b, out_dtype=torch.int32, **blocks)


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor,
                  w: torch.Tensor | None = None):
    """``x`` ``(N, D)`` float32, ``centroids`` ``(K, D)``, ``w`` optional
    ``(N,)`` row weights (ones) -> ``(sums (K, D), counts (K,), sse
    ())``."""
    N, D = x.shape
    if w is None:
        w = torch.ones((N,), dtype=torch.float32, device=x.device)
    blocks = _at.block_shapes("kmeans_assign", x.dtype,
                              (1, N, D, centroids.shape[0]),
                              device=x.device)
    sums, counts, sse = _km.kmeans_assign(x[None], centroids, w[None],
                                          **blocks)
    return sums[0], counts[0], sse[0]


def split_hist(node_idx: torch.Tensor, xbin: torch.Tensor, y: torch.Tensor,
               w: torch.Tensor | None = None, *, n_nodes: int, n_bins: int,
               n_classes: int) -> torch.Tensor:
    """``node_idx`` ``(N,)``, ``xbin`` ``(N, F)``, ``y`` ``(N,)``
    (int32; ``xbin`` also int16 or uint8), ``w`` optional ``(N,)`` row
    weights (ones) -> ``H`` ``(n_nodes, F, n_bins, n_classes)``
    float32."""
    N, F = xbin.shape
    if w is None:
        w = torch.ones((N,), dtype=torch.float32, device=xbin.device)
    blocks = _at.block_shapes("split_hist", xbin.dtype,
                              (1, N, F, n_nodes * n_bins * n_classes),
                              device=xbin.device, n_nodes=n_nodes)
    return _sh.split_hist(node_idx[None], xbin[None], y[None], w[None],
                          n_nodes=n_nodes, n_bins=n_bins,
                          n_classes=n_classes, **blocks)[0]
