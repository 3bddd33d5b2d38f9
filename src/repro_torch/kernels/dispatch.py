"""Kernel dispatch: routes the mlalgos' inner loops to the CUDA kernels.

Port of ``repro.kernels.dispatch``:

  ====================  ===================  ============================
  dispatch fn           kernel               used by
  ====================  ===================  ============================
  ``hybrid_matmul``     ``fxp_matmul``       linreg/logreg/svm/
                                             multinomial int8/int16
                                             forward and gradient dots
                                             (a launch per 16 columns
                                             of b: one for every
                                             workload)
  ``lut_apply``         ``lut_activation``   logreg LUT sigmoid,
                                             multinomial LUT exp
  ``kmeans_partials``   ``kmeans_assign``    kmeans Lloyd iteration
  ``level_histogram``   ``split_hist``       dtree level statistics
  ``flash_attention``   ``flash_attention``  LM self-attention, causal
                                             (decoders) or full (an
                                             encoder;
                                             ``models.attention.attn_full``)
  ``nearest_centroid``  — (matmul + argmin)  kmeans eval / predict
  ====================  ===================  ============================

When autograd records (LM training), ``flash_attention`` goes through
:class:`FlashAttention`, whose backward launches ``flash_attention_bwd``.

``use_kernels(False)`` routes each to its plain PyTorch function
(``quantize.hybrid_dot``, ``lut.lut_lookup``, ``ref.kmeans_assign_ref``,
``ref.split_hist_ref``, ``ref.flash_attention_ref`` and
``ref.flash_attention_bwd_ref``); parity tests and ``chip_smoke.py`` use
it.  With kernels on, each wrapper launches its kernel on a CUDA tensor and
runs its plain version on a CPU tensor.

Launch layouts are not constants: ``hybrid_matmul``, ``kmeans_partials``
and ``level_histogram`` ask ``tuning.autotune.block_shapes`` for theirs
at every call, keyed on ``(kernel, dtype, shape bucket, device)``, as
JAX's dispatch asks for its block shapes.  A measured entry of the
on-disk table wins; otherwise the heuristic, which on the card is the
layout the kernels had before they were tuned.  The lookup is pure
Python (no launch, no sync).  ``PimGrid.make_runner``'s CUDA graphs
keep the launch arguments of their capture, as JAX's jit keeps its
trace: a table changed after a capture serves only runners built
afterwards (``api.fit`` binds, and captures, anew each call).

Example — the kernel path equals the plain path on an integer product:

>>> import torch
>>> from repro_torch.kernels import dispatch
>>> a = torch.ones((4, 8), dtype=torch.int8)
>>> b = torch.ones((8, 2), dtype=torch.int16)
>>> out = dispatch.hybrid_matmul(a, b)
>>> with dispatch.use_kernels(False):
...     ref = dispatch.hybrid_matmul(a, b)
>>> out.dtype, bool(torch.equal(out, ref))
(torch.float32, True)
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.core import lut as lut_mod
from repro_torch.core import quantize as qz
from repro_torch.distributed import sharding
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fxp_matmul as _fxp
from repro_torch.kernels import kmeans_assign as _km
from repro_torch.kernels import lut_activation as _lut
from repro_torch.kernels import ref
from repro_torch.kernels import split_hist as _sh
from repro_torch.tuning import autotune as _at

_ENABLED = [True]


def kernels_enabled() -> bool:
    """True when dispatch routes to the kernel wrappers."""
    return _ENABLED[0]


@contextlib.contextmanager
def use_kernels(enabled: bool):
    """Temporarily route dispatch to the kernels (True) or to the plain
    PyTorch functions (False)."""
    prev = _ENABLED[0]
    _ENABLED[0] = enabled
    try:
        yield
    finally:
        _ENABLED[0] = prev


def hybrid_launches(n_cols: int, block_n: int = _fxp.MAX_N) -> int:
    """``fxp_matmul`` launches of one :func:`hybrid_matmul` with an
    ``n_cols``-column ``b``: one per ``block_n`` columns (``MAX_N`` = 16
    but where a tuned table says 8), whatever the types of ``a`` and
    ``b`` (the kernel splits both into limbs itself).

    >>> hybrid_launches(10), hybrid_launches(16), hybrid_launches(20)
    (1, 1, 2)
    >>> hybrid_launches(10, block_n=8)
    2
    """
    return -(-n_cols // block_n)


def fxp_shape(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """``fxp_matmul``'s key shape ``(L, M, K, N)`` of ``a`` ``(M, K)``
    or ``(L, M, K)`` by ``b``'s N columns."""
    return ((a.shape[0] if a.dim() == 3 else 1), *a.shape[-2:],
            b.shape[-1])


def hybrid_matmul(a: torch.Tensor, b: torch.Tensor, *,
                  k_chunk: int = 4096) -> torch.Tensor:
    """Drop-in for ``quantize.hybrid_dot``: ``(..., M, K)`` int8/int16 x
    ``(..., K, N)`` int8/int16 -> float32 ``(..., M, N)``, for any N.

    Each group of ``block_n`` (16, or 8 where a tuned table says so)
    columns of ``b`` is one ``fxp_matmul`` launch
    (:func:`hybrid_launches`) with the table's ``block_m``; the kernel
    splits both operands into limbs, sums each (limb pair, K-chunk)
    partial in int32 and combines them in float32 in ``hybrid_dot``'s
    order.  An output column's float operations are its own, so neither
    the grouping nor the blocks change a bit of ``hybrid_dot``'s result.
    """
    if not kernels_enabled():
        return qz.hybrid_dot(a, b, k_chunk=k_chunk)
    blocks = _at.block_shapes("fxp_matmul", a.dtype, fxp_shape(a, b),
                              device=a.device)
    return _fxp.grouped(a, b, k_chunk=k_chunk, **blocks)


def lut_apply(table: lut_mod.LutTable, x: torch.Tensor) -> torch.Tensor:
    """Nearest-entry LUT evaluation of a float32 ``x`` (any shape)."""
    if kernels_enabled():
        return _lut.lut_activation(x, table.table, x_min=table.x_min,
                                   x_max=table.x_max)
    return lut_mod.lut_lookup(table, x)


def kmeans_partials(x: torch.Tensor, centroids: torch.Tensor,
                    w: torch.Tensor, x_scale: torch.Tensor | None = None):
    """Per-lane K-means partials: ``x`` ``(L, R, D)`` resident rows
    (float32, or int16/int8 dequantized by ``x_scale`` inside the
    kernel), ``centroids`` ``(K, D)`` or ``(L, K, D)``, ``w`` ``(L, R)``
    0/1 row mask -> ``sums (L, K, D)``, ``counts (L, K)``, ``sse (L,)``;
    padding rows contribute nothing.

    >>> import torch
    >>> from repro_torch.kernels import dispatch
    >>> x = torch.tensor([[[0.0, 0.0], [4.0, 4.0], [9.9, 9.9]]])
    >>> c = torch.tensor([[0.0, 0.0], [4.0, 4.0]])
    >>> w = torch.tensor([[1.0, 1.0, 0.0]])      # third row is padding
    >>> sums, counts, sse = dispatch.kmeans_partials(x, c, w)
    >>> counts.tolist(), sse.tolist()
    ([[1.0, 1.0]], [0.0])
    """
    if kernels_enabled():
        L, R, D = x.shape
        blocks = _at.block_shapes("kmeans_assign", x.dtype,
                                  (L, R, D, centroids.shape[-2]),
                                  device=x.device)
        return _km.kmeans_assign(x, centroids, w, x_scale, **blocks)
    return ref.kmeans_assign_ref(x, centroids, w, x_scale)


def nearest_centroid(x: torch.Tensor, centroids: torch.Tensor
                     ) -> torch.Tensor:
    """Per-row nearest centroid of float32 ``x`` ``(N, D)``: the serving
    companion of :func:`kmeans_partials`, which never exposes its argmin.
    As in the JAX package it has no kernel: one Gram matmul (full
    float32) and an argmin of ``|c|² − 2·x·cᵀ``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    c2 = (centroids * centroids).sum(dim=1)
    return torch.argmin(c2[None, :] - 2.0 * (x @ centroids.T), dim=1)


def level_histogram(node_idx: torch.Tensor, xbin: torch.Tensor,
                    y: torch.Tensor, w: torch.Tensor, *, n_nodes: int,
                    n_bins: int, n_classes: int) -> torch.Tensor:
    """Per-lane ``H[lane, node, feature, bin, class]`` weighted counts
    for one tree level (``map_reduce`` sums the lanes)."""
    if kernels_enabled():
        blocks = _at.block_shapes(
            "split_hist", xbin.dtype,
            (*xbin.shape, n_nodes * n_bins * n_classes), device=xbin.device,
            n_nodes=n_nodes)
        return _sh.split_hist(node_idx, xbin, y, w, n_nodes=n_nodes,
                              n_bins=n_bins, n_classes=n_classes, **blocks)
    return ref.split_hist_ref(node_idx, xbin, y, w, n_nodes=n_nodes,
                              n_bins=n_bins, n_classes=n_classes)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Self-attention of the model's ``q`` ``(B, S, H, D)`` and ``k``/``v``
    ``(B, S, Kh, D)`` -> ``(B, S, H, D)``: the kernel reads them as
    ``(B, H, S, D)`` views, by strides, with no copy.  When autograd
    records (grad mode on and any of q, k, v requiring grad) the call goes
    through :class:`FlashAttention`, whose backward is the
    ``flash_attention_bwd`` kernel; otherwise it is the forward alone.

    ``DTensor`` inputs (a sharded model under ``distributed.sharding``'s
    rules) run each rank's heads through ``local_map``
    (``distributed.sharding.map_heads``): the kernel only ever sees local
    tensors."""
    if sharding.is_dtensor(q):
        return sharding.map_heads(
            lambda ql, kl, vl: flash_attention(ql, kl, vl, causal=causal),
            q, k, v)
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        out = FlashAttention.apply(*args, causal)
    elif kernels_enabled():
        out = _fa.flash_attention(*args, causal=causal)
    else:
        out = ref.flash_attention_ref(*args, causal=causal)
    return out.transpose(1, 2)


class FlashAttention(torch.autograd.Function):
    """Attention with its gradient: the forward saves q, k, v, its output
    and the row log-sum-exp; the backward runs ``flash_attention_bwd`` (on
    the card the kernel, on the CPU its plain version) or, under
    ``use_kernels(False)``, ``ref.flash_attention_bwd_ref``.  Inputs and
    gradients are ``(B, H, S, D)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        if kernels_enabled():
            o, lse = _fa.flash_attention(q, k, v, causal=causal,
                                         return_lse=True)
        else:
            o, lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                             return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.kernels = kernels_enabled()
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # autograd hands dO over in any layout; the kernel takes unit
        # stride along D and 16-byte aligned rows, which the model's
        # (B, S, H, D) layout has: copy into it (no copy when it is so)
        do = do.transpose(1, 2).contiguous().transpose(1, 2)
        bwd = (_fa.flash_attention_bwd if ctx.kernels
               else ref.flash_attention_bwd_ref)
        dq, dk, dv = bwd(q, k, v, o, do, lse, causal=ctx.causal)
        return dq, dk, dv, None
