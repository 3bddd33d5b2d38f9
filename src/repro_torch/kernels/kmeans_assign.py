"""Wrapper of the ``kmeans_assign`` CUDA kernel (``csrc/kmeans_assign.cu``).

Port of ``repro/kernels/kmeans_assign.py::kmeans_assign`` as
``KMeans.local_step`` drives it: one launch computes every lane's
K-means partials (sums, counts, sse) straight from the resident rows,
dequantizing int16/int8 rows in registers.  A CPU tensor runs the plain
version (:func:`repro_torch.kernels.ref.kmeans_assign_ref`); a CUDA
tensor launches the kernel or raises.  ``kmeans_assign.launches`` counts
the launches; each launch also charges its bytes and operations to an
active ``roofline.analysis.RoundCounter``.  ``block_n``, the rows a block
takes, is a keyword (``tuning.autotune.block_shapes`` chooses it for
``dispatch.kmeans_partials`` and ``ops.kmeans_assign``); its default is
:func:`default_block_n`, the layout before tuning.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.roofline import analysis

MAX_SMEM_BYTES = 227 * 1024    # what a block may take on Hopper
TARGET_SMEM_BYTES = 57344      # four blocks of an SM's 228 KB, 1 KB each kept
THREADS = 256                  # most threads a block
WARP_ROWS = 32                 # rows a warp takes at a time
BLOCKS_PER_SM = 32             # a few waves: the last leaves few SMs idle
_X_DTYPES = {torch.float32: 0, torch.int16: 1, torch.int8: 2}
_SIGNATURES = {
    "kmeans_assign_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]),
    "kmeans_assign_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


@functools.lru_cache(maxsize=None)
def layout(K: int, D: int) -> dict:
    """A block's layout at ``(K, D)`` (mirrors ``layout`` in the source):
    its warps, each warp's statistics groups, the rows a block takes a
    round (``tile``), the float32 words of its partial statistics
    (``cells``) and its bytes of dynamic shared memory (``smem``): per
    warp its staged rows, its groups' partials, its own partial, weights
    and assignments; then the centroids, scales and ``|c|²``."""
    dq = -(-D // 4)
    q = dq + 1
    max_d = 8 if D <= 8 else 16 if D <= 16 else 32 if D <= 32 else 0
    cstride = max_d if max_d else 4 * dq
    kq = K * q
    fixed = (K + 1) * cstride + (K + 3) // 4 * 4
    per_warp = 4 * (WARP_ROWS * (q | 1) + kq) + 2 * WARP_ROWS
    per_group = 4 * (kq + 1)
    warps = THREADS // 32
    while warps > 1 and fixed + warps * (per_warp + per_group) \
            > MAX_SMEM_BYTES // 4:
        warps //= 2
    groups = (TARGET_SMEM_BYTES // 4 - fixed - warps * per_warp) \
        // (warps * per_group)
    groups = max(1, min(groups, WARP_ROWS // min(q, WARP_ROWS)))
    return {"warps": warps, "groups": groups, "tile": WARP_ROWS * warps,
            "cells": 4 * kq,
            "smem": 4 * (fixed + warps * (per_warp + groups * per_group))}


def smem_bytes(K: int, D: int) -> int:
    """Shared memory of one block at ``(K, D)``."""
    return layout(K, D)["smem"]


def max_blocks(L: int, R: int, K: int, D: int, sms: int) -> int:
    """Blocks a lane may take: about ``BLOCKS_PER_SM`` blocks an SM over
    all lanes, and no more than its tiles."""
    return max(1, min(-(-R // layout(K, D)["tile"]),
                      -(-BLOCKS_PER_SM * sms // L)))


def block_rows(R: int, K: int, D: int, blocks: int) -> int:
    """Rows a block takes when a lane may take ``blocks`` blocks: an even
    share rounded up to the tile (the source's ``rows``)."""
    tile = layout(K, D)["tile"]
    return -(-(-(-R // blocks)) // tile) * tile


def default_block_n(L: int, R: int, K: int, D: int, sms: int) -> int:
    """``block_n`` before tuning: the rows of :func:`max_blocks`'s
    blocks."""
    return block_rows(R, K, D, max_blocks(L, R, K, D, sms))


def grid_blocks(R: int, K: int, D: int, block_n: int) -> tuple:
    """``(rows, blocks)`` a lane launches at ``block_n``: ``block_n``
    rounded up to the tile, then the source's own rounding of the
    ``ceil(R / block_n)`` blocks it is given (which may take fewer rows
    a block, never more blocks).

    >>> grid_blocks(65536, 8, 16, 4096), grid_blocks(1000, 8, 16, 1)
    ((4096, 16), (256, 4))
    """
    tile = layout(K, D)["tile"]
    rows = block_rows(R, K, D, -(-R // (-(-block_n // tile) * tile)))
    return rows, -(-R // rows)


def _check(x, centroids, w, x_scale):
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"x must be float32, int16 or int8, got {x.dtype}")
    if centroids.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"centroids and w must be float32, got "
                        f"{centroids.dtype}, {w.dtype}")
    if x.dim() != 3 or w.shape != x.shape[:2]:
        raise ValueError(f"need x (L, R, D) and w (L, R); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    L, _, D = x.shape
    if centroids.dim() not in (2, 3) or centroids.shape[-1] != D or (
            centroids.dim() == 3 and centroids.shape[0] != L):
        raise ValueError(f"centroids must be (K, {D}) or ({L}, K, {D}), got "
                         f"{tuple(centroids.shape)}")
    if centroids.shape[-2] < 1 or D < 1 or x.shape[1] < 1:
        raise ValueError("need K, R and D >= 1")
    if x_scale is not None:
        if x_scale.dtype != torch.float32 or x_scale.numel() != D:
            raise ValueError(f"x_scale must be float32 with {D} entries, got "
                             f"{x_scale.dtype} {tuple(x_scale.shape)}")
        if x.dtype == torch.float32:
            raise ValueError("x_scale dequantizes int rows; x is float32")
    tensors = [x, centroids, w] + ([x_scale] if x_scale is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, centroids, w and x_scale must share a device")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"kmeans_assign runs on CPU or CUDA, got {x.device}")


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor, w: torch.Tensor,
                  x_scale: torch.Tensor | None = None, *,
                  return_assign: bool = False, block_n: int | None = None):
    """Per-lane K-means partials of the rows ``x`` against ``centroids``.

    ``x``: ``(L, R, D)`` float32, or int16/int8 with ``x_scale`` (``D``
    float32 per-feature scales: a row is ``x.float() * x_scale``); unit
    stride along ``D``, any lane and row strides.  ``centroids``: float32
    ``(K, D)`` shared by every lane or ``(L, K, D)`` per lane (an expanded
    view costs no copy).  ``w``: float32 ``(L, R)`` row weights.  Returns
    ``sums (L, K, D)``, ``counts (L, K)``, ``sse (L,)`` =
    Σ w·|x − c_a|², and with ``return_assign`` the int32 nearest centroid of every row
    ``(L, R)`` (first index on ties).

    ``block_n``: the rows a block takes (:func:`grid_blocks`; None is
    :func:`default_block_n`).  The blocks' partials are added in block
    order, so the sums' and sse's float order moves with it (within
    1e-5 of their mass); the assignments and 0/1 counts do not.
    """
    _check(x, centroids, w, x_scale)
    if block_n is not None and block_n < 1:
        raise ValueError(f"block_n must be >= 1, got {block_n}")
    traced = build.traced(x, centroids, w, x_scale)
    if x.device.type == "cpu" and not traced:
        return ref.kmeans_assign_ref(x, centroids, w, x_scale,
                                     return_assign=return_assign)
    if x.stride(-1) != 1:
        raise ValueError("x must have unit stride along D")
    L, R, D = x.shape
    K = centroids.shape[-2]
    if L > 65535:
        raise ValueError(f"at most 65535 lanes, got {L}")
    smem = smem_bytes(K, D)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"K={K} x D={D} needs {smem} B of shared memory "
                         f"per block, above the {MAX_SMEM_BYTES} B limit")
    if traced:                           # the kernel's outputs, unlaunched
        f32 = dict(dtype=torch.float32, device=x.device)
        out = (torch.empty((L, K, D), **f32), torch.empty((L, K), **f32),
               torch.empty((L,), **f32))
        if return_assign:
            out += (torch.empty((L, R), dtype=torch.int32,
                                device=x.device),)
    else:
        out = _launch(build.load("kmeans_assign", _SIGNATURES), x,
                      centroids, w, x_scale, return_assign, block_n)
        kmeans_assign.launches += 1
    # a row's K distances of 2D + 2 operations, |x|^2, the dequantize and
    # the accumulation
    scale = [] if x_scale is None else [x_scale]
    analysis.charge(analysis.nbytes(x, centroids, w, *scale, *out),
                    L * R * (2 * K * D + 2 * K + 5 * D + 2), "fp32")
    return out


def _launch(lib, x, centroids, w, x_scale, return_assign: bool,
            block_n: int | None = None):
    """One launch of ``lib``, a build of ``csrc/kmeans_assign.cu``, on
    tensors that passed the wrapper's checks, its blocks taking
    ``block_n`` rows (None: :func:`default_block_n`).  Counts nothing:
    :func:`kmeans_assign` counts its own calls, and ``tools/kernel_ab.py``
    times other versions of the source with it (the scratch is sized for
    this one, which needs more than the parent's)."""
    L, R, D = x.shape
    K = centroids.shape[-2]
    if centroids.dim() == 3 and centroids.stride(0) == 0:
        centroids = centroids[0]                 # an expanded shared copy
    c = centroids.contiguous()
    c_lane = K * D if c.dim() == 3 else 0
    dev = x.device
    sums = torch.empty((L, K, D), dtype=torch.float32, device=dev)
    counts = torch.empty((L, K), dtype=torch.float32, device=dev)
    sse = torch.empty((L,), dtype=torch.float32, device=dev)
    assign = (torch.empty((L, R), dtype=torch.int32, device=dev)
              if return_assign else None)
    if block_n is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        block_n = default_block_n(L, R, K, D, sms)
    # the blocks the source launches, after its rounding: it takes
    # ceil(R / rows) of them and lays their partials out at that stride
    _, blocks = grid_blocks(R, K, D, block_n)
    part = torch.empty((L, blocks, layout(K, D)["cells"]),
                       dtype=torch.float32, device=dev)
    scale = (x_scale.reshape(-1).contiguous() if x_scale is not None
             else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.kmeans_assign_launch(
            x.data_ptr(), _X_DTYPES[x.dtype], x.stride(0), x.stride(1),
            c.data_ptr(), c_lane, w.data_ptr(), w.stride(0), w.stride(1),
            scale.data_ptr() if scale is not None else None, L, R, D, K,
            blocks, part.data_ptr(), sums.data_ptr(), counts.data_ptr(),
            sse.data_ptr(), assign.data_ptr() if return_assign else None,
            R, stream)
    build.check(lib, "kmeans_assign", err)
    return (sums, counts, sse) + ((assign,) if return_assign else ())


kmeans_assign.launches = 0
