"""Wrapper of the ``fxp_matmul`` CUDA kernel (``csrc/fxp_matmul.cu``).

Port of ``repro/kernels/fxp_matmul.py::fxp_matmul`` together with the
limb split and float combination that ``repro/kernels/dispatch.py::
hybrid_matmul`` runs around it: one launch returns the float32 dot of up
to ``MAX_N`` columns of ``b``, bit-equal to ``quantize.hybrid_dot``.  A
CPU tensor runs the plain version (:func:`repro_torch.kernels.ref.
fxp_matmul_ref`); a CUDA tensor launches the kernel or raises.  The
launch layout is a keyword: ``block_m``, the rows a block of the rows
route takes (whole row groups of :func:`group_rows`), and ``block_n``,
the columns of ``b`` a launch may take; ``tuning.autotune.block_shapes``
chooses them for ``dispatch.hybrid_matmul`` and ``ops.fxp_matmul``, and
the defaults are the layout the kernel had before it was tuned.
``fxp_matmul.launches`` counts the launches; each launch also charges
its bytes and operations to an active ``roofline.analysis.RoundCounter``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.roofline import analysis

MAX_N = 16                     # columns of b one launch takes
BLOCK_NS = (8, MAX_N)          # block_n: one or two n8 blocks a launch
ROW_WARPS = 8                  # rows kernel: warps a block (kRowWarps)
ROW_GROUPS = 8                 # row groups a rows block walks, by default
_DTYPES = (torch.int8, torch.int16)
_ROW_TILES = {torch.int8: 2, torch.int16: 1}   # m16 tiles a warp, rows
_SIGNATURES = {
    "fxp_matmul_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        *[ctypes.c_longlong] * 8, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    "fxp_matmul_blocks": (ctypes.c_int, [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int]),
    "fxp_matmul_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def group_rows(a_dtype: torch.dtype) -> int:
    """Rows of one row group of the rows route: ``ROW_WARPS`` warps of
    16·MT rows (MT = 2 m16 tiles a warp for int8 ``a``, 1 for int16), so
    256 for int8 and 128 for int16.  ``block_m`` is a whole number of
    them.

    >>> group_rows(torch.int8), group_rows(torch.int16)
    (256, 128)
    """
    return ROW_WARPS * 16 * _ROW_TILES[a_dtype]


def default_block_m(a_dtype: torch.dtype) -> int:
    """The rows route's block before tuning: ``ROW_GROUPS`` groups."""
    return ROW_GROUPS * group_rows(a_dtype)


def _check(a: torch.Tensor, b: torch.Tensor, k_chunk: int,
           block_m: int | None = None, block_n: int = MAX_N,
           out_dtype: torch.dtype = torch.float32):
    if a.dtype not in _DTYPES or b.dtype not in _DTYPES:
        raise TypeError(f"fxp_matmul takes int8 or int16 a and b, got "
                        f"{a.dtype} and {b.dtype}")
    if a.dim() not in (2, 3) or b.dim() not in (2, 3) or b.dim() > a.dim():
        raise ValueError(f"need a (M, K) or (L, M, K) and b (K, N) or "
                         f"(L, K, N); got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if b.dim() == 3 and b.shape[0] not in (1, a.shape[0]):
        raise ValueError(f"b has {b.shape[0]} lanes, a has {a.shape[0]}")
    if a.shape[-1] != b.shape[-2] or a.shape[-1] < 1:
        raise ValueError(f"K mismatch or empty: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    if block_n not in BLOCK_NS:
        raise ValueError(f"block_n must be one of {BLOCK_NS}, got {block_n}")
    if not 1 <= b.shape[-1] <= block_n:
        raise ValueError(f"b must have 1..{block_n} columns, got "
                         f"{b.shape[-1]}")
    if block_m is not None and (block_m < 1
                                or block_m % group_rows(a.dtype)):
        raise ValueError(f"block_m must be a positive multiple of "
                         f"{group_rows(a.dtype)} rows for {a.dtype} a, got "
                         f"{block_m}")
    if out_dtype not in (torch.float32, torch.int32):
        raise TypeError(f"out_dtype must be float32 or int32, got "
                        f"{out_dtype}")
    if out_dtype == torch.int32 and (a.dtype, b.dtype) != (torch.int8,
                                                           torch.int8):
        raise TypeError(f"an int32 output takes int8 a and b, got "
                        f"{a.dtype} and {b.dtype}")
    if k_chunk < 1:
        raise ValueError(f"k_chunk must be >= 1, got {k_chunk}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if a.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"fxp_matmul runs on CPU or CUDA, got {a.device}")


def layout(a: torch.Tensor, k_chunk: int = 4096) -> tuple:
    """How the kernel reads ``a`` (``(M, K)`` or ``(L, M, K)``):
    ``(cols, vec)``.  ``cols``: along m (``a`` contiguous along m, the
    gradient's transposed view), else along k.  ``vec``: in whole pieces
    (16 bytes along k, 8 along m), which needs those pieces aligned; else
    element by element."""
    a3 = a if a.dim() == 3 else a.unsqueeze(0)
    L, M, K = a3.shape
    sAl, sAm, sAk = a3.stride()
    esz = a.element_size()
    cols = sAm == 1 and sAk != 1 and M > 1
    # a piece starts at a lane, a row (rows) or a k (cols), and a chunk
    piece = 8 if cols else 16
    starts = [a3.data_ptr(), (L > 1) * sAl * esz,
              sAk * esz if cols else (M > 1) * sAm * esz,
              0 if cols else min(k_chunk, K) * esz]
    vec = (cols or sAk == 1) and all(s % piece == 0 for s in starts)
    return cols, vec


def route(a: torch.Tensor, k_chunk: int = 4096) -> str:
    """The kernel and load mode ``a`` takes: ``rows`` or ``cols``, then
    ``16B``/``8B`` (whole pieces) or ``elements``."""
    cols, vec = layout(a, k_chunk)
    return (("cols/8B" if vec else "cols/elements") if cols
            else ("rows/16B" if vec else "rows/elements"))


def fxp_matmul(a: torch.Tensor, b: torch.Tensor, *, k_chunk: int = 4096,
               block_m: int | None = None, block_n: int = MAX_N,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``quantize.hybrid_dot(a, b, k_chunk=k_chunk)`` in one launch.

    ``a``: ``(M, K)`` or ``(L, M, K)``, int8 or int16, any strides (a
    transposed view costs no copy).  ``b``: ``(K, N)`` (shared by every
    lane) or ``(L, K, N)``, int8 or int16, ``N <= block_n``, any strides.
    Both split into int8-range limbs inside the kernel; every (limb pair,
    K-chunk) partial is an exact int32, and they combine in float32 in
    ``hybrid_dot``'s order.  Returns float32 ``(..., M, N)``; with
    ``out_dtype=torch.int32`` (int8 ``a`` and ``b``) the int32 product
    itself, the chunks added in int32 with two's-complement wrap.

    ``block_m`` (rows route only; the gradient's ``cols`` route has one
    block layout): rows a block takes, a multiple of
    :func:`group_rows`; None is :func:`default_block_m`.  ``block_n``
    (8 or 16) caps ``b``'s columns.  No layout changes a bit of the
    output.
    """
    _check(a, b, k_chunk, block_m, block_n, out_dtype)
    traced = build.traced(a, b)
    if a.device.type == "cpu" and not traced:
        if out_dtype == torch.int32:
            return ref.fxp_matmul_int32_ref(a, b)
        return ref.fxp_matmul_ref(a, b, k_chunk=k_chunk)

    if traced:                           # the kernel's output, unlaunched
        out = torch.empty((*a.shape[:-1], b.shape[-1]), dtype=out_dtype,
                          device=a.device)
    else:
        groups = (ROW_GROUPS if block_m is None
                  else block_m // group_rows(a.dtype))
        out = _launch(build.load("fxp_matmul", _SIGNATURES), a, b, k_chunk,
                      groups=groups, out_dtype=out_dtype)
    if a.numel():                        # a launch ran (K >= 1)
        if not traced:
            fxp_matmul.launches += 1
        # a multiply-add of every limb pair
        analysis.charge(analysis.nbytes(a, b, out),
                        2 * a.numel() * b.shape[-1] * a.element_size()
                        * b.element_size(), "int8")
    return out


def grouped(a: torch.Tensor, b: torch.Tensor, *, k_chunk: int = 4096,
            block_m: int | None = None, block_n: int = MAX_N,
            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """:func:`fxp_matmul` of ``b`` with any number of columns: a launch
    for each group of ``block_n`` columns, the outputs concatenated.  An
    output column's operations are its own, so the grouping changes no
    bit."""
    outs = [fxp_matmul(a, b[..., j:j + block_n], k_chunk=k_chunk,
                       block_m=block_m, block_n=block_n, out_dtype=out_dtype)
            for j in range(0, b.shape[-1], block_n)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


def _launch(lib, a: torch.Tensor, b: torch.Tensor, k_chunk: int, *,
            groups: int = ROW_GROUPS,
            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One launch of ``lib``, a build of ``csrc/fxp_matmul.cu``, on CUDA
    tensors that passed the wrapper's checks, the rows route's blocks
    walking ``groups`` row groups.  Counts nothing:
    :func:`fxp_matmul` counts its own calls, and ``tools/kernel_ab.py``
    times other versions of the source with it."""
    a3 = a if a.dim() == 3 else a.unsqueeze(0)
    b3 = b if b.dim() == 3 else b.unsqueeze(0)
    L, M, K = a3.shape
    N = b3.shape[-1]
    kc = min(k_chunk, K)
    n_chunks = -(-K // kc)
    if L > 65535 or n_chunks > 65535:
        raise ValueError(f"at most 65535 lanes and chunks, got {L} lanes, "
                         f"{n_chunks} chunks")
    out = torch.empty((L, M, N), dtype=out_dtype, device=a.device)
    if M and L:
        cols, vec = layout(a3, kc)
        scratch = counters = None
        if n_chunks > 1:
            pairs = a.element_size() * b.element_size()
            scratch = torch.empty((L, n_chunks, pairs, M, N),
                                  dtype=torch.int32, device=a.device)
            counters = torch.zeros(
                (L, lib.fxp_matmul_blocks(M, a.element_size(), int(cols),
                                          groups)),
                dtype=torch.int32, device=a.device)
        sBl = b3.stride(0) if b3.shape[0] > 1 else 0
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.fxp_matmul_launch(
                a3.data_ptr(), a.element_size(), b3.data_ptr(),
                b.element_size(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                None if counters is None else counters.data_ptr(),
                L, M, K, N, kc, *a3.stride(), sBl, *b3.stride()[1:],
                *out.stride()[:2], int(cols), int(vec), groups,
                int(out_dtype == torch.int32), stream)
        build.check(lib, "fxp_matmul", err)
    return out if a.dim() == 3 else out[0]


fxp_matmul.launches = 0
