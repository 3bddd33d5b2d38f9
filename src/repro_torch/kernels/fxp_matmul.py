"""Wrapper of the ``fxp_matmul`` CUDA kernel (``csrc/fxp_matmul.cu``).

Port of ``repro/kernels/fxp_matmul.py::fxp_matmul`` together with the
limb split and float combination that ``repro/kernels/dispatch.py::
hybrid_matmul`` runs around it: one launch returns the float32 dot of up
to ``MAX_N`` columns of ``b``, bit-equal to ``quantize.hybrid_dot``.  A
CPU tensor runs the plain version (:func:`repro_torch.kernels.ref.
fxp_matmul_ref`); a CUDA tensor launches the kernel or raises.
``fxp_matmul.launches`` counts the launches; each launch also charges
its bytes and operations to an active ``roofline.analysis.RoundCounter``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.roofline import analysis

MAX_N = 16                     # columns of b one launch takes
_DTYPES = (torch.int8, torch.int16)
_SIGNATURES = {
    "fxp_matmul_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        *[ctypes.c_longlong] * 8, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]),
    "fxp_matmul_blocks": (ctypes.c_int, [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int]),
    "fxp_matmul_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _check(a: torch.Tensor, b: torch.Tensor, k_chunk: int):
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
    if not 1 <= b.shape[-1] <= MAX_N:
        raise ValueError(f"b must have 1..{MAX_N} columns, got "
                         f"{b.shape[-1]}")
    if k_chunk < 1:
        raise ValueError(f"k_chunk must be >= 1, got {k_chunk}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if a.device.type not in ("cpu", "cuda"):
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


def fxp_matmul(a: torch.Tensor, b: torch.Tensor, *,
               k_chunk: int = 4096) -> torch.Tensor:
    """``quantize.hybrid_dot(a, b, k_chunk=k_chunk)`` in one launch.

    ``a``: ``(M, K)`` or ``(L, M, K)``, int8 or int16, any strides (a
    transposed view costs no copy).  ``b``: ``(K, N)`` (shared by every
    lane) or ``(L, K, N)``, int8 or int16, ``N <= MAX_N``, any strides.
    Both split into int8-range limbs inside the kernel; every (limb pair,
    K-chunk) partial is an exact int32, and they combine in float32 in
    ``hybrid_dot``'s order.  Returns float32 ``(..., M, N)``.
    """
    _check(a, b, k_chunk)
    if a.device.type == "cpu":
        return ref.fxp_matmul_ref(a, b, k_chunk=k_chunk)

    out = _launch(build.load("fxp_matmul", _SIGNATURES), a, b, k_chunk)
    if a.numel():                        # a launch ran (K >= 1)
        fxp_matmul.launches += 1
        # a multiply-add of every limb pair
        analysis.charge(analysis.nbytes(a, b, out),
                        2 * a.numel() * b.shape[-1] * a.element_size()
                        * b.element_size(), "int8")
    return out


def _launch(lib, a: torch.Tensor, b: torch.Tensor,
            k_chunk: int) -> torch.Tensor:
    """One launch of ``lib``, a build of ``csrc/fxp_matmul.cu``, on CUDA
    tensors that passed the wrapper's checks.  Counts nothing:
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
    out = torch.empty((L, M, N), dtype=torch.float32, device=a.device)
    if M and L:
        cols, vec = layout(a3, kc)
        scratch = counters = None
        if n_chunks > 1:
            pairs = a.element_size() * b.element_size()
            scratch = torch.empty((L, n_chunks, pairs, M, N),
                                  dtype=torch.int32, device=a.device)
            counters = torch.zeros(
                (L, lib.fxp_matmul_blocks(M, a.element_size(), int(cols))),
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
                *out.stride()[:2], int(cols), int(vec), stream)
        build.check(lib, "fxp_matmul", err)
    return out if a.dim() == 3 else out[0]


fxp_matmul.launches = 0
