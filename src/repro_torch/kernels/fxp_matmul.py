"""Wrapper of the ``fxp_matmul`` CUDA kernel (``csrc/fxp_matmul.cu``).

Port of ``repro/kernels/fxp_matmul.py::fxp_matmul`` as
``kernels/dispatch.py::hybrid_matmul`` drives it: one launch returns the
int32 partial of every K-chunk, for every lane, for all of ``b``'s
columns.  A CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.fxp_matmul_ref`); a CUDA tensor launches
the kernel or raises.  ``fxp_matmul.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

MAX_N = 8                      # columns of b the kernel keeps in registers
_LIMB_DTYPE = {0: torch.int8, 1: torch.int16, 2: torch.int16}
_SIGNATURES = {
    "fxp_matmul_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    "fxp_matmul_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _check(a: torch.Tensor, b: torch.Tensor, k_chunk: int, limb: int):
    if limb not in _LIMB_DTYPE:
        raise ValueError(f"limb must be 0, 1 or 2, got {limb}")
    if a.dtype != _LIMB_DTYPE[limb]:
        raise TypeError(f"limb={limb} takes a {_LIMB_DTYPE[limb]} a, got "
                        f"{a.dtype}")
    if b.dtype != torch.int16:
        raise TypeError(f"b must be int16 limbs, got {b.dtype}")
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


def fxp_matmul(a: torch.Tensor, b: torch.Tensor, *, k_chunk: int = 4096,
               limb: int = 0) -> torch.Tensor:
    """Int32 chunk partials of ``limb(a) @ b``.

    ``a``: ``(M, K)`` or ``(L, M, K)``, int8 (``limb=0``) or int16 read
    as its high (``limb=1``) or low (``limb=2``) int8-range limb; any
    strides, so a transposed view costs no copy.  ``b``: ``(K, N)``
    (shared by every lane) or ``(L, K, N)`` int16 limbs in [-128, 255],
    ``N <= 8``.  Returns int32 ``(..., n_chunks, M, N)`` with
    ``n_chunks = ceil(K / min(k_chunk, K))``.
    """
    _check(a, b, k_chunk, limb)
    if a.device.type == "cpu":
        return ref.fxp_matmul_ref(a, b, k_chunk=k_chunk, limb=limb)

    a3 = a if a.dim() == 3 else a.unsqueeze(0)
    b3 = b if b.dim() == 3 else b.unsqueeze(0)
    L, M, K = a3.shape
    N = b3.shape[-1]
    kc = min(k_chunk, K)
    n_chunks = -(-K // kc)
    if L > 65535 or n_chunks > 65535:
        raise ValueError(f"at most 65535 lanes and chunks, got {L} lanes, "
                         f"{n_chunks} chunks")
    out = torch.empty((L, n_chunks, M, N), dtype=torch.int32,
                      device=a.device)
    if M and L:
        sAl, sAm, sAk = a3.stride()
        sBl = b3.stride(0) if b3.shape[0] > 1 else 0
        _, sBk, sBn = b3.stride()
        cols = sAm == 1 and sAk != 1
        # cols: m per block; rows: lanes per row (each walks ~8 k's)
        param = (min(64, _pow2_ceil(M)) if cols
                 else min(32, _pow2_ceil(-(-kc // 8))))
        lib = build.load("fxp_matmul", _SIGNATURES)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.fxp_matmul_launch(
                a3.data_ptr(), limb, b3.data_ptr(), out.data_ptr(), L, M, K,
                N, kc, sAl, sAm, sAk, sBl, sBk, sBn, int(cols), param,
                stream)
        build.check(lib, "fxp_matmul", err)
        fxp_matmul.launches += 1
    return out if a.dim() == 3 else out[0]


fxp_matmul.launches = 0
