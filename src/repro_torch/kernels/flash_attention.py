"""Wrapper of the ``flash_attention`` CUDA kernel
(``csrc/flash_attention.cu``).

Port of ``repro/kernels/flash_attention.py::flash_attention``: causal
(or full) grouped-query attention forward with an online softmax, p in
float32 as the TPU kernel keeps it.  A CPU tensor runs the plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`); a CUDA tensor
launches one of the library's three kernels (:func:`route`) or raises.
``flash_attention.launches`` counts the launches; each launch also
charges its bytes and operations to an active
``roofline.analysis.RoundCounter``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.roofline import analysis

HEAD_DIMS = (32, 64, 128)
# the kernels of csrc/flash_attention.cu, by the code the launcher takes
_KERNELS = {"mma": 0, "simt": 1, "wgmma": 2}
_DTYPES = (torch.bfloat16, torch.float32)
_LL = ctypes.c_longlong
_SIGNATURES = {
    "flash_attention_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
        _LL, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]),
    "flash_attention_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"need q (B, H, S, D), k and v (B, Kh, S, D); got "
                         f"{[tuple(t.shape) for t in (q, k, v)]}")
    B, H, S, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (S, D):
        raise ValueError(f"k and v must be (B, Kh, S, D) = ({B}, Kh, {S}, "
                         f"{D}); got {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[1] < 1 or H % k.shape[1]:
        raise ValueError(f"H = {H} is not a multiple of Kh = {k.shape[1]}")
    if min(B, H, S) < 1:
        raise ValueError(f"need B, H, S >= 1, got {tuple(q.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("q, k and v must share a device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on CPU or CUDA, got "
                         f"{q.device}")


def _check_cuda_layout(q, k, v):
    """What the kernel takes: bf16 or float32, D in HEAD_DIMS, unit stride
    along D, and 16-byte aligned rows (pointers and the batch, head and
    sequence strides)."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"the flash_attention kernel takes bf16 or float32, "
                        f"got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {q.shape[-1]}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                st % vec for st in t.stride()[:3]):
            raise ValueError(
                f"{name}: the flash_attention kernel needs unit stride "
                f"along D and 16-byte aligned rows; got strides "
                f"{t.stride()} at offset {t.data_ptr() % 16} mod 16")
    if q.shape[0] > 65535 or q.shape[1] > 65535:
        raise ValueError(f"at most 65535 batches and heads, got "
                         f"{tuple(q.shape)}")


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call takes: bf16 at ``D`` in (64, 128) runs on
    ``wgmma`` fed by TMA, bf16 at ``D = 32`` on ``mma.sync`` (a 64-byte
    row is narrower than the 128-byte swizzle the ``wgmma`` kernel's
    tiles use), float32 on the CUDA cores (``simt``).  A rule on the
    shape, not a fallback: a failed build or launch raises."""
    if dtype == torch.float32:
        return "simt"
    return "wgmma" if head_dim in (64, 128) else "mma"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention forward: ``q`` ``(B, H, S, D)``, ``k``/``v`` ``(B, Kh,
    S, D)``, ``H % Kh == 0`` -> ``(B, H, S, D)`` in ``q``'s dtype.

    On the card: bf16 or float32, ``D`` in ``HEAD_DIMS``, any ``S >= 1``,
    unit stride along ``D`` and 16-byte aligned batch, head and sequence
    strides (the transposed view of the model's ``(B, S, H, D)`` tensors
    qualifies).  The result is the transposed view of a contiguous
    ``(B, S, H, D)`` tensor, the layout the output projection reads."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    _check_cuda_layout(q, k, v)
    o = _launch(build.load("flash_attention", _SIGNATURES),
                route(q.dtype, q.shape[-1]), q, k, v, causal)
    flash_attention.launches += 1
    # q·kᵀ once and p·v (in bf16 as two products, p's hi and lo terms)
    # per (query, key) pair, key <= query when causal
    B, H, S, D = q.shape
    pairs = S * (S + 1) // 2 if causal else S * S
    wide = q.dtype == torch.float32
    analysis.charge(analysis.nbytes(q, k, v, o),
                    (4 if wide else 6) * D * B * H * pairs,
                    analysis.op_kind(q.dtype))
    return o


def _launch(lib, kernel: str, q, k, v, causal: bool) -> torch.Tensor:
    """One launch of ``kernel`` from ``lib``, a build of
    ``csrc/flash_attention.cu``, on tensors that passed the wrapper's
    checks.  Counts nothing: :func:`flash_attention` counts its own calls,
    and ``tools/kernel_ab.py`` times builds of edited sources with it."""
    B, H, S, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    o = out.transpose(1, 2)
    strides = []
    for t in (q, k, v, o):                     # (batch, seq, head)
        strides += [t.stride(0), t.stride(2), t.stride(1)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _KERNELS[kernel], *strides, B, S, H, k.shape[1], D, int(causal),
            1.0 / D ** 0.5, stream)
    build.check(lib, "flash_attention", err)
    return o


flash_attention.launches = 0
