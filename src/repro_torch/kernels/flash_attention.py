"""Wrapper of the ``flash_attention`` CUDA kernels
(``csrc/flash_attention.cu``): the attention forward and its backward.

:func:`flash_attention` ports ``repro/kernels/flash_attention.py::
flash_attention``: causal (or full) grouped-query attention forward with
an online softmax, p in float32 as the TPU kernel keeps it; asked for
(``return_lse``), it also returns the float32 row log-sum-exp the
backward takes.  :func:`flash_attention_bwd` is its gradient, which the
TPU package never had (JAX trains through autodiff of its plain
attention): dq, dk and dv from q, k, v, the output, its gradient and the
log-sum-exp (FlashAttention-2's scheme, one call of the library).
A CPU tensor runs the plain versions (:func:`repro_torch.kernels.ref.
flash_attention_ref`, :func:`~repro_torch.kernels.ref.
flash_attention_bwd_ref`); a CUDA tensor launches the kernels (the
forward's by :func:`route`, the backward's by :func:`bwd_route`) or
raises; a fake or ``meta`` tensor (``build.traced``) returns empty
outputs of the kernels' shapes and layouts and charges their work.
``flash_attention.launches`` and ``flash_attention_bwd.launches`` count
the calls that launched; each also charges its bytes and operations to
an active ``roofline.analysis.RoundCounter``.
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
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ctypes.c_void_p]),
    "flash_attention_bwd_launch": (ctypes.c_int, [ctypes.c_void_p] * 10 + [
        ctypes.c_int] + [_LL] * 24 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]),
    "flash_attention_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
# the wgmma backward's tiles (csrc/flash_attention.cu: kWgRows, kBwdRows):
# a dK/dV block owns 128 keys and streams 64-row query tiles, a dQ block
# owns 128 query rows and streams 64-key tiles; their schedule and its
# balance are in the source's note
BWD_BLOCK_ROWS, BWD_TILE_ROWS = 128, 64


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
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention runs on CPU or CUDA, got "
                         f"{q.device}")


def _check_cuda_layout(q, k, v, **more):
    """What the kernels take: bf16 or float32, D in HEAD_DIMS, unit stride
    along D, and 16-byte aligned rows (pointers and the batch, head and
    sequence strides) of q, k, v and the backward's ``more`` tensors."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"the flash_attention kernel takes bf16 or float32, "
                        f"got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {q.shape[-1]}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
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
    """The kernel a CUDA call takes, forward and backward alike: bf16 at
    ``D`` in (64, 128) runs on ``wgmma`` fed by TMA, bf16 at ``D = 32`` on
    ``mma.sync`` (a 64-byte row is narrower than the 128-byte swizzle the
    ``wgmma`` kernels' tiles use), float32 on the CUDA cores (``simt``).
    A rule on the shape, not a fallback: a failed build or launch
    raises."""
    if dtype == torch.float32:
        return "simt"
    return "wgmma" if head_dim in (64, 128) else "mma"


# the backward follows the forward's rule
bwd_route = route


def bwd_scratch(kernel: str, B: int, H: int, Kh: int, S: int,
                D: int) -> tuple:
    """``(delta, scratch)``: the float32 elements of the two scratch
    arrays a backward on ``kernel`` takes.  Every route keeps delta a row;
    ``wgmma`` pads each head's rows to a whole 64-row tile and keeps
    lse·log2(e) beside delta, and with a GQA group (``H > Kh``) the
    float32 partial dK and dV of every query head, ``(B, H, S, D)``
    each, that its group sum adds."""
    if kernel != "wgmma":
        return B * H * S, 0
    rows = B * H * -(-S // BWD_TILE_ROWS) * BWD_TILE_ROWS
    return rows, rows + (2 * B * H * S * D if H > Kh else 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, return_lse: bool = False):
    """Attention forward: ``q`` ``(B, H, S, D)``, ``k``/``v`` ``(B, Kh,
    S, D)``, ``H % Kh == 0`` -> ``(B, H, S, D)`` in ``q``'s dtype; with
    ``return_lse``, ``(out, lse)``, ``lse`` the float32 row log-sum-exp of
    the scaled scores, a contiguous ``(B, H, S)`` tensor.

    On the card: bf16 or float32, ``D`` in ``HEAD_DIMS``, any ``S >= 1``,
    unit stride along ``D`` and 16-byte aligned batch, head and sequence
    strides (the transposed view of the model's ``(B, S, H, D)`` tensors
    qualifies).  The result is the transposed view of a contiguous
    ``(B, S, H, D)`` tensor, the layout the output projection reads.
    Writing ``lse`` changes nothing else: the output is the same bits."""
    _check(q, k, v)
    traced = build.traced(q, k, v)
    if q.device.type == "cpu" and not traced:
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       return_lse=return_lse)
    B, H, S, D = q.shape
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if traced:
        o = torch.empty((B, S, H, D), dtype=q.dtype,
                        device=q.device).transpose(1, 2)
    else:
        _check_cuda_layout(q, k, v)
        o = _launch(build.load("flash_attention", _SIGNATURES),
                    route(q.dtype, q.shape[-1]), q, k, v, causal, lse)
        flash_attention.launches += 1
    # q·kᵀ once and p·v (in bf16 as two products, p's hi and lo terms)
    # per (query, key) pair, key <= query when causal
    wide = q.dtype == torch.float32
    analysis.charge(analysis.nbytes(q, k, v, o, *(lse,) * return_lse),
                    (4 if wide else 6) * D * B * H * _pairs(S, causal),
                    analysis.op_kind(q.dtype))
    return (o, lse) if return_lse else o


def _pairs(S: int, causal: bool) -> int:
    """Live (query, key) pairs of one head: key <= query when causal."""
    return S * (S + 1) // 2 if causal else S * S


def _launch(lib, kernel: str, q, k, v, causal: bool,
            lse: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of ``kernel`` from ``lib``, a build of
    ``csrc/flash_attention.cu``, on tensors that passed the wrapper's
    checks; ``lse``, when given, receives the row log-sum-exp.  Counts
    nothing: :func:`flash_attention` counts its own calls, and
    ``tools/kernel_ab.py`` times builds of edited sources with it."""
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
            1.0 / D ** 0.5, stream, None if lse is None else lse.data_ptr())
    build.check(lib, "flash_attention", err)
    return o


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True):
    """The gradient of :func:`flash_attention`: ``q`` ``(B, H, S, D)``,
    ``k``/``v`` ``(B, Kh, S, D)``, the forward's output ``o`` and its
    gradient ``do`` (both ``(B, H, S, D)``, the inputs' dtype) and its
    ``lse`` (float32 ``(B, H, S)``) -> ``(dq, dk, dv)`` in the inputs'
    dtype, float32 accumulation.

    On the card: the forward's dtypes, head dims and layouts (``o`` and
    ``do`` too); the kernels by :func:`bwd_route`, with no float atomics,
    so two calls give the same bits.  bf16 at ``D`` in (64, 128) runs on
    ``wgmma``: Δ = rowsum(dO ∘ O), dQ a (batch, head, 128-row query
    tile), dK/dV a (batch, query head, 128-key tile) and, with a GQA
    group, the group's partials added in head order; bf16 at ``D = 32``
    on ``mma.sync`` (dK/dV a (batch, kv head, 64-key tile) over the
    group); float32 on the CUDA cores.  p and ds are rounded once to bf16
    as operands.  The gradients are transposed views of contiguous ``(B,
    S, heads, D)`` tensors, as the forward's output."""
    _check(q, k, v)
    B, H, S, D = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be q's shape, dtype and device "
                             f"{tuple(q.shape)}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 or \
            lse.device != q.device:
        raise ValueError(f"lse must be float32 (B, H, S) = ({B}, {H}, {S}) "
                         f"on q's device, got {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}")
    traced = build.traced(q, k, v, o, do, lse)
    if q.device.type == "cpu" and not traced:
        return ref.flash_attention_bwd_ref(q, k, v, o, do, lse,
                                           causal=causal)
    if traced:
        grads = tuple(torch.empty((B, S, t.shape[1], D), dtype=q.dtype,
                                  device=q.device).transpose(1, 2)
                      for t in (q, k, v))
    else:
        _check_cuda_layout(q, k, v, o=o, do=do)
        grads = _launch_bwd(build.load("flash_attention", _SIGNATURES),
                            bwd_route(q.dtype, D), q, k, v, o, do, lse,
                            causal)
        flash_attention_bwd.launches += 1
    # the function's five products of 2·D a live (query, key) pair: s =
    # q·kᵀ (p is not an input), dV = pᵀ·dO, dp = dO·vᵀ, dK = dsᵀ·q and dQ =
    # ds·k.  The dQ kernel's second q·kᵀ and dO·vᵀ, and the partials of a
    # GQA group, are this implementation's cost, not the function's, and
    # are not charged.
    analysis.charge(analysis.nbytes(q, k, v, o, do, lse, *grads),
                    10 * D * B * H * _pairs(S, causal),
                    analysis.op_kind(q.dtype))
    return grads


def _launch_bwd(lib, kernel: str, q, k, v, o, do, lse,
                causal: bool) -> tuple:
    """One backward on ``kernel`` from ``lib``, a build of
    ``csrc/flash_attention.cu``, on tensors that passed the wrapper's
    checks: the scratch of :func:`bwd_scratch` allocated, ``(dq, dk,
    dv)`` returned.  Counts nothing: :func:`flash_attention_bwd` counts
    its own calls, and ``tools/kernel_ab.py`` times other builds with it
    (a library from before the ``wgmma`` route takes the scratch pointer,
    its last argument, and ignores it)."""
    B, H, S, D = q.shape
    Kh = k.shape[1]
    lse = lse.contiguous()
    grads = tuple(torch.empty((B, S, heads, D), dtype=q.dtype,
                              device=q.device).transpose(1, 2)
                  for heads in (H, Kh, Kh))
    n_delta, n_scratch = bwd_scratch(kernel, B, H, Kh, S, D)
    # one allocation: delta, then the scratch (a whole number of 64-float
    # rows after delta's on the wgmma route, so 16-byte aligned)
    buf = torch.empty(n_delta + n_scratch, dtype=torch.float32,
                      device=q.device)
    strides = []
    for t in (q, k, v, o, do, *grads):          # (batch, seq, head)
        strides += [t.stride(0), t.stride(2), t.stride(1)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), buf.data_ptr(),
            *(g.data_ptr() for g in grads), _KERNELS[kernel], *strides,
            B, S, H, Kh, D, int(causal), 1.0 / D ** 0.5, stream,
            buf.data_ptr() + 4 * n_delta if n_scratch else None)
    build.check(lib, "flash_attention", err)
    return grads


flash_attention.launches = 0
flash_attention_bwd.launches = 0
