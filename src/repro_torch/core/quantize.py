"""Fixed-point / quantized arithmetic (the paper's insight I1).

Port of ``repro.core.quantize``: dynamic symmetric quantization with
per-tensor or per-axis scales, the int8-limb split of wider integers,
and the overflow-safe hybrid-precision dot the mlalgos' quantized paths
run.  Integer outputs equal the JAX package's bit for bit:

* the scale divides (``x / scale``), it is never a multiply by its
  reciprocal;
* ``torch.round`` rounds half to even, like ``jnp.round``;
* every divide by a Python number goes through :func:`div_scalar`,
  because PyTorch's CUDA ``div`` turns a CPU-scalar divisor into a
  multiply by its reciprocal, which is not the IEEE quotient.
"""

from __future__ import annotations

import dataclasses

import torch

_INT_DTYPES = {8: torch.int8, 16: torch.int16, 32: torch.int32,
               64: torch.int64}


def div_scalar(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` as a true IEEE divide in ``x.dtype`` on any device."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


@dataclasses.dataclass(frozen=True)
class Quantized:
    """``values * scale`` reconstructs the original; ``scale``
    broadcasts against ``values``."""

    values: torch.Tensor
    scale: torch.Tensor

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.values.float() * self.scale.float()).to(dtype)


def symmetric_scale(amax, bits: int = 8) -> torch.Tensor:
    """The scale :func:`quantize_symmetric` derives from an absmax."""
    qmax = 2 ** (bits - 1) - 1
    amax = torch.as_tensor(amax, dtype=torch.float32)
    return div_scalar(torch.clamp(amax, min=1e-12), float(qmax))


def quantize_symmetric(x: torch.Tensor, bits: int = 8,
                       axis=None) -> Quantized:
    """Symmetric linear quantization with a dynamic scale.

    ``axis=None``: one scale for the tensor.  ``axis=k``: the absmax
    reduces over ``k`` (kept as a size-1 dim), so ``axis=0`` on an
    ``(n, d)`` matrix gives per-feature scales and ``axis=-1`` on a
    lane-batched ``(L, R)`` residual gives one scale per lane.
    """
    x = x.float()
    qmax = 2 ** (bits - 1) - 1
    if axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    scale = symmetric_scale(amax, bits)
    q = torch.round(x / scale)
    dtype = _INT_DTYPES.get(bits, torch.int32)
    return Quantized(torch.clamp(q, -qmax - 1, qmax).to(dtype), scale)


# ---------------------------------------------------------------------------
# hybrid precision: narrow multiply, wide accumulate
# ---------------------------------------------------------------------------


def fxp_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain integer product ``(..., M, K) x (..., K, N) -> int32``.

    Computed in float64, which is exact while every partial sum stays
    below 2^53 (the callers bound it below 2^31): CUDA has no integer
    matmul, so this is the one formulation that is exact on both
    devices."""
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def _split_limbs(x: torch.Tensor):
    """int16 -> (hi, lo) with ``x = 256*hi + lo`` and ``lo`` in [0, 256)."""
    xi = x.to(torch.int32)
    hi = (xi >> 8).to(torch.int16)           # arithmetic shift = floor/256
    lo = (xi & 0xFF).to(torch.int16)         # unsigned low byte
    return hi, lo


def int8_limbs(x: torch.Tensor):
    """``[(weight, limb)]`` with ``x = Σ weight * limb``; limbs are
    int16-typed and every value fits a narrow multiply (the low limb is
    unsigned [0, 256))."""
    if x.dtype in (torch.int8, torch.uint8):
        return [(1.0, x.to(torch.int16))]
    hi, lo = _split_limbs(x)
    return [(256.0, hi), (1.0, lo)]


def hybrid_dot(a: torch.Tensor, b: torch.Tensor, *,
               k_chunk: int = 4096) -> torch.Tensor:
    """Overflow-safe integer product ``(..., M, K) x (..., K, N) -> f32``.

    Every operand splits into int8-range limbs; each limb pair
    accumulates in int32 over K-chunks of ``k_chunk`` (a chunk partial
    stays below 2^28); chunk partials convert to float32 and sum in
    chunk order, limb terms in limb order — the same float operations
    as ``repro.core.quantize.hybrid_dot``, so the result is bit-equal.
    """
    K = a.shape[-1]
    k_chunk = min(k_chunk, K)
    n_chunks = -(-K // k_chunk)
    out = None
    for wa, la in int8_limbs(a):
        for wb, lb in int8_limbs(b):
            acc = None
            for c in range(n_chunks):
                sl = slice(c * k_chunk, (c + 1) * k_chunk)
                part = fxp_matmul(la[..., sl], lb[..., sl, :]).float()
                acc = part if acc is None else acc + part
            term = acc * (wa * wb)
            out = term if out is None else out + term
    return out
