"""Fixed-point / quantized arithmetic (the paper's insight I1).

Port of ``repro.core.quantize``: Qm.n fixed point (:class:`QFormat`),
dynamic symmetric quantization with per-tensor or per-axis scales, the
int8-limb split of wider integers, the overflow-safe hybrid-precision
dot the mlalgos' quantized paths run, and the error-feedback and top-k
helpers of the compressed merge (``distributed.compression``).  Integer
outputs equal the JAX package's bit for bit:

* the scale divides (``x / scale``), it is never a multiply by its
  reciprocal;
* ``torch.round`` rounds half to even, like ``jnp.round``;
* every divide by a Python number goes through :func:`div_scalar`,
  because PyTorch's CUDA ``div`` turns a CPU-scalar divisor into a
  multiply by its reciprocal, which is not the IEEE quotient.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_INT_DTYPES = {8: torch.int8, 16: torch.int16, 32: torch.int32,
               64: torch.int64}


@dataclasses.dataclass(frozen=True)
class QFormat:
    """Qm.n fixed point stored in a ``total_bits`` signed integer:
    ``value = stored_int * 2**-frac_bits``; ``int_bits`` excludes the
    sign bit.  Casts saturate.  (The JAX package's stochastic rounding
    draws from a JAX key and is not ported.)"""

    int_bits: int
    frac_bits: int

    def __post_init__(self):
        if self.total_bits not in _INT_DTYPES:
            raise ValueError(f"unsupported total bits {self.total_bits}")

    @property
    def total_bits(self) -> int:
        return 1 + self.int_bits + self.frac_bits

    @property
    def dtype(self) -> torch.dtype:
        return _INT_DTYPES[self.total_bits]

    @property
    def scale(self) -> float:
        return float(2 ** self.frac_bits)

    @property
    def max_value(self) -> float:
        return (2 ** (self.total_bits - 1) - 1) / self.scale

    @property
    def min_value(self) -> float:
        return -(2 ** (self.total_bits - 1)) / self.scale

    def quantize(self, x) -> torch.Tensor:
        """Float -> Qm.n integer, rounded half to even and saturated.
        The clamp runs in float64, so a float32 value at or past 2^31
        saturates as XLA's float-to-int conversion does."""
        q = torch.round(torch.as_tensor(x, dtype=torch.float32) * self.scale)
        return self._saturate(q.double())

    def dequantize(self, q: torch.Tensor, dtype=torch.float32
                   ) -> torch.Tensor:
        return div_scalar(q.to(dtype), self.scale)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._saturate(a.to(torch.int32) + b.to(torch.int32))

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Qm.n * Qm.n -> Qm.n through an int32 product (2n fractional
        bits), shifted back down with rounding."""
        wide = a.to(torch.int32) * b.to(torch.int32)
        return self._saturate(_rounding_rshift(wide, self.frac_bits))

    def _saturate(self, wide: torch.Tensor) -> torch.Tensor:
        lo = -(2 ** (self.total_bits - 1))
        hi = 2 ** (self.total_bits - 1) - 1
        return torch.clamp(wide, lo, hi).to(self.dtype)


def _rounding_rshift(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Arithmetic right shift rounding to nearest (half an ulp added
    before the shift, as DPU fixed point does)."""
    if bits == 0:
        return x
    return (x + (1 << (bits - 1))) >> bits


def div_scalar(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` as a true IEEE divide in ``x.dtype`` on any device.  The
    divisor is a fill, not ``torch.tensor``'s copy from pageable host
    memory, which synchronises the stream and cannot be captured in a
    CUDA graph (``serving.PredictRunner``)."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


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


def quantize_fixed_scale(x, scale, bits: int = 8) -> Quantized:
    """Symmetric quantization against a precomputed ``scale`` (the
    out-of-core path: a rotation window sees a partition of the rows, so
    its scale comes from the whole dataset's absmax,
    ``data.pipeline.StreamingDataset.feature_absmax``).  The divide,
    round and clip of :func:`quantize_symmetric`, so with
    ``symmetric_scale`` of the global absmax a window equals the same
    rows of the resident ``quantize_symmetric(X, axis=0)`` bit for bit."""
    x = torch.as_tensor(x).float()
    qmax = 2 ** (bits - 1) - 1
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    q = torch.round(x / scale)
    dtype = _INT_DTYPES.get(bits, torch.int32)
    return Quantized(torch.clamp(q, -qmax - 1, qmax).to(dtype), scale)


_NP_INT_DTYPES = {8: np.int8, 16: np.int16, 32: np.int32, 64: np.int64}


def quantize_fixed_scale_np(x, scale, bits: int = 8) -> np.ndarray:
    """:func:`quantize_fixed_scale` in numpy, for the prefetch worker: it
    quantizes a gathered window on the host, so the H2D copy ships int8
    or int16 bytes, not float32.  The same float32 divide, round half to
    even (``np.round``, like ``torch.round``) and clip, so the integers
    are the same bit for bit; done in place on the quotient, one float32
    temporary a call."""
    qmax = 2 ** (bits - 1) - 1
    q = np.divide(np.asarray(x, np.float32), np.asarray(scale, np.float32))
    np.round(q, out=q)
    np.clip(q, -qmax - 1, qmax, out=q)
    return q.astype(_NP_INT_DTYPES.get(bits, np.int32))


def ef_quantize(grad: torch.Tensor, error: torch.Tensor, bits: int = 8):
    """Quantize ``grad + error``: returns ``(Quantized, new_error)`` with
    ``new_error = target − dequantized`` (error feedback keeps compressed
    SGD within O(1) of the exact iterates)."""
    target = grad + error
    q = quantize_symmetric(target, bits=bits)
    return q, target - q.dequantize(grad.dtype)


def quantize_dequantize(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """The quantization round trip, in ``x``'s dtype."""
    return quantize_symmetric(x, bits=bits).dequantize(x.dtype)


def topk_indices(x: torch.Tensor, frac: float) -> torch.Tensor:
    """The flat indices of the ``max(1, floor(size*frac))`` largest-|.|
    entries of ``x``, largest first and, among equal magnitudes, the
    lower index first, as ``jax.lax.top_k`` orders them: the head of a
    stable descending sort (``torch.topk`` promises no order among
    ties)."""
    flat = x.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    return torch.sort(flat.abs(), descending=True, stable=True).indices[:k]


def topk_keep(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Zero all but the entries :func:`topk_indices` picks: exactly k
    survive whatever the ties.  Dropped entries are multiplied by 0, so
    a negative one becomes −0.0, as in the JAX package."""
    flat = x.reshape(-1)
    mask = torch.zeros_like(flat).index_fill_(0, topk_indices(x, frac), 1)
    return (flat * mask).reshape(x.shape)


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
