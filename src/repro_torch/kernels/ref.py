"""Plain PyTorch versions of the kernels.

The CPU path of every wrapper, and the oracle ``chip_smoke.py`` holds
each CUDA kernel against on the card.  They repeat the kernels'
arithmetic and are no yardstick of speed.
"""

from __future__ import annotations

import torch

from repro_torch.core import lut as lut_mod
from repro_torch.core import quantize as qz


def a_limb(a: torch.Tensor, limb: int) -> torch.Tensor:
    """0: ``a`` as it is; 1: high limb ``a >> 8``; 2: low limb
    ``a & 0xFF`` of an int16 ``a`` (int32-typed)."""
    if limb == 0:
        return a
    ai = a.to(torch.int32)
    return ai >> 8 if limb == 1 else ai & 0xFF


def fxp_matmul_ref(a: torch.Tensor, b: torch.Tensor, *, k_chunk: int,
                   limb: int = 0) -> torch.Tensor:
    """``(..., M, K) x (..., K, N)`` -> int32 chunk partials
    ``(..., n_chunks, M, N)``: ``out[..., c, m, n]`` sums
    ``a_limb(a)[..., m, k] * b[..., k, n]`` over chunk ``c``'s
    ``k_chunk`` columns.  Exact (float64 products of integers)."""
    la = a_limb(a, limb)
    K = a.shape[-1]
    k_chunk = min(k_chunk, K)
    parts = [qz.fxp_matmul(la[..., c:c + k_chunk], b[..., c:c + k_chunk, :])
             for c in range(0, K, k_chunk)]
    return torch.stack(parts, dim=-3)


def lut_activation_ref(x: torch.Tensor, table: torch.Tensor, x_min: float,
                       x_max: float) -> torch.Tensor:
    """Nearest-entry lookup, ``repro_torch.core.lut.lut_lookup``."""
    return lut_mod.lut_lookup(lut_mod.LutTable(table, x_min, x_max), x)
