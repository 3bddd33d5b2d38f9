"""Lookup-table activations (the paper's insight I2).

Port of ``repro.core.lut``.  Tables are built by the same numpy code
(float64 grid, one cast to float32), so their bytes equal the JAX
package's.  The nearest-entry index is computed as ``repro.core.lut``
does, in float32: subtract ``x_min``, divide by ``step`` (rounded once
from the Python double), round half to even, clamp.  The card's kernel
(``kernels/csrc/lut_activation.cu``) repeats that sequence bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.quantize import div_scalar


@dataclasses.dataclass(frozen=True)
class LutTable:
    """``table[i] = fn(x_min + i*step)``, ``step = (x_max-x_min)/(n-1)``;
    out-of-range inputs clamp to the end entries."""

    table: torch.Tensor       # (n_entries,) float32
    x_min: float
    x_max: float

    @property
    def n_entries(self) -> int:
        return int(self.table.shape[0])

    @property
    def step(self) -> float:
        return (self.x_max - self.x_min) / (self.n_entries - 1)


def build_lut(fn: Callable[[np.ndarray], np.ndarray], x_min: float,
              x_max: float, n_entries: int = 1024,
              device="cpu") -> LutTable:
    """Tabulate ``fn`` on a uniform grid on the host, once."""
    xs = np.linspace(x_min, x_max, n_entries, dtype=np.float64)
    vals = np.asarray(fn(xs), dtype=np.float64)
    table = torch.from_numpy(vals.astype(np.float32)).to(device)
    return LutTable(table, float(x_min), float(x_max))


def _index(lut: LutTable, x: torch.Tensor) -> torch.Tensor:
    """Nearest entry; NaN goes to entry 0, as XLA's float-to-int
    conversion (and the kernel's ``fmaxf``) send it."""
    pos = torch.round(div_scalar(x.float() - lut.x_min, lut.step))
    pos = torch.nan_to_num(torch.clamp(pos, 0, lut.n_entries - 1), nan=0.0)
    return pos.to(torch.int64)


def lut_lookup(lut: LutTable, x: torch.Tensor) -> torch.Tensor:
    """Nearest-entry lookup (the paper's DPU variant)."""
    return lut.table[_index(lut, x)].to(x.dtype)


def lut_lookup_interp(lut: LutTable, x: torch.Tensor) -> torch.Tensor:
    """Linearly interpolated lookup: error O(step^2) instead of O(step)."""
    pos = div_scalar(x.float() - lut.x_min, lut.step)
    pos = torch.clamp(pos, 0.0, lut.n_entries - 1.0)
    lo = torch.nan_to_num(torch.floor(pos), nan=0.0).to(torch.int64)
    hi = torch.clamp(lo + 1, max=lut.n_entries - 1)
    w = pos - lo.float()
    return ((1.0 - w) * lut.table[lo] + w * lut.table[hi]).to(x.dtype)


def _np_sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _np_gelu(x):
    return 0.5 * x * (1.0 + np.tanh(np.sqrt(2.0 / np.pi)
                                    * (x + 0.044715 * x ** 3)))


def _np_silu(x):
    return x * _np_sigmoid(x)


_SHARED: dict = {}


def shared_lut(fn: Callable[[np.ndarray], np.ndarray], x_min: float,
               x_max: float, n_entries: int, device) -> LutTable:
    """:func:`build_lut` once per ``(fn, range, entries, device)``.
    ``predict`` asks for its table on every call, and a new table on the
    card is a copy from pageable host memory, which synchronises and
    cannot be captured in a CUDA graph (``serving.PredictRunner``).  The
    table is shared: do not write into it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (fn, float(x_min), float(x_max), int(n_entries), dev)
    lut = _SHARED.get(key)
    if lut is None:
        lut = build_lut(fn, x_min, x_max, n_entries, dev)
        if _is_fake(lut.table):          # a dry run's trace: not shared
            return lut
        lut = _SHARED.setdefault(key, lut)
    return lut


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor) or t.is_meta


def sigmoid_lut(n_entries: int = 1024, bound: float = 8.0,
                device="cpu") -> LutTable:
    """The paper's sigmoid table on [-8, 8] (:func:`shared_lut`)."""
    return shared_lut(_np_sigmoid, -bound, bound, n_entries, device)


def gelu_lut(n_entries: int = 2048, bound: float = 8.0,
             device="cpu") -> LutTable:
    """GELU (tanh form) on [-8, 8]."""
    return build_lut(_np_gelu, -bound, bound, n_entries, device)


def silu_lut(n_entries: int = 2048, bound: float = 8.0,
             device="cpu") -> LutTable:
    """SiLU on [-8, 8]."""
    return build_lut(_np_silu, -bound, bound, n_entries, device)


def tanh_lut(n_entries: int = 1024, bound: float = 6.0,
             device="cpu") -> LutTable:
    """tanh on [-6, 6]."""
    return build_lut(np.tanh, -bound, bound, n_entries, device)


def exp_lut(n_entries: int = 1024, bound: float = 16.0,
            device="cpu") -> LutTable:
    """exp on [-16, 0], one-sided: the LUT softmax feeds shifted logits
    ``z - max(z) <= 0``; below -16 exp is under 1.2e-7 and the clamp to
    the end entry is exact enough for training.  ``lut_activation``
    serves it unchanged (it clamps to the end entries and sends NaN to
    entry 0).  Shared (:func:`shared_lut`)."""
    return shared_lut(np.exp, -bound, 0.0, n_entries, device)


def taylor_sigmoid(x: torch.Tensor, order: int = 7) -> torch.Tensor:
    """The paper's losing baseline: the odd series of sigmoid about 0,
    evaluated by Horner's rule in float32."""
    coeffs = [0.5, 0.25, 0.0, -1.0 / 48, 0.0, 1.0 / 480, 0.0, -17.0 / 80640]
    xf = x.float()
    acc = torch.zeros_like(xf)
    for c in reversed(coeffs[: order + 1]):
        acc = acc * xf + c
    return acc.to(x.dtype)


def lut_max_error(lut: LutTable, fn: Callable, n_probe: int = 100_000,
                  interp: bool = False) -> float:
    """Max abs error of the table against the exact ``fn`` (given float64
    numpy values) on ``n_probe`` float32 points spanning its domain."""
    xs = np.linspace(lut.x_min, lut.x_max, n_probe, dtype=np.float32)
    exact = np.asarray(fn(xs.astype(np.float64)))
    ev = lut_lookup_interp if interp else lut_lookup
    host = LutTable(lut.table.cpu(), lut.x_min, lut.x_max)
    approx = ev(host, torch.from_numpy(xs)).numpy().astype(np.float64)
    return float(np.max(np.abs(exact - approx)))
