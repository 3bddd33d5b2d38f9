"""Wrapper of the ``lut_activation`` CUDA kernel
(``csrc/lut_activation.cu``).

Port of ``repro/kernels/lut_activation.py::lut_activation``.  A CPU
tensor runs the plain version
(:func:`repro_torch.kernels.ref.lut_activation_ref`); a CUDA tensor
launches the kernel or raises.  ``lut_activation.launches`` counts the
launches; each launch also charges its bytes and operations to an
active ``roofline.analysis.RoundCounter``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.roofline import analysis

MAX_ENTRIES = 12288            # 48 KB of shared memory
BLOCKS_PER_SM = 8
_SIGNATURES = {
    "lut_activation_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p]),
    "lut_activation_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return build.load("lut_activation", _SIGNATURES)


def lut_activation(x: torch.Tensor, table: torch.Tensor, *, x_min: float,
                   x_max: float) -> torch.Tensor:
    """``table[clip(round((x - x_min) / step), 0, n-1)]`` elementwise,
    ``step = (x_max - x_min) / (n - 1)``.  ``x``: contiguous float32 of
    any shape; ``table``: contiguous float32 ``(n,)``, ``2 <= n <=
    12288``.  Returns float32 of ``x``'s shape."""
    if x.dtype != torch.float32 or table.dtype != torch.float32:
        raise TypeError(f"x and table must be float32, got {x.dtype}, "
                        f"{table.dtype}")
    if table.dim() != 1 or not 2 <= table.shape[0] <= MAX_ENTRIES:
        raise ValueError(f"table must be (n,) with 2 <= n <= {MAX_ENTRIES}, "
                         f"got {tuple(table.shape)}")
    if not (x.is_contiguous() and table.is_contiguous()):
        raise ValueError("x and table must be contiguous")
    if x.device != table.device:
        raise ValueError(f"x on {x.device}, table on {table.device}")
    traced = build.traced(x, table)
    if x.device.type == "cpu" and not traced:
        return ref.lut_activation_ref(x, table, x_min, x_max)
    if x.device.type not in ("cuda", "meta") and not traced:
        raise ValueError(f"lut_activation runs on CPU or CUDA, got "
                         f"{x.device}")

    out = torch.empty_like(x)
    if x.numel() and not traced:        # traced: the output, unlaunched
        n_entries = int(table.shape[0])
        # rounded from the double to float32 once, here (ctypes.c_float)
        step = (x_max - x_min) / (n_entries - 1)
        sms = _sm_count(x.device.index if x.device.index is not None
                        else torch.cuda.current_device())
        lib = _library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.lut_activation_launch(
                x.data_ptr(), table.data_ptr(), out.data_ptr(), x.numel(),
                n_entries, x_min, step, sms * BLOCKS_PER_SM, stream)
        build.check(lib, "lut_activation", err)
        lut_activation.launches += 1
    if x.numel():
        # subtract, divide, round, clamp
        analysis.charge(2 * analysis.nbytes(x) + analysis.nbytes(table),
                        4 * x.numel(), "fp32")
    return out


lut_activation.launches = 0
