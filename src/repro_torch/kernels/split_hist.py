"""Wrapper of the ``split_hist`` CUDA kernel (``csrc/split_hist.cu``).

Port of ``repro/kernels/split_hist.py::split_hist`` as
``DecisionTree.local_step`` drives it: one launch builds every lane's
histogram ``H[node, feature, bin, class]`` for one tree level.  A CPU
tensor runs the plain version
(:func:`repro_torch.kernels.ref.split_hist_ref`); a CUDA tensor launches
the kernel or raises.  ``split_hist.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

MAX_SMEM_BYTES = 227 * 1024    # what a block may take on Hopper
TILE_SMEM_BYTES = 48 * 1024    # feature tiles are cut to this when they can
MAX_ROWS = 2 ** 24             # every partial stays an exact float
BLOCKS_PER_SM = 32             # a few waves: the last leaves few SMs idle
MIN_ROWS_PER_BLOCK = 1024
_XBIN_DTYPES = {torch.int32: 0, torch.int16: 1, torch.uint8: 2}
_SIGNATURES = {
    "split_hist_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]),
    "split_hist_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _check(node, xbin, y, w, n_nodes, n_bins, n_classes):
    if node.dtype != torch.int32 or y.dtype != torch.int32:
        raise TypeError(f"node and y must be int32, got {node.dtype}, "
                        f"{y.dtype}")
    if xbin.dtype not in _XBIN_DTYPES:
        raise TypeError(f"xbin must be int32, int16 or uint8, got "
                        f"{xbin.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    if xbin.dim() != 3 or any(t.shape != xbin.shape[:2]
                              for t in (node, y, w)):
        raise ValueError(f"need xbin (L, R, F) and node, y, w (L, R); got "
                         f"{[tuple(t.shape) for t in (node, xbin, y, w)]}")
    if min(xbin.shape) < 1 or min(n_nodes, n_bins, n_classes) < 1:
        raise ValueError("need L, R, F, n_nodes, n_bins, n_classes >= 1")
    if xbin.shape[1] > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} rows per lane (so every count "
                         f"is an exact float32), got {xbin.shape[1]}")
    if any(t.device != xbin.device for t in (node, y, w)):
        raise ValueError("node, xbin, y and w must share a device")
    if xbin.device.type not in ("cpu", "cuda"):
        raise ValueError(f"split_hist runs on CPU or CUDA, got "
                         f"{xbin.device}")


def feature_tile(n_nodes: int, n_bins: int, n_classes: int, F: int) -> int:
    """Features per block: as many as fit in ``TILE_SMEM_BYTES`` of
    shared memory, at least one; raises when one feature's histogram
    exceeds what a block may take."""
    per_feature = 4 * n_nodes * n_bins * n_classes
    if per_feature > MAX_SMEM_BYTES:
        raise ValueError(f"{n_nodes} nodes x {n_bins} bins x {n_classes} "
                         f"classes need {per_feature} B of shared memory per "
                         f"feature, above the {MAX_SMEM_BYTES} B limit")
    return max(1, min(F, TILE_SMEM_BYTES // per_feature))


def split_hist(node: torch.Tensor, xbin: torch.Tensor, y: torch.Tensor,
               w: torch.Tensor, *, n_nodes: int, n_bins: int,
               n_classes: int) -> torch.Tensor:
    """Per-lane weighted counts ``H[lane, node, feature, bin, class]``.

    ``node``, ``y``: int32 ``(L, R)``; ``xbin``: ``(L, R, F)`` int32,
    int16 or uint8 bins with unit stride along ``F``; ``w``: float32 ``(L,
    R)`` 0/1 row weights; any lane and row strides.  Elements whose node,
    bin or class is out of range add nothing.  Returns float32 ``(L,
    n_nodes, F, n_bins, n_classes)``; with 0/1 weights and ``R <= 2^24``
    every count is exact, so the result does not depend on the order of
    the additions.
    """
    _check(node, xbin, y, w, n_nodes, n_bins, n_classes)
    if xbin.device.type == "cpu":
        return ref.split_hist_ref(node, xbin, y, w, n_nodes=n_nodes,
                                  n_bins=n_bins, n_classes=n_classes)
    if xbin.stride(-1) != 1:
        raise ValueError("xbin must have unit stride along F")
    L, R, F = xbin.shape
    if L > 65535:
        raise ValueError(f"at most 65535 lanes, got {L}")
    ft = feature_tile(n_nodes, n_bins, n_classes, F)
    tiles = -(-F // ft)
    sms = torch.cuda.get_device_properties(xbin.device).multi_processor_count
    chunks = max(1, min(-(-BLOCKS_PER_SM * sms // (tiles * L)),
                        -(-R // MIN_ROWS_PER_BLOCK), 65535))
    H = torch.zeros((L, n_nodes, F, n_bins, n_classes), dtype=torch.float32,
                    device=xbin.device)
    lib = build.load("split_hist", _SIGNATURES)
    with torch.cuda.device(xbin.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.split_hist_launch(
            node.data_ptr(), node.stride(0), node.stride(1), xbin.data_ptr(),
            _XBIN_DTYPES[xbin.dtype], xbin.stride(0), xbin.stride(1),
            y.data_ptr(), y.stride(0), y.stride(1), w.data_ptr(),
            w.stride(0), w.stride(1), L, R, F, n_nodes, n_bins, n_classes,
            ft, chunks, H.data_ptr(), stream)
    build.check(lib, "split_hist", err)
    split_hist.launches += 1
    return H


split_hist.launches = 0
