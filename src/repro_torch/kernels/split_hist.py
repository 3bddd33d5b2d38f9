"""Wrapper of the ``split_hist`` CUDA kernel (``csrc/split_hist.cu``).

Port of ``repro/kernels/split_hist.py::split_hist`` as
``DecisionTree.local_step`` drives it: one launch builds every lane's
histogram ``H[node, feature, bin, class]`` for one tree level.  A CPU
tensor runs the plain version
(:func:`repro_torch.kernels.ref.split_hist_ref`); a CUDA tensor launches
the kernel or raises.  ``split_hist.launches`` counts the launches;
each launch also charges its bytes to an active
``roofline.analysis.RoundCounter``.  ``block_n``, the rows a block takes,
is a keyword (``tuning.autotune.block_shapes`` chooses it for
``dispatch.level_histogram`` and ``ops.split_hist``); None is the layout
before tuning.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref
from repro_torch.roofline import analysis

THREADS = 1024                 # threads a block (kThreads in the source)
MAX_SMEM_BYTES = 232448        # what a block may take on Hopper (227 KB)
MAX_ROWS = 2 ** 24             # every count stays an exact float
WAVE_SHARE = 0.85              # one block a (lane, tile) when its waves
                               # fill this share of the card; else rows
CHUNK_WAVES = 4                # are cut into chunks for ~4 waves
MIN_ROWS_PER_BLOCK = 1024
_XBIN_DTYPES = {torch.int32: 0, torch.int16: 1, torch.uint8: 2}
_SIGNATURES = {
    "split_hist_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]),
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
    if xbin.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"split_hist runs on CPU or CUDA, got "
                         f"{xbin.device}")


def _tiles(F: int, fits) -> tuple:
    """(tiles, features a tile): the fewest tiles whose even cut of the
    ``F`` features ``fits``."""
    for tiles in range(1, F + 1):
        nf = -(-F // tiles)
        if -(-F // nf) == tiles and fits(nf):
            return tiles, nf
    raise AssertionError("one feature always fits once checked")


@functools.lru_cache(maxsize=None)
def layout(L: int, R: int, F: int, n_nodes: int, n_bins: int,
           n_classes: int, sms: int, block_n: int | None = None) -> dict:
    """How a launch cuts the work (mirrors the source's ``Level``): the
    features a block holds (``nf``, in ``tiles`` tiles), the row chunks a
    lane is cut into (``chunks``), the shared strides of cell (node,
    feature, bin, class), ``s0 + node*sN + f*sF + (bin*classes +
    class)*sC``, and the block's shared bytes (``smem``).

    One block a (lane, tile) when those blocks fill the card's waves to
    ``WAVE_SHARE``: it stores its cells (``bulk`` False), features
    fastest at an odd stride ``sC`` so a warp's reads spread over the
    banks.  Otherwise the rows are cut into chunks for ~``CHUNK_WAVES``
    waves, and each block adds its tile into a zeroed H by bulk
    reduce-adds (``bulk`` True), in H's own order with each node's run
    ``sN`` words apart (congruent to H's mod 4, so both runs share their
    16-byte phase; ``s0`` < 4 sets it).

    ``block_n`` (rows a block takes) chooses instead of that rule:
    ``block_n >= R`` is one block a (lane, tile), a smaller one the bulk
    layout with ``chunks = ceil(R / block_n)`` (at most 65,535)."""
    bc = n_bins * n_classes
    one = 4 * (3 + n_nodes * (bc + 3))      # one feature, either layout
    if one > MAX_SMEM_BYTES:
        raise ValueError(f"{n_nodes} nodes x {n_bins} bins x {n_classes} "
                         f"classes need {one} B of shared memory per "
                         f"feature, above the {MAX_SMEM_BYTES} B limit")
    tiles, nf = _tiles(F, lambda nf: 4 * n_nodes * bc * (nf | 1)
                       <= MAX_SMEM_BYTES)
    blocks = L * tiles
    waves = -(-blocks // sms)
    if block_n is not None:
        whole = block_n >= R
        if not whole and -(-R // block_n) > 65535:
            raise ValueError(f"block_n={block_n} cuts {R} rows into more "
                             f"than 65535 chunks")
    else:
        whole = blocks >= WAVE_SHARE * waves * sms or R <= MIN_ROWS_PER_BLOCK
    if whole:
        sc = nf | 1
        return {"tiles": tiles, "nf": nf, "chunks": 1, "bulk": False,
                "sN": bc * sc, "sF": 1, "sC": sc,
                "smem": 4 * n_nodes * bc * sc}

    def node_words(nf):
        return nf * bc + (F - nf) * bc % 4

    tiles, nf = _tiles(F, lambda nf: 4 * (3 + n_nodes * node_words(nf))
                       <= MAX_SMEM_BYTES)
    chunks = (-(-R // block_n) if block_n is not None else
              max(2, min(-(-CHUNK_WAVES * sms // (L * tiles)),
                         -(-R // MIN_ROWS_PER_BLOCK), 65535)))
    return {"tiles": tiles, "nf": nf, "chunks": chunks, "bulk": True,
            "sN": node_words(nf), "sF": bc, "sC": 1,
            "smem": 4 * (3 + n_nodes * node_words(nf))}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return build.load("split_hist", _SIGNATURES)


def row_vectors(xbin: torch.Tensor) -> int:
    """1 where one aligned 16-byte load reads a row's bins: its ``F``
    bins fit 16 bytes (the tree's uint8 bins at F <= 16, int16 at F <= 8)
    and the base and both strides are multiples of 16 bytes, so the
    granule read starts at the row and stays in its pages; else 0, one
    load an element."""
    size = xbin.element_size()
    return int(xbin.shape[2] * size <= 16 and xbin.data_ptr() % 16 == 0
               and xbin.stride(0) * size % 16 == 0
               and xbin.stride(1) * size % 16 == 0)


def default_block_n(L: int, R: int, F: int, n_nodes: int, n_bins: int,
                    n_classes: int, sms: int) -> int:
    """``block_n`` of the layout before tuning: ``R`` where it is one
    block a (lane, tile), else a chunk's rows, ``ceil(R / chunks)``,
    which gives back the same chunks (and the source's grid).

    >>> default_block_n(256, 65536, 16, 1, 32, 4, 132)
    65536
    >>> default_block_n(4, 65536, 16, 1, 32, 4, 132)
    1024
    """
    lay = layout(L, R, F, n_nodes, n_bins, n_classes, sms)
    return -(-R // lay["chunks"])


def split_hist(node: torch.Tensor, xbin: torch.Tensor, y: torch.Tensor,
               w: torch.Tensor, *, n_nodes: int, n_bins: int,
               n_classes: int, block_n: int | None = None) -> torch.Tensor:
    """Per-lane weighted counts ``H[lane, node, feature, bin, class]``.

    ``node``, ``y``: int32 ``(L, R)``; ``xbin``: ``(L, R, F)`` int32,
    int16 or uint8 bins with unit stride along ``F``; ``w``: float32 ``(L,
    R)`` 0/1 row weights; any lane and row strides.  Elements whose node,
    bin or class is out of range add nothing.  Returns float32 ``(L,
    n_nodes, F, n_bins, n_classes)``; with 0/1 weights and ``R <= 2^24``
    every count is exact, so the result does not depend on the order of
    the additions (other weights are added in float, in any order).
    ``block_n``: the rows a block takes (:func:`layout`).
    """
    _check(node, xbin, y, w, n_nodes, n_bins, n_classes)
    if block_n is not None and block_n < 1:
        raise ValueError(f"block_n must be >= 1, got {block_n}")
    traced = build.traced(node, xbin, y, w)
    if xbin.device.type == "cpu" and not traced:
        return ref.split_hist_ref(node, xbin, y, w, n_nodes=n_nodes,
                                  n_bins=n_bins, n_classes=n_classes)
    if xbin.stride(-1) != 1:
        raise ValueError("xbin must have unit stride along F")
    if xbin.shape[0] > 65535:
        raise ValueError(f"at most 65535 lanes, got {xbin.shape[0]}")
    if traced:                           # the kernel's output, unlaunched
        H = torch.empty((xbin.shape[0], n_nodes, xbin.shape[2], n_bins,
                         n_classes), dtype=torch.float32, device=xbin.device)
    else:
        H = _launch(_library(), node, xbin, y, w, n_nodes, n_bins,
                    n_classes, block_n)
        split_hist.launches += 1
    # bytes only: the adds are one a row of nonzero weight and feature,
    # which only the weights' values tell (reading them would stop the
    # host), and take a few percent of the bytes' time
    analysis.charge(analysis.nbytes(node, xbin, y, w, H))
    return H


def _launch(lib, node, xbin, y, w, n_nodes: int, n_bins: int,
            n_classes: int, block_n: int | None = None) -> torch.Tensor:
    """One launch of ``lib``, a build of ``csrc/split_hist.cu``, on
    tensors that passed the wrapper's checks, cut as :func:`layout`
    says.  Counts nothing: :func:`split_hist` counts its own calls, and
    ``tools/kernel_ab.py`` times other builds with it."""
    L, R, F = xbin.shape
    dev = xbin.device
    lay = layout(L, R, F, n_nodes, n_bins, n_classes,
                 _sm_count(dev.index if dev.index is not None
                           else torch.cuda.current_device()), block_n)
    shape = (L, n_nodes, F, n_bins, n_classes)
    H = (torch.zeros if lay["bulk"] else torch.empty)(
        shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.split_hist_launch(
            node.data_ptr(), node.stride(0), node.stride(1), xbin.data_ptr(),
            _XBIN_DTYPES[xbin.dtype], xbin.stride(0), xbin.stride(1),
            y.data_ptr(), y.stride(0), y.stride(1), w.data_ptr(),
            w.stride(0), w.stride(1), L, R, F, n_nodes, n_bins, n_classes,
            lay["nf"], lay["chunks"], lay["sN"], lay["sF"], lay["sC"],
            lay["smem"], int(lay["bulk"]), row_vectors(xbin),
            H.data_ptr(), stream)
    build.check(lib, "split_hist", err)
    return H


split_hist.launches = 0
