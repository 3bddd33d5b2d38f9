"""The compressed host hop: fixed point with error feedback, and top-k
sparsification.

Port of ``repro.distributed.compression``.  On a mesh
:func:`compressed_reduce` sums the fast axes exactly and crosses the
slow one through the compressed collectives.  A ``mesh=None`` grid has
already lane-summed its partials, so the "wire" is the merged tree
itself: :func:`ef_compress_tree` quantizes and dequantizes each float
leaf with error feedback, which is numerically the round trip a
quantized reduction performs on a slow axis of one participant.
The error buffer is a tree congruent with the wire; it rides in the
merge round's carry and continues across ``fit`` calls through
``merge_state["error"]`` (``distributed.merge_plan``).

Leaf policy (the paper's insight I1 applied to the wire): only float
leaves are quantized.  Integer leaves (counts, histograms, anything
already fixed point) cross exactly.  :func:`_compressible` is the one
predicate.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core import quantize as qz
from repro_torch.distributed import collectives as coll
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """What crosses the host hop.  ``bits``: the fixed-point width of
    float values (None: native width, only with ``top_k_frac``).
    ``top_k_frac``: keep the largest-|.| fraction of each float leaf a
    round, the dropped entries becoming the next round's residual (None:
    dense).  ``slow_axis`` and ``fast_axes`` name the mesh axes of
    :func:`compressed_reduce`."""

    bits: Optional[int] = 8
    error_feedback: bool = True
    top_k_frac: Optional[float] = None
    slow_axis: Optional[str] = "pod"
    fast_axes: Tuple[str, ...] = ("data",)

    def __post_init__(self):
        # bits=1 has qmax = 0: the quantizer would divide by zero
        if self.bits is None:
            if self.top_k_frac is None:
                raise ValueError(
                    "CompressionConfig.bits=None (raw float values) is "
                    "only meaningful with top_k_frac — otherwise nothing "
                    "is compressed")
        elif not 2 <= self.bits <= 16:
            raise ValueError(
                f"CompressionConfig.bits must be in [2, 16] (or None "
                f"with top_k_frac), got {self.bits}")
        if self.top_k_frac is not None and \
                not 0.0 < self.top_k_frac <= 1.0:
            raise ValueError(
                f"CompressionConfig.top_k_frac must be in (0, 1], got "
                f"{self.top_k_frac}")


def _compressible(leaf) -> bool:
    """Only float leaves ride the quantized wire; integer statistics
    cross exactly."""
    dtype = getattr(leaf, "dtype", None)
    if dtype is None:
        dtype = torch.as_tensor(leaf).dtype
    return dtype.is_floating_point or dtype.is_complex


def init_error_state(grads: Any) -> Any:
    """A zero error buffer: float32 for float leaves, a zero of their own
    dtype for integer leaves (which never accumulate error; kept so the
    buffer stays congruent with the tree)."""
    return tree_map(
        lambda g: torch.zeros_like(g, dtype=torch.float32)
        if _compressible(g) else torch.zeros_like(g), grads)


def compressed_reduce(grads: Any, error: Any, cfg: CompressionConfig, *,
                      mesh) -> Tuple[Any, Any]:
    """Reduce a tree hierarchically with a compressed slow hop: exact sums
    over ``cfg.fast_axes``, then ``cfg.slow_axis`` through the compressed
    collectives of ``distributed.collectives``, integer leaves exact.
    ``error`` is congruent with ``grads`` (this participant's residual,
    no hop axis).  Returns ``(reduced, new_error)``; with ``slow_axis``
    None the exact fast-axis sums and ``error`` as it was.

    The JAX function runs inside ``shard_map``, where the axis names are
    bound; here every rank calls it with ``mesh`` (a ``DeviceMesh`` or a
    dict of groups by axis name)."""
    grads = coll.hierarchical_psum(grads, mesh, cfg.fast_axes, None)
    if cfg.slow_axis is None:
        return grads, error
    group = coll.axis_group(mesh, cfg.slow_axis)

    def leaf(g, e):
        if not _compressible(g):
            return coll.psum(g, group), e
        if cfg.top_k_frac is not None:
            return coll.sparse_psum_ef(g, e, group, frac=cfg.top_k_frac,
                                       bits=cfg.bits,
                                       error_feedback=cfg.error_feedback)
        if cfg.error_feedback:
            return coll.quantized_psum_ef(g, e, group, bits=cfg.bits)
        return coll.quantized_psum(g, group, bits=cfg.bits), e

    return _map_pairs(leaf, grads, error)


def _map_pairs(fn, tree: Any, error: Any) -> Tuple[Any, Any]:
    """``fn(leaf, error leaf) -> (out, new error)`` over two congruent
    trees; returns the tree of outs and the tree of new errors."""
    new: list = []

    def leaf(x, e):
        out, ne = fn(x, e)
        new.append(ne)
        return out

    outs = tree_map(leaf, tree, error)
    it = iter(new)
    return outs, tree_map(lambda x, e: next(it), tree, error)


def ef_compress_tree(tree: Any, error: Any, cfg: CompressionConfig
                     ) -> Tuple[Any, Any]:
    """The compressed host hop of a ``mesh=None`` grid: each float leaf
    quantized and dequantized at ``cfg.bits`` with error feedback (and
    top-k sparsified first when ``cfg.top_k_frac`` is set), integer
    leaves untouched.  Returns ``(dequantized tree, new error)``, with
    the float operations of ``repro.distributed.compression.
    ef_compress_tree`` in its order."""

    def leaf(x, e):
        if not _compressible(x):
            return x, e
        if cfg.top_k_frac is not None:
            # the combined residual is target − wire in both cases, so
            # one buffer serves the sparsification and the quantization
            e_in = e if cfg.error_feedback else torch.zeros_like(e)
            kept, resid = topk_sparsify(x, cfg.top_k_frac, e_in)
            deq = (qz.quantize_dequantize(kept, cfg.bits)
                   if cfg.bits is not None else kept)
            return deq, (resid + (kept - deq) if cfg.error_feedback
                         else e)
        if cfg.error_feedback:
            q, ne = qz.ef_quantize(x, e, bits=cfg.bits)
            return q.dequantize(x.dtype), ne
        return qz.quantize_dequantize(x, cfg.bits), e

    return _map_pairs(leaf, tree, error)


def wire_bytes(tree: Any, cfg: Optional[CompressionConfig]) -> int:
    """Bytes one merge round moves over the host hop for ``tree``.

    A compressed float leaf costs ``ceil(bits/8)`` bytes an element plus
    a 4-byte scale; with ``top_k_frac`` only its kept entries cross, each
    its value (at ``bits``, or native with ``bits=None``) plus a 4-byte
    index.  Integer leaves and an exact wire cross at native width.
    Without a mesh this is the modelled cost: the emulated hop moves no
    bytes.

    >>> tree = {"g": torch.zeros(64), "loss": torch.zeros(())}
    >>> wire_bytes(tree, None), wire_bytes(tree, CompressionConfig(bits=8))
    (260, 73)
    """
    total = 0
    for leaf in tree_leaves(tree):
        if not hasattr(leaf, "dtype"):
            leaf = torch.as_tensor(leaf)
        size = 1
        for d in leaf.shape:
            size *= int(d)
        itemsize = leaf.dtype.itemsize
        if cfg is not None and _compressible(leaf):
            vbytes = itemsize if cfg.bits is None else (cfg.bits + 7) // 8
            scale_bytes = 0 if cfg.bits is None else 4
            if cfg.top_k_frac is not None:
                k = max(1, int(size * cfg.top_k_frac))
                total += k * (vbytes + 4) + scale_bytes
            else:
                total += size * vbytes + scale_bytes
        else:
            total += size * itemsize
    return total


def top_k_ladder(base_frac: float, *, bits: Optional[int] = 8,
                 rungs: int = 2) -> Tuple[CompressionConfig, ...]:
    """``rungs`` top-k configs at halving kept fractions from
    ``base_frac``; every rung shares one state-shaped error buffer.

    >>> [c.top_k_frac for c in top_k_ladder(0.25, rungs=3)]
    [0.25, 0.125, 0.0625]
    """
    if not 0.0 < base_frac <= 1.0:
        raise ValueError(f"top_k_ladder needs 0 < base_frac <= 1, got "
                         f"{base_frac}")
    return tuple(CompressionConfig(bits=bits,
                                   top_k_frac=base_frac / (2 ** r))
                 for r in range(max(1, int(rungs))))


def topk_sparsify(g: torch.Tensor, frac: float, error: torch.Tensor):
    """Keep the largest-|.| ``frac`` of ``g + error``
    (``quantize.topk_keep``): returns ``(kept, new error)``, the dropped
    mass being the new error."""
    target = g + error
    kept = qz.topk_keep(target, frac)
    return kept, target - kept
