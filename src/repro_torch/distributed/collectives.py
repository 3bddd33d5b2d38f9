"""Hierarchical and quantized collectives — the paper's insight I5 (the
host-mediated merge) and I1 (fixed point) on a mesh of ranks.

Port of ``repro.distributed.collectives`` on ``torch.distributed``.
UPMEM DPUs cannot talk to each other: partial results funnel through
the host.  A cluster of H100s has the same two levels, NVLink inside a
node and the NIC between nodes, so the host hop maps to the ``pod``
axis of the mesh (``launch.mesh.make_pim_mesh``).
:func:`hierarchical_psum` reduces over the fast axes first, then crosses
the slow axis once; :func:`quantized_psum` and its error-fed variants
carry the slow hop as int8 codes and one float32 scale.

Where JAX names an axis, these functions take the axis's
``ProcessGroup`` (:func:`axis_group` of a ``DeviceMesh``, or of a dict
of groups by axis name).  Every rank calls them with its own
contribution and gets the reduced value back, as every participant of
a ``psum`` does.

Exact and deterministic.  Integer tensors are summed by
``all_reduce(SUM)``, which is exact.  A float sum depends on its order,
and a backend's all-reduce picks its order by algorithm, so a float
tensor is all-gathered and every rank adds the contributions in rank
order, ``((x0 + x1) + x2) + ...``, in the tensor's dtype: the sum JAX's
``psum`` computes over a ``vmap`` axis, and the same bits on every rank
whatever the backend.  The maximum is ``all_reduce(MAX)``, exact too.
So the replicas of a multi-controller fit stay bit-identical.

At a hop of one participant each quantized collective is, bit for bit,
the single-device emulation (``quantize.ef_quantize``,
``compression.ef_compress_tree``): the grid in float32 whatever the
leaf dtype, the dequantized wire the float32 product cast once to the
leaf dtype, the residual taken against the wire cast to the input's
dtype.  Its residuals are equal up to the sign of a zero.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import quantize as qz
from repro_torch.roofline import analysis
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def axis_group(mesh, axis: str):
    """The ``ProcessGroup`` of mesh axis ``axis``: ``mesh`` is a
    ``DeviceMesh`` or a dict of groups by axis name."""
    if isinstance(mesh, dict):
        return mesh[axis]
    return mesh.get_group(axis)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every participant's ``x`` (see the module docstring
    for the order); returns a new tensor."""
    if not x.dtype.is_floating_point:
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out
    parts = all_gather(x, group)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over the participants."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_gather(x: torch.Tensor, group) -> list:
    """Every participant's ``x``, in rank order of ``group``."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


def psum_tree(tree: Any, group, *, fast: bool = False) -> Any:
    """:func:`psum` of every leaf, one collective a dtype: the leaves of
    one dtype travel flattened into one buffer (a sum is elementwise, so
    the bits are those of a collective a leaf).  ``fast`` charges the
    traffic to an active ``roofline.analysis.RoundCounter`` as fast-link
    bytes."""
    leaves = tree_leaves(tree)
    n = dist.get_world_size(group)
    by_dtype: dict = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    out = list(leaves)
    for dtype, idx in by_dtype.items():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx]) \
            if len(idx) > 1 else leaves[idx[0]].reshape(-1)
        if fast:
            # a float leaf is gathered, an integer one all-reduced
            moved = (n - 1) if dtype.is_floating_point else 2 * (n - 1) / n
            analysis.charge_link(moved * analysis.nbytes(flat))
        total = psum(flat, group)
        off = 0
        for i in idx:
            size = leaves[i].numel()
            out[i] = total[off:off + size].reshape(leaves[i].shape)
            off += size
    return tree_unflatten(tree, out)


def hierarchical_psum(x: Any, mesh, fast_axes: Sequence[str],
                      slow_axis: Optional[str]) -> Any:
    """Sum a tree over the fast axes in turn, then over the slow axis
    (``None``: the fast axes only)."""
    for ax in fast_axes:
        x = psum_tree(x, axis_group(mesh, ax), fast=True)
    if slow_axis is not None:
        x = psum_tree(x, axis_group(mesh, slow_axis))
    return x


def lane_sum(tree: Any, *, scale: float | None = None) -> Any:
    """Sum each leaf over its leading lane dim, with ``scale`` folded into
    the summands (the JAX package folds it into a ones vector and
    contracts on the MXU; here it is ``sum(dim=0)``)."""
    return tree_map(
        lambda x: (x if scale is None else x * scale).sum(dim=0), tree)


def _grid(x32: torch.Tensor, group, bits: int):
    """The shared grid: every participant's float32 absmax, maxed over
    the axis, as ``quantize.symmetric_scale`` turns an absmax into a
    scale.  Returns ``(codes as float32, scale)``."""
    qmax = 2 ** (bits - 1) - 1
    amax = pmax(x32.abs().amax(), group)
    scale = qz.symmetric_scale(amax, bits)
    return torch.clamp(torch.round(x32 / scale), -qmax - 1, qmax), scale


def _code_sum(q: torch.Tensor, scale: torch.Tensor, group,
              dtype: torch.dtype) -> torch.Tensor:
    """The int32 sum of the codes, dequantized once to ``dtype``."""
    total = psum(q.to(torch.int32), group)
    return (total.float() * scale).to(dtype)


def quantized_psum(x: torch.Tensor, group, *, bits: int = 8
                   ) -> torch.Tensor:
    """All-reduce with fixed point on the wire: quantize on a grid shared
    over the axis, sum the codes in int32 (the paper's hybrid
    precision), dequantize."""
    q, scale = _grid(x.float(), group, bits)
    return _code_sum(q, scale, group, x.dtype)


def _alive(alive, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(alive, dtype=torch.bool, device=like.device)


def quantized_psum_ef(x: torch.Tensor, error: torch.Tensor, group, *,
                      bits: int = 8, alive=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback variant: returns ``(reduced, new_error)``; this
    round's quantization residual is added to the next round's input.

    ``alive`` (survivor merges): an optional bool for this participant.
    A dead participant sends an exactly-zero wire and *holds* its
    residual, so a revived one re-injects what it owed; ``None`` skips
    the gating."""
    target = x + error
    if alive is not None:
        alive = _alive(alive, target)
        target = torch.where(alive, target, torch.zeros_like(target))
    q, scale = _grid(target.float(), group, bits)
    new_error = target - (q * scale).to(x.dtype)
    if alive is not None:
        new_error = torch.where(alive, new_error, error)
    return _code_sum(q, scale, group, x.dtype), new_error


def sparse_psum_ef(x: torch.Tensor, error: torch.Tensor, group, *,
                   frac: float, bits: Optional[int] = 8,
                   error_feedback: bool = True, alive=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k sparsified (optionally fixed-point) all-reduce with error
    feedback, the slow hop of PIM-Opt's sparsified merge.

    Each participant keeps the largest-|.| ``frac`` of its (error-fed)
    entries (``quantize.topk_keep``: exactly k survive) as a dense
    carrier, quantizes the kept values at ``bits`` on the shared grid
    (``None``: raw floats, summed exactly as :func:`psum` sums), and
    the carriers are summed.  The dropped mass and the quantization
    residual become the next round's error.  ``alive`` gates a dead
    participant as in :func:`quantized_psum_ef`."""
    target = x + error if error_feedback else x
    if alive is not None:
        alive = _alive(alive, target)
        target = torch.where(alive, target, torch.zeros_like(target))
    kept = qz.topk_keep(target, frac)
    if bits is None:
        local_wire = kept
        total = psum(kept, group)
    else:
        q, scale = _grid(kept.float(), group, bits)
        local_wire = (q * scale).to(x.dtype)
        total = _code_sum(q, scale, group, x.dtype)
    new_error = (target - local_wire) if error_feedback else error
    if alive is not None and error_feedback:
        new_error = torch.where(alive, new_error, error)
    return total, new_error


def hierarchical_grad_reduce(grads: Any, mesh, *, fast_axes: Sequence[str],
                             slow_axis: Optional[str],
                             compress_bits: int = 0) -> Any:
    """The paper's merge of gradients: exact over the fast axes, then the
    slow hop exact or, with ``compress_bits``, in fixed point
    (:func:`quantized_psum`)."""
    grads = hierarchical_psum(grads, mesh, fast_axes, None)
    if slow_axis is None:
        return grads
    group = axis_group(mesh, slow_axis)
    if compress_bits:
        return tree_map(
            lambda g: quantized_psum(g, group, bits=compress_bits), grads)
    return psum_tree(grads, group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every participant's ``x`` stacked on a new leading dim, in rank
    order (the error buffer's hop rows, made equal on every rank)."""
    return torch.stack(all_gather(x, group))


def mesh_max(mesh, axes: Sequence[str], value: float,
             device) -> float:
    """``value`` maxed over every rank of the mesh's ``axes``: a host
    number that decides control flow, agreed before it is used."""
    t = torch.tensor(float(value), dtype=torch.float64, device=device)
    for ax in axes:
        t = pmax(t, axis_group(mesh, ax))
    return float(t)
