"""Survivor-weighted merges: training through dead lanes.

Port of ``repro.resilience.survivor``.  The exact cadence round
(``merge_plan.cadence_round``) averages the lanes' phase-end states
uniformly, ``Σ_l s_l / n``.  When lanes die that average would NaN (a
dead lane's garbage) or lean toward zero (masking without
renormalising).  The survivor merge renormalises by the surviving lane
count,

    avg = Σ_l m_l · s_l / n_s,      n_s = max(Σ_l m_l, 1),

with ``m`` a 0/1 float32 mask riding the carry.  On the wire this is a
delta a slow-hop participant ``p`` sends,

    x_p = (Σ_{l∈p} m_l s_l − n_p · state) / n_s,

so that ``Σ_p x_p = avg − state``, and a participant with no live lane
sends an exactly-zero wire.  The new state is ``state + Σ_p x̂_p``, with
``x̂`` the (possibly compressed) wire, computed in the JAX package's
order: it rounds differently from the unarmed ``S · (1/n)``, and the
tests hold each against its own JAX counterpart.

A compressed wire gates on ``alive_p = n_p > 0``: a dead participant
sends zero and *holds* its error-feedback residual
(``collectives.quantized_psum_ef(..., alive=)``).  Metrics are
mask-averaged the same way (``Σ m·metric / n_s``).  Non-float state
leaves are frozen.

The carry is ``(state, mask, ef)``.  ``ef`` is state-shaped with the
hop axis first (``merge_plan.init_merge_error``) whatever the wire, so
the checkpoint layout does not change as the recovery ladder drops
compression.  On a mesh a rank holds its own block of the mask
(:func:`place_mask`), and updates only its pod's row of ``ef``, as
``merge_plan._slow_hop`` does.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed import compression as comp
from repro_torch.distributed import merge_plan as mp
from repro_torch.tree import tree_map


def _float_leaf(x) -> bool:
    return x.dtype.is_floating_point


def _wsum(tree, mask):
    """Mask-weighted sum over the leading lane axis."""
    def one(x):
        m = mask.reshape((mask.shape[0],) + (1,) * (x.dim() - 1))
        return (x * m.to(x.dtype)).sum(dim=0)
    return tree_map(one, tree)


def _wire_delta(ssum, state, n_local, n_s):
    """A participant's wire ``(Σ_local m·s − n_local·state) / n_s``; a
    frozen (non-float) leaf sends zeros."""
    def one(ss, s):
        if not _float_leaf(s):
            return torch.zeros_like(s)
        return (ss - n_local.to(s.dtype) * s) / n_s.to(s.dtype)
    return tree_map(one, ssum, state)


def _apply_delta(state, delta):
    return tree_map(lambda s, d: s + d if _float_leaf(s) else s,
                    state, delta)


def _masked_mean(msum, n_s):
    return tree_map(lambda m: m / n_s.to(m.dtype) if _float_leaf(m)
                    else m, msum)


def _gated_compress(wire, ef, compression, alive):
    """The emulated slow hop of a grid without a mesh, its wire and
    residual gated on ``alive`` (hop row 0 of ``ef``)."""
    sq = tree_map(lambda e: e[0], ef)
    deq, new = comp.ef_compress_tree(wire, sq, compression)
    deq = tree_map(lambda d: torch.where(alive, d, torch.zeros_like(d)),
                   deq)
    new = tree_map(lambda n, e: torch.where(alive, n, e), new, sq)
    return deq, tree_map(lambda n: n[None], new)


def _slow_hop_compressed(grid, wire, ef, compression, alive):
    """The compressed sum over ``pod``, leaf by leaf, alive-gated: each
    rank feeds and updates its own pod's row of ``ef``."""
    slow = grid.data_axes[0]
    group = coll.axis_group(grid.mesh, slow)
    pod = grid.axis_index(slow)

    def leaf(x, e):
        row = e[pod]
        if not comp._compressible(x):
            return coll.psum(x, group), e
        if compression.top_k_frac is not None:
            out, new = coll.sparse_psum_ef(
                x, row, group, frac=compression.top_k_frac,
                bits=compression.bits,
                error_feedback=compression.error_feedback, alive=alive)
        elif compression.error_feedback:
            out, new = coll.quantized_psum_ef(x, row, group,
                                              bits=compression.bits,
                                              alive=alive)
        else:
            gated = torch.where(alive, x, torch.zeros_like(x))
            return coll.quantized_psum(gated, group,
                                       bits=compression.bits), e
        e = e.clone()
        e[pod] = new
        return out, e

    return comp._map_pairs(leaf, wire, ef)


def _stack(rows: list):
    return tree_map(lambda *xs: torch.stack(xs), *rows)


def survivor_runners(grid, local_fn: Callable, update_fn: Callable, *,
                     merge_every: int, compression=None) -> dict:
    """``{"runner", "round"}`` of the masked merge at cadence
    ``merge_every``.

    ``round(carry, data) -> (carry', metrics)`` runs one round over the
    carry ``(state, mask, ef)``: ``merge_plan.local_phase``'s
    ``merge_every`` local steps (partials scaled by the global
    ``n_vdpus``), then the masked merge; each metric leaf comes back
    with a leading axis of ``merge_every`` steps.
    ``runner(carry, data, length=L)`` runs ``L`` rounds and stacks the
    metrics ``(L, merge_every, ...)`` on the device, with no host
    synchronisation.
    """
    k = merge_every

    def lanes_phase(state, data, mask):
        """k local steps; (Σ m·s, Σ m·metric of each step, Σ m)."""
        lanes, per_step = mp.local_phase(grid, local_fn, update_fn, k,
                                         state, data)
        return (_wsum(lanes, mask), tuple(_wsum(m, mask) for m in per_step),
                mask.sum())

    if grid.mesh is None:
        def round_fn(carry, data):
            state, mask, ef = carry
            ssum, msum, n_local = lanes_phase(state, data, mask)
            n_s = torch.clamp(n_local, min=1.0)
            alive = n_local > 0
            wire = _wire_delta(ssum, state, n_local, n_s)
            if compression is None:
                delta = wire
            else:
                delta, ef = _gated_compress(wire, ef, compression, alive)
            metrics = _stack(list(_masked_mean(msum, n_s)))
            return (_apply_delta(state, delta), mask, ef), metrics
    else:
        group = coll.axis_group(grid.mesh, grid.data_axes[0])

        def round_fn(carry, data):
            state, mask, ef = carry
            part = lanes_phase(state, data, mask)
            ssum, msum, n_fast = grid.reduce(part, slow=False)
            n_s = torch.clamp(coll.psum(n_fast, group), min=1.0)
            alive = n_fast > 0
            wire = _wire_delta(ssum, state, n_fast, n_s)
            if compression is None:
                delta = coll.psum_tree(wire, group)
            else:
                delta, ef = _slow_hop_compressed(grid, wire, ef,
                                                 compression, alive)
            msum = coll.psum_tree(msum, group)
            metrics = _stack(list(_masked_mean(msum, n_s)))
            return (_apply_delta(state, delta), mask, ef), metrics

    def runner(carry, data, *, length: int):
        rows = []
        for _ in range(length):
            carry, metrics = round_fn(carry, data)
            rows.append(metrics)
        return carry, _stack(rows)

    return {"runner": runner, "round": round_fn}


def place_mask(grid, mask_host: np.ndarray) -> torch.Tensor:
    """The host mask ``(n_vdpus,)`` on the grid's device as float32: on
    a mesh this rank's block of lanes, ``[lo, lo + n_local)``."""
    lo = grid.shard_index * grid.n_local
    block = np.asarray(mask_host, np.float32)[lo:lo + grid.n_local]
    return torch.as_tensor(block, device=grid.device).clone()

