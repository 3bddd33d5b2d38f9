"""MergePlan — the exact default merge plan.

Port of the default path of ``repro.distributed.merge_plan``: a plan is
a merge cadence ``k`` (local update steps per vDPU between merges).
``k = 1`` is the paper's merge-per-step loop; ``k > 1`` runs
:func:`cadence_round`.  The rest of the JAX module — the overlapped and
compressed merge pipeline, SlowMo and Nesterov outer optimizers,
adaptive cadence and ``"auto"`` — is not ported yet (ROADMAP queue A,
item 10) and raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable


_NOT_PORTED = ("is not ported to repro_torch yet (ROADMAP queue A, item 10: "
               "overlap, compression, SlowMo, Nesterov, adaptive cadence "
               "and 'auto'); only the exact default plan runs")


@dataclasses.dataclass(frozen=True)
class MergePlan:
    """``cadence``: local update steps per vDPU between merges."""

    cadence: int = 1

    def __post_init__(self):
        if self.cadence < 1:
            raise ValueError(
                f"MergePlan.cadence must be >= 1, got {self.cadence}")

    @classmethod
    def resolve(cls, merge_plan=None, *, merge_every: int = 1,
                overlap_merge: bool = False,
                merge_compression=None) -> "MergePlan":
        """The ``fit`` spellings as a plan: a given plan wins but must not
        be mixed with a non-default ``merge_every``."""
        if isinstance(merge_plan, str):
            raise NotImplementedError(f"merge_plan={merge_plan!r} "
                                      + _NOT_PORTED)
        if overlap_merge:
            raise NotImplementedError("overlap_merge " + _NOT_PORTED)
        if merge_compression is not None:
            raise NotImplementedError("merge_compression " + _NOT_PORTED)
        if merge_plan is not None:
            if not isinstance(merge_plan, cls):
                raise NotImplementedError(f"merge_plan={merge_plan!r} "
                                          + _NOT_PORTED)
            if merge_every != 1:
                raise ValueError("pass either merge_plan= or merge_every=, "
                                 "not both")
            return merge_plan
        return cls(cadence=merge_every)

    @property
    def is_exact_default(self) -> bool:
        """Every plan the port has is the exact default."""
        return True


def tree_map(fn: Callable, state):
    """``fn`` on every tensor of a state: a tensor, or a tuple of states
    (the minibatch sampler carries ``(state, counter)``)."""
    if isinstance(state, tuple):
        return tuple(tree_map(fn, s) for s in state)
    return fn(state)


def cadence_round(grid, local_fn: Callable, update_fn: Callable, k: int,
                  state, data: dict):
    """One exact merge round at cadence ``k``: every vDPU runs ``k`` local
    update steps on its own copy of ``state``, then the per-vDPU states
    and per-step metrics are averaged.

    Lanes are the leading batch dimension: ``local_fn`` gets the
    ``(L, ...)`` state (each tensor of a tuple state expanded alike) and
    returns per-lane partials, which are pre-scaled by ``n_vdpus`` so
    ``update_fn``'s global normalisation sees shard statistics at
    dataset magnitude (the local-SGD view), and the average is
    ``sum(dim=0) * (1.0 / n_vdpus)`` as in
    ``repro.distributed.merge_plan.cadence_round``.

    Returns ``(avg_state, [metrics of each local step])``.
    """
    scale = float(grid.n_vdpus)
    lanes = tree_map(lambda s: s.expand((grid.n_vdpus,) + tuple(s.shape)),
                     state)
    per_step = []
    for _ in range(k):
        part = {key: v * scale for key, v in local_fn(lanes, data).items()}
        lanes, metrics = update_fn(lanes, part)
        per_step.append(metrics)
    inv = 1.0 / scale
    return (tree_map(lambda s: s.sum(dim=0) * inv, lanes),
            [{key: v.sum(dim=0) * inv for key, v in m.items()}
             for m in per_step])
