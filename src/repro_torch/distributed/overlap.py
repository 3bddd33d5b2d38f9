"""Compute/communication overlap — the paper's insight I5: the host merge
is tolerable when it overlaps the DPU compute.

Port of ``repro.distributed.overlap``:

* :func:`double_buffered_body` — across merge rounds: the round behind
  ``PimGrid.fit(overlap_merge=True)``.  The carry holds the live state
  and the previous round's un-reduced partials, so a round issues the
  merge of round *i* and the local compute of round *i+1*, which do not
  depend on each other.  The price is one round of staleness: the merge
  committed at round *i* was computed from round *i−1*'s state.  Here
  the two run in order on one stream; hiding the merge behind the
  compute is left to a later change.
* :func:`microbatched_grads` — within a step: gradient accumulation over
  microbatches, with an optional reduction per microbatch.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map


def double_buffered_body(merge_fn: Callable, compute_fn: Callable,
                         commit_fn: Callable) -> Callable:
    """The overlapped round over the carry ``(state, pending, ef, mom)``.

    ``merge_fn(pending, ef) -> (merged, ef')`` reduces the previous
    round's partials; ``compute_fn(state) -> (fresh, metrics | None)`` is
    this round's local compute and must not read the merge's output;
    ``commit_fn(state, merged, mom) -> (state', mom', metrics)`` applies
    the merged statistics through the outer optimizer's buffer ``mom``.
    Returns ``body(carry) -> (carry', metrics)``: the compute's metrics
    where it reports them (the cadence-k phase), else the commit's.  The
    merge is issued first, as in the JAX package."""
    def body(carry):
        state, pending, ef, mom = carry
        merged, ef = merge_fn(pending, ef)
        fresh, compute_metrics = compute_fn(state)
        new_state, mom, commit_metrics = commit_fn(state, merged, mom)
        metrics = (compute_metrics if compute_metrics is not None
                   else commit_metrics)
        return (new_state, fresh, ef, mom), metrics

    return body


def microbatched_grads(loss_fn: Callable, params: Any, batch: Any, *,
                       n_micro: int, reduce_fn: Optional[Callable] = None):
    """Gradient accumulation over ``n_micro`` microbatches.

    ``loss_fn(params, microbatch) -> (loss, metrics)`` on tensors;
    ``reduce_fn(grads) -> grads``, when given, reduces each
    microbatch's gradients as they come.  Every leaf of ``batch`` has a
    leading dim divisible by ``n_micro``.  Returns ``(mean loss, mean
    grads, None)``: float32 accumulators, scaled by ``1 / n_micro`` at
    the end, as in the JAX package.
    """
    def split(x):
        return x.reshape((n_micro, x.shape[0] // n_micro)
                         + tuple(x.shape[1:]))

    micro = tree_map(split, batch)
    gfn = torch.func.grad_and_value(lambda p, b: loss_fn(p, b)[0])
    dev = tree_leaves(params)[0].device
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    grad_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=dev), params)
    for i in range(n_micro):
        grads, loss = gfn(params, tree_map(lambda x: x[i], micro))
        if reduce_fn is not None:
            grads = reduce_fn(grads)
        grad_acc = tree_map(torch.add, grad_acc, grads)
        loss_acc = loss_acc + loss
    scale = 1.0 / n_micro
    return loss_acc * scale, tree_map(lambda g: g * scale, grad_acc), None
