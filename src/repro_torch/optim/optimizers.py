"""Minimal optax-style optimizers over trees of tensors.

Port of ``repro.optim.optimizers``.  A state is an :class:`OptState`:
the step, a 0-dim int32 tensor on the parameters' device, and a tree
mirroring the parameters (a tensor, or a tuple or dict of tensors).
Every update is out of place, so a state handed in (a ``merge_state``
holder's momentum) is never changed.  ``adamw`` keeps float32 master
weights when the parameters are bf16 (narrow compute, wide accumulator,
as the paper's insight I1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor
    inner: Any                     # optimizer-specific tree(s)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    update: Callable[[Any, OptState, Any], Tuple[Any, OptState]]
    # update(grads, state, params) -> (new_params, new_state)


def _cast_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return x.to(ref.dtype)


def _zero_step(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32,
                       device=leaves[0].device if leaves else None)


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def sgd(lr: float) -> Optimizer:
    def init(params):
        return OptState(_zero_step(params), ())

    def update(grads, state, params):
        new = tree_map(lambda p, g: p - _cast_like(lr * g.float(), p),
                       params, grads)
        return new, OptState(state.step + 1, ())

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return OptState(_zero_step(params), _zeros_f32(params))

    def update(grads, state, params):
        m = tree_map(lambda m_, g: beta * m_ + g.float(), state.inner, grads)
        new = tree_map(lambda p, m_: p - _cast_like(lr * m_, p), params, m)
        return new, OptState(state.step + 1, m)

    return Optimizer(init, update)


def nesterov(lr: float, beta: float = 0.9) -> Optimizer:
    """Nesterov accelerated momentum (the lookahead form):

        m ← β·m + g,   p ← p − lr·(g + β·m)

    With ``β = 0`` this is plain SGD.  The merge plan's ``Nesterov``
    outer optimizer feeds it the negated merge delta as the gradient
    (``distributed.merge_plan``).
    """

    def init(params):
        return OptState(_zero_step(params), _zeros_f32(params))

    def update(grads, state, params):
        g32 = tree_map(lambda g: g.float(), grads)
        m = tree_map(lambda m_, g: beta * m_ + g, state.inner, g32)
        new = tree_map(lambda p, g, m_: p - _cast_like(lr * (g + beta * m_),
                                                       p),
                       params, g32, m)
        return new, OptState(state.step + 1, m)

    return Optimizer(init, update)


def slow_momentum(outer_lr: float = 1.0, beta: float = 0.5) -> Optimizer:
    """SlowMo's outer optimizer (arXiv 1910.00643): momentum applied at
    merge boundaries rather than per step.

    The caller feeds the negated merge delta as the gradient
    (``g = anchor − avg``); the update is then

        m ← β·m + g,   anchor ← anchor − α·m

    which with ``β = 0, α = 1`` commits the plain average.  The arithmetic
    is :func:`momentum`'s; this name says what the merge plan's ``SlowMo``
    means by it.
    """
    return momentum(outer_lr, beta=beta)


def adamw(lr: float, *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          master_fp32: bool = True,
          grad_clip: Optional[float] = 1.0) -> Optimizer:
    """AdamW with an optional float32 master copy of low-precision
    parameters, and the gradients clipped to a global norm of
    ``grad_clip``."""

    def init(params):
        inner = {"m": _zeros_f32(params), "v": _zeros_f32(params)}
        if master_fp32:
            inner["master"] = tree_map(lambda p: p.float(), params)
        return OptState(_zero_step(params), inner)

    def update(grads, state, params):
        step = state.step + 1
        grads = tree_map(lambda g: g.float(), grads)
        if grad_clip is not None:
            gn = torch.sqrt(sum((g * g).sum() for g in tree_leaves(grads))
                            + 1e-12)
            scale = torch.clamp(grad_clip / gn, max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g,
                     state.inner["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g,
                     state.inner["v"], grads)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        base = state.inner.get("master", params) if master_fp32 else params

        def upd(p, m_, v_):
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return p.float() - lr * u

        new_master = tree_map(upd, base, m, v)
        new_params = tree_map(_cast_like, new_master, params)
        inner = {"m": m, "v": v}
        if master_fp32:
            inner["master"] = new_master
        return new_params, OptState(step, inner)

    return Optimizer(init, update)
