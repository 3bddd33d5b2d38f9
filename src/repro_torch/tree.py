"""Trees of tensors: the port's counterpart of ``jax.tree.map`` and
``jax.tree.leaves``.

A tree is a tensor, a tuple or named tuple of trees (a minibatch fit's
``(state, counter)``, an ``OptState``) or a dict of trees.  Dict leaves
are visited in sorted key order, as ``jax.tree.leaves`` visits them, so
a sum over the leaves adds in the reference's order.
"""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *matching leaves of rest)`` on every leaf of ``tree``;
    ``rest`` must have ``tree``'s structure."""
    if isinstance(tree, tuple):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list[Any]:
    """The leaves of ``tree`` in JAX's order."""
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves) -> Any:
    """A tree of ``tree``'s structure holding ``leaves``, given in
    :func:`tree_leaves`' order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, tuple):
            out = [build(x) for x in t]
            return type(t)(*out) if hasattr(t, "_fields") else tuple(out)
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        return next(it)

    return build(tree)
