"""Trees of tensors: the port's counterpart of ``jax.tree.map``,
``jax.tree.leaves`` and ``jax.tree_util.tree_flatten_with_path``
(:func:`tree_flatten_with_names`, :func:`tree_flatten_with_keys`).

A tree is a tensor, a tuple or named tuple of trees (a minibatch fit's
``(state, counter)``, an ``OptState``), a list of trees (an LM's
``"layers"``) or a dict of trees.  Dict leaves
are visited in sorted key order, as ``jax.tree.leaves`` visits them, so
a sum over the leaves adds in the reference's order.
"""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *matching leaves of rest)`` on every leaf of ``tree``;
    ``rest`` must have ``tree``'s structure."""
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return _rebuild(tree, out)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list[Any]:
    """The leaves of ``tree`` in JAX's order."""
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_flatten_with_names(tree) -> tuple[list[str], list[Any]]:
    """``(names, leaves)`` in :func:`tree_leaves`' order, each name the
    leaf's path as ``jax.tree_util.keystr`` spells it: ``['k']`` for a
    dict key, ``[i]`` for a tuple or list index, ``.field`` for a named tuple's
    field, and ``""`` for a bare leaf.  A checkpoint's manifest holds
    these names, so either package restores what the other wrote.

    >>> import torch
    >>> from repro_torch.optim.optimizers import OptState
    >>> tree = {"model": (torch.zeros(2), torch.zeros(())),
    ...         "merge_momentum": OptState(torch.zeros(()), torch.zeros(2))}
    >>> for name in tree_flatten_with_names(tree)[0]:
    ...     print(name)
    ['merge_momentum'].step
    ['merge_momentum'].inner
    ['model'][0]
    ['model'][1]
    """
    names: list[str] = []
    leaves: list[Any] = []
    _visit(tree, "", names, leaves)
    return names, leaves


# The walks below are module functions, not closures: a nested function
# that calls itself sits in a reference cycle (the function, its closure
# cell), which would keep what it reaches -- a training step's gradients
# -- alive until the cyclic garbage collector runs.

def _visit(t, path: str, names: list, leaves: list) -> None:
    if isinstance(t, (tuple, list)):
        fields = getattr(t, "_fields", None)
        for i, x in enumerate(t):
            _visit(x, f"{path}.{fields[i]}" if fields else f"{path}[{i}]",
                   names, leaves)
    elif isinstance(t, dict):
        for k in sorted(t):
            _visit(t[k], f"{path}[{k!r}]", names, leaves)
    else:
        names.append(path)
        leaves.append(t)


def tree_flatten_with_keys(tree) -> tuple[list[tuple], list[Any]]:
    """``(paths, leaves)`` in :func:`tree_leaves`' order, each path the
    tuple of keys from the root to the leaf as JAX's
    ``launch.shardings._path_keys`` reads a key path: a dict key, a tuple
    or list index, and ``None`` for a named tuple's field (JAX's
    ``GetAttrKey`` has neither a ``key`` nor an ``idx``).

    >>> import torch
    >>> from repro_torch.optim.optimizers import OptState
    >>> tree = {"layers": [{"wq": torch.zeros(2)}],
    ...         "opt": OptState(torch.zeros(()), {"m": torch.zeros(2)})}
    >>> tree_flatten_with_keys(tree)[0]
    [('layers', 0, 'wq'), ('opt', None), ('opt', None, 'm')]
    """
    paths: list[tuple] = []
    leaves: list[Any] = []
    _visit_keys(tree, (), paths, leaves)
    return paths, leaves


def _visit_keys(t, path: tuple, paths: list, leaves: list) -> None:
    if isinstance(t, (tuple, list)):
        named = hasattr(t, "_fields")
        for i, x in enumerate(t):
            _visit_keys(x, path + (None if named else i,), paths, leaves)
    elif isinstance(t, dict):
        for k in sorted(t):
            _visit_keys(t[k], path + (k,), paths, leaves)
    else:
        paths.append(path)
        leaves.append(t)


def tree_unflatten(tree, leaves) -> Any:
    """A tree of ``tree``'s structure holding ``leaves``, given in
    :func:`tree_leaves`' order."""
    return _build(tree, iter(leaves))


def _build(t, it):
    if isinstance(t, (tuple, list)):
        return _rebuild(t, [_build(x, it) for x in t])
    if isinstance(t, dict):
        built = {k: _build(t[k], it) for k in sorted(t)}
        return {k: built[k] for k in t}
    return next(it)


def _rebuild(node, children: list):
    """A node of ``node``'s kind (named tuple, tuple or list) holding
    ``children``."""
    if isinstance(node, list):
        return children
    return type(node)(*children) if hasattr(node, "_fields") \
        else tuple(children)
