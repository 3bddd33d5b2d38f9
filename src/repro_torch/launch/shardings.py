"""Parameter, optimizer, cache and batch placements from the logical
rules table, by the key paths of the state trees.

Port of ``repro/launch/shardings.py``.  JAX returns a tree of
``NamedSharding``s; the port returns a tree of DTensor placement tuples
(one ``Placement`` a mesh dim, :func:`tree_shardings`) from each leaf's
spec (:func:`leaf_spec`, JAX's ``PartitionSpec`` entries), and
:func:`distribute_tree` turns a tree of tensors into ``DTensor``s on the
rules' mesh.

Conventions (JAX's):

* a leaf's logical axes come from the last string key of its path
  (``_PARAM_AXES``, ``_CACHE_AXES``), disambiguated by ``ndim`` where
  needed (an MoE layer's 3-dim ``w_gate``/``w_up``/``w_down``);
* JAX stacks a scanned group's leaves with a leading repeat axis, which
  stays unsharded; the port keeps one dict a layer, so its leaves have no
  such axis and the same rule gives them JAX's spec without its leading
  ``None``;
* the optimizer state mirrors its parameter's spec (its ``m``, ``v`` and
  ``master`` trees end in the parameter names), so ZeRO falls out of the
  ``embed -> data`` FSDP rule;
* decode caches shard the sequence over ``model`` and the batch over the
  data axes;
* a dim whose size its mesh extent does not divide is replicated
  (``long_500k``'s batch of 1 cannot shard over ``data`` = 16).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

from repro_torch.distributed.sharding import LogicalRules, placements_of
from repro_torch.tree import tree_flatten_with_keys, tree_unflatten

# last key -> logical axes, disambiguated by ndim where needed
_PARAM_AXES = {
    # vocab over model only (JAX: sharding d over data too makes the
    # token gather rematerialise the table)
    "embed": ("vocab", None),
    "head": ("embed", "vocab"),
    "pos_emb": (None, "embed"),
    "wq": ("embed", "heads", None),
    "wk": ("embed", "kv_heads", None),
    "wv": ("embed", "kv_heads", None),
    "wo": ("heads", None, "embed"),
    "bq": ("heads", None),
    "bk": ("kv_heads", None),
    "bv": ("kv_heads", None),
    "w_down": ("ff", "embed"),
    "router": (None, None),
    "conv_w": (None, "lru"),
    "conv_b": ("lru",),
    "w_in": ("embed", None),
    "A_log": (None,),
    "dt_bias": (None,),
    "D": (None,),
    "norm_scale": ("lru",),
    "w_out": ("lru", "embed"),
    "w_x": ("embed", "lru"),
    "w_a": ("lru", None),
    "w_i": ("lru", None),
    "lambda": ("lru",),
    "b_a": ("lru",),
    "b_i": ("lru",),
    "b_up": ("ff",),
    "b_down": (None,),
    "scale": (None,),
    "bias": (None,),
}

_CACHE_AXES = {
    "k": ("batch", "kv_seq", "kv_heads", None),
    "v": ("batch", "kv_seq", "kv_heads", None),
    "conv": ("batch", None, "lru"),
    "ssm": ("batch", "heads", None, None),
    "h": ("batch", "lru"),
}


def _last_name(keys) -> str:
    return next((k for k in reversed(keys) if isinstance(k, str)), "")


def _fit(base, ndim: int) -> Tuple[Optional[str], ...]:
    """``base`` with leading ``None``s for stacked repeat axes, or cut to
    ``ndim``."""
    extra = ndim - len(base)
    if extra > 0:
        return (None,) * extra + tuple(base)
    return tuple(base[:ndim])


def param_axes(path, leaf) -> Tuple[Optional[str], ...]:
    """The logical axes of a parameter (or optimizer-state) leaf at key
    path ``path`` (``tree.tree_flatten_with_keys``)."""
    keys = list(path)
    name = _last_name(keys)
    if name in ("w_gate", "w_up"):
        base = ("experts", "embed", "ff") if leaf.ndim >= 3 and \
            "moe" in keys else ("embed", "ff")
    elif name == "w_down" and leaf.ndim >= 3 and "moe" in keys:
        base = ("experts", "ff", "embed")
    elif name in _PARAM_AXES:
        base = _PARAM_AXES[name]
    else:
        base = (None,) * leaf.ndim
    return _fit(base, leaf.ndim)


def cache_axes(path, leaf) -> Tuple[Optional[str], ...]:
    """The logical axes of a decode-cache leaf."""
    name = _last_name(list(path))
    base = _CACHE_AXES.get(name, ("batch",) + (None,) * (leaf.ndim - 1))
    return _fit(base, leaf.ndim)


def batch_axes(path, leaf) -> Tuple[Optional[str], ...]:
    """A batch leaf: its leading dim over the data axes."""
    return ("batch",) + (None,) * (leaf.ndim - 1)


def leaf_spec(rules: LogicalRules, axes, shape) -> tuple:
    """The spec of one leaf: ``rules.spec(*axes)`` with a dim its mesh
    extent does not divide (or beyond the leaf's rank) replicated."""
    spec = list(rules.spec(*axes))
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        if i >= len(shape) or shape[i] % rules.axis_size(ax):
            spec[i] = None
    return tuple(spec)


def tree_shardings(rules: LogicalRules, tree: Any, axes_fn: Callable
                   ) -> Any:
    """A tree of ``tree``'s structure holding each leaf's DTensor
    placements (one a mesh dim), after the divisibility fallback."""
    paths, leaves = tree_flatten_with_keys(tree)
    return tree_unflatten(tree, [
        placements_of(rules, leaf_spec(rules, axes_fn(p, leaf),
                                       tuple(leaf.shape)))
        for p, leaf in zip(paths, leaves)])


def param_shardings(rules: LogicalRules, params: Any) -> Any:
    return tree_shardings(rules, params, param_axes)


def opt_shardings(rules: LogicalRules, opt_state: Any) -> Any:
    """The optimizer state mirrors the parameters (its ``m``/``v``/
    ``master`` leaves' paths end in the parameter names)."""
    return tree_shardings(rules, opt_state, param_axes)


def cache_shardings(rules: LogicalRules, cache: Any) -> Any:
    return tree_shardings(rules, cache, cache_axes)


def batch_shardings(rules: LogicalRules, batch: Any) -> Any:
    return tree_shardings(rules, batch, batch_axes)


def distribute_tree(rules: LogicalRules, tree: Any, axes_fn: Callable
                    ) -> Any:
    """``tree`` with every tensor leaf a ``DTensor`` on ``rules.mesh``,
    placed as :func:`tree_shardings` says.  Every rank holds the same
    full tensors (one program a rank, the same seed) and keeps its own
    shard of them: no data moves (``src_data_rank=None``).  A leaf that
    already is a ``DTensor`` is redistributed.  ``requires_grad`` is
    kept."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    paths, leaves = tree_flatten_with_keys(tree)
    out = []
    for p, leaf in zip(paths, leaves):
        pl = placements_of(rules, leaf_spec(rules, axes_fn(p, leaf),
                                            tuple(leaf.shape)))
        if isinstance(leaf, DTensor):
            out.append(leaf.redistribute(rules.mesh, pl))
        else:
            out.append(distribute_tensor(leaf, rules.mesh, pl,
                                         src_data_rank=None))
    return tree_unflatten(tree, out)


def pin_to(tree: Any, like: Any) -> Any:
    """Each ``DTensor`` leaf of ``tree`` redistributed to the placements of
    the matching leaf of ``like`` (gradients to their parameters' storage
    layout, so that the optimizer's update runs there: a replicated
    gradient would drag the whole update replicated); plain leaves as
    they are."""
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import tree_map

    def pin(t, ref):
        if isinstance(t, DTensor) and tuple(t.placements) != \
                tuple(ref.placements):
            return t.redistribute(ref.device_mesh, ref.placements)
        return t

    return tree_map(pin, tree, like)
