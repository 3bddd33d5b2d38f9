"""Logical-axis sharding: one rules table maps model-space axis names to
mesh axes; models annotate activations with :func:`shard_hint` and the
launchers derive parameter, optimizer, cache and batch placements from
the same table (``launch.shardings``).

Port of ``repro/distributed/sharding.py``.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, and a
sharded tensor a ``DTensor``: where JAX's rules give a ``PartitionSpec``
(a mesh axis, a tuple of them, or ``None`` for each tensor dim),
:meth:`LogicalRules.placements` gives one DTensor ``Placement`` for each
mesh dim.  A tensor dim over a tuple of axes is ``Shard(i)`` on each of
those mesh dims, in the tuple's order (the first the outer split, as
JAX's ``P(("pod", "data"))`` is pod-major).

Axis vocabulary (JAX's):
  batch    — data-parallel batch            -> ("pod", "data")
  seq      — sequence, unsharded for training
  seq_act  — the residual stream between blocks -> "model"
  kv_seq   — a decode cache's sequence -> "model"
  embed    — d_model of a parameter (FSDP / ZeRO-3) -> the data axes
  heads    — query heads -> "model" when divisible, else replicated
  kv_heads — KV heads -> "model" when divisible, else replicated
  ff       — MLP hidden -> "model"
  experts  — MoE expert dim -> "model" (expert parallelism)
  vocab    — embedding/logit vocab -> "model"
  lru      — RG-LRU width / SSD inner channels -> "model"
  state    — SSM state dim -> replicated

The rules are a dict and a contextvar, so model code stays free of
meshes: with no rules active (every single-device path) :func:`shard_hint`
returns its input, and so does it for a tensor that is not a ``DTensor``.

While rules are active, :func:`use_rules` also turns on DTensor's
``implicit_replication``: a plain tensor that the model makes (positions,
masks, a float32 zero) meets the sharded state as a replicated one.

Example — the (1, 1) mesh of one process; heads of 14 replicate where
``model`` is 16 but shard where it is 1:

>>> import torch.distributed as dist
>>> from repro_torch.launch.mesh import make_host_mesh
>>> mesh = make_host_mesh(1, 1, device_type="cpu")
>>> rules = make_rules(mesh, n_heads=14, n_kv_heads=2)
>>> rules.spec("batch", "seq", "heads", None)
(('data',), None, 'model', None)
>>> rules.placements("embed", "vocab")      # one rank a mesh dim
(Replicate(), Replicate())
>>> dist.destroy_process_group()
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Mapping, Optional, Sequence

import torch

Axes = Optional[object]          # a mesh axis name, a tuple of them, None


@dataclasses.dataclass(frozen=True)
class LogicalRules:
    """``table``: logical axis -> mesh axis name, tuple of names or None,
    over ``mesh``'s named dims."""

    mesh: object                     # torch.distributed DeviceMesh
    table: Mapping[str, object]

    def spec(self, *logical_axes: Optional[str]) -> tuple:
        """For each tensor dim, its mesh axis, tuple of axes or None; a
        mesh axis is claimed at most once (a later dim asking for a taken
        axis is left unsharded on it), as JAX's ``PartitionSpec`` rule."""
        parts = []
        used: set = set()

        def claim(ax):
            if ax is None:
                return None
            if isinstance(ax, (tuple, list)):
                got = tuple(a for a in ax if a not in used)
                used.update(got)
                return got if got else None
            if ax in used:
                return None
            used.add(ax)
            return ax

        for name in logical_axes:
            ax = self.table.get(name) if name is not None else None
            parts.append(claim(ax))
        return tuple(parts)

    def axis_size(self, axes: Axes) -> int:
        """The number of shards ``axes`` (a name, tuple or None) make."""
        if axes is None:
            return 1
        if isinstance(axes, (tuple, list)):
            return math.prod(self.axis_size(a) for a in axes)
        return self.mesh.size(self.mesh_dim(axes))

    def mesh_dim(self, name: str) -> int:
        return list(self.mesh.mesh_dim_names).index(name)

    def placements(self, *logical_axes: Optional[str],
                   shape: Sequence[int] | None = None) -> tuple:
        """One DTensor placement for each mesh dim: ``Shard(i)`` where
        tensor dim ``i``'s spec names that mesh dim, ``Replicate()``
        elsewhere.  With ``shape``, a dim whose size the mesh extent does
        not divide is replicated, and logical axes beyond ``len(shape)``
        are dropped (:func:`shard_hint`'s fallbacks)."""
        return placements_of(self, self.spec(*logical_axes), shape)


def placements_of(rules: LogicalRules, spec: Sequence[Axes],
                  shape: Sequence[int] | None = None) -> tuple:
    """The DTensor placements of a spec (see
    :meth:`LogicalRules.placements`); ``Replicate`` on a mesh dim of one
    rank, whatever the spec names."""
    from torch.distributed.tensor import Replicate, Shard

    spec = list(spec)
    if shape is not None:
        spec = spec[:len(shape)]
        spec = [ax if ax is not None and shape[i] % rules.axis_size(ax) == 0
                else None for i, ax in enumerate(spec)]
    out = [Replicate()] * rules.mesh.ndim
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        for name in (ax if isinstance(ax, (tuple, list)) else (ax,)):
            d = rules.mesh_dim(name)
            # a mesh dim of one rank splits nothing (and DTensor's view
            # rules refuse to merge a size-1 dim split over it)
            if rules.mesh.size(d) > 1:
                out[d] = Shard(i)
    return tuple(out)


_RULES: contextvars.ContextVar[Optional[LogicalRules]] = \
    contextvars.ContextVar("repro_torch_sharding_rules", default=None)


def current_rules() -> Optional[LogicalRules]:
    return _RULES.get()


@contextlib.contextmanager
def use_rules(rules: Optional[LogicalRules]):
    """Make ``rules`` the active table within the block (``None``: no
    rules), with DTensor's implicit replication of plain tensors while a
    table is active."""
    tok = _RULES.set(rules)
    try:
        if rules is None:
            yield
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
    finally:
        _RULES.reset(tok)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


class _Hint(torch.autograd.Function):
    """Redistribute to ``pl`` forward, and the gradient to ``pl`` backward:
    the transpose of JAX's sharding constraint is the same constraint."""

    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        if tuple(x.placements) == pl:
            return x.view_as(x)
        return x.redistribute(x.device_mesh, pl)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.pl:
            g = g.redistribute(g.device_mesh, ctx.pl)
        return g, None


def shard_hint(x: torch.Tensor, *logical_axes: Optional[str]
               ) -> torch.Tensor:
    """``x`` redistributed to the layout its logical axes name under the
    active rules (JAX's ``with_sharding_constraint``), and its gradient
    redistributed to the same layout.  Returns ``x`` itself when no rules
    are active or ``x`` is not a ``DTensor``.  Axes beyond ``x.ndim`` are
    dropped and a dim that its mesh extent does not divide is replicated
    (a decode's seq of 1 cannot shard over 16)."""
    rules = _RULES.get()
    if rules is None or not is_dtensor(x):
        return x
    pl = rules.placements(*logical_axes, shape=tuple(x.shape))
    if not (torch.is_grad_enabled() and x.requires_grad):
        if tuple(x.placements) == pl:
            return x
        return x.redistribute(x.device_mesh, pl)
    return _Hint.apply(x, pl)


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the local tensor ``x`` over ``group``, whose result every
    member then uses whole (replicated): forward an all-reduce in ``x``'s
    dtype (a backend that refuses the dtype raises; nothing is cast),
    backward the identity, since each member's ``x`` enters the sum
    once.  For the insides of ``local_map`` (JAX's ``psum`` in a
    ``shard_map``)."""
    return _AllSum.apply(x, group)


def shard_coordinate(mesh, placements, dim: int) -> tuple:
    """``(index, count)``: which of the ``count`` pieces of tensor dim
    ``dim`` this rank holds under ``placements`` (the mesh dims sharding
    it, outer first)."""
    coord = mesh.get_coordinate()
    r, n = 0, 1
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            r = r * mesh.size(i) + coord[i]
            n *= mesh.size(i)
    return r, n


def map_heads(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """``fn(q, k, v)`` of ``DTensor``s, a rank at a time (``local_map``):
    attention of the model's ``q`` (B, Sq, H, D) over ``k``/``v`` (B,
    Skv, Kh, D), returning q's shape, with no dependence between heads.

    Under the active rules q's heads follow ``heads`` and k/v's follow
    ``kv_heads``, the batch the data axes, and the sequences and the head
    dim are whole (a dim its mesh extent does not divide is replicated, as
    :func:`shard_hint` does): where ``model`` does not divide the heads
    each rank runs all of them, and a decode cache sharded along its
    sequence is gathered (JAX's ``mha`` hints its keys so).  Where
    ``model`` divides the query heads but not the KV heads (qwen1.5-110b:
    64 and 8 over 16), each rank holds every KV head and attends with
    those of its own query heads' groups; the ranks' KV gradients then
    differ and are summed (``Partial``)."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    rules = _RULES.get()
    if rules is None:
        raise ValueError("attention of DTensors needs active sharding rules "
                         "(distributed.sharding.use_rules)")
    mesh = q.device_mesh
    q_pl = rules.placements("batch", None, "heads", None,
                            shape=tuple(q.shape))
    kv_pl = rules.placements("batch", None, "kv_heads", None,
                             shape=tuple(k.shape))
    H, Kh = q.shape[2], k.shape[2]
    r, h_ways = shard_coordinate(mesh, q_pl, 2)
    _, kv_ways = shard_coordinate(mesh, kv_pl, 2)
    grad_pl = kv_pl
    lo = hi = None
    if h_ways != kv_ways:
        if kv_ways != 1:
            raise ValueError(f"query heads in {h_ways} shards and KV heads "
                             f"in {kv_ways}: no GQA group is local")
        # this rank's query heads [r·Hl, (r+1)·Hl) read the KV heads
        # [r·Hl/G, ((r+1)·Hl − 1)/G]
        Hl, G = H // h_ways, H // Kh
        lo, hi = r * Hl // G, (r * Hl + Hl - 1) // G + 1
        if Hl % G and G % Hl:
            raise ValueError(f"{Hl} local query heads do not cover whole "
                             f"GQA groups of {G}")
        grad_pl = tuple(Partial() if pq.is_shard(2) else pk
                        for pq, pk in zip(q_pl, kv_pl))

    def local(ql, kl, vl):
        if lo is not None:
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return fn(ql, kl, vl)

    return local_map(local, out_placements=list(q_pl),
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, grad_pl, grad_pl),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def logical_to_spec(rules: Optional[LogicalRules],
                    axes: Sequence[Optional[str]]) -> Optional[tuple]:
    if rules is None:
        return None
    return rules.spec(*axes)


# ---------------------------------------------------------------------------
# default rule tables
# ---------------------------------------------------------------------------

def make_rules(mesh, *, n_heads: int, n_kv_heads: int,
               shard_seq_decode: bool = True,
               fsdp_params: bool = True) -> LogicalRules:
    """The per-arch rules table, JAX's entry for entry.  Head axes fall
    back to replication when ``model`` does not divide them (qwen2-0.5b's
    14 heads, whisper-tiny's 6, phi4-mini's 24, recurrentgemma's 10); the
    MLP, vocab and expert dims still shard over ``model`` there."""
    names = tuple(mesh.mesh_dim_names)
    msize = mesh.size(names.index("model"))
    dp_axes = tuple(a for a in ("pod", "data") if a in names)
    table = {
        "batch": dp_axes,
        "seq": None,
        # the sequence-parallel residual stream between blocks
        "seq_act": "model",
        "kv_seq": "model" if shard_seq_decode else None,
        # ZeRO/FSDP over the full data-parallel product (pod included)
        "embed": dp_axes if fsdp_params else None,
        "embed_act": None,
        "heads": "model" if n_heads % msize == 0 else None,
        "kv_heads": "model" if n_kv_heads % msize == 0 else None,
        "ff": "model",
        "experts": "model",
        "vocab": "model",
        "lru": "model",
        "state": None,
        "head_dim": None,
    }
    return LogicalRules(mesh=mesh, table=table)
