"""MergePlan — the merge side of the PIM engine as a composable object.

Port of ``repro.distributed.merge_plan``, on one device or on a mesh
(``core.pim.make_mesh_grid``).  A plan composes four choices:

    MergePlan(cadence     = vDPU-local steps between merges,
              overlap     = the merge behind the next round's compute,
              compression = what the host hop carries (None = exact),
              outer       = what happens at the merge boundary
                            (an OuterOptimizer))

``PimGrid.fit(merge_plan=...)`` is the entry point; ``merge_every=``,
``overlap_merge=`` and ``merge_compression=`` are thin constructors for
the same plan (:meth:`MergePlan.resolve`).  The exact default plan (any
cadence, the plain average) runs ``PimGrid.fit``'s own loop; every other
plan runs :func:`run_fit`.

Ported: the cadence, overlap, compression, the outer optimizers, and
the controller-driven plans: ``AdaptiveCadence`` and ``"auto"``
(``tuning.AutoTune``) run under ``tuning.controller.run_controlled_fit``,
which picks the cadence (and, under auto, the wire format and the
overlap) round by round on the host and records its decisions in
``merge_state["cadence_trace"]`` and ``["tuning_trace"]``.

DESIGN — outer optimizers (the merge-boundary commit)
-----------------------------------------------------

Every merge round produces a proposed delta: ``avg(lane states) − phase
start`` at cadence k, ``update_fn(state, merged) − state`` at cadence 1.
The ``OuterOptimizer`` decides how that delta commits:

* ``AverageCommit`` — ``state += delta``; the default plan, which never
  reaches :func:`run_fit`.
* ``SlowMo`` — slow momentum at merge boundaries (arXiv 1910.00643, the
  PIM-Opt outer loop): the negated delta is a pseudo-gradient for a
  momentum step, ``m ← β·m − delta``, ``state ← state − α·m``.
  ``β=0, α=1`` recovers the average up to float association.
* ``Nesterov`` — the lookahead variant: ``m ← β·m + g``, ``state ←
  state − α·(g + β·m)`` with ``g = −delta``.

The momentum buffer (an ``optim.OptState``, whose step counts commits)
rides in the round's carry and continues across ``fit`` calls through
``merge_state["momentum"]``.  A round is three pieces
(:func:`pipeline_fns`): ``compute_fn`` (the lanes' local work),
``merge_fn`` (the lane sum, compressed or not) and ``commit_fn(state,
merged, mom) -> (state', mom', metrics)``.

DESIGN — the overlapped and compressed merge
--------------------------------------------

Cadence amortises the merge, overlap hides it, compression shrinks it
(the paper's I5 and I1).

* ``overlap=True`` — the round carries a second buffer, the previous
  round's un-reduced partials (``overlap.double_buffered_body``): a
  round merges round *i*'s pending buffer and computes round *i+1*'s
  partials from the state, which do not depend on each other.  The
  price is one round of staleness.  A prologue (one real, uncommitted
  phase) primes the pending buffer.  At cadence 1 the first update is
  exact and the last fresh partials are dropped; at cadence k the
  commit is a delayed delta, ``anchor += avg(lanes) − start`` through
  the outer optimizer (a replacement commit would split the run into
  two half-rate chains), and a drain commits the last pending phase.
  A trailing ``steps % k`` round runs after the drain, not overlapped.
  Here the merge and the compute run in order on one stream.
* ``compression=CompressionConfig(...)`` — the lane-summed tree crosses
  the host hop compressed: float leaves quantized with error feedback,
  top-k sparsified when asked, integer leaves exact.  Without a mesh the
  hop is emulated (``compression.ef_compress_tree``); on a mesh the
  lane sum is all-reduced exactly over ``data`` and each pod's sum
  crosses ``pod`` through ``collectives.quantized_psum_ef``,
  ``sparse_psum_ef`` or ``quantized_psum``.  On the state wire top-k
  carries per-lane ``end − start`` (the delta wire), since a state's
  large entries are its large weights.  The error buffer has the JAX
  package's layout, a leading hop axis of one row a pod (``(1, ...)``
  without a mesh): every rank holds the whole ``(hop_size, ...)`` tree
  and updates its own pod's row, and at the end of a fit the rows are
  all-gathered over ``pod`` so the holder is the same on every rank.
  So a JAX ``merge_state["error"]`` carries over
  (``interop.error_from_numpy``).  The port sizes it at the first merge
  from the lane-summed tree (the partials at cadence 1, the state at
  cadence k), where JAX sizes it with ``jax.eval_shape``.  It continues
  across fits through ``merge_state["error"]``.

Carries: ``(state, ef, mom)``, and ``(state, pending, ef, mom)`` under
overlap; ``mom`` is ``()`` for plain commits, ``ef`` ``None`` without
compression.  On a grid without a mesh ``engine="scan"`` replays these
rounds as captured chunks (:func:`pipeline_runners`, ``core.graphs``);
the eager rounds of :func:`run_rounds` are the oracle they are held
against, and still run meshes (see ``core.pim``'s DESIGN notes).

Example — a SlowMo plan at cadence 4 converges on the problem the default
plan solves:

>>> import torch
>>> from repro_torch.core.pim import make_cpu_grid
>>> from repro_torch.distributed.merge_plan import MergePlan, SlowMo
>>> grid = make_cpu_grid(4)
>>> data, n = grid.shard_rows(torch.arange(8.0)[:, None])
>>> def local_fn(w, sl):
...     return {"g": ((w[..., None, :] - sl["X"])
...                   * sl["w"][..., None]).sum(-2)}
>>> def update_fn(w, merged):
...     return w - 0.1 * merged["g"] / n, {"g0": merged["g"][..., 0]}
>>> plan = MergePlan(cadence=4, outer=SlowMo(beta=0.5))
>>> w, hist = grid.fit(init_state=torch.zeros(1), local_fn=local_fn,
...                    update_fn=update_fn, data=data, steps=40,
...                    merge_plan=plan)
>>> len(hist)
40
>>> bool(abs(w[0] - 3.5) < 0.2)
True
"""

from __future__ import annotations

import dataclasses
import threading
import warnings
from typing import Any, Callable, Optional

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed import compression as comp
from repro_torch.distributed.overlap import double_buffered_body
from repro_torch.optim.optimizers import nesterov, slow_momentum
from repro_torch.tree import tree_leaves, tree_map


class MergeFallbackWarning(UserWarning):
    """A workload was asked for a merge-plan axis it cannot honour and
    ran at the exact default instead (the tree's discrete split commits
    cannot be averaged at cadence > 1)."""


def warn_fallback(algo: str, knobs: str, reason: str) -> None:
    """The structured fallback warning, once per ``fit`` call."""
    warnings.warn(
        f"{algo}: {knobs} requested but not honoured — {reason}; "
        f"running exact merge-per-step semantics instead",
        MergeFallbackWarning, stacklevel=3)


# -- the grid's cache ----------------------------------------------------

_CACHE_MAX = 32
# one lock for every grid's cache: a lookup reorders the LRU (pop, then
# put back), which another thread's lookup must not see half done
CACHE_LOCK = threading.RLock()


def fn_signature(fn) -> tuple:
    """Cache key of a step function: its code and its closure's contents
    (primitives, tuples, string-keyed dicts and hashable frozen
    dataclasses by value, anything else by identity), as in the JAX
    package.  ``train_*`` re-creates its closures on every call; two with
    the same code and captured values share a key.  The cache keeps the
    functions beside the entry, so an identity in a key is not reused
    while the entry lives."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return (fn,)

    def value_key(v):
        if isinstance(v, (int, float, bool, str, bytes, type(None))):
            return v
        if isinstance(v, tuple):
            return tuple(value_key(x) for x in v)
        if isinstance(v, dict):
            try:
                items = sorted(v.items(), key=lambda kv: kv[0])
            except TypeError:
                return id(v)
            return ("dict",) + tuple((k, value_key(x)) for k, x in items)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            try:
                hash(v)
            except TypeError:
                return id(v)
            return v
        return id(v)

    cells = ()
    if fn.__closure__:
        cells = tuple(value_key(c.cell_contents) for c in fn.__closure__)
    defaults = tuple(value_key(v) for v in (fn.__defaults__ or ()))
    kwdefaults = tuple(sorted(
        (k, value_key(v)) for k, v in (fn.__kwdefaults__ or {}).items()))
    return (code, cells, defaults, kwdefaults)


def cache_get(grid, key):
    """Look ``key`` up in the grid's cache (``PimGrid._tuning_cache``),
    most recently used last."""
    with CACHE_LOCK:
        entry = grid._tuning_cache.get(key)
        if entry is None:
            return None
        grid._tuning_cache[key] = grid._tuning_cache.pop(key)
    return entry[0]


def _kind(key) -> Any:
    """An entry's kind: the key's first element when it names one
    (``"fit_runner"``, ``"serving"``, ``"tuning_cost_model"``, ...)."""
    if isinstance(key, tuple) and key and isinstance(key[0], str):
        return key[0]
    return None


def cache_put(grid, key, value, local_fn, update_fn) -> None:
    """Insert into the grid's cache, dropping the least recently used
    entry of the key's kind past ``_CACHE_MAX`` of them: each kind has
    its own budget, so fits capturing new chunk runners never evict a
    server's hot bucket graphs, nor the reverse.  The functions ride
    along so the identities in ``key`` stay alive."""
    with CACHE_LOCK:
        cache = grid._tuning_cache
        kind = _kind(key)
        same = [k for k in cache if _kind(k) == kind]
        while len(same) >= _CACHE_MAX:
            cache.pop(same.pop(0))
        cache[key] = (value, local_fn, update_fn)


# -- outer optimizers --------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OuterOptimizer:
    """What happens at a merge boundary: ``commit`` folds the merged
    delta into the anchor state, optionally through a buffer that rides
    in the round's carry (``init`` builds it; ``()`` means stateless).

    ``plain_commit`` marks optimizers whose commit is exactly ``anchor +
    delta`` with no buffer: :func:`run_fit` keeps the engine's own commit
    expressions for those and never calls ``commit``.  A subclass that
    overrides ``commit`` is marked ``plain_commit = False`` unless it
    says otherwise, so a custom commit cannot be skipped unnoticed.
    """

    plain_commit = True

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if "commit" in cls.__dict__ and "plain_commit" not in cls.__dict__:
            cls.plain_commit = False

    def init(self, state: Any) -> Any:
        return ()

    def commit(self, anchor: Any, delta: Any, buf: Any):
        return tree_map(lambda a, d: a + d, anchor, delta), buf


@dataclasses.dataclass(frozen=True)
class AverageCommit(OuterOptimizer):
    """Commit the averaged (cadence k) or updated (cadence 1) state as it
    is: the exact default plan."""


@dataclasses.dataclass(frozen=True)
class SlowMo(OuterOptimizer):
    """Slow momentum at merge boundaries (SlowMo, arXiv 1910.00643): the
    merge delta is the negated pseudo-gradient of a momentum step with
    slow learning rate ``outer_lr`` and momentum ``beta``
    (``optim.slow_momentum``).  The buffer is float32, shaped like the
    state, and steps once per merge round."""

    beta: float = 0.5
    outer_lr: float = 1.0

    plain_commit = False

    def init(self, state: Any) -> Any:
        return slow_momentum(self.outer_lr, beta=self.beta).init(state)

    def commit(self, anchor: Any, delta: Any, buf: Any):
        pseudo_grad = tree_map(torch.neg, delta)
        return slow_momentum(self.outer_lr, beta=self.beta).update(
            pseudo_grad, buf, anchor)


@dataclasses.dataclass(frozen=True)
class Nesterov(OuterOptimizer):
    """Nesterov momentum at merge boundaries, the lookahead variant of
    :class:`SlowMo` (``optim.nesterov`` fed ``g = −delta``):

        m ← β·m + g,   state ← state − α·(g + β·m)

    ``β=0, α=1`` recovers the plain average."""

    beta: float = 0.5
    outer_lr: float = 1.0

    plain_commit = False

    def init(self, state: Any) -> Any:
        return nesterov(self.outer_lr, beta=self.beta).init(state)

    def commit(self, anchor: Any, delta: Any, buf: Any):
        pseudo_grad = tree_map(torch.neg, delta)
        return nesterov(self.outer_lr, beta=self.beta).update(
            pseudo_grad, buf, anchor)


@dataclasses.dataclass(frozen=True)
class AdaptiveCadence(OuterOptimizer):
    """Host-side cadence adaptation: start at the plan's ``cadence`` and
    grow ``k`` by ``growth`` (up to ``k_max``) once the norms of
    ``patience + 1`` successive merged deltas agree within
    ``stable_ratio`` relative change; the commit is the plain average.

    A preset over ``tuning.PlanController``: the wire stays the plan's
    ``compression`` and only the cadence moves.  With ``shrink=True`` a
    delta-norm spike past ``spike_ratio`` × the previous norm halves
    ``k`` toward ``k_min``.  For a controller that picks the wire too,
    use ``merge_plan="auto"`` (``tuning.AutoTune``)."""

    k_max: int = 16
    growth: int = 2
    stable_ratio: float = 0.5
    patience: int = 2
    shrink: bool = False
    spike_ratio: float = 4.0
    k_min: int = 1

    # the controlled-fit driver reads these; the wire is pinned, so there
    # is nothing to explore or hold for
    explore_rounds = 0
    min_steps_to_explore = 0
    hold_rounds = 1

    def __post_init__(self):
        if self.k_max < 1 or self.growth < 2:
            raise ValueError(
                f"AdaptiveCadence needs k_max >= 1 and growth >= 2, got "
                f"k_max={self.k_max} growth={self.growth}")
        if not 1 <= self.k_min <= self.k_max:
            raise ValueError(
                f"AdaptiveCadence needs 1 <= k_min <= k_max, got "
                f"k_min={self.k_min} k_max={self.k_max}")
        if self.spike_ratio <= 1.0:
            raise ValueError(
                f"AdaptiveCadence.spike_ratio must be > 1, got "
                f"{self.spike_ratio}")


# -- the plan ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MergePlan:
    """cadence × overlap × compression × outer (see the module
    docstring).  Hashable."""

    cadence: int = 1
    overlap: bool = False
    compression: Optional[comp.CompressionConfig] = None
    outer: OuterOptimizer = AverageCommit()

    def __post_init__(self):
        if self.cadence < 1:
            raise ValueError(
                f"MergePlan.cadence must be >= 1, got {self.cadence}")
        if not isinstance(self.outer, OuterOptimizer):
            raise ValueError(
                f"MergePlan.outer must be an OuterOptimizer, got "
                f"{self.outer!r}")
        if (self.adaptive or self.auto) and self.overlap:
            raise ValueError(
                "controller-driven plans (AdaptiveCadence / auto) "
                "cannot be combined with overlap=True: the controller "
                "re-decides k per round on the host, the overlap "
                "pipeline's pending buffer is shaped per-k")

    @classmethod
    def from_legacy(cls, *, merge_every: int = 1,
                    overlap_merge: bool = False,
                    merge_compression=None) -> "MergePlan":
        """The legacy ``fit`` kwargs as a plan."""
        return cls(cadence=merge_every, overlap=bool(overlap_merge),
                   compression=merge_compression)

    @classmethod
    def resolve(cls, merge_plan=None, *, merge_every: int = 1,
                overlap_merge: bool = False,
                merge_compression=None) -> "MergePlan":
        """The one rule for the ``fit`` spellings: a given plan wins but
        must not be mixed with non-default legacy kwargs; otherwise the
        kwargs build the plan.  The string ``"auto"`` is
        ``tuning.auto_plan()``, the self-tuning preset."""
        if isinstance(merge_plan, str):
            if merge_plan != "auto":
                raise ValueError(
                    f"unknown merge_plan spelling {merge_plan!r}: the "
                    f"only string form is 'auto' (or pass a MergePlan)")
            from repro_torch.tuning import auto_plan
            merge_plan = auto_plan()
        if merge_plan is not None:
            if merge_every != 1 or overlap_merge or \
                    merge_compression is not None:
                raise ValueError(
                    "pass either merge_plan= or the legacy kwargs "
                    "(merge_every / overlap_merge / merge_compression), "
                    "not both")
            return merge_plan
        return cls.from_legacy(merge_every=merge_every,
                               overlap_merge=overlap_merge,
                               merge_compression=merge_compression)

    @property
    def adaptive(self) -> bool:
        return isinstance(self.outer, AdaptiveCadence)

    @property
    def auto(self) -> bool:
        """Whether the outer is the ``tuning.AutoTune`` preset (read off
        the class, so this module does not import ``tuning``)."""
        return bool(getattr(self.outer, "is_auto", False))

    @property
    def is_exact_default(self) -> bool:
        """Plans served by ``PimGrid.fit``'s own loop: any cadence, no
        overlap, no compression, the plain average."""
        return (not self.overlap and self.compression is None
                and type(self.outer) is AverageCommit)

    def describe(self) -> str:
        parts = [f"cadence={self.cadence}"]
        if self.overlap:
            parts.append("overlap")
        if self.compression is not None:
            parts.append(f"compression={self.compression!r}")
        if type(self.outer) is not AverageCommit:
            parts.append(f"outer={self.outer!r}")
        return "MergePlan(" + ", ".join(parts) + ")"


# -- rounds --------------------------------------------------------------


def lane_sum(tree, *, scale: float | None = None):
    """``collectives.lane_sum``: each leaf summed over its leading lane
    dim, ``scale`` folded into the summands."""
    return coll.lane_sum(tree, scale=scale)


def local_phase(grid, local_fn: Callable, update_fn: Callable, k: int,
                state, data: dict):
    """``k`` local update steps per vDPU, each on its own copy of
    ``state``: returns the per-lane end states and each step's per-lane
    metrics.

    Lanes are the leading batch dimension: ``local_fn`` gets the
    ``(L, ...)`` state (each tensor of a tuple state expanded alike) and
    returns per-lane partials, which are pre-scaled by the global
    ``n_vdpus`` so ``update_fn``'s global normalisation sees shard
    statistics at dataset magnitude (the local-SGD view).  On a mesh the
    lanes are this rank's ``n_local``."""
    scale = float(grid.n_vdpus)
    lanes = tree_map(lambda s: s.expand((grid.n_local,) + tuple(s.shape)),
                     state)
    per_step = []
    for _ in range(k):
        part = {key: v * scale for key, v in local_fn(lanes, data).items()}
        lanes, metrics = update_fn(lanes, part)
        per_step.append(metrics)
    return lanes, per_step


def cadence_round(grid, local_fn: Callable, update_fn: Callable, k: int,
                  state, data: dict):
    """One exact merge round at cadence ``k`` (the default plan):
    :func:`local_phase`, then the lane states and per-step metrics summed
    over the lanes (on a mesh then over ``data`` and ``pod``) and scaled
    by ``1.0 / n_vdpus``, as in
    ``repro.distributed.merge_plan.cadence_round``.

    Returns ``(avg_state, [metrics of each local step])``.
    """
    lanes, per_step = local_phase(grid, local_fn, update_fn, k, state, data)
    inv = 1.0 / float(grid.n_vdpus)
    states, metrics = grid.reduce(
        (lane_sum(lanes), tuple(lane_sum(m) for m in per_step)))
    return (tree_map(lambda s: s * inv, states),
            [{key: v * inv for key, v in m.items()} for m in metrics])


# -- the wire and the round pieces ---------------------------------------


def hop_size(grid) -> int:
    """Participants on the compressible slow hop: the size of the mesh's
    first data axis (``pod``), 1 without a mesh.  The error buffer
    carries one row a participant on its leading axis."""
    if grid.mesh is None:
        return 1
    return int(grid.mesh.shape[0])


def init_merge_error(grid, wire: Any) -> Any:
    """A zero error buffer for a wire tree (tensors whose shapes and
    dtypes cross the hop): ``(hop_size, ...)`` a leaf, in the leaf's
    dtype, as the JAX package lays it out."""
    hop = hop_size(grid)
    return tree_map(lambda x: torch.zeros((hop,) + tuple(x.shape),
                                          dtype=x.dtype, device=x.device),
                    wire)


def gather_merge_error(grid, ef: Any) -> Any:
    """The error buffer as every rank holds it after a fit: each pod's row
    from that pod's ranks, all-gathered over ``pod`` (a rank updates
    only its own pod's row during the fit).  Without a mesh, or at a hop
    of one, the buffer itself."""
    if ef is None or hop_size(grid) == 1:
        return ef
    group = coll.axis_group(grid.mesh, grid.data_axes[0])
    pod = grid.axis_index(grid.data_axes[0])
    return tree_map(lambda e: coll.gather_rows(e[pod], group), ef)


def _slow_hop(grid, part: Any, ef: Any, compression) -> tuple:
    """This pod's sum across ``pod`` through
    ``compression.compressed_reduce`` (which owns the wire's leaf
    policy), fed this pod's row of ``ef``; the row comes back as the
    leaf's new error.  Returns ``(merged, ef')``."""
    slow = grid.data_axes[0]
    pod = grid.axis_index(slow)
    rows = tree_map(lambda e: e[pod], ef)
    merged, new_rows = comp.compressed_reduce(
        part, rows, dataclasses.replace(compression, slow_axis=slow,
                                        fast_axes=()), mesh=grid.mesh)

    def put(e, row, ne):
        if ne is row:
            return e
        out = e.to(ne.dtype).clone()
        out[pod] = ne
        return out

    return merged, tree_map(put, ef, rows, new_rows)


def merge_pending(grid, pending: Any, ef: Any, compression,
                  scale: float | None):
    """Reduce a per-lane tree: the lane sum (``scale`` folded in), on a
    mesh then the exact sums over the fast axes, then the host hop: the
    exact sum over ``pod``, or with ``compression`` the compressed one
    (without a mesh ``compression.ef_compress_tree`` on the buffer's one
    hop row, on a mesh the collectives of ``_slow_hop``).  ``ef`` of
    ``None`` is sized here from the lane-summed tree.  Returns
    ``(merged, ef')``."""
    part = lane_sum(pending, scale=scale)
    if compression is None:
        return grid.reduce(part), ef
    part = grid.reduce(part, slow=False)
    if ef is None:
        ef = init_merge_error(grid, part)
    hop = hop_size(grid)
    for e in tree_leaves(ef):
        if e.shape[0] != hop:
            raise ValueError(
                f"the error buffer has {e.shape[0]} hop rows, the grid's "
                f"slow hop {hop} participants")
    if grid.mesh is not None:
        return _slow_hop(grid, part, ef, compression)
    merged, new = comp.ef_compress_tree(
        part, tree_map(lambda e: e[0], ef), compression)
    return merged, tree_map(lambda e: e[None], new)


def pipeline_fns(grid, local_fn: Callable, update_fn: Callable, *,
                 merge_every: int, compression, state_wire: bool,
                 outer: OuterOptimizer):
    """The pieces :func:`run_fit` assembles a round from:
    ``(merge_fn, compute_fn, commit_fn, prologue)``.

    * partials wire (cadence 1, ``state_wire=False``): ``compute_fn`` is
      the lanes' ``local_fn``, ``merge_fn`` their (compressed) sum, and
      the commit applies ``update_fn`` (metrics come from the merged
      partials) and threads the proposed delta through ``outer``.
    * state wire (cadence k, and a cadence-k plan's trailing round of
      any length): ``compute_fn`` runs a ``merge_every``-step
      :func:`local_phase` and averages each step's metrics over the
      lanes exactly; the wire carries ``(lane end states, phase start)``,
      the merge averages the end states (on the delta wire under top-k:
      ``start + avg(end − start)``), and the commit folds ``avg −
      start`` into the anchor through ``outer``, the delayed-delta commit
      the overlap needs.

    ``merge_fn(pending, ef) -> (merged, ef)``, ``commit_fn(state, merged,
    mom) -> (state', mom', metrics)``, and ``prologue(state, data)`` the
    overlap's first, uncommitted compute.
    """
    if not state_wire:
        def compute_fn(state, data):
            return local_fn(state, data), None

        def merge_fn(pending, ef):
            return merge_pending(grid, pending, ef, compression, None)

        def commit_fn(state, merged, mom):
            proposed, metrics = update_fn(state, merged)
            if outer.plain_commit:
                return proposed, mom, metrics
            delta = tree_map(torch.sub, proposed, state)
            new, mom = outer.commit(state, delta, mom)
            return new, mom, metrics

        return merge_fn, compute_fn, commit_fn, compute_fn

    inv = 1.0 / float(grid.n_vdpus)

    def compute_fn(state, data):
        lanes, per_step = local_phase(grid, local_fn, update_fn,
                                      merge_every, state, data)
        # every step's metrics in one reduction (one collective a dtype)
        return (lanes, state), list(grid.reduce(
            tuple(lane_sum(m, scale=inv) for m in per_step)))

    # top-k of a state zeroes most of the model every merge; a local
    # phase's delta is what sparsified local SGD sends.  The error buffer
    # stays state-shaped (deltas are congruent with states).
    delta_wire = (compression is not None
                  and compression.top_k_frac is not None)

    def merge_fn(pending, ef):
        lanes, start = pending
        if delta_wire:
            lanes = tree_map(torch.sub, lanes, start)
        avg, ef = merge_pending(grid, lanes, ef, compression, inv)
        if delta_wire:
            avg = tree_map(torch.add, start, avg)
        return (avg, start), ef

    def commit_fn(state, merged, mom):
        avg, start = merged
        if outer.plain_commit:
            new = tree_map(lambda s, a, st: s + (a - st), state, avg, start)
            return new, mom, None
        delta = tree_map(torch.sub, avg, start)
        new, mom = outer.commit(state, delta, mom)
        return new, mom, None

    return merge_fn, compute_fn, commit_fn, compute_fn


def plain_round(fns: tuple, data: dict, carry, *, state_wire: bool):
    """One round of :func:`pipeline_fns`' pieces ``fns`` over the carry
    ``(state, ef, mom)``: compute, merge, commit.  Returns ``(carry',
    [metrics of each local step])``."""
    merge_fn, compute_fn, commit_fn, _ = fns
    state, ef, mom = carry
    fresh, compute_metrics = compute_fn(state, data)
    merged, ef = merge_fn(fresh, ef)
    state, mom, commit_metrics = commit_fn(state, merged, mom)
    return (state, ef, mom), (compute_metrics if state_wire
                              else [commit_metrics])


def overlapped_body(fns: tuple, data: dict) -> Callable:
    """The overlapped round of ``fns`` over the carry ``(state, pending,
    ef, mom)`` (``overlap.double_buffered_body``); the prologue that
    primes ``pending`` is ``fns[3](state, data)[0]``."""
    merge_fn, compute_fn, commit_fn, _ = fns
    return double_buffered_body(merge_fn, lambda st: compute_fn(st, data),
                                commit_fn)


def drain(fns: tuple, carry, *, state_wire: bool):
    """End an overlapped carry ``(state, pending, ef, mom)``: commit the
    last pending phase on the state wire; at cadence 1 (the partials
    wire) the last fresh partials are dropped.  Returns ``(state, ef,
    mom)``."""
    state, pending, ef, mom = carry
    if state_wire and pending is not None:
        merge_fn, _, commit_fn, _ = fns
        merged, ef = merge_fn(pending, ef)
        state, mom, _ = commit_fn(state, merged, mom)
    return state, ef, mom


def run_rounds(steps: int, k: int, round_fn: Callable, state, *,
               engine: str, scan_chunk: int, callback: Optional[Callable]):
    """Drive ``steps`` local steps as rounds of ``k`` and a trailing round
    of ``steps % k``: ``round_fn(state, kk) -> (state, [metrics of each of
    its kk steps])``.  Metrics reach the host after every round
    (``engine="python"``) or every ``scan_chunk`` rounds (``"scan"``), one
    transfer per key; a callback sees the state at that point.  Returns
    ``(state, history)``."""
    per_sync = 1 if engine == "python" else scan_chunk
    history: list = []
    done, rounds, pending = 0, 0, []
    while done < steps:
        kk = min(k, steps - done)
        state, metrics = round_fn(state, kk)
        pending.extend(metrics)
        done += kk
        rounds += 1
        if rounds == per_sync or done >= steps:
            flush_metrics(pending, history, state, callback)
            rounds, pending = 0, []
    return state, history


def flush_metrics(pending: list, history: list, state, callback) -> None:
    """Bring the pending steps' metrics to the host in one transfer per
    key and append them to ``history``."""
    if not pending:
        return
    host = {key: torch.stack([m[key] for m in pending]).cpu()
            for key in pending[0]}
    for i in range(len(pending)):
        metrics = {key: v[i] for key, v in host.items()}
        history.append(metrics)
        if callback is not None:
            callback(len(history) - 1, state, metrics)


def flush_stacked(stacked: dict, rounds: int, k: int, nested: bool,
                  history: list, state, callback) -> None:
    """A chunk's stacked metrics (a chunk runner's: ``(rounds, ...)``,
    ``(rounds, k, ...)`` when ``nested``) to the host in one transfer per
    key, one ``history`` entry a local step; a callback sees ``state``,
    the end-of-chunk state."""
    host = {key: v.cpu() for key, v in stacked.items()}
    for r in range(rounds):
        for j in range(k if nested else 1):
            metrics = {key: v[r, j] if nested else v[r]
                       for key, v in host.items()}
            history.append(metrics)
            if callback is not None:
                callback(len(history) - 1, state, metrics)


def replay_rounds(runner, carry, data, rounds: int, k: int, nested: bool,
                  scan_chunk: int, history: list, callback,
                  state_of: Callable = lambda carry: carry):
    """``rounds`` rounds of a chunk runner (``core.graphs.ChunkRunner``)
    in chunks of ``scan_chunk``, each chunk's metrics flushed into
    ``history`` (:func:`flush_stacked`; a callback sees
    ``state_of(carry)``).  Returns the runner's live carry."""
    done = 0
    while done < rounds:
        length = min(scan_chunk, rounds - done)
        carry, stacked = runner(carry, data, length=length)
        flush_stacked(stacked, length, k, nested, history, state_of(carry),
                      callback)
        done += length
    return carry


def _clone(tree):
    return tree_map(lambda t: None if t is None else t.clone(), tree)


def pipeline_runners(grid, local_fn: Callable, update_fn: Callable, *,
                     merge_every: int, overlap: bool, compression,
                     state_wire: bool,
                     outer: OuterOptimizer = AverageCommit()) -> dict:
    """The cached pieces of one overlap x compression x outer mode, the
    counterpart of ``repro.distributed.merge_plan.pipeline_runners``:
    ``"runner"``, a ``core.graphs.ChunkRunner`` of the mode's rounds
    over the carry ``(state, ef, mom)`` (``(state, pending, ef, mom)``
    under overlap), one captured graph a (data binding, chunk length) on
    the card, metrics ``(L, ...)`` on the partials wire and ``(L, k,
    ...)`` on the state wire; ``"round"``, one eager round of the same
    pieces; under overlap ``"prologue"`` (``prologue(state, data) ->
    pending``) and ``"drain"`` (``drain(carry) -> (state, ef, mom)``),
    eager, once a fit.

    Keyed on the grid as JAX keys it: the ``fn_signature`` of both
    functions, the kernel flag, the cadence, ``overlap``,
    ``compression``, ``state_wire`` and ``outer``.  ``mom`` is ``()`` for
    plain commits; an ``ef`` of ``None`` under compression is sized by
    the runner's warm-up round and starts as zeros, as
    :func:`merge_pending` sizes it at the first merge."""
    from repro_torch.core.graphs import ChunkRunner
    from repro_torch.kernels import dispatch as _dispatch

    key = ("fit_runner", fn_signature(local_fn), fn_signature(update_fn),
           _dispatch.kernels_enabled(), merge_every, overlap, compression,
           state_wire, outer)
    with CACHE_LOCK:
        cached = cache_get(grid, key)
        if cached is not None:
            return cached
        fns = pipeline_fns(grid, local_fn, update_fn,
                           merge_every=merge_every, compression=compression,
                           state_wire=state_wire, outer=outer)
        if overlap:
            def round_fn(carry, data):
                return overlapped_body(fns, data)(carry)

            runners = {
                "round": round_fn,
                "prologue": lambda state, data: fns[3](state, data)[0],
                "drain": lambda carry: drain(fns, carry,
                                             state_wire=state_wire)}
        else:
            def round_fn(carry, data):
                carry, metrics = plain_round(fns, data, carry,
                                             state_wire=state_wire)
                return carry, metrics if state_wire else metrics[0]

            runners = {"round": round_fn}
        runners["runner"] = ChunkRunner(round_fn, grid.device)
        cache_put(grid, key, runners, local_fn, update_fn)
        return runners


def _fit_chunks(grid, plan: MergePlan, state, ef, mom, *, local_fn,
                update_fn, data, steps: int, callback, scan_chunk: int):
    """:func:`run_fit`'s rounds on :func:`pipeline_runners`' chunk
    runners: full rounds in chunks of ``scan_chunk`` (the overlap's
    prologue before them and its drain after), then a trailing ``steps %
    k`` round on the state wire, not overlapped.  Returns ``(state, ef,
    mom, history)``, cloned out of the runners' carries."""
    k = plan.cadence
    state_wire = k > 1
    history: list = []
    if steps <= 0:
        return state, ef, mom, history
    rounds, rem = divmod(steps, k)
    if rounds:
        rs = pipeline_runners(grid, local_fn, update_fn, merge_every=k,
                              overlap=plan.overlap,
                              compression=plan.compression,
                              state_wire=state_wire, outer=plan.outer)
        carry = ((state, rs["prologue"](state, data), ef, mom)
                 if plan.overlap else (state, ef, mom))
        carry = replay_rounds(rs["runner"], carry, data, rounds, k,
                              state_wire, scan_chunk, history, callback,
                              lambda c: c[0])
        state, ef, mom = rs["drain"](carry) if plan.overlap else carry
    if rem:
        rs = pipeline_runners(grid, local_fn, update_fn, merge_every=rem,
                              overlap=False, compression=plan.compression,
                              state_wire=True, outer=plan.outer)
        state, ef, mom = replay_rounds(rs["runner"], (state, ef, mom), data,
                                       1, rem, True, 1, history, callback,
                                       lambda c: c[0])
    return _clone(state), _clone(ef), _clone(mom), history


def run_fit(grid, plan: MergePlan, *, init_state, local_fn: Callable,
            update_fn: Callable, data: dict, steps: int,
            callback: Optional[Callable], scan_chunk: int, engine: str,
            merge_state: Optional[dict], compiled: bool = False):
    """``PimGrid.fit``'s loop for every plan that is not the exact
    default.  Returns ``(state, history)`` with one entry per local step;
    reads ``merge_state["error"]`` and ``["momentum"]`` at entry and
    writes them at exit, and under a controller-driven plan also writes
    ``["cadence_trace"]`` and ``["tuning_trace"]``.

    A cadence-k plan's trailing round runs on the state wire through the
    outer optimizer whatever its length, one step included, and after
    the overlap's drain, as in the JAX package (the default plan runs a
    one-step round as a merge-per-step step).  Under overlap the
    prologue adds one phase of local steps (``cadence`` of them) whose
    metrics are not reported.  Adaptive and auto plans run
    ``tuning.controller.run_controlled_fit``, one dispatch at a time
    (``engine`` and ``scan_chunk`` do not apply).  ``compiled`` (set by
    ``PimGrid.fit`` for ``"scan"`` without a mesh) replays
    :func:`pipeline_runners`' chunks; otherwise the rounds run eagerly
    through :func:`run_rounds`, the oracle the chunks are held against.
    """
    outer, compression, k = plan.outer, plan.compression, plan.cadence
    state_wire = k > 1
    held = merge_state or {}
    # an auto plan may compress although plan.compression is None (the
    # controller chooses), so its EF buffer continues across fits too
    ef = held.get("error") if compression is not None or plan.auto \
        else None
    if plan.adaptive or plan.auto:
        from repro_torch.resilience import faults
        from repro_torch.tuning.controller import run_controlled_fit

        # the resilient driver covers static plans only: say that an
        # armed plan injects nothing here rather than skip it silently
        if faults.active() is not None:
            warnings.warn(
                "a FaultPlan is armed but this fit uses a controller-driven "
                "plan (adaptive/auto); fault injection and recovery only "
                "cover static plans — no faults will be injected",
                MergeFallbackWarning, stacklevel=3)
        state, history, ef, ctl = run_controlled_fit(
            grid, plan, state=init_state, ef=ef, local_fn=local_fn,
            update_fn=update_fn, data=data, steps=steps, callback=callback)
        if merge_state is not None:
            if ef is not None:
                merge_state["error"] = gather_merge_error(grid, ef)
            merge_state["cadence_trace"] = list(ctl.cadence_trace)
            merge_state["tuning_trace"] = ctl.trace_dict()
        return state, history

    mom: Any = ()
    if not outer.plain_commit:
        mom = held.get("momentum")
        if mom is None:
            mom = outer.init(init_state)
    if compiled:
        state, ef, mom, history = _fit_chunks(
            grid, plan, init_state, ef, mom, local_fn=local_fn,
            update_fn=update_fn, data=data, steps=steps,
            callback=callback, scan_chunk=scan_chunk)
        _hold(grid, merge_state, ef, outer, mom)
        return state, history
    pieces: dict = {}

    def fns(kk):
        if kk not in pieces:
            pieces[kk] = pipeline_fns(grid, local_fn, update_fn,
                                      merge_every=kk,
                                      compression=compression,
                                      state_wire=state_wire, outer=outer)
        return pieces[kk]

    if plan.overlap:
        body = overlapped_body(fns(k), data)

        def round_fn(carry, kk):
            if kk == k:
                carry, metrics = body(carry)
                return carry, (metrics if state_wire else [metrics])
            carry, metrics = plain_round(
                fns(kk), data, drain(fns(k), carry, state_wire=state_wire),
                state_wire=state_wire)
            return (carry[0], None) + carry[1:], metrics

        pending = fns(k)[3](init_state, data)[0] if steps >= k else None
        carry = (init_state, pending, ef, mom)
    else:
        def round_fn(carry, kk):
            return plain_round(fns(kk), data, carry, state_wire=state_wire)

        carry = (init_state, ef, mom)

    cb = None
    if callback is not None:
        def cb(step, carry, metrics):
            return callback(step, carry[0], metrics)

    carry, history = run_rounds(steps, k, round_fn, carry, engine=engine,
                                scan_chunk=scan_chunk, callback=cb)
    state, ef, mom = drain(fns(k), carry, state_wire=state_wire) \
        if plan.overlap else carry
    _hold(grid, merge_state, ef, outer, mom)
    return state, history


def _hold(grid, merge_state: Optional[dict], ef, outer, mom) -> None:
    """Write a fit's EF buffer and outer momentum into its holder."""
    if merge_state is not None:
        if ef is not None:
            merge_state["error"] = gather_merge_error(grid, ef)
        if not outer.plain_commit:
            merge_state["momentum"] = mom
