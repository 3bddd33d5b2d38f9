"""PimGrid — the paper's PIM execution model on a device or a mesh.

Port of ``repro.core.pim``.  A virtual DPU (vDPU) is one lane of a
leading ``n_vdpus`` batch dimension:

  1. ``shard_rows`` partitions the training set once into
     ``(n_vdpus, rows_per_vdpu, ...)`` resident tensors, padded with zero
     rows that a 0/1 row mask ``w`` marks (insight I4),
  2. ``map_reduce`` computes every lane's partial statistics in one
     batched call and merges them with ``sum(dim=0)`` (the host merge),
  3. ``fit`` runs the loop: partials -> merge -> update.

DESIGN — the mesh (``make_mesh_grid``)
--------------------------------------

``mesh=None`` keeps every lane on one device.  With a mesh
(``launch.mesh.make_pim_mesh``: axes ``("pod", "data")``, ``pod`` the
slow host hop) the lanes are sharded over the ranks in JAX's global lane
order, pod-major: rank ``r`` holds lanes ``[r * n_local, (r + 1) *
n_local)``.  JAX runs one process over the mesh; here every rank runs
the same program (multi-controller):

  * every rank calls ``fit`` (or ``api.fit``) with the same full inputs
    and keeps only its own block of lanes (``shard_rows``);
  * a merge sums the local lanes, then all-reduces over ``data``, then
    over ``pod`` (``distributed.collectives``, whose sums are exact or
    in a fixed order, so every rank gets the same bits);
  * every rank returns the same replicated state, JAX's
    ``out_specs=P()``.

A value that decides control flow must be equal on every rank before it
is used, or the ranks would diverge or deadlock.  Each such place says
so: the controller's round times (``tuning.controller``, agreed by an
all-reduce MAX), its cadence and wire decisions (from agreed times and
replicated delta norms), the tree's splits (from the all-reduced
histogram) and K-means' initial centroids (drawn from the full ``X``
with one seeded generator).

DESIGN — the compiled engine (CUDA graphs)
------------------------------------------

The JAX engine compiles the loop as chunks of ``lax.scan`` over merge
rounds, cached on the grid, with a donated carry.  The port captures the
same chunks as CUDA graphs (``core.graphs``), one engine a choice of
``engine``:

  * ``engine="scan"`` on a grid without a mesh replays
    :meth:`PimGrid.make_runner`'s chunk runner once per ``scan_chunk``
    rounds (``merge_plan.pipeline_runners``' for every other static
    plan): one captured graph a (data binding, chunk length), its
    metrics stacked on the card and brought to the host in one transfer
    a key, one host sync a chunk.  The runner is cached on the grid by
    the ``fn_signature`` of the step functions, the kernel flag and the
    cadence (``merge_plan.cache_get`` / ``cache_put``); a fit captures
    at most the full chunk and the remainder (and a short last round at
    cadence k, under its own ``merge_every`` key).  The caller's
    ``init_state`` is copied in and the returned state cloned out; a
    callback sees the end-of-chunk state, which the next chunk
    overwrites (JAX's donated-carry rule: copy what you keep);
  * ``engine="python"`` runs every round eagerly and brings its metrics
    to the host at once; callbacks see every round's state.  It is the
    oracle the graphs are held against, bit for bit: the same kernels in
    the same order;
  * on a mesh (NCCL cannot be captured here, and gloo never), under an
    armed ``FaultPlan``, under an adaptive or auto plan (one host sync a
    dispatch) and a streaming window at a time (new tensors a window),
    ``"scan"`` runs the eager rounds with one host sync a chunk.
"""

from __future__ import annotations

import os
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.core import graphs as _graphs
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import merge_plan as mp
from repro_torch.resilience import faults as _faults
from repro_torch.tree import tree_map


def mesh_device(device, mesh) -> torch.device:
    """A rank's device: as given; else under NCCL ``cuda:LOCAL_RANK``
    (the launcher's, or the rank modulo the cards), and under any other
    backend the default of :func:`resolve_device` (every rank of a gloo
    world on one card shares ``cuda:0``)."""
    if device is not None or mesh is None or dist.get_backend() != "nccl":
        return resolve_device(device)
    local = int(os.environ.get(
        "LOCAL_RANK", dist.get_rank() % max(torch.cuda.device_count(), 1)))
    return torch.device("cuda", local)


class PimGrid:
    """A grid of ``n_vdpus`` virtual DPUs on one device (``None`` means
    the card; pass ``device="cpu"`` for the plain PyTorch paths), or
    sharded over a ``("pod", "data")`` mesh of ranks (``mesh``, a
    ``DeviceMesh``; see DESIGN — the mesh)."""

    def __init__(self, n_vdpus: int, device=None, mesh=None):
        if n_vdpus < 1:
            raise ValueError(f"n_vdpus must be >= 1, got {n_vdpus}")
        self.n_vdpus = int(n_vdpus)
        self.mesh = mesh
        # the mesh axes carrying the vDPU shards, slow to fast: the first
        # is the host hop, reduced last and compressible
        self.data_axes = (tuple(mesh.mesh_dim_names) if mesh is not None
                          else ("data",))
        if self.n_vdpus % self.n_shards:
            raise ValueError(
                f"n_vdpus={self.n_vdpus} not divisible by data shards "
                f"{self.n_shards}")
        self.device = mesh_device(device, mesh)
        # the grid's cache (merge_plan.cache_get / cache_put), keyed by
        # the step functions: chunk runners, serving's bucket graphs, the
        # plan controller's cost model and setup
        self._tuning_cache: dict = {}

    # -- layout --------------------------------------------------------

    @property
    def n_shards(self) -> int:
        """Ranks the lanes are sharded over (1 without a mesh)."""
        return 1 if self.mesh is None else int(self.mesh.size())

    @property
    def n_local(self) -> int:
        """Lanes this rank holds."""
        return self.n_vdpus // self.n_shards

    @property
    def shard_index(self) -> int:
        """This rank's block of lanes in JAX's global order (pod-major)."""
        idx = 0
        if self.mesh is not None:
            for size, ax in zip(self.mesh.shape, self.data_axes):
                idx = idx * size + self.mesh.get_local_rank(ax)
        return idx

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on mesh axis ``axis``."""
        return self.mesh.get_local_rank(axis)

    def reduce(self, tree, *, slow: bool = True):
        """Sum a tree of this rank's (lane-summed) partials over the mesh:
        the fast axes, then with ``slow`` the host hop.  Without a mesh,
        the tree itself."""
        if self.mesh is None:
            return tree
        return coll.hierarchical_psum(
            tree, self.mesh, self.data_axes[1:][::-1],
            self.data_axes[0] if slow else None)

    def shard_rows(self, X, *extras):
        """Partition rows across vDPUs (the one-time resident placement).

        Pads the row count up to a multiple of ``n_vdpus`` and returns
        ``(data, n_rows)``: ``data`` holds ``X`` (and extras ``y0``,
        ``y1``, ...) as ``(n_vdpus, rows_per_vdpu, ...)`` plus a float32
        0/1 mask ``w`` of real rows.  Without padding the placement is a
        view of the caller's tensor, not a copy.  On a mesh every rank
        passes the full ``X`` and keeps a copy of its own ``n_local``
        lanes; ``n_rows`` is the global count.
        """
        X = torch.as_tensor(X, device=self.device)
        n = X.shape[0]
        per = -(-n // self.n_vdpus)
        pad = per * self.n_vdpus - n
        lo = self.shard_index * self.n_local

        def place(a):
            a = torch.as_tensor(a, device=self.device)
            if pad:
                a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
            a = a.reshape((self.n_vdpus, per) + tuple(a.shape[1:]))
            if self.n_shards > 1:
                a = a[lo:lo + self.n_local].clone()
            return a

        data = {"X": place(X),
                "w": place(torch.ones(n, dtype=torch.float32,
                                      device=self.device))}
        for i, e in enumerate(extras):
            data[f"y{i}"] = place(e)
        return data, n

    def map_reduce(self, local_fn: Callable[[Any, dict], dict], model: Any,
                   data: dict) -> dict:
        """``local_fn(model, data)`` returns per-lane partials with a
        leading lane dim; returns their sum over the lanes, on a mesh
        then all-reduced over ``data`` and then over ``pod`` (the
        paper's host merge: tasklet, rank, host).

        >>> import torch
        >>> grid = PimGrid(4, device="cpu")
        >>> data, n = grid.shard_rows(torch.arange(8.0)[:, None])
        >>> out = grid.map_reduce(
        ...     lambda m, d: {"s": (d["X"][..., 0] * d["w"]).sum(-1)},
        ...     None, data)
        >>> float(out["s"])
        28.0
        """
        return self.reduce(
            {k: v.sum(dim=0) for k, v in local_fn(model, data).items()})

    def make_runner(self, local_fn: Callable, update_fn: Callable, *,
                    merge_every: int = 1) -> _graphs.ChunkRunner:
        """The cached chunk runner for ``(local_fn, update_fn)``, the
        counterpart of ``repro.core.pim.PimGrid.make_runner``.

        ``runner(state, data, length=L)`` runs ``L`` merge rounds and
        returns ``(state, stacked_metrics)``.  At ``merge_every=1`` a
        round is one merge-per-step step and metric leaves come back
        ``(L, ...)``; at cadence ``k > 1`` a round is
        ``merge_plan.cadence_round`` (``k`` vDPU-local steps and one state
        merge) and metric leaves are ``(L, k, ...)``.  On the card each
        ``(data binding, L)`` is one captured CUDA graph
        (``core.graphs.ChunkRunner``: the data read in place, the state
        a static carry the graph writes back, returned live); on the CPU
        the same rounds run eagerly on the same static carry.

        Cached on the grid as JAX caches its jitted runner, keyed by the
        ``merge_plan.fn_signature`` of both functions (code and captured
        values: equal closures share a runner, a changed hyperparameter
        does not), ``dispatch.kernels_enabled()`` (a runner captured with
        the kernels never serves a ``use_kernels(False)`` fit) and
        ``merge_every``, in the grid's bounded LRU.

        >>> import torch
        >>> grid = make_cpu_grid(4)
        >>> data, n = grid.shard_rows(torch.arange(8.0)[:, None])
        >>> def local_fn(w, sl):
        ...     return {"g": ((w - sl["X"]) * sl["w"][..., None]).sum(-2)}
        >>> def update_fn(w, merged):
        ...     return w - 0.1 * merged["g"] / n, {"g0": merged["g"][0]}
        >>> runner = grid.make_runner(local_fn, update_fn)
        >>> grid.make_runner(local_fn, update_fn) is runner
        True
        >>> grid.make_runner(local_fn, update_fn, merge_every=4) is runner
        False
        >>> w, stacked = runner(torch.zeros(1), data, length=3)
        >>> tuple(stacked["g0"].shape), runner._cache_size()
        ((3,), 1)
        """
        if merge_every < 1:
            raise ValueError(
                f"merge_every must be >= 1, got {merge_every}")
        from repro_torch.kernels import dispatch as _dispatch

        key = ("fit_runner", mp.fn_signature(local_fn),
               mp.fn_signature(update_fn), _dispatch.kernels_enabled(),
               merge_every)
        with mp.CACHE_LOCK:
            runner = mp.cache_get(self, key)
            if runner is None:
                if merge_every == 1:
                    def round_fn(state, data):
                        merged = self.map_reduce(local_fn, state, data)
                        return update_fn(state, merged)
                else:
                    def round_fn(state, data):
                        return mp.cadence_round(self, local_fn, update_fn,
                                                merge_every, state, data)
                runner = _graphs.ChunkRunner(round_fn, self.device)
                mp.cache_put(self, key, runner, local_fn, update_fn)
        return runner

    def fit(self, *, init_state, local_fn: Callable,
            update_fn: Callable, data: dict, steps: int,
            callback: Callable | None = None, scan_chunk: int = 32,
            engine: str = "scan", merge_every: int = 1,
            overlap_merge: bool = False, merge_compression=None,
            merge_plan=None, merge_state: dict | None = None):
        """Run the loop: local partials -> merge -> update.

        ``update_fn(state, merged) -> (state, metrics)``; ``state`` is a
        tensor or a tuple of tensors (the minibatch sampler's ``(state,
        counter)``).  Returns
        ``(state, history)`` with one metrics dict (0-dim CPU tensors) per
        local step, whatever the cadence.  At cadence ``k > 1`` a round is
        ``k`` local steps per vDPU and one state merge
        (``merge_plan.cadence_round``); a trailing ``steps % k`` runs as
        one short round, and a round of one step is a merge-per-step
        step, as in the JAX engine.  ``scan_chunk`` counts rounds.

        ``engine="scan"`` replays :meth:`make_runner`'s captured chunks
        on a grid without a mesh (DESIGN — the compiled engine): the
        returned state is the caller's own, but a callback sees the
        end-of-chunk state, live, which the next chunk overwrites (copy
        it to keep it), as under JAX's donated carry.
        ``engine="python"`` runs every round eagerly, its metrics and
        callbacks a round at a time.

        Every other plan (``overlap_merge``, ``merge_compression`` (a
        ``distributed.compression.CompressionConfig``), SlowMo or Nesterov
        outer momentum, a custom ``OuterOptimizer``) is driven by
        ``distributed.merge_plan.run_fit`` (see that module's DESIGN
        notes).  When a ``merge_state`` dict is passed, the error-feedback
        buffer (``"error"``) and the outer momentum (``"momentum"``) are
        read from it at entry and written back at exit, so they continue
        across ``fit`` calls.

        ``data`` may also be a ``data.pipeline.PartitionRotation`` (an
        out-of-core dataset): ``data.pipeline.run_streaming_fit`` then
        runs one fit like this one a rotation window, on the eager
        rounds.

        Under an armed ``resilience.faults.FaultPlan`` a plan that is not
        adaptive or auto runs ``resilience.runtime.drive_fit`` (the
        survivor-weighted merge, with the armed recovery policy and
        checkpoints), and ``merge_state`` also receives its report.
        """
        if engine not in ("python", "scan"):
            raise ValueError(f"unknown engine {engine!r}")
        if scan_chunk < 1:
            raise ValueError(f"scan_chunk must be >= 1, got {scan_chunk}")
        plan = mp.MergePlan.resolve(
            merge_plan, merge_every=merge_every,
            overlap_merge=overlap_merge, merge_compression=merge_compression)
        # out-of-core streaming: a data.pipeline.PartitionRotation is
        # trained a window at a time, each window through _fit, so every
        # path below (the armed-faults hook too) applies to it
        if getattr(data, "is_streaming_rotation", False):
            from repro_torch.data import pipeline as _pipeline

            return _pipeline.run_streaming_fit(
                self, data, init_state=init_state, local_fn=local_fn,
                update_fn=update_fn, steps=steps, plan=plan,
                merge_state=merge_state, callback=callback,
                scan_chunk=scan_chunk, engine=engine)
        return self._fit(plan, init_state=init_state, local_fn=local_fn,
                         update_fn=update_fn, data=data, steps=steps,
                         callback=callback, scan_chunk=scan_chunk,
                         engine=engine, merge_state=merge_state,
                         compiled=engine == "scan" and self.mesh is None)

    def _fit(self, plan: mp.MergePlan, *, init_state, local_fn: Callable,
             update_fn: Callable, data: dict, steps: int,
             callback: Callable | None, scan_chunk: int, engine: str,
             merge_state: dict | None, compiled: bool):
        """:meth:`fit` on resident ``data`` under a resolved plan.
        ``compiled``: replay the captured chunk runners (``"scan"``
        without a mesh); ``data.pipeline.run_streaming_fit`` passes
        False, since every window is new tensors."""
        # fault injection (resilience): under an armed FaultPlan a static
        # plan runs the resilient driver (survivor-weighted merges,
        # injection, rollback); unarmed, this is one None check
        ctx = _faults.armed_context()
        if ctx is not None and not (plan.adaptive or plan.auto):
            from repro_torch.resilience import runtime as _resilient

            fplan, recovery, ckpt, ckpt_every = ctx
            state, history, _report = _resilient.drive_fit(
                self, init_state=init_state, local_fn=local_fn,
                update_fn=update_fn, data=data, steps=steps, plan=plan,
                fault_plan=fplan, recovery=recovery, ckpt=ckpt,
                ckpt_every_rounds=ckpt_every, scan_chunk=scan_chunk,
                callback=callback, merge_state=merge_state)
            return state, history
        if not plan.is_exact_default:
            return mp.run_fit(
                self, plan, init_state=init_state, local_fn=local_fn,
                update_fn=update_fn, data=data, steps=steps,
                callback=callback, scan_chunk=scan_chunk, engine=engine,
                merge_state=merge_state, compiled=compiled)
        if compiled:
            return self._fit_chunks(plan.cadence, init_state, local_fn,
                                    update_fn, data, steps, callback,
                                    scan_chunk)

        def round_fn(state, kk):
            if kk == 1:
                merged = self.map_reduce(local_fn, state, data)
                state, metrics = update_fn(state, merged)
                return state, [metrics]
            return mp.cadence_round(self, local_fn, update_fn, kk, state,
                                    data)

        return mp.run_rounds(steps, plan.cadence, round_fn, init_state,
                             engine=engine, scan_chunk=scan_chunk,
                             callback=callback)

    def _fit_chunks(self, k: int, init_state, local_fn, update_fn, data,
                    steps: int, callback, scan_chunk: int):
        """The default plan on the chunk runners: full rounds of ``k`` in
        chunks of ``scan_chunk``, then a trailing ``steps % k`` round on
        its own runner (``merge_every=steps % k``), as in the JAX
        engine."""
        history: list = []
        if steps <= 0:
            return init_state, history
        rounds, rem = divmod(steps, k)
        state = init_state
        for kk, n in ((k, rounds), (rem, 1 if rem else 0)):
            if n:
                state = mp.replay_rounds(
                    self.make_runner(local_fn, update_fn, merge_every=kk),
                    state, data, n, kk, kk > 1, scan_chunk, history,
                    callback)
        return tree_map(torch.clone, state), history


def make_grid(n_vdpus: int = 64, device=None) -> PimGrid:
    """A grid on the card (or on ``device``)."""
    return PimGrid(n_vdpus, device=device)


def make_mesh_grid(n_vdpus: int = 64, *, pods: int = 1,
                   data: int | None = None, mesh=None,
                   device=None) -> PimGrid:
    """A grid whose vDPU axis is sharded over a mesh of ranks.

    The mesh carries the engine's two levels as axes ``("pod",
    "data")``: ``pod`` the slow, compressible host hop (reduced last),
    ``data`` the fast axis.  It is built over the world by
    ``launch.mesh.make_pim_mesh`` (which starts a world of one process
    when none exists, over the backend of ``device``'s type: gloo for
    the CPU, NCCL for the card) unless ``mesh`` is given.  ``n_vdpus`` must be
    divisible by the world size: each rank runs its share of the lanes,
    as the single-device grid runs all of them.

    In a single process the mesh is ``(1, 1)`` and every collective has
    one participant:

    >>> import torch
    >>> grid = make_mesh_grid(8, device="cpu")
    >>> grid.data_axes, grid.n_shards
    (('pod', 'data'), 1)
    >>> data, n = grid.shard_rows(torch.arange(16.0)[:, None])
    >>> out = grid.map_reduce(
    ...     lambda m, d: {"s": (d["X"][..., 0] * d["w"]).sum(-1)},
    ...     None, data)
    >>> float(out["s"])
    120.0
    >>> torch.distributed.destroy_process_group()   # the world it started
    """
    if mesh is None:
        from repro_torch.launch.mesh import make_pim_mesh
        mesh = make_pim_mesh(pods, data, device_type=None if device is None
                             else torch.device(device).type)
    return PimGrid(n_vdpus, device=device, mesh=mesh)


def make_cpu_grid(n_vdpus: int = 64) -> PimGrid:
    """A grid on the CPU, where every kernel wrapper runs its plain
    version (tests)."""
    return PimGrid(n_vdpus, device="cpu")
