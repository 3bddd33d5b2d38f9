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

The JAX engine compiles the loop (``lax.scan`` over chunks, a compile
cache, donated carries).  PyTorch runs eagerly, so the port has no
compile cache or donation (a grid keeps one small cache, of the plan
controller's cost model, ``merge_plan.cache_get``); its two engines run
the same arithmetic and differ only in when per-step metrics reach the
host:

  * ``engine="python"`` — metrics come back after every step (or round),
    and callbacks see every step's state;
  * ``engine="scan"``  — metrics stay on the device and come back with
    one synchronisation per ``scan_chunk`` rounds; callbacks see the
    end-of-chunk state, as under the JAX scan engine.
"""

from __future__ import annotations

import os
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import merge_plan as mp
from repro_torch.resilience import faults as _faults


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
        # the plan controller's cost model and setup, keyed by the step
        # functions (merge_plan.cache_get / cache_put)
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
        runs one fit like this one a rotation window.

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
        # trained a window at a time, each window through this fit again,
        # so every path below (the armed-faults hook too) applies to it
        if getattr(data, "is_streaming_rotation", False):
            from repro_torch.data import pipeline as _pipeline

            return _pipeline.run_streaming_fit(
                self, data, init_state=init_state, local_fn=local_fn,
                update_fn=update_fn, steps=steps, plan=plan,
                merge_state=merge_state, callback=callback,
                scan_chunk=scan_chunk, engine=engine)
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
                merge_state=merge_state)

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
