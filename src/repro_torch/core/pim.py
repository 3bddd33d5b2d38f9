"""PimGrid — the paper's PIM execution model on one device.

Port of ``repro.core.pim`` without a mesh.  A virtual DPU (vDPU) is one
lane of a leading ``n_vdpus`` batch dimension:

  1. ``shard_rows`` partitions the training set once into
     ``(n_vdpus, rows_per_vdpu, ...)`` resident tensors, padded with zero
     rows that a 0/1 row mask ``w`` marks (insight I4),
  2. ``map_reduce`` computes every lane's partial statistics in one
     batched call and merges them with ``sum(dim=0)`` (the host merge),
  3. ``fit`` runs the loop: partials -> merge -> update.

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

from typing import Any, Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import merge_plan as mp


class PimGrid:
    """A grid of ``n_vdpus`` virtual DPUs on one device (``None`` means
    the card; pass ``device="cpu"`` for the plain PyTorch paths)."""

    def __init__(self, n_vdpus: int, device=None):
        if n_vdpus < 1:
            raise ValueError(f"n_vdpus must be >= 1, got {n_vdpus}")
        self.n_vdpus = int(n_vdpus)
        self.device = resolve_device(device)
        # the plan controller's cost model and setup, keyed by the step
        # functions (merge_plan.cache_get / cache_put)
        self._tuning_cache: dict = {}

    def shard_rows(self, X, *extras):
        """Partition rows across vDPUs (the one-time resident placement).

        Pads the row count up to a multiple of ``n_vdpus`` and returns
        ``(data, n_rows)``: ``data`` holds ``X`` (and extras ``y0``,
        ``y1``, ...) as ``(n_vdpus, rows_per_vdpu, ...)`` plus a float32
        0/1 mask ``w`` of real rows.  Without padding the placement is a
        view of the caller's tensor, not a copy.
        """
        X = torch.as_tensor(X, device=self.device)
        n = X.shape[0]
        per = -(-n // self.n_vdpus)
        pad = per * self.n_vdpus - n

        def place(a):
            a = torch.as_tensor(a, device=self.device)
            if pad:
                a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
            return a.reshape((self.n_vdpus, per) + tuple(a.shape[1:]))

        data = {"X": place(X),
                "w": place(torch.ones(n, dtype=torch.float32,
                                      device=self.device))}
        for i, e in enumerate(extras):
            data[f"y{i}"] = place(e)
        return data, n

    def map_reduce(self, local_fn: Callable[[Any, dict], dict], model: Any,
                   data: dict) -> dict:
        """``local_fn(model, data)`` returns per-lane partials with a
        leading ``n_vdpus`` dim; returns their sum over the lanes.

        >>> import torch
        >>> grid = PimGrid(4, device="cpu")
        >>> data, n = grid.shard_rows(torch.arange(8.0)[:, None])
        >>> out = grid.map_reduce(
        ...     lambda m, d: {"s": (d["X"][..., 0] * d["w"]).sum(-1)},
        ...     None, data)
        >>> float(out["s"])
        28.0
        """
        return {k: v.sum(dim=0) for k, v in local_fn(model, data).items()}

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
        """
        if engine not in ("python", "scan"):
            raise ValueError(f"unknown engine {engine!r}")
        if scan_chunk < 1:
            raise ValueError(f"scan_chunk must be >= 1, got {scan_chunk}")
        plan = mp.MergePlan.resolve(
            merge_plan, merge_every=merge_every,
            overlap_merge=overlap_merge, merge_compression=merge_compression)
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


def make_cpu_grid(n_vdpus: int = 64) -> PimGrid:
    """A grid on the CPU, where every kernel wrapper runs its plain
    version (tests)."""
    return PimGrid(n_vdpus, device="cpu")
