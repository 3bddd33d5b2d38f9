"""Workload — the estimator API over the PimGrid engine.

Port of ``repro.core.mlalgos.api``.  A Workload packages what is
per-algorithm:

    prepare(grid, X, y)           -> (data, n, consts), the one-time
                                     resident placement (quantize +
                                     ``shard_rows``)
    init_state(consts)            -> the model state
    local_step(consts, state, sl) -> per-vDPU partial statistics
    update(consts, state, merged) -> (state', metrics)
    eval(state, X, y)             -> quality metrics
    predict(state, X)             -> the serving forward pass

Lanes are a batch dimension: ``sl`` is the whole resident data dict
with its leading ``n_vdpus`` dim, and ``local_step`` returns partials
with that leading dim.  ``state`` is one shared tensor at cadence 1 and
one per lane (leading ``n_vdpus`` dim) inside a cadence-k round.

``fit`` is the one entry point: it applies the workload's
``merge_caps`` and hands over to ``Workload.run`` — bind and the
``PimGrid.fit`` loop by default, an algorithm-owned loop where training
is not that loop (the tree's levels).

``Program.step_fn`` and ``Program.round_fn`` hand a bound program's
step (or cadence-k merge round) to an outside training loop, the
fault-tolerant ``runtime.Trainer``.  They run eagerly, like ``fit``.

``batch_size=b`` samples ``b`` of each vDPU's resident rows every local
step, on the device (``core.minibatch``): the engine triple is wrapped
so the state carries a step counter, ``(state, counter)``, and the
caller gets the state back.  ``batch_size=None`` is the full-batch path.
Stateful outer optimizers (SlowMo, Nesterov) are refused with
``batch_size``: their momentum would integrate the sampler's counter.
The overlapped and compressed merges compose with it: the float32
counter crosses the wire like the state (quantized under compression,
as in the JAX package) and is rounded where it is read.  Adaptive
cadence and ``"auto"`` run under the plan controller
(``repro_torch.tuning``).

An out-of-core source (``data.pipeline.StreamingDataset``, rows on the
host) trains through the same entry point, ``fit(workload, grid,
stream)`` with its labels inside the stream: ``Workload.bind_stream``
takes the workload's constants from one pass over the host rows
(``stream_consts``: the row count, the quantization scales of the whole
dataset) and maps each window's rows as ``prepare`` maps the resident set
(``stream_transform``, in numpy, on the prefetch thread), and the bound
:class:`StreamProgram` trains a rotation window at a time
(``data.pipeline``'s DESIGN).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core import minibatch as mb
from repro_torch.core.pim import PimGrid
from repro_torch.distributed import merge_plan as mp


MergeFallbackWarning = mp.MergeFallbackWarning


@dataclasses.dataclass(frozen=True)
class MergeCaps:
    """Which merge-plan and sampling axes a workload can honour;
    :meth:`constrain` degrades an unsupported request to the exact
    default and warns (``merge_plan.MergeFallbackWarning``) with the
    workload's ``reason``.  The default is everything: gradient-style
    estimators whose state is an averageable float tensor."""

    cadence: bool = True
    overlap: bool = True
    compression: bool = True
    outer: bool = True
    minibatch: bool = True
    reason: str = ""

    @classmethod
    def exact_only(cls, reason: str) -> "MergeCaps":
        """Merge every step, full batch only (the tree's discrete
        commits)."""
        return cls(cadence=False, overlap=False, compression=False,
                   outer=False, minibatch=False, reason=reason)

    def constrain(self, name: str, plan: mp.MergePlan,
                  batch_size: Optional[int]):
        """Degrade ``(plan, batch_size)`` to what the workload supports;
        one warning lists everything dropped."""
        dropped = []
        changes: dict = {}
        if plan.cadence > 1 and not self.cadence:
            dropped.append(f"merge_every={plan.cadence}")
            changes["cadence"] = 1
        if plan.overlap and not self.overlap:
            dropped.append("overlap_merge")
            changes["overlap"] = False
        if plan.compression is not None and not self.compression:
            dropped.append("merge_compression")
            changes["compression"] = None
        if type(plan.outer) is not mp.AverageCommit and not self.outer:
            dropped.append(f"outer={type(plan.outer).__name__}")
            changes["outer"] = mp.AverageCommit()
        if batch_size is not None and not self.minibatch:
            dropped.append(f"batch_size={batch_size}")
            batch_size = None
        if dropped:
            mp.warn_fallback(name, " + ".join(dropped), self.reason)
            plan = dataclasses.replace(plan, **changes)
        return plan, batch_size


class Workload:
    """Base estimator: subclasses are frozen dataclasses of
    hyperparameters implementing the protocol in the module docstring.
    ``consts`` holds the constants the step functions read (row and
    feature counts, quantization scales, the device)."""

    name: str = "workload"
    merge_caps: MergeCaps = MergeCaps()
    # False marks a forward pass that is not one device computation (the
    # tree bins and descends level by level), as in the JAX package
    predict_device: bool = True

    def prepare(self, grid: PimGrid, X, y=None):
        raise NotImplementedError

    def init_state(self, consts: dict):
        raise NotImplementedError

    def local_step(self, consts: dict, state, sl: dict) -> dict:
        raise NotImplementedError

    def update(self, consts: dict, state, merged: dict):
        raise NotImplementedError

    def eval(self, state, X, y=None) -> dict:
        raise NotImplementedError

    def predict(self, state, X):
        """Raw predictions for a batch of rows (the forward half of
        ``eval``); pad-invariant, like the JAX package's."""
        raise NotImplementedError(
            f"workload {self.name!r} does not implement predict")

    # -- spec-level step functions (``launch.dryrun_pim``) ---------------

    def spec_consts(self, device) -> Optional[dict]:
        """The constants :meth:`spec_fns` adds to ``n``, ``d`` and a unit
        ``x_scale`` (an activation); ``None``, the default, means the
        workload has no spec-level step functions."""
        return None

    def spec_fns(self, *, features: int, rows: int, device="cpu"):
        """``(local_fn, update_fn, state0)`` over spec-level constants,
        with no resident data: unit quantization scales for an int
        resident dataset and :meth:`spec_consts`.  Under a
        ``FakeTensorMode`` nothing is allocated."""
        extra = self.spec_consts(device)
        if extra is None:
            raise NotImplementedError(
                f"workload {self.name!r} has no spec-level step functions")
        consts = {"n": rows, "d": features, "device": torch.device(device),
                  "x_scale": torch.ones((1, features), dtype=torch.float32,
                                        device=device), **extra}
        program = Program.assemble(self, None, None, rows, consts)
        return program.local_fn, program.update_fn, program.state0

    # -- out-of-core streaming (opt-in) ----------------------------------

    def stream_consts(self, stream, grid: PimGrid) -> Optional[dict]:
        """The constants of a fit over a ``data.pipeline.StreamingDataset``
        (``prepare``'s consts, from one pass over the host rows, since no
        window sees them all), on ``grid``'s device.  ``None``, the
        default, means the workload cannot stream (:meth:`bind_stream`
        says so)."""
        return None

    def stream_transform(self, consts: dict, X_rows, y_rows):
        """A window's host rows (numpy) -> the ``(X', extra0, ...)`` tuple
        ``prepare`` would have given ``shard_rows``: labels mapped, values
        quantized against the whole dataset's scales.  Row-local, so it
        commutes with the rotation's gather; numpy, since it runs on the
        prefetch thread."""
        return (X_rows,) if y_rows is None else (X_rows, y_rows)

    def bind(self, grid: PimGrid, X, y=None) -> "Program":
        """Shard the dataset and assemble the engine closures once."""
        data, n, consts = self.prepare(grid, X, y)
        return Program.assemble(self, grid, data, n, consts)

    def bind_stream(self, grid: PimGrid, stream) -> "StreamProgram":
        """Bind an out-of-core ``data.pipeline.StreamingDataset``: the
        closures of :meth:`bind`, over a ``PartitionRotation`` that puts
        resident-sized windows on the device as they are needed."""
        from repro_torch.data.pipeline import PartitionRotation

        consts = self.stream_consts(stream, grid)
        if consts is None:
            raise ValueError(
                f"workload {self.name!r} does not support streaming "
                f"ingestion (stream_consts returned None): its "
                f"prepare-time statistics cannot be derived from "
                f"one-pass host statistics, or nobody has taught it "
                f"to — use the fully-resident path")

        def transform(Xb, yb):
            return self.stream_transform(consts, Xb, yb)

        rotation = PartitionRotation(stream, grid, transform=transform)
        return StreamProgram.assemble(self, grid, rotation, stream.n_rows,
                                      consts)

    def run(self, grid: PimGrid, X, y=None, *, steps: int,
            plan: mp.MergePlan, batch_size: Optional[int], engine: str,
            scan_chunk: int, callback: Optional[Callable],
            merge_state: Optional[dict] = None, sample_seed: int = 0,
            sample_permutation: Optional[mb.Permutation] = None
            ) -> "FitResult":
        """Train from raw arrays, ``plan`` and ``batch_size`` already
        constrained by :func:`fit`.  The default is bind and the
        ``PimGrid.fit`` loop; a workload whose training is not that loop
        overrides it."""
        return self.bind(grid, X, y).fit(
            steps=steps, batch_size=batch_size, engine=engine,
            scan_chunk=scan_chunk, merge_plan=plan, merge_state=merge_state,
            callback=callback, sample_seed=sample_seed,
            sample_permutation=sample_permutation)


@dataclasses.dataclass
class FitResult:
    """The trained state and one metrics entry per local step."""

    state: Any
    history: list
    workload: Workload

    def eval(self, X, y=None) -> dict:
        return self.workload.eval(self.state, X, y)


@dataclasses.dataclass
class Program:
    """A workload bound to a grid and a resident dataset: the
    ``(local_fn, update_fn, state0)`` triple plus the placement."""

    workload: Workload
    grid: PimGrid
    data: dict
    n: int
    consts: dict
    local_fn: Callable
    update_fn: Callable
    state0: Any
    _mb_cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def assemble(cls, workload: Workload, grid: PimGrid, data: dict, n: int,
                 consts: dict) -> "Program":
        def local_fn(state, sl):
            return workload.local_step(consts, state, sl)

        def update_fn(state, merged):
            return workload.update(consts, state, merged)

        return cls(workload=workload, grid=grid, data=data, n=n,
                   consts=consts, local_fn=local_fn, update_fn=update_fn,
                   state0=workload.init_state(consts))

    @property
    def rows_per_vdpu(self) -> int:
        return int(self.data["w"].shape[1])

    def _triple(self, batch_size: Optional[int], sample_seed: int,
                permutation: Optional[mb.Permutation] = None):
        """The engine triple and an ``unwrap`` of its state (None at full
        batch), minibatch-wrapped when asked; wrapped triples are kept
        per ``(batch_size, seed, permutation)``."""
        if batch_size is None:
            return self.local_fn, self.update_fn, self.state0, None
        key = (batch_size, sample_seed, permutation)
        if key not in self._mb_cache:
            self._mb_cache[key] = mb.minibatch_fns(
                self.local_fn, self.update_fn, self.state0,
                rows_per_vdpu=self.rows_per_vdpu, batch_size=batch_size,
                seed=sample_seed, permutation=permutation)
        return self._mb_cache[key]

    def fit(self, *, steps: int, batch_size: Optional[int] = None,
            engine: str = "scan", scan_chunk: int = 32,
            merge_every: int = 1, merge_plan=None,
            merge_state: Optional[dict] = None,
            callback: Optional[Callable] = None, sample_seed: int = 0,
            sample_permutation: Optional[mb.Permutation] = None
            ) -> FitResult:
        """Train on the bound dataset under a merge plan (``merge_state``
        carries its outer momentum across fits), full batch or
        (``batch_size``) on sampled batches; a callback sees the caller's
        state, never the sampler's counter."""
        plan = mp.MergePlan.resolve(merge_plan, merge_every=merge_every)
        plan, batch_size = self.workload.merge_caps.constrain(
            self.workload.name, plan, batch_size)
        if batch_size is not None and not plan.outer.plain_commit:
            raise ValueError(
                f"batch_size={batch_size} cannot compose with the "
                f"{type(plan.outer).__name__} outer optimizer: the "
                f"sampler's step counter rides in the merged state and "
                f"a stateful outer commit would integrate it into its "
                f"momentum, breaking the epoch schedule")
        local_fn, update_fn, state0, unwrap = self._triple(
            batch_size, sample_seed, sample_permutation)
        cb = callback
        if unwrap is not None and callback is not None:
            def cb(step, state, metrics):
                return callback(step, unwrap(state), metrics)
        state, history = self.grid.fit(
            init_state=state0, local_fn=local_fn, update_fn=update_fn,
            data=self.data, steps=steps, engine=engine,
            scan_chunk=scan_chunk, merge_plan=plan, merge_state=merge_state,
            callback=cb)
        if unwrap is not None:
            state = unwrap(state)
        return FitResult(state=state, history=history,
                         workload=self.workload)

    def _step_triple(self, batch_size: Optional[int], sample_seed: int,
                     permutation: Optional[mb.Permutation] = None):
        """The engine triple that :meth:`step_fn` and :meth:`round_fn` run
        (a :class:`StreamProgram` adds its window's scale)."""
        return self._triple(batch_size, sample_seed, permutation)[:3]

    def step_fn(self, *, batch_size: Optional[int] = None,
                sample_seed: int = 0,
                sample_permutation: Optional[mb.Permutation] = None):
        """A merge-per-step function for outside training loops (the
        ``runtime.Trainer``): ``step(state, batch) -> (state, metrics)``
        over ``batch`` when given (a stream's window), else over the
        resident data.  It runs what a cadence-1 ``fit`` step runs, in the
        same order.  Returns ``(step, state0)``; with ``batch_size`` the
        state is ``(state, counter)``, so a checkpoint holds the sampler's
        position."""
        local_fn, update_fn, state0 = self._step_triple(
            batch_size, sample_seed, sample_permutation)
        grid, resident = self.grid, self.data

        def step(state, batch):
            data = resident if batch is None else batch
            merged = grid.map_reduce(local_fn, state, data)
            return update_fn(state, merged)

        return step, state0

    def round_fn(self, k: int, *, batch_size: Optional[int] = None,
                 sample_seed: int = 0,
                 sample_permutation: Optional[mb.Permutation] = None):
        """An exact merge round at cadence ``k`` for outside loops:
        ``round(state, batch) -> (state, [metrics of each of the k local
        steps])``, ``merge_plan.cadence_round`` on ``batch`` when given,
        else on the resident data (the default plan's round).  Returns
        ``(round, state0)``; this is how ``Trainer.for_program`` runs
        ``merge_every > 1`` with its checkpoints on merge boundaries."""
        if k < 1:
            raise ValueError(f"round_fn needs cadence k >= 1, got {k}")
        local_fn, update_fn, state0 = self._step_triple(
            batch_size, sample_seed, sample_permutation)
        grid, resident = self.grid, self.data

        def round(state, batch):
            data = resident if batch is None else batch
            return mp.cadence_round(grid, local_fn, update_fn, k, state,
                                    data)

        return round, state0


@dataclasses.dataclass
class StreamProgram(Program):
    """A workload bound to a grid and an out-of-core rotation: ``data`` is
    a ``data.pipeline.PartitionRotation``, which ``PimGrid.fit`` hands to
    ``data.pipeline.run_streaming_fit``.  ``batch_size`` samples within a
    window (the sampler's ``rows_per_vdpu`` is the window's ``part``),
    every static plan runs inside each window, and EF and momentum
    continue across windows through ``merge_state``; controller plans
    are refused."""

    is_stream_program = True

    @property
    def rows_per_vdpu(self) -> int:
        return self.data.part

    @property
    def stream_tag(self) -> str:
        """The rotation's identity, for the Trainer's checkpoints."""
        return self.data.tag()

    def batch_feed(self, cadence: int = 1):
        """A deterministic ``batch_fn(step)`` over the rotation for the
        ``Trainer``: window ``step // steps_per_window``, prefetched, and
        gathered again on a rollback."""
        from repro_torch.data.pipeline import RotationFeed

        return RotationFeed(self.data, self.data.steps_per_window(cadence))

    def _step_triple(self, batch_size, sample_seed, sample_permutation):
        """The engine triple with the window's scale applied outside the
        sampler (the sampler selects rows of every leaf it is given), so
        the Trainer's steps over the feed's windows are a streaming
        fit's."""
        from repro_torch.data.pipeline import make_scaled_local

        local_fn, update_fn, state0, _ = self._triple(
            batch_size, sample_seed, sample_permutation)
        if not self.data.exact_full:
            local_fn = make_scaled_local(local_fn)
        return local_fn, update_fn, state0


def fit(workload: Workload, grid: PimGrid, X, y=None, *, steps: int,
        batch_size: Optional[int] = None, engine: str = "scan",
        scan_chunk: int = 32, merge_every: int = 1,
        overlap_merge: bool = False, merge_compression=None,
        merge_plan=None, merge_state: Optional[dict] = None,
        callback: Optional[Callable] = None, sample_seed: int = 0,
        sample_permutation: Optional[mb.Permutation] = None) -> FitResult:
    """Train any workload on the grid — the entry point every layer above
    the algorithms goes through.  ``merge_plan``: a
    ``merge_plan.MergePlan`` (``None``: the exact default), e.g.
    ``MergePlan(cadence=8, outer=SlowMo())``; unsupported axes degrade
    with a ``MergeFallbackWarning``, and ``merge_state`` (a dict) carries
    the error-feedback buffer and the outer momentum across fits.  ``X``
    may be a ``data.pipeline.StreamingDataset`` (``y=None``: the labels
    ride in it).  ``batch_size``: rows sampled per
    vDPU per local step (None: full batch), on the schedule of
    ``sample_seed`` and, when given, ``sample_permutation(seed, epoch,
    rows_per_vdpu)`` (default: ``minibatch.hashed_permutation``); it
    cannot compose with a stateful outer optimizer.

    >>> import numpy as np
    >>> from repro_torch.core import make_cpu_grid
    >>> from repro_torch.core.mlalgos import api, LogReg
    >>> rng = np.random.default_rng(0)
    >>> X = rng.standard_normal((512, 8)).astype(np.float32)
    >>> y = (X[:, 0] > 0).astype(np.float32)
    >>> res = api.fit(LogReg(precision="int8", sigmoid="lut"),
    ...               make_cpu_grid(8), X, y, steps=20)
    >>> len(res.history), res.eval(X, y)["accuracy"] > 0.9
    (20, True)
    """
    plan = mp.MergePlan.resolve(
        merge_plan, merge_every=merge_every, overlap_merge=overlap_merge,
        merge_compression=merge_compression)
    plan, batch_size = workload.merge_caps.constrain(workload.name, plan,
                                                     batch_size)
    if getattr(X, "is_streaming_source", False):
        # out-of-core: X is a data.pipeline.StreamingDataset carrying its
        # own labels; PimGrid.fit hands the bound rotation to
        # data.pipeline.run_streaming_fit
        if y is not None:
            raise ValueError(
                "streaming fits carry labels inside the "
                "StreamingDataset — pass y=None")
        return workload.bind_stream(grid, X).fit(
            steps=steps, batch_size=batch_size, engine=engine,
            scan_chunk=scan_chunk, merge_plan=plan, merge_state=merge_state,
            callback=callback, sample_seed=sample_seed,
            sample_permutation=sample_permutation)
    return workload.run(grid, X, y, steps=steps, plan=plan,
                        batch_size=batch_size, engine=engine,
                        scan_chunk=scan_chunk, callback=callback,
                        merge_state=merge_state, sample_seed=sample_seed,
                        sample_permutation=sample_permutation)
