"""The fault-tolerant training loop.

Port of ``repro.runtime.trainer``:

* **checkpoint/restart** — ``CheckpointManager`` snapshots the state
  (and the merge-state holder's buffers) every ``ckpt_every`` steps; a
  new ``Trainer`` resumes from the newest checkpoint, in the JAX
  package's format, so either package resumes the other's run.
* **failure handling** — a step that raises, or a window whose loss is
  not finite (or spikes, under ``TrainerConfig.recovery``), restores the
  last checkpoint and replays from it, up to ``max_restarts`` times.
  A kernel that cannot be built or launched (``kernels.build.
  KernelError``) or a CUDA error (``torch.AcceleratorError``: the
  context is lost) is raised at once: a replay would fail the same way.
* **no host sync on the hot path** — a step's metrics stay on the device
  until a log or checkpoint boundary; there each loss reduces to a
  finite flag on the device, the window's flags come back in one
  transfer and its metrics in one more, and a checkpoint is never
  written before the steps it covers are verified finite.
* **straggler accounting** — an EWMA of the host-observed step time;
  steps slower than ``straggler_factor`` times it are counted.
* **merge boundaries** — at cadence k the lanes' states differ between
  merges, so flushes and checkpoints that fall inside a round wait for
  its merge; ``for_program`` runs one merge round a call.

State is a tree of tensors (``repro_torch.tree``).  Where JAX's arrays
are immutable, a tensor may be updated in place, so the trainer copies
what it keeps: the checkpoint's host copy and the run's entry state
(``origin``, the rollback of last resort) are clones.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.kernels.build import KernelError
from repro_torch.tree import tree_map

# failures that restore-and-replay cannot cure: raised at once
UNRECOVERABLE = (KernelError,) + tuple(
    c for c in (getattr(torch, "AcceleratorError", None),) if c is not None)


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    ckpt_keep: int = 3
    max_restarts: int = 3
    straggler_factor: float = 2.0
    log_every: int = 10
    # Merge cadence of the engine behind the step function: between
    # merges the lanes' states differ and step metrics are local, so
    # flushes, finite checks and checkpoints fire only at merge
    # boundaries ((step + 1) % merge_every == 0); a log or checkpoint
    # boundary inside a round waits for the next merge.
    merge_every: int = 1
    # Merge compression of the engine (a CompressionConfig or None),
    # recorded in every checkpoint's extra: an error-feedback buffer is
    # only meaningful under the compression that produced it, so a
    # restore under another one is refused.
    merge_compression: object = None
    # The two knobs above as one distributed.merge_plan.MergePlan (pass
    # one spelling, not both).
    merge_plan: object = None
    # Minibatch sampling of the program (core.minibatch): rows sampled a
    # vDPU a local step.  Read by Trainer.for_program only; None is the
    # full batch.
    batch_size: Optional[int] = None
    # The finite check fused into the flush: each buffered loss reduces
    # to a flag on the device and the stacked flags come back in one
    # transfer, then the window's metrics in one more.  False keeps the
    # per-step float(loss) check, the parity oracle.
    fused_finite: bool = True
    # Flush windows on a background thread: a log boundary costs the loop
    # nothing.  The thread is drained (every queued window verified)
    # before a checkpoint, before a callback and at the end of a run; a
    # non-finite window found there raises on the loop at the next poll
    # or drain and takes the same restore-and-replay path.
    async_metrics: bool = False
    # Structured recovery (resilience.recovery.RecoveryPolicy or None):
    # backoff before each restore and its max_restarts as the budget;
    # loss-spike detection at flush boundaries (spike_factor); at cadence
    # > 1 under for_program, the cadence halves after degrade_after
    # divergences in a row.  Decisions land in run()'s "recovery_trace"
    # and, with a merge-state holder, in its
    # ["tuning_trace"]["recovery"].
    recovery: object = None


class _MetricsSink:
    """The background consumer of flush windows (``async_metrics``).

    The loop ``submit``\\ s whole windows (lists of ``(step, metrics, dt,
    stragglers)``); one daemon thread runs the trainer's ``_flush`` on
    them in order, so ``history`` has the synchronous path's order.  A
    window that fails its check parks the exception; ``poll`` raises it
    on the loop, and while one is parked (or a ``reset`` discards) the
    queued windows are skipped, not flushed: they cover steps the
    restore rolls back.
    """

    def __init__(self, flush_fn: Callable):
        self._flush = flush_fn
        self._q: queue.Queue = queue.Queue()
        self._exc: Optional[BaseException] = None
        self._skip = False
        self._closed = False
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._consume, name="trainer-metrics-sink",
            daemon=True)
        self._thread.start()
        # an interrupted run may die with windows still queued: closing
        # at interpreter exit lets them flush or park
        atexit.register(self.close)

    def _consume(self):
        while True:
            window = self._q.get()
            try:
                if window is None:
                    return
                with self._lock:
                    skip = self._skip or self._exc is not None
                if not skip:
                    self._flush(window)
            except BaseException as e:  # parked for the loop
                with self._lock:
                    self._exc = e
            finally:
                self._q.task_done()

    def submit(self, window: list):
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    "metrics sink is closed — submitted window would "
                    "never flush")
        self._q.put(window)

    def poll(self):
        """Raise (and clear) a parked exception on the caller."""
        with self._lock:
            exc, self._exc = self._exc, None
        if exc is not None:
            raise exc

    def drain(self):
        """Block until every submitted window is verified and appended,
        then raise any failure."""
        self._q.join()
        self.poll()

    def reset(self):
        """Discard what is queued without flushing it (the failure path)
        and clear a parked exception."""
        with self._lock:
            self._skip = True
        self._q.join()
        with self._lock:
            self._skip = False
            self._exc = None

    def close(self):
        """Idempotent shutdown: every queued window still flushes or
        parks its exception (a later ``drain``/``poll`` sees it), the
        thread stops, and the atexit hook is removed."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._q.put(None)
        self._thread.join(timeout=30.0)
        atexit.unregister(self.close)


def to_host(values: list) -> list:
    """Each value as a numpy array (a tensor's dtype kept): the tensors
    come back in one transfer for each device (their bytes, each padded
    to 8, concatenated, one ``.cpu()``, viewed back in their dtypes);
    other values go through ``np.asarray``."""
    out: list = [None] * len(values)
    groups: dict = {}
    for i, v in enumerate(values):
        if isinstance(v, torch.Tensor):
            groups.setdefault(v.device, []).append(i)
        else:
            out[i] = np.asarray(v)
    for idx in groups.values():
        parts, offsets, off = [], [], 0
        for i in idx:
            raw = values[i].detach().contiguous().reshape(-1).view(
                torch.uint8)
            pad = -raw.numel() % 8        # a view needs aligned offsets
            parts.append(torch.cat([raw, raw.new_zeros(pad)]) if pad
                         else raw)
            offsets.append(off)
            off += raw.numel() + pad
        host = torch.cat(parts).cpu()
        for i, o in zip(idx, offsets):
            v = values[i]
            n = v.numel() * v.element_size()
            out[i] = host[o:o + n].view(v.dtype).reshape(
                tuple(v.shape)).numpy()
    return out


def snapshot(state):
    """A copy of ``state`` that later in-place updates cannot reach."""
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, state)


class Trainer:
    """Drives ``step_fn(state, batch) -> (state, metrics)`` with fault
    tolerance.  ``state`` is a tree of tensors; ``batch_fn(step) ->
    batch`` must be deterministic in ``step``.

    ``merge_state`` is ``PimGrid.fit``'s merge-continuation holder
    (``{"error": <EF tree>, "momentum": <OptState>}``, either key alone
    is fine): its seeded buffers are checkpointed beside the state and
    restored into the same holder on resume.  The checkpointed tree is
    then the **v2 layout** ``{"model": state, "merge_error": error?,
    "merge_momentum": momentum?}``; without a seeded holder it is the
    bare state (v1).  A restore is driven by the template, so a resumed
    run passes a holder seeded with buffers of the right shapes (zeros
    are fine); an empty holder meeting a v2 checkpoint is told so, and a
    seeded holder meeting a v1 checkpoint restores the model and keeps
    its buffers.
    """

    def __init__(self, step_fn: Callable, init_state: Any,
                 batch_fn: Callable[[int], Any],
                 config: TrainerConfig = TrainerConfig(),
                 state_placer: Optional[Callable] = None,
                 merge_state: Optional[dict] = None,
                 stream_tag: Optional[str] = None,
                 stream_spw: Optional[int] = None):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.cfg = config
        # an out-of-core rotation's identity (a StreamProgram's, see
        # data.pipeline): checkpoints carry it and a restore under another
        # rotation is refused
        self._stream_tag = stream_tag
        self._stream_spw = stream_spw
        plan = config.merge_plan
        if plan is not None:
            if config.merge_every != 1 or \
                    config.merge_compression is not None:
                raise ValueError(
                    "pass either TrainerConfig.merge_plan or the legacy "
                    "merge_every/merge_compression knobs, not both")
            if isinstance(plan, str):
                from repro_torch.distributed import merge_plan as mp
                plan = mp.MergePlan.resolve(plan)
            if getattr(plan, "adaptive", False) or \
                    getattr(plan, "auto", False):
                raise ValueError(
                    "TrainerConfig.merge_plan cannot be adaptive or "
                    "auto: the Trainer aligns flush/checkpoint "
                    "boundaries to a FIXED cadence, but controller-"
                    "driven plans (AdaptiveCadence, merge_plan=\"auto\")"
                    " re-decide k mid-run — a boundary computed from "
                    "the starting cadence could checkpoint "
                    "vDPU-unsynced state")
            self._merge_every = plan.cadence
            self._merge_compression = plan.compression
        else:
            self._merge_every = config.merge_every
            self._merge_compression = config.merge_compression
        self.state = init_state
        self.merge_state = merge_state
        self.start_step = 0
        self._ewma = None
        self._restarts = 0
        self.straggler_steps = 0
        self.history: list = []
        self._sink: Optional[_MetricsSink] = None
        # structured recovery (cfg.recovery): the detector is fed at
        # flush boundaries, the divergences in a row drive the cadence
        # ladder, and every decision goes into the trace
        self._detector = (config.recovery.detector()
                          if config.recovery is not None else None)
        self._consec_div = 0
        self.recovery_trace: list = []
        # round-granular dispatch (for_program at cadence > 1): a call
        # runs _steps_per_call local steps and returns their metrics as a
        # list; _round_factory(k) builds a shorter round
        self._steps_per_call = 1
        self._round_factory: Optional[Callable[[int], Callable]] = None

        self.ckpt = None
        if config.ckpt_dir:
            self.ckpt = CheckpointManager(
                config.ckpt_dir, keep=config.ckpt_keep)
            resumed = self._restore_latest(init_state, state_placer)
            if resumed is not None:
                step, state, extra = resumed
                saved_cmp = extra.get("merge_compression")
                if saved_cmp is not None and \
                        saved_cmp != self._compression_tag():
                    raise ValueError(
                        f"checkpoint written under merge compression "
                        f"{saved_cmp!r} but trainer configured with "
                        f"{self._compression_tag()!r} — the EF residual "
                        f"is not transferable across compression "
                        f"settings")
                saved_stream = extra.get("stream_tag")
                if (saved_stream is not None or
                        self._stream_tag is not None) and \
                        saved_stream != self._stream_tag:
                    raise ValueError(
                        f"checkpoint written under rotation schedule "
                        f"{saved_stream!r} but trainer configured with "
                        f"{self._stream_tag!r} — a resumed streaming "
                        f"run must replay the exact partition sequence "
                        f"(same dataset rows, partition size, seed and "
                        f"shuffle mode), so a drifted rotation is "
                        f"refused rather than silently re-tiled")
                self.state = state
                self.start_step = step + 1
                if merge_state is not None:
                    for k in ("tuning_trace", "cadence_trace"):
                        if extra.get(f"merge_{k}") is not None:
                            merge_state[k] = extra[f"merge_{k}"]

    @classmethod
    def for_program(cls, program, config: Optional[TrainerConfig] = None,
                    *, merge_state: Optional[dict] = None,
                    state_placer: Optional[Callable] = None,
                    sample_seed: int = 0,
                    sample_permutation=None) -> "Trainer":
        """Drive a bound :class:`~repro_torch.core.mlalgos.api.Program`
        under the fault-tolerant loop.

        At cadence 1 a trainer step is one merge-per-step training step
        over the resident data (``Program.step_fn``; the batch function
        is a no-op).  Over a ``StreamProgram`` the batch function is its
        rotation feed (``StreamProgram.batch_feed``) and each checkpoint
        carries the rotation's tag and window.  ``config.batch_size``
        turns on the device sampler, whose counter rides in the
        checkpointed state, so a replay
        resumes the epoch schedule where it left off;
        ``sample_permutation`` is ``fit``'s.

        An exact cadence (``merge_every=k`` or ``MergePlan(cadence=k)``)
        runs one ``Program.round_fn`` merge round a call; history still
        gets an entry a local step, and every checkpoint falls on a
        merge boundary.  Plans that carry an EF buffer or a momentum
        through the round, or re-decide the cadence (overlap,
        compression, SlowMo and Nesterov, adaptive, auto) are refused:
        run them through ``api.fit`` or ``PimGrid.fit``.  So is a grid
        on a mesh of ranks, where every rank would write the same
        checkpoints (ROADMAP item 12b).
        """
        from repro_torch.distributed import merge_plan as mp

        if program.grid.mesh is not None:
            raise NotImplementedError(
                "Trainer over a grid on a mesh of ranks is not ported yet "
                "(ROADMAP queue A, item 12b): every rank would run the "
                "trainer and write the same checkpoint directory; rank 0 "
                "must write and every rank restore the replicated state")
        config = config if config is not None else TrainerConfig()
        if config.merge_plan is None:
            plan = mp.MergePlan.resolve(
                None, merge_every=config.merge_every,
                merge_compression=config.merge_compression)
        else:
            plan = mp.MergePlan.resolve(config.merge_plan)
        unsupported = (plan.overlap or plan.compression is not None
                       or type(plan.outer) is not mp.AverageCommit)
        if unsupported:
            raise ValueError(
                "Trainer.for_program drives exact merge rounds only "
                "(no EF/momentum carry rides in the one-round "
                "round_fn); run overlap/compression/outer-optimizer/"
                "adaptive/auto plans through api.fit or PimGrid.fit")
        cadence = plan.cadence
        sampling = dict(batch_size=config.batch_size,
                        sample_seed=sample_seed,
                        sample_permutation=sample_permutation)
        # a StreamProgram (out-of-core): the batch function is the rotation
        # feed (window step // steps_per_window, prefetched, gathered again
        # on a rollback or restore), and the rotation's tag rides in every
        # checkpoint, so a resumed run replays the same partition sequence
        batch_fn: Callable[[int], Any] = lambda step: None
        stream = {}
        if getattr(program, "is_stream_program", False):
            batch_fn = program.batch_feed(cadence)
            stream = dict(stream_tag=program.stream_tag,
                          stream_spw=batch_fn.spw)
        if cadence == 1:
            step_fn, state0 = program.step_fn(**sampling)
            return cls(step_fn, state0, batch_fn, config,
                       state_placer=state_placer, merge_state=merge_state,
                       **stream)
        round_fn, state0 = program.round_fn(cadence, **sampling)
        tr = cls(round_fn, state0, batch_fn, config,
                 state_placer=state_placer, merge_state=merge_state,
                 **stream)
        tr._steps_per_call = cadence
        rounds = {cadence: round_fn}

        def factory(k):
            if k not in rounds:
                rounds[k] = program.round_fn(k, **sampling)[0]
            return rounds[k]

        tr._round_factory = factory
        return tr

    def _compression_tag(self) -> Optional[str]:
        cmp = self._merge_compression
        return repr(cmp) if cmp is not None else None

    def _seeded_keys(self) -> tuple:
        """The holder's seeded keys (those the checkpoint carries), in
        the v2 layout's order."""
        if self.merge_state is None:
            return ()
        return tuple(k for k in ("error", "momentum")
                     if self.merge_state.get(k) is not None)

    def _ckpt_is_wrapped(self) -> bool:
        """Whether the newest checkpoint on disk has the v2 layout, read
        from its manifest."""
        step = self.ckpt.latest_step()
        if step is None:
            return False
        path = os.path.join(self.ckpt.dir, f"step_{step:010d}",
                            "manifest.json")
        try:
            with open(path) as f:
                names = json.load(f).get("names", [])
        except (OSError, ValueError):
            return False
        return any(n.startswith("['merge_error']")
                   or n.startswith("['merge_momentum']") for n in names)

    def _restore_latest(self, init_state, placer):
        """A template-driven restore that handles layout drift between
        the holder and the checkpoint.  Returns ``(step, state, extra)``
        or None."""
        seeded = bool(self._seeded_keys())
        try:
            resumed = self.ckpt.restore_latest(self._wrap(init_state),
                                               placer=placer)
            if resumed is None:
                return None
            step, tree, extra = resumed
            return step, self._unwrap(tree), extra
        except ValueError as e:
            if seeded and not self._ckpt_is_wrapped():
                # a seeded holder meeting a v1 checkpoint (written before
                # compression): restore the model, keep the seeded buffer
                resumed = self.ckpt.restore_latest(init_state,
                                                   placer=placer)
                if resumed is None:
                    raise
                return resumed
            if not seeded and self._ckpt_is_wrapped():
                raise ValueError(
                    "checkpoint has the merge-state v2 layout "
                    "({'model', 'merge_error'/'merge_momentum'}) but "
                    "merge_state carries no seeded buffers — restore is "
                    "template-driven, so seed the holder to match the "
                    "checkpoint: merge_state={'error': merge_plan."
                    "init_merge_error(grid, wire)} for a compressed run "
                    "(or the holder of a fit under the same plan), "
                    "{'momentum': outer.init(state)} for a SlowMo run, "
                    "or both (zeros are fine)") from e
            raise                  # a genuine structure mismatch

    def _wrap(self, state):
        """The checkpoint's tree: the bare state (v1), or the v2 layout
        when the holder has seeded buffers."""
        keys = self._seeded_keys()
        if not keys:
            return state
        tree = {"model": state}
        for k in keys:
            tree[f"merge_{k}"] = self.merge_state[k]
        return tree

    def _unwrap(self, tree):
        keys = self._seeded_keys()
        if not keys:
            return tree
        for k in keys:
            self.merge_state[k] = tree[f"merge_{k}"]
        return tree["model"]

    def _save(self, step: int):
        extra = {"data_step": step,
                 "merge_compression": self._compression_tag()}
        if self._stream_tag is not None:
            extra["stream_tag"] = self._stream_tag
            extra["rotation_window"] = step // self._stream_spw
        if self.merge_state is not None:
            # the controller's traces are JSON-able lists and dicts: they
            # ride the manifest's extra, so a resumed run keeps them
            for k in ("tuning_trace", "cadence_trace"):
                if self.merge_state.get(k) is not None:
                    extra[f"merge_{k}"] = self.merge_state[k]
        self.ckpt.save(step, self._wrap(self.state), extra=extra)

    # -- structured recovery (cfg.recovery) ---------------------------------

    def _record_recovery(self, event: dict) -> None:
        """Append to the recovery trace, and to the holder's
        ``["tuning_trace"]["recovery"]`` (one holder, one history)."""
        self.recovery_trace.append(event)
        if self.merge_state is not None:
            ts = self.merge_state.setdefault("tuning_trace", {})
            if isinstance(ts, dict):
                lst = ts.setdefault("recovery", self.recovery_trace)
                if lst is not self.recovery_trace:
                    lst.append(event)

    def _degrade_cadence(self, rec, *, reason: str) -> None:
        """One rung of the cadence ladder: halve the cadence by the plan
        controller's shrink rule and take the matching round.  Only
        round-granular trainers (for_program at cadence > 1) have a
        cadence to give; halving keeps old merge boundaries on new ones,
        so the replayed step stays on a boundary."""
        if self._round_factory is None or \
                self._steps_per_call <= rec.min_cadence:
            return
        from repro_torch.tuning.controller import shrink_k

        old = self._steps_per_call
        new = shrink_k(old, rec.min_cadence)
        if new == old:
            return
        self.step_fn = self._round_factory(new)
        self._steps_per_call = new
        self._merge_every = new
        self._consec_div = 0
        self._record_recovery({
            "action": "degrade", "from_cadence": old,
            "to_cadence": new, "restarts": self._restarts,
            "reason": reason,
        })

    # -- main loop ----------------------------------------------------------

    def run(self, n_steps: int, callback: Optional[Callable] = None
            ) -> Dict[str, Any]:
        # the sink outlives the run (closed, not dropped): a window
        # failure parked by an interrupted run stays reachable through
        # trainer._sink.drain() for a post-mortem
        self._sink = (_MetricsSink(self._flush)
                      if self.cfg.async_metrics else None)
        try:
            return self._run(n_steps, callback)
        finally:
            if self._sink is not None:
                self._sink.close()
            # a rotation feed's prefetch thread holds device windows
            close = getattr(self.batch_fn, "close", None)
            if close is not None:
                close()

    def _run(self, n_steps: int, callback: Optional[Callable]
             ) -> Dict[str, Any]:
        step = self.start_step
        end = self.start_step + n_steps
        pending: list = []   # unflushed (step, metrics, dt, stragglers)
        # the rollback of last resort (cfg.recovery only): a failure
        # before the first checkpoint replays from the run's entry state
        origin = (snapshot(self.state)
                  if self.cfg.recovery is not None else None)
        while step < end:
            try:
                # a failure the sink found in an earlier window takes the
                # restore-and-replay path too
                if self._sink is not None:
                    self._sink.poll()
                # round-granular dispatch: a call is a merge round of
                # `stride` local steps; a short last round comes from
                # _round_factory
                stride = 1
                fn = self.step_fn
                if self._round_factory is not None:
                    stride = min(self._steps_per_call, end - step)
                    if stride != self._steps_per_call:
                        fn = self._round_factory(stride)
                t0 = time.perf_counter()
                batch = self.batch_fn(step)
                # hot path: no .item(), float() or .cpu(); the loss stays
                # on the device and the step returns without waiting
                self.state, metrics = fn(self.state, batch)
                dt = time.perf_counter() - t0
                self._track_time(dt)
                last = step + stride - 1
                if self._round_factory is None:
                    pending.append(
                        (step, metrics, dt, self.straggler_steps))
                else:
                    # a round returns its local steps' metrics as a list:
                    # an entry each, sharing the round's wall time
                    share = dt / stride
                    for j in range(stride):
                        pending.append((step + j, metrics[j], share,
                                        self.straggler_steps))
                # a boundary inside a merge round waits for the merge:
                # only then is the state the same on every lane and safe
                # to checkpoint
                at_merge = ((last + 1) % self._merge_every == 0
                            or last == end - 1)
                # the checkpoint multiple this window covers must lie past
                # start_step, or cadence > 1 would checkpoint at the first
                # merge boundary (the window covering multiple 0)
                at_ckpt = (self.ckpt is not None and at_merge
                           and last % self.cfg.ckpt_every
                           < self._merge_every
                           and last - last % self.cfg.ckpt_every
                           > self.start_step)
                at_log = at_merge and last % self.cfg.log_every \
                    < self._merge_every
                if at_ckpt or at_log or last == end - 1:
                    if self._sink is not None:
                        # hand the window over; wait only where it
                        # matters: before a checkpoint, a callback, or
                        # the end
                        self._sink.submit(pending)
                        pending = []
                        if at_ckpt or last == end - 1 or \
                                (callback and at_log):
                            self._sink.drain()
                        if callback and at_log:
                            callback(last, self.history[-1])
                    else:
                        # verify and materialise the window (raises before
                        # a checkpoint could capture a post-NaN state)
                        flushed = self._flush(pending)
                        pending = []
                        if callback and at_log:
                            callback(last, flushed[-1])
                    if at_ckpt:
                        self._save(last)
                    # a whole window verified clean ends a divergence
                    # streak
                    self._consec_div = 0
                step = last + 1
            except (FloatingPointError, RuntimeError) as e:  # failure path
                if isinstance(e, UNRECOVERABLE):
                    raise
                pending = []
                self._restarts += 1
                rec = self.cfg.recovery
                budget = (rec.max_restarts if rec is not None
                          else self.cfg.max_restarts)
                if self.ckpt is None or self._restarts > budget:
                    raise
                t_fail = time.perf_counter()
                if rec is not None:
                    backoff = rec.backoff_s(self._restarts)
                    time.sleep(backoff)
                    if self._detector is not None:
                        # the replay feeds the rolled-back losses again;
                        # they must not meet their own earlier copies
                        self._detector.reset()
                    if isinstance(e, FloatingPointError):
                        self._consec_div += 1
                        if self._consec_div >= rec.degrade_after:
                            self._degrade_cadence(rec, reason=str(e))
                else:
                    backoff = 0.0
                if self._sink is not None:
                    # queued windows cover rolled-back steps: discard them
                    self._sink.reset()
                # a save in flight must land before "latest" is picked
                self.ckpt.wait()
                # the layout-robust restore of construction: a seeded run
                # resumed over v1 checkpoints recovers through them too
                resumed = self._restore_latest(self.state, None)
                if resumed is None:
                    if origin is None:
                        raise RuntimeError(
                            f"step {step} failed ({e}) with no "
                            f"checkpoint") from e
                    # recovery armed and nothing on disk yet: replay the
                    # whole run from its entry state
                    ck_step, self.state = self.start_step - 1, \
                        snapshot(origin)
                else:
                    ck_step, self.state, _ = resumed
                if rec is not None:
                    self._record_recovery({
                        "action": "rollback", "step": step,
                        "restarts": self._restarts,
                        "error": type(e).__name__, "detail": str(e),
                        "to_step": ck_step, "backoff_s": backoff,
                        "latency_s": time.perf_counter() - t_fail,
                    })
                step = ck_step + 1          # replay from the checkpoint
        if self._sink is not None:
            self._sink.drain()
        if self.ckpt:
            self._save(end - 1)
            self.ckpt.wait()
        return {"final_step": end, "restarts": self._restarts,
                "stragglers": self.straggler_steps,
                "history": self.history,
                "recovery_trace": self.recovery_trace}

    def _flush(self, pending) -> list:
        """Verify the buffered steps' metrics and append them to
        ``history``.

        Raises ``FloatingPointError`` at the first non-finite loss (the
        failure path restores and replays, dropping the window).  Fused
        (the default): each loss reduces to a flag on the device, the
        stacked flags come back in one transfer, then the window's
        metrics in one more (:func:`to_host`).  Legacy
        (``fused_finite=False``): ``float(loss)`` a step, the oracle.

        The whole window is verified before anything is appended: a
        partial append would survive the replay as duplicate steps."""
        losses = [(i, m.get("loss")) for i, (_, m, _, _) in
                  enumerate(pending)
                  if hasattr(m, "get") and m.get("loss") is not None]
        if self.cfg.fused_finite and losses:
            oks = np.array([bool(f) for f in to_host(
                [torch.isfinite(torch.as_tensor(l)).all()
                 for _, l in losses])])
            if not oks.all():
                i = losses[int(np.argmin(oks))][0]
                step, metrics = pending[i][0], pending[i][1]
                # the flag takes a loss of any shape, so the report does
                # too (float() of a vector would raise TypeError past the
                # failure path)
                loss = to_host([metrics.get("loss")])[0].ravel()
                bad = loss[~np.isfinite(loss)]
                val = float(bad[0]) if bad.size else float(loss[0])
                raise FloatingPointError(
                    f"non-finite loss {val} at step {step}")
        elif not self.cfg.fused_finite:
            for step, metrics, _, _ in pending:
                loss = float(metrics.get("loss", 0.0))
                if not np.isfinite(loss):
                    raise FloatingPointError(
                        f"non-finite loss {loss} at step {step}")
        # one transfer for the window's metrics
        keys = [list(m) for _, m, _, _ in pending]
        host = iter(to_host([m[k] for (_, m, _, _), ks in zip(pending, keys)
                             for k in ks]))
        mats = [{k: next(host) for k in ks} for ks in keys]
        if self._detector is not None and self._detector.factor > 0.0:
            # loss-spike detection (cfg.recovery.spike_factor): a window
            # that diverges while finite fails before anything is
            # appended or checkpointed
            for (step, _, _, _), metrics in zip(pending, mats):
                loss = metrics.get("loss")
                if loss is None:
                    continue
                val = float(np.asarray(loss).mean())
                if self._detector.observe(val):
                    raise FloatingPointError(
                        f"loss spike {val:.6g} at step {step} "
                        f"(> {self._detector.factor}x window median)")
        flushed = []
        for (step, _, dt, stragglers), metrics in zip(pending, mats):
            entry = dict(metrics, step=step, wall_time=dt,
                         stragglers=stragglers)
            entry = {k: (float(v) if hasattr(v, "item") or
                         isinstance(v, (int, float)) else v)
                     for k, v in entry.items()}
            self.history.append(entry)
            flushed.append(entry)
        return flushed

    # -- straggler tracking ---------------------------------------------------

    def _track_time(self, dt: float):
        if self._ewma is None:
            self._ewma = dt
            return
        if dt > self.cfg.straggler_factor * self._ewma:
            self.straggler_steps += 1
        self._ewma = 0.9 * self._ewma + 0.1 * dt
