"""Data pipeline with the paper's residency model (insights I3/I4).

Port of ``repro.data.pipeline``:

* ``ShardedDataset`` — the training set placed across the vDPU grid once
  (``PimGrid.shard_rows``), resident for every iteration;
* ``TokenStream`` — a deterministic synthetic LM token stream, pure in
  ``(seed, step)`` so a restart replays it;
* ``Prefetcher`` — a background thread producing the next items of an
  iterator while the consumer works on the current one;
* ``StreamingDataset`` / ``PartitionRotation`` / ``run_streaming_fit`` —
  out-of-core training: the dataset lives on the host (numpy or
  ``np.memmap``) and one resident-sized row partition at a time is on
  the device, rotated between merge rounds.

DESIGN — out-of-core partition rotation
---------------------------------------

The paper's thesis is that training is memory-bound because it
"repeatedly accesses large training datasets"; PIM-Opt (arXiv
2404.07164) trains on terabyte-class Criteo, which no card holds.  The
rotation is the JAX package's, in PyTorch's terms:

* **rotation = the minibatch schedule, lifted to the host.**  The
  resident placement lays ``n`` rows out as ``(n_vdpus, per)`` slots.
  Window ``t`` holds the ``part`` slots a vDPU that
  ``core.minibatch.host_schedule(per, part, seed, t)`` names: the
  sampler's own schedule, so an epoch of ``ceil(per / part)`` windows
  visits every slot once (a padded last window carries a zero mask).
  ``shuffle=True`` draws the sampler's permutation
  (``minibatch.hashed_permutation``, or ``StreamingDataset.permutation``
  when given, as ``api.fit(sample_permutation=)``); ``shuffle=False``
  tiles the slots in order.
* **exactness.**  A window's partials are scaled by ``per / n_valid``,
  the sampler's unbiased scale (``make_scaled_local``, one multiply of
  every partial by the window's ``"scale"`` leaf, outside the minibatch
  sampler when one runs inside the window).  So a rotation with
  ``steps_per_window=1`` equals the resident fit with ``batch_size=part``
  bit for bit, and a ``shuffle=False`` single-window stream (no scale:
  ``exact_full``) equals the resident full-batch fit.  The quantized
  workloads quantize each window against scales of the whole dataset
  (``StreamingDataset.feature_absmax``), so a window's integers are the
  resident set's.
* **windows align with the merge cadence.**  ``steps_per_window`` must
  be a multiple of the cadence; each window is one ``PimGrid.fit`` of
  that many steps, so EF and momentum buffers continue across windows
  through ``merge_state`` as they continue across fits.
* **the worker stays cheap.**  The prefetch thread gathers a window
  (``np.take`` into a reused ``_StagingRing`` buffer), quantizes it in
  numpy (``quantize_fixed_scale_np``: the copy ships int8 or int16
  bytes), and stages it: each leaf is copied into a pinned host buffer
  of the rotation and from there to the card with ``non_blocking=True``
  on a side CUDA stream the rotation owns.  The worker waits on the
  copies' event before it releases the pinned buffers or hands the
  window over, so a buffer is never refilled under a copy in flight and
  the consumer never reads a window before it has landed (a host wait
  on the worker thread, ~ms for a window's bytes; the main thread's
  stream never waits on it).  Each device tensor was allocated on the
  side stream and is read on the consumer's: ``record_stream`` tells the
  caching allocator, so its memory is not handed out again while the
  consumer's kernels still read it.
* **residency.**  ``run_streaming_fit`` drops a window's tensors as soon
  as its fit returns (``_release_window``; the allocator keeps them
  until the stream has passed their last use), so at most ``depth``
  windows wait in the queue, one more is held by the worker and one is
  trained on: ``depth + 2`` windows on the device.
* **failures surface.**  A worker's exception is kept and re-raised by
  the consumer's ``next``: a failed gather or copy ends the fit with its
  own error, never a silent end of the stream.  Nothing falls back: a
  stream bound to a grid on the card stages on the card.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.core import minibatch as mb
from repro_torch.device import resolve_device


@dataclasses.dataclass
class ShardedDataset:
    """Memory-resident sharded dataset (see ``PimGrid.shard_rows``)."""

    data: Any                  # dict of (n_vdpus, rows_per_vdpu, ...)
    n_rows: int

    @classmethod
    def place(cls, grid, X, *extras):
        data, n = grid.shard_rows(X, *extras)
        return cls(data=data, n_rows=n)


class TokenStream:
    """Deterministic synthetic LM token stream: next token = a seeded
    choice among 8 successors of the previous one, or a random token, so
    a model has structure to learn.  ``batch_at(step)`` is pure in
    ``(seed, step)`` and returns int32 tokens on ``device`` (the card
    unless named, see ``resolve_device``); the numbers are numpy's, as in
    the JAX package.

    >>> a = TokenStream(vocab_size=64, batch=2, seq_len=8, seed=3, device="cpu")
    >>> b = TokenStream(vocab_size=64, batch=2, seq_len=8, seed=3, device="cpu")
    >>> bool((a.batch_at(7)["tokens"] == b.batch_at(7)["tokens"]).all())
    True
    """

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, structure: float = 0.8, device=None):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.structure = structure
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        # sparse deterministic bigram successor table (8 choices per token)
        self._succ = rng.integers(0, vocab_size, size=(vocab_size, 8),
                                  dtype=np.int32)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        B, S = self.batch, self.seq
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, B)
        choice = rng.integers(0, 8, (B, S))
        rand = rng.integers(0, self.vocab, (B, S), dtype=np.int32)
        use_rand = rng.random((B, S)) > self.structure
        for t in range(1, S):
            nxt = self._succ[toks[:, t - 1], choice[:, t]]
            toks[:, t] = np.where(use_rand[:, t], rand[:, t], nxt)
        return {"tokens": torch.from_numpy(toks).to(self.device)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background prefetch of an iterator: a worker thread pulls the
    next items (and runs ``transform`` on them) while the consumer works,
    at most ``depth`` of them waiting.

    The worker's put is stop-aware (a full queue never deadlocks
    ``close``), ``close`` joins the thread, ``__next__`` after ``close``
    raises, and an exception of the worker (in the iterator or the
    transform) is raised again by ``__next__``.  Seconds to produce each
    item (worker side) and seconds the consumer waited for it land in
    ``produce_s`` and ``stall_s``.

    >>> pf = Prefetcher(iter(range(4)), depth=2)
    >>> [x for x in pf]
    [0, 1, 2, 3]
    >>> pf.close()
    """

    _SENTINEL = object()

    def __init__(self, it: Iterator, depth: int = 2,
                 transform: Optional[Callable] = None):
        if depth < 1:
            raise ValueError(f"Prefetcher depth must be >= 1, got {depth}")
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._closed = False
        self._done = False
        self._error: Optional[BaseException] = None
        self._transform = transform
        self.produce_s: list = []    # worker: seconds to produce item i
        self.stall_s: list = []      # consumer: seconds blocked for item i

        def worker():
            try:
                while True:
                    # the whole production: the pull (a gather lives in the
                    # generator) and the transform (staging)
                    t0 = time.perf_counter()
                    try:
                        item = next(it)
                    except StopIteration:
                        break
                    if self._stop.is_set():
                        return
                    if self._transform:
                        item = self._transform(item)
                    self.produce_s.append(time.perf_counter() - t0)
                    if not self._put(item):
                        return
            except BaseException as e:       # handed to the consumer
                self._error = e
            finally:
                self._put(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Stop-aware put: never blocks forever on a full queue."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise RuntimeError(
                "Prefetcher is closed — __next__ would never produce "
                "an item")
        if not self._done:
            t0 = time.perf_counter()
            item = self._q.get()
            if item is not self._SENTINEL:
                self.stall_s.append(time.perf_counter() - t0)
                return item
            self._done = True
        if self._error is not None:
            raise self._error
        raise StopIteration

    def close(self):
        """Stop the worker, join it, and invalidate the iterator.
        Idempotent; safe with the queue full (the worker's put is
        stop-aware) or with a consumer blocked in ``__next__`` (the
        drained queue is re-primed with the sentinel)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        try:                             # unblock a worker stuck in put()
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)
        try:                             # wake a consumer blocked in get()
            self._q.put_nowait(self._SENTINEL)
        except queue.Full:
            pass


# ---------------------------------------------------------------------------
# Out-of-core streaming ingestion
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StreamingDataset:
    """An out-of-core training source: host row arrays (numpy or
    ``np.memmap``) rotated through device memory a resident-sized
    partition at a time.

    ``partition_rows`` is the resident-row budget of the whole grid.
    ``steps_per_window`` local steps run on each window (default: one
    merge round).  ``shuffle=True`` draws each epoch's order from the
    sampler's permutation of ``(seed, epoch)``, ``permutation`` when
    given (``minibatch.Permutation``, as ``api.fit``'s
    ``sample_permutation``), else ``minibatch.hashed_permutation``;
    ``shuffle=False`` tiles the slots in order.

    >>> import numpy as np
    >>> sd = StreamingDataset(np.ones((100, 4), np.float32),
    ...                       np.zeros(100, np.float32),
    ...                       partition_rows=32)
    >>> sd.n_rows, sd.n_features
    (100, 4)
    """

    is_streaming_source = True

    X: Any
    y: Any = None
    partition_rows: int = 0
    prefetch_depth: int = 2
    steps_per_window: Optional[int] = None
    seed: int = 0
    shuffle: bool = True
    permutation: Optional[mb.Permutation] = None

    def __post_init__(self):
        self.X = np.asarray(self.X)
        if self.y is not None:
            self.y = np.asarray(self.y)
            if len(self.y) != len(self.X):
                raise ValueError(
                    f"X has {len(self.X)} rows but y has {len(self.y)}")
        if self.partition_rows < 1:
            raise ValueError(
                f"partition_rows must be >= 1, got {self.partition_rows}")
        if self.prefetch_depth < 0:
            raise ValueError(
                f"prefetch_depth must be >= 0, got {self.prefetch_depth}")
        if self.steps_per_window is not None and self.steps_per_window < 1:
            raise ValueError(
                f"steps_per_window must be >= 1, got "
                f"{self.steps_per_window}")

    @property
    def n_rows(self) -> int:
        return int(self.X.shape[0])

    @property
    def n_features(self) -> int:
        return int(self.X.shape[1])

    def rows(self, idx) -> np.ndarray:
        """Random access into the host rows (K-means' initial
        centroids)."""
        return np.take(self.X, np.asarray(idx), axis=0)

    def feature_absmax(self, block_rows: int = 1 << 18) -> np.ndarray:
        """Per-feature ``max |x|`` as ``(1, d)`` float32, in one blocked
        host pass: the statistic the quantized streaming paths take their
        scales from (``quantize_symmetric(X, axis=0)``'s reduction over
        the whole dataset)."""
        amax = np.zeros((1, self.n_features), np.float32)
        for lo in range(0, self.n_rows, block_rows):
            blk = np.abs(np.asarray(self.X[lo:lo + block_rows],
                                    np.float32))
            np.maximum(amax, blk.max(axis=0, keepdims=True), out=amax)
        return amax

    def label_absmax(self, block_rows: int = 1 << 18) -> np.float32:
        amax = np.float32(0.0)
        for lo in range(0, self.n_rows, block_rows):
            blk = np.abs(np.asarray(self.y[lo:lo + block_rows],
                                    np.float32))
            amax = np.maximum(amax, blk.max() if blk.size else 0.0)
        return np.float32(amax)

    def bind(self, grid, transform: Optional[Callable] = None
             ) -> "PartitionRotation":
        """The rotation on ``grid`` for a raw ``grid.fit`` (workloads
        bind through ``Workload.bind_stream``).  ``transform(X_rows,
        y_rows) -> (X', extra0, ...)`` maps a window's host rows to the
        resident representation (labels, quantization); the identity by
        default."""
        return PartitionRotation(self, grid, transform=transform)


class _StagingRing:
    """Reused host gather buffers: a gather takes a free buffer (a new
    one when none fits) and gives it back once its window no longer reads
    it, so the rotation gathers into the same few buffers whatever the
    number of windows, and two gathers in flight (the worker's and a
    synchronous caller's) never share one.  At most ``size`` are kept."""

    def __init__(self, size: int):
        self._size = max(2, size)
        self._free: list = []
        self._lock = threading.Lock()

    def take(self, src: np.ndarray, flat_idx: np.ndarray) -> np.ndarray:
        shape = (len(flat_idx),) + src.shape[1:]
        with self._lock:
            buf = self._free.pop() if self._free else None
        if buf is None or buf.shape != shape or buf.dtype != src.dtype:
            buf = np.empty(shape, src.dtype)
        np.take(src, flat_idx, axis=0, out=buf, mode="clip")
        return buf

    def give(self, buf: np.ndarray) -> None:
        with self._lock:
            if len(self._free) < self._size:
                self._free.append(buf)


class PartitionRotation:
    """A :class:`StreamingDataset` bound to a grid: the device windows
    the engine trains on, in the epoch-exact rotation order (see the
    module DESIGN).

    A window is ``PimGrid.shard_rows``' dict — ``{"X", "w", "y0", ...}``
    shaped ``(lanes, part, ...)``, ``lanes`` the grid's ``n_local`` (all
    of them without a mesh) — plus a per-lane ``"scale"`` leaf, the
    unbiased scale ``per / n_valid`` that ``run_streaming_fit`` multiplies
    the window's partials by.  On a mesh a rank gathers its own lanes'
    rows; ``per``, ``part``, the schedule and :meth:`tag` are global, so
    every rank draws the same windows.
    """

    is_streaming_rotation = True

    def __init__(self, stream: StreamingDataset, grid,
                 transform: Optional[Callable] = None):
        self.stream = stream
        self.grid = grid
        self._transform = transform
        n, nv = stream.n_rows, grid.n_vdpus
        self.per = -(-n // nv)                      # resident slots/vDPU
        self.part = max(1, min(self.per,
                               -(-stream.partition_rows // nv)))
        self.windows_per_epoch = mb.epoch_steps(self.per, self.part)
        # one window of every slot: the mask is all ones and the scale
        # exactly 1, so the fit leaves the scale out and (shuffle=False)
        # runs the resident fit's own arithmetic
        self.exact_full = self.part == self.per
        self._ring = _StagingRing(stream.prefetch_depth + 2)
        self._sched_cache: dict = {}
        self._sched_lock = threading.Lock()
        self.last_run_stats: Optional[dict] = None
        # H2D staging on the card: pinned buffers (one a leaf), a side
        # stream, the consumer's stream (this thread's, at bind time)
        self._stage_lock = threading.Lock()
        self._pinned: dict = {}
        dev = grid.device
        self._side = (torch.cuda.Stream(dev) if dev.type == "cuda"
                      else None)
        self._consumer = (torch.cuda.current_stream(dev)
                          if dev.type == "cuda" else None)

    # -- schedule ------------------------------------------------------

    def steps_per_window(self, cadence: int) -> int:
        """Local steps a window: the stream's setting, or one merge
        round.  Windows must hold whole merge rounds."""
        spw = self.stream.steps_per_window
        if spw is None:
            spw = cadence
        if spw % cadence:
            raise ValueError(
                f"steps_per_window={spw} must be a multiple of the "
                f"merge cadence {cadence}: a rotation boundary inside "
                f"a merge round would swap data under vDPU-divergent "
                f"states")
        return spw

    def schedule(self, t: int):
        """``(idx, mask)`` of window ``t``: ``minibatch.host_schedule``,
        kept for the last 4,096 windows asked for."""
        with self._sched_lock:
            got = self._sched_cache.get(t)
        if got is None:
            s = self.stream
            got = mb.host_schedule(self.per, self.part, s.seed, t,
                                   shuffle=s.shuffle,
                                   permutation=s.permutation)
            with self._sched_lock:
                self._sched_cache[t] = got
                while len(self._sched_cache) > 4096:
                    self._sched_cache.pop(next(iter(self._sched_cache)))
        return got

    def prewarm_schedules(self, ts) -> None:
        """Draw window schedules ahead of a fit, on the calling thread.
        The fits leave the schedule to the prefetch worker (a torch
        call there does not queue behind the main thread's work, as a
        JAX execution does)."""
        for t in ts:
            self.schedule(t)

    def tag(self) -> str:
        """The rotation's identity, checkpointed by the ``Trainer`` so a
        resumed run refuses another partition sequence.  With
        ``shuffle=False`` it is the JAX package's text; with
        ``shuffle=True`` it also names the permutation, which is not
        JAX's."""
        s = self.stream
        text = (f"rotation(n={s.n_rows}, n_vdpus={self.grid.n_vdpus}, "
                f"part={self.part}, spw={s.steps_per_window}, "
                f"seed={s.seed}, shuffle={s.shuffle}")
        if s.shuffle:
            perm = s.permutation
            name = "hashed" if perm is None else (
                f"{getattr(perm, '__module__', '')}."
                f"{getattr(perm, '__qualname__', type(perm).__name__)}")
            text += f", perm={name}"
        return text + ")"

    # -- windows -------------------------------------------------------

    def window_host(self, t: int) -> dict:
        """Host arrays of window ``t``, pure in ``(seed, t)``: a replayed
        window holds the same rows."""
        s, per, part = self.stream, self.per, self.part
        lanes = self.grid.n_local
        lo = self.grid.shard_index * lanes
        idx, mask = self.schedule(t)
        n = s.n_rows
        # slot (v, i) -> row v*per + idx[i]; rows past n are the shard
        # padding (zero rows, w = 0), as shard_rows lays them out
        rows = (np.arange(lo, lo + lanes, dtype=np.int64)[:, None] * per
                + idx[None, :].astype(np.int64))
        real = (rows < n).astype(np.float32)
        flat = rows.ravel()
        Xb = self._ring.take(s.X, flat)
        try:
            yb = None if s.y is None else np.take(
                s.y, np.clip(flat, 0, n - 1), axis=0)
            if self._transform is not None:
                out = self._transform(Xb, yb)
            else:
                out = (Xb,) if yb is None else (Xb, yb)
            Xt, extras = out[0], out[1:]
            w = real * mask[None, :]
            d = {"X": np.asarray(Xt).reshape((lanes, part)
                                             + np.shape(Xt)[1:]),
                 "w": w}
            for i, e in enumerate(extras):
                d[f"y{i}"] = np.asarray(e).reshape((lanes, part)
                                                   + np.shape(e)[1:])
            # pad and masked slots hold zero rows, as shard_rows' padding
            # (a new array: the window no longer reads the gather buffer)
            wz = w.astype(bool)
            d["X"] = np.where(wz[(...,) + (None,) * (d["X"].ndim - 2)],
                              d["X"], np.zeros((), d["X"].dtype))
        finally:
            self._ring.give(Xb)
        valid = np.float32(mask.sum(dtype=np.float32))
        scale = np.float32(per) / np.maximum(valid, np.float32(1.0))
        if not self.exact_full:
            d["scale"] = np.full((lanes,), scale, np.float32)
        return d

    def place(self, host_dict: dict) -> dict:
        """H2D: the window's arrays as tensors on the grid's device.  On
        the card each leaf goes through a pinned buffer of the rotation
        and a ``non_blocking`` copy on its side stream; the call returns
        once the copies have landed (see the module DESIGN)."""
        dev = self.grid.device
        if self._side is None:
            return {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for k, a in host_dict.items()}
        out = {}
        with self._stage_lock, torch.cuda.stream(self._side):
            for k, a in host_dict.items():
                a = np.ascontiguousarray(a)
                buf = self._pinned.get(k)
                if buf is None or tuple(buf.shape) != a.shape or \
                        buf.numpy().dtype != a.dtype:
                    buf = torch.from_numpy(a).pin_memory()
                    self._pinned[k] = buf
                else:
                    np.copyto(buf.numpy(), a)
                t = buf.to(dev, non_blocking=True)
                # allocated on the side stream, read on the consumer's
                t.record_stream(self._consumer)
                out[k] = t
            landed = torch.cuda.Event()
            landed.record(self._side)
            landed.synchronize()
        return out

    def window_data(self, t: int) -> dict:
        """Window ``t`` on the device (the synchronous path)."""
        return self.place(self.window_host(t))

    def windows(self, start: int = 0,
                stop: Optional[int] = None) -> Iterator[dict]:
        """Host windows from ``start`` on, up to ``stop`` (excluded;
        without end when None)."""
        t = start
        while stop is None or t < stop:
            yield self.window_host(t)
            t += 1

    def prefetcher(self, start: int = 0, depth: Optional[int] = None,
                   stop: Optional[int] = None) -> Prefetcher:
        """Windows ``start`` to ``stop`` gathered and staged on a worker
        thread.  A fit that knows its last window passes ``stop``: a
        gather cannot be interrupted, so ``close`` would wait for a
        window past the end."""
        depth = self.stream.prefetch_depth if depth is None else depth
        return Prefetcher(self.windows(start, stop), depth=max(1, depth),
                          transform=self.place)


def _release_window(d: Optional[dict]) -> None:
    """Drop a consumed window's tensors (``Tensor.delete`` has no torch
    counterpart): the caching allocator frees them once the streams have
    passed their last use, keeping residency at ``depth + 2`` windows."""
    if d is not None:
        d.clear()


def make_scaled_local(local_fn: Callable) -> Callable:
    """Wrap an engine ``local_fn`` for rotation windows: take the
    ``"scale"`` leaf out of the slice and multiply every partial by it,
    the sampler's ``per / n_valid`` multiply hoisted to the window.  The
    scale is per lane, ``(lanes,)``, broadcast against each partial's
    leading lane dim."""

    def streaming_local_fn(state, sl):
        scale = sl["scale"]
        rows = {k: v for k, v in sl.items() if k != "scale"}
        return {k: v * scale.reshape((-1,) + (1,) * (v.dim() - 1))
                for k, v in local_fn(state, rows).items()}

    return streaming_local_fn


def run_streaming_fit(grid, rotation: PartitionRotation, *, init_state,
                      local_fn, update_fn, steps: int, plan,
                      merge_state: Optional[dict] = None,
                      callback: Optional[Callable] = None,
                      scan_chunk: int = 32, engine: str = "scan"):
    """The out-of-core fit: one ``PimGrid.fit`` of
    ``steps_per_window`` steps a window, while the prefetcher gathers and
    stages the next windows behind the current one's compute.

    ``PimGrid.fit`` dispatches here when ``data`` is a
    :class:`PartitionRotation`; each window's fit runs the whole engine
    on the eager rounds (scan or python, any static plan, an armed fault
    plan; the scan engine's captured chunks would bind each new window),
    and EF and momentum continue across windows through
    ``merge_state``.  Returns ``(state, history)``, an entry a local
    step, and leaves the ingest, stall and overlap statistics in
    ``rotation.last_run_stats`` (and ``merge_state["streaming_trace"]``
    when a holder is passed).
    """
    if plan.adaptive or plan.auto:
        raise ValueError(
            "streaming ingestion cannot drive controller plans "
            "(AdaptiveCadence / merge_plan=\"auto\"): the controller "
            "re-probes per fit, and a per-window probe would measure "
            "rotation noise, not the plan — pick an explicit MergePlan")
    spw = rotation.steps_per_window(plan.cadence)
    scaled_lf = (local_fn if rotation.exact_full
                 else make_scaled_local(local_fn))
    depth = rotation.stream.prefetch_depth

    state = init_state
    history: list = []
    done = 0
    window = 0
    produce_s: list = []
    stall_s: list = []
    pf = (rotation.prefetcher(0, stop=-(-steps // spw)) if depth >= 1
          else None)
    try:
        while done < steps:
            t0 = time.perf_counter()
            if pf is not None:
                data = next(pf)
                stall = time.perf_counter() - t0
            else:
                data = rotation.window_data(window)
                stall = time.perf_counter() - t0
                produce_s.append(stall)          # fully exposed ingest
            stall_s.append(stall)
            k = min(spw, steps - done)
            cb = None
            if callback is not None:
                def cb(step, st, m, _off=done, _cb=callback):
                    return _cb(_off + step, st, m)
            try:
                # eager rounds: a window is new tensors, which a chunk
                # runner would capture again (ROADMAP item 19b)
                state, h = grid._fit(
                    plan, init_state=state, local_fn=scaled_lf,
                    update_fn=update_fn, data=data, steps=k,
                    merge_state=merge_state, engine=engine,
                    scan_chunk=scan_chunk, callback=cb, compiled=False)
            finally:
                _release_window(data)
            history.extend(h)
            done += k
            window += 1
    finally:
        if pf is not None:
            produce_s = list(pf.produce_s)
            pf.close()

    # steady-state overlap: the pipeline-fill windows (the first
    # min(depth, windows - 1)) pay their ingest by construction
    skip = min(max(depth, 1), max(len(stall_s) - 1, 0))
    ingest_steady = float(sum(produce_s[skip:len(stall_s)]))
    stall_steady = float(sum(stall_s[skip:]))
    overlap = (1.0 - min(stall_steady / ingest_steady, 1.0)
               if ingest_steady > 0 else 1.0)
    stats = {
        "windows": len(stall_s),
        "windows_per_epoch": rotation.windows_per_epoch,
        "steps_per_window": spw,
        "prefetch_depth": depth,
        "ingest_s": float(sum(produce_s[:len(stall_s)])),
        "stall_s": float(sum(stall_s)),
        "ingest_s_steady": ingest_steady,
        "stall_s_steady": stall_steady,
        "ingest_overlap_fraction": overlap,
    }
    rotation.last_run_stats = stats
    if merge_state is not None:
        merge_state["streaming_trace"] = stats
    return state, history


class RotationFeed:
    """A deterministic ``batch_fn(step)`` over a rotation for the
    ``Trainer``: window ``step // steps_per_window``, prefetched in
    order and rebuilt on any other request (a restore or rollback
    gathers its window again).  ``close`` stops the prefetcher; the next
    call starts one again."""

    def __init__(self, rotation: PartitionRotation,
                 steps_per_window: int):
        if steps_per_window < 1:
            raise ValueError(
                f"steps_per_window must be >= 1, got {steps_per_window}")
        self.rotation = rotation
        self.spw = steps_per_window
        self._pf: Optional[Prefetcher] = None
        self._cur_w = -1
        self._cur: Optional[dict] = None

    def __call__(self, step: int) -> dict:
        w = step // self.spw
        if w == self._cur_w:
            return self._cur
        depth = self.rotation.stream.prefetch_depth
        if self._pf is None or w != self._cur_w + 1:
            if self._pf is not None:
                self._pf.close()
            self._pf = (self.rotation.prefetcher(w)
                        if depth >= 1 else None)
        prev = self._cur
        if self._pf is not None:
            self._cur = next(self._pf)
        else:
            self._cur = self.rotation.window_data(w)
        self._cur_w = w
        _release_window(prev)
        return self._cur

    def close(self):
        if self._pf is not None:
            self._pf.close()
            self._pf = None
