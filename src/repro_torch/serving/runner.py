"""Batch inference: ``Workload.predict`` behind a bucket ladder, one
captured CUDA graph per bucket on the card.

Port of ``repro.serving.runner``.  Requests arrive at any batch size;
the :class:`PredictRunner` closes the shape set:

* a request pads with zero rows up to a small **bucket ladder**
  (default 8 / 32 / 128 / 512 rows) and the result is sliced back to
  the true length: ``Workload.predict`` is pad-invariant (zero rows never
  move a per-feature quantization absmax, and every forward reduction is
  row-local);
* a batch larger than the top bucket splits into top-bucket chunks plus
  one bucketed remainder;
* each (workload, bucket, n_features, state shapes, device) is captured
  once, in the grid's cache (``merge_plan.cache_get`` / ``cache_put``
  keyed by ``fn_signature``, which keys the workload by value), so two
  runners of equal configurations share graphs, across registry
  hot-swaps too: the state is an *input* of the graph, copied into its
  static buffer by each call, never a constant of it.

On ``cuda`` a cache entry is one ``torch.cuda.CUDAGraph`` of
``workload.predict(state, X)`` (:class:`BucketEntry`, on
``core.graphs.Graph``), which JAX's
ahead-of-time compiled executable becomes: a call copies the state into
the entry's static state, stages the rows into its static input (through
a pinned buffer, ``non_blocking``), replays the graph and clones its
output's first rows, all under the entry's lock, so two runners sharing
the entry never read each other's weights.  The kernels launch inside
the replay, where no Python runs: the wrappers' launch counters count
the capture only.  A failed capture or replay raises; nothing falls back
to the eager forward.  The port has no buffer donation, so the key drops
JAX's ``donating_backend()``.  On the CPU an entry runs the eager
forward on the same static buffers, under the same lock, and is cached
and counted the same way.

Counters (``bucket_hits`` / ``compile_misses`` /
``steady_compile_misses``): after :meth:`~PredictRunner.warmup`, steady
traffic must capture nothing more.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.graphs import Graph
from repro_torch.distributed import merge_plan as mp
from repro_torch.tree import tree_leaves, tree_unflatten

DEFAULT_BUCKETS = (8, 32, 128, 512)
# forward calls on the capture stream before the capture: the first one
# builds the kernels' libraries and cuBLAS's workspace, and fills the
# wrappers' caches, none of which may happen inside a capture
WARMUP_CALLS = 2


def _buffers(state, bucket: int, d: int) -> tuple:
    """An entry's static state (a copy of ``state``'s leaves), that state
    as a tree for the forward, and its zero ``(bucket, d)`` input."""
    leaves = tree_leaves(state)
    static = [leaf.detach().clone() for leaf in leaves]
    x = torch.zeros((bucket, d), dtype=torch.float32,
                    device=leaves[0].device)
    return static, tree_unflatten(state, static), x


class BucketEntry:
    """One cached (configuration, bucket): static state, input and output
    buffers, and ``replay``, which recomputes ``out`` from ``state`` and
    ``x``: a captured CUDA graph's replay on the card (:meth:`capture`),
    the eager forward on the CPU (:meth:`eager`), or any callable that
    does the same (a test's stand-in)."""

    def __init__(self, state: list, x: torch.Tensor, out: torch.Tensor,
                 replay: Callable[[], None]):
        self.state, self.x, self.out, self.replay = state, x, out, replay
        self.lock = threading.Lock()
        self._card = x.device.type == "cuda"
        self._turn = 0
        if self._card:
            # two pinned buffers in turn: staging a call waits only for
            # the copy out of the buffer two calls back
            self._pinned = [(torch.empty(tuple(x.shape), dtype=x.dtype,
                                         pin_memory=True),
                             torch.cuda.Event()) for _ in range(2)]
            self._done = torch.cuda.Event()

    @classmethod
    def eager(cls, fwd: Callable, state, bucket: int, d: int
              ) -> "BucketEntry":
        """The CPU entry: ``replay`` runs ``fwd`` on the static buffers
        (``core.graphs.Graph`` on the CPU)."""
        return cls._entry(fwd, state, bucket, d, warmup_calls=0)

    @classmethod
    def capture(cls, fwd: Callable, state, bucket: int, d: int
                ) -> "BucketEntry":
        """Capture ``fwd(state, X)`` for ``(bucket, d)`` float32 rows on
        the card (``core.graphs.Graph``): warm-up calls on the graph's
        side stream, then the capture there in ``thread_local`` mode
        (another thread may copy or allocate on the card meanwhile, as
        the queue's worker and a registry refresh do), into a pool of the
        graph's own: entries may be replayed from several threads, so
        they share none.  The forward only reads its inputs, so it warms
        up on the static buffers themselves."""
        return cls._entry(fwd, state, bucket, d, warmup_calls=WARMUP_CALLS)

    @classmethod
    def _entry(cls, fwd: Callable, state, bucket: int, d: int, *,
               warmup_calls: int) -> "BucketEntry":
        static, st, x = _buffers(state, bucket, d)
        graph = Graph(x.device)
        for _ in range(warmup_calls):
            graph.warm(lambda: fwd(st, x))
        graph.capture(lambda: fwd(st, x))
        if graph.outputs is None:          # the CPU: the first call
            graph.replay()
        return cls(static, x, graph.outputs, graph.replay)

    def run(self, state, X, n: int) -> torch.Tensor:
        """``fwd(state, X padded)[:n]``: the state and the rows copied
        in, the replay and the clone out, under the entry's lock."""
        with self.lock:
            if self._card:
                # the entry's last user may have enqueued on another stream
                torch.cuda.current_stream(self.x.device).wait_event(
                    self._done)
            for buf, leaf in zip(self.state, tree_leaves(state)):
                buf.copy_(leaf)
            self._stage(X, n)
            self.replay()
            out = self.out[:n].clone()
            if self._card:
                self._done.record()
        return out

    def _stage(self, X, n: int) -> None:
        """The rows into ``x``, zero rows after them; rows from the host
        to the card through the pinned buffers."""
        if not self._card or (isinstance(X, torch.Tensor) and X.is_cuda):
            self.x[:n].copy_(torch.as_tensor(X))
            self.x[n:].zero_()
            return
        host = X.numpy() if isinstance(X, torch.Tensor) else X
        pinned, copied = self._pinned[self._turn]
        self._turn ^= 1
        copied.synchronize()            # its last copy to the card is done
        view = pinned.numpy()
        view[:n] = host
        view[n:] = 0.0
        self.x.copy_(pinned, non_blocking=True)
        copied.record()


class PredictRunner:
    """Bucketed ``workload.predict(state, X)``, one CUDA graph a bucket
    on the card.

    ``grid`` is optional: when given, entries live in the grid's cache
    (shared across runners and hot-swapped versions); without one the
    runner keeps a private cache.  The runner runs where its state lives:
    on the CPU only when the state is there.

    >>> import torch
    >>> from repro_torch.core.mlalgos.linreg import LinReg
    >>> r = PredictRunner(LinReg(), torch.ones(3), buckets=(4, 8))
    >>> r.warmup(3)                 # build the ladder, arm the counters
    >>> r.predict(torch.eye(3)).tolist()
    [1.0, 1.0, 1.0]
    >>> r.bucket_for(6), r.bucket_for(100)      # oversize -> chunked
    (8, None)
    >>> r.counters()["steady_compile_misses"]
    0
    """

    def __init__(self, workload, state, *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, grid=None):
        if not getattr(workload, "predict_device", True):
            raise ValueError(
                f"workload {workload.name!r} declares "
                f"predict_device=False (host-only forward pass) — the "
                f"compiled PredictRunner cannot trace it; call "
                f"workload.predict directly instead")
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"bucket ladder must be positive: {buckets}")
        self.workload = workload
        self.state = state
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.grid = grid
        self._private_cache: dict = {}
        # lookup, capture and insert are one critical section: held on
        # the grid's cache lock, so runners sharing a grid capture a key
        # once between them
        self._lock = (mp.CACHE_LOCK if grid is not None
                      else threading.Lock())

        # the captured function: the workload rides in a default argument
        # so fn_signature keys it by value (equal configurations share
        # entries); the state is an argument, so version swaps reuse the
        # entries as long as the state's shapes match
        def fwd(state, X, _w=workload):
            return _w.predict(state, X)

        self._fwd = fwd
        self._signature = mp.fn_signature(fwd)
        self.bucket_hits = 0
        self.compile_misses = 0
        self.steady_compile_misses = 0
        self._warm = False

    # -- the cache -----------------------------------------------------

    def key(self, bucket: int, d: int) -> tuple:
        """The cache key of one ``(bucket, d)`` entry for the current
        state: the forward's signature, the shapes, dtypes and device."""
        leaves = tree_leaves(self.state)
        aval = tuple((tuple(leaf.shape), str(leaf.dtype)) for leaf in leaves)
        return ("serving", self._signature, bucket, d, aval,
                str(leaves[0].device))

    def _compiled(self, bucket: int, d: int):
        """The entry of one (bucket, features) cell, built at most once
        per (workload, bucket, d, state shapes, device)."""
        key = self.key(bucket, d)
        with self._lock:
            if self.grid is not None:
                hit = mp.cache_get(self.grid, key)
            else:
                hit = self._private_cache.get(key)
            if hit is not None:
                return hit
            self.compile_misses += 1
            if self._warm:
                self.steady_compile_misses += 1
            build = (BucketEntry.capture
                     if tree_leaves(self.state)[0].device.type == "cuda"
                     else BucketEntry.eager)
            entry = build(self._fwd, self.state, bucket, d)
            if self.grid is not None:
                mp.cache_put(self.grid, key, entry, self._fwd, self._fwd)
            else:
                self._private_cache[key] = entry
            return entry

    def bucket_for(self, n: int) -> Optional[int]:
        """Smallest ladder bucket holding ``n`` rows (None: oversize,
        the caller chunks by the top bucket)."""
        for b in self.buckets:
            if n <= b:
                return b
        return None

    def mark_warm(self):
        """Declare warmup over: any later capture is a steady-state miss
        (the counter the zero-miss acceptance test reads)."""
        self._warm = True

    def warmup(self, d: int):
        """Capture the whole ladder for ``d`` features, then arm the
        steady-state miss counter."""
        for b in self.buckets:
            self._compiled(b, d)
        self.mark_warm()

    # -- the serve path ------------------------------------------------

    @staticmethod
    def _rows(X):
        """A request as float32 rows: a tensor stays where it is (rows
        on the card are copied on the card), anything else becomes a
        numpy array (staged through pinned memory)."""
        if isinstance(X, torch.Tensor):
            Xn = X.detach().to(torch.float32)
        else:
            Xn = np.asarray(X, np.float32)
        if Xn.ndim != 2:
            raise ValueError(
                f"predict expects (rows, features), got {tuple(Xn.shape)}")
        return Xn

    def _run_bucket(self, Xn, bucket: int) -> torch.Tensor:
        entry = self._compiled(bucket, Xn.shape[1])
        self.bucket_hits += 1
        return entry.run(self.state, Xn, Xn.shape[0])

    def predict(self, X) -> torch.Tensor:
        """Serve one request batch of any size: pad to the bucket ladder
        (oversize splits into top-bucket chunks + a bucketed remainder),
        replay the bucket's graph, slice the padding off.  Returns a
        tensor where the state lives."""
        Xn = self._rows(X)
        n = Xn.shape[0]
        if n == 0:
            raise ValueError("empty request batch")
        b = self.bucket_for(n)
        if b is not None:
            return self._run_bucket(Xn, b)
        top = self.buckets[-1]
        parts = [self._run_bucket(Xn[i:i + top], top)
                 for i in range(0, n - n % top, top)]
        rem = n % top
        if rem:
            parts.append(self._run_bucket(Xn[n - rem:],
                                          self.bucket_for(rem)))
        return torch.cat(parts, dim=0)

    def run_stream(self, batches):
        """Serve an iterable of batches that fit the ladder, one result
        per batch, in order.  Nothing synchronises: batch *i* is staged
        (pinned, ``non_blocking``) and its graph replayed before batch
        *i−1*'s result is handed out, so the host prepares a batch while
        the card computes the one before.  Each replay's rows are cloned
        at once (on the card), since consecutive batches of one bucket
        share the entry's static output."""
        pending = None
        for X in batches:
            Xn = self._rows(X)
            b = self.bucket_for(Xn.shape[0])
            if b is None:
                raise ValueError(
                    f"run_stream batches must fit the ladder "
                    f"(≤ {self.buckets[-1]} rows), got {Xn.shape[0]}")
            out = self._run_bucket(Xn, b)
            if pending is not None:
                yield pending
            pending = out
        if pending is not None:
            yield pending

    def counters(self) -> dict:
        return {"bucket_hits": self.bucket_hits,
                "compile_misses": self.compile_misses,
                "steady_compile_misses": self.steady_compile_misses}
