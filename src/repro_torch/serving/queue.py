"""Dynamic micro-batching: coalesce single-row requests into
bucket-sized batches under a max-wait deadline.

Port of ``repro.serving.queue``.  Throughput comes from keeping the card
busy on batched, already-captured work, but a queue that waits for a full
bucket would trade unbounded latency for it.  The
:class:`MicroBatchQueue` bounds both sides:

* the **worker** takes the oldest waiting request and then coalesces
  followers until either ``max_batch`` rows are in hand or the oldest
  request's ``max_wait_ms`` deadline expires — light load pays at most
  one deadline of extra latency, heavy load serves full buckets;
* **backpressure** is a bounded queue: :meth:`~MicroBatchQueue.submit`
  with ``block=False`` (the default) raises :class:`Backpressure` when
  ``max_pending`` requests are already waiting, so overload surfaces at
  the edge instead of growing an unbounded heap;
* **latency accounting** is per request, enqueue→result
  (:attr:`~MicroBatchQueue.latencies`, seconds);
* every micro-batch takes one atomic ``(version, runner)`` snapshot
  from its source, so a registry hot-swap never splits a batch across
  model versions and never drops an in-flight request.

A micro-batch's result comes to the host once (``.cpu().numpy()``, the
one synchronisation of a batch), and each ticket gets its row.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Optional

import numpy as np
import torch


class Backpressure(RuntimeError):
    """The queue is full (``max_pending`` requests waiting)."""


class _Ticket:
    __slots__ = ("row", "t0", "done", "result", "error", "version",
                 "latency_s")

    def __init__(self, row):
        self.row = row
        self.t0 = time.monotonic()
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.version = None
        self.latency_s: Optional[float] = None

    def get(self, timeout: Optional[float] = None):
        if not self.done.wait(timeout):
            raise TimeoutError("prediction not ready")
        if self.error is not None:
            raise self.error
        return self.result


class MicroBatchQueue:
    """Request-driven front end over a runner or registry.

    ``source`` is either a :class:`~repro_torch.serving.runner.
    PredictRunner` or a :class:`~repro_torch.serving.registry.
    ModelRegistry` — the worker resolves the current ``(version,
    runner)`` once per micro-batch.
    """

    _CLOSE = object()

    def __init__(self, source, *, max_batch: int = 32,
                 max_wait_ms: float = 2.0, max_pending: int = 1024):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._source = source
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self._q: _queue.Queue = _queue.Queue(maxsize=max_pending)
        self.latencies: list = []
        self.batches_served = 0
        self.rows_served = 0
        self._closed = False
        self._worker = threading.Thread(target=self._serve_loop,
                                        daemon=True)
        self._worker.start()

    def _snapshot(self):
        cur = getattr(self._source, "current", None)
        if callable(cur):
            return cur()                       # registry: (version, runner)
        return (None, self._source)            # bare runner

    # -- client side ---------------------------------------------------

    def submit(self, row, *, block: bool = False,
               timeout: Optional[float] = None) -> _Ticket:
        """Enqueue one request row; returns a ticket whose ``get()``
        blocks for the result.  When the queue is full: raise
        :class:`Backpressure` (``block=False``, the default) or wait up
        to ``timeout`` for a slot."""
        if self._closed:
            raise RuntimeError("queue is closed")
        t = _Ticket(np.asarray(row, np.float32))
        try:
            self._q.put(t, block=block, timeout=timeout)
        except _queue.Full:
            raise Backpressure(
                f"{self._q.maxsize} requests already pending") from None
        return t

    def predict(self, row, *, timeout: Optional[float] = None):
        """Synchronous single-row convenience: submit + wait."""
        return self.submit(row, block=True, timeout=timeout).get(timeout)

    # -- worker side ---------------------------------------------------

    def _serve_loop(self):
        while True:
            head = self._q.get()
            if head is self._CLOSE:
                return
            batch = [head]
            deadline = head.t0 + self.max_wait_s
            closing = False
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                try:
                    # past the deadline (e.g. the head aged in a backlog
                    # while the previous batch computed): stop waiting
                    # but still drain everything already queued — that
                    # is where the coalescing win under load comes from
                    t = (self._q.get_nowait() if remaining <= 0
                         else self._q.get(timeout=remaining))
                except _queue.Empty:
                    break
                if t is self._CLOSE:
                    closing = True
                    break
                batch.append(t)
            self._serve_batch(batch)
            if closing:
                return

    def _serve_batch(self, batch):
        try:
            version, runner = self._snapshot()
            X = np.stack([t.row for t in batch])
            out = runner.predict(X)
            out = (out.cpu().numpy() if isinstance(out, torch.Tensor)
                   else np.asarray(out))
            now = time.monotonic()
            for i, t in enumerate(batch):
                t.result = out[i]
                t.version = version
                t.latency_s = now - t.t0
                self.latencies.append(t.latency_s)
                t.done.set()
            self.batches_served += 1
            self.rows_served += len(batch)
        except BaseException as exc:
            for t in batch:
                t.error = exc
                t.done.set()

    # -- lifecycle / stats ---------------------------------------------

    def close(self):
        """Drain the queue (every submitted request is served) and stop
        the worker."""
        if self._closed:
            return
        self._closed = True
        self._q.put(self._CLOSE)
        self._worker.join()
        # serve whatever raced in behind the sentinel
        leftovers = []
        while True:
            try:
                t = self._q.get_nowait()
            except _queue.Empty:
                break
            if t is not self._CLOSE:
                leftovers.append(t)
        if leftovers:
            self._serve_batch(leftovers)

    def stats(self) -> dict:
        lat = np.asarray(self.latencies, np.float64)
        out = {"requests": int(lat.size),
               "batches": self.batches_served,
               "mean_batch": (self.rows_served / self.batches_served
                              if self.batches_served else 0.0)}
        if lat.size:
            out["p50_ms"] = float(np.percentile(lat, 50) * 1e3)
            out["p99_ms"] = float(np.percentile(lat, 99) * 1e3)
        return out
