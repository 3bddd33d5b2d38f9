"""Captured calls: a function over static buffers, replayed.

Port-only, as ``kernels/build.py`` and ``interop.py`` are: the JAX package
compiles with ``jax.jit``; the port captures CUDA graphs.  One mechanism
serves ``PimGrid.make_runner`` and ``merge_plan.pipeline_runners`` (a chunk
of merge rounds, :class:`ChunkRunner`), ``serving.PredictRunner`` (a
bucket's forward) and ``launch.serve_lm.generate`` (a decode step).

On the card a :class:`Graph` is one ``torch.cuda.CUDAGraph``:

* :meth:`Graph.warm` calls run first, on the graph's side stream.  They
  build the kernels' libraries at first use, fill ``lut.shared_lut``, make
  cuBLAS's workspace for the stream and issue the kernels'
  ``cudaFuncSetAttribute`` calls, none of which may first happen inside a
  capture.  Callers warm up on scratch copies of their inputs, never on
  the buffers a replay reads;
* :meth:`Graph.capture` records the function on that stream in
  ``thread_local`` mode (another thread may copy or allocate on the card
  meanwhile), into a memory pool of the graph's own: graphs may be
  replayed from several threads, so they share none;
* :meth:`Graph.replay` re-runs every kernel on what the static buffers
  hold.  No Python runs, so the kernel wrappers' launch counters count
  the warm-up and the capture, never a replay.  A replay's kernels are
  counted from the graph itself: with ``Graph.keep_nodes`` set before
  the capture, :meth:`Graph.kernel_nodes` lists the captured graph's
  kernel nodes, and ``Graph.replays`` counts the replays.

A captured function may not synchronise or copy from pageable host
memory.  A capture that fails raises (``RuntimeError``, or the kernel
wrappers' ``KernelError``); nothing falls back to eager calls.

On the CPU the same object calls the function on the same static buffers
at every replay and copies its results into the same output tensors, so
a caller's copy-in, copy-out and aliasing rules run in the CPU tests.
"""

from __future__ import annotations

import os
import re
import tempfile
import threading
import weakref
from collections import OrderedDict
from typing import Any, Callable, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map


# one side stream a card for every warm-up and capture: the caching
# allocator keeps a freed block for the stream it was allocated on, so a
# new stream a graph would strand each warm-up's memory in a cache of its
# own; one warm-up or capture at a time uses the stream
_STREAMS: dict = {}
_CAPTURE_LOCK = threading.RLock()


def _side_stream(device: torch.device):
    with _CAPTURE_LOCK:
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        stream = _STREAMS.get(index)
        if stream is None:
            stream = _STREAMS[index] = torch.cuda.Stream(
                torch.device("cuda", index))
        return stream


class Graph:
    """One function over static buffers: a captured CUDA graph on the
    card, the eager call on the CPU (module docstring).  ``outputs`` is
    the function's result tree, overwritten by every replay; on the CPU
    it exists after the first replay.

    ``captures`` counts the captures made in this process, on either
    device, as the kernel wrappers count their launches."""

    captures = 0
    _count_lock = threading.Lock()
    # set before a capture to keep the captured graph's nodes for
    # kernel_nodes() (PyTorch drops them at instantiation otherwise)
    keep_nodes = False
    _live: "weakref.WeakSet[Graph]" = weakref.WeakSet()

    def __init__(self, device):
        self.device = torch.device(device)
        self._card = self.device.type == "cuda"
        self.outputs: Any = None
        self.pool_bytes: Optional[int] = None
        self.replays = 0
        self._fn: Optional[Callable[[], Any]] = None
        self._graph = None
        self._nodes: Optional[list] = None
        if self._card:
            self._stream = _side_stream(self.device)

    def warm(self, fn: Callable[[], Any]) -> Any:
        """``fn()`` on the graph's stream (the card) or at once (the
        CPU); returns its result.  Call it before :meth:`capture`."""
        if not self._card:
            return fn()
        # under the capture lock: work put on a stream that is capturing
        # joins that capture, whichever thread puts it there
        with _CAPTURE_LOCK:
            caller = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(caller)
            with torch.cuda.stream(self._stream):
                out = fn()
            caller.wait_stream(self._stream)
        return out

    def capture(self, fn: Callable[[], Any]) -> Any:
        """Record ``fn()`` (on the CPU: keep it for :meth:`replay`).
        Returns ``outputs`` (``None`` on the CPU until the first
        replay).  ``pool_bytes`` is what the capture added to the card's
        reserved memory: the segments of the graph's own pool."""
        with Graph._count_lock:
            Graph.captures += 1
            Graph._live.add(self)
        if not self._card:
            self._fn = fn
            return None
        dev = self.device
        keep = Graph.keep_nodes
        # keep_graph: the captured cudaGraph_t outlives the instantiation
        graph = torch.cuda.CUDAGraph(keep_graph=True) if keep \
            else torch.cuda.CUDAGraph()
        if keep:
            graph.enable_debug_mode()          # lets debug_dump print it
        with _CAPTURE_LOCK:
            self._stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.graph(graph, stream=self._stream,
                                  capture_error_mode="thread_local"):
                # read inside: entering empties the allocator's cache
                before = torch.cuda.memory_reserved(dev)
                self.outputs = fn()
                self.pool_bytes = torch.cuda.memory_reserved(dev) - before
            torch.cuda.current_stream(dev).wait_stream(self._stream)
        if keep:
            graph.instantiate()
            self._nodes = []
        self._graph = graph
        return self.outputs

    def replay(self) -> None:
        """Recompute ``outputs`` from the static buffers."""
        self.replays += 1
        if self._card:
            self._graph.replay()
            return
        res = self._fn()
        if self.outputs is None:
            self.outputs = res
            return
        for out, new in zip(tree_leaves(self.outputs), tree_leaves(res)):
            if out is not new:
                out.copy_(new)

    @classmethod
    def live(cls) -> list:
        """The captured graphs still alive in this process."""
        with cls._count_lock:
            return list(cls._live)

    def kernel_nodes(self) -> list:
        """The kernels one replay launches: the label of each kernel node
        of the captured graph (its function's name among its launch
        parameters), read from ``CUDAGraph.debug_dump``'s DOT text once
        and kept.  Needs ``Graph.keep_nodes`` at the capture.  On the CPU
        a replay launches none: ``[]``."""
        if not self._card:
            return []
        if self._nodes is None:
            raise RuntimeError("captured without Graph.keep_nodes: the "
                               "graph's nodes are gone")
        if not self._nodes and self._graph is not None:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "graph.dot")
                self._graph.debug_dump(path)
                with open(path) as f:
                    self._nodes = dot_kernel_nodes(f.read())
        return self._nodes


_DOT_NODE = re.compile(r'"(\w*node_\d+)"\s*\[')


def dot_kernel_nodes(dot: str) -> list:
    """The labels of the kernel nodes in a graph's DOT text
    (``cudaGraphDebugDotPrint``): each node statement ``"<id>"[...]``
    up to the next, an edge's ``"a" -> "b"[...]`` skipped, one entry a
    node id whose statement names a ``KERNEL``."""
    starts = [m for m in _DOT_NODE.finditer(dot)
              if "->" not in dot[dot.rfind("\n", 0, m.start()) + 1:
                                 m.start()]]
    seen, out = set(), []
    for m, nxt in zip(starts, starts[1:] + [None]):
        text = dot[m.start():nxt.start() if nxt else len(dot)]
        if m.group(1) not in seen and "KERNEL" in text:
            seen.add(m.group(1))
            out.append(text)
    return out


# -- chunks of rounds ------------------------------------------------------


def _static_like(given: Any, after: Any) -> Any:
    """The static carry for ``given``, laid out as ``after`` (the carry
    after one round): a leaf takes the dtype a round gives it (an int32
    count summed into int64 by PyTorch's promotion; the copy in is exact),
    and a ``None`` the round sized into a tree (the compressed merge's
    error buffer, which ``merge_plan.merge_pending`` makes as zeros at
    its first merge) becomes zeros.  A leaf whose shape a round changes
    cannot be captured."""
    if given is None:
        if after is None:
            return None
        return tree_map(lambda a: torch.zeros(a.shape, dtype=a.dtype,
                                              device=a.device), after)
    if isinstance(given, tuple):
        out = [_static_like(g, a) for g, a in zip(given, after)]
        return type(given)(*out) if hasattr(given, "_fields") else tuple(out)
    if isinstance(given, dict):
        return {k: _static_like(v, after[k]) for k, v in given.items()}
    if given.shape != after.shape:
        raise ValueError(
            f"a round changes a carry leaf's shape from "
            f"{tuple(given.shape)} to {tuple(after.shape)}: a captured "
            f"chunk needs a carry of fixed shape")
    return torch.zeros(after.shape, dtype=after.dtype, device=given.device)


def _load(static: Any, given: Any) -> None:
    """Copy the caller's carry into the static one; ``None`` where the
    static carry holds a tree fills it with zeros (see
    :func:`_static_like`)."""
    if static is None:
        if given is not None:
            raise ValueError("the carry's layout differs from the one "
                             "this chunk was captured with")
        return
    if given is None:
        for t in tree_leaves(static):
            t.zero_()
        return
    if isinstance(static, tuple):
        for s, g in zip(static, given):
            _load(s, g)
    elif isinstance(static, dict):
        for k, s in static.items():
            _load(s, given[k])
    elif static is not given:
        static.copy_(given)


def _slots(static: Any, new: Any):
    """``(static buffer, end leaf)`` pairs of two carries of one layout."""
    if static is None:
        return
    if isinstance(static, tuple):
        for s, n in zip(static, new):
            yield from _slots(s, n)
    elif isinstance(static, dict):
        for k, s in static.items():
            yield from _slots(s, new[k])
    else:
        yield static, new


def _write_back(static: Any, new: Any) -> None:
    """Copy a chunk's end carry into the static carry (inside the
    capture).  An end leaf that is, or views, another slot's buffer (the
    overlap's pending phase start is the state it started from) is
    cloned before any slot is written."""
    pairs = list(_slots(static, new))
    storages = {s.untyped_storage().data_ptr() for s, _ in pairs}
    pairs = [(s, n.clone() if n is not s and
              n.untyped_storage().data_ptr() in storages else n)
             for s, n in pairs]
    for s, n in pairs:
        if n is not s:
            s.copy_(n)


def stack_metrics(per_round: list) -> dict:
    """A chunk's metrics, one transfer a key: a round's dict stacks to
    ``(L, ...)``, a round's list of ``k`` step dicts to ``(L, k, ...)``
    (JAX's ``lax.scan`` layouts)."""
    if not per_round:
        return {}
    first = per_round[0]
    if isinstance(first, dict):
        return {key: torch.stack([m[key] for m in per_round])
                for key in first}
    return {key: torch.stack([torch.stack([m[key] for m in ms])
                              for ms in per_round])
            for key in first[0]}


def _leaves_in_order(data: Any) -> list:
    """``data``'s leaves in :func:`tree_map`'s order, with no reference
    cycle (the tree module's recursive helpers make one a call, which
    would keep a dataset alive until the next garbage collection)."""
    out: list = []
    tree_map(out.append, data)
    return out


def _binding(data: Any, leaves: list) -> tuple:
    """What a graph reads of ``data`` in place: its structure and the
    leaves' shapes, dtypes, strides and addresses."""
    return (repr(tree_map(lambda t: None, data)),) + tuple(
        (tuple(t.shape), t.dtype, tuple(t.stride()), t.data_ptr(), t.device)
        for t in leaves)


class _Bound:
    """The graphs of one data binding: the static carry they share, one
    :class:`Graph` a chunk length, and weak references to the data's
    leaves (the binding dies with its data)."""

    def __init__(self, sig: tuple, refs: list):
        self.sig, self.refs = sig, refs
        self.carry: Any = None
        self.graphs: "OrderedDict[int, Graph]" = OrderedDict()

    def holds(self, sig: tuple, leaves: list) -> bool:
        return sig == self.sig and all(
            r() is leaf for r, leaf in zip(self.refs, leaves))


class ChunkRunner:
    """``runner(carry, data, *, length=L)``: ``L`` rounds of
    ``round_fn(carry, data) -> (carry', metrics)`` back to back, as one
    captured graph a (data binding, ``L``) on the card; returns ``(carry,
    stacked metrics)`` (:func:`stack_metrics`).

    * **The carry** is copied into a static carry the graphs of a
      binding share, and the graph writes its end state back into it, as
      JAX donates its carry: the returned carry *is* that static carry,
      live, and the next call on the binding overwrites it (a caller
      passing it back costs no copy).  The metrics are fresh tensors.
      A ``None`` in the carry where a round sizes a tree (the compressed
      merge's error buffer) is laid out by the warm-up round and starts
      as zeros.
    * **The data** is read in place, never copied (the resident set, 1
      GiB of int8 X at 256 vDPUs x 2^24 rows).  A binding is the
      identity, shape, dtype, stride and address of every data leaf.
      The runner holds the data weakly: a binding and its graphs (their
      pools too) go when any of its tensors is freed, so a grid's cache
      of runners never keeps a dataset alive.  At most
      ``MAX_BINDINGS`` = 2 bindings live a runner, the least recently
      used dropped first: a program's own data and one other in turn;
      and at most ``MAX_LENGTHS`` = 4 chunk lengths a binding (a fit
      replays two: the full chunk and the last), since each graph's pool
      holds a round's intermediates (482 MiB for the main path's).
    * **Capture**: one warm-up round on scratch copies of the carry,
      then the capture of the ``L`` rounds (:class:`Graph`).  On the CPU
      the same object runs the rounds eagerly on the static carry.
    * ``_cache_size()`` counts the graphs held, as JAX's runner counts
      its traces.

    One lock covers a call: concurrent callers of one binding share its
    carry, so a runner serves one fit at a time.
    """

    MAX_BINDINGS = 2
    MAX_LENGTHS = 4

    def __init__(self, round_fn: Callable[[Any, Any], tuple], device):
        self.round_fn = round_fn
        self.device = torch.device(device)
        self._bound: "OrderedDict[int, _Bound]" = OrderedDict()
        self._next = 0
        self._lock = threading.RLock()

    def __call__(self, carry, data, *, length: int):
        if length < 1:
            raise ValueError(f"length must be >= 1, got {length}")
        with self._lock:
            bound = self._bind(data)
            graph = bound.graphs.get(length)
            if graph is None:
                graph = self._capture(bound, carry, data, length)
            bound.graphs.move_to_end(length)
            _load(bound.carry, carry)
            graph.replay()
            metrics = tree_map(torch.clone, graph.outputs)
            return bound.carry, metrics

    def _bind(self, data) -> _Bound:
        leaves = _leaves_in_order(data)
        sig = _binding(data, leaves)
        for key, bound in self._bound.items():
            if bound.holds(sig, leaves):
                self._bound.move_to_end(key)
                return bound
        key = self._next
        self._next += 1
        me = weakref.ref(self)

        def dead(_ref, _key=key):
            runner = me()
            if runner is not None:
                with runner._lock:
                    runner._bound.pop(_key, None)

        bound = _Bound(sig, [weakref.ref(t, dead) for t in leaves])
        while len(self._bound) >= self.MAX_BINDINGS:
            self._bound.popitem(last=False)
        self._bound[key] = bound
        return bound

    def _capture(self, bound: _Bound, carry, data, length: int) -> Graph:
        graph = Graph(self.device)
        scratch = tree_map(
            lambda t: None if t is None else t.detach().clone(), carry)
        after, _ = graph.warm(lambda: self.round_fn(scratch, data))
        if bound.carry is None:
            bound.carry = _static_like(carry, after)
        static = bound.carry
        round_fn = self.round_fn
        # the chunk reaches the data through the binding's weak
        # references: the CPU's graph keeps its function, which must not
        # keep the data alive
        skeleton = tree_map(lambda t: None, data)
        refs = bound.refs

        def chunk():
            it = iter([r() for r in refs])
            rows = tree_map(lambda _: next(it), skeleton)
            state, per_round = static, []
            for _ in range(length):
                state, metrics = round_fn(state, rows)
                per_round.append(metrics)
            _write_back(static, state)
            return stack_metrics(per_round)

        graph.capture(chunk)
        while len(bound.graphs) >= self.MAX_LENGTHS:
            bound.graphs.popitem(last=False)
        bound.graphs[length] = graph
        return graph

    def _cache_size(self) -> int:
        with self._lock:
            return sum(len(b.graphs) for b in self._bound.values())

    def pool_bytes(self) -> int:
        """The card memory the live graphs' pools hold (0 on the CPU)."""
        with self._lock:
            return sum(g.pool_bytes or 0 for b in self._bound.values()
                       for g in b.graphs.values())
