"""Launch layouts ("block shapes") of the CUDA kernels — measured or
heuristic, with an on-disk cache.  Port of ``repro.tuning.autotune``
(ROADMAP item 16b).

The kernels ``fxp_matmul``, ``kmeans_assign`` and ``split_hist`` take
their launch layout as keyword arguments.  This module chooses it:

* ``block_shapes(kernel, dtype, shape)`` — the dispatch-time entry point
  (``kernels.dispatch`` and ``kernels.ops`` call it at every kernel
  call).  A measured table entry for the ``(kernel, dtype, shape
  bucket, backend)`` key wins; otherwise the backend's heuristic.  Pure
  Python over shapes: no launch, no sync, so it may run while a CUDA
  graph is captured.
* ``autotune(kernel, shape, dtype)`` — times every candidate with the
  real kernel, stores the winner in the on-disk cache and returns it.
  ``measure_candidates`` returns the timings as :class:`Measurement`
  records (``seconds`` is one call), beside the candidates it refused;
  ``store_best`` keeps a sweep's fastest.

Candidate sets are data, as in JAX: ``CANDIDATE_TABLE`` declares them
per ``(kernel, backend)`` with symbolic entries (a dim name takes that
dim's extent, ``["heur", f]`` scales the heuristic's value by f), and
``register_candidates`` adds rows.  A backend's rows are its own, else
``"default"``'s.
Values are clamped to the shape and deduplicated, as JAX does.  Shapes
are bucketed to the next power of two per dim, and writes go through a
temp file per writer and ``os.replace``, as JAX does.

What differs from JAX:

* **The backend in the key** is the device: ``cuda:<torch.cuda.
  get_device_name>`` or ``cpu``.  A table measured on one card never
  steers another.
* **Its own cache**: ``$REPRO_TORCH_AUTOTUNE_CACHE`` or
  ``~/.cache/repro_torch/autotune_blocks.json``.  The block vocabulary is
  not JAX's, so neither package reads the other's table.
* **The shape includes the lanes**: ``(L, M, K, N)`` for ``fxp_matmul``
  (``a`` ``(L, M, K)``, ``b``'s N columns), ``(L, N, D, K)`` for
  ``kmeans_assign`` (N rows a lane, K centroids) and ``(L, N, F,
  n_nodes·n_bins·n_classes)`` for ``split_hist``.  JAX vmaps the lanes
  around its grid; here they are a grid axis, and the layouts depend on
  ``L`` and on the SM count.  The key's dtype is ``a``'s, ``x``'s and
  ``xbin``'s.
* **The vocabulary** is what the Hopper kernels can vary without
  changing a bit of their output (``fxp_matmul``, ``split_hist``) or
  beyond ``kmeans_assign``'s 1e-5 bar (the blocks' partials are added in
  block order):

  - ``fxp_matmul``: ``block_m``, the rows a block of the rows route
    takes, in whole row groups (256 rows for int8 ``a``, 128 for int16;
    ``kernels.fxp_matmul.group_rows``); ``block_n``, the columns of
    ``b`` a launch takes, 8 or 16 (not clamped to N: it is a launch's
    capacity, and a dot of more columns is a launch a group).  The
    K-chunk is no block shape here: its int32 partials' boundaries set
    ``hybrid_dot``'s float order, so it stays ``k_chunk``.
  - ``kmeans_assign``: ``block_n``, the rows a block takes, rounded up
    to the tile of 32·warps rows (``kernels.kmeans_assign.grid_blocks``).
  - ``split_hist``: ``block_n``, the rows a block takes: ``>= N`` is one
    block a (lane, feature tile), a smaller value the bulk layout with
    ``ceil(N / block_n)`` row chunks (``kernels.split_hist.layout``).
* **The heuristic of a ``cuda`` backend is the layout the kernels had
  before they were tuned**, so with no measured entry nothing moves.
  ``split_hist``'s also takes the node count (``n_nodes``), which the
  key folds into n·b·c.  The ``cpu`` heuristic takes each extent whole
  (one block, as JAX's interpret heuristic); the CPU's plain versions
  take no blocks.
* **Timing** uses CUDA events on the card: one warm call, then 5 runs
  of 20 calls enqueued back to back, each divided by 20 (the host clock
  on the CPU); the candidates are timed in turns, the list forward and
  then backward, and each keeps the median of its 10 runs.
* **No candidate is skipped in silence**: a candidate the wrapper would
  refuse (a ``block_n`` other than 8 or 16; more than 65,535 row
  chunks) is named before any launch and returned beside the
  measurements, and a launch that fails raises.
* **Captured graphs keep their layouts**: ``core.graphs`` captures a
  runner's kernel calls with the launch arguments of its capture, as
  JAX's jit keeps its trace, so a table changed afterwards serves only
  runners built afterwards.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import fxp_matmul as _fxp
from repro_torch.kernels import kmeans_assign as _km
from repro_torch.kernels import split_hist as _sh
from repro_torch.tuning.measurement import Measurement

_CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
_DEFAULT_CACHE = os.path.join("~", ".cache", "repro_torch",
                              "autotune_blocks.json")
TIMING_ITERS = 20              # calls a timed run
TIMING_RUNS = 5                # runs a candidate a pass; the median kept

_lock = threading.Lock()
_cache: Optional[dict] = None
_cache_path_loaded: Optional[str] = None
# bumped at every load, store and reset of the in-memory table: the key
# under which block_shapes' answers are cached
_generation = [0]

# block name -> shape axis it is clamped to, per kernel (fxp_matmul's
# block_n is a launch's capacity, 8 or 16, and is not clamped to N)
KERNEL_DIMS: Dict[str, Dict[str, int]] = {
    "fxp_matmul": {"block_m": 1},
    "kmeans_assign": {"block_n": 1},
    "split_hist": {"block_n": 1},
}
# dim name -> shape axis: the vocabulary of CANDIDATE_TABLE's entries
_DIM_NAMES: Dict[str, Dict[str, int]] = {
    "fxp_matmul": {"L": 0, "M": 1, "K": 2, "N": 3},
    "kmeans_assign": {"L": 0, "N": 1, "D": 2, "K": 3},
    "split_hist": {"L": 0, "N": 1, "F": 2},
}


def cache_path() -> str:
    return os.path.expanduser(os.environ.get(_CACHE_ENV, _DEFAULT_CACHE))


def _load_cache() -> dict:
    global _cache, _cache_path_loaded
    path = cache_path()
    with _lock:
        if _cache is not None and _cache_path_loaded == path:
            return _cache
        entries: dict = {}
        try:
            with open(path) as f:
                data = json.load(f)
            if isinstance(data, dict):
                entries = data.get("entries", {})
        except (OSError, ValueError):
            pass
        _cache = entries
        _cache_path_loaded = path
        _generation[0] += 1
        return _cache


def _store(key: str, blocks: Dict[str, int], us: float):
    global _cache, _cache_path_loaded
    # merge into what is on disk, not just this process's view: a fresh
    # process whose first act is autotune() must not wipe entries other
    # runs stored (loaded outside the non-reentrant lock)
    entries = dict(_load_cache())
    path = cache_path()
    with _lock:
        entries.update(_cache or {})
        entries[key] = {"blocks": blocks, "us": round(us, 2),
                        "time": time.time()}
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            # a temp name per writer: two processes racing one cache path
            # never write the same temp file, and os.replace keeps the
            # final JSON whole either way
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            with open(tmp, "w") as f:
                json.dump({"version": 1, "entries": entries}, f, indent=1)
            os.replace(tmp, path)
        except OSError:
            pass                    # the cache is best-effort
        _cache = entries
        _cache_path_loaded = path
        _generation[0] += 1


def reset_cache_for_tests():
    """Drop the in-memory cache, so a file changed under the same path
    is read again (tests point ``$REPRO_TORCH_AUTOTUNE_CACHE`` at temp
    dirs)."""
    global _cache, _cache_path_loaded
    with _lock:
        _cache = None
        _cache_path_loaded = None
        _generation[0] += 1


# ---------------------------------------------------------------------------
# keys and heuristics
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _cuda_device(index: int) -> Tuple[str, int]:
    return (f"cuda:{torch.cuda.get_device_name(index)}",
            torch.cuda.get_device_properties(index).multi_processor_count)


def _device_info(device=None) -> Tuple[str, Optional[int]]:
    """``(backend, SM count)`` of ``device``: ``("cpu", None)`` for the
    CPU; None is the current CUDA device where there is one."""
    if device is None:
        if not torch.cuda.is_available():
            return "cpu", None
        device = torch.device("cuda")
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu", None
    return _cuda_device(device.index if device.index is not None
                        else torch.cuda.current_device())


def backend_of(device=None) -> str:
    """The backend a table entry is keyed on: ``cuda:<card name>`` or
    ``cpu``; None is the current CUDA device where there is one."""
    return _device_info(device)[0]


def shape_bucket(shape: Sequence[int]) -> Tuple[int, ...]:
    """Next power of two per dim: nearby problem sizes share a table
    entry (and a measurement)."""
    return tuple(1 if d <= 1 else 1 << (int(d) - 1).bit_length()
                 for d in shape)


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return np.dtype(dtype).name


def table_key(kernel: str, dtype, shape: Sequence[int],
              backend: Optional[str] = None) -> str:
    backend = backend or backend_of()
    bucket = "x".join(str(d) for d in shape_bucket(shape))
    return f"{kernel}|{_dtype_name(dtype)}|{bucket}|{backend}"


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def _heuristic(kernel: str, dtype, shape: Sequence[int], backend: str, *,
               sms: Optional[int] = None, n_nodes: int = 1
               ) -> Dict[str, int]:
    """The backend's blocks: on ``cuda`` the kernels' layouts before
    tuning at ``sms`` SMs (None: the current device's); on ``cpu`` each
    extent whole."""
    if kernel not in KERNEL_DIMS:
        raise ValueError(f"unknown kernel {kernel!r}")
    shape = tuple(int(d) for d in shape)
    on_cuda = backend.split(":", 1)[0] == "cuda"
    if on_cuda and sms is None:
        sms = _device_info()[1]
        if sms is None:
            raise ValueError(f"the {backend!r} heuristic needs the SM count "
                             f"(sms=) where there is no CUDA device")
    return dict(_heuristic_cached(kernel, _dtype_name(dtype), shape,
                                  on_cuda, sms, int(n_nodes)))


@functools.lru_cache(maxsize=4096)
def _heuristic_cached(kernel: str, dtype: str, shape: tuple, on_cuda: bool,
                      sms: Optional[int], n_nodes: int) -> tuple:
    if kernel == "fxp_matmul":
        L, M, K, N = shape
        rows = _fxp.group_rows(_torch_dtype(dtype))
        bm = (_fxp.default_block_m(_torch_dtype(dtype)) if on_cuda
              else _round_up(max(M, 1), rows))
        return (("block_m", bm), ("block_n", _fxp.MAX_N))
    if kernel == "kmeans_assign":
        L, N, D, K = shape
        bn = _km.default_block_n(L, N, K, D, sms) if on_cuda else N
        return (("block_n", bn),)
    L, N, F, nbc = shape                                   # split_hist
    if not on_cuda:
        return (("block_n", N),)
    if nbc % n_nodes:
        raise ValueError(f"n·b·c = {nbc} is no multiple of {n_nodes} nodes")
    return (("block_n", _sh.default_block_n(L, N, F, n_nodes,
                                            nbc // n_nodes, 1, sms)),)


def _fit(kernel: str, dtype, shape: Sequence[int],
         blocks: Dict[str, int]) -> Dict[str, int]:
    """Clamp to the shape (as JAX does), then round to what the kernel
    takes: ``fxp_matmul``'s ``block_m`` up to whole row groups,
    ``kmeans_assign``'s ``block_n`` up to its tile."""
    out = {k: max(1, int(v)) for k, v in blocks.items()}
    for name, axis in KERNEL_DIMS[kernel].items():
        out[name] = max(1, min(out[name], int(shape[axis])))
    if kernel == "fxp_matmul":
        out["block_m"] = _round_up(out["block_m"],
                                   _fxp.group_rows(_torch_dtype(dtype)))
    elif kernel == "kmeans_assign":
        tile = _km.layout(int(shape[3]), int(shape[2]))["tile"]
        out["block_n"] = _round_up(out["block_n"], tile)
    return out


def _refusal(kernel: str, shape: Sequence[int],
             blocks: Dict[str, int]) -> Optional[str]:
    """Why the kernel's wrapper would refuse ``blocks`` at ``shape``, or
    None."""
    want = {"fxp_matmul": {"block_m", "block_n"}}.get(kernel, {"block_n"})
    if set(blocks) != want:
        return f"needs the blocks {sorted(want)}, got {sorted(blocks)}"
    if kernel == "fxp_matmul" and blocks["block_n"] not in _fxp.BLOCK_NS:
        return f"block_n must be one of {_fxp.BLOCK_NS}"
    if kernel == "split_hist" and blocks["block_n"] < shape[1] \
            and -(-int(shape[1]) // blocks["block_n"]) > 65535:
        return "more than 65535 row chunks (the grid's limit)"
    return None


def block_shapes(kernel: str, dtype, shape: Sequence[int],
                 backend: Optional[str] = None, *, device=None,
                 sms: Optional[int] = None, n_nodes: int = 1
                 ) -> Dict[str, int]:
    """Measured-or-heuristic blocks for one kernel call.

    The on-disk table first (a measured entry wins), then the backend's
    heuristic; either is clamped to the shape and rounded to what the
    kernel takes (:func:`_fit`), so a table tuned at a bucket's size
    never hands a larger block to a smaller call.  An entry the kernel
    would refuse (another version's vocabulary) is passed over for the
    heuristic.  ``device`` gives the backend and the SM count of a
    tensor's device; ``sms`` overrides the count; ``n_nodes`` is
    ``split_hist``'s node count.

    >>> block_shapes("kmeans_assign", torch.int16, (256, 65536, 16, 8),
    ...              "cuda:NVIDIA H100 80GB HBM3", sms=132)
    {'block_n': 4096}
    >>> block_shapes("fxp_matmul", torch.int8, (1, 64, 128, 32), "cpu")
    {'block_m': 256, 'block_n': 16}
    """
    if device is not None:
        backend, dev_sms = _device_info(device)
        sms = dev_sms if sms is None else sms
    backend = backend or backend_of()
    _load_cache()               # a new path is read (a new generation)
    return dict(_block_shapes(kernel, dtype, tuple(shape), backend, sms,
                              n_nodes, _generation[0]))


@functools.lru_cache(maxsize=4096)
def _block_shapes(kernel, dtype, shape, backend, sms, n_nodes,
                  generation) -> tuple:
    return tuple(_lookup(kernel, dtype, shape, backend, sms,
                         n_nodes).items())


def _lookup(kernel, dtype, shape, backend, sms, n_nodes) -> dict:
    heur = _heuristic(kernel, dtype, shape, backend, sms=sms,
                      n_nodes=n_nodes)
    entry = _load_cache().get(table_key(kernel, dtype, shape, backend))
    if entry is not None:
        try:
            blocks = _fit(kernel, dtype, shape, dict(entry["blocks"]))
        except (KeyError, TypeError, ValueError):
            blocks = None
        if blocks is not None and _refusal(kernel, shape, blocks) is None:
            return blocks
    return _fit(kernel, dtype, shape, heur)


# ---------------------------------------------------------------------------
# measured autotuning
# ---------------------------------------------------------------------------

# Candidate sets, kernel -> backend ("default": every backend without rows
# of its own).  An int is literal, a dim name (see
# _DIM_NAMES) takes that dim's extent, ["heur", f] scales the heuristic's
# value by f.  The heuristic is always candidate 0; everything is
# clamped, rounded and deduplicated before timing.  These are the Hopper
# rows: fxp_matmul at 1, 2, 4, 8 and 16 row groups a block (the
# heuristic is 8) by one or two n8 blocks a launch; kmeans_assign at a
# quarter to four times the heuristic's rows and one block a lane;
# split_hist at one block a (lane, tile) and chunks of 16,384, 4,096 and
# 1,024 rows.
CANDIDATE_TABLE: Dict[str, Dict[str, tuple]] = {
    "fxp_matmul": {
        "default": tuple({"block_m": ["heur", groups / _fxp.ROW_GROUPS],
                          "block_n": n}
                         for groups in (1, 2, 4, 8, 16) for n in (8, 16)),
    },
    "kmeans_assign": {
        "default": (
            {"block_n": ["heur", 0.25]},
            {"block_n": ["heur", 0.5]},
            {"block_n": ["heur", 2]},
            {"block_n": ["heur", 4]},
            {"block_n": "N"},
        ),
    },
    "split_hist": {
        "default": (
            {"block_n": "N"},
            {"block_n": 16384},
            {"block_n": 4096},
            {"block_n": 1024},
        ),
    },
}


def register_candidates(kernel: str, candidates: Sequence[dict], *,
                        backend: str = "default") -> None:
    """Set a backend's candidate rows (a card's own sweep, a
    workload's shape family), in ``CANDIDATE_TABLE``'s entry format."""
    if kernel not in KERNEL_DIMS:
        raise ValueError(f"unknown kernel {kernel!r}")
    table = CANDIDATE_TABLE.setdefault(kernel, {})
    table[backend] = tuple(dict(c) for c in candidates)


def _resolve_entry(kernel: str, entry: dict, heur: Dict[str, int],
                   shape: Sequence[int]) -> Dict[str, int]:
    out = {}
    names = _DIM_NAMES[kernel]
    for block, val in entry.items():
        if isinstance(val, str):
            val = shape[names[val]]
        elif isinstance(val, (list, tuple)):
            tag, factor = val
            assert tag == "heur", f"unknown candidate op {tag!r}"
            val = heur[block] * factor
        out[block] = max(1, int(val))
    return out


def _rows(kernel: str, backend: str) -> tuple:
    table = CANDIDATE_TABLE.get(kernel, {})
    return table.get(backend, table.get("default", ()))


def _candidates(kernel: str, dtype, shape: Sequence[int], backend: str, *,
                sms: Optional[int] = None, n_nodes: int = 1,
                refused: Optional[list] = None) -> list:
    """The heuristic, then the backend's rows, resolved, clamped, rounded
    and deduplicated in order.  A candidate the wrapper would refuse is
    left out and, with ``refused`` given, appended to it as ``(blocks,
    reason)``."""
    heur = _heuristic(kernel, dtype, shape, backend, sms=sms,
                      n_nodes=n_nodes)
    cands = [heur] + [_resolve_entry(kernel, e, heur, shape)
                      for e in _rows(kernel, backend)]
    out, seen = [], set()
    for c in cands:
        c = _fit(kernel, dtype, shape, c)
        key = tuple(sorted(c.items()))
        if key in seen:
            continue
        seen.add(key)
        why = _refusal(kernel, shape, c)
        if why is None:
            out.append(c)
        elif refused is not None:
            refused.append((c, why))
    return out


def _time_call(fn: Callable, device=None, iters: int = TIMING_ITERS,
               runs: int = TIMING_RUNS) -> float:
    """Microseconds one ``fn()`` takes: the median of :func:`_time_runs`."""
    return statistics.median(_time_runs(fn, device, iters, runs))


def _time_runs(fn: Callable, device=None, iters: int = TIMING_ITERS,
               runs: int = TIMING_RUNS) -> List[float]:
    """Microseconds one ``fn()`` takes in each of ``runs`` runs of
    ``iters`` calls enqueued back to back, after one warm call (CUDA
    events on the card, the host clock on the CPU)."""
    on_cuda = torch.device(device).type == "cuda" if device is not None \
        else False
    fn()
    if on_cuda:
        torch.cuda.synchronize(device)
    times = []
    for _ in range(runs):
        if on_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3 / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            times.append((time.perf_counter() - t0) * 1e6 / iters)
    return times


def _default_inputs(kernel: str, shape: Sequence[int], dtype, device,
                    hist: tuple) -> tuple:
    """Inputs from a fixed seed: ``fxp_matmul`` a ``(L, M, K)`` of
    ``dtype`` (int8 by default) read along K (the rows route) and an
    int16 ``b`` ``(K, N)``, the workloads' weights; ``kmeans_assign`` x
    ``(L, N, D)`` (float32, or int16/int8 with per-feature scales), K
    centroids, unit weights; ``split_hist`` nodes, bins (``dtype``,
    uint8 by default), classes and unit weights at ``hist``'s counts."""
    g = torch.Generator(device=device).manual_seed(0)

    def ints(size, lo, hi, dt):
        return torch.randint(lo, hi, size, generator=g, device=device,
                             dtype=torch.int32).to(dt)

    if kernel == "fxp_matmul":
        L, M, K, N = shape
        return (ints((L, M, K), -128, 128, dtype),
                ints((K, N), -32768, 32768, torch.int16))
    if kernel == "kmeans_assign":
        L, N, D, K = shape
        xf = torch.randn((L, N, D), generator=g, device=device)
        c = xf[0, :K].clone()
        w = torch.ones((L, N), device=device)
        if dtype == torch.float32:
            return xf, c, w, None
        info = torch.iinfo(dtype)
        scale = torch.full((D,), 4.0 / info.max, device=device)
        x = torch.clamp(torch.round(xf / scale), info.min, info.max
                        ).to(dtype)
        return x, c, w, scale
    L, N, F, _ = shape
    n_nodes, n_bins, n_classes = hist
    return (ints((L, N), 0, n_nodes, torch.int32),
            ints((L, N, F), 0, n_bins, dtype),
            ints((L, N), 0, n_classes, torch.int32),
            torch.ones((L, N), device=device))


def _bench_harness(kernel: str, shape: Sequence[int], dtype, device,
                   hist: Optional[tuple], inputs: Optional[tuple]):
    """``(dtype, hist, inputs, run)`` for one kernel: ``run(blocks)`` is
    one call of the wrapper at ``blocks`` (for ``fxp_matmul`` the dot of
    all N columns, a launch a ``block_n`` group, as
    ``dispatch.hybrid_matmul`` runs it)."""
    if kernel not in KERNEL_DIMS:
        raise ValueError(f"unknown kernel {kernel!r}")
    if kernel == "split_hist":
        hist = tuple(hist) if hist is not None else (1, int(shape[3]), 1)
        if int(np.prod(hist)) != int(shape[3]):
            raise ValueError(f"hist={hist} is not n·b·c = {shape[3]}")
    if inputs is None:
        dtype = _torch_dtype(dtype) if dtype is not None else {
            "fxp_matmul": torch.int8, "kmeans_assign": torch.float32,
            "split_hist": torch.uint8}[kernel]
        inputs = _default_inputs(kernel, shape, dtype, device, hist)
    else:
        dtype = inputs[1].dtype if kernel == "split_hist" else \
            inputs[0].dtype

    if kernel == "fxp_matmul":
        def run(blocks):
            return _fxp.grouped(*inputs, **blocks)
    elif kernel == "kmeans_assign":
        def run(blocks):
            return _km.kmeans_assign(*inputs, **blocks)
    else:
        def run(blocks):
            return _sh.split_hist(*inputs, n_nodes=hist[0], n_bins=hist[1],
                                  n_classes=hist[2], **blocks)
    return dtype, hist, inputs, run


class Sweep(NamedTuple):
    """What :func:`measure_candidates` found: the timed candidates in
    order (the heuristic first) and the refused ones, ``(blocks,
    reason)``, which were never launched."""
    measured: List[Measurement]
    refused: List[tuple]


def measure_candidates(kernel: str, shape: Sequence[int], dtype=None, *,
                       device=None, hist: Optional[tuple] = None,
                       inputs: Optional[tuple] = None,
                       check: Optional[Callable] = None) -> Sweep:
    """Time every candidate for ``(kernel, shape)`` on ``device`` (None:
    the current CUDA device where there is one) and return the timings
    as :class:`Measurement` records, one call each (the median of its
    runs in turns, :func:`_time_runs`), beside the refused candidates.

    ``inputs`` are the wrapper's tensors (default: made from a fixed
    seed); ``hist`` is ``split_hist``'s ``(n_nodes, n_bins, n_classes)``
    (default ``(1, n·b·c, 1)``, as JAX's harness).  ``check(blocks,
    out)`` is called with each candidate's output before any timing, to
    hold it against the plain version.  A launch that fails raises.
    """
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    backend, sms = _device_info(dev)
    dtype, hist, inputs, run = _bench_harness(kernel, shape, dtype, dev,
                                              hist, inputs)
    tkey = table_key(kernel, dtype, shape, backend)
    refused: list = []
    cands = _candidates(kernel, dtype, shape, backend, sms=sms,
                        n_nodes=hist[0] if hist else 1, refused=refused)
    if check is not None:
        for blocks in cands:
            check(dict(blocks), run(blocks))
    # in turns, the list forward and then backward, so that no candidate
    # gains from its place (the first one read ~2 % slow on the card)
    runs: List[list] = [[] for _ in cands]
    for i in list(range(len(cands))) + list(range(len(cands)))[::-1]:
        runs[i] += _time_runs(lambda b=cands[i]: run(b), dev)
    out = [Measurement(key=(kernel, tkey, tuple(sorted(blocks.items()))),
                       seconds=statistics.median(r) * 1e-6, steps=1,
                       source="autotune")
           for blocks, r in zip(cands, runs)]
    return Sweep(out, refused)


def store_best(sweep: Sweep) -> Dict[str, int]:
    """Store the fastest candidate of a :func:`measure_candidates` sweep
    under its table key (each measurement's ``key[1]``) and return its
    blocks."""
    best = min(sweep.measured, key=lambda m: m.seconds)
    blocks = dict(best.key[2])
    _store(best.key[1], blocks, best.seconds * 1e6)
    return blocks


def autotune(kernel: str, shape: Sequence[int], dtype=None, *,
             device=None, hist: Optional[tuple] = None,
             inputs: Optional[tuple] = None,
             check: Optional[Callable] = None) -> Dict[str, int]:
    """Measure the candidates for ``(kernel, shape)`` on this device,
    store the fastest in the on-disk table and return it.

    ``shape`` is the kernel's problem shape with its lanes: ``(L, M, K,
    N)`` for ``fxp_matmul``, ``(L, N, D, K)`` for ``kmeans_assign``,
    ``(L, N, F, n_nodes·n_bins·n_classes)`` for ``split_hist``; the other
    arguments are :func:`measure_candidates`'.
    """
    return store_best(measure_candidates(kernel, shape, dtype,
                                         device=device, hist=hist,
                                         inputs=inputs, check=check))
