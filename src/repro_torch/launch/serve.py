"""Serving launcher: the PIM prediction path end to end.

Port of ``repro.launch.serve``.  Trains (or restores) a workload,
publishes it through the :class:`~repro_torch.serving.ModelRegistry`,
captures the bucket ladder, stands up the micro-batching queue, fires an
open-loop burst of single-row requests and prints the latency and
throughput summary:

    python -m repro_torch.launch.serve --workload linreg \\
        --precision int8 --requests 512 --rate 2000          # the card
    python -m repro_torch.launch.serve --device cpu          # the CPU

With ``--ckpt-dir`` the registry restores the newest valid checkpoint
(sha256-validated; a Trainer's v2 layout or a bare state, written by
either package) instead of training in-process.  The data come from
``core.datasets`` with seed 0 on the serving device; ``jax.random``'s
streams cannot be replayed in PyTorch, so the rows differ from the JAX
launcher's.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import time

import torch

from repro_torch.core import datasets, make_grid
from repro_torch.core.mlalgos import api
from repro_torch.core.mlalgos.kmeans import KMeans
from repro_torch.core.mlalgos.linreg import LinReg
from repro_torch.core.mlalgos.multinomial import MultinomialLogReg
from repro_torch.core.mlalgos.svm import LinearSVM
from repro_torch.device import resolve_device
from repro_torch.serving import MicroBatchQueue, ModelRegistry

N_CLASSES = 4
K = 8


def build_workload(name: str, precision: str):
    if name == "linreg":
        return LinReg(lr=0.05, precision=precision)
    if name == "svm":
        return LinearSVM(lr=0.05, precision=precision)
    if name == "multinomial":
        return MultinomialLogReg(n_classes=N_CLASSES, lr=0.2,
                                 precision=precision, softmax="lut")
    if name == "kmeans":
        return KMeans(k=K, precision=precision)
    raise SystemExit(f"unknown workload {name!r}")


def make_problem(name: str, rows: int, features: int, device):
    gen = torch.Generator(device=device).manual_seed(0)
    if name == "multinomial":
        X = torch.randn((rows, features), generator=gen, device=device)
        y = torch.randint(0, N_CLASSES, (rows,), generator=gen,
                          device=device)
        return X, y
    X, y, _ = datasets.regression(gen, rows, features)
    if name == "svm":
        y = (y > 0).float()
    if name == "kmeans":
        y = None
    return X, y


def template_for(name: str, features: int, device) -> torch.Tensor:
    shape = {"multinomial": (features, N_CLASSES),
             "kmeans": (K, features)}.get(name, (features,))
    return torch.zeros(shape, dtype=torch.float32, device=device)


def open_loop(q: MicroBatchQueue, rows, n: int, rate: float,
              timeout: float = 60.0) -> tuple:
    """Submit ``n`` single-row requests (``rows[i % len(rows)]``) on an
    open-loop schedule, request ``i`` due at ``i / rate`` seconds, and
    wait for every result: ``(tickets, seconds)``.  The submitting thread
    sleeps to the next due time (a spin would hold the GIL from the
    queue's worker) and then submits every request that is due."""
    gap = 1.0 / rate
    tickets = []
    t0 = time.perf_counter()
    while len(tickets) < n:
        due = min(n, int((time.perf_counter() - t0) / gap) + 1)
        while len(tickets) < due:
            tickets.append(q.submit(rows[len(tickets) % len(rows)],
                                    block=True))
        if len(tickets) < n:
            time.sleep(max(0.0, t0 + len(tickets) * gap
                           - time.perf_counter()))
    for t in tickets:
        t.get(timeout=timeout)
    return tickets, time.perf_counter() - t0


@contextlib.contextmanager
def frozen_heap():
    """Serve with the warm heap (torch, the model, the graphs) out of the
    garbage collector's sight (``gc.freeze``), and give it back after: a
    full collection during traffic then scans only what the traffic
    allocated, where it would hold every thread for as long as the whole
    heap takes, and the queue would back up behind it."""
    gc.freeze()
    try:
        yield
    finally:
        gc.unfreeze()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="linreg",
                    choices=["linreg", "svm", "multinomial", "kmeans"])
    ap.add_argument("--precision", default="fp32",
                    choices=["fp32", "int16", "int8"])
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--features", type=int, default=16)
    ap.add_argument("--train-steps", type=int, default=20)
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--rate", type=float, default=1000.0,
                    help="offered load, requests/s (open loop)")
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore the newest valid checkpoint instead of "
                         "training in-process")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    wl = build_workload(args.workload, args.precision)
    X, y = make_problem(args.workload, args.rows, args.features, dev)
    grid = make_grid(8, device=dev)

    template = template_for(args.workload, args.features, dev)
    reg = ModelRegistry(wl, template, ckpt_dir=args.ckpt_dir, grid=grid)
    if args.ckpt_dir is not None:
        version = reg.refresh()
        if version is None:
            raise SystemExit(f"no valid checkpoint in {args.ckpt_dir}")
        print(f"restored checkpoint step {version}")
    else:
        state = api.fit(wl, grid, X, y, steps=args.train_steps).state
        reg.publish(state, version=0)

    _, runner = reg.current()
    runner.warmup(args.features)
    q = MicroBatchQueue(reg, max_batch=args.max_batch,
                        max_wait_ms=args.max_wait_ms)
    with frozen_heap():
        _, dt = open_loop(q, X.cpu().numpy(), args.requests, args.rate)
    q.close()

    s = q.stats()
    c = runner.counters()
    print(f"{args.workload}/{args.precision}: {s['requests']} requests "
          f"at {args.rate:.0f} req/s offered -> "
          f"{s['requests'] / dt:.0f} req/s served, "
          f"p50 {s['p50_ms']:.2f} ms, p99 {s['p99_ms']:.2f} ms, "
          f"mean batch {s['mean_batch']:.1f}, "
          f"compile misses {c['compile_misses']} "
          f"(steady {c['steady_compile_misses']})")


if __name__ == "__main__":
    main()
