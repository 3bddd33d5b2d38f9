#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's training path once on the card.

    python3 chip_smoke.py              # one CUDA card, full size
    python3 chip_smoke.py --rehearse   # CPU, small size, plain versions

Phases, each printed as one JSON line:

  1. device   — the card, and its name and power limit from nvidia-smi;
  2. build    — both CUDA kernels built from src/repro_torch/kernels/csrc;
  3. compare  — each kernel's wrapper against its plain PyTorch version
                on the card, bit for bit, at the training path's shapes
                (256 lanes x 65,536 rows x 64 features), on ragged shapes,
                with K > 4096 and the strided transposed view, and their
                median times (CUDA events);
  4. train    — ``api.fit`` of LogReg(int8, LUT sigmoid) on 256 vDPUs x
                d=64 x 2^24 rows made on the card from --seed: 50 steps at
                cadence 1 and 48 at cadence 8, against the fp32 + exact
                sigmoid run on the same data, then LinReg int8 for 20
                steps; the launch counters are set to 0 before each run
                and must show the launches the design implies; a small
                fit must equal its ``use_kernels(False)`` twin bit for bit;
  5. predict  — the trained state answers requests of 1, 7 and 512 rows
                through ``Workload.predict``, bit-exact with the plain
                path;
  6. the ``kernels`` line, the nvidia-smi line, and last
     ``{"ok": true, "device": {...}}``.

Any mismatch, missing launch or exception ends the run with a non-zero
exit code and without the ``ok`` line.  Without CUDA (and without
--rehearse) it exits 1 before doing anything.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import torch  # noqa: E402

from repro_torch.configs.pim_ml import CONFIG  # noqa: E402
from repro_torch.core import datasets, make_grid  # noqa: E402
from repro_torch.core import lut as lut_mod  # noqa: E402
from repro_torch.core import quantize as qz  # noqa: E402
from repro_torch.core.mlalgos import LinReg, LogReg, accuracy, api  # noqa: E402
from repro_torch.kernels import build, dispatch, ref  # noqa: E402
from repro_torch.kernels.fxp_matmul import fxp_matmul  # noqa: E402
from repro_torch.kernels.lut_activation import lut_activation  # noqa: E402

# PimMLConfig's regression workload at a size the card holds for real
# (its reg_rows=65536 was cut to fit the JAX package's CPU container):
# 2^24 rows, a 1 GiB int8 resident dataset at d=64
FULL_ROWS = 2 ** 24
LINREG_STEPS = 20
TIMING_ITERS = 20
# NVIDIA H100 SXM data sheet (dense): HBM3 rate, int8 tensor-core rate,
# float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12
SOURCES = {
    "fxp_matmul": ("src/repro_torch/kernels/csrc/fxp_matmul.cu",
                   "src/repro/kernels/fxp_matmul.py:48"),
    "lut_activation": ("src/repro_torch/kernels/csrc/lut_activation.cu",
                       "src/repro/kernels/lut_activation.py:41"),
}


class SmokeFailure(Exception):
    pass


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def reset_counts() -> None:
    fxp_matmul.launches = 0
    lut_activation.launches = 0


def counts() -> dict:
    return {"fxp_matmul": fxp_matmul.launches,
            "lut_activation": lut_activation.launches}


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def median_ms(fn, dev: torch.device, iters: int) -> float:
    """Median time of one ``fn()`` call after two warm-up calls: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    fn()
    sync(dev)
    times = []
    for _ in range(iters):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: int, n_ops: int, ops_per_s: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def rand_int(gen, shape, lo, hi, dtype):
    return torch.randint(lo, hi, shape, generator=gen, device=gen.device,
                         dtype=torch.int64).to(dtype)


def limbs16(gen, shape):
    """The int16-typed limbs of random int16 values, stacked as the last
    dim: what ``hybrid_matmul`` hands ``fxp_matmul`` as ``b``."""
    v = rand_int(gen, shape, -32768, 32768, torch.int16)
    return torch.cat([lb for _, lb in qz.int8_limbs(v)], dim=-1)


# -- phase 3 ---------------------------------------------------------------


def compare_fxp(gen, lanes: int, rows: int, d: int) -> list:
    """Kernel == plain on a few lanes at the path's per-lane shapes, and
    on shapes that reach every kernel variant: the 16-byte vector kernels
    with ragged rows, idle threads, K > 4096 and N from 1 to 4, and the
    scalar kernels (K or M not a multiple of the vector, N > 4, an
    unaligned view), for int8 and both int16 limbs."""
    few = min(lanes, 4)
    X = rand_int(gen, (few, rows, d), -128, 128, torch.int8)
    Xa = rand_int(gen, (3, 1000, 48), -128, 128, torch.int8)
    Xb = rand_int(gen, (2, 9000, 80), -128, 128, torch.int8)
    Xr = rand_int(gen, (3, 5000, 77), -128, 128, torch.int8)
    X16 = rand_int(gen, (2, 333, 64), -32768, 32768, torch.int16)
    cases = [
        ("forward, shared weight", X, limbs16(gen, (d, 1)), 0),
        ("forward, per-lane weight", X, limbs16(gen, (few, d, 1)), 0),
        ("gradient, transposed view", X.transpose(-1, -2),
         limbs16(gen, (few, rows, 1)), 0),
        ("request rows, 2-D", X[0, :7], limbs16(gen, (d, 1)), 0),
        ("vector rows, ragged M, K=48, N=3", Xa,
         limbs16(gen, (3, 48, 1))[..., :3].contiguous(), 0),
        ("vector cols, M=48, N=1", Xa.transpose(-1, -2),
         limbs16(gen, (3, 1000, 1))[..., :1].contiguous(), 0),
        ("vector cols, M=80, K=9000, N=4", Xb.transpose(-1, -2),
         limbs16(gen, (2, 9000, 2)), 0),
        ("vector rows, int16 high limb", X16, limbs16(gen, (64, 1)), 1),
        ("vector cols, int16 low limb", X16.transpose(-1, -2),
         limbs16(gen, (2, 333, 1)), 2),
        ("scalar rows, K=77, N=6", Xr, limbs16(gen, (3, 77, 3)), 0),
        ("scalar cols, M=77, K=5000", Xr.transpose(-1, -2),
         limbs16(gen, (3, 5000, 1)), 0),
        ("scalar rows, int16 high limb, K=63", X16[..., 1:],
         limbs16(gen, (63, 1)), 1),
        ("scalar rows, unaligned view", X[..., 1:],
         limbs16(gen, (d - 1, 1)), 0),
    ]
    out = []
    for name, a, b, limb in cases:
        got = fxp_matmul(a, b, limb=limb)
        want = ref.fxp_matmul_ref(a, b, k_chunk=4096, limb=limb)
        equal = bool(torch.equal(got, want))
        out.append({"case": name, "a": list(a.shape), "b": list(b.shape),
                    "equal": equal})
        require(equal, f"fxp_matmul != plain version: {name}")
    return out


def lut_probe(table: lut_mod.LutTable, dev) -> torch.Tensor:
    """Exact midpoints between entries (and their float32 neighbours),
    the end points, values far outside [x_min, x_max], and NaN."""
    step = torch.tensor(table.step, dtype=torch.float32)
    mids = (torch.arange(table.n_entries - 1, dtype=torch.float32) + 0.5) \
        * step + table.x_min
    near = torch.cat([mids, torch.nextafter(mids, mids + 1),
                      torch.nextafter(mids, mids - 1)])
    edge = torch.tensor([table.x_min, table.x_max, -100.0, 100.0, 0.0,
                         -math.inf, math.inf, -1e30, 1e30, math.nan])
    return torch.cat([near, edge]).to(dev)


def compare_lut(gen, lanes: int, rows: int) -> dict:
    table = lut_mod.sigmoid_lut(device=gen.device)
    probe = lut_probe(table, gen.device)
    pos = qz.div_scalar(probe - table.x_min, table.step)
    ties = int((pos - torch.floor(pos) == 0.5).sum())
    z = torch.randn((min(lanes, 4), rows), generator=gen,
                    device=gen.device) * 6
    out = {"ties_in_probe": ties}
    for name, x in (("probe", probe), ("z, few lanes", z)):
        got = lut_activation(x, table.table, x_min=table.x_min,
                             x_max=table.x_max)
        equal = bool(torch.equal(
            got, ref.lut_activation_ref(x, table.table, table.x_min,
                                        table.x_max)))
        out[name] = equal
        require(equal, f"lut_activation != plain version: {name}")
    require(ties > 0, "the LUT probe holds no exact tie")
    return out


def time_kernels(gen, lanes: int, rows: int, d: int, iters: int) -> dict:
    """Kernel, plain and bound times of one training step's work at the
    path's full shapes (and one more exact comparison there)."""
    dev = gen.device
    X = rand_int(gen, (lanes, rows, d), -128, 128, torch.int8)
    bw = limbs16(gen, (d, 1))                 # cadence 1: one shared weight
    br = limbs16(gen, (lanes, rows, 1))       # per-lane residual
    Xt = X.transpose(-1, -2)
    fwd = lambda: fxp_matmul(X, bw)           # noqa: E731
    grad = lambda: fxp_matmul(Xt, br)         # noqa: E731
    fwd_ref = lambda: ref.fxp_matmul_ref(X, bw, k_chunk=4096)  # noqa: E731
    grad_ref = lambda: ref.fxp_matmul_ref(Xt, br, k_chunk=4096)  # noqa: E731
    of, og = fwd(), grad()
    fxp_err = max(max_abs_err(of, fwd_ref()), max_abs_err(og, grad_ref()))
    require(fxp_err == 0.0, f"fxp_matmul != plain at full size ({fxp_err})")
    plain_iters = max(1, iters // 5)
    parts = {
        "forward": {"ms": median_ms(fwd, dev, iters),
                    "plain_ms": median_ms(fwd_ref, dev, plain_iters),
                    "bytes": nbytes(X, bw, of),
                    "ops": 2 * X.numel() * bw.shape[-1]},
        "gradient": {"ms": median_ms(grad, dev, iters),
                     "plain_ms": median_ms(grad_ref, dev, plain_iters),
                     "bytes": nbytes(X, br, og),
                     "ops": 2 * X.numel() * br.shape[-1]},
    }
    del of, og
    fxp = {k: sum(p[k] for p in parts.values())
           for k in ("ms", "plain_ms", "bytes", "ops")}
    fxp["bound_ms"], fxp["bound_by"] = bound(fxp["bytes"], fxp["ops"],
                                             INT8_OPS_PER_S)
    fxp["parts"] = parts
    fxp["max_abs_err"] = fxp_err
    del X, Xt, br

    table = lut_mod.sigmoid_lut(device=dev)
    z = torch.randn((lanes, rows), generator=gen, device=dev) * 6
    lut_fn = lambda: lut_activation(z, table.table, x_min=table.x_min,  # noqa
                                    x_max=table.x_max)
    lut_ref = lambda: ref.lut_activation_ref(z, table.table,  # noqa: E731
                                             table.x_min, table.x_max)
    lut_err = max_abs_err(lut_fn(), lut_ref())
    require(lut_err == 0.0, f"lut_activation != plain at full size "
            f"({lut_err})")
    lut = {"ms": median_ms(lut_fn, dev, iters),
           "plain_ms": median_ms(lut_ref, dev, iters),
           "bytes": 2 * nbytes(z) + nbytes(table.table),
           "ops": 4 * z.numel(),            # subtract, divide, round, clamp
           "max_abs_err": lut_err}
    lut["bound_ms"], lut["bound_by"] = bound(lut["bytes"], lut["ops"],
                                             FP32_OPS_PER_S)
    return {"fxp_matmul": fxp, "lut_activation": lut}


# -- phases 4 and 5 --------------------------------------------------------


def fit_run(name, workload, grid, X, y, steps, expect, check_counts,
            **kw) -> tuple:
    """``api.fit`` with the counters set to 0 just before and read just
    after; returns (result, summary)."""
    dev = grid.device
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    res = api.fit(workload, grid, X, y, steps=steps, **kw)
    sync(dev)
    seconds = time.perf_counter() - t0
    seen = counts()
    losses = [float(m["loss"]) for m in res.history]
    summary = {"run": name, "steps": steps, "launches": seen,
               "expected_launches": expect, "seconds_fit": seconds,
               "loss_first": losses[0], "loss_last": losses[-1]}
    if dev.type == "cuda":
        summary["peak_memory_gib"] = \
            torch.cuda.max_memory_allocated(dev) / 2 ** 30
    require(len(losses) == steps, f"{name}: {len(losses)} history entries")
    require(all(math.isfinite(v) for v in losses), f"{name}: loss not "
            "finite")
    require(losses[-1] < losses[0], f"{name}: the loss did not fall")
    require(bool(torch.isfinite(res.state).all()), f"{name}: state not "
            "finite")
    if check_counts:
        require(seen == expect, f"{name}: launches {seen}, the design "
                f"implies {expect}")
    return res, summary


def step_rate(workload, grid, X, y, steps, reps=5, **kw) -> dict:
    """Steady steps/s of ``Program.fit`` on an already-bound program: the
    median, lowest and highest of ``reps`` fits of ``steps`` steps (host
    clock, ending in a synchronise)."""
    program = workload.bind(grid, X, y)
    program.fit(steps=2, **kw)
    sync(grid.device)
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        program.fit(steps=steps, **kw)
        sync(grid.device)
        rates.append(steps / (time.perf_counter() - t0))
    return {"median": statistics.median(rates), "min": min(rates),
            "max": max(rates), "fits": reps}


def profile_steps(workload, grid, X, y, steps: int) -> dict:
    """Where a main-path step's time goes: ``torch.profiler`` over
    ``steps`` warm steps of ``Program.fit``, device time by kernel, and
    the device's idle share of the traced window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    program = workload.bind(grid, X, y)
    program.fit(steps=2)
    sync(grid.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        program.fit(steps=steps)
        sync(grid.device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"steps": steps, "device_time": "not measured (the profiler "
                "recorded no device events)", "traced_wall_ms": wall_ms}
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    port = re.compile(r"(fxp_\w+?_kernel|lut_kernel)")   # names are mangled

    def name(key: str) -> str:
        found = port.search(key)
        return found.group(1) if found else key[:90]

    ours = sum(e.self_device_time_total for e in kernels
               if port.search(e.key))
    return {"steps": steps, "traced_wall_ms": wall_ms,
            "device_busy_ms": busy_us / 1e3,
            "idle_share": max(0.0, 1.0 - busy_us / 1e3 / wall_ms),
            "port_kernels_ms": ours / 1e3,
            "top_kernels": [{"name": name(e.key), "calls": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def small_parity(dev, seed: int, d: int) -> dict:
    """A small int8 + LUT fit equals its use_kernels(False) twin."""
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    X, y, _ = datasets.binary_classification(gen, 8 * 4096 + 5, d)
    grid = make_grid(8, device=dev)
    wl = LogReg(lr=0.5, precision="int8", sigmoid="lut")
    out = {}
    for k in (1, 4):
        a = api.fit(wl, grid, X, y, steps=10, merge_every=k)
        with dispatch.use_kernels(False):
            b = api.fit(wl, grid, X, y, steps=10, merge_every=k)
        equal = bool(torch.equal(a.state, b.state)) and all(
            bool(torch.equal(m["loss"], n["loss"]))
            for m, n in zip(a.history, b.history))
        out[f"cadence_{k}"] = equal
        require(equal, f"small fit at cadence {k} != its plain twin")
    return out


def train(args, dev, card: str) -> tuple:
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    grid = make_grid(args.lanes, device=dev)
    X, y, _ = datasets.binary_classification(gen, args.rows, args.features)
    check = not args.rehearse
    runs = []
    t0 = time.perf_counter()
    ref_res, s = fit_run("logreg fp32 exact", LogReg(lr=0.5), grid, X, y,
                         args.steps, {"fxp_matmul": 0, "lut_activation": 0},
                         check)
    acc_ref = accuracy(ref_res.state, X, y)
    s["accuracy"] = acc_ref
    runs.append(s)

    wl = LogReg(lr=0.5, precision="int8", sigmoid="lut")
    # the main path: its counters are the kernels line's "launches"
    main_res, s = fit_run("logreg int8 lut, cadence 1", wl, grid, X, y,
                          args.steps, {"fxp_matmul": 2 * args.steps,
                                       "lut_activation": args.steps}, check)
    main_counts = s["launches"]
    s["accuracy"] = accuracy(main_res.state, X, y)
    s["steps_per_s"] = step_rate(wl, grid, X, y, args.steps)
    require(abs(s["accuracy"] - acc_ref) <= 0.01, "int8 + LUT accuracy "
            f"{s['accuracy']} is not within 0.01 of fp32 {acc_ref}")
    runs.append(s)
    emit("profile", **profile_steps(wl, grid, X, y, 5))

    k = args.cadence
    cad_res, s = fit_run(f"logreg int8 lut, cadence {k}", wl, grid, X, y,
                         args.cadence_steps,
                         {"fxp_matmul": 2 * args.cadence_steps,
                          "lut_activation": args.cadence_steps}, check,
                         merge_every=k)
    s["accuracy"] = accuracy(cad_res.state, X, y)
    s["steps_per_s"] = step_rate(wl, grid, X, y, args.cadence_steps,
                                 merge_every=k)
    require(abs(s["accuracy"] - acc_ref) <= 0.01, f"cadence {k} accuracy "
            f"{s['accuracy']} is not within 0.01 of fp32 {acc_ref}")
    runs.append(s)
    requests = X[:512].clone()
    del X, y, ref_res, cad_res

    Xr, yr, _ = datasets.regression(gen, args.rows, args.features)
    lin = LinReg(lr=0.1, precision="int8")
    _, s = fit_run("linreg int8, cadence 1", lin, grid, Xr, yr,
                   args.linreg_steps, {"fxp_matmul": 2 * args.linreg_steps,
                                       "lut_activation": 0}, check)
    runs.append(s)
    del Xr, yr
    emit("train", card=card, lanes=args.lanes, rows=args.rows,
         features=args.features,
         runs=runs, small_parity=small_parity(dev, args.seed, args.features),
         seconds=time.perf_counter() - t0)
    return wl, main_res.state, requests, main_counts


def predict(wl, state, requests, check_counts: bool) -> None:
    results = []
    for n in (1, 7, 512):
        rows = requests[:n]
        reset_counts()
        got = wl.predict(state, rows)
        seen = counts()
        if check_counts:
            require(seen == {"fxp_matmul": 1, "lut_activation": 1},
                    f"predict({n}) launched {seen}")
        with dispatch.use_kernels(False):
            want = wl.predict(state, rows)
        equal = bool(torch.equal(got, want))
        results.append({"rows": n, "launches": seen, "equal": equal,
                        "mean_p": float(got.mean())})
        require(got.shape == (n,) and bool(torch.isfinite(got).all()),
                f"predict({n}) gave {tuple(got.shape)} or non-finite")
        require(equal, f"predict({n}) != its plain twin")
    emit("predict", requests=results)


# -- main ------------------------------------------------------------------


def device_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list:
    return [{"registers": int(r), "spill_stores": int(s)}
            for s, r in re.findall(r"(\d+) bytes spill stores.*?\n.*?Used "
                                   r"(\d+) registers", log)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="run on the CPU at 16 lanes x 2^14 rows with the "
                        "plain versions; prints no ok line")
    args = p.parse_args(argv)
    cfg = CONFIG
    args.lanes = 16 if args.rehearse else cfg.n_vdpus
    args.rows = 2 ** 14 if args.rehearse else FULL_ROWS
    args.features, args.steps = cfg.reg_features, cfg.reg_steps
    args.cadence = cfg.merge_every
    args.cadence_steps = cfg.reg_steps // cfg.merge_every * cfg.merge_every
    args.linreg_steps, args.iters = LINREG_STEPS, TIMING_ITERS

    if args.rehearse:
        dev = torch.device("cpu")
        smi = "not measured (rehearsal on the CPU)"
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device; this script measures the "
                  "card (use --rehearse for a CPU dry run)", file=sys.stderr)
            return 1
        dev = torch.device("cuda")
        smi = device_line()
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         kind=(torch.cuda.get_device_name(0) if dev.type == "cuda"
               else "cpu"), nvidia_smi=smi)

    if dev.type == "cuda":
        t0 = time.perf_counter()
        logs = build.build_all()
        emit("build", seconds=time.perf_counter() - t0,
             built=sorted(logs), ptxas={k: ptxas_summary(v)
                                        for k, v in logs.items()})

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    per_lane = args.rows // args.lanes
    emit("compare", fxp_matmul=compare_fxp(gen, args.lanes, per_lane,
                                           args.features),
         lut_activation=compare_lut(gen, args.lanes, per_lane))
    times = time_kernels(gen, args.lanes, per_lane, args.features,
                         args.iters)
    torch.cuda.empty_cache() if dev.type == "cuda" else None

    wl, state, requests, main_counts = train(args, dev, smi)
    predict(wl, state, requests, check_counts=dev.type == "cuda")

    kernels = []
    for name, t in times.items():
        src, replaces = SOURCES[name]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": main_counts[name],
                 "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                 "library_ms": None,
                 "library_note": "no single PyTorch call computes the same "
                                 "function (see PERF.md)",
                 "per": ("one training step: forward (L,R,d)x(d,2) + "
                         "gradient (L,d,R)x(L,R,2), int32 chunk partials"
                         if name == "fxp_matmul" else
                         "one training step: sigmoid of z (L,R)")}
        if "parts" in t:
            entry["parts"] = t["parts"]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    if args.rehearse:
        print("chip_smoke: rehearsal finished; no result on the CPU",
              file=sys.stderr)
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
