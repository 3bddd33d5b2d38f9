"""Shared helpers of the port's mesh tests (``tests/test_torch_mesh.py``,
``tests/test_torch_collectives.py``, ``tests/test_torch_resilience.py``,
``tests/test_torch_streaming.py``).

* :func:`run_world` starts a ``torch.distributed`` world of gloo ranks on
  the CPU (``torch.multiprocessing`` spawn, a ``FileStore`` under a test
  directory: no socket, so parallel test workers cannot collide), runs
  one scenario function of this module on every rank and returns each
  rank's results, handed back by file.  Each join has its own timeout,
  and a rank that fails or hangs fails the test.
* :func:`run_jax` runs a function of this module in a subprocess whose
  JAX sees ``devices`` forced CPU devices, the JAX package's own mesh
  (``make_mesh_grid``), and returns what it wrote.

Inputs are made with numpy from fixed seeds on both sides.  This module
imports neither JAX nor torch at its top, so the JAX subprocess and the
ranks each load only their own package.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
SRC = os.path.join(ROOT, "src")


# -- running worlds and the JAX reference ----------------------------------


def _rank_entry(rank: int, world: int, store_path: str, out_dir: str,
                scenario: str, args: tuple) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_world

    init_world("gloo", dist.FileStore(store_path, world), rank=rank,
               world_size=world)
    try:
        out = globals()[scenario](rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_world(scenario: str, world: int, tmp_dir: str, *, args=(),
              timeout: float = 300.0) -> list:
    """Every rank's result of ``scenario(rank, world, *args)``, in rank
    order.  Raises when a rank fails, or when the world has not ended
    ``timeout`` seconds after it started (its processes are killed)."""
    import torch.multiprocessing as tmp

    os.makedirs(tmp_dir, exist_ok=True)
    store = os.path.join(tmp_dir, "store")
    ctx = tmp.start_processes(
        _rank_entry, args=(world, store, tmp_dir, scenario, tuple(args)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"the {world}-rank world of {scenario} did not end "
                    f"within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = []
    for r in range(world):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def run_jax(fn: str, out_path: str, *, devices: int,
            timeout: float = 300.0):
    """Run ``fn(out_path)`` of this module in a subprocess with
    ``devices`` forced CPU devices; returns the unpickled ``out_path``."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        f" --xla_force_host_platform_device_count={devices}")
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, TESTS] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    code = f"import torch_mesh_ref as r; r.{fn}({out_path!r})"
    done = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=timeout)
    if done.returncode:
        raise RuntimeError(f"the JAX reference {fn} failed:\n"
                           f"{done.stderr[-4000:]}")
    with open(out_path, "rb") as f:
        return pickle.load(f)


def wait_for(path: str, timeout: float) -> None:
    """Wait until ``path`` exists (the JAX reference writes it)."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() >= deadline:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.2)


def dump(obj, path: str) -> None:
    """Pickle atomically: a reader polling for ``path`` sees it whole."""
    with open(path + ".part", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".part", path)


# -- the collectives: inputs and the port's scenarios ----------------------

DTYPES = ("float32", "bfloat16", "float16")
HOPS = (2, 4)
N = 257
# single-axis collectives (the slow hop) and their keyword arguments;
# "alive" cases kill participant 1
SINGLE = {
    "quantized_psum": ("quantized_psum", dict(bits=8)),
    "quantized_psum_bits4": ("quantized_psum", dict(bits=4)),
    "quantized_psum_ef": ("quantized_psum_ef", dict(bits=8)),
    "quantized_psum_ef_alive": ("quantized_psum_ef", dict(bits=8,
                                                          alive=True)),
    "sparse_int8_ef": ("sparse_psum_ef", dict(frac=0.25, bits=8)),
    "sparse_int8_noef": ("sparse_psum_ef", dict(frac=0.25, bits=8,
                                                error_feedback=False)),
    "sparse_raw_ef": ("sparse_psum_ef", dict(frac=0.25, bits=None)),
    "sparse_raw_noef": ("sparse_psum_ef", dict(frac=0.25, bits=None,
                                               error_feedback=False)),
    "sparse_int8_ef_alive": ("sparse_psum_ef", dict(frac=0.25, bits=8,
                                                    alive=True)),
    "sparse_raw_ef_alive": ("sparse_psum_ef", dict(frac=0.25, bits=None,
                                                   alive=True)),
}
# over both axes of a (hop, data) mesh
MESHWIDE = ("hierarchical_psum", "compressed_reduce_int8",
            "compressed_reduce_topk", "compressed_reduce_int8_noef",
            "grad_reduce_int8", "grad_reduce_exact")


def mesh_shape(hop: int) -> tuple:
    """The (pod, data) mesh a hop is tested on, in a world of 4."""
    return (hop, 4 // hop)


def collective_inputs(hop: int, seed: int = 0) -> dict:
    """float32 inputs for every (pod, data) participant: ``x`` and ``e``
    of shape (hop, data, N), integer counts, and the alive flags.  Some
    entries are 0 or -0 and some repeat, so zero signs and top-k ties
    occur."""
    r = np.random.default_rng(seed + hop)
    data = 4 // hop
    x = (r.standard_normal((hop, data, N)) *
         np.float32(3.0)).astype(np.float32)
    x[..., :8] = 0.0
    x[..., 8:12] = -0.0
    x[..., 12:20] = x[..., 20:21]
    e = (r.standard_normal((hop, data, N)) * 0.05).astype(np.float32)
    e[..., 30:40] = 0.0
    counts = r.integers(-1000, 1000, (hop, data, 7)).astype(np.int32)
    alive = np.array([p != 1 for p in range(hop)])
    return {"x": x, "e": e, "counts": counts, "alive": alive}


def _cfg(name: str):
    from repro_torch.distributed.compression import CompressionConfig

    return {"compressed_reduce_int8": CompressionConfig(bits=8),
            "compressed_reduce_int8_noef": CompressionConfig(
                bits=8, error_feedback=False),
            "compressed_reduce_topk": CompressionConfig(
                bits=8, top_k_frac=0.25)}[name]


def collectives_scenario(rank: int, world: int) -> dict:
    """Every collective of ``repro_torch.distributed.collectives`` (and
    ``compressed_reduce``) on this rank's inputs, at each hop and dtype:
    ``{(scenario, hop, dtype): (pod, data, outputs as numpy)}``."""
    import torch

    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import compression as comp
    from repro_torch.launch.mesh import make_pim_mesh

    def np_(t):
        return t.float().numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()

    out = {}
    for hop in HOPS:
        mesh = make_pim_mesh(*mesh_shape(hop))
        p, d = mesh.get_local_rank("pod"), mesh.get_local_rank("data")
        pod = mesh.get_group("pod")
        inp = collective_inputs(hop)
        for dname in DTYPES:
            dt = getattr(torch, dname)
            x = torch.from_numpy(inp["x"][p, d]).to(dt)
            e = torch.from_numpy(inp["e"][p, d]).to(dt)
            alive = bool(inp["alive"][p])
            for name, (fn, kw) in SINGLE.items():
                kw = dict(kw)
                if kw.pop("alive", False):
                    kw["alive"] = alive
                f = getattr(coll, fn)
                res = f(x, pod, **kw) if fn == "quantized_psum" \
                    else f(x, e, pod, **kw)
                res = res if isinstance(res, tuple) else (res,)
                out[(name, hop, dname)] = (p, d, [np_(t) for t in res])
            counts = torch.from_numpy(inp["counts"][p, d])
            tree = {"g": x, "n": counts}
            for name in MESHWIDE:
                if name == "hierarchical_psum":
                    res = coll.hierarchical_psum(tree, mesh, ("data",),
                                                 "pod")
                    res = [res["g"], res["n"]]
                elif name.startswith("grad_reduce"):
                    res = coll.hierarchical_grad_reduce(
                        {"g": x}, mesh, fast_axes=("data",),
                        slow_axis="pod",
                        compress_bits=8 if name.endswith("int8") else 0)
                    res = [res["g"]]
                else:
                    err = {"g": e, "n": torch.zeros_like(counts)}
                    red, new = comp.compressed_reduce(tree, err,
                                                      _cfg(name), mesh=mesh)
                    res = [red["g"], red["n"], new["g"], new["n"]]
                out[(name, hop, dname)] = (p, d, [np_(t) for t in res])
    return out


# -- the mesh engine: plan cells and workloads on a (2, 2) mesh ------------

N_VDPUS = 16
STEPS = 16
WL_STEPS = 8
# test_mesh_engine.py's PLAN_CELLS: (cadence, overlap, compression kwargs,
# SlowMo)
PLAN_CELLS = {
    "exact_k1": (1, False, None, False),
    "exact_k4": (4, False, None, False),
    "int8_k1": (1, False, dict(bits=8), False),
    "int8_k4": (4, False, dict(bits=8), False),
    "topk_k4": (4, False, dict(bits=8, top_k_frac=0.25), False),
    "overlap_k1": (1, True, None, False),
    "overlap_k4": (4, True, None, False),
    "overlap_int8_k4": (4, True, dict(bits=8), False),
    "slowmo_k4": (4, False, None, True),
}
EXACT_CELLS = {"exact_k1", "exact_k4", "overlap_k1", "overlap_k4",
               "slowmo_k4"}
# compressed cell -> the exact cell whose trajectory error feedback tracks
EF_ORACLE = {"int8_k1": "exact_k1", "int8_k4": "exact_k4",
             "topk_k4": "exact_k4", "overlap_int8_k4": "overlap_k4"}
JAX_WORKLOADS = ("linreg", "logreg", "logreg_int8", "svm", "multinomial",
                 "kmeans")
WORKLOADS = JAX_WORKLOADS + ("dtree",)


def plan_of(mp, comp, cell: str):
    """The cell's plan in either package (``mp``: its ``merge_plan``
    module, ``comp``: its ``compression`` module)."""
    k, overlap, c, slowmo = PLAN_CELLS[cell]
    return mp.MergePlan(cadence=k, overlap=overlap,
                        compression=comp.CompressionConfig(**c) if c
                        else None,
                        outer=mp.SlowMo(beta=0.5) if slowmo
                        else mp.AverageCommit())


def linreg_data():
    r = np.random.default_rng(0)
    X = r.standard_normal((192, 6)).astype(np.float32)
    w = r.standard_normal(6).astype(np.float32)
    y = (X @ w + 0.1 * r.standard_normal(192)).astype(np.float32)
    return X, y


def workload_case(ml, name: str):
    """``(workload, X, y, initial centroids or None)`` in the package
    whose ``core.mlalgos`` is ``ml``, on numpy data made from a seed."""
    r = np.random.default_rng(10 + WORKLOADS.index(name))
    X = r.standard_normal((256, 6)).astype(np.float32)
    c0 = None
    if name == "linreg":
        y = (X @ r.standard_normal(6).astype(np.float32)).astype(np.float32)
        wl = ml.LinReg(lr=0.05)
    elif name in ("logreg", "logreg_int8", "svm"):
        p = 1.0 / (1.0 + np.exp(-(X @ r.standard_normal(6))))
        y = (r.random(256) < p).astype(np.float32)
        wl = {"logreg": ml.LogReg(lr=0.5),
              "logreg_int8": ml.LogReg(lr=0.5, precision="int8",
                                       sigmoid="lut"),
              "svm": ml.LinearSVM(lr=0.1, l2=1e-3)}[name]
    elif name == "kmeans":
        centers = r.uniform(-2.0, 2.0, (8, 4)).astype(np.float32)
        X = (centers[r.integers(0, 8, 256)] +
             0.3 * r.standard_normal((256, 4))).astype(np.float32)
        y = None
        c0 = X[r.choice(256, 8, replace=False)]
        wl = ml.KMeans(k=8)
    else:
        centers = r.uniform(-2.0, 2.0, (8, 6)).astype(np.float32)
        comp_ = r.integers(0, 8, 256)
        X = (centers[comp_] + 0.5 * r.standard_normal((256, 6))
             ).astype(np.float32)
        y = (comp_ % 4).astype(np.int32)
        wl = (ml.MultinomialLogReg(n_classes=4, lr=0.5)
              if name == "multinomial"
              else ml.DecisionTree(max_depth=6, n_bins=32, n_classes=4))
    return wl, X, y, c0


# a minibatch fit of the logreg case: 4 of each lane's 16 rows a step
MINIBATCH = dict(steps=8, batch_size=4, merge_every=2)


def int_leaf_data():
    return np.random.default_rng(7).standard_normal((96, 5)).astype(
        np.float32)


def jax_mesh_main(out_path: str) -> None:
    """The JAX package's mesh runs the port is held against, on a (2, 2)
    mesh of 4 forced CPU devices (``make_mesh_grid(16, pods=2)``), under
    ``use_kernels(False)``: the EF resume pair first (written to
    ``out_path + ".resume"`` as soon as it is done), then every plan
    cell and workload."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.core import make_mesh_grid
    from repro.core import mlalgos as ml
    from repro.distributed import compression as comp
    from repro.distributed import merge_plan as mp
    from repro.kernels import dispatch

    grid = make_mesh_grid(N_VDPUS, pods=2)
    assert tuple(grid.mesh.shape.values()) == (2, 2)
    X, y = linreg_data()
    out = {"cells": {}, "workloads": {}}
    with dispatch.use_kernels(False):
        data, n, lf, uf, w0 = ml.make_linreg_step(
            grid, jnp.asarray(X), jnp.asarray(y), lr=0.05)
        holder = {}
        plan = plan_of(mp, comp, "int8_k4")
        w_half, _ = grid.fit(init_state=w0, local_fn=lf, update_fn=uf,
                             data=data, steps=8, merge_plan=plan,
                             merge_state=holder)
        error = jax.tree.map(np.asarray, holder["error"])
        w_two, _ = grid.fit(init_state=w_half, local_fn=lf, update_fn=uf,
                            data=data, steps=8, merge_plan=plan,
                            merge_state=holder)
        dump({"w_half": np.asarray(w_half), "error": error,
              "w_two": np.asarray(w_two)}, out_path + ".resume")
        for cell in PLAN_CELLS:
            w, hist = grid.fit(init_state=w0, local_fn=lf, update_fn=uf,
                               data=data, steps=STEPS, scan_chunk=4,
                               merge_plan=plan_of(mp, comp, cell))
            out["cells"][cell] = (np.asarray(w), np.asarray(
                [float(h["loss"]) for h in hist]))
        for name in JAX_WORKLOADS:
            wl, Xw, yw, c0 = workload_case(ml, name)
            Xj, yj = jnp.asarray(Xw), None if yw is None else jnp.asarray(yw)
            if c0 is None:
                res = ml.api.fit(wl, grid, Xj, yj, steps=WL_STEPS)
            else:
                res = dataclasses.replace(
                    wl.bind(grid, Xj, yj),
                    state0=jnp.asarray(c0)).fit(steps=WL_STEPS)
            out["workloads"][name] = {
                "state": [np.asarray(a) for a in
                          jax.tree.leaves(res.state)],
                "eval": {k: float(v) for k, v in res.eval(Xj, yj).items()}}
    dump(out, out_path)


def fit_workload(ml, wl, grid, X, y, c0):
    """The port's fit of a workload case (a bound program from ``c0``
    for K-means)."""
    import dataclasses

    import torch

    if c0 is None:
        return ml.api.fit(wl, grid, X, y, steps=WL_STEPS)
    return dataclasses.replace(wl.bind(grid, X, y),
                               state0=torch.from_numpy(c0)).fit(
                                   steps=WL_STEPS)


def _fit_np(grid, lf, uf, w0, data, steps, plan, **kw):
    w, hist = grid.fit(init_state=w0, local_fn=lf, update_fn=uf, data=data,
                       steps=steps, merge_plan=plan, **kw)
    return w.numpy(), np.asarray([float(h["loss"]) for h in hist])


def int_leaf_fns():
    """TestIntegerLeafExactness's functions in the port's lane layout."""
    import torch

    def local_fn(state, sl):
        pos = (sl["X"] > 0.0) * sl["w"][..., None]
        return {"hist": pos.to(torch.int32).sum(dim=1),
                "mass": (sl["X"] * sl["w"][..., None]).sum(dim=1)}

    def update_fn(state, merged):
        return ({"hist": state["hist"] + merged["hist"],
                 "w": state["w"] - 1e-3 * merged["mass"]},
                {"hist": merged["hist"]})

    s0 = {"hist": torch.zeros(5, dtype=torch.int32),
          "w": torch.zeros(5, dtype=torch.float32)}
    return local_fn, update_fn, s0


def big_wire_fns():
    """A 256 KiB state wire, large enough that the slow hop's price
    decides the prediction (test_mesh_engine.py's ``_big_model``)."""
    import torch

    def lf(w, sl):
        return {"g": w * sl["w"].sum(-1)[:, None]}

    def uf(w, merged):
        return w - 1e-3 * merged["g"], {"m": merged["g"][..., 0]}

    return lf, uf, torch.zeros(1 << 16, dtype=torch.float32)


def big_wire_merge(grid) -> dict:
    """The modelled merge of the big wire, exact against int8, at
    cadence 4: ``{"exact": t_merge_s, "int8": t_merge_s, "n_chips"}``,
    and each wire's ``us_per_step`` with and without overlap
    (``"us"``: ``{(tag, overlap): us}``)."""
    import torch

    from repro_torch.distributed.compression import CompressionConfig
    from repro_torch.tuning.cost import CostModel

    lf, uf, w0 = big_wire_fns()
    data, _ = grid.shard_rows(torch.zeros(32, 4))
    model = CostModel.for_fit(grid, lf, uf, w0, data)
    wires = {"exact": None, "int8": CompressionConfig(bits=8)}
    out = {tag: model.predict(cadence=4, compression=c)["t_merge_s"]
           for tag, c in wires.items()}
    out["us"] = {(tag, ov): model.predict(cadence=4, compression=c,
                                          overlap=ov)["us_per_step"]
                 for tag, c in wires.items() for ov in (False, True)}
    out["n_chips"] = model.n_chips
    return out


def mesh_scenario(rank: int, world: int, jax_resume: str) -> dict:
    """The port's mesh runs, on a (2, 2) mesh of the 4 ranks: every plan
    cell at both engines, every workload, the integer-leaf case, the EF
    buffer across fits and from JAX (``jax_resume``, written by
    :func:`jax_mesh_main`), the controller-driven plans and the cost
    model, and the construction refusals."""

    import torch

    from repro_torch import interop
    from repro_torch.core import make_mesh_grid
    from repro_torch.core import mlalgos as ml
    from repro_torch.distributed import compression as comp
    from repro_torch.distributed import merge_plan as mp
    from repro_torch.tuning import AutoTune
    from repro_torch.tuning.cost import CostModel
    from repro_torch.tree import tree_leaves

    grid = make_mesh_grid(N_VDPUS, pods=2, device="cpu")
    out = {"pod": grid.axis_index("pod"), "data": grid.axis_index("data"),
           "n_shards": grid.n_shards, "n_local": grid.n_local,
           "hop": mp.hop_size(grid), "cells": {}, "workloads": {}}
    X, y = linreg_data()
    data, n, lf, uf, w0 = ml.make_linreg_step(grid, X, y, lr=0.05)
    for cell in PLAN_CELLS:
        out["cells"][cell] = {
            engine: _fit_np(grid, lf, uf, w0, data, STEPS,
                            plan_of(mp, comp, cell), scan_chunk=4,
                            engine=engine)
            for engine in ("scan", "python")}

    for name in WORKLOADS:
        wl, Xw, yw, c0 = workload_case(ml, name)
        res = fit_workload(ml, wl, grid, Xw, yw, c0)
        out["workloads"][name] = {
            "state": [a.numpy() for a in tree_leaves(
                res.state if name != "dtree" else
                (res.state.feature, res.state.threshold,
                 res.state.leaf_value, res.state.bin_edges))],
            "eval": {k: float(v) for k, v in res.eval(Xw, yw).items()},
            "history": [{k: float(v) for k, v in h.items()}
                        for h in res.history]}

    # minibatch sampling: every rank draws the same slots
    wl, Xw, yw, _ = workload_case(ml, "logreg")
    res = ml.api.fit(wl, grid, Xw, yw, **MINIBATCH)
    out["minibatch"] = (res.state.numpy(), np.asarray(
        [float(h["loss"]) for h in res.history]))

    # integer leaves cross exactly under a compressed plan
    ilf, iuf, s0 = int_leaf_fns()
    idata, _ = grid.shard_rows(int_leaf_data())
    state, hist = grid.fit(init_state=s0, local_fn=ilf, update_fn=iuf,
                           data=idata, steps=4,
                           merge_plan=mp.MergePlan(
                               compression=comp.CompressionConfig(bits=8)))
    out["int_leaf"] = (state["hist"].numpy(),
                       np.stack([h["hist"].numpy() for h in hist]))

    # the EF buffer and the momentum across split fits
    split = {}
    for cell in ("int8_k4", "slowmo_k4"):
        plan = plan_of(mp, comp, cell)
        whole = _fit_np(grid, lf, uf, w0, data, 16, plan)[0]
        holder: dict = {}
        w_half, _ = grid.fit(init_state=w0, local_fn=lf, update_fn=uf,
                             data=data, steps=8, merge_plan=plan,
                             merge_state=holder)
        shapes = {k: [tuple(a.shape) for a in tree_leaves(v)]
                  for k, v in holder.items()}
        error = ([a.numpy() for a in tree_leaves(holder["error"])]
                 if "error" in holder else None)
        w_two, _ = grid.fit(init_state=w_half, local_fn=lf, update_fn=uf,
                            data=data, steps=8, merge_plan=plan,
                            merge_state=holder)
        split[cell] = {"whole": whole, "two": w_two.numpy(),
                       "shapes": shapes, "error": error}
    out["split"] = split

    # a JAX mesh fit's EF buffer resumes here as it resumes in JAX
    wait_for(jax_resume, 240.0)
    with open(jax_resume, "rb") as f:
        jres = pickle.load(f)
    holder = {"error": interop.error_from_numpy(jres["error"],
                                                device="cpu")}
    w_res, _ = grid.fit(init_state=torch.from_numpy(jres["w_half"]),
                        local_fn=lf, update_fn=uf, data=data, steps=8,
                        merge_plan=plan_of(mp, comp, "int8_k4"),
                        merge_state=holder)
    out["resume"] = w_res.numpy()

    # the controller-driven plans: every rank decides alike
    ctl = {}
    for name, plan, steps in (
            ("auto", "auto", 16),
            ("autotune", mp.MergePlan(outer=AutoTune(
                min_steps_to_explore=16)), 32),
            ("adaptive", mp.MergePlan(outer=mp.AdaptiveCadence(k_max=8)),
             16)):
        holder = {}
        w, losses = _fit_np(grid, lf, uf, w0, data, steps, plan,
                            merge_state=holder)
        ctl[name] = {"w": w, "losses": losses,
                     "trace": holder["tuning_trace"],
                     "cadence_trace": holder["cadence_trace"]}
    out["controller"] = ctl
    out["n_chips"] = CostModel.for_fit(grid, lf, uf, w0, data).n_chips
    out["big_wire"] = big_wire_merge(grid)

    try:
        make_mesh_grid(6, pods=2, device="cpu")
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


# -- the survivor merge on a (2, 2) mesh -------------------------------------

# test_resilience.py::test_mesh_survivor_matrix: 16 vDPUs, 256 x 8 rows,
# cadence 4, 48 steps, a NaN lane, a dead pod and a flipped wire bit,
# every wire, no checkpoint directory (rollbacks go to the fit's start)
SURVIVOR_STEPS = 48
SURVIVOR_WIRES = {"exact": None, "int8ef": dict(bits=8),
                  "topk": dict(bits=8, top_k_frac=0.25)}


def survivor_data():
    r = np.random.default_rng(26)
    X = r.standard_normal((256, 8)).astype(np.float32)
    w = r.standard_normal(8).astype(np.float32)
    y = (X @ w + 0.1 * r.standard_normal(256)).astype(np.float32)
    return X, y


def survivor_case(flt, rec):
    """The mixed fault plan and the recovery policy, in the package whose
    ``resilience.faults`` is ``flt`` and ``resilience.recovery`` is
    ``rec``."""
    fp = flt.FaultPlan(events=(
        flt.FaultEvent(2, "nan_lane", lane=3),
        flt.FaultEvent(4, "dead_pod", pod=1),
        flt.FaultEvent(6, "wire_bitflip", leaf=0, index=1, bit=29)))
    pol = rec.RecoveryPolicy(max_restarts=10, degrade_after=2,
                             spike_factor=50.0, backoff_base_s=0.0)
    return fp, pol


def _survivor_cells(grid, mp, comp, flt, rec, drive_fit, lf, uf, w0,
                    data, to_np) -> dict:
    import warnings

    fp, pol = survivor_case(flt, rec)
    out = {}
    for name, c in SURVIVOR_WIRES.items():
        plan = mp.MergePlan(cadence=4, compression=comp.CompressionConfig(
            **c) if c else None)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            w, hist, rep = drive_fit(
                grid, init_state=w0, local_fn=lf, update_fn=uf, data=data,
                steps=SURVIVOR_STEPS, plan=plan, fault_plan=fp,
                recovery=pol)
        out[name] = {"w": to_np(w),
                     "losses": np.asarray([float(h["loss"]) for h in hist]),
                     "report": {k: rep[k] for k in (
                         "restarts", "rounds", "survivors", "final_plan",
                         "fired")},
                     "trace": [(e["action"], e.get("to_step"),
                                e.get("transient")) for e in rep["trace"]]}
    return out


def jax_survivor_main(out_path: str) -> None:
    """JAX's survivor merges on a (2, 2) mesh of 4 forced CPU devices
    (``make_mesh_grid(16, pods=2)``)."""
    import jax.numpy as jnp

    from repro.core import make_mesh_grid
    from repro.core.mlalgos.linreg import make_linreg_step
    from repro.distributed import compression as comp
    from repro.distributed import merge_plan as mp
    from repro.resilience import faults as flt
    from repro.resilience import recovery as rec
    from repro.resilience.runtime import drive_fit

    grid = make_mesh_grid(16, pods=2)
    assert tuple(grid.mesh.shape.values()) == (2, 2)
    X, y = survivor_data()
    data, n, lf, uf, w0 = make_linreg_step(grid, jnp.asarray(X),
                                           jnp.asarray(y), lr=0.1)
    dump(_survivor_cells(grid, mp, comp, flt, rec, drive_fit, lf, uf, w0,
                         data, np.asarray), out_path)


def survivor_mesh_scenario(rank: int, world: int) -> dict:
    """The port's survivor merges on a (2, 2) mesh of the 4 ranks."""
    from repro_torch.core import make_mesh_grid
    from repro_torch.core.mlalgos.linreg import make_linreg_step
    from repro_torch.distributed import compression as comp
    from repro_torch.distributed import merge_plan as mp
    from repro_torch.resilience import faults as flt
    from repro_torch.resilience import recovery as rec
    from repro_torch.resilience.runtime import drive_fit

    grid = make_mesh_grid(16, pods=2, device="cpu")
    X, y = survivor_data()
    data, n, lf, uf, w0 = make_linreg_step(grid, X, y, lr=0.1)
    return {"pod": grid.axis_index("pod"), "data": grid.axis_index("data"),
            "cells": _survivor_cells(grid, mp, comp, flt, rec, drive_fit,
                                     lf, uf, w0, data,
                                     lambda t: t.numpy())}


# -- out-of-core streaming on a mesh ------------------------------------------

STREAM_CELLS = ("linreg fp32", "linreg int8", "logreg int8 lut")


def stream_mesh_scenario(rank: int, world: int) -> dict:
    """A rotation on a (2, 1) mesh (each rank gathers its own 8 lanes'
    rows) against the same mesh's resident minibatch fit at ``batch_size
    = part``: each cell's states and losses, as numpy."""
    from repro_torch.core import make_mesh_grid
    from repro_torch.core import mlalgos as ml
    from repro_torch.data import StreamingDataset

    grid = make_mesh_grid(16, pods=world, device="cpu")
    X, y = linreg_data()
    yb = (y > 0).astype(np.float32)
    out = {"n_local": grid.n_local}
    for cell in STREAM_CELLS:
        wl, yy = {"linreg fp32": (ml.LinReg(lr=0.05), y),
                  "linreg int8": (ml.LinReg(lr=0.05, precision="int8"), y),
                  "logreg int8 lut": (ml.LogReg(lr=0.5, precision="int8",
                                                sigmoid="lut"), yb)}[cell]
        sd = StreamingDataset(X, yy, partition_rows=64, steps_per_window=1,
                              seed=3)
        prog = wl.bind_stream(grid, sd)
        window = prog.data.window_data(0)
        rs = ml.api.fit(wl, grid, sd, steps=10)
        rr = ml.api.fit(wl, grid, X, yy, steps=10,
                        batch_size=prog.data.part, sample_seed=3)
        out[cell] = {
            "window_lanes": int(window["w"].shape[0]),
            "scale_shape": tuple(window["scale"].shape),
            "stream": (rs.state.numpy(),
                       [float(m["loss"]) for m in rs.history]),
            "resident": (rr.state.numpy(),
                         [float(m["loss"]) for m in rr.history])}
    return out


# -- on the card ---------------------------------------------------------------

CARD_CELLS = {"cadence 1": dict(), "cadence 4": dict(cadence=4),
              "int8 EF, cadence 4": dict(cadence=4, compression=dict(bits=8))}


def card_case():
    """A small int8 + LUT logistic regression for the card's mesh tests."""
    r = np.random.default_rng(3)
    X = r.standard_normal((8 * 512 + 3, 16)).astype(np.float32)
    y = (X @ r.standard_normal(16) > 0).astype(np.float32)
    return X, y


def card_plan(mp, comp, cell: str):
    kw = dict(CARD_CELLS[cell])
    if "compression" in kw:
        kw["compression"] = comp.CompressionConfig(**kw["compression"])
    return mp.MergePlan(**kw)


def card_mesh_scenario(rank: int, world: int) -> dict:
    """Two ranks on the one card over gloo (``pods=2``): each cell's
    state, as numpy."""
    import torch

    from repro_torch.core import make_mesh_grid
    from repro_torch.core.mlalgos import LogReg, api
    from repro_torch.distributed import compression as comp
    from repro_torch.distributed import merge_plan as mp
    from repro_torch.launch.mesh import make_pim_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    grid = make_mesh_grid(8, mesh=make_pim_mesh(world, 1, "cpu"),
                          device=dev)
    X, y = card_case()
    wl = LogReg(lr=0.5, precision="int8", sigmoid="lut")
    return {cell: api.fit(wl, grid, X, y, steps=16,
                          merge_plan=card_plan(mp, comp, cell)
                          ).state.cpu().numpy()
            for cell in CARD_CELLS}


# -- the MoE's expert-parallel branch (tests/test_torch_moe_ep.py) ---------

EP_ARCHS = ("phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b")


def ep_inputs(arch: str, seed: int = 5) -> dict:
    """float32 MoE parameters, an input ``x`` (2, 16, d) and a cotangent
    ``ct`` for ``arch``'s smoke config, from numpy."""
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config(arch)
    d, f, E = cfg.d_model, cfg.moe.d_ff, cfg.moe.n_experts
    r = np.random.default_rng(seed)

    def w(*shape):
        return (r.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    return {"p": {"router": w(d, E), "w_gate": w(E, d, f),
                  "w_up": w(E, d, f), "w_down": w(E, f, d)},
            "x": r.standard_normal((2, 16, d)).astype(np.float32),
            "ct": r.standard_normal((2, 16, d)).astype(np.float32)}


def _ep_jax_case(arch: str, sharded: bool) -> dict:
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.distributed.sharding import make_rules, use_rules
    from repro.models import moe

    cfg = configs.get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, dtype="float32")
    inp = ep_inputs(arch)
    rules = None
    if sharded:
        mesh = jax.make_mesh((1, 2), ("data", "model"))
        rules = make_rules(mesh, n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_kv_heads)

    def loss(p, x):
        y, aux = moe.moe_ffn(cfg, p, x)
        return jnp.sum(y * inp["ct"]) + aux, (y, aux)

    with use_rules(rules):
        p = jax.tree.map(jnp.asarray, inp["p"])
        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(inp["x"]))
    return {"y": np.asarray(y), "aux": np.asarray(aux),
            "gp": jax.tree.map(np.asarray, gp), "gx": np.asarray(gx)}


def jax_ep_main(out_path: str) -> None:
    """JAX's ``moe_ffn`` at both MoE smoke configs on a (1, 2) ``("data",
    "model")`` mesh of 2 forced CPU devices (the ``shard_map`` branch)
    and without rules (one device): outputs, aux and gradients."""
    dump({(arch, sharded): _ep_jax_case(arch, sharded)
          for arch in EP_ARCHS for sharded in (True, False)}, out_path)


def ep_scenario(rank: int, world: int) -> dict:
    """The port's ``moe_ffn`` on a (1, ``world``) ``("data", "model")``
    gloo mesh under ``make_rules`` (the expert-parallel branch, experts
    over ``model``), the parameters and input placed by
    ``launch.shardings``: ``{arch: (y, aux, grads, routes, local expert
    shapes)}`` as numpy, whole."""
    import dataclasses

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import make_rules, use_rules
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe

    mesh = make_host_mesh(1, world, device_type="cpu")
    out = {}
    for arch in EP_ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        inp = ep_inputs(arch)
        rules = make_rules(mesh, n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_kv_heads)
        with use_rules(rules):
            p = sh.distribute_tree(
                rules, {"moe": {k: torch.from_numpy(v) for k, v in
                                inp["p"].items()}}, sh.param_axes)["moe"]
            p = {k: v.detach().requires_grad_() for k, v in p.items()}
            x = sh.distribute_tree(rules, torch.from_numpy(inp["x"]),
                                   sh.batch_axes).detach().requires_grad_()
            with moe.log_routes() as routes:
                y, aux = moe.moe_ffn(cfg, p, x)
            ct = sh.distribute_tree(rules, torch.from_numpy(inp["ct"]),
                                    sh.batch_axes)
            loss = (y * ct).sum() + aux
            grads = torch.autograd.grad(loss, [p[k] for k in sorted(p)]
                                        + [x])
        out[arch] = {
            "y": y.full_tensor().detach().numpy(),
            "aux": aux.full_tensor().detach().numpy(),
            "gp": {k: g.full_tensor().numpy()
                   for k, g in zip(sorted(p), grads)},
            "gx": grads[-1].full_tensor().numpy(),
            "topi": [t.numpy() for t, _ in routes],
            "kept": [k.numpy() for _, k in routes],
            "w_gate_local": tuple(p["w_gate"].to_local().shape),
        }
    return out
