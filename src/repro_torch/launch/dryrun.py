"""Dry run on the production meshes: trace every (arch × shape × mesh)
cell as one rank of a fake world of 256 or 512 ranks and record its
memory, work and collectives.

Port of ``repro/launch/dryrun.py``.  JAX lowers and compiles each cell
for 256 or 512 placeholder devices and reads XLA's memory and cost
analyses.  The port runs eagerly, so it runs the cell: this process is
rank 0 of a ``"fake"`` process group (:func:`fake_mesh`; every
collective returns at once), the mesh is the production mesh over it,
every tensor is a fake one (``FakeTensorMode``: shapes, no data), and
every state leaf is a ``DTensor`` placed by ``launch.shardings``.  The
step runs as the card would run it — the train step is ``Model.loss``,
``torch.autograd.grad``, each gradient pinned to its parameter's
placements and AdamW's update (``launch.train.make_step_fn``), prefill
``Model.prefill``,
decode ``Model.decode_step`` — with the kernel wrappers' fake paths
(``kernels.build.traced``) charging each kernel's bytes and operations
at a rank's local shapes.  ``roofline.analysis.RankCounter`` counts the
rank's local ops, collectives and peak (see ``rank_roofline`` for what
this sees that XLA's compiled analyses see differently).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun            # full matrix
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape train_4k --multi-pod
Records land in experiments/dryrun_torch/*.json.  ``--save-hlo`` has no
counterpart (there is no HLO) and is refused.

The mesh's device type is ``"cuda"`` where this PyTorch has CUDA (the
collectives are then NCCL's), else ``"cpu"``, whose group runs an
all-to-all as an all-gather and a chunk; each record names it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, list_archs
from repro_torch.distributed.sharding import make_rules, use_rules
from repro_torch.launch import shardings as sh
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import PRODUCTION_SHAPES
from repro_torch.models import build
from repro_torch.optim import adamw
from repro_torch.roofline import analysis as ra
from repro_torch.tree import tree_leaves

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def mesh_tag(shape) -> str:
    return "pod" + "x".join(str(n) for n in shape)


@contextlib.contextmanager
def fake_mesh(shape=(16, 16), names=("data", "model"), device_type=None):
    """A mesh of ``shape`` over a world of ``prod(shape)`` ranks on
    PyTorch's ``"fake"`` backend (``torch.testing._internal.distributed.
    fake_pg``), in which this process is rank 0 and every collective
    returns at once without moving data; started here and destroyed at
    the end of the block (a world that exists already must have that
    size, and is left as it was).  ``device_type=None``: ``"cuda"`` where
    this PyTorch has CUDA (the collectives are NCCL's), else ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = 1
    for k in shape:
        n *= k
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    elif dist.get_world_size() != n:
        raise RuntimeError(f"a world of {dist.get_world_size()} ranks "
                           f"exists; the {shape} mesh needs {n}")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    try:
        yield init_device_mesh(device_type, tuple(shape),
                               mesh_dim_names=tuple(names))
    finally:
        if started:
            dist.destroy_process_group()


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of the tensors in ``tree``."""
    from torch.distributed.tensor import DTensor
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        total += t.numel() * t.element_size()
    return total


def trace_cell(cfg, spec, mesh, opt=None) -> dict:
    """Run ``spec``'s step of ``cfg`` as rank 0 of ``mesh`` on fake
    tensors and return ``{"count", "argument_bytes", "state_bytes",
    "output_bytes", ...}`` (``count`` a ``RankCount``; the state: the
    parameters, with the optimizer state in training and the cache in
    decode).  Must run inside a ``FakeTensorMode``."""
    from repro_torch.launch.train import make_step_fn

    dev = mesh.device_type
    rules = make_rules(mesh, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)
    model = build(cfg, dev)
    params = model.init(0)
    with use_rules(rules):
        p = sh.distribute_tree(rules, params, sh.param_axes)
        if spec.kind == "train":
            opt = opt or adamw(3e-4)
            o = sh.distribute_tree(rules, opt.init(params), sh.param_axes)
            batch = sh.distribute_tree(
                rules, sp.batch_specs(cfg, spec, dev), sh.batch_axes)
            args, state = (p, o, batch), (p, o)
            with ra.RankCounter() as rc:
                out = make_step_fn(model, opt)({"params": p, "opt": o},
                                               batch)
        elif spec.kind == "prefill":
            batch = sh.distribute_tree(
                rules, sp.batch_specs(cfg, spec, dev), sh.batch_axes)
            args, state = (p, batch), (p,)
            with ra.RankCounter() as rc, torch.no_grad():
                out = model.prefill(p, batch)
        else:
            cache, token, pos = sp.decode_specs(cfg, spec, model)
            cache = sh.distribute_tree(rules, cache, sh.cache_axes)
            token = sh.distribute_tree(rules, token, sh.batch_axes)
            args, state = (p, cache, token, pos), (p, cache)
            with ra.RankCounter() as rc, torch.no_grad():
                out = model.decode_step(p, cache, token, pos)
    return {"count": rc.count, "argument_bytes": local_bytes(args),
            "state_bytes": local_bytes(state),
            "output_bytes": local_bytes(out), "model": model,
            "params": params}


def run_cell(arch: str, shape: str, multi_pod: bool = False, *, cfg=None,
             mesh_shape=None, mesh_names=None, batch: int | None = None,
             seq_len: int | None = None) -> dict:
    """The record of one cell: ``status`` OK (with ``memory``,
    ``cost_analysis``, ``roofline``, ``model_flops``, ``collectives``),
    SKIP (with JAX's reason) or ERROR (with the trace).  ``cfg``
    replaces ``get_config(arch)`` (a smoke config); ``mesh_shape`` and
    ``mesh_names`` replace the production mesh (a small fake mesh);
    ``batch`` and ``seq_len`` the shape's."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = cfg or get_config(arch)
    if mesh_shape is None:
        mesh_shape, mesh_names = PRODUCTION_SHAPES[bool(multi_pod)]
    tag = mesh_tag(mesh_shape)
    spec = sp.cell_spec(cfg, shape)
    spec = dataclasses.replace(spec, batch=batch or spec.batch,
                               seq_len=seq_len or spec.seq_len)
    base = {"arch": arch, "shape": shape, "mesh": tag}
    if not spec.runnable:
        return {**base, "status": "SKIP", "skip_reason": spec.skip_reason}
    n_chips = 1
    for k in mesh_shape:
        n_chips *= k
    t0 = time.time()
    try:
        with fake_mesh(mesh_shape, mesh_names) as mesh, FakeTensorMode():
            got = trace_cell(cfg, spec, mesh)
            mf = ra.model_flops(cfg, spec.kind, spec.batch, spec.seq_len,
                                params=got["params"])
            device_type = mesh.device_type
    except Exception as e:      # a failing cell is a bug: surface it
        return {**base, "status": "ERROR",
                "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-4000:]}
    count = got["count"]
    args, temp = got["argument_bytes"], count.peak_bytes
    return {
        "status": "OK", **base, "kind": spec.kind, "batch": spec.batch,
        "seq_len": spec.seq_len, "trace_s": round(time.time() - t0, 2),
        "n_chips": n_chips, "mesh_device_type": device_type,
        "memory": {
            "argument_bytes": int(args),
            "state_bytes": int(got["state_bytes"]),
            "output_bytes": int(got["output_bytes"]),
            "temp_bytes": int(temp),
            "peak_per_device_gb": round((args + temp) / 2 ** 30, 3),
        },
        "cost_analysis": {"flops": float(sum(count.ops.values())),
                          "bytes": float(count.bytes)},
        "collectives": count.collective_summary(),
        "roofline": ra.rank_roofline(count, n_chips=n_chips),
        "model_flops": mf,
    }


def summary_line(r: dict) -> str:
    tag = f"{r['arch']}_{r['shape']}_{r['mesh']}"
    extra = ""
    if r["status"] == "OK":
        colls = ", ".join(f"{k} {v['count']}"
                          for k, v in sorted(r["collectives"].items()))
        extra = (f"mem/dev={r['memory']['peak_per_device_gb']}GB "
                 f"flops/dev={r['cost_analysis']['flops']:.4g} "
                 f"[{colls}] trace={r['trace_s']}s")
    elif r["status"] == "ERROR":
        extra = r["error"]
    return f"[{r['status']:5s}] {tag} {extra}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, help="one arch (default all)")
    ap.add_argument("--shape", default=None, help="one shape (default all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--save-hlo", action="store_true",
                    help="(refused: the port traces eagerly, no HLO)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.save_hlo:
        ap.error("--save-hlo has no counterpart: the port runs each cell "
                 "eagerly on fake tensors and lowers no HLO")

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(sp.SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(ART_DIR, exist_ok=True)
    results = []
    t0 = time.time()
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                r = run_cell(arch, shape, mp)
                results.append(r)
                tag = f"{arch}_{shape}_{r['mesh']}"
                with open(os.path.join(ART_DIR, tag + ".json"), "w") as f:
                    json.dump(r, f, indent=1)
                print(summary_line(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_err = sum(r["status"] == "ERROR" for r in results)
    print(f"\n{len(results)} cells: "
          f"{sum(r['status'] == 'OK' for r in results)} ok, "
          f"{sum(r['status'] == 'SKIP' for r in results)} skipped, "
          f"{n_err} errors in {time.time() - t0:.1f} s")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
