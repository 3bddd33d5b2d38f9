"""Dry run of the paper's own workloads at pod scale: a Workload
(logistic regression by default, ``--workload svm`` / ``multinomial``)
on a ``PimGrid`` of 4,096 virtual DPUs spread over the production mesh,
with the int8 resident dataset, LUT activations and the hierarchical
merge.

Port of ``repro/launch/dryrun_pim.py``:

  PYTHONPATH=src python -m repro_torch.launch.dryrun_pim [--multi-pod]
      [--workload {logreg,svm,multinomial}] [--batch-size B]
      [--merge-every K] [--chunk L] [--rows N]
      [--overlap-merge] [--compress-bits B]
      [--merge-plan {avg,slowmo,nesterov,topk,auto}]

JAX lowers the grid's cached chunk runner; the port runs it, as rank 0
of a fake world of 256 or 512 ranks (``launch.dryrun.fake_mesh``) on
fake tensors: the lanes sit over ``("data",)`` of the ``(16, 16)`` mesh
or ``("pod", "data")`` of the ``(2, 16, 16)`` one (replicated over
``model``), each rank holding its 16 (8) lanes of 4,096 rows × 64 int8
features, and ``--chunk`` rounds of the runner's own round function
(``PimGrid.make_runner``, or ``merge_plan.pipeline_runners`` for a plan)
run under ``roofline.analysis.RankCounter``, the kernels on their fake
paths.  The step functions are the workload's ``spec_fns``, so no
dataset is made.  The merge's collectives show once a round: every
local step at cadence 1, once every ``k`` local steps at ``--merge-every
k``.

``--overlap-merge`` runs the double-buffered pipeline and checks, as
JAX checks a sync backend's schedule (``roofline.analysis.
merge_overlap_report``), that in a round the kernels of this round's
local steps run after the slow hop's collective: eager order is a
topological order, so the collective cannot read this round's products,
only the previous round's pending state.  The run fails loudly when no
kernel follows it.  ``--merge-plan auto`` counts one round
(``tuning.CostModel``) and prints the ranked cost table with the chosen
plan.
"""

from __future__ import annotations

import argparse
import json
import os
import warnings

import torch

from repro_torch.configs.pim_ml import CONFIG
from repro_torch.launch.dryrun import ART_DIR, fake_mesh, mesh_tag
from repro_torch.launch.mesh import PRODUCTION_SHAPES
from repro_torch.roofline import analysis as ra

WORKLOAD_NAMES = ("logreg", "svm", "multinomial")


def _workload(name: str):
    """The config's estimator of ``name``, int8 with LUT activations
    (JAX's ``PimMLConfig.workload_spec(precision="int8")``)."""
    from repro_torch.core import mlalgos as ml

    return {
        "logreg": lambda: ml.LogReg(lr=0.5, precision="int8",
                                    sigmoid="lut"),
        "svm": lambda: ml.LinearSVM(lr=0.1, l2=CONFIG.svm_l2,
                                    precision="int8"),
        "multinomial": lambda: ml.MultinomialLogReg(
            n_classes=CONFIG.mn_classes, lr=0.5, precision="int8",
            softmax="lut"),
    }[name]()


def _plan(plan_name: str, merge_every: int, overlap: bool,
          compress_bits: int):
    from repro_torch.distributed import merge_plan as mp
    from repro_torch.distributed.compression import CompressionConfig

    compression = (CompressionConfig(bits=compress_bits)
                   if compress_bits else None)
    outer = mp.AverageCommit()
    if plan_name == "slowmo":
        outer = mp.SlowMo(beta=0.5)
    elif plan_name == "nesterov":
        outer = mp.Nesterov(beta=0.5)
    elif plan_name == "topk":
        compression = CompressionConfig(bits=compress_bits or None,
                                        top_k_frac=0.125)
    elif plan_name not in ("avg", "auto"):
        raise SystemExit(
            f"--merge-plan {plan_name!r} is not traced here (the adaptive "
            f"controller is host-side; see the module docstring)")
    return mp.MergePlan(cadence=merge_every, overlap=overlap,
                        compression=compression, outer=outer)


def build(multi_pod: bool = False, n_vdpus: int = 4096, rows: int = 1 << 24,
          features: int = 64, merge_every: int = 1, chunk: int = 8,
          overlap: bool = False, compress_bits: int = 0,
          plan_name: str = "avg", workload: str = "logreg",
          batch_size: int = 0, mesh_shape=None, mesh_names=None) -> dict:
    """Trace one configuration and return its record (JAX's ``build`` and
    ``main``'s record in one): memory a rank, the roofline terms, the
    collectives of the traced rounds and of one round, and, as asked,
    ``merge_overlap`` and ``auto_plan``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core import minibatch as mb
    from repro_torch.core.pim import PimGrid
    from repro_torch.distributed import merge_plan as mp

    if mesh_shape is None:
        mesh_shape, mesh_names = PRODUCTION_SHAPES[bool(multi_pod)]
    data_axes = tuple(a for a in ("pod", "data") if a in mesh_names)
    extra: dict = {}
    with fake_mesh(mesh_shape, mesh_names) as mesh, \
            FakeTensorMode(allow_non_fake_inputs=True):
        dev = torch.device(mesh.device_type)
        grid = PimGrid(n_vdpus, device=dev, mesh=mesh[data_axes])
        per = rows // n_vdpus
        L = grid.n_local
        local_fn, update_fn, state0 = _workload(workload).spec_fns(
            features=features, rows=rows, device=dev)
        if batch_size:
            local_fn, update_fn, state0, _ = mb.minibatch_fns(
                local_fn, update_fn, state0, rows_per_vdpu=per,
                batch_size=batch_size)
        y_dtype = torch.int32 if workload == "multinomial" else torch.float32
        data = {"X": torch.empty((L, per, features), dtype=torch.int8,
                                 device=dev),
                "y0": torch.empty((L, per), dtype=y_dtype, device=dev),
                "w": torch.empty((L, per), dtype=torch.float32, device=dev)}
        plan = _plan(plan_name, merge_every, overlap, compress_bits)
        force_pipeline = False
        if plan_name == "auto":
            from repro_torch import tuning

            preset = tuning.AutoTune()
            model = tuning.CostModel.for_fit(grid, local_fn, update_fn,
                                             state0, data)
            choices = tuning.candidate_choices(preset, plan.compression)
            wires, seen = [], set()
            for c in choices:
                tag = tuning.compression_tag(c.compression)
                if tag not in seen:
                    seen.add(tag)
                    wires.append(c.compression)
            cadences = tuning.cadence_ladder(max(merge_every, 1),
                                             preset.k_max, preset.growth)
            table = model.table(
                cadences=cadences, compressions=wires,
                overlaps=tuple(sorted({c.overlap for c in choices})))
            best = table[0]
            extra["auto_plan"] = {
                "chosen": {"cadence": int(best["cadence"]),
                           "compression": best["compression"],
                           "overlap": bool(best["overlap"])},
                "wire_bytes_by_format": {
                    tuning.compression_tag(w): int(model.wire_bytes(w))
                    for w in wires},
                "cost_table": table,
            }
            plan = mp.MergePlan(
                cadence=int(best["cadence"]), overlap=bool(best["overlap"]),
                compression={tuning.compression_tag(w): w
                             for w in wires}[best["compression"]])
            force_pipeline = True     # auto fits run the state-wire pipeline
        if batch_size and not plan.outer.plain_commit:
            raise SystemExit(
                "--batch-size cannot compose with a stateful outer "
                "optimizer (the sampler's step counter would be folded "
                "into its momentum)")

        if plan.is_exact_default and not force_pipeline:
            round_fn = grid.make_runner(local_fn, update_fn,
                                        merge_every=plan.cadence).round_fn
            carry, prologue = state0, None
        else:
            state_wire = plan.cadence > 1 or force_pipeline
            rs = mp.pipeline_runners(
                grid, local_fn, update_fn, merge_every=plan.cadence,
                overlap=plan.overlap, compression=plan.compression,
                state_wire=state_wire, outer=plan.outer)
            round_fn = rs["round"]
            mom = () if plan.outer.plain_commit else plan.outer.init(state0)
            prologue = rs.get("prologue")
            carry = (state0, None, mom)
        counters = []
        with ra.RankCounter() as rc:
            if prologue is not None:
                carry = (state0, prologue(state0, data), None, mom)
            for _ in range(chunk):
                with ra.RankCounter(events=True) as one:
                    carry, _ = round_fn(carry, data)
                counters.append(one.count)
        last = counters[-1]
        report = ra.merge_overlap_report(counters[-1].events)
        memory = rc.count.peak_bytes + sum(
            t.numel() * t.element_size() for t in data.values())
    n_chips = 1
    for k in mesh_shape:
        n_chips *= k
    arch = f"pim-ml({workload},int8+lut,scan-engine"
    arch += f",b{batch_size}" if batch_size else ""
    arch += ",overlap" if overlap else ""
    arch += f",efq{compress_bits}" if compress_bits else ""
    arch += f",{plan_name}" if plan_name != "avg" else ""
    arch += ")"
    out = {
        "status": "OK", "arch": arch, "mesh": mesh_tag(mesh_shape),
        "mesh_device_type": dev.type, "lanes_over": list(data_axes),
        "rows": rows, "n_vdpus": n_vdpus, "workload": workload,
        "batch_size": batch_size, "merge_every": plan.cadence,
        "scan_chunk": chunk, "overlap_merge": plan.overlap,
        "compress_bits": compress_bits, "merge_plan": plan_name,
        "memory_gb_per_device": round(memory / 2 ** 30, 3),
        "roofline": ra.rank_roofline(rc.count, n_chips=n_chips),
        "collectives": rc.count.collective_summary(),
        "collectives_per_round": last.collective_summary(),
        "local_steps_per_round": plan.cadence,
        "merge_overlap": report,
    }
    out.update(extra)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rows", type=int, default=1 << 24)
    ap.add_argument("--workload", default=CONFIG.workload,
                    choices=WORKLOAD_NAMES)
    ap.add_argument("--batch-size", type=int, default=CONFIG.batch_size,
                    help="resident rows sampled per vDPU per local step "
                         "(0 = full batch)")
    ap.add_argument("--merge-every", type=int, default=1,
                    help="vDPU-local steps per hierarchical merge")
    ap.add_argument("--chunk", type=int, default=8,
                    help="merge rounds traced")
    ap.add_argument("--overlap-merge", action="store_true",
                    help="the double-buffered merge pipeline, with its "
                         "overlap checked")
    ap.add_argument("--compress-bits", type=int, default=0,
                    help="error-feedback fixed-point width on the slow "
                         "hop (0 = exact merges)")
    ap.add_argument("--merge-plan", default="avg",
                    choices=("avg", "slowmo", "nesterov", "topk", "auto"))
    args = ap.parse_args(argv)

    from repro_torch.distributed.merge_plan import MergeFallbackWarning
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", MergeFallbackWarning)
        out = build(args.multi_pod, rows=args.rows,
                    merge_every=args.merge_every, chunk=args.chunk,
                    overlap=args.overlap_merge,
                    compress_bits=args.compress_bits,
                    plan_name=args.merge_plan, workload=args.workload,
                    batch_size=args.batch_size)
    out["merge_fallback_warnings"] = [
        str(w.message) for w in caught
        if issubclass(w.category, MergeFallbackWarning)]
    if args.overlap_merge:
        if not out["merge_overlap"]["overlapped"]:
            # a hard failure, not an assert: it must hold under -O too
            raise SystemExit(
                "overlap_merge ran a round where no kernel follows the "
                f"slow hop's collective: not decoupled: "
                f"{out['merge_overlap']}")
        print("merge overlap verified:", json.dumps(out["merge_overlap"]))
    os.makedirs(ART_DIR, exist_ok=True)
    with open(os.path.join(ART_DIR, f"pim-ml_{out['mesh']}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
