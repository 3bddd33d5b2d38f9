#!/usr/bin/env python3
"""Time versions of a CUDA kernel in turns on one card.

    python3 tools/kernel_ab.py                       # flash: route vs mma.sync
    python3 tools/kernel_ab.py --variants mma,nolo --rounds 2
    python3 tools/kernel_ab.py --against old/flash_attention.cu
    python3 tools/kernel_ab.py --kernel kmeans_assign \\
        --against old/kmeans_assign.cu --rounds 3

The cases run in turns, the list forward and then backward (A B B A),
``--rounds`` times, each reading a median of ``--iters`` launches (CUDA
events), in one process on one card.  Each line also says how the
reading's outputs compare with the plain version's.

The cases: ``route``, the checkout's library as the wrapper launches it;
each variant, an edit of the kernel's source built beside it; each
``--against`` file, another version of that source (say a parent
commit's, unpacked by ``git show`` or ``git archive``).  Everything is
built by ``repro_torch.kernels.build`` into its build directory, in
parallel, and launched through the wrapper's private ``_launch``.

``flash_attention`` runs at qwen2-0.5b's prefill shape, q (4, 14, 4096,
D) and k, v (4, 2, 4096, D), causal, bf16, at D = 64 and D = 128,
through the ``wgmma`` kernel (each variant names its own); a line gives
the share of outputs bit-equal to the plain version.  Its variants:

  mma      the repaired flash_mma_kernel, instantiated at every width
           (the route takes it at D = 32 only);
  stages2  a two-stage K/V ring instead of three;
  nolo     p.v without p's lo term (not the kernel's function: it shows
           what keeping p in float32 costs).

``kmeans_assign`` runs at ``chip_smoke.time_km``'s inputs: int16 rows
(256, 65536, 16) with their scales, shared centroids (8, 16), every
tenth row masked; a line says whether the assignments and counts equal
the plain version's and gives the sums' largest error over their mass.
Its variants:

  lb3      registers for three blocks an SM instead of four;
  target3  shared memory for three blocks an SM (more statistics groups);
  k1       one centroid instead of K (not the kernel's function: it
           shows what the distances cost);
  fma      x.c by fused multiply-adds (not the kernel's function: the
           assignments may differ; it shows what keeping them apart costs);
  nostats  no statistics (not the kernel's function: it shows what they
           cost);
  l2rows   every block reads the first 4,096 rows of its lane, which
           stay in L2 (not the kernel's function: it shows what the
           rows' trip from device memory costs).

Prints one JSON line per reading, after the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import kmeans_assign as km  # noqa: E402

# kernel: {variant: (edits of the source, the kernel launched)}
VARIANTS = {
    "flash_attention": {
        "mma": ([("} else if constexpr (D == 32) {",
                  "} else if constexpr (true) {")], "mma"),
        "stages2": ([("constexpr int kStages = 3;",
                      "constexpr int kStages = 2;")], "wgmma"),
        "nolo": ([("      wgmma_pv<D>(o, pl[kk], dv);\n", "")], "wgmma"),
    },
    "kmeans_assign": {
        "lb3": ([("__launch_bounds__(kThreads, 4)",
                  "__launch_bounds__(kThreads, 3)")], None),
        "target3": ([("kTargetWords = 57344 / 4;",
                      "kTargetWords = 76800 / 4;")], None),
        "k1": ([("      for (int k = 0; k < K; ++k) {\n"
                 "        const float4* ck = reinterpret_cast<const "
                 "float4*>(cs + k * kMaxD);",
                 "      for (int k = 0; k < 1; ++k) {\n"
                 "        const float4* ck = reinterpret_cast<const "
                 "float4*>(cs + k * kMaxD);")], None),
        "fma": ([("  s = __fadd_rn(s, __fmul_rn(x.x, c.x));\n"
                  "  s = __fadd_rn(s, __fmul_rn(x.y, c.y));\n"
                  "  s = __fadd_rn(s, __fmul_rn(x.z, c.z));\n"
                  "  return __fadd_rn(s, __fmul_rn(x.w, c.w));",
                  "  s = __fmaf_rn(x.x, c.x, s);\n"
                  "  s = __fmaf_rn(x.y, c.y, s);\n"
                  "  s = __fmaf_rn(x.z, c.z, s);\n"
                  "  return __fmaf_rn(x.w, c.w, s);")], None),
        "nostats": ([("    if (g < groups) {\n      for (int t = g;",
                      "    if (false) {\n      for (int t = g;")], None),
        "l2rows": ([("fetch_row<T, kVec, kMaxD>(xl + r * sxr,",
                     "fetch_row<T, kVec, kMaxD>(xl + (r & 4095) * sxr,"),
                    ("wv = here ? wl[r * swr] : 0.0f;",
                     "wv = here ? wl[(r & 4095) * swr] : 0.0f;")], None),
    },
}
WRAPPERS = {"flash_attention": fa, "kmeans_assign": km}


def flash_readings(libs, kernels, cases, args, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    for D in (64, 128):
        q, k, v = cs.flash_inputs(gen, cs.LM_BATCH, 14, 2, cs.LM_SEQ, D,
                                  torch.bfloat16)
        want = ref.flash_attention_ref(q, k, v)
        for case in (cases + cases[::-1]) * args.rounds:
            def run():
                return fa._launch(libs[case], kernels[case], q, k, v, True)
            got = run()
            yield {"D": D, "case": case, "kernel": kernels[case],
                   "ms": cs.median_ms(run, dev, args.iters),
                   "bit_equal_share": float((got == want).double().mean()),
                   "max_abs_err": cs.max_abs_err(got, want)}


def kmeans_readings(libs, kernels, cases, args, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    x, c, w, scale, xf = cs.km_inputs(gen, 256, cs.FULL_ROWS // 256, 16, 8,
                                      torch.int16, False)
    want = ref.kmeans_assign_ref(x, c, w, scale, return_assign=True)
    onehot = (want[3].long()[..., None] == torch.arange(8, device=dev)
              ).double() * w.double()[..., None]
    mass = (onehot.transpose(-1, -2) @ xf.abs().double()).clamp(min=1e-30)
    del onehot, xf
    for case in (cases + cases[::-1]) * args.rounds:
        def run():
            return km._launch(libs[case], x, c, w, scale, False)
        got = km._launch(libs[case], x, c, w, scale, True)
        yield {"case": case, "ms": cs.median_ms(run, dev, args.iters),
               "assign_equal": bool(torch.equal(got[3], want[3])),
               "counts_equal": bool(torch.equal(got[1], want[1])),
               "sums_max_err_over_mass": float(
                   ((got[0].double() - want[0].double()).abs()
                    / mass).max())}


READINGS = {"flash_attention": flash_readings,
            "kmeans_assign": kmeans_readings}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--kernel", choices=sorted(VARIANTS),
                   default="flash_attention")
    p.add_argument("--variants", default=None,
                   help="comma-separated edits of the kernel's source "
                        "(flash_attention: mma, stages2, nolo; default "
                        "mma)")
    p.add_argument("--against", action="append", default=[],
                   help="another version of the kernel's source to time "
                        "(repeatable)")
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    name, wrapper = args.kernel, WRAPPERS[args.kernel]
    if args.variants is None:
        args.variants = "mma" if name == "flash_attention" else ""
    dev = torch.device("cuda")
    print(cs.device_line(), flush=True)
    src = (build.CSRC / f"{name}.cu").read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources, kernels = {}, {}
    for variant in filter(None, args.variants.split(",")):
        edits, kernels[variant] = VARIANTS[name][variant]
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {variant}: {old!r} not in the "
                                   f"source")
            text = text.replace(old, new)
        sources[variant] = build.BUILD_DIR / f"{name}_ab_{variant}.cu"
        sources[variant].write_text(text)
    for i, path in enumerate(args.against):
        label = f"against{i}"
        sources[label], kernels[label] = Path(path), "wgmma"
        print(json.dumps({"case": label, "source": path}), flush=True)
    build.build_all(list(sources), sources)
    libs = {label: build.bind(build.library_path(label, path),
                              wrapper._SIGNATURES)
            for label, path in sources.items()}
    libs["route"] = build.load(name, wrapper._SIGNATURES)
    kernels["route"] = "wgmma"
    cases = ["route", *sources]
    for reading in READINGS[name](libs, kernels, cases, args, dev):
        print(json.dumps(reading), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
