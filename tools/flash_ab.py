#!/usr/bin/env python3
"""Time builds of flash_attention's bf16 kernels in turns on one CUDA card.

    python3 tools/flash_ab.py                        # route vs mma.sync
    python3 tools/flash_ab.py --variants mma,nolo --rounds 2
    python3 tools/flash_ab.py --against old/flash_attention.cu

Every case runs at qwen2-0.5b's prefill shape, q (4, 14, 4096, D) and k,
v (4, 2, 4096, D), causal, bf16, at D = 64 and D = 128.  The cases run
in turns, the list forward and then backward (A B B A), ``--rounds``
times, each reading a median of ``--iters`` launches (CUDA events), in
one process on one card.  Each line also gives the share of outputs
bit-equal to the plain version.

The cases: ``route``, the checkout's library as the wrapper launches it
(``flash_wgmma_kernel`` at both widths); each variant, an edit of
``csrc/flash_attention.cu`` built beside it and launched as its kernel
below; each ``--against`` file, another version of that source (say a
parent commit's, unpacked by ``git archive``) launched through its
``wgmma`` kernel.  Everything is built by ``repro_torch.kernels.build``
into its build directory, in parallel.

  mma      the repaired flash_mma_kernel, instantiated at every width
           (the route takes it at D = 32 only);
  stages2  a two-stage K/V ring instead of three;
  nolo     p.v without p's lo term (not the kernel's function: it shows
           what keeping p in float32 costs).

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

# name: (edits of the source, the kernel launched)
VARIANTS = {
    "mma": ([("} else if constexpr (D == 32) {",
              "} else if constexpr (true) {")], "mma"),
    "stages2": ([("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
                "wgmma"),
    "nolo": ([("      wgmma_pv<D>(o, pl[kk], dv);\n", "")], "wgmma"),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--variants", default="mma",
                   help=f"comma-separated, of {sorted(VARIANTS)}")
    p.add_argument("--against", action="append", default=[],
                   help="another flash_attention.cu to time (repeatable)")
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.device_line(), flush=True)
    src = (build.CSRC / "flash_attention.cu").read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources, kernels = {}, {}
    for name in filter(None, args.variants.split(",")):
        edits, kernels[name] = VARIANTS[name]
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in the "
                                   f"source")
            text = text.replace(old, new)
        sources[name] = build.BUILD_DIR / f"flash_ab_{name}.cu"
        sources[name].write_text(text)
    for i, path in enumerate(args.against):
        label = f"against{i}"
        sources[label], kernels[label] = Path(path), "wgmma"
        print(json.dumps({"case": label, "source": path}), flush=True)
    build.build_all(list(sources), sources)
    libs = {label: build.bind(build.library_path(label, path),
                              fa._SIGNATURES)
            for label, path in sources.items()}
    libs["route"] = build.load("flash_attention", fa._SIGNATURES)
    kernels["route"] = "wgmma"
    cases = ["route", *sources]
    gen = torch.Generator(device=dev).manual_seed(0)
    for D in (64, 128):
        q, k, v = cs.flash_inputs(gen, cs.LM_BATCH, 14, 2, cs.LM_SEQ, D,
                                  torch.bfloat16)
        want = ref.flash_attention_ref(q, k, v)
        for case in (cases + cases[::-1]) * args.rounds:
            def run():
                return fa._launch(libs[case], kernels[case], q, k, v, True)
            got = run()
            print(json.dumps({
                "D": D, "case": case, "kernel": kernels[case],
                "ms": cs.median_ms(run, dev, args.iters),
                "bit_equal_share": float((got == want).double().mean()),
                "max_abs_err": cs.max_abs_err(got, want)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
