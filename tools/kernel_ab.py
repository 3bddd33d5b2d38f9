#!/usr/bin/env python3
"""Time versions of a CUDA kernel in turns on one card.

    python3 tools/kernel_ab.py                       # flash: route vs mma.sync
    python3 tools/kernel_ab.py --variants mma,nolo --rounds 2
    python3 tools/kernel_ab.py --against old/flash_attention.cu
    python3 tools/kernel_ab.py --kernel kmeans_assign \\
        --against old/kmeans_assign.cu --rounds 3
    python3 tools/kernel_ab.py --kernel split_hist --variants noflush \\
        --against old/split_hist.cu --bins uint8,int32
    python3 tools/kernel_ab.py --kernel fxp_matmul \\
        --against old/fxp_matmul.cu --rounds 2
    python3 tools/kernel_ab.py --kernel flash_attention_bwd \\
        --against old/flash_attention.cu --rounds 2

The cases run in turns, the list forward and then backward (A B B A),
``--rounds`` times, each reading the median over five runs of
``--iters`` launches enqueued back to back (CUDA events around a run,
divided by its launches), in one process on one card.  Each line also
says how the reading's outputs compare with the plain version's.

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

``split_hist`` runs at ``chip_smoke.time_sh``'s inputs: the seven
passes of a depth-6 tree (1, 2, ..., 64 nodes) over 256 lanes x 65,536
rows, F = 16, 32 bins, 4 classes, every tenth row masked, with the bins
as uint8 (the tree's resident bins) and as int32 (``--bins``); a reading
is the sum of the seven passes' times, and says whether every H is
bit-equal to the plain version's.  A source with the parent's interface
(before the redesign: ``ft`` features a block, ``n_chunks`` chunks, a
zeroed H) is launched as its wrapper launched it.  Its variants:

  noflush   no write of H (not the kernel's function: it shows what the
            flush costs);
  l2rows    every block reads the first 4,096 rows of its lane, which
            stay in L2 (not the kernel's function: it shows what the
            rows' trip from device memory costs);
  atomsadd  the unit count added as a value the compiler cannot see is
            1 (ATOMS.ADD, not ATOMS.POPC.INC);
  u1, u3    one or three rows a thread a step, not two.

``fxp_matmul`` runs the whole dot of a training step (the forward X.W
and the gradient X^T.R on the transposed view, int8 X of 256 lanes x
65,536 rows x 64 features, int16 W and R) at logreg's shape (N = 1) and
at the multinomial's C = 4 and 10 (``--shapes``); a reading is the sum of
the two dots' times and says whether both are bit-equal to the plain
version (``hybrid_dot``).  A source with the interface of before the
whole-dot kernel (int32 chunk partials of one a-limb, b's int16 limbs as
its columns, at most 8) is launched as its wrapper and ``hybrid_matmul``
drove it: b's limbs in groups of 8 limb columns, a launch per group and
a-limb, the float combination in PyTorch.  Its variants:

  cw2, cw8 two or eight warps a cols block instead of four;
  clb2     the cols kernel held to two blocks an SM (128 registers);
  nostage  the rows kernel stores its output from the fragments at
           every N (the staged store is for N > 8);
  stageall the output staged in shared memory at every N;
  nostore  the rows kernel writes no output with one chunk (not the
           kernel's function: it shows what the forward's float32
           output costs).

``flash_attention_bwd`` runs one layer's gradient in qwen2-0.5b's
training step: q, o and dO (4, 14, 2048, 64), k and v (4, 2, 2048, 64),
and with ``--shapes phi4-mini`` at phi4-mini's heads (24 and 8 of D =
128), bf16, causal, every tensor a (B, H, S, D) view of a (B, S, H, D)
tensor as the step hands it over (dO too), the forward's o and lse from the
checkout's library.  A source of ``flash_attention.cu`` from before the
``wgmma`` backward (no ``flash_bwd_dkdv_wgmma_kernel``) is launched on its
``mma.sync`` route through the same wrapper.  A line gives the error over
max|grad| and the bit-equal share against the plain version, one call
between its own events (``single_call_ms``), the host's time a call
while the card works (``host_ms``: the same Python for every case, so
it differs by the library's own), and each backward kernel's device time
a launch (``torch.profiler``).  The whole training step of two
checkouts is compared by ``tools/step_ab.py``.

Prints one JSON line per reading, after the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import quantize as qz  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fxp_matmul as fxp  # noqa: E402
from repro_torch.kernels import kmeans_assign as km  # noqa: E402
from repro_torch.kernels import split_hist as sh  # noqa: E402

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
    "split_hist": {
        "noflush": ([("  if (a.bulk)\n    flush_bulk(",
                      "  if (a.bulk < 0)\n    flush_bulk("),
                     ("  else\n    flush_store(",
                      "  else if (a.bulk < 0)\n    flush_store(")], None),
        "l2rows": ([("    const long long rr = r;\n    x.w",
                     "    long long rr = r;\n    x.w"),
                    ("    x.w = k.wl[rr * k.swr];",
                     "    rr &= 4095;\n    x.w = k.wl[rr * k.swr];")], None),
        "atomsadd": ([("    atomicAdd(cell, 1u);",
                       "    atomicAdd(cell, static_cast<unsigned>(wv));")],
                     None),
        "u1": ([("constexpr int kU = 2;", "constexpr int kU = 1;")], None),
        "u3": ([("constexpr int kU = 2;", "constexpr int kU = 3;")], None),
    },
    "flash_attention_bwd": {},
    "fxp_matmul": {
        "cw2": ([("constexpr int kColWarps = 4;",
                  "constexpr int kColWarps = 2;")], None),
        "cw8": ([("constexpr int kColWarps = 4;",
                  "constexpr int kColWarps = 8;")], None),
        "clb2": ([("__launch_bounds__(kColWarps * 32)\nfxp_cols_kernel",
                   "__launch_bounds__(kColWarps * 32, 2)\nfxp_cols_kernel")],
                 None),
        "nostage": ([("                if (NB > 1)\n"
                      "                  os[warp][(m - r0) * a.N + n] = v;\n"
                      "                else if (m < a.M)",
                      "                if (m < a.M)"),
                     ("      if (NB > 1 && a.n_chunks == 1 && r0 < a.M) {",
                      "      if (false) {")], None),
        "stageall": ([("float os[kRowWarps][NB > 1 ? 16 * MT * kMaxN : 1];",
                       "float os[kRowWarps][16 * MT * kMaxN];"),
                      ("                if (NB > 1)\n"
                       "                  os[warp]",
                       "                if (true)\n"
                       "                  os[warp]"),
                      ("      if (NB > 1 && a.n_chunks == 1 && r0 < a.M) {",
                       "      if (a.n_chunks == 1 && r0 < a.M) {")], None),
        "nostore": ([("      if (NB > 1 && a.n_chunks == 1 && r0 < a.M) {",
                      "      if (a.N < 0) {"),
                     ("                  *out_of(m, n) = v;",
                      "                  ;")], None),
    },
}
WRAPPERS = {"flash_attention": fa, "kmeans_assign": km, "split_hist": sh,
            "fxp_matmul": fxp, "flash_attention_bwd": fa}
# the source each kernel is built from, where its name differs
SOURCE_OF = {"flash_attention_bwd": "flash_attention"}
# a flash_attention.cu whose backward has its wgmma route
WGMMA_BWD_MARK = "flash_bwd_dkdv_wgmma_kernel"
# the interface of the source before its redesign for whole-SM tiles
PARENT_SH_MARK = "int ft, int n_chunks, void* H, void* stream"
PARENT_SH_SIGNATURES = {
    "split_hist_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]),
    "split_hist_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


# the interface of fxp_matmul.cu before the whole-dot kernel
PARENT_FXP_MARK = "int cols, int param, void* stream"
PARENT_FXP_SIGNATURES = {
    "fxp_matmul_launch": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        *[ctypes.c_int] * 5, *[ctypes.c_longlong] * 6, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]),
    "fxp_matmul_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
# the shapes of --kernel fxp_matmul: b's columns (N = 1 for logreg, C for
# the multinomial)
FXP_SHAPES = {"logreg": 1, "multinomial C=4": 4, "multinomial C=10": 10}
# the shapes of --kernel flash_attention_bwd, (B, H, Kh, S, D) of one
# layer's training step at 4 x 2048 tokens: qwen2-0.5b's, and phi4-mini's
# heads at D = 128
BWD_SHAPES = {"qwen2-0.5b": (4, 14, 2, 2048, 64),
              "phi4-mini": (4, 24, 8, 2048, 128)}


def parent_fxp_partials(lib, a, b, kc, limb):
    """The parent's wrapper: int32 partials ``(L, n_chunks, M, N)`` of one
    limb of ``a`` (0: int8; 1, 2: high, low limb of int16) by b's int16
    limb columns."""
    a3 = a if a.dim() == 3 else a.unsqueeze(0)
    b3 = b if b.dim() == 3 else b.unsqueeze(0)
    L, M, K = a3.shape
    N = b3.shape[-1]
    n_chunks = -(-K // kc)
    out = torch.empty((L, n_chunks, M, N), dtype=torch.int32,
                      device=a.device)
    sAl, sAm, sAk = a3.stride()
    _, sBk, sBn = b3.stride()
    cols = sAm == 1 and sAk != 1
    pow2 = 1 << max(0, (-(-kc // 8) if not cols else M) - 1).bit_length()
    param = min(64, pow2) if cols else min(32, pow2)
    err = lib.fxp_matmul_launch(
        a3.data_ptr(), limb, b3.data_ptr(), out.data_ptr(), L, M, K, N, kc,
        sAl, sAm, sAk, b3.stride(0) if b3.shape[0] > 1 else 0, sBk, sBn,
        int(cols), param, torch.cuda.current_stream().cuda_stream)
    build.check(lib, "fxp_matmul", err)
    return out


def parent_fxp_dot(lib, a, b, k_chunk=4096):
    """The parent's ``hybrid_matmul``: b's int16-typed limbs cut into
    groups of 8 limb columns and concatenated, a launch per group and limb
    of ``a``, then the float32 combination of the partials in PyTorch."""
    b_limbs = qz.int8_limbs(b)
    weights = [wb for wb, _ in b_limbs]
    width = 8 // len(b_limbs)
    a_limbs = ([(1.0, 0)] if a.dtype == torch.int8
               else [(256.0, 1), (1.0, 2)])
    kc = min(k_chunk, a.shape[-1])
    outs = []
    for j in range(0, b.shape[-1], width):
        bcat = torch.cat([lb[..., j:j + width] for _, lb in b_limbs], dim=-1)
        n = bcat.shape[-1] // len(weights)
        out = None
        for wa, limb in a_limbs:
            parts = parent_fxp_partials(lib, a, bcat, kc, limb)
            for i, wb in enumerate(weights):
                pj = parts[..., i * n:(i + 1) * n]
                acc = None
                for c in range(parts.shape[-3]):
                    part = pj[..., c, :, :].float()
                    acc = part if acc is None else acc + part
                term = acc * (wa * wb)
                out = term if out is None else out + term
        outs.append(out)
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


def fxp_readings(libs, kernels, cases, args, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    lanes, rows, d = 256, cs.FULL_ROWS // 256, cs.CONFIG.reg_features
    X = cs.rand_int(gen, (lanes, rows, d), -128, 128, torch.int8)
    for shape in args.shapes:
        C = FXP_SHAPES[shape]
        dots = [(X, cs.int16s(gen, (d, C))),
                (X.transpose(-1, -2), cs.int16s(gen, (lanes, rows, C)))]
        wants = [ref.fxp_matmul_ref(a, b) for a, b in dots]
        for case in (cases + cases[::-1]) * args.rounds:
            def run():
                if kernels[case] == "parent":
                    return [parent_fxp_dot(libs[case], a, b) for a, b in dots]
                return [fxp._launch(libs[case], a, b, 4096) for a, b in dots]
            yield {"shape": shape, "case": case,
                   "ms": cs.median_ms(run, dev, args.iters),
                   "bit_equal": all(torch.equal(g, w)
                                    for g, w in zip(run(), wants))}


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


def flash_bwd_readings(libs, kernels, cases, args, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape in args.shapes:
        yield from flash_bwd_shape(libs, kernels, cases, args, dev, gen,
                                   shape)


def flash_bwd_shape(libs, kernels, cases, args, dev, gen, shape):
    B, H, Kh, S, D = BWD_SHAPES[shape]
    q, k, v = cs.flash_inputs(gen, B, H, Kh, S, D, torch.bfloat16)
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    do = torch.randn((B, S, H, D), generator=gen, device=dev
                     ).to(q.dtype).transpose(1, 2)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse)
    top = max(float(w.float().abs().max()) for w in want)
    for case in (cases + cases[::-1]) * args.rounds:
        def run():
            return fa._launch_bwd(libs[case], kernels[case], q, k, v, o, do,
                                  lse, True)
        got = run()
        yield {"shape": shape, "case": case, "kernel": kernels[case],
               "ms": cs.median_ms(run, dev, args.iters),
               "single_call_ms": cs.single_call_ms(run, dev, args.iters),
               "host_ms": cs.host_ms(run, dev, args.iters),
               "err_over_max_grad": max(cs.max_abs_err(g, w)
                                        for g, w in zip(got, want)) / top,
               "bit_equal_share": sum(int((g == w).sum())
                                      for g, w in zip(got, want))
               / sum(w.numel() for w in want),
               "bit_equal_to_itself": all(torch.equal(a, b) for a, b in
                                          zip(got, run())),
               "split": cs.bwd_split(run, dev)}


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


def parent_sh_launch(lib, node, xbin, y, w, nodes, bins, classes):
    """The parent's wrapper: features cut to 48 KB tiles, ~32 blocks an
    SM, a zeroed H that every block adds its non-zero cells into."""
    L, R, F = xbin.shape
    ft = max(1, min(F, 48 * 1024 // (4 * nodes * bins * classes)))
    tiles = -(-F // ft)
    sms = torch.cuda.get_device_properties(xbin.device).multi_processor_count
    chunks = max(1, min(-(-32 * sms // (tiles * L)), -(-R // 1024), 65535))
    H = torch.zeros((L, nodes, F, bins, classes), dtype=torch.float32,
                    device=xbin.device)
    err = lib.split_hist_launch(
        node.data_ptr(), node.stride(0), node.stride(1), xbin.data_ptr(),
        sh._XBIN_DTYPES[xbin.dtype], xbin.stride(0), xbin.stride(1),
        y.data_ptr(), y.stride(0), y.stride(1), w.data_ptr(), w.stride(0),
        w.stride(1), L, R, F, nodes, bins, classes, ft, chunks, H.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    build.check(lib, "split_hist", err)
    return H


def split_hist_readings(libs, kernels, cases, args, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    kw = {"bins": cs.CONFIG.dt_bins, "classes": cs.CONFIG.dt_classes}
    passes = []
    for level in range(cs.CONFIG.dt_depth + 1):
        nodes = 2 ** level
        node, xbin, y, w = cs.sh_inputs(gen, 256, cs.FULL_ROWS // 256,
                                        cs.CONFIG.dt_features, nodes,
                                        kw["bins"], kw["classes"])
        want = ref.split_hist_ref(node, xbin, y, w, n_nodes=nodes,
                                  n_bins=kw["bins"], n_classes=kw["classes"])
        bins = {"int32": xbin, "uint8": xbin.to(torch.uint8)}
        passes.append((nodes, node, {b: bins[b] for b in args.bins}, y, w,
                       want))
    pairs = [(c, b) for c in cases for b in args.bins]
    for case, bins in (pairs + pairs[::-1]) * args.rounds:
        lib = libs[case]
        launch = (parent_sh_launch if kernels[case] == "parent"
                  else sh._launch)
        times, equal = {}, True
        for nodes, node, xb, y, w, want in passes:
            def run():
                return launch(lib, node, xb[bins], y, w, nodes, kw["bins"],
                              kw["classes"])
            equal &= bool(torch.equal(run(), want))
            times[nodes] = cs.median_ms(run, dev, args.iters)
        yield {"case": case, "bins": bins, "ms": sum(times.values()),
               "bit_equal": equal, "passes": times}


READINGS = {"flash_attention": flash_readings,
            "flash_attention_bwd": flash_bwd_readings,
            "kmeans_assign": kmeans_readings,
            "split_hist": split_hist_readings,
            "fxp_matmul": fxp_readings}


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
    p.add_argument("--bins", default="uint8,int32",
                   help="split_hist: the bin types to read (uint8, int32)")
    p.add_argument("--shapes", default=None,
                   help="fxp_matmul: the shapes to read (" +
                        ", ".join(FXP_SHAPES) + "); flash_attention_bwd: "
                        "(" + ", ".join(BWD_SHAPES) + "; default the "
                        "first)")
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    args.bins = args.bins.split(",")
    args.shapes = (args.shapes.split(",") if args.shapes else
                   [next(iter(BWD_SHAPES))] if args.kernel ==
                   "flash_attention_bwd" else list(FXP_SHAPES))
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    name, wrapper = args.kernel, WRAPPERS[args.kernel]
    lib_name = SOURCE_OF.get(name, name)
    if args.variants is None:
        args.variants = "mma" if name == "flash_attention" else ""
    dev = torch.device("cuda")
    print(cs.device_line(), flush=True)
    src = (build.CSRC / f"{lib_name}.cu").read_text()
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
        sources[variant] = build.BUILD_DIR / f"{lib_name}_ab_{variant}.cu"
        sources[variant].write_text(text)
    for i, path in enumerate(args.against):
        label = f"against{i}"
        sources[label], kernels[label] = Path(path), "wgmma"
        text = Path(path).read_text()
        if (name == "split_hist" and PARENT_SH_MARK in text
                or name == "fxp_matmul" and PARENT_FXP_MARK in text):
            kernels[label] = "parent"
        if name == "flash_attention_bwd":
            kernels[label] = "wgmma" if WGMMA_BWD_MARK in text else "mma"
        print(json.dumps({"case": label, "source": path}), flush=True)
    for label, log in build.build_all(list(sources), sources).items():
        print(json.dumps({"case": label, "ptxas": cs.ptxas_summary(log)}),
              flush=True)
    parent_signatures = {"split_hist": PARENT_SH_SIGNATURES,
                         "fxp_matmul": PARENT_FXP_SIGNATURES}.get(name)
    libs = {label: build.bind(build.library_path(label, path),
                              parent_signatures
                              if kernels[label] == "parent"
                              else wrapper._SIGNATURES)
            for label, path in sources.items()}
    libs["route"] = build.load(lib_name, wrapper._SIGNATURES)
    kernels["route"] = "wgmma"
    cases = ["route", *sources]
    for reading in READINGS[name](libs, kernels, cases, args, dev):
        print(json.dumps(reading), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
