#!/usr/bin/env python3
"""Time qwen2-0.5b's training step of two checkouts in turns on one card.

    python3 tools/step_ab.py --against old --rounds 1

Each turn is a process of its own, run with ``PYTHONPATH`` at one
checkout's ``src``: ``this`` (the checkout this script sits in) and each
``--against`` directory (the root of another checkout, say a parent
commit unpacked by ``git archive``).  The turns run the other checkouts,
then this one, and then backward (A B B A), ``--rounds`` times; a
checkout's first turn builds its kernels into its own build directory.

A turn builds qwen2-0.5b at full width (random parameters from
``--seed``, bf16, AdamW's float32 master and moments), takes one
``TokenStream`` batch of 4 x 2048 tokens, runs ``--warm`` steps of
``launch.train.make_step_fn`` and times ``--steps`` more, each on the
host clock from its call to the card's finish; then ``loss_and_grads``
alone between CUDA events.  It also times one layer's
``flash_attention_bwd`` at the training shape (q (4, 14, 2048, 64), k and
v (4, 2, 2048, 64), bf16, causal, every tensor a (B, H, S, D) view of a
(B, S, H, D) tensor) through the checkout's own wrapper: calls back to
back between two events, one call between its own events, and the host's
time a call while the card works.  Each turn also gives the loss after
every timed step (the same batch, so it falls fast and small differences
in the gradients' rounding grow); ``--plain`` adds a last turn of this
checkout with the plain PyTorch functions in place of the kernels
(``dispatch.use_kernels(False)``) as those losses' reference.

Prints the card's name and power limit, one JSON line a turn, then one
line a checkout with its readings from every turn.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, BATCH, SEQ, HEADS, KV_HEADS, HEAD_DIM = "qwen2-0.5b", 4, 2048, 14, 2, 64


def median_of_runs(run_once, runs: int = 5) -> float:
    return statistics.median(run_once() for _ in range(runs))


def child(args) -> dict:
    """One turn in this process, on the checkout ``PYTHONPATH`` names."""
    import torch

    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.launch import train as lm_train
    from repro_torch.models.model_api import build
    from repro_torch.optim import adamw

    dev = torch.device("cuda")

    def sync():
        torch.cuda.synchronize(dev)

    def events_ms(fn, calls: int = 1) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    cfg = get_config(ARCH)
    model = build(cfg, dev)
    opt = adamw(3e-4)
    state = lm_train.make_state(model, opt, args.seed)
    stream = TokenStream(cfg.vocab_size, BATCH, SEQ, seed=args.seed,
                         device=dev)
    batch = lm_train.make_batch_fn(cfg, stream, BATCH, SEQ)(0)
    step_fn = lm_train.make_step_fn(model, opt)
    with (dispatch.use_kernels(False) if args.plain
          else contextlib.nullcontext()):
        for _ in range(args.warm):
            state, _ = step_fn(state, batch)
        sync()
        steps, losses = [], []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            sync()
            steps.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
        grads_ms = [events_ms(lambda: lm_train.loss_and_grads(
            model, state["params"], batch)) for _ in range(5)]
    del state, batch, metrics
    torch.cuda.empty_cache()
    out = {"checkout": os.path.dirname(os.path.dirname(os.path.dirname(
               os.path.abspath(repro_torch.__file__)))),
           "plain": args.plain,
           "step_ms": statistics.median(steps), "step_ms_all": steps,
           "tokens_per_s": BATCH * SEQ * 1e3 / statistics.median(steps),
           "loss_and_grads_ms": statistics.median(grads_ms),
           "losses": losses,
           "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    if args.plain:
        return out

    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def bshd(heads):
        return torch.randn((BATCH, SEQ, heads, HEAD_DIM), generator=gen,
                           device=dev).to(torch.bfloat16).transpose(1, 2)

    q, k, v = bshd(HEADS), bshd(KV_HEADS), bshd(KV_HEADS)
    o, lse = flash_attention(q, k, v, return_lse=True)
    do = bshd(HEADS)

    def bwd():
        return flash_attention_bwd(q, k, v, o, do, lse)

    for _ in range(3):
        bwd()
    sync()

    def host_ms():
        t0 = time.perf_counter()
        for _ in range(20):
            bwd()
        ms = (time.perf_counter() - t0) * 1e3 / 20
        sync()
        return ms

    out["flash_bwd"] = {"ms": median_of_runs(lambda: events_ms(bwd, 20)),
                        "single_call_ms": median_of_runs(
                            lambda: events_ms(bwd)),
                        "host_ms": median_of_runs(host_ms)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--against", action="append", default=[],
                   help="the root of another checkout (repeatable)")
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--warm", type=int, default=3)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--timeout", type=int, default=900,
                   help="seconds a turn may take, its build included")
    p.add_argument("--plain", action="store_true",
                   help="add a turn of this checkout without its kernels")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        print(json.dumps(child(args)), flush=True)
        return 0

    import torch
    if not torch.cuda.is_available():
        print("step_ab: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    trees = {f"against{i}": os.path.abspath(path)
             for i, path in enumerate(args.against)}
    trees["this"] = ROOT
    cases = list(trees)
    turns = {case: [] for case in cases}
    order = (cases + cases[::-1]) * args.rounds
    if args.plain:
        trees["plain"] = ROOT
        turns["plain"] = []
        order.append("plain")
    for case in order:
        env = dict(os.environ, PYTHONPATH=os.path.join(trees[case], "src"))
        cmd = [sys.executable, os.path.abspath(__file__), "--child",
               "--warm", str(args.warm), "--steps", str(args.steps),
               "--seed", str(args.seed), *["--plain"] * (case == "plain")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=args.timeout)
        if proc.returncode != 0:
            print(f"step_ab: the turn of {case} failed "
                  f"({proc.returncode}):\n{proc.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        reading = json.loads(proc.stdout.strip().splitlines()[-1])
        reading = {"case": case, "turn_s": time.perf_counter() - t0,
                   **reading}
        turns[case].append(reading)
        print(json.dumps(reading), flush=True)
    for case, readings in turns.items():
        print(json.dumps({
            "case": case, "checkout": trees[case], "turns": len(readings),
            "step_ms": [r["step_ms"] for r in readings],
            "tokens_per_s": [r["tokens_per_s"] for r in readings],
            "loss_and_grads_ms": [r["loss_and_grads_ms"] for r in readings],
            "last_loss": [r["losses"][-1] for r in readings],
            **{f"flash_bwd_{k}": [r["flash_bwd"][k] for r in readings]
               for k in ("ms", "single_call_ms", "host_ms")
               if case != "plain"}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
