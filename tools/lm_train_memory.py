"""Peak card memory of an LM training step, or of a prefill, at several
batches and depths.

    python3 tools/lm_train_memory.py --arch mamba2-370m --batch 2,3,4
    python3 tools/lm_train_memory.py --arch recurrentgemma-2b --layers 26,20,17,14
    python3 tools/lm_train_memory.py --arch llava-next-mistral-7b --seq 1216 \
        --layers 9,8,7,6
    python3 tools/lm_train_memory.py --arch phi3.5-moe-42b-a6.6b --prefill \
        --batch 4 --seq 4096 --layers 27,28,29

For each (batch, layers) the arch's full config, cut to its first
``layers`` layers, takes ``--steps`` steps of ``batch`` x ``--seq`` tokens
through ``launch.train``'s state, step and batch function (bf16
parameters, AdamW with a float32 master; ``TokenStream`` tokens, and the
zero frames or prefix embeddings an encoder-decoder or a VLM's batch
carries: llava's 2,880 prefix positions come before ``--seq`` tokens),
and one JSON line gives the
peak of ``torch.cuda.max_memory_allocated`` or the out-of-memory error,
with the card's name and power limit.  With ``--prefill`` each
(batch, layers) is one ``Model.prefill`` of random tokens under
``torch.inference_mode`` after the bf16 weights are drawn from seed 1
(the serving path's peak; no optimizer).  Runs on the card only.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402


def ints(text: str) -> list:
    return [int(x) for x in text.split(",")]


def train_peak(cfg, batch: int, seq: int, steps: int) -> dict:
    """The peak of ``steps`` training steps from seed 1, and the last
    loss."""
    model = build(cfg)
    opt = adamw(3e-4)
    state = train.make_state(model, opt, seed=1)
    step = train.make_step_fn(model, opt)
    stream = TokenStream(cfg.vocab_size, batch, seq, seed=1,
                         device=model.device)
    batch_fn = train.make_batch_fn(cfg, stream, batch, seq)
    for i in range(steps):
        state, metrics = step(state, batch_fn(i))
    torch.cuda.synchronize()
    return {"peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "loss": float(metrics["loss"])}


def prefill_peak(cfg, batch: int, seq: int, steps: int) -> dict:
    """The peak of one prefill of random tokens after the weights are
    drawn from seed 1 (``steps`` is unused), the weights' size and the
    card's."""
    model = build(cfg)
    with torch.inference_mode():
        params = model.init(1)
        weights = torch.cuda.memory_allocated() / 2 ** 30
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                               device=model.device)
        model.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
    return {"peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "weights_gib": weights,
            "card_gib": torch.cuda.get_device_properties(0).total_memory
            / 2 ** 30}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--batch", type=ints, default=[1])
    ap.add_argument("--layers", type=ints, default=None,
                    help="depths to try (default: the config's)")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--prefill", action="store_true",
                    help="the peak of one prefill, not of training steps")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lm_train_memory: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    full = get_config(args.arch)
    for layers in args.layers or [full.n_layers]:
        cfg = dataclasses.replace(full, n_layers=layers,
                                  block_pattern=full.pattern[:layers])
        for batch in args.batch:
            out = {"arch": args.arch, "layers": layers, "batch": batch,
                   "seq": args.seq, "prefix": cfg.n_prefix_embeds,
                   "card": card, "mode": "prefill" if args.prefill
                   else "train"}
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            try:
                run = prefill_peak if args.prefill else train_peak
                out.update(run(cfg, batch, args.seq, args.steps))
            except torch.OutOfMemoryError as e:
                out["out_of_memory"] = str(e).splitlines()[0][:160]
            out["seconds"] = time.perf_counter() - t0
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
