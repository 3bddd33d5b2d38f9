"""Batched greedy serving: fill the KV cache with a batch of prompts, then
decode, through the ``Model`` facade.

Port of ``examples/serve_lm.py``:

    python -m repro_torch.launch.serve_lm --arch qwen2-0.5b           # card
    python -m repro_torch.launch.serve_lm --smoke --device cpu        # CPU

The full config runs on the card by default, with random weights drawn
from seed 0 at the published shapes; ``--smoke`` takes the reduced
config.  As in the JAX script, the cache is filled by replaying each
prompt token through ``decode_step``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.models import Model, build


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor         # (B, new_tokens) int64, greedy
    prompt_logits: torch.Tensor  # (B, Vp): the last prompt position's
    prefill_s: float             # replaying the prompts, host clock
    decode_s: float              # the other new_tokens - 1 steps


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(model: Model, params: dict, prompts: torch.Tensor,
             new_tokens: int) -> Generation:
    """Greedy continuation of ``prompts`` (B, P) by ``new_tokens`` tokens.

    The cache (``P + new_tokens`` positions) is filled by replaying the
    prompt through ``decode_step``; the first new token is the argmax of
    the last prompt position's logits, each later one that of the step
    before.  Times end in a synchronise."""
    B, P = prompts.shape
    V = model.cfg.vocab_size
    dev = model.device
    cache = model.init_cache(B, P + new_tokens)
    _sync(dev)
    t0 = time.perf_counter()
    for t in range(P):
        logits, cache = model.decode_step(params, cache,
                                          prompts[:, t:t + 1], t)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    prompt_logits = logits[:, -1]
    tok = torch.argmax(prompt_logits[:, :V], dim=-1)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for t in range(P, P + new_tokens - 1):
        logits, cache = model.decode_step(params, cache, tok, t)
        tok = torch.argmax(logits[:, -1, :V], dim=-1)[:, None]
        out.append(tok)
    _sync(dev)
    return Generation(torch.cat(out, dim=1), prompt_logits, prefill_s,
                      time.perf_counter() - t0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config of the arch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    args = ap.parse_args(argv)

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    model = build(cfg, args.device)
    gen = torch.Generator(device=model.device).manual_seed(0)
    with torch.inference_mode():
        params = model.init(gen)
        prompts = torch.randint(0, cfg.vocab_size,
                                (args.batch, args.prompt_len), generator=gen,
                                device=model.device)
        res = generate(model, params, prompts, args.new_tokens)
    B, P, n = args.batch, args.prompt_len, res.tokens.shape[1]
    print(f"arch={args.arch} ({'smoke' if args.smoke else 'full'} config, "
          f"{model.param_count(params):,} params) on {model.device}  "
          f"batch={B}")
    print(f"prefill: {P} tokens x {B} seqs in {res.prefill_s * 1e3:.0f}ms")
    print(f"decode : {n} tokens x {B} seqs in {res.decode_s * 1e3:.0f}ms "
          f"({B * (n - 1) / max(res.decode_s, 1e-9):.1f} tok/s)")
    for i in range(min(2, B)):
        print(f"  seq{i}: {res.tokens[i, :12].tolist()} ...")


if __name__ == "__main__":
    main()
