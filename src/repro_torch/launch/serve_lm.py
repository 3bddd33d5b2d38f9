"""Batched greedy serving: fill the KV cache with a batch of prompts, then
decode, through the ``Model`` facade.

Port of ``examples/serve_lm.py``:

    python -m repro_torch.launch.serve_lm --arch qwen2-0.5b           # card
    python -m repro_torch.launch.serve_lm --smoke --device cpu        # CPU

The full config runs on the card by default, with random weights drawn
from seed 0 at the published shapes; ``--smoke`` takes the reduced
config.  As in the JAX script, the cache is filled by replaying each
prompt token through ``decode_step``; JAX jits that step once with a
traced ``pos``, and the port captures it once as a CUDA graph
(:class:`DecodeStep`).  An encoder-decoder (``--arch whisper-tiny``)
serves random frames drawn from the seed, encoded once into the cache's
cross K/V before the prompt (``encdec.encdec_build_cross``); a model
with a prefix (llava) decodes tokens only, as JAX's ``decode_step``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core.graphs import Graph
from repro_torch.models import Model, build
from repro_torch.models import encdec
from repro_torch.tree import tree_leaves


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor         # (B, new_tokens) int64, greedy
    prompt_logits: torch.Tensor  # (B, Vp): the last prompt position's
    prefill_s: float             # replaying the prompts, host clock
    decode_s: float              # the other new_tokens - 1 steps


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class DecodeStep:
    """One greedy decode step over static buffers, captured once on the
    card (``core.graphs.Graph``): the token ``tok`` (B, 1) and the
    position ``pos`` (0-dim int32) live on the card, and a replay runs
    ``Model.decode_step`` on the static KV cache, writes the argmax of
    the next token into ``tok`` and steps ``pos``, so a token costs one
    replay.  ``logits`` (B, 1, Vp) is the step's output, overwritten by
    every replay.  The weights are read in place.  On the CPU a replay
    runs the same step eagerly on the same buffers."""

    def __init__(self, model: Model, params: dict, batch: int,
                 max_len: int):
        dev, V = model.device, model.cfg.vocab_size
        self.cache = model.init_cache(batch, max_len)
        self.tok = torch.zeros((batch, 1), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((), dtype=torch.int32, device=dev)

        def step(cache, tok, pos):
            logits, _ = model.decode_step(params, cache, tok, pos)
            tok.copy_(torch.argmax(logits[:, -1, :V], dim=-1)[:, None])
            pos.add_(1)
            return logits

        self.graph = Graph(dev)
        scratch = (model.init_cache(batch, max_len), self.tok.clone(),
                   self.pos.clone())
        self.graph.warm(lambda: step(*scratch))
        del scratch
        self.graph.capture(lambda: step(self.cache, self.tok, self.pos))

    def reset(self) -> None:
        """Position 0 and every cache tensor zero, as ``init_cache`` makes
        it: an encoder-decoder's cross K/V too, so build it
        (``encdec.encdec_build_cross`` on ``self.cache``) after a
        reset."""
        for t in tree_leaves(self.cache):
            t.zero_()
        self.pos.zero_()

    def __call__(self, token: torch.Tensor | None = None) -> torch.Tensor:
        """One step at ``pos``, on ``token`` (B, 1) when given (a prompt
        token, copied in on the card), else on the argmax the previous
        step wrote; returns the static ``logits``."""
        if token is not None:
            self.tok.copy_(token)
        self.graph.replay()
        return self.graph.outputs


def generate(model: Model, params: dict, prompts: torch.Tensor,
             new_tokens: int, frames: torch.Tensor | None = None
             ) -> Generation:
    """Greedy continuation of ``prompts`` (B, P) by ``new_tokens`` tokens,
    over ``frames`` (B, n_ctx, d) for an encoder-decoder.

    One :class:`DecodeStep` is captured for ``(B, P + new_tokens)``
    before the clocks start; after its reset, an encoder-decoder's
    encoder runs once on ``frames`` into the step's cross K/V (before
    the prefill clock).  The cache is filled by replaying it over
    the prompt, each prompt token copied into its static token on the
    card; the first new token is the argmax of the last prompt
    position's logits, each later one that of the step before, written
    by the replay itself.  A decode token costs one replay and one copy
    of the token out, with no host read until the end.  Times end in a
    synchronise."""
    B, P = prompts.shape
    dev = model.device
    if (frames is None) != (model.cfg.encoder is None):
        raise ValueError(f"{model.cfg.name}: frames are "
                         f"{'needed' if frames is None else 'not taken'}")
    step = DecodeStep(model, params, B, P + new_tokens)
    step.reset()
    if frames is not None:
        encdec.encdec_build_cross(model.cfg, params, frames.to(dev),
                                  step.cache)
    prompts = prompts.to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    for t in range(P):
        logits = step(prompts[:, t:t + 1])
    prompt_logits = logits[:, -1].clone()
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    out = [step.tok.clone()]
    t0 = time.perf_counter()
    for _ in range(new_tokens - 1):
        step()
        out.append(step.tok.clone())
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
        frames = None
        if cfg.encoder is not None:
            frames = torch.randn((args.batch, cfg.encoder.n_ctx,
                                  cfg.d_model), generator=gen,
                                 device=model.device)
        res = generate(model, params, prompts, args.new_tokens, frames)
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
