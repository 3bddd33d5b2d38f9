"""LM training launcher: ``--arch <id>`` through the fault-tolerant
``Trainer``.

Port of ``repro/launch/train.py``:

    python -m repro_torch.launch.train --arch qwen2-0.5b --smoke \
        --steps 50 --batch 8 --seq 128 --device cpu           # CPU
    python -m repro_torch.launch.train --arch qwen2-0.5b \
        --steps 20 --batch 4 --seq 2048                       # the card

Parameters are random from seed 0 at the config's shapes and dtype
(bf16 at full size); AdamW keeps a float32 master, moments and a step
beside them; a batch a step comes from ``TokenStream(seed=0)``; with
``--ckpt-dir`` the trainer checkpoints and a second run over the same
directory resumes.  A step is ``Model.loss``, ``torch.autograd.grad``
over the parameter leaves (the attention's gradient is the
``flash_attention_bwd`` kernel on the card), then the optimizer's update
out of place under ``torch.no_grad()``.  JAX jits the step; the port runs
it eagerly.  ``--production-mesh`` (``--multi-pod``) builds the (16, 16)
((2, 16, 16)) mesh over a launcher's world of 256 (512) ranks, makes the
arch's rules table (``distributed.sharding.make_rules``) and places the
parameters, the optimizer state and each batch as ``DTensor``s by it
(``launch.shardings``); a checkpoint directory on a mesh raises (item
12b).
"""

from __future__ import annotations

import argparse
from typing import Callable

import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.data import TokenStream
from repro_torch.distributed.sharding import (current_rules, make_rules,
                                              use_rules)
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model, build
from repro_torch.models import common as cm
from repro_torch.optim import Optimizer, adamw
from repro_torch.runtime import Trainer, TrainerConfig
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def make_state(model: Model, opt: Optimizer, seed: int = 0) -> dict:
    """``{"params", "opt"}``: the model's random parameters from ``seed``
    on its device and the optimizer's state over them."""
    params = model.init(seed)
    return {"params": params, "opt": opt.init(params)}


def trainable(params):
    """``params`` as fresh leaves that autograd records, detached from
    whatever produced them."""
    return tree_map(lambda p: p.detach().requires_grad_(), params)


def loss_and_grads(model: Model, params, batch: dict):
    """``(loss, metrics, grads)``: ``Model.loss`` on ``batch`` and its
    gradient in every parameter leaf, ``grads`` shaped as ``params``.  The
    step's forward and backward, and nothing else."""
    leaves = trainable(params)
    loss, metrics = model.loss(leaves, batch)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    return loss, metrics, tree_unflatten(leaves, grads)


def make_step_fn(model: Model, opt: Optimizer) -> Callable:
    """``step_fn(state, batch) -> (state, metrics)``: ``loss_and_grads``,
    then ``opt.update`` (under active rules with each gradient first
    redistributed to its parameter's placements,
    ``launch.shardings.pin_to``).  The
    metrics (``loss``, ``ce``, ``aux``) stay on the device; the state
    handed in is not changed."""

    def step_fn(state: dict, batch: dict):
        loss, metrics, grads = loss_and_grads(model, state["params"], batch)
        if current_rules() is not None:
            grads = sh.pin_to(grads, state["params"])
        with torch.no_grad():
            new_p, new_o = opt.update(grads, state["opt"], state["params"])
        return ({"params": new_p, "opt": new_o},
                {"loss": loss.detach(),
                 **{k: v.detach() for k, v in metrics.items()}})

    return step_fn


def make_batch_fn(cfg: cm.ModelConfig, stream: TokenStream, batch: int,
                  seq: int) -> Callable[[int], dict]:
    """``step -> {"tokens": (batch, seq)}`` from ``stream``, pure in the
    step, plus what JAX's launcher adds: zero ``"frames"`` (batch, n_ctx,
    d_model) for an encoder-decoder and zero ``"prefix_embeds"`` (batch,
    n_prefix_embeds, d_model) for a config with a prefix, in the compute
    dtype on the stream's device (made once, read by every step)."""
    if (stream.batch, stream.seq) != (batch, seq):
        raise ValueError(f"the stream gives ({stream.batch}, {stream.seq}) "
                         f"batches, asked for ({batch}, {seq})")
    if stream.vocab != cfg.vocab_size:
        raise ValueError(f"the stream draws from {stream.vocab} tokens, "
                         f"{cfg.name} has {cfg.vocab_size}")
    shapes = {}
    if cfg.encoder is not None:
        shapes["frames"] = (batch, cfg.encoder.n_ctx, cfg.d_model)
    if cfg.n_prefix_embeds:
        shapes["prefix_embeds"] = (batch, cfg.n_prefix_embeds, cfg.d_model)
    extra = {k: torch.zeros(shape, dtype=cfg.compute_dtype,
                            device=stream.device)
             for k, shape in shapes.items()}
    return lambda step: {**stream.batch_at(step), **extra}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config of the arch (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the (16, 16) mesh (a world of 256 ranks)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) mesh (a world of 512 ranks)")
    args = ap.parse_args(argv)

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    rules = None
    if args.production_mesh or args.multi_pod:
        if args.ckpt_dir is not None:
            raise NotImplementedError(
                "--ckpt-dir on a mesh: a sharded checkpoint is multi-rank "
                "work, ROADMAP item 12b")
        mesh = make_production_mesh(
            multi_pod=args.multi_pod,
            device_type=None if args.device is None
            else torch.device(args.device).type)
        rules = make_rules(mesh, n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_kv_heads)
    model = build(cfg, args.device)
    opt = adamw(args.lr)
    stream = TokenStream(cfg.vocab_size, args.batch, args.seq, seed=0,
                         device=model.device)
    with use_rules(rules):
        state = make_state(model, opt)
        batch_fn = make_batch_fn(cfg, stream, args.batch, args.seq)
        if rules is not None:
            state = {"params": sh.distribute_tree(rules, state["params"],
                                                  sh.param_axes),
                     "opt": sh.distribute_tree(rules, state["opt"],
                                               sh.param_axes)}
            plain_batch = batch_fn
            batch_fn = lambda step: sh.distribute_tree(  # noqa: E731
                rules, plain_batch(step), sh.batch_axes)
        trainer = Trainer(make_step_fn(model, opt), state, batch_fn,
                          TrainerConfig(ckpt_dir=args.ckpt_dir,
                                        log_every=10))
        out = trainer.run(args.steps, callback=lambda s, m: print(
            f"step {s}: loss={float(m['loss']):.4f}"))
    print(f"done: {out['final_step']} steps, restarts={out['restarts']}")
    return out


if __name__ == "__main__":
    main()
