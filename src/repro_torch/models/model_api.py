"""Model facade: one object per architecture config exposing ``init``,
``loss``, ``prefill``, ``init_cache`` and ``decode_step``.

Port of ``repro/models/model_api.py`` for the decoder-only families the
port runs: dense and local attention, Mamba-2 and RG-LRU layers in any
pattern (``transformer``).  ``build`` raises ``NotImplementedError``
for a family that is not ported (MoE, encoder-decoder, prefix
embeddings), naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: cm.ModelConfig
    device: torch.device

    def init(self, seed: int | torch.Generator = 0) -> dict:
        """Random parameters at the config's shapes and dtype, from a
        seed or a ``torch.Generator`` on this model's device."""
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        return tfm.init_lm(self.cfg, gen)

    def loss(self, params: dict, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, dict]:
        """Next-token training loss of ``batch["tokens"]`` (B, S): ``(loss,
        {"ce", "aux"})``, float32 scalars (``transformer.lm_loss``).
        Differentiable in every parameter leaf that requires grad."""
        _no_prefix(batch)
        return tfm.lm_loss(self.cfg, params, batch)

    def prefill(self, params: dict, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        """Full-context forward of ``batch["tokens"]`` (B, S); returns the
        last position's logits (B, 1, Vp)."""
        _no_prefix(batch)
        return tfm.lm_prefill(self.cfg, params, batch["tokens"])

    def init_cache(self, batch: int, max_len: int) -> List[dict]:
        """One dict of zero tensors a layer, in model order: a KV cache
        (a ring of ``window`` slots for a local-attention layer) or a
        recurrent state (``conv`` and ``ssm`` / ``h``).  ``decode_step``
        writes into them in place."""
        return tfm.lm_init_cache(self.cfg, batch, max_len, self.device)

    def decode_step(self, params: dict, cache: List[dict],
                    token: torch.Tensor, pos
                    ) -> Tuple[torch.Tensor, List[dict]]:
        """token (B, 1) at absolute position ``pos`` -> (logits (B, 1,
        Vp), cache updated in place).  ``pos`` is a 0-dim int32 tensor on
        the model's device, as JAX's traced ``pos`` (an int is filled
        there), so the step can be captured (``launch.serve_lm``)."""
        return tfm.lm_decode_step(self.cfg, params, cache, token, pos)

    def param_count(self, params: dict) -> int:
        return sum(t.numel() for t in _leaves(params))


def _no_prefix(batch: dict) -> None:
    if "prefix_embeds" in batch:
        raise NotImplementedError(
            "prefix embeddings are not ported yet: ROADMAP queue A, "
            "item A18.6 (enc-dec and VLM prefix)")


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        for v in tree:
            yield from _leaves(v)


def build(cfg: cm.ModelConfig, device=None) -> Model:
    """The model of ``cfg`` on ``device`` (``None``: the card)."""
    tfm.check_supported(cfg)
    return Model(cfg, resolve_device(device))
