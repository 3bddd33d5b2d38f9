"""Model facade: one object per architecture config exposing ``init``,
``loss``, ``prefill``, ``init_cache`` and ``decode_step``.

Port of ``repro/models/model_api.py``: decoders with dense and local
attention, Mamba-2 and RG-LRU layers in any pattern, MLP or
Mixture-of-Experts channel mixers, with an optional prefix of
precomputed embeddings (``transformer``), and the whisper-style
encoder-decoder (``encdec``, chosen by ``cfg.encoder``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import common as cm
from repro_torch.models import encdec as ed
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
        if self.cfg.encoder is not None:
            return ed.init_encdec(self.cfg, gen)
        return tfm.init_lm(self.cfg, gen)

    def loss(self, params: dict, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, dict]:
        """Next-token training loss of ``batch["tokens"]`` (B, S), with
        ``"frames"`` (B, n_ctx, d) for an encoder-decoder
        (``encdec.encdec_loss``) or an optional ``"prefix_embeds"`` (B,
        P, d) for a decoder (``transformer.lm_loss``): ``(loss, {"ce",
        "aux"})``, float32 scalars.  Differentiable in every parameter
        leaf that requires grad."""
        if self.cfg.encoder is not None:
            return ed.encdec_loss(self.cfg, params, batch)
        return tfm.lm_loss(self.cfg, params, batch)

    def prefill(self, params: dict, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        """Full-context forward of ``batch["tokens"]`` (B, S) (with its
        ``"frames"``, or after its ``"prefix_embeds"``, as :meth:`loss`);
        returns the last position's logits (B, 1, Vp)."""
        if self.cfg.encoder is not None:
            return ed.encdec_prefill(self.cfg, params, batch["tokens"],
                                     batch["frames"])
        return tfm.lm_prefill(self.cfg, params, batch["tokens"],
                              batch.get("prefix_embeds"))

    def init_cache(self, batch: int, max_len: int) -> List[dict] | dict:
        """Zero tensors that ``decode_step`` writes into in place.  A
        decoder: one dict a layer, in model order, a KV cache (a ring of
        ``window`` slots for a local-attention layer) or a recurrent state
        (``conv`` and ``ssm`` / ``h``).  An encoder-decoder: ``{"self",
        "cross"}``, a KV dict a decoder layer each, the cross K/V filled
        by ``encdec.encdec_build_cross``."""
        if self.cfg.encoder is not None:
            return ed.encdec_init_cache(self.cfg, batch, max_len,
                                        self.device)
        return tfm.lm_init_cache(self.cfg, batch, max_len, self.device)

    def decode_step(self, params: dict, cache, token: torch.Tensor, pos
                    ) -> Tuple[torch.Tensor, List[dict] | dict]:
        """token (B, 1) at absolute position ``pos`` -> (logits (B, 1,
        Vp), cache updated in place).  ``pos`` is a 0-dim int32 tensor on
        the model's device, as JAX's traced ``pos`` (an int is filled
        there), so the step can be captured (``launch.serve_lm``).  A
        decoder decodes tokens only, with no prefix, as JAX's."""
        if self.cfg.encoder is not None:
            return ed.encdec_decode_step(self.cfg, params, cache, token, pos)
        return tfm.lm_decode_step(self.cfg, params, cache, token, pos)

    def param_count(self, params: dict) -> int:
        return sum(t.numel() for t in _leaves(params))

    def active_param_count(self, params: dict) -> int:
        """The parameters a token uses: the total, less the MoE experts'
        weights (each layer's ``moe`` ``w_gate``, ``w_up`` and ``w_down``)
        but for ``top_k / n_experts`` of them, as JAX's."""
        total = self.param_count(params)
        mc = self.cfg.moe
        if mc is None:
            return total
        experts = sum(layer["moe"][k].numel() for layer in params["layers"]
                      if "moe" in layer for k in ("w_gate", "w_up", "w_down"))
        return total - experts + int(experts * mc.top_k / mc.n_experts)


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
