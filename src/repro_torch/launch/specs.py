"""Input stand-ins for each (architecture × assigned shape): tensors of
every model input's shape and dtype that hold no data, which the dry run
(``launch.dryrun``) places and traces.

Port of ``repro/launch/specs.py``.  JAX's stand-ins are
``ShapeDtypeStruct``s; the port's are tensors made on ``device`` — a
``"meta"`` tensor by default, or under a ``FakeTensorMode`` a fake tensor
of the device asked for — so nothing is allocated.

Assigned LM shape set (each applies to all 10 archs unless skipped):
  train_4k     seq 4,096   x global_batch 256   (train step)
  prefill_32k  seq 32,768  x global_batch 32    (prefill forward)
  decode_32k   KV 32,768   x global_batch 128   (decode step, 1 token)
  long_500k    KV 524,288  x global_batch 1     (decode step, 1 token)

``long_500k`` needs sub-quadratic attention: only mamba2-370m (the SSD's
O(1) state) and recurrentgemma-2b (the LRU's O(1) state and a 2048-slot
ring) run it; the full-attention archs skip with a recorded reason.  The
modality frontends are stand-ins, as JAX's: whisper receives frame
embeddings, llava patch embeddings.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.common import ModelConfig

SHAPES: Dict[str, dict] = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

_SUBQUADRATIC = {"mamba2-370m", "recurrentgemma-2b"}


@dataclasses.dataclass(frozen=True)
class CellSpec:
    arch: str
    shape: str
    kind: str                   # train | prefill | decode
    batch: int
    seq_len: int
    skip_reason: Optional[str] = None

    @property
    def runnable(self) -> bool:
        return self.skip_reason is None


def cell_spec(cfg: ModelConfig, shape: str) -> CellSpec:
    meta = SHAPES[shape]
    skip = None
    if shape == "long_500k" and cfg.name not in _SUBQUADRATIC:
        skip = ("pure full-attention arch: 512k-context decode is "
                "quadratic/unservable; long_500k runs only for SSM/hybrid "
                "(mamba2-370m, recurrentgemma-2b)")
    return CellSpec(arch=cfg.name, shape=shape, kind=meta["kind"],
                    batch=meta["global_batch"], seq_len=meta["seq_len"],
                    skip_reason=skip)


def _stand_in(shape, dtype, device) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def batch_specs(cfg: ModelConfig, spec: CellSpec, device="meta"
                ) -> Dict[str, torch.Tensor]:
    """Full-sequence inputs for training and prefill: ``tokens`` int32
    (B, S); whisper's ``frames`` (B, n_ctx, d) in the compute dtype;
    llava's ``prefix_embeds`` (B, n_prefix, d), which take the first
    n_prefix of the S positions."""
    B, S = spec.batch, spec.seq_len
    out = {}
    if cfg.encoder is not None:
        out["tokens"] = _stand_in((B, S), torch.int32, device)
        out["frames"] = _stand_in((B, cfg.encoder.n_ctx, cfg.d_model),
                                  cfg.compute_dtype, device)
        return out
    n_prefix = cfg.n_prefix_embeds
    if n_prefix:
        out["prefix_embeds"] = _stand_in((B, n_prefix, cfg.d_model),
                                         cfg.compute_dtype, device)
        out["tokens"] = _stand_in((B, S - n_prefix), torch.int32, device)
    else:
        out["tokens"] = _stand_in((B, S), torch.int32, device)
    return out


def decode_specs(cfg: ModelConfig, spec: CellSpec, model) -> Tuple:
    """``(cache, token, pos)`` for the decode step: ``model.init_cache(B,
    S)`` made under the caller's mode on the model's device (a fake or
    ``meta`` model allocates nothing), a token (B, 1) int32 and a 0-dim
    int32 position."""
    B, S = spec.batch, spec.seq_len
    cache = model.init_cache(B, S)
    token = _stand_in((B, 1), torch.int32, model.device)
    pos = _stand_in((), torch.int32, model.device)
    return cache, token, pos


def train_tokens_per_step(spec: CellSpec) -> int:
    return spec.batch * spec.seq_len
