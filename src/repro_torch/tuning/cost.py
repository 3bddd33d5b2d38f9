"""The roofline-backed cost model behind ``merge_plan="auto"``.

Port of ``repro.tuning.cost``.  ``CostModel`` predicts the per-round time
and wire bytes of any candidate ``(cadence, compression, overlap)`` from
the count of ONE cadence-1 state-wire round of the fit's own functions
and the H100's constants (``roofline.hw``):

    us_per_step(k, cfg) = t_local + t_merge(cfg) / k

The JAX package parses the lowered HLO of that round; the port runs it
once under ``roofline.analysis.RoundCounter``, on the grid's own tensors,
and discards what it returns (the fit's state is not touched).  So the
count launches the path's kernels once — for ``LogReg(int8, lut)`` two
``fxp_matmul`` and one ``lut_activation`` — and their launches are in it.
The model is cached on the grid per (step functions, kernels flag), so
repeated fits of one program count once.  It reads no clock.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import torch

from repro_torch.distributed import compression as comp
from repro_torch.distributed import merge_plan as mp
from repro_torch.distributed.compression import CompressionConfig
from repro_torch.roofline import analysis as ra
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.tuning.measurement import Measurement


def compression_tag(cfg: Optional[CompressionConfig]) -> str:
    """Compact JSON-friendly label for a wire format: ``"exact"``,
    ``"int8"``, ``"top0.125@int8"``, ``"top0.25@raw"``."""
    if cfg is None:
        return "exact"
    bits = "raw" if cfg.bits is None else f"int{cfg.bits}"
    if cfg.top_k_frac is not None:
        return f"top{cfg.top_k_frac:g}@{bits}"
    return bits


def _dense_float_bytes(wire: Any) -> int:
    """Dense bytes of the wire tree — the traffic one encode/decode pass
    over it costs."""
    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree_leaves(wire))


def count_round(grid, local_fn, update_fn, state, data) -> ra.RoundCount:
    """The operations and bytes of one cadence-1 state-wire round of the
    plain average (the round the JAX package lowers), run once on
    ``state`` and ``data`` with its outputs discarded."""
    fns = mp.pipeline_fns(grid, local_fn, update_fn, merge_every=1,
                          compression=None, state_wire=True,
                          outer=mp.AverageCommit())
    with ra.RoundCounter() as counter:
        mp.plain_round(fns, data, (state, None, ()), state_wire=True)
    return counter.count


@dataclasses.dataclass
class CostModel:
    """Per-round time and wire-byte predictions from one counted round.

    ``count`` is :func:`count_round` of the fit; ``wire`` is the state
    tree (as shapes and dtypes on the ``meta`` device), which every
    controller round ships across the slow hop.
    """

    count: ra.RoundCount
    wire: Any
    # the world size of the grid's mesh (1 without a mesh)
    n_chips: int = 1

    # encode/decode passes a compressed wire costs over the dense tree
    # (quantize + dequantize + error-feedback update)
    ENCODE_PASSES = 3

    @classmethod
    def for_fit(cls, grid, local_fn, update_fn, state, data
                ) -> "CostModel":
        """Build (or fetch from the grid's cache) the model for one
        fit's functions."""
        from repro_torch.kernels.dispatch import kernels_enabled

        key = ("tuning_cost_model", mp.fn_signature(local_fn),
               mp.fn_signature(update_fn), kernels_enabled())
        hit = mp.cache_get(grid, key)
        if hit is not None:
            return hit
        model = cls(
            count=count_round(grid, local_fn, update_fn, state, data),
            wire=tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                                device="meta"), state),
            n_chips=grid.n_shards)
        mp.cache_put(grid, key, model, local_fn, update_fn)
        return model

    def wire_bytes(self, compression: Optional[CompressionConfig]) -> int:
        return comp.wire_bytes(self.wire, compression)

    def predict(self, *, cadence: int = 1,
                compression: Optional[CompressionConfig] = None,
                overlap: bool = False) -> dict:
        """Predicted cost row for one candidate tuple.

        One card's slow hop is an in-memory reduction priced at HBM
        bandwidth, so compression never wins on modeled time (one dense
        pass beats ENCODE_PASSES of them plus the compressed wire).
        Across a mesh (``n_chips > 1``) the wire is priced at the NIC's
        rate, where fewer bytes are a real saving.  The port's overlap
        runs its merge and the next round's steps in order on one stream
        (blocking collectives), so nothing hides the merge on one card or
        on a mesh: an ``overlap`` candidate is priced as its twin (and
        tagged as itself), and only a measured probe can promote it.
        (JAX's prior lets the overlap hide the merge on a mesh, where XLA
        schedules the collective beside the compute; ROADMAP item 11b.)"""
        encode = 0 if compression is None \
            else self.ENCODE_PASSES * _dense_float_bytes(self.wire)
        row = ra.predict_round(
            self.count, n_chips=self.n_chips, cadence=cadence,
            wire_bytes=self.wire_bytes(compression), overlap=False,
            encode_bytes=encode)
        row["compression"] = compression_tag(compression)
        row["overlap"] = bool(overlap)
        return row

    def prediction(self, *, cadence: int = 1,
                   compression: Optional[CompressionConfig] = None,
                   overlap: bool = False) -> Measurement:
        """The same prediction as :meth:`predict`, spoken as the shared
        ``Measurement`` record (``source="prior"``)."""
        row = self.predict(cadence=cadence, compression=compression,
                           overlap=overlap)
        return Measurement(
            key=("plan", int(cadence), compression_tag(compression),
                 bool(overlap)),
            seconds=row["round_s"], steps=int(cadence), source="prior")

    def table(self, *, cadences: Sequence[int],
              compressions: Sequence[Optional[CompressionConfig]],
              overlaps: Sequence[bool] = (False,)) -> List[dict]:
        """Cost rows for a candidate grid, best (lowest predicted
        us_per_step) first — the table ``merge_state["tuning_trace"]``
        records."""
        rows = [self.predict(cadence=k, compression=c, overlap=o)
                for k in cadences for c in compressions for o in overlaps]
        rows.sort(key=lambda r: r["us_per_step"])
        return rows
