"""K-means clustering (Lloyd's algorithm) on the PIM grid.

Port of ``repro.core.mlalgos.kmeans`` (paper workload #4).  Per
iteration each vDPU streams its resident rows, assigns each to the
nearest centroid and accumulates per-cluster partial sums and counts;
the host merges the partials and recomputes the centroids.  The fused
distance → argmin → accumulate runs on the ``kmeans_assign`` kernel
through ``dispatch.kmeans_partials``, one launch per iteration for every
lane.

Fixed point (insight I1): at int16/int8 the resident copy is integer
with per-feature scales, and the kernel dequantizes each row in
registers, so no float copy of the dataset is made per iteration (the
JAX path materialises ``X.astype(f32) * x_scale`` before its kernel).

The initial centroids are ``k`` distinct rows drawn with
``torch.randperm`` from ``seed``; they are not ``jax.random.choice``'s,
so parity tests set a bound program's ``state0`` to the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core import quantize as qz
from repro_torch.core.mlalgos import api
from repro_torch.core.mlalgos.linreg import (BITS, as_f32, host_f32,
                                             stream_scale)
from repro_torch.core.pim import PimGrid
from repro_torch.kernels import dispatch

Precision = Literal["fp32", "int16", "int8"]


@dataclasses.dataclass
class KMeansResult:
    centroids: torch.Tensor   # (k, d)
    history: list             # per-iteration {"sse": ..., "moved": ...}
    precision: str


@dataclasses.dataclass(frozen=True)
class KMeans(api.Workload):
    """Lloyd's algorithm; state = the ``(k, d)`` centroid matrix (one per
    lane, ``(L, k, d)``, inside a cadence-k round)."""

    k: int = 8
    precision: Precision = "fp32"
    seed: int = 0

    name = "kmeans"

    def init_rows(self, n: int, device) -> torch.Tensor:
        """The rows of the initial centroids: ``k`` distinct of ``n``,
        drawn on ``device`` with one seeded generator, so every rank of a
        mesh, and a stream of the same rows, starts from the same ones."""
        gen = torch.Generator(device=device).manual_seed(self.seed)
        return torch.randperm(n, generator=gen, device=device)[:self.k]

    def prepare(self, grid: PimGrid, X, y=None):
        X = as_f32(X, grid.device)
        consts = {"_c0": X[self.init_rows(X.shape[0], grid.device)]}
        if self.precision == "fp32":
            data, n = grid.shard_rows(X)
        else:
            Xq = qz.quantize_symmetric(X, bits=BITS[self.precision], axis=0)
            data, n = grid.shard_rows(Xq.values)
            consts["x_scale"] = Xq.scale                   # (1, d)
        consts["n"] = n
        return data, n, consts

    def stream_consts(self, stream, grid: PimGrid):
        # prepare's draw, on the grid's device, read from the host rows
        init = self.init_rows(stream.n_rows, grid.device).cpu().numpy()
        consts = {"n": stream.n_rows,
                  "_c0": as_f32(host_f32(stream.rows(init)), grid.device)}
        if self.precision != "fp32":
            consts["x_scale"], consts["x_scale_host"] = stream_scale(
                stream.feature_absmax(), BITS[self.precision], grid.device)
        return consts

    def stream_transform(self, consts, X_rows, y_rows):
        if self.precision == "fp32":
            return (host_f32(X_rows),)
        return (qz.quantize_fixed_scale_np(X_rows, consts["x_scale_host"],
                                           BITS[self.precision]),)

    def init_state(self, consts):
        return consts["_c0"]

    def local_step(self, consts, centroids, sl):
        sums, counts, sse = dispatch.kmeans_partials(
            sl["X"], centroids, sl["w"], consts.get("x_scale"))
        return {"sums": sums, "counts": counts, "sse": sse}

    def update(self, consts, centroids, merged):
        counts = merged["counts"][..., None]
        new_c = merged["sums"] / torch.clamp(counts, min=1.0)
        # empty clusters keep their previous centroid (the paper's policy)
        new_c = torch.where(counts > 0, new_c, centroids)
        moved = torch.amax(torch.abs(new_c - centroids), dim=(-2, -1))
        return new_c, {"sse": merged["sse"], "moved": moved}

    def eval(self, state, X, y=None) -> dict:
        X = as_f32(X, state.device)
        assign = kmeans_assign_points(state, X)
        return {"sse": float(((X - state[assign]) ** 2).sum())}

    def predict(self, state, X):
        """Nearest centroid of each request row; quantized configurations
        quantize the request on its own per-feature grid and dequantize
        it first, as ``local_step`` sees the resident rows."""
        X = as_f32(X, state.device)
        if self.precision != "fp32":
            Xq = qz.quantize_symmetric(X, bits=BITS[self.precision], axis=0)
            X = Xq.values.float() * Xq.scale
        return dispatch.nearest_centroid(X, state)


def train_kmeans(grid: PimGrid, X, k: int, *, iters: int = 20,
                 precision: Precision = "fp32", seed: int = 0,
                 engine: str = "scan", merge_every: int = 1,
                 merge_plan=None,
                 merge_state: dict | None = None) -> KMeansResult:
    """``merge_every=m`` runs ``m`` vDPU-local Lloyd iterations between
    centroid merges (each vDPU updates its own copy; the merge averages
    the copies); ``m=1`` is the paper's exact merge per iteration.  An
    outer optimizer in ``merge_plan`` commits the centroids' merge delta
    (``merge_state`` carries its momentum)."""
    res = api.fit(KMeans(k=k, precision=precision, seed=seed), grid, X,
                  steps=iters, engine=engine, merge_every=merge_every,
                  merge_plan=merge_plan, merge_state=merge_state)
    return KMeansResult(centroids=res.state, history=res.history,
                        precision=precision)


def kmeans_assign_points(centroids: torch.Tensor, X) -> torch.Tensor:
    """Nearest-centroid assignment (``dispatch.nearest_centroid``)."""
    return dispatch.nearest_centroid(as_f32(X, centroids.device), centroids)
