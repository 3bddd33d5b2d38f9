"""Linear SVM (hinge loss) by subgradient descent on the PIM grid.

Port of ``repro.core.mlalgos.svm``, the second workload PIM-Opt
(arXiv 2404.07164) trains on real UPMEM hardware: logistic regression's
data flow with the hinge loss.  Per resident row, labels mapped to ±1:

    margin m = y·(x·w),  hinge = max(0, 1 − m)
    subgradient g = −y·x where m < 1, else 0   (+ L2 in ``update``)

The fixed-point paths reuse linear regression's integer dots
(``quantize_weight``, ``int_forward``, ``int_gradient``): the resident
dataset is quantized once per feature, and the forward and gradient
dots run on the ``fxp_matmul`` kernel, two launches a step at N = 1.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np
import torch

from repro_torch.core import quantize as qz
from repro_torch.core.mlalgos import api
from repro_torch.core.mlalgos.linreg import (BITS, as_f32, host_f32,
                                             int_forward, int_gradient,
                                             matvec, quantize_weight,
                                             rmatvec, rowdot, stream_scale)
from repro_torch.core.pim import PimGrid

Precision = Literal["fp32", "int16", "int8"]


@dataclasses.dataclass
class SVMResult:
    w: torch.Tensor
    history: list             # per-step {"loss": mean hinge + L2 term}
    precision: str


def pm1(y, device) -> torch.Tensor:
    """Labels as float32 ±1: positive values are +1, the rest −1."""
    y = torch.as_tensor(y, device=device)
    return torch.where(y > 0, 1.0, -1.0).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class LinearSVM(api.Workload):
    """Hinge-loss linear SVM; labels may arrive as {0, 1} or ±1."""

    lr: float = 0.1
    l2: float = 1e-3          # the SVM regularizer (C = 1/(l2·n))
    precision: Precision = "fp32"

    name = "svm"

    def prepare(self, grid: PimGrid, X, y=None):
        X, ys = as_f32(X, grid.device), pm1(y, grid.device)
        consts = {"d": X.shape[1], "device": grid.device}
        if self.precision == "fp32":
            data, n = grid.shard_rows(X, ys)
        else:
            Xq = qz.quantize_symmetric(X, bits=BITS[self.precision], axis=0)
            data, n = grid.shard_rows(Xq.values, ys)
            consts["x_scale"] = Xq.scale
        consts["n"] = n
        return data, n, consts

    def spec_consts(self, device) -> dict:
        return {}

    def stream_consts(self, stream, grid: PimGrid):
        consts = {"n": stream.n_rows, "d": stream.n_features,
                  "device": grid.device}
        if self.precision != "fp32":
            consts["x_scale"], consts["x_scale_host"] = stream_scale(
                stream.feature_absmax(), BITS[self.precision], grid.device)
        return consts

    def stream_transform(self, consts, X_rows, y_rows):
        # the ±1 labels of pm1, a window at a time
        ys = np.where(np.asarray(y_rows) > 0, 1.0, -1.0).astype(np.float32)
        if self.precision == "fp32":
            return host_f32(X_rows), ys
        return (qz.quantize_fixed_scale_np(X_rows, consts["x_scale_host"],
                                           BITS[self.precision]), ys)

    def init_state(self, consts):
        return torch.zeros((consts["d"],), dtype=torch.float32,
                           device=consts["device"])

    def local_step(self, consts, w, sl):
        ys, mask = sl["y0"], sl["w"]
        if self.precision == "fp32":
            z = matvec(sl["X"], w)
            active = (ys * z < 1.0).float() * mask
            g = rmatvec(sl["X"], -(ys * active))
        else:
            x_scale = consts["x_scale"]
            z = int_forward(sl["X"], quantize_weight(w, x_scale))
            active = (ys * z < 1.0).float() * mask
            g = int_gradient(sl["X"], -(ys * active), x_scale)
        hinge = torch.clamp(1.0 - ys * z, min=0.0) * mask
        return {"g": g, "loss": hinge.sum(-1)}

    def update(self, consts, w, merged):
        n = consts["n"]
        g = qz.div_scalar(merged["g"], n) + self.l2 * w
        loss = qz.div_scalar(merged["loss"], n) \
            + 0.5 * self.l2 * (w * w).sum(-1)
        return w - self.lr * g, {"loss": loss}

    def eval(self, state, X, y=None) -> dict:
        out = {}
        if y is not None:
            out["accuracy"] = svm_accuracy(state, X, y)
        return out

    def predict(self, state, X):
        """Decision values (sign = class); quantized margins run
        ``local_step``'s integer forward on ``fxp_matmul`` with the
        request's own per-feature scales; fp32 margins are
        :func:`~repro_torch.core.mlalgos.linreg.rowdot`'s (pad-invariant)."""
        X = as_f32(X, state.device)
        if self.precision == "fp32":
            return rowdot(X, state)
        Xq = qz.quantize_symmetric(X, bits=BITS[self.precision], axis=0)
        return int_forward(Xq.values, quantize_weight(state, Xq.scale))


def train_svm(grid: PimGrid, X, y, *, lr: float = 0.1, steps: int = 100,
              l2: float = 1e-3, precision: Precision = "fp32",
              engine: str = "scan", merge_every: int = 1, merge_plan=None,
              merge_state: Optional[dict] = None,
              batch_size: Optional[int] = None,
              sample_seed: int = 0) -> SVMResult:
    """``api.fit`` of a :class:`LinearSVM`: cadence, merge plans and
    minibatching as for every gradient workload (PIM-Opt trains the SVM
    as minibatch SGD with a local update cadence)."""
    res = api.fit(LinearSVM(lr=lr, l2=l2, precision=precision), grid, X, y,
                  steps=steps, engine=engine, merge_every=merge_every,
                  merge_plan=merge_plan, merge_state=merge_state,
                  batch_size=batch_size, sample_seed=sample_seed)
    return SVMResult(w=res.state, history=res.history, precision=precision)


def svm_predict(w: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Decision values (sign = class), in full float32."""
    return matvec(X, w)


def svm_accuracy(w: torch.Tensor, X, y) -> float:
    """Accuracy against {0, 1} or ±1 labels."""
    X = as_f32(X, w.device)
    return float((torch.sign(svm_predict(w, X)) == pm1(y, w.device)
                  ).float().mean())
