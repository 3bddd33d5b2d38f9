"""Logistic regression by gradient descent on the PIM grid.

Port of ``repro.core.mlalgos.logreg``: linear regression's data flow
plus the sigmoid, which the paper evaluates three ways (insight I2):

  * ``exact``      — ``torch.sigmoid`` (the reference),
  * ``lut``        — nearest-entry LUT on the ``lut_activation`` kernel
                     (the paper's winning variant); ``lut_interp``
                     interpolates between entries,
  * ``taylor``     — the truncated series (the paper's losing baseline).
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import torch

from repro_torch.core import lut as lut_mod
from repro_torch.core import quantize as qz
from repro_torch.core.mlalgos import api
from repro_torch.core.mlalgos.linreg import (BITS, as_f32, host_f32,
                                             int_forward, int_gradient,
                                             matvec, quantize_weight,
                                             rmatvec, rowdot, stream_scale)
from repro_torch.core.pim import PimGrid
from repro_torch.kernels import dispatch

Sigmoid = Literal["exact", "lut", "lut_interp", "taylor"]
Precision = Literal["fp32", "int16", "int8"]


@dataclasses.dataclass
class LogRegResult:
    w: torch.Tensor
    history: list             # per-step {"loss": mean BCE}
    precision: str
    sigmoid: str


def make_sigmoid(kind: Sigmoid, n_entries: int = 1024, device="cpu"):
    if kind == "exact":
        return torch.sigmoid
    if kind == "taylor":
        return lut_mod.taylor_sigmoid
    table = lut_mod.sigmoid_lut(n_entries=n_entries, device=device)
    if kind == "lut":
        return lambda x: dispatch.lut_apply(table, x)
    if kind == "lut_interp":
        return lambda x: lut_mod.lut_lookup_interp(table, x)
    raise ValueError(kind)


@dataclasses.dataclass(frozen=True)
class LogReg(api.Workload):
    """GD binary logistic regression (LUT sigmoid variants, hybrid fixed
    point)."""

    lr: float = 0.5
    precision: Precision = "fp32"
    sigmoid: Sigmoid = "exact"
    lut_entries: int = 1024
    l2: float = 0.0

    name = "logreg"

    def prepare(self, grid: PimGrid, X, y=None):
        X, y = as_f32(X, grid.device), as_f32(y, grid.device)
        consts = {"d": X.shape[1], "device": grid.device,
                  "sig": make_sigmoid(self.sigmoid, self.lut_entries,
                                      grid.device)}
        if self.precision == "fp32":
            data, n = grid.shard_rows(X, y)
        else:
            Xq = qz.quantize_symmetric(X, bits=BITS[self.precision], axis=0)
            data, n = grid.shard_rows(Xq.values, y)
            consts["x_scale"] = Xq.scale
        consts["n"] = n
        return data, n, consts

    def spec_consts(self, device) -> dict:
        return {"sig": make_sigmoid(self.sigmoid, self.lut_entries, device)}

    def stream_consts(self, stream, grid: PimGrid):
        consts = {"n": stream.n_rows, "d": stream.n_features,
                  "device": grid.device,
                  "sig": make_sigmoid(self.sigmoid, self.lut_entries,
                                      grid.device)}
        if self.precision != "fp32":
            consts["x_scale"], consts["x_scale_host"] = stream_scale(
                stream.feature_absmax(), BITS[self.precision], grid.device)
        return consts

    def stream_transform(self, consts, X_rows, y_rows):
        if self.precision == "fp32":
            return host_f32(X_rows), host_f32(y_rows)
        return (qz.quantize_fixed_scale_np(X_rows, consts["x_scale_host"],
                                           BITS[self.precision]),
                host_f32(y_rows))

    def init_state(self, consts):
        return torch.zeros((consts["d"],), dtype=torch.float32,
                           device=consts["device"])

    def local_step(self, consts, w, sl):
        sig, y0, mask = consts["sig"], sl["y0"], sl["w"]
        if self.precision == "fp32":
            z = matvec(sl["X"], w)
            r = (sig(z) - y0) * mask
            g = rmatvec(sl["X"], r)
        else:
            x_scale = consts["x_scale"]
            z = int_forward(sl["X"], quantize_weight(w, x_scale))
            r = (sig(z) - y0) * mask
            g = int_gradient(sl["X"], r, x_scale)
        # BCE with the exact sigmoid and log, for reporting only
        eps = 1e-7
        pe = torch.clamp(torch.sigmoid(z), eps, 1 - eps)
        loss = -(mask * (y0 * torch.log(pe)
                         + (1 - y0) * torch.log(1 - pe))).sum(-1)
        return {"g": g, "loss": loss}

    def update(self, consts, w, merged):
        n = consts["n"]
        g = qz.div_scalar(merged["g"], n) + self.l2 * w
        return w - self.lr * g, {"loss": qz.div_scalar(merged["loss"], n)}

    def eval(self, state, X, y=None) -> dict:
        out = {}
        if y is not None:
            out["accuracy"] = accuracy(state, X, y)
        return out

    def predict(self, state, X):
        """Probabilities through the configured sigmoid; quantized
        logits run ``local_step``'s integer forward on ``fxp_matmul``
        with the request's own per-feature scales; fp32 logits are
        :func:`~repro_torch.core.mlalgos.linreg.rowdot`'s (pad-invariant)."""
        X = as_f32(X, state.device)
        sig = make_sigmoid(self.sigmoid, self.lut_entries, state.device)
        if self.precision == "fp32":
            return sig(rowdot(X, state))
        Xq = qz.quantize_symmetric(X, bits=BITS[self.precision], axis=0)
        return sig(int_forward(Xq.values, quantize_weight(state, Xq.scale)))


def train_logreg(grid: PimGrid, X, y, *, lr: float = 0.5, steps: int = 100,
                 precision: Precision = "fp32", sigmoid: Sigmoid = "exact",
                 lut_entries: int = 1024, l2: float = 0.0,
                 engine: str = "scan", merge_every: int = 1,
                 merge_plan=None, merge_state: Optional[dict] = None,
                 batch_size: Optional[int] = None,
                 sample_seed: int = 0) -> LogRegResult:
    """``api.fit`` of a :class:`LogReg` (cadence, merge plan and its
    ``merge_state``, minibatching as for every gradient workload)."""
    res = api.fit(
        LogReg(lr=lr, precision=precision, sigmoid=sigmoid,
               lut_entries=lut_entries, l2=l2),
        grid, X, y, steps=steps, engine=engine, merge_every=merge_every,
        merge_plan=merge_plan, merge_state=merge_state,
        batch_size=batch_size, sample_seed=sample_seed)
    return LogRegResult(w=res.state, history=res.history,
                        precision=precision, sigmoid=sigmoid)


def logreg_predict(w: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Probabilities with the exact sigmoid."""
    return torch.sigmoid(matvec(X, w))


def accuracy(w: torch.Tensor, X, y) -> float:
    X, y = as_f32(X, w.device), as_f32(y, w.device)
    pred = (logreg_predict(w, X) > 0.5).float()
    return float((pred == y).float().mean())
