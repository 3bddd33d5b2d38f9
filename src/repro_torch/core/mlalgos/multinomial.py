"""Multinomial (softmax) logistic regression on the PIM grid.

Port of ``repro.core.mlalgos.multinomial``: the C-class generalisation of
logistic regression.  Each vDPU computes the partial gradient
``G_p = X_pᵀ(softmax(X_p W) − onehot(y_p))`` over its resident rows;
the host merges and steps.  The state is the ``(d, C)`` weight matrix,
``(L, d, C)`` inside a cadence-k round.

``softmax="lut"`` evaluates exp through the one-sided table
``lut.exp_lut`` on the ``lut_activation`` kernel, once a step on the
``(L, R, C)`` shifted logits ``z − max(z) <= 0``.  The fixed-point paths
run both dots on ``fxp_matmul`` through ``dispatch.hybrid_matmul`` at
N = C: the per-feature data scale is folded into the weight matrix,
which is quantized to 16 bits with one scale for a shared ``W`` and one
per lane for lane-batched ``W``, and the residual with one scale per
lane, as the JAX local step does under vmap.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np
import torch

from repro_torch.core import lut as lut_mod
from repro_torch.core import quantize as qz
from repro_torch.core.mlalgos import api
from repro_torch.core.mlalgos.linreg import (BITS, as_f32, host_f32,
                                             rowdot, stream_scale)
from repro_torch.core.pim import PimGrid
from repro_torch.kernels import dispatch

Precision = Literal["fp32", "int16", "int8"]
Softmax = Literal["exact", "lut"]


@dataclasses.dataclass
class MultinomialResult:
    W: torch.Tensor           # (d, n_classes)
    history: list             # per-step {"loss": mean cross-entropy}
    precision: str
    softmax: str


def make_softmax(kind: Softmax, n_entries: int = 1024, device="cpu"):
    """Softmax over the last dim; ``lut`` takes exp from the one-sided
    table on the ``lut_activation`` kernel."""
    if kind == "exact":
        return lambda z: torch.softmax(z, dim=-1)
    if kind == "lut":
        table = lut_mod.exp_lut(n_entries=n_entries, device=device)

        def lut_softmax(z):
            e = dispatch.lut_apply(table, z - z.amax(dim=-1, keepdim=True))
            return e / e.sum(dim=-1, keepdim=True)

        return lut_softmax
    raise ValueError(kind)


def matmul(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``X @ W`` in full float32 (no TF32 on the card)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.matmul(X, W)


def quantize_lanes(x: torch.Tensor) -> qz.Quantized:
    """16 bits with one scale per ``(rows, cols)`` matrix: one for a
    ``(d, C)`` matrix, one per lane for ``(L, d, C)``."""
    return qz.quantize_symmetric(x, bits=16,
                                 axis=None if x.dim() == 2 else (-2, -1))


def int_logits(Xi: torch.Tensor, W: torch.Tensor,
               x_scale: torch.Tensor) -> torch.Tensor:
    """``X @ W`` on the ``fxp_matmul`` kernel: the per-feature data
    scale folded into ``W`` (``Z_rc = Σ_k Xq_rk · s_k · W_kc``), which is
    quantized to 16 bits."""
    Wq = quantize_lanes(W * x_scale[0][:, None])
    return dispatch.hybrid_matmul(Xi, Wq.values) * Wq.scale


def one_hot(y: torch.Tensor, n_classes: int) -> torch.Tensor:
    """float32 one-hot rows; a label outside [0, C) gives a zero row, as
    ``jax.nn.one_hot`` does."""
    return (y.long()[..., None]
            == torch.arange(n_classes, device=y.device)).float()


@dataclasses.dataclass(frozen=True)
class MultinomialLogReg(api.Workload):
    """C-class softmax regression; state = the ``(d, C)`` weights."""

    n_classes: int = 4
    lr: float = 0.5
    precision: Precision = "fp32"
    softmax: Softmax = "exact"
    lut_entries: int = 1024
    l2: float = 0.0

    name = "multinomial"

    def prepare(self, grid: PimGrid, X, y=None):
        X = as_f32(X, grid.device)
        yi = torch.as_tensor(y, device=grid.device).to(torch.int32)
        consts = {"d": X.shape[1], "device": grid.device,
                  "sm": make_softmax(self.softmax, self.lut_entries,
                                     grid.device)}
        if self.precision == "fp32":
            data, n = grid.shard_rows(X, yi)
        else:
            Xq = qz.quantize_symmetric(X, bits=BITS[self.precision], axis=0)
            data, n = grid.shard_rows(Xq.values, yi)
            consts["x_scale"] = Xq.scale
        consts["n"] = n
        return data, n, consts

    def spec_consts(self, device) -> dict:
        return {"sm": make_softmax(self.softmax, self.lut_entries, device)}

    def stream_consts(self, stream, grid: PimGrid):
        consts = {"n": stream.n_rows, "d": stream.n_features,
                  "device": grid.device,
                  "sm": make_softmax(self.softmax, self.lut_entries,
                                     grid.device)}
        if self.precision != "fp32":
            consts["x_scale"], consts["x_scale_host"] = stream_scale(
                stream.feature_absmax(), BITS[self.precision], grid.device)
        return consts

    def stream_transform(self, consts, X_rows, y_rows):
        yi = np.asarray(y_rows).astype(np.int32)     # prepare's cast
        if self.precision == "fp32":
            return host_f32(X_rows), yi
        return (qz.quantize_fixed_scale_np(X_rows, consts["x_scale_host"],
                                           BITS[self.precision]), yi)

    def init_state(self, consts):
        return torch.zeros((consts["d"], self.n_classes),
                           dtype=torch.float32, device=consts["device"])

    def local_step(self, consts, W, sl):
        onehot = one_hot(sl["y0"], self.n_classes)
        mask = sl["w"][..., None]
        if self.precision == "fp32":
            Z = matmul(sl["X"], W)                            # (L, R, C)
            R = (consts["sm"](Z) - onehot) * mask
            G = matmul(sl["X"].transpose(-1, -2), R)          # (L, d, C)
        else:
            x_scale = consts["x_scale"]
            Xi = sl["X"]
            Z = int_logits(Xi, W, x_scale)
            R = (consts["sm"](Z) - onehot) * mask
            Rq = quantize_lanes(R)
            Gacc = dispatch.hybrid_matmul(Xi.transpose(-1, -2), Rq.values)
            G = Gacc * (x_scale[0][:, None] * Rq.scale)
        # cross-entropy with the exact log-softmax, for reporting
        logp = torch.log_softmax(Z, dim=-1)
        loss = -(sl["w"] * (onehot * logp).sum(-1)).sum(-1)
        return {"g": G, "loss": loss}

    def update(self, consts, W, merged):
        n = consts["n"]
        G = qz.div_scalar(merged["g"], n) + self.l2 * W
        return W - self.lr * G, {"loss": qz.div_scalar(merged["loss"], n)}

    def eval(self, state, X, y=None) -> dict:
        out = {}
        if y is not None:
            out["accuracy"] = multinomial_accuracy(state, X, y)
        return out

    def predict(self, state, X):
        """Class probabilities ``(n, C)`` through the configured softmax;
        quantized logits run ``local_step``'s integer product on
        ``fxp_matmul`` with the request's own per-feature scales; fp32
        logits are :func:`~repro_torch.core.mlalgos.linreg.rowdot`'s, one
        row and class at a time (pad-invariant)."""
        X = as_f32(X, state.device)
        sm = make_softmax(self.softmax, self.lut_entries, state.device)
        if self.precision == "fp32":
            return sm(rowdot(X.unsqueeze(-2), state.transpose(0, 1)))
        Xq = qz.quantize_symmetric(X, bits=BITS[self.precision], axis=0)
        return sm(int_logits(Xq.values, state, Xq.scale))


def train_multinomial(grid: PimGrid, X, y, *, n_classes: int,
                      lr: float = 0.5, steps: int = 100,
                      precision: Precision = "fp32",
                      softmax: Softmax = "exact", lut_entries: int = 1024,
                      l2: float = 0.0, engine: str = "scan",
                      merge_every: int = 1, merge_plan=None,
                      merge_state: Optional[dict] = None,
                      batch_size: Optional[int] = None,
                      sample_seed: int = 0) -> MultinomialResult:
    """``api.fit`` of a :class:`MultinomialLogReg`."""
    res = api.fit(
        MultinomialLogReg(n_classes=n_classes, lr=lr, precision=precision,
                          softmax=softmax, lut_entries=lut_entries, l2=l2),
        grid, X, y, steps=steps, engine=engine, merge_every=merge_every,
        merge_plan=merge_plan, merge_state=merge_state,
        batch_size=batch_size, sample_seed=sample_seed)
    return MultinomialResult(W=res.state, history=res.history,
                             precision=precision, softmax=softmax)


def multinomial_predict(W: torch.Tensor, X) -> torch.Tensor:
    """Class probabilities ``(n, C)`` with the exact softmax."""
    return torch.softmax(matmul(as_f32(X, W.device), W), dim=-1)


def multinomial_accuracy(W: torch.Tensor, X, y) -> float:
    pred = torch.argmax(matmul(as_f32(X, W.device), W), dim=-1)
    y = torch.as_tensor(y, device=W.device)
    return float((pred == y).float().mean())
