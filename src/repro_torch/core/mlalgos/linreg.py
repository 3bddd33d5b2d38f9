"""Linear regression by batch gradient descent on the PIM grid.

Port of ``repro.core.mlalgos.linreg``.  Each vDPU computes the partial
gradient ``g_p = X_pᵀ(X_p w − y_p)`` over its resident rows; the host
merges the partials and applies the GD step.  Three numeric paths:

  * ``fp32``  — the float reference,
  * ``int16`` / ``int8`` — hybrid-precision fixed point: the resident
    dataset is quantized once (per-feature scales), the dots run in
    integers on the ``fxp_matmul`` kernel with int32 accumulation, and
    only the merged gradient is rescaled to float.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np
import torch

from repro_torch.core import quantize as qz
from repro_torch.core.mlalgos import api
from repro_torch.core.pim import PimGrid
from repro_torch.kernels import dispatch

Precision = Literal["fp32", "int16", "int8"]
BITS = {"int16": 16, "int8": 8}


@dataclasses.dataclass
class LinRegResult:
    w: torch.Tensor
    history: list             # per-step {"loss": ...}
    precision: str


def as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def stream_scale(amax, bits: int, device) -> tuple:
    """``symmetric_scale`` of a host absmax, on ``device`` (as the
    resident path computes it) and its host copy for the numpy
    quantization of the windows: ``(device scale, numpy scale)``."""
    scale = qz.symmetric_scale(torch.as_tensor(amax).to(device), bits)
    return scale, scale.cpu().numpy()


def host_f32(x) -> np.ndarray:
    """Host rows as float32, as ``as_f32`` takes resident ones."""
    return np.asarray(x, np.float32)


def matvec(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``X @ w`` per lane: ``(..., R, d)`` with a shared ``(d,)`` or a
    per-lane ``(L, d)`` weight -> ``(..., R)``, in full float32."""
    # fp32 paths keep full float32 products: TF32 on the card would keep
    # ~10 mantissa bits and leave the JAX reference behind
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.matmul(X, w.unsqueeze(-1)).squeeze(-1)


def rmatvec(X: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``Xᵀ @ r`` per lane: ``(L, R, d)``, ``(L, R)`` -> ``(L, d)``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.matmul(X.transpose(-1, -2), r.unsqueeze(-1)).squeeze(-1)


def rowdot(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``X @ w`` for a request: ``(n, d)`` rows against a ``(d,)`` weight
    -> ``(n,)`` (``(n, 1, d)`` against ``(C, d)`` -> ``(n, C)``), each
    row's sum over the features taken on its own, so a row's result does
    not depend on how many rows the request holds.  A BLAS or cuBLAS
    product picks its blocking by the row count, and then the last bits
    of a row move when a request is padded.  Training keeps
    :func:`matvec`: the product here is materialised, which over the
    resident set would cost a copy of it every step."""
    return (X * w).sum(-1)


def quantize_weight(w: torch.Tensor, x_scale: torch.Tensor) -> qz.Quantized:
    """The weight with the per-feature data scale folded in, quantized to
    16 bits: one scale for a shared ``(d,)`` weight, one per lane for an
    ``(L, d)`` weight."""
    return qz.quantize_symmetric(w * x_scale[0], bits=16,
                                 axis=None if w.dim() == 1 else -1)


def int_forward(Xi: torch.Tensor, wq: qz.Quantized) -> torch.Tensor:
    """``Xi @ w`` on the ``fxp_matmul`` kernel: int8/int16 ``(..., R, d)``
    and a 16-bit weight -> float32 ``(..., R)``."""
    return dispatch.hybrid_matmul(Xi, wq.values.unsqueeze(-1))[..., 0] \
        * wq.scale


def int_gradient(Xi: torch.Tensor, r: torch.Tensor,
                 x_scale: torch.Tensor) -> torch.Tensor:
    """``Xᵀ r`` per lane on the ``fxp_matmul`` kernel: the residual is
    quantized to 16 bits with one scale per lane, and ``Xi``'s
    transposed view goes to the kernel as it is (no copy)."""
    rq = qz.quantize_symmetric(r, bits=16, axis=-1)
    gacc = dispatch.hybrid_matmul(Xi.transpose(-1, -2),
                                  rq.values.unsqueeze(-1))[..., 0]
    return gacc * (x_scale[0] * rq.scale)


@dataclasses.dataclass(frozen=True)
class LinReg(api.Workload):
    """GD linear regression (optionally hybrid fixed point)."""

    lr: float = 0.1
    precision: Precision = "fp32"
    l2: float = 0.0

    name = "linreg"

    def prepare(self, grid: PimGrid, X, y=None):
        X, y = as_f32(X, grid.device), as_f32(y, grid.device)
        d = X.shape[1]
        if self.precision == "fp32":
            data, n = grid.shard_rows(X, y)
            return data, n, {"n": n, "d": d, "device": grid.device}
        Xq = qz.quantize_symmetric(X, bits=BITS[self.precision], axis=0)
        yq = qz.quantize_symmetric(y, bits=16)
        data, n = grid.shard_rows(Xq.values, yq.values)
        return data, n, {"n": n, "d": d, "device": grid.device,
                         "x_scale": Xq.scale, "y_scale": yq.scale}

    def stream_consts(self, stream, grid: PimGrid):
        """``prepare``'s constants from one pass over the host rows: the
        scales of the whole dataset, so every window quantizes on the
        resident grid (``*_host``: their numpy copies, for the
        windows)."""
        consts = {"n": stream.n_rows, "d": stream.n_features,
                  "device": grid.device}
        if self.precision != "fp32":
            consts["x_scale"], consts["x_scale_host"] = stream_scale(
                stream.feature_absmax(), BITS[self.precision], grid.device)
            consts["y_scale"], consts["y_scale_host"] = stream_scale(
                stream.label_absmax(), 16, grid.device)
        return consts

    def stream_transform(self, consts, X_rows, y_rows):
        if self.precision == "fp32":
            return host_f32(X_rows), host_f32(y_rows)
        return (qz.quantize_fixed_scale_np(X_rows, consts["x_scale_host"],
                                           BITS[self.precision]),
                qz.quantize_fixed_scale_np(y_rows, consts["y_scale_host"],
                                           16))

    def init_state(self, consts):
        return torch.zeros((consts["d"],), dtype=torch.float32,
                           device=consts["device"])

    def local_step(self, consts, w, sl):
        if self.precision == "fp32":
            r = (matvec(sl["X"], w) - sl["y0"]) * sl["w"]
            return {"g": rmatvec(sl["X"], r), "loss": (r * r).sum(-1)}
        x_scale = consts["x_scale"]
        pred = int_forward(sl["X"], quantize_weight(w, x_scale))
        yf = sl["y0"].float() * consts["y_scale"]
        r = (pred - yf) * sl["w"]
        return {"g": int_gradient(sl["X"], r, x_scale),
                "loss": (r * r).sum(-1)}

    def update(self, consts, w, merged):
        n = consts["n"]
        g = qz.div_scalar(merged["g"], n) + self.l2 * w
        return w - self.lr * g, {"loss": qz.div_scalar(merged["loss"], n)}

    def eval(self, state, X, y=None) -> dict:
        out = {}
        if y is not None:
            X, y = as_f32(X, state.device), as_f32(y, state.device)
            out["mse"] = float(((linreg_predict(state, X) - y) ** 2).mean())
        return out

    def predict(self, state, X):
        """fp32: ``X @ w`` row by row (:func:`rowdot`).  Quantized:
        ``local_step``'s forward recipe on the request's own per-feature
        scales.  Pad-invariant: zero rows never move an absmax, nor
        another row's sum."""
        X = as_f32(X, state.device)
        if self.precision == "fp32":
            return rowdot(X, state)
        Xq = qz.quantize_symmetric(X, bits=BITS[self.precision], axis=0)
        return int_forward(Xq.values, quantize_weight(state, Xq.scale))


def make_linreg_step(grid: PimGrid, X, y, *, lr: float = 0.1,
                     precision: Precision = "fp32", l2: float = 0.0):
    """The bound :class:`LinReg` program's pieces for ``grid.fit``:
    ``(data, n, local_fn, update_fn, w0)``."""
    program = LinReg(lr=lr, precision=precision, l2=l2).bind(grid, X, y)
    return (program.data, program.n, program.local_fn,
            program.update_fn, program.state0)


def train_linreg(grid: PimGrid, X, y, *, lr: float = 0.1, steps: int = 100,
                 precision: Precision = "fp32", l2: float = 0.0,
                 engine: str = "scan", merge_every: int = 1,
                 merge_plan=None, merge_state: Optional[dict] = None,
                 batch_size: Optional[int] = None,
                 sample_seed: int = 0) -> LinRegResult:
    """``api.fit`` of a :class:`LinReg`: ``merge_every=k`` runs k
    vDPU-local GD steps between merges, ``merge_plan`` composes the
    cadence with an outer optimizer (``distributed.merge_plan``), and
    ``merge_state`` carries its momentum across calls."""
    res = api.fit(LinReg(lr=lr, precision=precision, l2=l2), grid, X, y,
                  steps=steps, engine=engine, merge_every=merge_every,
                  merge_plan=merge_plan, merge_state=merge_state,
                  batch_size=batch_size, sample_seed=sample_seed)
    return LinRegResult(w=res.state, history=res.history,
                        precision=precision)


def linreg_predict(w: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return matvec(X, w)


def closed_form(X, y, l2: float = 0.0) -> torch.Tensor:
    """The normal-equation solution (a test oracle), in float32."""
    X, y = torch.as_tensor(X).float(), torch.as_tensor(y).float()
    d = X.shape[1]
    A = X.T @ X + l2 * X.shape[0] * torch.eye(d, device=X.device)
    return torch.linalg.solve(A, X.T @ y)
