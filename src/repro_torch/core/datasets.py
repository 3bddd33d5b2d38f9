"""Synthetic training sets (port of ``repro.core.datasets``: regression,
binary classification, K-means blobs and the tree's labelled mixture).

Draws come from an explicit ``torch.Generator`` on the device the data
is made on, so a full-size set never crosses the host.  They do not
reproduce ``jax.random``'s numbers: parity tests hand both packages the
same numpy arrays instead.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def regression(gen: torch.Generator, n: int, d: int, noise: float = 0.1,
               w_scale: float = 1.0
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(X, y, w_true)``: ``X ~ N(0, 1)``, ``y = X w + noise``."""
    dev = gen.device
    X = torch.randn((n, d), generator=gen, device=dev)
    w = torch.randn((d,), generator=gen, device=dev) * w_scale
    y = X @ w + noise * torch.randn((n,), generator=gen, device=dev)
    return X, y, w


def binary_classification(gen: torch.Generator, n: int, d: int,
                          w_scale: float = 2.0
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """``(X, y in {0, 1}, w_true)``: labels drawn from the logistic
    model ``P(y=1) = sigmoid(X w)``."""
    dev = gen.device
    X = torch.randn((n, d), generator=gen, device=dev)
    w = torch.randn((d,), generator=gen, device=dev) * (w_scale
                                                        / math.sqrt(d))
    p = torch.sigmoid(X @ w)
    y = (torch.rand((n,), generator=gen, device=dev) < p).float()
    return X, y, w


def blobs(gen: torch.Generator, n: int, d: int, k: int, spread: float = 0.3,
          box: float = 2.0
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(X, assignment, centers)``: ``k`` gaussian blobs with centres
    uniform in ``[-box, box]^d``."""
    dev = gen.device
    centers = torch.rand((k, d), generator=gen, device=dev) * (2 * box) - box
    assign = torch.randint(0, k, (n,), generator=gen, device=dev)
    X = centers[assign] + spread * torch.randn((n, d), generator=gen,
                                               device=dev)
    return X, assign, centers


def mixture_classification(gen: torch.Generator, n: int, d: int,
                           n_classes: int, clusters_per_class: int = 2,
                           spread: float = 0.5
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(X, y int32)``: a labelled gaussian mixture of
    ``n_classes * clusters_per_class`` components with centres uniform in
    ``[-2, 2]^d``; component ``c`` has label ``c % n_classes``, so a
    depth-limited tree can fit it."""
    dev = gen.device
    k = n_classes * clusters_per_class
    centers = torch.rand((k, d), generator=gen, device=dev) * 4.0 - 2.0
    comp = torch.randint(0, k, (n,), generator=gen, device=dev)
    X = centers[comp] + spread * torch.randn((n, d), generator=gen,
                                             device=dev)
    return X, (comp % n_classes).to(torch.int32)
