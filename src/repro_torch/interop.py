"""Values carried across from the JAX package.

Each function takes what ``repro`` produced, handed over as numpy
arrays (``np.asarray(jax_array)``), and returns the port's tensors on
``device`` (``None`` means the card).  With them a JAX-trained state
predicts in the port (``Workload.predict``; K-means centroids cross as a
state, a tree with :func:`dtree_from_numpy`), a JAX state resumes
training in the port (``PimGrid.fit(init_state=...)``), and a JAX
resident placement feeds the port's step functions.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lut import LutTable
from repro_torch.core.mlalgos.dtree import DTree
from repro_torch.core.quantize import Quantized
from repro_torch.device import resolve_device


def state_from_numpy(w, device=None) -> torch.Tensor:
    """A trained state vector (``FitResult.state``) as float32.  Every
    function here copies, so the tensors own their memory."""
    return torch.tensor(np.asarray(w, dtype=np.float32),
                        device=resolve_device(device))


def lut_from_numpy(table, x_min: float, x_max: float,
                   device=None) -> LutTable:
    """A ``repro.core.lut.LutTable`` (``table, x_min, x_max``)."""
    return LutTable(torch.tensor(np.asarray(table, dtype=np.float32),
                                 device=resolve_device(device)),
                    float(x_min), float(x_max))


def quantized_from_numpy(values, scale, device=None) -> Quantized:
    """A ``repro.core.quantize.Quantized`` dataset (integer values and
    their float32 scales), dtypes kept."""
    dev = resolve_device(device)
    return Quantized(torch.tensor(np.asarray(values), device=dev),
                     torch.tensor(np.asarray(scale, dtype=np.float32),
                                  device=dev))


def resident_from_numpy(data: dict, device=None) -> dict:
    """A resident placement (``PimGrid.shard_rows``' data dict:
    ``X``, ``w``, ``y0``... with a leading ``n_vdpus`` dim), dtypes
    kept."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v), device=dev)
            for k, v in data.items()}


def dtree_from_numpy(feature, threshold, leaf_value, bin_edges,
                     max_depth: int, n_classes: int, device=None) -> DTree:
    """A ``repro.core.mlalgos.dtree.DTree``: int32 node arrays and
    float32 bin edges."""
    dev = resolve_device(device)

    def as_int(a):
        return torch.tensor(np.asarray(a, dtype=np.int32), device=dev)

    return DTree(feature=as_int(feature), threshold=as_int(threshold),
                 leaf_value=as_int(leaf_value),
                 bin_edges=torch.tensor(np.asarray(bin_edges,
                                                   dtype=np.float32),
                                        device=dev),
                 max_depth=int(max_depth), n_classes=int(n_classes))
