"""Values carried across from the JAX package.

Each function takes what ``repro`` produced, handed over as numpy
arrays (``np.asarray(jax_array)``), and returns the port's tensors on
``device`` (``None`` means the card).  With them a JAX-trained state
predicts in the port (``Workload.predict``; K-means centroids cross as a
state, a tree with :func:`dtree_from_numpy`), a JAX state resumes
training in the port (``PimGrid.fit(init_state=...)``) and, under an
outer optimizer or a compressed merge, with its momentum
(:func:`momentum_from_numpy`) and error-feedback buffer
(:func:`error_from_numpy`) in ``merge_state``, a JAX resident
placement feeds the port's step functions, and a JAX LM's parameters
serve in the port (:func:`lm_params_from_numpy`,
:func:`encdec_params_from_numpy`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lut import LutTable
from repro_torch.core.mlalgos.dtree import DTree
from repro_torch.core.quantize import Quantized
from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.optim.optimizers import OptState
from repro_torch.tree import tree_map


def state_from_numpy(w, device=None):
    """A trained state (``FitResult.state``: a weight vector, the
    multinomial's ``(d, C)`` matrix, K-means centroids) as float32; a
    tuple, such as a minibatch fit's ``(state, counter)`` carry, as a
    tuple of them.  Every function here copies, so the tensors own their
    memory."""
    if isinstance(w, tuple):
        return tuple(state_from_numpy(s, device) for s in w)
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


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """One array, dtype and bits kept.  bf16 arrives as
    ``ml_dtypes.bfloat16``, which torch refuses: it crosses as its 16-bit
    pattern and is viewed as ``torch.bfloat16`` on the other side."""
    a = np.asarray(a)
    dev = resolve_device(device)
    if a.dtype.name == "bfloat16":
        bits = torch.tensor(np.ascontiguousarray(a).view(np.int16))
        return bits.view(torch.bfloat16).to(dev)
    return torch.tensor(a, device=dev)


def momentum_from_numpy(mom, device=None) -> OptState:
    """A JAX fit's ``merge_state["momentum"]``, an ``OptState(step,
    inner)`` with numpy leaves (``jax.tree.map(np.asarray, ...)``), as the
    port's ``OptState``: a 0-dim int32 step and the same tree of tensors,
    dtypes and bits kept.  Put it in the ``merge_state`` of the fit that
    resumes the JAX fit's state."""
    step, inner = mom
    dev = resolve_device(device)
    return OptState(
        torch.tensor(np.asarray(step, dtype=np.int32), device=dev),
        tree_map(lambda a: tensor_from_numpy(a, dev), inner))


def error_from_numpy(error, device=None):
    """A JAX fit's ``merge_state["error"]``, a tree (dict or tuple) of
    numpy arrays with the leading hop axis (``(1, ...)`` a leaf without a
    mesh, ``(hop, ...)`` from a mesh of ``hop`` pods, gathered by
    ``np.asarray``), as the port's tree of tensors, dtypes and bits kept.
    Put it in the ``merge_state`` of the fit that resumes the JAX fit's
    state under the same compression, on a grid whose slow hop has as
    many participants (every rank of a mesh takes the whole buffer)."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, dev), error)


def _tree_from_numpy(tree, dev, index=None):
    if isinstance(tree, dict):
        return {k: _tree_from_numpy(v, dev, index) for k, v in tree.items()}
    a = np.asarray(tree)
    return tensor_from_numpy(a if index is None else a[index], dev)


def lm_params_from_numpy(params: dict, cfg: ModelConfig,
                         device=None) -> dict:
    """A JAX ``Model.init`` pytree (``repro.models.transformer.init_lm``)
    as the port's parameters, every dtype kept.

    JAX stacks the layers of the pattern's repeating unit: ``params
    ["stack"]["scan"]`` holds one layer dict per layer of the unit, each
    leaf with a leading ``reps`` dim, and ``["tail"]`` the unrolled rest.
    The port's ``"layers"`` list takes them in model order: repeat 0's
    unit, repeat 1's unit, ..., then the tail.  A unit may mix kinds
    (recurrentgemma's ``(rglru, rglru, local_attn)`` x 8 + ``(rglru,
    rglru)``), each layer keeps its own keys, and a float32 leaf of a
    bf16 model (Mamba-2's ``A_log``, ``dt_bias``, ``D``; the RG-LRU's
    ``lambda``, ``b_a``, ``b_i``) stays float32."""
    dev = resolve_device(device)
    unit = list(params["stack"]["scan"])
    reps = np.asarray(unit[0]["norm1"]["scale"]).shape[0]
    layers = [_tree_from_numpy(unit[u], dev, r)
              for r in range(reps) for u in range(len(unit))]
    layers += [_tree_from_numpy(p, dev) for p in params["stack"]["tail"]]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers in the pytree, {cfg.name} "
                         f"has {cfg.n_layers}")
    out = {"embed": tensor_from_numpy(params["embed"], dev),
           "layers": layers,
           "final_norm": _tree_from_numpy(params["final_norm"], dev)}
    if "head" in params:
        out["head"] = tensor_from_numpy(params["head"], dev)
    return out


def _stacked_layers(stacked: dict, dev) -> list:
    """A ``lax.scan`` stack (leaves with a leading layer dim) as one
    layer dict a layer, in order."""
    n = np.asarray(stacked["norm1"]["scale"]).shape[0]
    return [_tree_from_numpy(stacked, dev, i) for i in range(n)]


def encdec_params_from_numpy(params: dict, cfg: ModelConfig,
                             device=None) -> dict:
    """A JAX encoder-decoder's ``Model.init`` pytree
    (``repro.models.encdec.init_encdec``: ``{"encoder": {"scan",
    "final_norm"}, "decoder": {"scan"}, "embed", "pos_emb",
    "final_norm"}``, each ``scan`` a stack of layers along a leading dim)
    as the port's parameters, ``"layers"`` lists in model order, every
    dtype kept."""
    dev = resolve_device(device)
    enc = _stacked_layers(params["encoder"]["scan"], dev)
    dec = _stacked_layers(params["decoder"]["scan"], dev)
    if len(enc) != cfg.encoder.n_layers or len(dec) != cfg.n_layers:
        raise ValueError(f"{len(enc)} encoder and {len(dec)} decoder layers "
                         f"in the pytree, {cfg.name} has "
                         f"{cfg.encoder.n_layers} and {cfg.n_layers}")
    return {"encoder": {"layers": enc, "final_norm": _tree_from_numpy(
                params["encoder"]["final_norm"], dev)},
            "decoder": {"layers": dec},
            "embed": tensor_from_numpy(params["embed"], dev),
            "pos_emb": tensor_from_numpy(params["pos_emb"], dev),
            "final_norm": _tree_from_numpy(params["final_norm"], dev)}
