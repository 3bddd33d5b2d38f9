"""The round count and the per-round prediction behind the plan
controller's cost model (``tuning.cost.CostModel``).

Port of the two pieces of ``repro.roofline.analysis`` that the cost
model uses:

* :class:`RoundCounter` takes the place of ``analyze_hlo``.  The port
  runs eagerly, so there is no lowered program to parse: the round runs
  once under a ``TorchDispatchMode`` that charges every aten op its
  operand reads plus its output write (``analyze_hlo``'s ``_traffic``),
  lets views and metadata ops through free (its ``_FREE``), and charges
  each matrix product 2·M·N·K operations of its operands' type.  The
  port's CUDA kernels are called through ``ctypes`` and never reach the
  dispatcher, so each wrapper charges its own launch (:func:`charge`) as
  ``PERF.md``'s bound column counts it: each input read once, each
  output written once.  On the CPU the wrappers run their plain
  versions, which are aten ops the mode counts.  The count reads no
  clock: it is a prior, not a timing.
* :func:`predict_round`, the JAX package's formula term for term, with
  the card's constants as arguments (defaults from :mod:`.hw`).

On a mesh the round's collectives (``distributed.collectives``) pass the
dispatcher as ``c10d`` ops, which the mode lets through uncharged: the
collectives charge their own link traffic (:func:`charge_link`), the
fast axes' bytes into ``RoundCount.ici_bytes``.  The slow hop charges
nothing, because :func:`predict_round` prices it from the candidate's
wire bytes (as the JAX package takes the larger of the two, never
both).

Example — a float32 product (2·4·8·2 operations; a and b read, 192
bytes, the product written, 32) and an add (the product read and the
sum written, 64 bytes), counted:

>>> import torch
>>> a, b = torch.ones(4, 8), torch.ones(8, 2)
>>> with RoundCounter() as counter:
...     c = (a @ b) + 1.0
>>> counter.count.ops, counter.count.bytes
({'fp32': 128.0}, 288.0)
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.roofline import hw

# ops that move no bytes themselves: fresh uninitialised storage, and a
# view whose schema does not say so (``_unsafe_view``); every other op
# whose outputs alias an input unwritten is a view too
_FREE = frozenset({"_unsafe_view", "empty", "empty_like", "empty_strided",
                   "new_empty", "new_empty_strided"})
# matrix products: the positions of the two operands
_DOTS = {"mm": (0, 1), "bmm": (0, 1), "_int_mm": (0, 1), "mv": (0, 1),
         "dot": (0, 1), "vdot": (0, 1), "addmm": (1, 2),
         "baddbmm": (1, 2), "addmv": (1, 2)}
# counters that kernel wrappers charge (innermost last)
_ACTIVE: list = []


@dataclasses.dataclass
class RoundCount:
    """Operations by kind (the keys of ``hw.PEAK_OPS``), HBM bytes and
    the bytes a participant moves over the fast links (``ici_bytes``)
    of one round."""

    ops: dict = dataclasses.field(default_factory=dict)
    bytes: float = 0.0
    ici_bytes: float = 0.0

    def add(self, n_bytes: float, ops: float = 0.0,
            kind: str = "fp32") -> None:
        self.bytes += float(n_bytes)
        if ops:
            self.ops[kind] = self.ops.get(kind, 0.0) + float(ops)


def op_kind(dtype: torch.dtype) -> str:
    """The peak a product of ``dtype`` operands runs at."""
    if dtype in (torch.int8, torch.uint8):
        return "int8"
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    return "fp32"


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements of a tensor: an expanded (stride 0)
    dimension is read once."""
    if t.numel() == 0:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def nbytes(*ts: torch.Tensor) -> int:
    """Bytes of the tensors, each element once (a kernel launch's inputs
    read once and outputs written once)."""
    return sum(map(tensor_bytes, ts))


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class RoundCounter(TorchDispatchMode):
    """Count the work of the code run inside ``with RoundCounter() as c``
    into ``c.count`` (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.count = RoundCount()

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name in _FREE or func.namespace == "c10d" or _is_view(func):
            return out
        reads = _tensors((args, {k: v for k, v in kwargs.items()
                                 if k != "out"}))
        moved = nbytes(*reads, *_tensors(out))
        ops, kind = 0.0, "fp32"
        if name in _DOTS:
            i, j = _DOTS[name]
            a, b = args[i], args[j]
            # a (..., M, K) by b (..., K, N), or a vector b
            ops = 2.0 * a.numel() * (b.shape[-1] if b.dim() >= 2 else 1)
            kind = op_kind(a.dtype)
        self.count.add(moved, ops, kind)
        return out


def charge(n_bytes: float, ops: float = 0.0, kind: str = "fp32") -> None:
    """Charge one kernel launch to every active :class:`RoundCounter`
    (kernel wrappers call this where they count a launch)."""
    for counter in _ACTIVE:
        counter.count.add(n_bytes, ops, kind)


def charge_link(n_bytes: float) -> None:
    """Charge a fast-axis collective's traffic (the bytes one
    participant receives) to every active :class:`RoundCounter`."""
    for counter in _ACTIVE:
        counter.count.ici_bytes += float(n_bytes)


def predict_round(count: RoundCount, *, n_chips: int = 1, cadence: int = 1,
                  wire_bytes: float = 0.0, overlap: bool = False,
                  baseline_cadence: int = 1, encode_bytes: float = 0.0,
                  ici_s: float | None = None, dcn_s: float = 0.0,
                  hbm_bw: float = hw.HBM_BW, peak_ops: dict = hw.PEAK_OPS,
                  wire_bw: float | None = None) -> dict:
    """Per-round time of a candidate merge plan, from the count of ONE
    round at ``baseline_cadence`` (normally 1), as
    ``repro.roofline.analysis.predict_round`` decomposes it:

    * ``t_local_s`` — a local step's bound, ``max(compute, memory) /
      baseline_cadence``: compute is each kind's operations over its
      peak, memory the bytes over ``hbm_bw``;
    * ``t_merge_s`` — ``ici_s + encode_bytes / hbm_bw + max(dcn_s,
      wire_bytes / wire_bw)``: the fast hop's collectives (by default
      ``count.ici_bytes`` over NVLink's rate), the compressed wire's
      encode passes and the slow hop.  ``wire_bw=None`` prices the slow
      hop at the NIC's rate when ``n_chips > 1`` and at ``hbm_bw`` on
      one card, whose hop is an in-memory reduction;
    * a round costs ``cadence · t_local + t_merge``; with ``overlap``
      only the merge time ``cadence`` local steps cannot hide.

    Returns those terms with ``round_s`` and ``us_per_step`` (the
    ranking key).
    """
    compute_s = sum(n / peak_ops[kind] for kind, n in count.ops.items())
    memory_s = count.bytes / hbm_bw
    base = max(int(baseline_cadence), 1)
    t_local = max(compute_s, memory_s) / base
    t_encode = float(encode_bytes) / hbm_bw
    if ici_s is None:
        ici_s = count.ici_bytes / hw.NVLINK_BW
    if wire_bw is None:
        wire_bw = hw.NIC_BW_PER_GPU if n_chips > 1 else hbm_bw
    bw = float(wire_bw)
    t_merge = ici_s + t_encode + max(dcn_s, float(wire_bytes) / bw)
    k = max(int(cadence), 1)
    exposed = max(0.0, t_merge - k * t_local) if overlap else t_merge
    round_s = k * t_local + exposed
    return {
        "cadence": k,
        "overlap": bool(overlap),
        "wire_bytes": float(wire_bytes),
        "t_local_s": float(t_local),
        "t_merge_s": float(t_merge),
        "exposed_merge_s": float(exposed),
        "round_s": float(round_s),
        "us_per_step": float(round_s / k * 1e6),
    }
