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


# ---------------------------------------------------------------------------
# the dry run's count of one rank (launch.dryrun, launch.dryrun_pim)
# ---------------------------------------------------------------------------

# the collectives a rank issues, by the name of their functional op
_COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_coalesced":
                "all-reduce", "all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_to_all_single": "all-to-all", "broadcast": "broadcast",
                "allreduce_": "all-reduce", "allgather_": "all-gather",
                "_allgather_base_": "all-gather",
                "reduce_scatter_": "reduce-scatter",
                "_reduce_scatter_base_": "reduce-scatter",
                "alltoall_base_": "all-to-all", "broadcast_": "broadcast"}


# DTensor's sharding propagator runs each new op pattern once on fake
# tensors of the GLOBAL shapes to learn its output's shape; the counter
# skips what runs inside these methods (the names differ across PyTorch
# versions; each that exists is wrapped)
_PROPAGATORS = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")


class _Propagating:
    """While entered, wraps the propagator's methods so that ``depth``
    counts the calls in flight."""

    def __init__(self):
        self.depth = 0
        self._saved: dict = {}

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        for name in _PROPAGATORS:
            orig = ShardingPropagator.__dict__.get(name)
            if orig is not None:
                self._saved[name] = orig
                setattr(ShardingPropagator, name, self._wrap(orig))
        if not self._saved:
            # without the wrap every global-shape propagation op would be
            # counted as a rank's own work
            raise RuntimeError(
                f"ShardingPropagator has none of {_PROPAGATORS}: this "
                f"PyTorch's propagator runs under another name, so a "
                f"rank's counts cannot be told from DTensor's global-shape "
                f"ones")
        return self

    def _wrap(self, orig):
        def wrapped(prop, *args, **kwargs):
            self.depth += 1
            try:
                return orig(prop, *args, **kwargs)
            finally:
                self.depth -= 1
        return wrapped

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        for name, orig in self._saved.items():
            setattr(ShardingPropagator, name, orig)
        self._saved.clear()


@dataclasses.dataclass
class RankCount(RoundCount):
    """One rank's work in a traced program: the :class:`RoundCount`
    fields (operations by kind, HBM bytes) of the rank's local shards,
    the collectives it issues (``(kind, bytes, group size, crosses
    pod)``, bytes the whole buffer: a gather's output, a scatter's input)
    and the peak of the bytes its new tensors hold (``peak_bytes``, on
    top of the arguments)."""

    collectives: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    events: list | None = None

    def add(self, n_bytes: float, ops: float = 0.0,
            kind: str = "fp32") -> None:
        super().add(n_bytes, ops, kind)
        if ops and self.events is not None:
            self.events.append("dot")

    def collective_summary(self) -> dict:
        """``{kind: {"count", "bytes"}}`` over the collectives."""
        out: dict = {}
        for kind, n, _, _ in self.collectives:
            rec = out.setdefault(kind, {"count": 0, "bytes": 0})
            rec["count"] += 1
            rec["bytes"] += int(n)
        return out


class RankCounter(TorchDispatchMode):
    """Count one rank's share of the work of a program over ``DTensor``s
    (``with RankCounter() as c``; the result in ``c.count``).

    The mode declines every op on a ``DTensor`` (it returns
    ``NotImplemented``), so DTensor lowers the op to the rank's local
    ops and collectives, which come back to the mode on local tensors and
    are counted: a product's operations at the local shards' sizes (a
    ``FlopCounterMode`` outside DTensor counts the global op), bytes as
    :class:`RoundCounter` charges them, and each collective with its
    buffer and group.  The fake global-shape op DTensor's sharding
    propagator runs for each new op pattern is skipped
    (``_PROPAGATORS``).  Kernel wrappers charge their launches
    (:func:`charge`), at the local shapes ``local_map`` gives them.

    The peak: each op's new output storage is held from the op until the
    last tensor on it is freed; ``count.peak_bytes`` is the largest sum
    reached.  Tensors made before the block (the arguments) are not in
    it.  Storage made inside a DTensor op but not returned from it (a
    redistribution's buffers) is not seen."""

    def __init__(self, events: bool = False):
        super().__init__()
        self.count = RankCount()
        if events:                      # the order of products, launches
            self.count.events = []      # and collectives
        self._live: dict = {}           # storage key -> [bytes, refs]
        self._now = 0
        self._prop = None

    def __enter__(self):
        self._prop = _Propagating().__enter__()
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        self._prop.__exit__(*exc)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._prop.depth:
            return out
        name = func.overloadpacket.__name__
        if name in _COLLECTIVES:
            self._collective(_COLLECTIVES[name], args, out)
            return out
        if func.namespace in ("c10d", "_c10d_functional", "prim") or \
                name in _FREE:
            return out
        outs = _tensors(out)
        if not _is_view(func):
            seen = {t.untyped_storage()._cdata for t in _tensors(args)}
            for t in outs:
                self._hold(t, t.untyped_storage()._cdata not in seen)
            reads = _tensors((args, {k: v for k, v in kwargs.items()
                                     if k != "out"}))
            ops, kind = 0.0, "fp32"
            if name in _DOTS:
                i, j = _DOTS[name]
                a, b = args[i], args[j]
                ops = 2.0 * a.numel() * (b.shape[-1] if b.dim() >= 2 else 1)
                kind = op_kind(a.dtype)
            self.count.add(nbytes(*reads, *outs), ops, kind)
        else:
            for t in outs:
                self._hold(t, False)
        return out

    def _hold(self, t: torch.Tensor, new: bool) -> None:
        """Count ``t`` as a reference to its storage: a ``new`` storage
        from here on, an existing one only if it is already held (a view
        or an in-place result of an argument is not new memory)."""
        import weakref
        st = t.untyped_storage()
        key = st._cdata
        rec = self._live.get(key)
        if rec is None:
            if not new:
                return
            rec = self._live[key] = [st.nbytes(), 0]
            self._now += rec[0]
            self.count.peak_bytes = max(self.count.peak_bytes, self._now)
        rec[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        rec = self._live.get(key)
        if rec is None:
            return
        rec[1] -= 1
        if rec[1] == 0:
            self._now -= rec[0]
            del self._live[key]

    def _collective(self, kind: str, args, out) -> None:
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group

        # a functional collective names its group last (after a reduce
        # op's name); a c10d one takes the group object
        group = next((a for a in reversed(args) if isinstance(a, str)), None)
        if group is not None:
            pg = _resolve_process_group(group)
        else:                           # c10d's ops take the boxed group
            pg = next((dist.ProcessGroup.unbox(a) for a in args
                       if isinstance(a, torch.ScriptObject)), None)
        ranks = dist.get_process_group_ranks(pg) if pg is not None else [0]
        # the whole buffer: a gather's outputs, a scatter's inputs
        moved = max(nbytes(*_tensors(a)) for a in (*args, out))
        world = dist.get_world_size()
        pod = world // 2 if world >= 512 else world
        crosses = len({r // pod for r in ranks}) > 1
        self.count.collectives.append((kind, moved, len(ranks), crosses))
        if self.count.events is not None:
            self.count.events.append("collective")


def merge_overlap_report(events: list) -> dict:
    """Did one traced round issue its merge so that it can run behind the
    local compute?  ``events`` is a round's order of products and kernel
    launches (``"dot"``) and collectives (``"collective"``), from a
    ``RankCounter(events=True)``.  The port's ops run in program order,
    a valid topological order of their data, so a product that comes
    after a collective proves that the collective does not read it —
    JAX's check of a sync backend's schedule (XLA:CPU's plain
    ``all-reduce``).  A serial compute -> merge -> update round never has
    one: every product feeds the merge.  (With NCCL on the card the
    collectives of ``distributed.collectives`` are issued on the compute
    stream, so this shows the dependence structure, not a run that
    overlapped.)"""
    first = next((i for i, e in enumerate(events) if e == "collective"),
                 None)
    after = 0 if first is None else sum(
        e == "dot" for e in events[first + 1:])
    return {"collectives": sum(e == "collective" for e in events),
            "dots": sum(e == "dot" for e in events),
            "dots_after_first_collective": after,
            "overlapped": after > 0}


def rank_roofline(count: RankCount, *, n_chips: int, hbm_bw: float =
                  hw.HBM_BW, peak_ops: dict = hw.PEAK_OPS) -> dict:
    """The three-term roofline of one rank's traced step, JAX's
    ``roofline_terms`` on the card's figures: compute (each kind of
    operation over its peak), memory (the bytes over ``hbm_bw``) and the
    collectives (each buffer times the ring factor, 2(n−1)/n for an
    all-reduce and (n−1)/n for a gather, scatter or all-to-all, over
    NVLink's rate, or the NIC's where the group crosses a pod).

    What this sees that XLA's ``memory_analysis`` / ``cost_analysis``
    see differently: the port runs eagerly, op by op, so every
    intermediate is a tensor of its own — there is no fusion, no buffer
    aliasing and no compiled schedule.  The bytes are each op's reads and
    writes, not a fused program's, and the peak is the largest sum of live
    op outputs, not the temp allocation of one compiled schedule; a
    collective's time is counted as if nothing overlapped it."""
    compute_s = sum(n / peak_ops[k] for k, n in count.ops.items())
    memory_s = count.bytes / hbm_bw
    ici_s = dcn_s = 0.0
    for kind, n_bytes, group, crosses in count.collectives:
        g = max(group, 1)
        factor = (2.0 * (g - 1) / g if kind == "all-reduce" else
                  1.0 if kind == "broadcast" else (g - 1) / g)
        if crosses:
            dcn_s += n_bytes * factor / hw.NIC_BW_PER_GPU
        else:
            ici_s += n_bytes * factor / hw.NVLINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": ici_s + dcn_s, "ici_s": ici_s, "dcn_s": dcn_s}
    flops = sum(count.ops.values())
    return {
        **{k: float(v) for k, v in terms.items()},
        "bottleneck": max(("compute_s", "memory_s", "collective_s"),
                          key=lambda k: terms[k]),
        "step_time_bound_s": float(max(compute_s, memory_s,
                                       ici_s + dcn_s)),
        "flops_per_device": float(flops),
        "flops_global": float(flops * n_chips),
        "ops_by_kind": {k: float(v) for k, v in count.ops.items()},
        "bytes_per_device": float(count.bytes),
    }


def model_flops(cfg, kind: str, batch: int, seq_len: int,
                params=None) -> dict:
    """JAX's ``model_flops``: 6·N·T (train), 2·N·T (prefill), 2·N·B
    (decode), N the active non-embedding parameters (MoE experts at
    top_k / E), plus the causal-attention and SSD terms.  ``params``: the
    model's parameter tree (any tensors, fake ones too); None makes it
    under a ``FakeTensorMode`` on the CPU."""
    from repro_torch.tree import tree_flatten_with_keys

    if params is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.models import build
        with FakeTensorMode():
            params = build(cfg, "cpu").init(0)
    paths, leaves = tree_flatten_with_keys(params)
    total = sum(int(t.numel()) for t in leaves)
    emb = moe_total = 0
    for path, leaf in zip(paths, leaves):
        keys = [k for k in path if k is not None]
        if keys and keys[-1] == "embed":
            emb += int(leaf.numel())
        if "moe" in keys and keys[-1] in ("w_gate", "w_up", "w_down"):
            moe_total += int(leaf.numel())
    n_active = total - emb - moe_total
    if cfg.moe is not None and moe_total:
        n_active += int(moe_total * cfg.moe.top_k / cfg.moe.n_experts)

    pat = cfg.pattern
    n_attn = sum(1 for k in pat if k == "attn")
    n_local = sum(1 for k in pat if k == "local_attn")
    H, Dh = cfg.n_heads, cfg.hd
    W = cfg.window or seq_len
    if kind == "train":
        T = batch * seq_len
        param_f = 6.0 * n_active * T
        attn_f = 3.0 * (2.0 * batch * H * Dh *
                        (n_attn * seq_len ** 2 / 2
                         + n_local * seq_len * min(W, seq_len)))
        if cfg.encoder is not None:
            ec = cfg.encoder
            attn_f += 3.0 * 2.0 * batch * H * Dh * (
                ec.n_layers * ec.n_ctx ** 2 + len(pat) * seq_len * ec.n_ctx)
    elif kind == "prefill":
        T = batch * seq_len
        param_f = 2.0 * n_active * T
        attn_f = 2.0 * batch * H * Dh * (
            n_attn * seq_len ** 2 / 2 + n_local * seq_len * min(W, seq_len))
        if cfg.encoder is not None:
            ec = cfg.encoder
            attn_f += 2.0 * batch * H * Dh * (
                ec.n_layers * ec.n_ctx ** 2 + len(pat) * seq_len * ec.n_ctx)
    else:
        param_f = 2.0 * n_active * batch
        attn_f = 4.0 * batch * H * Dh * (
            n_attn * seq_len + n_local * min(W, seq_len))
        if cfg.encoder is not None:
            attn_f += 4.0 * batch * H * Dh * len(pat) * cfg.encoder.n_ctx
    ssd_f = 0.0
    if cfg.ssm is not None:
        sc = cfg.ssm
        d_in = sc.expand * cfg.d_model
        Hs = d_in // sc.head_dim
        n_ssd = sum(1 for k in pat if k == "mamba2")
        if kind == "decode":
            ssd_f = 2.0 * batch * n_ssd * Hs * sc.head_dim * sc.d_state * 2
        else:
            per_tok = 2.0 * sc.chunk * Hs * (sc.d_state + 2 * sc.head_dim)
            ssd_f = (3.0 if kind == "train" else 1.0) * batch * seq_len * \
                per_tok * n_ssd
    return {"model_flops": float(param_f + attn_f + ssd_f),
            "param_flops": float(param_f), "attn_flops": float(attn_f),
            "ssd_flops": float(ssd_f), "n_active_params": int(n_active),
            "n_total_params": int(total)}
