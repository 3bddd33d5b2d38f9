"""CART decision-tree training on the PIM grid.

Port of ``repro.core.mlalgos.dtree`` (paper workload #3).  The tree
grows level by level: each vDPU builds the split statistics
``H[node, feature, bin, class]`` of its resident rows on the
``split_hist`` kernel (through ``dispatch.level_histogram``, one launch
per level for every lane), the host merges them and commits the best
split per node, and the rows re-route to their children.  Only
histograms cross to the host, never rows (insight I4).

Features are quantile-binned once (``quantize_features``) into resident
bins of the narrowest type that holds them (uint8 at the paper's 32
bins; the JAX package keeps int32 with the same values); the bin edges
are computed on the device with numpy's ``percentile`` rule, so they
equal the JAX package's bit for bit without a host round trip of the
dataset.

The tree is stored level-wise in fixed-size arrays (node ``i``'s
children are ``2i+1`` and ``2i+2``).  Its update is a discrete argmax,
so the workload declares ``MergeCaps.exact_only``: a cadence or
minibatch request degrades to the exact merge per level with a
``MergeFallbackWarning``, and ``DecisionTree.run`` owns the level loop.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.mlalgos import api
from repro_torch.core.mlalgos.linreg import as_f32
from repro_torch.core.pim import PimGrid
from repro_torch.kernels import dispatch


@dataclasses.dataclass
class DTree:
    """Dense complete-binary-tree storage (depth D: ``2^D - 1`` internal
    slots, ``2^D`` leaf slots; unused slots are leaves)."""

    feature: torch.Tensor     # (n_total,) int32, -1 = leaf / unused
    threshold: torch.Tensor   # (n_total,) int32: go left if bin <= thr
    leaf_value: torch.Tensor  # (n_total,) int32 class of each node
    bin_edges: torch.Tensor   # (n_features, n_bins - 1) float32
    max_depth: int
    n_classes: int


@dataclasses.dataclass
class DTreeResult:
    tree: DTree
    history: list


def _percentile_edges(X: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``np.percentile(X, linspace(0, 100, n_bins + 1)[1:-1], axis=0).T``
    as float32, computed on ``X``'s device with numpy's linear rule:
    virtual index ``(n - 1) * (q / 100)`` and fraction ``g`` in float64,
    ``b - (b - a)(1 - g)`` where ``g >= 0.5`` else ``a + (b - a) g``,
    with ``b - a`` in float32."""
    n = X.shape[0]
    qs = np.linspace(0, 100, n_bins + 1)[1:-1]
    vi = (n - 1) * (qs / 100)
    lo = np.floor(vi)
    g = torch.as_tensor(vi - lo, dtype=torch.float64,
                        device=X.device)[:, None]
    lo = lo.astype(np.int64)
    hi = np.minimum(lo + 1, n - 1)
    srt = torch.sort(X, dim=0).values                     # (n, d)
    a = srt[torch.as_tensor(lo, device=X.device)]         # (B-1, d)
    b = srt[torch.as_tensor(hi, device=X.device)]
    diff = (b - a).double()
    edges = torch.where(g >= 0.5, b.double() - diff * (1 - g),
                        a.double() + diff * g)
    return edges.to(torch.float32).T.contiguous()         # (d, B-1)


BIN_CHUNK_ROWS = 2 ** 18      # rows binned at a time: the chunk's float32
                              # transpose and int32 bins (16 MiB each at
                              # d = 16) stay in a GPU's L2


def bin_dtype(n_bins: int) -> torch.dtype:
    """The narrowest type the split kernel reads that holds bins ``0 ..
    n_bins - 1``: uint8 up to 256 bins, int16 up to 32768, else int32."""
    return (torch.uint8 if n_bins <= 256 else
            torch.int16 if n_bins <= 32768 else torch.int32)


def bin_features(X: torch.Tensor, edges: torch.Tensor,
                 dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Bins ``(n, d)`` of ``dtype``, row-major: ``searchsorted(edges[j],
    X[:, j], side="right")`` per feature, as numpy bins.  The rows go
    ``BIN_CHUNK_ROWS`` at a time through one batched ``searchsorted``
    over the chunk's transpose, whose int32 result is written into the
    chunk's rows as ``dtype``: no pass over a whole column, and none over
    a whole int32 copy."""
    n, d = X.shape
    edges = edges.contiguous()
    binned = torch.empty((n, d), dtype=dtype, device=X.device)
    for r0 in range(0, n, BIN_CHUNK_ROWS):
        xt = X[r0:r0 + BIN_CHUNK_ROWS].T.contiguous()     # (d, rows)
        binned[r0:r0 + BIN_CHUNK_ROWS] = torch.searchsorted(
            edges, xt, right=True, out_int32=True).T
    return binned


def quantize_features(X, n_bins: int = 32, dtype: torch.dtype = torch.int32
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantile-bin the features: ``(binned (n, d) in [0, n_bins) as
    dtype, edges (d, n_bins - 1) float32)``, equal to the JAX package's bit
    for bit (int32 by default, as there), on ``X``'s device (a numpy
    ``X`` bins on the CPU)."""
    X = torch.as_tensor(X, dtype=torch.float32)
    edges = _percentile_edges(X, n_bins)
    return bin_features(X, edges, dtype), edges


def _best_splits(H: torch.Tensor):
    """Per-node best ``(feature, threshold, gain, class, count)`` of the
    merged ``H (nodes, F, B, C)`` by Gini gain,
    ``G(m) - (nL/n) G(L) - (nR/n) G(R)`` with ``G = 1 - Σ_c p_c²``;
    splits with an empty side get ``-inf``.  Runs on ``H``'s device;
    ``argmax`` takes the first maximum, as ``jnp.argmax``."""
    nodes, F, B, C = H.shape
    cum = torch.cumsum(H, dim=2)                  # left counts at thr = b
    total = cum[:, :, -1:, :]
    left = cum[:, :, :-1, :]
    right = total - left
    nl, nr, n = left.sum(dim=3), right.sum(dim=3), total.sum(dim=3)

    def gini(counts, size):
        p = counts / torch.clamp(size, min=1e-9)[..., None]
        return 1.0 - (p * p).sum(dim=-1)

    g_parent = gini(total, n)[:, :, 0]
    g_split = (nl * gini(left, nl) + nr * gini(right, nr)) \
        / torch.clamp(n, min=1e-9)
    gain = g_parent[:, :, None] - g_split
    gain = torch.where((nl > 0) & (nr > 0), gain, -torch.inf)
    flat_gain = gain.reshape(nodes, -1)
    best = torch.argmax(flat_gain, dim=1)
    best_gain = flat_gain.gather(1, best[:, None])[:, 0]
    node_class = torch.argmax(total[:, 0, 0, :], dim=1)
    return (torch.div(best, B - 1, rounding_mode="floor").to(torch.int32),
            (best % (B - 1)).to(torch.int32), best_gain,
            node_class.to(torch.int32), n[:, 0, 0])


@dataclasses.dataclass(frozen=True)
class DecisionTree(api.Workload):
    """Level-wise histogram CART (see the module docstring for why the
    tree is ``exact_only``)."""

    max_depth: int = 5
    n_bins: int = 32
    n_classes: int = 2
    min_samples_split: int = 2

    name = "dtree"
    merge_caps = api.MergeCaps.exact_only(
        "discrete split commits cannot be averaged across vDPUs "
        "(the level's argmax consumes the exact merged histogram)")
    predict_device = False

    def prepare(self, grid: PimGrid, X, y=None):
        """The resident bins are the narrowest type that holds them
        (:func:`bin_dtype`: uint8 at the paper's 32 bins).  The edges come
        from the full ``X``, so every rank of a mesh bins alike."""
        Xbin, edges = quantize_features(as_f32(X, grid.device), self.n_bins,
                                        bin_dtype(self.n_bins))
        y = torch.as_tensor(y, device=grid.device).to(torch.int32)
        data, n = grid.shard_rows(Xbin, y)
        return data, n, {"n": n, "_edges": edges}

    def init_state(self, consts):
        n_total = 2 ** (self.max_depth + 1) - 1
        dev = consts["_edges"].device
        return DTree(feature=torch.full((n_total,), -1, dtype=torch.int32,
                                        device=dev),
                     threshold=torch.zeros(n_total, dtype=torch.int32,
                                           device=dev),
                     leaf_value=torch.zeros(n_total, dtype=torch.int32,
                                            device=dev),
                     bin_edges=consts["_edges"], max_depth=self.max_depth,
                     n_classes=self.n_classes)

    def local_step(self, consts, state, sl):
        """One level's split statistics of every lane (``sl`` carries the
        per-row node index ``nidx``)."""
        return {"H": dispatch.level_histogram(
            sl["nidx"], sl["X"], sl["y0"], sl["w"],
            n_nodes=consts["n_nodes"], n_bins=self.n_bins,
            n_classes=self.n_classes)}

    def eval(self, state, X, y=None) -> dict:
        out = {}
        if y is not None:
            pred = dtree_predict(state, X)
            y = torch.as_tensor(y, device=pred.device)
            out["accuracy"] = float((pred == y).float().mean())
        return out

    def predict(self, state, X):
        """Class of each request row (:func:`dtree_predict`)."""
        return dtree_predict(state, X)

    def run(self, grid: PimGrid, X, y=None, *, steps=None, plan=None,
            batch_size=None, engine="scan", scan_chunk=32, callback=None,
            merge_state=None, sample_seed=0,
            sample_permutation=None) -> api.FitResult:
        """Train the tree to ``max_depth`` (``steps`` is ignored: the
        unit of work is a level).  ``plan`` and ``batch_size`` arrive
        already degraded to the exact default and full batch by
        ``merge_caps``."""
        data, _, consts = self.prepare(grid, X, y)
        max_depth = self.max_depth
        dev = grid.device
        node_idx = torch.zeros(data["w"].shape, dtype=torch.int32,
                               device=dev)

        n_total = 2 ** (max_depth + 1) - 1
        feature = np.full((n_total,), -1, np.int32)
        threshold = np.zeros((n_total,), np.int32)
        leaf_value = np.zeros((n_total,), np.int32)
        history = []
        reached_depth = 0

        def level_hist(n_nodes):
            level_consts = dict(consts, n_nodes=n_nodes)
            return grid.map_reduce(
                lambda _, sl: self.local_step(level_consts, None, sl), None,
                dict(data, nidx=node_idx))["H"]

        for depth in range(max_depth):
            n_nodes = 2 ** depth
            level_off = n_nodes - 1
            # control flow: on a mesh the histogram is all-reduced (sums
            # of 0/1 weights, exact in any order), so every rank makes
            # the same splits and stops at the same depth
            bf, bthr, bgain, bclass, bcount = (
                t.cpu().numpy() for t in _best_splits(level_hist(n_nodes)))

            # the host commits the splits
            made_split = np.zeros((n_nodes,), bool)
            for m in range(n_nodes):
                gid = level_off + m
                leaf_value[gid] = int(bclass[m])
                if (np.isfinite(bgain[m]) and bgain[m] > 1e-9
                        and bcount[m] >= self.min_samples_split):
                    feature[gid] = int(bf[m])
                    threshold[gid] = int(bthr[m])
                    made_split[m] = True
            history.append({"depth": depth,
                            "splits": int(made_split.sum()),
                            "mean_gain": float(np.nan_to_num(
                                np.where(made_split, bgain, 0.0).mean()))})
            if not made_split.any():
                break
            reached_depth = depth + 1

            # re-route: new local id = 2 * old + go_right; rows at nodes
            # that became leaves keep going to a dead subtree slot whose
            # leaf value is propagated below
            feat_l = torch.as_tensor(feature[level_off:level_off + n_nodes],
                                     device=dev)
            thr_l = torch.as_tensor(threshold[level_off:level_off + n_nodes],
                                    device=dev)
            nid = node_idx.long()
            f = torch.clamp(feat_l[nid], min=0).long()
            xv = torch.gather(data["X"], -1, f[..., None])[..., 0]
            node_idx = node_idx * 2 + (xv > thr_l[nid]).to(torch.int32)

        # the deepest nodes' classes: one more histogram pass
        if reached_depth > 0:
            n_nodes = 2 ** reached_depth
            level_off = n_nodes - 1
            counts = level_hist(n_nodes)[:, 0].sum(dim=1).cpu().numpy()
            for m in range(n_nodes):
                if counts[m].sum() > 0:
                    leaf_value[level_off + m] = int(counts[m].argmax())

        # dead or empty slots answer with their nearest populated
        # ancestor's class
        for gid in range((n_total - 1) // 2):
            if feature[gid] == -1:
                leaf_value[2 * gid + 1] = leaf_value[gid]
                leaf_value[2 * gid + 2] = leaf_value[gid]

        tree = DTree(feature=torch.as_tensor(feature, device=dev),
                     threshold=torch.as_tensor(threshold, device=dev),
                     leaf_value=torch.as_tensor(leaf_value, device=dev),
                     bin_edges=consts["_edges"], max_depth=max_depth,
                     n_classes=self.n_classes)
        return api.FitResult(state=tree, history=history, workload=self)


def train_dtree(grid: PimGrid, X, y, *, max_depth: int = 5,
                n_bins: int = 32, n_classes: int = 2,
                min_samples_split: int = 2, merge_every: int = 1,
                merge_plan=None, batch_size: int | None = None
                ) -> DTreeResult:
    """``merge_every``, ``merge_plan`` and ``batch_size`` are accepted for
    uniformity with the other workloads; the tree always merges every
    level on full partitions and warns when asked otherwise."""
    res = api.fit(DecisionTree(max_depth=max_depth, n_bins=n_bins,
                               n_classes=n_classes,
                               min_samples_split=min_samples_split),
                  grid, X, y, steps=max_depth, merge_every=merge_every,
                  merge_plan=merge_plan, batch_size=batch_size)
    return DTreeResult(tree=res.state, history=res.history)


def dtree_predict(tree: DTree, X) -> torch.Tensor:
    """Root-to-leaf descent on the binned request rows (int32 classes)."""
    Xb = bin_features(as_f32(X, tree.bin_edges.device), tree.bin_edges,
                      bin_dtype(tree.bin_edges.shape[1] + 1))
    node = torch.zeros(Xb.shape[0], dtype=torch.long, device=Xb.device)
    for _ in range(tree.max_depth):
        f = tree.feature[node].long()
        fv = torch.gather(Xb, 1, torch.clamp(f, min=0)[:, None])[:, 0]
        go_right = (fv > tree.threshold[node]).long()
        node = torch.where(f < 0, node, node * 2 + 1 + go_right)
    return tree.leaf_value[node]
