"""Port parity of the decision tree: the level histogram against the JAX
Pallas kernel, the quantile bins against numpy, whole trees against the
JAX package, a JAX tree predicting in the port, the exact-only merge
capabilities, and the ``split_hist`` wrapper's contract on the CPU.

Every histogram entry is an integer-valued float below 2^24, so the
histograms, and with them the trees, are compared bit for bit.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import make_cpu_grid as jax_grid  # noqa: E402
from repro.core.mlalgos import dtree as jdtree  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.kernels.split_hist import split_hist as jsh  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import datasets, make_cpu_grid  # noqa: E402
from repro_torch.core.mlalgos import (DecisionTree, api,  # noqa: E402
                                      dtree_predict, quantize_features,
                                      train_dtree)
from repro_torch.core.mlalgos import dtree as tdtree  # noqa: E402
from repro_torch.kernels import build, dispatch, ref  # noqa: E402
from repro_torch.kernels import split_hist as sh_mod  # noqa: E402
from repro_torch.kernels.split_hist import split_hist  # noqa: E402
from torch_parity import (assert_bits_equal, mixture, rng,  # noqa: E402
                          to_numpy, to_torch)

LANES, ROWS, D, C = 8, 603, 6, 3


def _level_inputs(seed, L, R, F, n_nodes, n_bins, n_classes):
    r = rng(seed)
    node = r.integers(0, n_nodes, (L, R)).astype(np.int32)
    xbin = r.integers(0, n_bins, (L, R, F)).astype(np.int32)
    y = r.integers(0, n_classes, (L, R)).astype(np.int32)
    w = (r.random((L, R)) < 0.9).astype(np.float32)
    return node, xbin, y, w


@pytest.mark.parametrize("n_nodes", [1, 4])
def test_level_histogram_vs_pallas_interpret(n_nodes):
    """Bit-equal to the JAX Pallas kernel (interpret mode), lane by lane,
    with 10 % of the rows masked out."""
    node, xbin, y, w = _level_inputs(n_nodes, 3, 301, 5, n_nodes, 8, C)
    H = dispatch.level_histogram(to_torch(node), to_torch(xbin),
                                 to_torch(y), to_torch(w), n_nodes=n_nodes,
                                 n_bins=8, n_classes=C)
    assert H.shape == (3, n_nodes, 5, 8, C)
    for lane in range(3):
        want = jsh(jnp.asarray(node[lane]), jnp.asarray(xbin[lane]),
                   jnp.asarray(y[lane]), jnp.asarray(w[lane]),
                   n_nodes=n_nodes, n_bins=8, n_classes=C, block_n=64,
                   interpret=True)
        assert_bits_equal(H[lane], want)


@pytest.mark.parametrize("dtype", [torch.int16, torch.uint8])
def test_narrow_bins_and_strided_lanes_count_the_same(dtype):
    """int16 and uint8 bins, and lane-strided views of every input, give
    the int32 histogram; out-of-range nodes, bins and classes add
    nothing."""
    node, xbin, y, w = _level_inputs(7, 6, 200, 4, 3, 16, C)
    node[0, :5], xbin[1, :5, 2], y[2, :5] = 3, 16, -1
    tn, tx, ty, tw = map(to_torch, (node, xbin, y, w))
    want = split_hist(tn, tx, ty, tw, n_nodes=3, n_bins=16, n_classes=C)
    got = split_hist(tn[::2], tx[::2].to(dtype), ty[::2], tw[::2],
                     n_nodes=3, n_bins=16, n_classes=C)
    assert_bits_equal(got, want[::2])
    assert float(want[0].sum()) == 4 * float(w[0, 5:].sum())   # node 3
    assert float(want[1, :, 2].sum()) == float(w[1, 5:].sum())  # bin 16
    assert float(want[2].sum()) == 4 * float(w[2, 5:].sum())   # class -1


@pytest.mark.parametrize("n,dup", [(1001, False), (1000, False),
                                   (999, True), (64, True), (1, False)])
def test_quantize_features_equals_numpy(n, dup):
    """Edges and bins bit-equal to ``repro``'s ``quantize_features``
    (``np.percentile`` on the host) at odd and even n and with duplicate
    values."""
    X = (rng(n).standard_normal((n, 3)) * 3).astype(np.float32)
    if dup:
        X = np.round(X * 2) / 2 + np.float32(0.25)   # ties, no signed zero
    jb, je = jdtree.quantize_features(jnp.asarray(X), 16)
    b, e = quantize_features(X, 16)
    assert_bits_equal(e, je)
    assert_bits_equal(b, jb)


@pytest.mark.parametrize("n_bins,dtype", [(32, torch.uint8),
                                          (256, torch.uint8),
                                          (300, torch.int16)])
def test_resident_bins_are_narrow_and_equal_jax(n_bins, dtype):
    """``DecisionTree.prepare`` keeps the bins in the narrowest type the
    split kernel reads (uint8 at the paper's 32 bins, int16 above 256),
    with the values of ``repro``'s int32 ``quantize_features`` bins, and
    the edges bit-equal to numpy's."""
    n = 2003
    X = (rng(n_bins).standard_normal((n, D)) * 3).astype(np.float32)
    y = rng(n_bins + 1).integers(0, C, n).astype(np.int32)
    wl = DecisionTree(max_depth=3, n_bins=n_bins, n_classes=C)
    data, _, consts = wl.prepare(make_cpu_grid(LANES), X, y)
    assert data["X"].dtype == dtype == tdtree.bin_dtype(n_bins)
    jb, je = jdtree.quantize_features(jnp.asarray(X), n_bins)
    assert_bits_equal(data["X"].reshape(-1, D)[:n].to(torch.int32), jb)
    assert_bits_equal(consts["_edges"], je)


def test_bin_features_in_chunks(monkeypatch):
    """Rows binned a chunk at a time (the last one ragged) equal
    ``searchsorted`` column by column, in every bin type."""
    monkeypatch.setattr(tdtree, "BIN_CHUNK_ROWS", 100)
    X = torch.as_tensor(rng(3).standard_normal((1001, 5)).astype(
        np.float32))
    edges = torch.sort(torch.as_tensor(rng(4).standard_normal(
        (5, 31)).astype(np.float32)), dim=1).values
    want = np.stack([np.searchsorted(edges[j].numpy(), X[:, j].numpy(),
                                     side="right") for j in range(5)], 1)
    for dtype in (torch.int32, torch.int16, torch.uint8):
        got = tdtree.bin_features(X, edges, dtype)
        assert got.dtype == dtype and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)


def test_split_hist_layout_mirrors_the_source():
    """The wrapper's threads and shared-memory limit are the source's."""
    src = (build.CSRC / "split_hist.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))

    assert const("kThreads") == sh_mod.THREADS
    assert const("kMaxSmemBytes") == sh_mod.MAX_SMEM_BYTES


def test_split_hist_layout_on_the_tree_path():
    """At the tree's passes (256 lanes x 65,536 rows, F = 16, 32 bins, 4
    classes, 132 SMs) one block holds a lane's whole tile up to 16 nodes,
    two at 32 and three at 64, every lane's rows read by one block a tile
    (no chunks, so H is stored, not added), within 227 KB."""
    tiles = []
    for level in range(7):
        lay = sh_mod.layout(256, 65536, 16, 2 ** level, 32, 4, 132)
        assert lay["chunks"] == 1 and not lay["bulk"]
        assert lay["smem"] <= sh_mod.MAX_SMEM_BYTES
        assert lay["sC"] % 2 == 1 and lay["sC"] >= lay["nf"]
        tiles.append(lay["tiles"])
    assert tiles == [1, 1, 1, 1, 1, 2, 3]


@pytest.mark.parametrize("L,R,F,nodes,bins,classes", [
    (4, 65536, 16, 1, 32, 4), (6, 5000, 40, 96, 16, 3),
    (3, 100003, 16, 16, 32, 4), (2, 4000, 7, 3, 9, 5)])
def test_split_hist_bulk_layout_keeps_runs_in_phase(L, R, F, nodes, bins,
                                                    classes):
    """With few lanes the rows are cut into chunks, and each node's run
    of a tile sits as many words from the last, mod 4, as in H, so one
    16-byte phase serves the whole tile; every tile fits."""
    lay = sh_mod.layout(L, R, F, nodes, bins, classes, 132)
    bc = bins * classes
    assert lay["bulk"] and lay["chunks"] > 1 and lay["sC"] == 1
    assert lay["sF"] == bc and lay["sN"] >= lay["nf"] * bc
    assert (lay["sN"] - F * bc) % 4 == 0
    assert lay["smem"] == 4 * (3 + nodes * lay["sN"]) <= sh_mod.MAX_SMEM_BYTES
    assert -(-F // lay["nf"]) == lay["tiles"]


def test_split_hist_row_vectors():
    """Rows whose bins fit 16 bytes on the 16-byte grid are one load:
    uint8 rows of 16 bins, and narrower uint8 and int16 rows of a view
    whose row stride is 16 bytes; rows off the grid, or wider than 16
    bytes (int32 rows of 16 bins), load by element."""
    u8 = torch.zeros((2, 8, 17), dtype=torch.uint8)
    u16 = torch.zeros((2, 8, 16), dtype=torch.uint8)
    i16 = torch.zeros((2, 8, 8), dtype=torch.int16)
    i32 = torch.zeros((2, 8, 16), dtype=torch.int32)
    assert sh_mod.row_vectors(u8[..., :16].contiguous()) == 1
    assert sh_mod.row_vectors(u16[..., :7]) == 1
    assert sh_mod.row_vectors(i16) == 1
    assert sh_mod.row_vectors(i16[..., :5]) == 1
    assert sh_mod.row_vectors(i32) == 0
    assert sh_mod.row_vectors(u8) == 0
    assert sh_mod.row_vectors(u8[..., 1:]) == 0
    assert sh_mod.row_vectors(u16[:, 1:, :7]) == 1
    assert sh_mod.row_vectors(u16[..., 1:8]) == 0
    assert sh_mod.row_vectors(i32[..., :8]) == 0


def _jax_tree(X, y, **kw):
    with jdispatch.use_kernels(False):
        return jdtree.train_dtree(jax_grid(LANES), jnp.asarray(X),
                                  jnp.asarray(y), **kw)


@pytest.mark.parametrize("depth,n_bins", [(3, 16), (5, 32)])
def test_train_dtree_equals_jax(depth, n_bins):
    """``feature``, ``threshold``, ``leaf_value``, the history and the
    predictions equal the JAX tree's."""
    X, y = mixture(depth, 2000, D, C)
    jres = _jax_tree(X, y, max_depth=depth, n_bins=n_bins, n_classes=C)
    res = train_dtree(make_cpu_grid(LANES), X, y, max_depth=depth,
                      n_bins=n_bins, n_classes=C)
    for field in ("feature", "threshold", "leaf_value", "bin_edges"):
        assert_bits_equal(getattr(res.tree, field),
                          getattr(jres.tree, field))
    assert [h["splits"] for h in res.history] == \
        [h["splits"] for h in jres.history]
    np.testing.assert_allclose([h["mean_gain"] for h in res.history],
                               [h["mean_gain"] for h in jres.history],
                               rtol=1e-5)
    assert_bits_equal(dtree_predict(res.tree, X),
                      jdtree.dtree_predict(jres.tree, jnp.asarray(X)))
    assert res.history[0]["splits"] == 1


def test_jax_tree_predicts_in_the_port():
    X, y = mixture(11, 1500, D, C)
    jt = _jax_tree(X, y, max_depth=4, n_bins=16, n_classes=C).tree
    tree = interop.dtree_from_numpy(
        np.asarray(jt.feature), np.asarray(jt.threshold),
        np.asarray(jt.leaf_value), np.asarray(jt.bin_edges), jt.max_depth,
        jt.n_classes, device="cpu")
    wl = DecisionTree(max_depth=4, n_bins=16, n_classes=C)
    for n in (1, 7, 100):
        want = np.asarray(jdtree.dtree_predict(jt, jnp.asarray(X[:n])))
        assert_bits_equal(wl.predict(tree, X[:n]), want)
    jacc = jdtree.DecisionTree().eval(jt, jnp.asarray(X), jnp.asarray(y))
    assert wl.eval(tree, X, y)["accuracy"] == pytest.approx(
        jacc["accuracy"], abs=1e-7)


def test_exact_only_warns_and_degrades():
    """Cadence 4 and a batch size degrade to the exact merge per level
    with one warning, and the tree is the exact one."""
    X, y = mixture(12, 800, D, C)
    grid = make_cpu_grid(LANES)
    wl = DecisionTree(max_depth=3, n_bins=16, n_classes=C)
    assert wl.merge_caps.cadence is False and wl.predict_device is False
    with pytest.warns(api.MergeFallbackWarning,
                      match="merge_every=4 \\+ batch_size=32"):
        a = api.fit(wl, grid, X, y, steps=3, merge_every=4, batch_size=32)
    b = api.fit(wl, grid, X, y, steps=3)
    assert torch.equal(a.state.feature, b.state.feature)
    assert torch.equal(a.state.leaf_value, b.state.leaf_value)


def test_one_launch_per_level_through_the_wrapper(monkeypatch):
    """The fit calls ``split_hist`` once per level and once for the leaf
    pass (on the CPU the wrapper runs its plain version)."""
    calls = []
    real = dispatch._sh.split_hist

    def spy(*a, **kw):
        calls.append(kw["n_nodes"])
        return real(*a, **kw)

    monkeypatch.setattr(dispatch._sh, "split_hist", spy)
    X, y = mixture(13, 800, D, C)
    res = train_dtree(make_cpu_grid(LANES), X, y, max_depth=3, n_bins=16,
                      n_classes=C)
    assert len(res.history) == 3
    assert calls == [1, 2, 4, 8]


def test_wrapper_contract_on_the_cpu():
    node, xbin, y, w = map(to_torch, _level_inputs(3, 2, 10, 3, 2, 4, 2))
    before = split_hist.launches
    H = split_hist(node, xbin, y, w, n_nodes=2, n_bins=4, n_classes=2)
    assert split_hist.launches == before
    assert torch.equal(H, ref.split_hist_ref(node, xbin, y, w, n_nodes=2,
                                             n_bins=4, n_classes=2))
    with pytest.raises(TypeError):
        split_hist(node.long(), xbin, y, w, n_nodes=2, n_bins=4, n_classes=2)
    with pytest.raises(TypeError):
        split_hist(node, xbin.float(), y, w, n_nodes=2, n_bins=4,
                   n_classes=2)
    with pytest.raises(ValueError):
        split_hist(node[:, :5], xbin, y, w, n_nodes=2, n_bins=4, n_classes=2)
    with pytest.raises(ValueError):
        split_hist(node, xbin, y, w, n_nodes=0, n_bins=4, n_classes=2)


def test_mixture_on_a_generator():
    gen = torch.Generator().manual_seed(0)
    X, y = datasets.mixture_classification(gen, 500, 4, 3)
    assert X.shape == (500, 4) and y.dtype == torch.int32
    assert set(to_numpy(y).tolist()) == {0, 1, 2}
