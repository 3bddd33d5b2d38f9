"""Port parity of K-means: the per-lane partials against the JAX Pallas
kernel, whole fits against the JAX package from its own initial
centroids, the port's engine oracle, centroids carried across, and the
``kmeans_assign`` wrapper's contract on the CPU.

The JAX fits run under ``dispatch.use_kernels(False)``
(``tests/test_dispatch.py`` holds its Pallas path equal to that one).
JAX computes ``x·cᵀ`` as a matmul and the port sums ``j = 0..D-1`` in
order, so assignments agree wherever the two nearest centroids are
more than rounding apart (the data here keep that gap above 1e-4) and
float sums agree to their summation order.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import make_cpu_grid as jax_grid  # noqa: E402
from repro.core import quantize as jqz  # noqa: E402
from repro.core.mlalgos import KMeans as JKMeans  # noqa: E402
from repro.core.mlalgos import api as japi  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.kernels.kmeans_assign import kmeans_assign as jkm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import datasets, make_cpu_grid  # noqa: E402
from repro_torch.core.mlalgos import KMeans, api, train_kmeans  # noqa: E402
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels import kmeans_assign as km_mod  # noqa: E402
from repro_torch.kernels.kmeans_assign import kmeans_assign  # noqa: E402
from torch_parity import (assert_bits_equal, blobs, rng,  # noqa: E402
                          to_numpy, to_torch, top_two_gap)

LANES, ROWS, D, K = 8, 603, 6, 4       # 603 rows: the last lane is padded
BITS = {"int16": 16, "int8": 8}


def _lanes_of(X, lanes):
    """``X`` padded with zero rows to a lane multiple, as ``(L, R, D)``,
    and the 0/1 row mask."""
    per = -(-X.shape[0] // lanes)
    pad = per * lanes - X.shape[0]
    Xp = np.concatenate([X, np.zeros((pad,) + X.shape[1:], X.dtype)])
    w = np.concatenate([np.ones(X.shape[0], np.float32),
                        np.zeros(pad, np.float32)])
    return Xp.reshape(lanes, per, *X.shape[1:]), w.reshape(lanes, per)


@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("precision", ["fp32", "int16", "int8"])
def test_partials_per_lane_vs_pallas_interpret(precision, per_lane):
    """Counts equal to the JAX Pallas kernel (interpret mode) lane by
    lane; sums and sse within atol 1e-4, rtol 1e-5 (another summation
    order).  int rows go in as int16/int8 with the scale; JAX gets the
    dequantized float rows, as its ``local_step`` does."""
    X = blobs(1, ROWS, D, K)
    x, w = _lanes_of(X, LANES)
    r = rng(2)
    c = X[r.choice(ROWS, K, replace=False)]
    c = (np.stack([c + 0.05 * r.standard_normal(c.shape).astype(np.float32)
                   for _ in range(LANES)]) if per_lane else c)
    scale = None
    if precision == "fp32":
        xin, xf = x, x
    else:
        q = jqz.quantize_symmetric(jnp.asarray(X), bits=BITS[precision],
                                   axis=0)
        xin, _ = _lanes_of(np.asarray(q.values), LANES)
        scale = np.asarray(q.scale)
        xf = xin.astype(np.float32) * scale
    cl = c if per_lane else np.broadcast_to(c, (LANES, K, D))
    near_tie = top_two_gap(xf, cl) <= 1e-4       # weight 0: no vote
    assert near_tie.sum() <= 2
    w = np.where(near_tie, np.float32(0), w)
    sums, counts, sse = dispatch.kmeans_partials(
        to_torch(xin), to_torch(c), to_torch(w),
        None if scale is None else to_torch(scale))
    assert sums.shape == (LANES, K, D) and sse.shape == (LANES,)
    for lane in range(LANES):
        js, jc, je = jkm(jnp.asarray(xf[lane]), jnp.asarray(cl[lane]),
                         jnp.asarray(w[lane]), block_n=64, interpret=True)
        assert_bits_equal(counts[lane], jc)
        np.testing.assert_allclose(sums[lane].numpy(), np.asarray(js),
                                   atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(float(sse[lane]), float(je), atol=1e-4,
                                   rtol=1e-5)


def test_plain_assignments_sum_in_feature_order():
    """The plain version's distance is ``|c|² − 2·Σ_j x_j c_j`` summed in
    order with one rounding per product and per add (what the kernel
    computes), and its argmin takes the first index on ties."""
    r = rng(3)
    x = r.standard_normal((2, 50, 7)).astype(np.float32)
    c = r.standard_normal((5, 7)).astype(np.float32)
    c[3] = c[1]                                       # an exact tie
    *_, a = ref.kmeans_assign_ref(to_torch(x), to_torch(c),
                                  torch.ones(2, 50), return_assign=True)
    dot = np.zeros((2, 50, 5), np.float32)
    c2 = np.zeros(5, np.float32)
    for j in range(7):
        dot = dot + x[..., j:j + 1] * c[:, j]
        c2 = c2 + c[:, j] * c[:, j]
    want = np.argmin(c2 - np.float32(2) * dot, axis=-1).astype(np.int32)
    assert_bits_equal(a, want)
    assert not (to_numpy(a) == 3).any()


def _jax_fit(precision, k, iters):
    X = blobs(4, ROWS, D, K)
    jw = JKMeans(k=K, precision=precision)
    with jdispatch.use_kernels(False):
        _, _, consts = jw.prepare(jax_grid(LANES), jnp.asarray(X))
        jres = japi.fit(jw, jax_grid(LANES), jnp.asarray(X), steps=iters,
                        merge_every=k)
    return X, np.asarray(consts["_c0"]), jres


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_fit_from_the_reference_c0(precision, k):
    """8 Lloyd iterations at cadence k from JAX's initial centroids:
    centroids within atol 1e-4, rtol 1e-5 (the JAX package's own bar in
    ``test_dispatch.py::test_kmeans_int8``), per-iteration sse within
    rtol 1e-5 and ``moved`` within 1e-4."""
    X, c0, jres = _jax_fit(precision, k, 8)
    program = KMeans(k=K, precision=precision).bind(make_cpu_grid(LANES), X)
    program.state0 = interop.state_from_numpy(c0, device="cpu")
    res = program.fit(steps=8, merge_every=k)
    np.testing.assert_allclose(res.state.numpy(), np.asarray(jres.state),
                               atol=1e-4, rtol=1e-5)
    assert len(res.history) == 8
    for m, n in zip(res.history, jres.history):
        assert m["moved"].shape == () and m["sse"].shape == ()
        np.testing.assert_allclose(float(m["sse"]), float(n["sse"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["moved"]), float(n["moved"]),
                                   atol=1e-4)


@pytest.mark.parametrize("k", [1, 3])
def test_scan_engine_equals_python_engine(k):
    """Bit-exact: the same arithmetic, other host synchronisation; 7
    iterations in chunks of 2 rounds leave a remainder."""
    X = blobs(5, ROWS, D, K)
    program = KMeans(k=K, precision="int16").bind(make_cpu_grid(LANES), X)
    a = program.fit(steps=7, engine="python", merge_every=k)
    b = program.fit(steps=7, engine="scan", scan_chunk=2, merge_every=k)
    assert torch.equal(a.state, b.state)
    for m, n in zip(a.history, b.history):
        assert torch.equal(m["sse"], n["sse"])
        assert torch.equal(m["moved"], n["moved"])


def test_update_reduces_each_lane_on_its_own():
    """Inside a cadence round the state is ``(L, k, d)``: ``moved`` is one
    value per lane and an empty cluster keeps its lane's centroid."""
    c = torch.arange(2 * 3 * 2, dtype=torch.float32).reshape(2, 3, 2)
    merged = {"sums": c + 1.0, "counts": torch.tensor([[1.0, 1.0, 0.0],
                                                       [1.0, 1.0, 1.0]]),
              "sse": torch.tensor([1.0, 2.0])}
    new_c, metrics = KMeans(k=3).update({}, c, merged)
    assert torch.equal(new_c[0, 2], c[0, 2])
    assert torch.equal(new_c[1], c[1] + 1.0)
    assert torch.equal(metrics["moved"], torch.tensor([1.0, 1.0]))


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_jax_centroids_predict_in_the_port(precision):
    """A JAX-trained state answers 1, 7 and 100 rows with the JAX
    package's assignments."""
    X, _, jres = _jax_fit(precision, 1, 5)
    jw = JKMeans(k=K, precision=precision)
    state = interop.state_from_numpy(np.asarray(jres.state), device="cpu")
    wl = KMeans(k=K, precision=precision)
    for n in (1, 7, 100):
        want = np.asarray(jw.predict(jres.state, jnp.asarray(X[:n])))
        got = wl.predict(state, X[:n])
        np.testing.assert_array_equal(to_numpy(got), want)
    np.testing.assert_allclose(wl.eval(state, X)["sse"],
                               jw.eval(jres.state, jnp.asarray(X))["sse"],
                               rtol=1e-5)


def test_train_kmeans_finds_the_blobs():
    X = blobs(6, 2000, D, K, spread=0.1)
    res = train_kmeans(make_cpu_grid(LANES), X, K, iters=10, seed=1)
    sse = [float(m["sse"]) for m in res.history]
    assert res.centroids.shape == (K, D) and sse[-1] <= sse[0]
    assert torch.isfinite(res.centroids).all()


def test_wrapper_contract_on_the_cpu():
    """Argument checks, and a CPU tensor never moves the counter."""
    x = torch.zeros(2, 5, 3)
    c = torch.zeros(4, 3)
    w = torch.ones(2, 5)
    before = kmeans_assign.launches
    sums, counts, sse = kmeans_assign(x, c, w)
    assert counts.tolist() == [[5.0, 0, 0, 0]] * 2
    assert kmeans_assign.launches == before
    with pytest.raises(TypeError):
        kmeans_assign(x.double(), c, w)
    with pytest.raises(ValueError):
        kmeans_assign(x, torch.zeros(4, 2), w)
    with pytest.raises(ValueError):
        kmeans_assign(x, torch.zeros(3, 4, 3), w)        # lanes differ
    with pytest.raises(ValueError):
        kmeans_assign(x, c, w, torch.ones(3))             # float rows
    with pytest.raises(ValueError):
        kmeans_assign(x.to(torch.int8), c, w, torch.ones(2))


# (L, R, K, D): configs/pim_ml.py's K-means at chip_smoke.py's 2^24 rows,
# then the shapes of the card tests and of chip_smoke.py's comparisons
@pytest.mark.parametrize("L,R,K,D", [
    (256, 65536, 8, 16), (4, 65536, 8, 16), (3, 1001, 3, 5),
    (2, 777, 17, 33), (5, 300, 1, 16), (3, 5000, 1, 16), (2, 4099, 64, 16),
    (3, 1237, 8, 64), (256, 2000, 8, 16), (3, 3001, 6, 16), (5, 300, 3, 4),
    (2, 300, 3, 130)])
def test_kernel_layout_fits_the_card(L, R, K, D):
    """The kernel's block at every shape the port runs it: shared memory
    within a block's limit (and four blocks an SM at the path's shape),
    each warp's statistics groups within its 32 threads, a grid within
    its limits and a scratch of a few MiB."""
    lay = km_mod.layout(K, D)
    q = -(-D // 4) + 1
    assert lay["smem"] <= km_mod.MAX_SMEM_BYTES
    assert 1 <= lay["groups"] <= km_mod.WARP_ROWS // min(q, km_mod.WARP_ROWS)
    assert lay["tile"] == km_mod.WARP_ROWS * lay["warps"] <= km_mod.THREADS
    if (K, D) == (8, 16):
        assert lay["smem"] <= km_mod.TARGET_SMEM_BYTES
    blocks = km_mod.max_blocks(L, R, K, D, sms=132)
    rows = -(-R // blocks)
    rows = -(-rows // lay["tile"]) * lay["tile"]
    assert 1 <= -(-R // rows) <= blocks and L <= 65535
    assert L * blocks * lay["cells"] * 4 <= 64 * 2 ** 20


def test_kernel_layout_mirrors_the_source():
    """``layout``'s constants are the CUDA source's."""
    src = (Path(km_mod.__file__).parent / "csrc" / "kmeans_assign.cu"
           ).read_text()

    def const(name):
        expr = re.search(rf"constexpr \w+(?: \w+)? {name} = ([0-9 /]+);",
                         src).group(1)
        first, *divisors = (int(t) for t in expr.split("/"))
        for d in divisors:
            first //= d
        return first

    assert const("kThreads") == km_mod.THREADS
    assert const("kWarpRows") == km_mod.WARP_ROWS
    assert const("kTargetWords") * 4 == km_mod.TARGET_SMEM_BYTES
    assert const("kMaxWords") * 4 == km_mod.MAX_SMEM_BYTES


def test_blobs_on_a_generator():
    gen = torch.Generator().manual_seed(0)
    X, assign, centers = datasets.blobs(gen, 500, 3, 4)
    assert X.shape == (500, 3) and centers.shape == (4, 3)
    assert (centers.abs() <= 2.0).all() and int(assign.max()) < 4
    assert float((X - centers[assign]).std()) < 0.4
