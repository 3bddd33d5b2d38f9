"""Card-only tests of the port: each CUDA kernel against its plain
PyTorch version (bit for bit; K-means sums and sse, and attention, within
their stated tolerances), and small fits and a small LM's prefill on the
card against their ``use_kernels(False)`` twins.  They skip where there
is no CUDA device and import no JAX, so the machine with the card runs
them as they are:

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import datasets, lut, make_grid  # noqa: E402
from repro_torch.core import minibatch as mb  # noqa: E402
from repro_torch.core.mlalgos import (DecisionTree, KMeans,  # noqa: E402
                                      LinearSVM, LinReg, LogReg,
                                      MultinomialLogReg, api)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels import split_hist as split_hist_mod  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    bwd_route, flash_attention, flash_attention_bwd, route)
from repro_torch.kernels.fxp_matmul import fxp_matmul  # noqa: E402
from repro_torch.kernels.fxp_matmul import route as fxp_route  # noqa: E402
from repro_torch.kernels.kmeans_assign import kmeans_assign  # noqa: E402
from repro_torch.kernels.lut_activation import lut_activation  # noqa: E402
from repro_torch.kernels.split_hist import split_hist  # noqa: E402
from repro_torch.models import build  # noqa: E402
import torch_mesh_ref as mesh_ref  # noqa: E402
from torch_parity import require_cuda, single_process_world  # noqa: E402

pytestmark = pytest.mark.requires_cuda


I8, I16 = torch.int8, torch.int16


# (L, M, K, N, transposed, a dtype, b dtype, view): both routes (rows: a
# contiguous along k; cols: the gradient's transposed view), N from 1 to
# 16, int8 and int16 a and b, ragged M and K, K > 4096 (chunks summed by
# the last block), a per-lane b (odd N) or a shared one, an unaligned
# view and 2-D request rows
@pytest.mark.parametrize("L,M,K,N,transposed,adt,bdt,view", [
    (3, 1000, 64, 1, False, I8, I16, None),
    (3, 1000, 64, 4, False, I8, I16, None),
    (3, 1000, 48, 3, False, I8, I8, None),
    (3, 80, 9000, 10, True, I8, I16, None),
    (3, 64, 9000, 1, True, I8, I16, None),
    (2, 77, 5000, 8, False, I8, I16, None),
    (1, 5, 7, 1, True, I8, I16, None),
    (2, 33, 64, 16, False, I8, I16, None),
    (2, 333, 64, 4, False, I16, I8, None),
    (2, 64, 333, 10, True, I16, I16, None),
    (2, 77, 63, 1, False, I16, I16, None),
    (2, 100, 4500, 16, True, I16, I8, None),
    (2, 300, 64, 8, False, I8, I16, "unaligned"),
    (2, 64, 300, 4, True, I8, I16, "unaligned"),
    (2, 7, 64, 10, False, I8, I16, "rows2d")])
def test_fxp_kernel_equals_plain(L, M, K, N, transposed, adt, bdt, view):
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(N)

    def ints(shape, dtype):
        info = torch.iinfo(dtype)
        return torch.randint(info.min, info.max + 1, shape, generator=g,
                             device=dev).to(dtype)

    shape = (L, K, M) if transposed else (L, M, K)
    if view == "unaligned":
        shape = shape[:-1] + (shape[-1] + 1,)
    a = ints(shape, adt)
    a = a[..., 1:] if view == "unaligned" else a
    a = a.transpose(-1, -2) if transposed else a
    a = a[0] if view == "rows2d" else a
    b = ints((L, K, N) if N % 2 else (K, N), bdt)
    b = b[0] if view == "rows2d" and b.dim() == 3 else b
    if view == "unaligned":
        assert fxp_route(a).endswith("elements")
    before = fxp_matmul.launches
    got = fxp_matmul(a, b)
    assert fxp_matmul.launches == before + 1
    assert torch.equal(got, ref.fxp_matmul_ref(a, b, k_chunk=4096))


def test_lut_kernel_equals_plain_on_ties_and_out_of_range():
    dev = require_cuda()
    t = lut.sigmoid_lut(device=dev)
    step = torch.tensor(t.step, dtype=torch.float32)
    mids = (torch.arange(1023, dtype=torch.float32) + 0.5) * step + t.x_min
    edge = torch.tensor([-100.0, 100.0, -8.0, 8.0, float("inf"),
                         -float("inf"), float("nan")])
    x = torch.cat([mids, torch.nextafter(mids, mids + 1), edge]).to(dev)
    x = torch.cat([x, torch.randn(1_000_003, device=dev) * 6])
    before = lut_activation.launches
    got = lut_activation(x, t.table, x_min=t.x_min, x_max=t.x_max)
    assert lut_activation.launches == before + 1
    assert torch.equal(got, ref.lut_activation_ref(x, t.table, t.x_min,
                                                   t.x_max))


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("workload", [
    LogReg(lr=0.5, precision="int8", sigmoid="lut"),
    LogReg(lr=0.5, precision="int16", sigmoid="lut"),
    LinReg(lr=0.1, precision="int8")])
def test_small_fit_equals_its_plain_twin(workload, k):
    dev = require_cuda()
    gen = torch.Generator(device=dev).manual_seed(3)
    make = (datasets.binary_classification if isinstance(workload, LogReg)
            else datasets.regression)
    X, y, _ = make(gen, 8 * 512 + 3, 32)
    grid = make_grid(8)
    a = api.fit(workload, grid, X, y, steps=6, merge_every=k)
    with dispatch.use_kernels(False):
        b = api.fit(workload, grid, X, y, steps=6, merge_every=k)
    assert torch.equal(a.state, b.state)
    for m, n in zip(a.history, b.history):
        assert torch.equal(m["loss"], n["loss"])


def _mass(xf, assign, w, K):
    """Σ w·|x| per (lane, cluster, feature) in float64: the scale of a
    cluster sum, against which two summation orders are compared."""
    onehot = (assign.long()[..., None] == torch.arange(K, device=xf.device)
              ).double() * w.double()[..., None]
    return onehot.transpose(-1, -2) @ xf.abs().double()


def _km_inputs(dev, L, R, D, K, per_lane, dtype, *, seed):
    """Rows (float32, or int16/int8 with per-feature scales), centroids
    drawn from the rows (shared, or per lane), a 0/1 mask, and the rows
    in float32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xf = torch.randn((L, R, D), generator=g, device=dev) * 2
    scale = None
    if dtype == torch.float32:
        x = xf
    else:
        info = torch.iinfo(dtype)
        x = torch.randint(info.min, info.max + 1, (L, R, D), generator=g,
                          device=dev).to(dtype)
        scale = torch.rand(D, generator=g, device=dev) / info.max + 1e-4
        xf = x.float() * scale
    c = xf[0, :K].clone()
    if per_lane:
        c = c + 0.1 * torch.randn((L, K, D), generator=g, device=dev)
    w = (torch.rand((L, R), generator=g, device=dev) < 0.9).float()
    return x, c, w, scale, xf


def _assert_km_equals_plain(x, c, w, scale, xf):
    """Assignments and counts bit-equal to the plain version, sums and sse
    within 1e-5 of their mass (another summation order), and a second
    launch bit-equal to the first; returns the assignments."""
    K = c.shape[-2]
    before = kmeans_assign.launches
    got = kmeans_assign(x, c, w, scale, return_assign=True)
    assert kmeans_assign.launches == before + 1
    want = ref.kmeans_assign_ref(x, c, w, scale, return_assign=True)
    assert torch.equal(got[3], want[3]) and torch.equal(got[1], want[1])
    mass = _mass(xf, want[3], w, K)
    assert ((got[0].double() - want[0].double()).abs()
            <= 1e-5 * mass + 1e-30).all()
    sse_mass = (want[2].double().abs() + 1.0)
    assert ((got[2].double() - want[2].double()).abs()
            <= 1e-5 * sse_mass).all()
    again = kmeans_assign(x, c, w, scale, return_assign=True)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    return got[3]


# (L, R, D, K): the path's per-lane widths, ragged rows and odd D, a wide
# D with many clusters; one cluster and 64 at D = 16 (one statistics
# group a warp), the shared-memory rows (D = 64) with R a multiple of no
# round of the block, rows of more than 32 quads, and the path's 256 lanes
@pytest.mark.parametrize("L,R,D,K", [(4, 65536, 16, 8), (3, 1001, 5, 3),
                                     (2, 777, 33, 17), (3, 5000, 16, 1),
                                     (2, 4099, 16, 64), (3, 1237, 64, 8),
                                     (2, 300, 130, 3), (256, 2000, 16, 8)])
@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16, torch.int8])
def test_kmeans_kernel_equals_plain(L, R, D, K, per_lane, dtype):
    """Assignments and counts bit-equal to the plain version, sums and sse
    within 1e-5 of their mass (another summation order), and a second
    launch bit-equal to the first."""
    dev = require_cuda()
    _assert_km_equals_plain(*_km_inputs(dev, L, R, D, K, per_lane, dtype,
                                        seed=L * R + D))


def test_kmeans_kernel_one_cluster_int8():
    """Every row of a lane in one cluster, int8 rows of one sign: the
    longest chain of additions into one cell, of values that repeat
    thousands of times."""
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(11)
    L, R, D, K = 4, 65536, 16, 8
    x = torch.randint(0, 128, (L, R, D), generator=g, device=dev
                      ).to(torch.int8)
    scale = torch.rand(D, generator=g, device=dev) / 127 + 1e-4
    xf = x.float() * scale
    c = xf.mean(1, keepdim=True) + torch.zeros((L, K, D), device=dev)
    c[:, 1:] += 1e3
    w = torch.ones((L, R), device=dev)
    assign = _assert_km_equals_plain(x, c, w, scale, xf)
    assert bool((assign == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.int16, torch.int8])
def test_kmeans_kernel_unaligned_rows(dtype):
    """Rows 17 elements apart and a base off the 16-byte grid take the
    element-by-element loads, with the assignments returned."""
    dev = require_cuda()
    x, c, w, scale, xf = _km_inputs(dev, 3, 3001, 17, 6, False, dtype,
                                    seed=17)
    assert x[..., 1:].data_ptr() % 16 and x.stride(1) == 17
    _assert_km_equals_plain(
        x[..., 1:], c[:, 1:].contiguous(), w,
        scale[1:].contiguous() if scale is not None else None, xf[..., 1:])


def test_kmeans_kernel_takes_an_expanded_centroid_view():
    dev = require_cuda()
    x = torch.randn((5, 300, 4), device=dev)
    w = torch.ones((5, 300), device=dev)
    c = torch.randn((3, 4), device=dev)
    a = kmeans_assign(x, c, w)
    b = kmeans_assign(x, c.expand(5, 3, 4), w)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


# (L, R, F, n_nodes, n_bins, n_classes, W): the bins are the first F of W
# columns.  Depth 0 and the final pass of the full tree with few lanes
# (rows cut into chunks, bulk reduce-adds) and at full lane width (every
# lane one block a tile: the contended 1-node pass, three tiles at 64
# nodes), a ragged case, histograms larger than a block (chunked; and
# stored, F = 40 and F = 200), F = 1 and F = 17, rows not a multiple of a
# block's, and rows read as one 16-byte load though narrower than it:
# views of 7 of 16 columns (uint8 and int16) and of 5 of 8 (int16), and
# int16 rows of 8 bins
@pytest.mark.parametrize("L,R,F,nodes,bins,classes,W", [
    (4, 65536, 16, 1, 32, 4, 16), (4, 65536, 16, 64, 32, 4, 16),
    (256, 65536, 16, 1, 32, 4, 16), (256, 65536, 16, 64, 32, 4, 16),
    (3, 1001, 7, 3, 9, 5, 7), (2, 5000, 40, 96, 16, 3, 40),
    (160, 3001, 40, 96, 16, 3, 40), (160, 3001, 200, 96, 16, 3, 200),
    (160, 3001, 1, 8, 32, 4, 1), (160, 3001, 17, 8, 32, 4, 17),
    (3, 100003, 16, 16, 32, 4, 16), (160, 3001, 7, 8, 32, 4, 16),
    (3, 100003, 7, 8, 32, 4, 16), (160, 3001, 5, 8, 32, 4, 8),
    (160, 3001, 8, 8, 32, 4, 8)])
@pytest.mark.parametrize("lane_step", [1, 2])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int16, torch.uint8])
def test_split_hist_kernel_equals_plain(L, R, F, nodes, bins, classes, W,
                                        lane_step, dtype):
    """Bit-equal to the plain version, on lane-strided views and views of
    the first F of W columns too, with out-of-range indices (also in the
    columns left out) and masked rows; a second launch bit-equal."""
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(R + F + nodes)
    Lx = L * lane_step
    node = torch.randint(0, nodes, (Lx, R), generator=g, device=dev,
                         dtype=torch.int32)
    xbin = torch.randint(0, bins + 2 * (W > F), (Lx, R, W), generator=g,
                         device=dev, dtype=torch.int32)
    xbin[..., :F].clamp_(max=bins - 1)
    y = torch.randint(0, classes, (Lx, R), generator=g, device=dev,
                      dtype=torch.int32)
    w = (torch.rand((Lx, R), generator=g, device=dev) < 0.9).float()
    node[0, :3], xbin[-1, :3, 0], y[0, 3:6] = nodes, bins, -1
    args = [t[::lane_step] for t in (node, xbin.to(dtype)[..., :F], y, w)]
    size = args[1].element_size()
    assert split_hist_mod.row_vectors(args[1]) == int(
        F * size <= 16 and W * size % 16 == 0)
    _assert_sh_equals_plain(args, nodes, bins, classes)


def _assert_sh_equals_plain(args, nodes, bins, classes):
    before = split_hist.launches
    got = split_hist(*args, n_nodes=nodes, n_bins=bins, n_classes=classes)
    assert split_hist.launches == before + 1
    want = ref.split_hist_ref(*args, n_nodes=nodes, n_bins=bins,
                              n_classes=classes)
    assert torch.equal(got, want)
    assert torch.equal(got, split_hist(*args, n_nodes=nodes, n_bins=bins,
                                       n_classes=classes))


@pytest.mark.parametrize("L,nodes", [(4, 16), (160, 4)])
def test_split_hist_kernel_uint8_rows_off_the_16_byte_grid(L, nodes):
    """A ``[..., 1:]`` view of uint8 bins (each row starts one byte past
    the 16-byte grid) takes element loads and counts the same."""
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(L)
    R = 3001
    node = torch.randint(0, nodes, (L, R), generator=g, device=dev,
                         dtype=torch.int32)
    xbin = torch.randint(0, 32, (L, R, 17), generator=g, device=dev,
                         dtype=torch.int32).to(torch.uint8)[..., 1:]
    y = torch.randint(0, 4, (L, R), generator=g, device=dev,
                      dtype=torch.int32)
    w = (torch.rand((L, R), generator=g, device=dev) < 0.9).float()
    _assert_sh_equals_plain([node, xbin, y, w], nodes, 32, 4)


@pytest.mark.parametrize("L", [4, 256])
def test_split_hist_kernel_other_weights(L):
    """Weights other than 0/1 take the float path; dyadic weights keep
    every sum exact whatever the order of the adds, so it is bit-equal
    too."""
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(L + 1)
    R = 5000
    node = torch.randint(0, 4, (L, R), generator=g, device=dev,
                         dtype=torch.int32)
    xbin = torch.randint(0, 32, (L, R, 16), generator=g, device=dev,
                         dtype=torch.int32).to(torch.uint8)
    y = torch.randint(0, 4, (L, R), generator=g, device=dev,
                      dtype=torch.int32)
    scale = torch.tensor([0.0, 0.5, 1.0, 2.0], device=dev)
    w = scale[torch.randint(0, 4, (L, R), generator=g, device=dev)]
    _assert_sh_equals_plain([node, xbin, y, w], 4, 32, 4)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("precision", ["fp32", "int16", "int8"])
def test_small_kmeans_fit_near_its_plain_twin(precision, k):
    """Counts are exact and the sums differ only in summation order, so
    the centroids agree within atol 1e-4, rtol 1e-5.  The fits start near
    the blobs' centres, so no centroid boundary runs through a blob
    (where a row would flip on a 1-ulp difference)."""
    dev = require_cuda()
    gen = torch.Generator(device=dev).manual_seed(5)
    X, _, centers = datasets.blobs(gen, 8 * 512 + 3, 16, 8)
    program = KMeans(k=8, precision=precision).bind(make_grid(8), X)
    program.state0 = centers + 0.1 * torch.randn(
        centers.shape, generator=gen, device=dev)
    a = program.fit(steps=6, merge_every=k)
    with dispatch.use_kernels(False):
        b = program.fit(steps=6, merge_every=k)
    torch.testing.assert_close(a.state, b.state, atol=1e-4, rtol=1e-5)
    c = program.fit(steps=6, merge_every=k, engine="python")
    assert torch.equal(a.state, c.state)


def test_small_tree_equals_its_plain_twin():
    dev = require_cuda()
    gen = torch.Generator(device=dev).manual_seed(6)
    X, y = datasets.mixture_classification(gen, 8 * 1024 + 5, 16, 4)
    grid = make_grid(8)
    wl = DecisionTree(max_depth=6, n_bins=32, n_classes=4)
    a = api.fit(wl, grid, X, y, steps=6)
    with dispatch.use_kernels(False):
        b = api.fit(wl, grid, X, y, steps=6)
    for field in ("feature", "threshold", "leaf_value", "bin_edges"):
        assert torch.equal(getattr(a.state, field), getattr(b.state, field))


# flash_attention against its plain version (the same online softmax with
# p in float32): float32 within atol 2e-5 (summation order); bf16 within
# atol = rtol = 1e-2, one bf16 ulp of the output, and at least 99 % of the
# outputs bit-equal (another summation order, tile width, and p carried as
# two bf16 terms to 2^-16 move an output across a bf16 rounding boundary
# now and then); two launches bit-equal.
FLASH_TOL = {torch.float32: dict(atol=2e-5, rtol=0),
             torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
FLASH_BIT_EQUAL = 0.99


def _flash_inputs(dev, B, H, Kh, S, D, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    # the model's (B, S, H, D) layout, read as (B, H, S, D) views
    q, k, v = (torch.randn((B, S, h, D), generator=g, device=dev
                           ).to(dtype).transpose(1, 2)
               for h in (H, Kh, Kh))
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,Kh,S,D,causal", [
    (2, 2, 1, 128, 32, True),        # the smoke config's heads
    (1, 14, 2, 1024, 64, True),      # qwen2-0.5b's heads
    (2, 14, 2, 1000, 64, True),      # ragged S
    (1, 3, 1, 1, 64, True),          # one position
    (2, 14, 2, 77, 64, False),
    (1, 8, 1, 512, 128, False),      # MQA, D = 128
    (1, 4, 2, 200, 128, True),
    (2, 16, 1, 300, 128, True),      # G = 16: qwen3-moe's group
    (1, 32, 2, 129, 64, False)])
def test_flash_kernel_equals_plain(B, H, Kh, S, D, causal, dtype):
    dev = require_cuda()
    q, k, v = _flash_inputs(dev, B, H, Kh, S, D, dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, H, S, D)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, **FLASH_TOL[dtype])
    assert torch.equal(got, flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("B,H,Kh,S,D,causal", [
    (4, 14, 2, 1024, 64, True),              # qwen2-0.5b's heads (wgmma)
    (2, 14, 2, 1000, 64, True),              # ragged S
    (1, 8, 1, 512, 128, False),              # MQA, D = 128
    (1, 4, 2, 200, 128, True),
    (2, 2, 1, 128, 32, True),                # the D = 32 route (mma.sync)
    (2, 4, 2, 1000, 32, True)])
def test_flash_bf16_kernel_bit_equal_share(B, H, Kh, S, D, causal):
    """Each bf16 kernel against the float32-p plain version: at least
    FLASH_BIT_EQUAL of the outputs bit-equal, all within one ulp."""
    dev = require_cuda()
    q, k, v = _flash_inputs(dev, B, H, Kh, S, D, torch.bfloat16, seed=2)
    got = flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert float((got == want).float().mean()) >= FLASH_BIT_EQUAL
    torch.testing.assert_close(got, want, **FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("D", [64, 128])
def test_flash_bf16_takes_the_wgmma_kernel(D):
    """bf16 at D = 64 and 128 launches flash_wgmma_kernel, as the
    profiler names it, and no other flash kernel."""
    dev = require_cuda()
    from torch.profiler import ProfilerActivity, profile
    q, k, v = _flash_inputs(dev, 1, 4, 2, 256, D, torch.bfloat16)
    assert route(torch.bfloat16, D) == "wgmma"
    flash_attention(q, k, v)                         # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flash_attention(q, k, v)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if "flash_" in e.key]
    assert names and all("flash_wgmma_kernel" in n for n in names), names


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_reads_a_packed_view(dtype):
    """q, k and v sliced from one packed (B, S, H + 2 Kh, D) tensor: no
    copy, the same values as contiguous inputs."""
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    packed = torch.randn((2, 300, 18, 64), generator=g, device=dev
                         ).to(dtype).transpose(1, 2)
    q, k, v = packed[:, :14], packed[:, 14:16], packed[:, 16:]
    got = flash_attention(q, k, v)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, want)
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v),
                               **FLASH_TOL[dtype])


def test_flash_kernel_raises_on_what_it_does_not_take():
    """On the card an unsupported dtype, head dim or layout raises; it
    never runs the plain version instead."""
    dev = require_cuda()
    q, k, v = _flash_inputs(dev, 1, 2, 1, 64, 64, torch.float32)
    before = flash_attention.launches
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):                    # head dim 48
        flash_attention(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError):                    # D not unit-stride
        flash_attention(*(t.transpose(-1, -2) for t in
                          _flash_inputs(dev, 1, 2, 1, 64, 64,
                                        torch.float32)))
    odd = torch.zeros((1, 64, 2 * 64 + 1), device=dev)[..., 1:]
    with pytest.raises(ValueError):                    # rows not 16-byte
        flash_attention(odd.view(1, 64, 2, 64).transpose(1, 2), k, v)
    assert flash_attention.launches == before


def _small_lm(dev, dtype):
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"), dtype=dtype)
    model = build(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    params = model.init(gen)
    toks = torch.randint(0, cfg.vocab_size, (3, 130), generator=gen,
                         device=dev)
    return cfg, model, params, toks


def test_prefill_launches_flash_once_per_layer():
    dev = require_cuda()
    cfg, model, params, toks = _small_lm(dev, "float32")
    flash_attention.launches = 0
    model.prefill(params, {"tokens": toks})
    assert flash_attention.launches == cfg.n_layers
    cache = model.init_cache(3, 4)
    for t in range(4):                 # decode stays on the plain mha
        model.decode_step(params, cache, toks[:, t:t + 1], t)
    assert flash_attention.launches == cfg.n_layers


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_small_prefill_near_its_plain_twin(dtype, tol):
    """The kernel path's last logits against the use_kernels(False) twin's,
    within tol * max|logit| (float32: summation order through two layers;
    bf16: a one-ulp difference in one attention output re-rounds through
    the rest of the stack)."""
    dev = require_cuda()
    _, model, params, toks = _small_lm(dev, dtype)
    got = model.prefill(params, {"tokens": toks}).float()
    with dispatch.use_kernels(False):
        want = model.prefill(params, {"tokens": toks}).float()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


# the backward kernel against its plain version on the same q, k, v, o,
# dO and lse (the kernel forward's): float32 within 2e-5 of max|grad|
# (summation order), bf16 within 1e-2 (p and ds rounded once to bf16 as
# mma operands; the plain version keeps them in float32); max|grad| over
# dq, dk and dv
FLASH_BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


def _flash_bwd_case(dev, B, H, Kh, S, D, causal, dtype, seed=4):
    q, k, v = _flash_inputs(dev, B, H, Kh, S, D, dtype, seed)
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    do = torch.randn((B, S, H, D), generator=g, device=dev).to(
        dtype).transpose(1, 2)
    return q, k, v, o, do, lse


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,Kh,S,D,causal", [
    (2, 2, 2, 130, 32, True),        # G = 1, D = 32, ragged S
    (2, 4, 2, 128, 32, False),
    (1, 14, 2, 1000, 64, True),      # qwen2-0.5b's heads (G = 7), ragged
    (2, 14, 2, 256, 64, False),
    (1, 8, 4, 200, 128, True),       # G = 2, D = 128
    (1, 8, 1, 64, 128, False),
    (1, 3, 1, 1, 64, True),          # one position
    # the wgmma schedule's edges: one position, one short of and one past
    # a 128-row block, a ragged last 128-key tile; the group sum skipped
    # (G = 1) and taken (G = 2, 7); causal and full at D = 64 and 128
    (2, 2, 2, 1, 128, True),
    (1, 4, 2, 127, 64, True),
    (1, 4, 4, 129, 128, True),
    (1, 7, 1, 129, 64, False),
    (2, 14, 2, 300, 64, True),
    (1, 4, 2, 300, 128, False),
    (1, 2, 2, 300, 64, False),
    # G = 16 (qwen3-moe's group): 16 partials a KV head in the group sum
    (2, 16, 1, 300, 128, True),
    (1, 32, 2, 129, 64, False),
    (4, 14, 2, 2048, 64, True)])     # qwen2-0.5b's training shape
def test_flash_bwd_kernel_equals_plain(B, H, Kh, S, D, causal, dtype):
    dev = require_cuda()
    if dtype == torch.bfloat16 and D in (64, 128):
        assert bwd_route(dtype, D) == "wgmma"
    q, k, v, o, do, lse = _flash_bwd_case(dev, B, H, Kh, S, D, causal, dtype)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    assert flash_attention_bwd.launches == before + 1
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal)
    scale = max(float(w.float().abs().max()) for w in want)
    for a, w in zip(got, want):
        assert a.dtype == dtype and a.shape == w.shape
        assert bool(torch.isfinite(a).all())
        assert float((a.float() - w.float()).abs().max()) <= \
            FLASH_BWD_TOL[dtype] * scale
    again = flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 32),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 128),
                                     (torch.float32, 64)])
def test_flash_forward_with_lse_equals_forward_without(dtype, D):
    """Each route's output with lse is the output without it, bit for
    bit, and its lse is the plain version's within 1e-5 (relative)."""
    dev = require_cuda()
    q, k, v = _flash_inputs(dev, 2, 4, 2, 300, D, dtype)
    o, lse = flash_attention(q, k, v, return_lse=True)
    assert torch.equal(o, flash_attention(q, k, v))
    _, want = ref.flash_attention_ref(q, k, v, return_lse=True)
    torch.testing.assert_close(lse, want, atol=0.0, rtol=1e-5)


def test_flash_bwd_kernel_raises_without_counting():
    """float16 inputs raise on the card, and the counter does not move."""
    dev = require_cuda()
    q, k, v, o, do, lse = _flash_bwd_case(dev, 1, 2, 1, 64, 64, True,
                                          torch.float32)
    before = flash_attention_bwd.launches
    with pytest.raises(TypeError):
        flash_attention_bwd(q.half(), k.half(), v.half(), o.half(),
                            do.half(), lse)
    with pytest.raises(ValueError):                    # head dim 48
        flash_attention_bwd(q[..., :48], k[..., :48], v[..., :48],
                            o[..., :48], do[..., :48], lse)
    assert flash_attention_bwd.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_small_training_step_near_its_plain_twin(dtype):
    """The smoke qwen2's loss gradients on the card: one forward and one
    backward flash launch a layer, every leaf within 1e-4 of its max|g| of
    the use_kernels(False) twin in float32 (summation order), the
    gradients' relative L2 gap under 5e-2 in bf16 (one-ulp attention
    outputs and bf16 p and ds re-rounded through the stack)."""
    from repro_torch.launch.train import loss_and_grads, make_step_fn
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_leaves

    dev = require_cuda()
    cfg, model, params, toks = _small_lm(dev, dtype)

    def grads():
        loss, _, g = loss_and_grads(model, params, {"tokens": toks})
        return loss, tree_leaves(g)

    flash_attention.launches = flash_attention_bwd.launches = 0
    loss, got = grads()
    assert flash_attention.launches == flash_attention_bwd.launches == \
        cfg.n_layers
    with dispatch.use_kernels(False):
        twin_loss, want = grads()
    torch.testing.assert_close(loss, twin_loss, atol=0.0, rtol=1e-2)
    if dtype == "float32":
        for a, w in zip(got, want):
            assert float((a - w).abs().max()) <= 1e-4 * float(w.abs().max())
    else:
        num = sum(float((a.float() - w.float()).norm()) ** 2
                  for a, w in zip(got, want))
        den = sum(float(w.float().norm()) ** 2 for w in want)
        assert (num / den) ** 0.5 < 5e-2
    opt = adamw(3e-4)
    state, met = make_step_fn(model, opt)(
        {"params": params, "opt": opt.init(params)}, {"tokens": toks})
    assert bool(torch.isfinite(met["loss"]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,S,D", [(2, 6, 1500, 64), (1, 2, 77, 32),
                                     (1, 4, 300, 128)])
def test_flash_function_full_attention_gradient(B, H, S, D, dtype):
    """The ``FlashAttention`` Function without the causal mask (an
    encoder's self-attention, whisper's heads at its 1,500 frames, a
    ragged S): one forward and one backward launch, the gradients of q, k
    and v within FLASH_BWD_TOL of max|grad| of the use_kernels(False)
    twin's (the plain forward and backward)."""
    dev = require_cuda()
    q, k, v = _flash_inputs(dev, B, H, H, S, D, dtype, seed=6)
    g = torch.Generator(device=dev).manual_seed(7)
    do = torch.randn((B, S, H, D), generator=g, device=dev).to(dtype)

    def grads():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = dispatch.flash_attention(*(t.transpose(1, 2) for t in leaves),
                                       causal=False)
        return torch.autograd.grad(out, leaves, do)

    flash_attention.launches = flash_attention_bwd.launches = 0
    got = grads()
    assert flash_attention.launches == flash_attention_bwd.launches == 1
    with dispatch.use_kernels(False):
        want = grads()
    scale = max(float(w.float().abs().max()) for w in want)
    for a, w in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert float((a.float() - w.float()).abs().max()) <= \
            FLASH_BWD_TOL[dtype] * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_small_whisper_near_its_plain_twin(dtype):
    """The whisper-tiny smoke model on the card: the prefill launches the
    flash kernel once a layer (full in the encoder, causal in the
    decoder), ``generate`` once an encoder layer (the decode replays
    none); the last logits within 1e-4 (float32) or 3e-2 (bf16) x
    max|logit| of the use_kernels(False) twin, and the loss's gradients,
    a forward and a backward launch a layer, within 1e-4 of each leaf's
    max|g| (float32) or a relative L2 gap under 5e-2 (bf16), as the
    qwen2 smoke model's."""
    from repro_torch.launch.serve_lm import generate
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.tree import tree_flatten_with_names

    dev = require_cuda()
    cfg = dataclasses.replace(get_smoke_config("whisper-tiny"), dtype=dtype)
    model = build(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    params = model.init(gen)
    toks = torch.randint(0, cfg.vocab_size, (3, 40), generator=gen,
                         device=dev)
    frames = torch.randn((3, cfg.encoder.n_ctx, cfg.d_model), generator=gen,
                         device=dev)
    batch = {"tokens": toks, "frames": frames}
    layers = cfg.encoder.n_layers + cfg.n_layers
    flash_attention.launches = 0
    got = model.prefill(params, batch).float()
    assert flash_attention.launches == layers
    with dispatch.use_kernels(False):
        want = model.prefill(params, batch).float()
    tol = 1e-4 if dtype == "float32" else 3e-2
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())
    flash_attention.launches = 0
    res = generate(model, params, toks[:, :6], 4, frames)
    assert flash_attention.launches == cfg.encoder.n_layers
    assert res.tokens.shape == (3, 4)

    def grads():
        loss, _, g = loss_and_grads(model, params, batch)
        return loss, tree_flatten_with_names(g)

    flash_attention.launches = flash_attention_bwd.launches = 0
    loss, (names, got) = grads()
    assert flash_attention.launches == flash_attention_bwd.launches == layers
    with dispatch.use_kernels(False):
        twin_loss, (_, want) = grads()
    torch.testing.assert_close(loss, twin_loss, atol=0.0, rtol=1e-2)
    if dtype == "float32":
        top = max(float(w.abs().max()) for w in want)
        for name, a, w in zip(names, got, want):
            # a key bias's true gradient is 0 (q·bk shifts every score of
            # a query alike): rounding noise on both sides, held against
            # the tree's largest gradient
            scale = top if name.endswith("['bk']") else float(w.abs().max())
            assert float((a - w).abs().max()) <= 1e-4 * scale, name
    else:
        num = sum(float((a.float() - w.float()).norm()) ** 2
                  for a, w in zip(got, want))
        den = sum(float(w.float().norm()) ** 2 for w in want)
        assert (num / den) ** 0.5 < 5e-2


# (a dtype, b dtype, N, per-lane b): N = 1, 4, 8, 10, 16 and 20 (a
# launch per 16 columns), int8 and int16 a and b
@pytest.mark.parametrize("adt,bdt,N,per_lane", [
    (I8, I16, 1, False), (I8, I16, 4, True), (I8, I16, 5, False),
    (I8, I16, 8, True), (I8, I16, 10, False), (I8, I16, 16, True),
    (I8, I16, 20, False), (I8, I8, 1, True), (I8, I8, 9, False),
    (I8, I8, 16, True), (I8, I8, 20, True), (I16, I16, 1, False),
    (I16, I16, 10, True), (I16, I16, 16, False), (I16, I16, 20, True),
    (I16, I8, 4, True), (I16, I8, 9, False)])
def test_wide_hybrid_matmul_equals_plain(adt, bdt, N, per_lane):
    """Bit-equal to ``use_kernels(False)`` (``hybrid_dot``), forward and
    the gradient's transposed view, with ``hybrid_launches`` launches."""
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(N)

    def ints(shape, dtype):
        info = torch.iinfo(dtype)
        return torch.randint(info.min, info.max + 1, shape, generator=g,
                             device=dev).to(dtype)

    L, R, d = 3, 5000, 64
    X = ints((L, R, d), adt)
    W = ints((L, d, N) if per_lane else (d, N), bdt)
    Rs = ints((L, R, N), bdt)
    for a, b in ((X, W), (X.transpose(-1, -2), Rs)):
        before = fxp_matmul.launches
        got = dispatch.hybrid_matmul(a, b)
        assert fxp_matmul.launches - before == dispatch.hybrid_launches(N)
        with dispatch.use_kernels(False):
            assert torch.equal(got, dispatch.hybrid_matmul(a, b))


def test_lut_kernel_exp_table():
    """The one-sided exp table: -16, 0, midpoints, values below -16 and
    above 0 (the end entries), NaN (entry 0), bit-equal to plain."""
    dev = require_cuda()
    t = lut.exp_lut(device=dev)
    step = torch.tensor(t.step, dtype=torch.float32)
    mids = (torch.arange(1023, dtype=torch.float32) + 0.5) * step + t.x_min
    edge = torch.tensor([-16.0, 0.0, -16.5, -1e30, -float("inf"), 0.5,
                         float("inf"), float("nan")])
    x = torch.cat([mids, edge]).to(dev)
    x = torch.cat([x, -torch.rand(1_000_003, device=dev) * 20])
    got = lut_activation(x, t.table, x_min=t.x_min, x_max=t.x_max)
    assert torch.equal(got, ref.lut_activation_ref(x, t.table, t.x_min,
                                                   t.x_max))


@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 7), (5, 3),
                                        (2 ** 40 + 1, 12)])
def test_default_permutation_same_on_card_and_cpu(seed, epoch):
    dev = require_cuda()
    per = 65536
    on_card = mb.hashed_permutation(seed, torch.tensor(epoch, device=dev),
                                    per)
    on_cpu = mb.hashed_permutation(seed, torch.tensor(epoch), per)
    assert on_card.device.type == "cuda"
    assert torch.equal(on_card.cpu(), on_cpu)
    assert torch.equal(torch.sort(on_cpu).values, torch.arange(per))


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("workload,batch_size", [
    (LinearSVM(lr=0.1, precision="int8"), None),
    (LinearSVM(lr=0.1, precision="int16"), 128),
    (MultinomialLogReg(n_classes=4, precision="int8", softmax="lut"), None),
    (MultinomialLogReg(n_classes=10, precision="int8", softmax="lut"), None),
    (MultinomialLogReg(n_classes=10, precision="int16", softmax="lut"), 128),
    (LogReg(lr=0.5, precision="int8", sigmoid="lut"), 128)])
def test_small_new_fit_equals_its_plain_twin(workload, batch_size, k):
    """The SVM, the multinomial (C = 4 and 10) and minibatch fits with
    kernels on, bit-equal to their ``use_kernels(False)`` twins."""
    dev = require_cuda()
    gen = torch.Generator(device=dev).manual_seed(4)
    if isinstance(workload, MultinomialLogReg):
        X, y = datasets.mixture_classification(gen, 8 * 512 + 3, 32,
                                               workload.n_classes)
    else:
        X, y, _ = datasets.binary_classification(gen, 8 * 512 + 3, 32)
    grid = make_grid(8)
    a = api.fit(workload, grid, X, y, steps=6, merge_every=k,
                batch_size=batch_size)
    with dispatch.use_kernels(False):
        b = api.fit(workload, grid, X, y, steps=6, merge_every=k,
                    batch_size=batch_size)
    assert torch.equal(a.state, b.state)
    for m, n in zip(a.history, b.history):
        assert torch.equal(m["loss"], n["loss"])


@pytest.mark.parametrize("k", [1, 4])
def test_small_minibatch_kmeans_near_its_plain_twin(k):
    """K-means on 128 sampled rows a lane: within atol 1e-4, rtol 1e-5 of
    its plain twin (the full-batch bar), python engine == scan."""
    dev = require_cuda()
    gen = torch.Generator(device=dev).manual_seed(6)
    X, _, centers = datasets.blobs(gen, 8 * 512 + 3, 16, 8)
    program = KMeans(k=8, precision="int16").bind(make_grid(8), X)
    program.state0 = centers + 0.1 * torch.randn(
        centers.shape, generator=gen, device=dev)
    a = program.fit(steps=6, merge_every=k, batch_size=128)
    with dispatch.use_kernels(False):
        b = program.fit(steps=6, merge_every=k, batch_size=128)
    torch.testing.assert_close(a.state, b.state, atol=1e-4, rtol=1e-5)
    c = program.fit(steps=6, merge_every=k, batch_size=128, engine="python")
    assert torch.equal(a.state, c.state)


def test_kernel_launches_charge_the_round_counter():
    """Each launch charges an active ``RoundCounter`` what ``PERF.md``'s
    bound counts (inputs once, outputs once; 2·M·N·K int8 operations a
    limb pair, 4 float32 operations an element for the LUT); the aten ops
    around the launch are the mode's own."""
    from repro_torch.roofline import analysis
    dev = require_cuda()
    gen = torch.Generator(device=dev).manual_seed(8)
    a = torch.randint(-128, 128, (4, 1000, 64), generator=gen,
                      device=dev).to(I8)
    b = torch.randint(-2 ** 15, 2 ** 15, (64, 3), generator=gen,
                      device=dev).to(I16)
    t = lut.sigmoid_lut(device=dev)
    x = torch.randn(4, 1000, device=dev)
    with analysis.RoundCounter() as counter:
        out = fxp_matmul(a, b)
        assert counter.count.ops == {"int8": 2 * a.numel() * 3 * 2}
        assert counter.count.bytes == analysis.nbytes(a, b, out)
        lut_activation(x, t.table, x_min=t.x_min, x_max=t.x_max)
    assert counter.count.ops["fp32"] == 4 * x.numel()
    assert counter.count.bytes == (analysis.nbytes(a, b, out)
                                   + 2 * analysis.nbytes(x)
                                   + analysis.nbytes(t.table))


@pytest.mark.parametrize("preset", ["adaptive", "auto"])
def test_small_controlled_fit_equals_its_plain_twin(preset):
    """``AdaptiveCadence`` and ``AutoTune`` without exploration (both
    deterministic) with kernels on, bit-equal to their
    ``use_kernels(False)`` twins, cadence traces equal; the counted
    round's launches are in the auto fit's."""
    from repro_torch.distributed.merge_plan import (AdaptiveCadence,
                                                    MergePlan)
    from repro_torch.tuning import AutoTune
    dev = require_cuda()
    gen = torch.Generator(device=dev).manual_seed(9)
    X, y, _ = datasets.binary_classification(gen, 8 * 512 + 3, 32)
    wl = LogReg(lr=0.5, precision="int8", sigmoid="lut")
    outer = AdaptiveCadence(k_max=4) if preset == "adaptive" \
        else AutoTune(k_max=4, min_steps_to_explore=10 ** 9)
    plan = MergePlan(outer=outer)
    grid = make_grid(8)
    before = fxp_matmul.launches
    held, twin = {}, {}
    a = api.fit(wl, grid, X, y, steps=20, merge_plan=plan,
                merge_state=held)
    counted = preset == "auto"
    assert fxp_matmul.launches - before == 2 * (20 + counted)
    with dispatch.use_kernels(False):
        b = api.fit(wl, grid, X, y, steps=20, merge_plan=plan,
                    merge_state=twin)
    assert torch.equal(a.state, b.state)
    assert held["cadence_trace"] == twin["cadence_trace"]
    assert max(held["cadence_trace"]) > 1


# -- the mesh on the card ------------------------------------------------------


@pytest.mark.parametrize("cell", sorted(mesh_ref.CARD_CELLS))
def test_mesh_at_hop_one_is_the_grid_on_the_card(cell):
    """A world of one process over NCCL: the (1, 1) mesh's fit equals
    ``make_grid``'s bit for bit (every collective has one participant,
    the compressed hop is ``ef_quantize``)."""
    from repro_torch.core import make_mesh_grid
    from repro_torch.distributed import compression as comp
    from repro_torch.distributed import merge_plan as mp

    dev = require_cuda()
    X, y = mesh_ref.card_case()
    wl = LogReg(lr=0.5, precision="int8", sigmoid="lut")
    plan = mesh_ref.card_plan(mp, comp, cell)
    with single_process_world("nccl"):
        a = api.fit(wl, make_mesh_grid(8, device=dev), X, y, steps=16,
                    merge_plan=plan)
    b = api.fit(wl, make_grid(8, device=dev), X, y, steps=16,
                merge_plan=plan)
    assert torch.equal(a.state, b.state)
    assert all(torch.equal(m["loss"], n["loss"])
               for m, n in zip(a.history, b.history))


def test_cpu_mesh_grid_beside_a_card_reduces():
    """Asked for the CPU on a machine with a card, ``make_mesh_grid``
    starts a gloo world and a CPU mesh, and its reduction runs."""
    import torch.distributed as dist

    from repro_torch.core import make_mesh_grid

    require_cuda()
    assert not dist.is_initialized()
    try:
        grid = make_mesh_grid(8, device="cpu")
        assert dist.get_backend() == "gloo"
        data, _ = grid.shard_rows(torch.arange(16.0)[:, None])
        out = grid.map_reduce(
            lambda _, sl: {"s": (sl["X"][..., 0] * sl["w"]).sum(-1)},
            None, data)
        assert float(out["s"]) == 120.0
    finally:
        dist.destroy_process_group()


def test_two_ranks_share_the_card_over_gloo(tmp_path):
    """Two ranks on the one card (gloo carries the CUDA tensors): the
    replicas are bit-equal, and the exact cells lie within 1e-5 x max|w|
    of ``make_grid``'s fit."""
    from repro_torch.distributed import compression as comp
    from repro_torch.distributed import merge_plan as mp

    dev = require_cuda()
    ranks = mesh_ref.run_world("card_mesh_scenario", 2, str(tmp_path),
                               timeout=240.0)
    X, y = mesh_ref.card_case()
    wl = LogReg(lr=0.5, precision="int8", sigmoid="lut")
    for cell, got in ranks[0].items():
        assert got.tobytes() == ranks[1][cell].tobytes(), cell
        if "int8" in cell:
            continue
        want = api.fit(wl, make_grid(8, device=dev), X, y, steps=16,
                       merge_plan=mesh_ref.card_plan(mp, comp, cell)
                       ).state.cpu().numpy()
        assert abs(got - want).max() <= 1e-5 * abs(want).max(), cell


# -- the compiled engine ------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {}, {"merge_every": 4}, {"batch_size": 64},
    {"merge_plan": "int8-ef"}, {"merge_plan": "overlap-slowmo-k4"}],
    ids=["cadence-1", "cadence-4", "minibatch", "int8-ef", "overlap-slowmo"])
def test_scan_fit_replays_graphs_bit_equal_to_python(kw):
    """On the card ``engine="scan"`` replays captured chunks: bit-equal
    to ``engine="python"`` (state and history), a second fit of the
    program captures nothing, and the replays launch no wrapper call."""
    from repro_torch.core.graphs import Graph
    from repro_torch.distributed import compression as comp
    from repro_torch.distributed import merge_plan as mp

    dev = require_cuda()
    plans = {"int8-ef": mp.MergePlan(compression=comp.CompressionConfig()),
             "overlap-slowmo-k4": mp.MergePlan(cadence=4, overlap=True,
                                               outer=mp.SlowMo())}
    if "merge_plan" in kw:
        kw = {"merge_plan": plans[kw["merge_plan"]]}
    gen = torch.Generator(device=dev).manual_seed(5)
    X, y, _ = datasets.binary_classification(gen, 8 * 512 + 3, 32)
    program = LogReg(lr=0.5, precision="int8", sigmoid="lut").bind(
        make_grid(8), X, y)
    a = program.fit(steps=10, engine="python", **kw)
    b = program.fit(steps=10, scan_chunk=4, **kw)
    before, launches = Graph.captures, fxp_matmul.launches
    c = program.fit(steps=10, scan_chunk=4, **kw)
    assert Graph.captures == before
    if not getattr(kw.get("merge_plan"), "overlap", False):
        # (the overlap's prologue runs eagerly, once a fit)
        assert fxp_matmul.launches == launches
    for res in (b, c):
        assert torch.equal(a.state, res.state)
        for m, n in zip(a.history, res.history, strict=True):
            assert torch.equal(m["loss"], n["loss"])


def test_generate_replays_one_decode_step_a_token():
    """The smoke qwen2 on the card: ``generate``'s tokens equal the eager
    decode's, and its decode launches one graph a token."""
    from repro_torch.launch.serve_lm import DecodeStep, generate

    dev = require_cuda()
    cfg = get_smoke_config("qwen2-0.5b")
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(2))
    prompts = torch.randint(0, cfg.vocab_size, (2, 6), device=dev,
                            generator=torch.Generator(device=dev
                                                      ).manual_seed(3))
    res = generate(model, params, prompts, 5)
    cache = model.init_cache(2, 11)
    for t in range(6):
        logits, cache = model.decode_step(params, cache, prompts[:, t:t + 1],
                                          t)
    tok = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]
    want = [tok]
    for t in range(6, 10):
        logits, cache = model.decode_step(params, cache, tok, t)
        tok = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]
        want.append(tok)
    assert torch.equal(res.tokens, torch.cat(want, 1))
    step = DecodeStep(model, params, 2, 11)
    assert step.graph.pool_bytes is not None


def test_graph_kernel_nodes_count_a_replays_launches():
    """``Graph.kernel_nodes`` of a capture that calls ``fxp_matmul``
    twice and ``lut_activation`` once: two fxp kernel nodes and one LUT
    node, whatever else the capture holds; ``replays`` counts replays."""
    import re

    from repro_torch.core.graphs import Graph

    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(11)
    a = torch.randint(-128, 128, (2, 300, 64), generator=g,
                      device=dev).to(I8)
    b = torch.randint(-2 ** 15, 2 ** 15, (64, 4), generator=g,
                      device=dev).to(I16)
    t = lut.sigmoid_lut(device=dev)

    def fn():
        y = fxp_matmul(a, b) + fxp_matmul(a, b)
        return lut_activation(y * 1e-6, t.table, x_min=t.x_min,
                              x_max=t.x_max)

    graph = Graph(dev)
    graph.warm(fn)
    keep = Graph.keep_nodes
    Graph.keep_nodes = True
    try:
        graph.capture(fn)
    finally:
        Graph.keep_nodes = keep
    for _ in range(3):
        graph.replay()
    nodes = graph.kernel_nodes()
    assert graph.replays == 3 and graph.kernel_nodes() == nodes
    assert sum(bool(re.search(r"fxp_\w+?_kernel", n)) for n in nodes) == 2
    assert sum("lut_kernel" in n for n in nodes) == 1
    assert torch.equal(graph.outputs, fn())


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-2b"])
def test_recurrent_decode_step_on_the_card(arch):
    """The smoke Mamba-2 and recurrentgemma models on the card: the
    captured decode step against the eager decode in lockstep, bit for
    bit, past the ring's wrap, launching none of the port's kernels;
    the decode's last logits near the prefill's (float32, 2e-4)."""
    from repro_torch.launch.serve_lm import DecodeStep

    dev = require_cuda()
    cfg = get_smoke_config(arch)
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(2))
    toks = torch.randint(0, cfg.vocab_size, (2, 16), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    wrappers = (fxp_matmul, lut_activation, kmeans_assign, split_hist,
                flash_attention, flash_attention_bwd)
    before = [fn.launches for fn in wrappers]
    step = DecodeStep(model, params, 2, 16)
    cache = model.init_cache(2, 16)
    for t in range(16):
        logits, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
        assert torch.equal(step(toks[:, t:t + 1]), logits), t
    pre = model.prefill(params, {"tokens": toks})
    assert float((pre - logits).abs().max()) <= 2e-4 * float(
        pre.abs().max())
    assert [fn.launches for fn in wrappers] == before


# ---------------------------------------------------------------------------
# Mixture-of-Experts (models/moe.py) on the card
# ---------------------------------------------------------------------------

MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b")


def _moe_layer(dev, arch, dtype, T, seed=11):
    """The smoke config's MoE parameters and a skewed (T, d) input, so that
    capacity drops pairs."""
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = moe.init_moe(cfg, gen)
    x = (torch.randn((T, cfg.d_model), generator=gen, device=dev)
         + 1.5 * torch.randn(cfg.d_model, generator=gen, device=dev)
         ).to(cfg.compute_dtype)
    return cfg, p, x


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layer_and_decode_step_never_sync(arch):
    """moe_ffn over a batch and a model's decode step (``pos`` on the card)
    under ``set_sync_debug_mode("error")``: the dispatch reads nothing on
    the host, so the decode step can be captured."""
    from repro_torch.models import moe

    dev = require_cuda()
    cfg, p, x = _moe_layer(dev, arch, "bfloat16", 64)
    model = build(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(3))
    cache = model.init_cache(4, 8)
    tok = torch.zeros((4, 1), dtype=torch.long, device=dev)
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = moe.moe_ffn(cfg, p, x.reshape(2, 32, -1))
        logits, _ = model.decode_step(params, cache, tok, pos)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert y.shape == (2, 32, cfg.d_model) and aux.shape == ()
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_backward_twice_bit_equal(arch):
    """Two gradients of one bf16 MoE layer with capacity drops, in x and in
    every parameter, the router's included, bit-equal: no atomics in the
    dispatch or the combine."""
    from repro_torch.models import moe

    dev = require_cuda()
    cfg, p, x = _moe_layer(dev, arch, "bfloat16", 256)
    kept, _ = moe.slots(*moe.route(cfg, p, x)[2:], moe.capacity(cfg, 256),
                        0, cfg.moe.n_experts)
    assert not bool(kept.all())

    def grads():
        leaves = [x.detach().requires_grad_()] + [
            p[k].detach().requires_grad_() for k in sorted(p)]
        y, aux = moe.moe_body(cfg, dict(zip(sorted(p), leaves[1:])),
                              leaves[0], 0, cfg.moe.n_experts)
        loss = y.float().square().mean() + 0.01 * aux
        return torch.autograd.grad(loss, leaves)

    a, b = grads(), grads()
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    router = a[1 + sorted(p).index("router")]
    assert bool(torch.isfinite(router).all()) and float(
        router.abs().max()) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_on_the_card_near_its_cpu_run(arch):
    """The float32 smoke model, at head dim 32 (the kernels take 32, 64
    and 128), its logits on the card (the flash kernels, cuBLAS) within
    1e-4 of max|logit| of the same parameters' CPU run (the plain
    versions): the prefill twin's bar of test_small_prefill; the routes
    of every layer equal."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_map

    dev = require_cuda()
    cfg = dataclasses.replace(get_smoke_config(arch), head_dim=32)
    cpu = build(cfg, "cpu")
    params = cpu.init(5)
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(6))
    with moe.log_routes() as want_routes:
        want = tfm.lm_forward(cfg, params, toks)
    on_card = tree_map(lambda t: t.to(dev), params)
    with moe.log_routes() as got_routes:
        got = tfm.lm_forward(cfg, on_card, toks.to(dev))
    assert len(got_routes) == len(want_routes) == cfg.n_layers
    for (gi, gk), (wi, wk) in zip(got_routes, want_routes):
        assert torch.equal(gi.cpu(), wi) and torch.equal(gk.cpu(), wk)
    gap = float((got.cpu() - want).abs().max())
    assert gap <= 1e-4 * float(want.abs().max())


# ---------------------------------------------------------------------------
# tuned launch layouts (tuning.autotune) and the int32 ops.fxp_matmul
# ---------------------------------------------------------------------------

@pytest.fixture
def tmp_table(tmp_path, monkeypatch):
    """A temp block table, so no stored entry steers a test (and none is
    left at the default path)."""
    from repro_torch.tuning import autotune as at
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    at.reset_cache_for_tests()
    yield at
    at.reset_cache_for_tests()


def _card_candidates(at, dev, kernel, dtype, shape, **kw):
    backend, sms = at._device_info(dev)
    refused = []
    cands = at._candidates(kernel, dtype, shape, backend, sms=sms,
                           refused=refused, **kw)
    assert refused == [] and len(cands) >= 2
    return cands


# (L, M, K, N, a dtype, transposed): the rows route at ragged M, K past
# one 4,096-k chunk (the last block of a tile sums the chunks, with
# counters sized by the launch's groups), N over one launch's 16 columns,
# and the gradient's transposed view
@pytest.mark.parametrize("L,M,K,N,adt,transposed", [
    (3, 1000, 64, 1, I8, False), (2, 5000, 9000, 10, I8, False),
    (2, 3001, 4500, 19, I16, False), (3, 777, 64, 4, I16, False),
    (2, 64, 9000, 10, I8, True)])
def test_every_fxp_candidate_equals_plain(tmp_table, L, M, K, N, adt,
                                          transposed):
    """Every block_m and block_n the tuner offers gives hybrid_dot's
    bits, K over several chunks included."""
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(M + K)
    info = torch.iinfo(adt)
    shape = (L, K, M) if transposed else (L, M, K)
    a = torch.randint(info.min, info.max + 1, shape, generator=g,
                      device=dev).to(adt)
    a = a.transpose(-1, -2) if transposed else a
    b = torch.randint(-32768, 32768, (K, N), generator=g, device=dev
                      ).to(I16)
    want = ref.fxp_matmul_ref(a, b)
    from repro_torch.kernels import fxp_matmul as fxp_mod
    for blocks in _card_candidates(tmp_table, dev, "fxp_matmul", adt,
                                   (L, M, K, N)):
        before = fxp_matmul.launches
        got = fxp_mod.grouped(a, b, **blocks)
        assert fxp_matmul.launches == before + dispatch.hybrid_launches(
            N, blocks["block_n"])
        assert torch.equal(got, want), blocks


@pytest.mark.parametrize("L,R,D,K,dtype", [
    (3, 1001, 5, 3, torch.float32), (4, 65536, 16, 8, torch.int16),
    (2, 4099, 16, 64, torch.int8), (256, 2000, 16, 8, torch.int16)])
def test_every_kmeans_candidate_equals_plain(tmp_table, L, R, D, K, dtype):
    """Assignments and counts bit-equal and sums and sse within 1e-5 of
    their mass at every block_n the tuner offers."""
    dev = require_cuda()
    x, c, w, scale, xf = _km_inputs(dev, L, R, D, K, False, dtype,
                                    seed=L + R)
    want = ref.kmeans_assign_ref(x, c, w, scale, return_assign=True)
    mass = _mass(xf, want[3], w, K)
    for blocks in _card_candidates(tmp_table, dev, "kmeans_assign", dtype,
                                   (L, R, D, K)):
        got = kmeans_assign(x, c, w, scale, return_assign=True, **blocks)
        assert torch.equal(got[3], want[3]) and torch.equal(got[1], want[1])
        assert ((got[0].double() - want[0].double()).abs()
                <= 1e-5 * mass + 1e-30).all(), blocks
        assert ((got[2].double() - want[2].double()).abs()
                <= 1e-5 * (want[2].double().abs() + 1.0)).all(), blocks


@pytest.mark.parametrize("L,R,F,nodes,bins,classes", [
    (4, 65536, 16, 1, 32, 4), (256, 20000, 16, 8, 32, 4),
    (3, 100003, 7, 3, 9, 5), (160, 3001, 40, 96, 16, 3)])
def test_every_split_hist_candidate_equals_plain(tmp_table, L, R, F, nodes,
                                                 bins, classes):
    """The same histogram, bit for bit, at every block_n the tuner offers
    (one block a lane, and the bulk layout's chunks)."""
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(R + nodes)
    node = torch.randint(0, nodes, (L, R), generator=g, device=dev,
                         dtype=torch.int32)
    xbin = torch.randint(0, bins, (L, R, F), generator=g, device=dev,
                         dtype=torch.int32).to(torch.uint8)
    y = torch.randint(0, classes, (L, R), generator=g, device=dev,
                      dtype=torch.int32)
    w = (torch.rand((L, R), generator=g, device=dev) < 0.9).float()
    kw = dict(n_nodes=nodes, n_bins=bins, n_classes=classes)
    want = ref.split_hist_ref(node, xbin, y, w, **kw)
    cands = _card_candidates(tmp_table, dev, "split_hist", torch.uint8,
                             (L, R, F, nodes * bins * classes),
                             n_nodes=nodes)
    for blocks in cands:
        assert torch.equal(split_hist(node, xbin, y, w, **kw, **blocks),
                           want), blocks


@pytest.mark.parametrize("M,K,N", [(1000, 64, 1), (333, 9000, 19),
                                   (5, 7, 3), (4096, 20000, 16)])
def test_ops_fxp_matmul_is_the_int32_product(tmp_table, M, K, N):
    """``ops.fxp_matmul`` on the card equals ``a.int() @ b.int()`` bit for
    bit, K over several chunks (summed in int32) included."""
    dev = require_cuda()
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(M * N)
    a = torch.randint(-128, 128, (M, K), generator=g, device=dev).to(I8)
    b = torch.randint(-128, 128, (K, N), generator=g, device=dev).to(I8)
    got = ops.fxp_matmul(a, b)
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), a.cpu().int() @ b.cpu().int())
    assert torch.equal(got, ref.fxp_matmul_int32_ref(a, b))


def test_ops_entry_points_equal_plain(tmp_table):
    dev = require_cuda()
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((3000, 16), generator=g, device=dev)
    c = x[:8].clone()
    got = ops.kmeans_assign(x, c)
    want = ref.kmeans_assign_ref(x[None], c, torch.ones((1, 3000),
                                                         device=dev))
    assert torch.equal(got[1], want[1][0])
    assert torch.allclose(got[0], want[0][0], rtol=1e-5, atol=1e-4)
    node = torch.randint(0, 4, (3000,), generator=g, device=dev,
                         dtype=torch.int32)
    xbin = torch.randint(0, 32, (3000, 16), generator=g, device=dev,
                         dtype=torch.int32)
    y = torch.randint(0, 4, (3000,), generator=g, device=dev,
                      dtype=torch.int32)
    H = ops.split_hist(node, xbin, y, n_nodes=4, n_bins=32, n_classes=4)
    assert torch.equal(H, ref.split_hist_ref(
        node[None], xbin[None], y[None], torch.ones((1, 3000), device=dev),
        n_nodes=4, n_bins=32, n_classes=4)[0])
    q = torch.randn((2, 4, 300, 64), generator=g, device=dev)
    k = torch.randn((2, 2, 300, 64), generator=g, device=dev)
    v = torch.randn((2, 2, 300, 64), generator=g, device=dev)
    assert (ops.flash_attention(q, k, v) - ref.flash_attention_ref(
        q, k, v, causal=True)).abs().max() <= 2e-5


# -- the sharded path: flash attention through local_map, fake paths ---------

@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 64),
                                     (torch.float32, 64)])
def test_flash_through_local_map_is_bit_equal(dtype, D):
    """``dispatch.flash_attention`` of DTensors on a (1, 1) NCCL mesh
    under ``make_rules`` (each rank's heads by ``local_map``) launches the
    same kernels on the same tensors as the plain call: the output and the
    q, k, v gradients bit for bit, one forward and one backward launch."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.sharding import make_rules, use_rules
    from repro_torch.launch.mesh import make_host_mesh

    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(7)
    B, S, H, Kh = 2, 256, 4, 2
    q, k, v, do = (torch.randn((B, S, h, D), generator=g, device=dev,
                               dtype=dtype)
                   for h in (H, Kh, Kh, H))

    def run(q, k, v, do):
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        out = dispatch.flash_attention(q, k, v, causal=True)
        grads = torch.autograd.grad(out, (q, k, v), do)
        return out, grads

    want, want_g = run(q, k, v, do)
    with single_process_world("nccl"):
        mesh = make_host_mesh(1, 1, device_type="cuda")
        rules = make_rules(mesh, n_heads=H, n_kv_heads=Kh)
        with use_rules(rules):
            place = [distribute_tensor(t, mesh, rules.placements(
                "batch", None, "heads", None), src_data_rank=None)
                for t in (q, k, v, do)]
            before = (flash_attention.launches, flash_attention_bwd.launches)
            got, got_g = run(*place)
            after = (flash_attention.launches, flash_attention_bwd.launches)
    assert after == (before[0] + 1, before[1] + 1)
    assert torch.equal(got.full_tensor(), want)
    for a, b in zip(got_g, want_g):
        assert torch.equal(a.full_tensor(), b)


def test_real_cuda_tensor_never_takes_the_fake_path():
    """A CUDA tensor is not traced: the wrapper launches its kernel (the
    count moves) and returns the plain version's values."""
    from repro_torch.kernels import build as kbuild

    dev = require_cuda()
    x = torch.linspace(-9.0, 9.0, 4099, device=dev)
    table = lut.sigmoid_lut(device=dev)
    assert not kbuild.traced(x, table.table)
    before = lut_activation.launches
    got = lut_activation(x, table.table, x_min=table.x_min,
                         x_max=table.x_max)
    assert lut_activation.launches == before + 1
    assert torch.equal(got, ref.lut_activation_ref(
        x, table.table, table.x_min, table.x_max))
