"""The port's public kernel entry points (``repro_torch.kernels.ops``) on
the CPU against the JAX package's ``repro.kernels.ops`` (its Pallas
kernels in interpret mode), on the same numpy inputs from a seed:
``fxp_matmul`` (int32) and ``split_hist`` bit for bit, ``kmeans_assign``
within 1e-5, ``lut_activation`` equal but on rounding ties (queue C's
known gap: XLA divides by a reciprocal multiply under jit), and
``flash_attention`` within 2e-5 in float32 at two of JAX's block
settings."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import lut as jlut  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import lut  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from torch_parity import assert_bits_equal, rng, to_torch  # noqa: E402


@pytest.fixture(autouse=True)
def _tables(tmp_path, monkeypatch):
    """Both packages' block tables in temp files: no stored entry steers
    either side."""
    from repro.tuning import autotune as jat
    from repro_torch.tuning import autotune as at
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "jax.json"))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "torch.json"))
    jat.reset_cache_for_tests()
    at.reset_cache_for_tests()
    yield
    jat.reset_cache_for_tests()
    at.reset_cache_for_tests()


@pytest.mark.parametrize("M,K,N", [(33, 57, 19), (4, 8, 3), (70, 4500, 20),
                                   (1, 300, 1)])
def test_fxp_matmul_int32_equals_jax(M, K, N):
    """int8 x int8 -> int32 for any N (a launch a group of columns on the
    card), bit-equal to JAX's Pallas kernel and to the int64 product."""
    r = rng(M + K + N)
    a = r.integers(-128, 128, (M, K)).astype(np.int8)
    b = r.integers(-128, 128, (K, N)).astype(np.int8)
    got = ops.fxp_matmul(to_torch(a), to_torch(b))
    want = np.asarray(jops.fxp_matmul(jnp.asarray(a), jnp.asarray(b)))
    assert want.dtype == np.int32
    assert_bits_equal(got, want)
    np.testing.assert_array_equal(
        got.numpy(), (a.astype(np.int64) @ b.astype(np.int64)))


@pytest.mark.parametrize("N,D,K,weights", [(100, 5, 4, False),
                                           (1000, 16, 8, True),
                                           (257, 3, 1, True)])
def test_kmeans_assign_near_jax(N, D, K, weights):
    r = rng(N + D)
    x = r.standard_normal((N, D)).astype(np.float32) * 2
    c = x[:K].copy() + 0.1 * r.standard_normal((K, D)).astype(np.float32)
    w = (r.random(N) < 0.9).astype(np.float32) if weights else None
    got = ops.kmeans_assign(to_torch(x), to_torch(c),
                            to_torch(w) if weights else None)
    want = jops.kmeans_assign(jnp.asarray(x), jnp.asarray(c),
                              jnp.asarray(w) if weights else None)
    assert [tuple(g.shape) for g in got] == [(K, D), (K,), ()]
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("N,F,nodes,bins,classes,weights", [
    (1001, 7, 3, 9, 5, True), (300, 16, 1, 32, 4, False),
    (2000, 4, 8, 16, 2, True)])
def test_split_hist_equals_jax(N, F, nodes, bins, classes, weights):
    r = rng(N + F + nodes)
    node = r.integers(0, nodes, N).astype(np.int32)
    xbin = r.integers(0, bins, (N, F)).astype(np.int32)
    y = r.integers(0, classes, N).astype(np.int32)
    w = (r.random(N) < 0.9).astype(np.float32) if weights else None
    got = ops.split_hist(to_torch(node), to_torch(xbin), to_torch(y),
                         to_torch(w) if weights else None, n_nodes=nodes,
                         n_bins=bins, n_classes=classes)
    want = jops.split_hist(jnp.asarray(node), jnp.asarray(xbin),
                           jnp.asarray(y),
                           jnp.asarray(w) if weights else None,
                           n_nodes=nodes, n_bins=bins, n_classes=classes)
    assert tuple(got.shape) == (nodes, F, bins, classes)
    assert_bits_equal(got, want)
    # the tree's uint8 bins count the same
    got8 = ops.split_hist(to_torch(node), to_torch(xbin.astype(np.uint8)),
                          to_torch(y), to_torch(w) if weights else None,
                          n_nodes=nodes, n_bins=bins, n_classes=classes)
    assert_bits_equal(got8, want)


def test_lut_activation_equals_jax_but_on_ties():
    """Equal wherever the divide and JAX's jitted reciprocal multiply
    round ``(x - x_min) / step`` to the same index: everywhere but a few
    midpoints of the probe."""
    t, jt = lut.sigmoid_lut(), jlut.sigmoid_lut()
    step = np.float32(jt.step)
    mids = (np.float32(jt.x_min)
            + (np.arange(1000, dtype=np.float32) + np.float32(0.5)) * step)
    r = rng(3)
    x = np.concatenate([mids, r.uniform(-10, 10, 2072).astype(np.float32)]
                       ).reshape(48, 64)
    got = ops.lut_activation(to_torch(x), t.table, x_min=t.x_min,
                             x_max=t.x_max)
    want = np.asarray(jops.lut_activation(jnp.asarray(x), jt.table,
                                          x_min=jt.x_min, x_max=jt.x_max))
    shifted = x - np.float32(jt.x_min)
    by_div = np.clip(np.round(shifted / step), 0, 1023)
    by_mul = np.clip(np.round(shifted * (np.float32(1) / step)), 0, 1023)
    ties = by_div != by_mul
    assert ties.sum() < 64
    np.testing.assert_array_equal(got.numpy()[~ties], want[~ties])
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jt.table)[by_div.astype(int)])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block_q,block_k", [(512, 512), (32, 64)])
def test_flash_attention_near_jax(causal, block_q, block_k):
    """float32 (B, H, S, D) with a GQA group of 2, within 2e-5 of JAX's
    kernel at its default blocks and at smaller ones (the port's route
    fixes its own tiles)."""
    r = rng(11)
    B, H, Kh, S, D = 2, 4, 2, 128, 32
    q = r.standard_normal((B, H, S, D)).astype(np.float32)
    k = r.standard_normal((B, Kh, S, D)).astype(np.float32)
    v = r.standard_normal((B, Kh, S, D)).astype(np.float32)
    got = ops.flash_attention(to_torch(q), to_torch(k), to_torch(v),
                              causal=causal)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=block_q, block_k=block_k))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_entry_points_read_their_blocks(monkeypatch):
    """Each tuned entry point asks ``block_shapes`` with a one-lane key,
    as JAX's asks with its shape."""
    from repro_torch.tuning import autotune as at
    asked = []
    real = at.block_shapes

    def spy(kernel, dtype, shape, *args, **kw):
        asked.append((kernel, tuple(shape)))
        return real(kernel, dtype, shape, *args, **kw)

    monkeypatch.setattr(ops._at, "block_shapes", spy)
    a = torch.ones((5, 6), dtype=torch.int8)
    ops.fxp_matmul(a, torch.ones((6, 17), dtype=torch.int8))
    ops.kmeans_assign(torch.ones((9, 3)), torch.zeros((2, 3)))
    ops.split_hist(torch.zeros(9, dtype=torch.int32),
                   torch.zeros((9, 4), dtype=torch.int32),
                   torch.zeros(9, dtype=torch.int32), n_nodes=2, n_bins=3,
                   n_classes=5)
    assert asked == [("fxp_matmul", (1, 5, 6, 17)),
                     ("kmeans_assign", (1, 9, 3, 2)),
                     ("split_hist", (1, 9, 4, 30))]
