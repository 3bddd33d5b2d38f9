"""Port parity: ``repro_torch.core.quantize`` and ``hybrid_matmul`` against
the JAX package, bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import quantize as jqz  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro_torch.core import quantize as qz  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from torch_parity import assert_bits_equal, rng, to_torch  # noqa: E402


def _with_ties(bits: int, axis):
    """Random values plus exact .5 ties: one entry of every scale group
    is qmax, so the scale is exactly 1.0 and half-integers stay ties."""
    qmax = 2 ** (bits - 1) - 1
    r = rng(bits)
    x = (r.standard_normal((257, 13)) * qmax / 4).astype(np.float32)
    half = (r.integers(-qmax, qmax, (257, 13)) + 0.5).astype(np.float32)
    x = np.where(r.random((257, 13)) < 0.3, half, x)
    if axis is None:
        x[0, 0] = qmax
    else:
        x[0, :] = qmax
    return x


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("axis", [None, 0])
@pytest.mark.parametrize("ties", [False, True])
def test_quantize_symmetric_bit_exact(bits, axis, ties):
    x = (_with_ties(bits, axis) if ties
         else (rng(1).standard_normal((300, 17)) * 3).astype(np.float32))
    want = jqz.quantize_symmetric(jnp.asarray(x), bits=bits, axis=axis)
    got = qz.quantize_symmetric(to_torch(x), bits=bits, axis=axis)
    assert_bits_equal(got.values, want.values)
    assert_bits_equal(got.scale.reshape(np.shape(want.scale)), want.scale)
    if ties:
        assert np.any(np.abs(x) % 1 == 0.5)


def test_per_lane_quantization_matches_vmap():
    """A lane-batched residual quantizes with one scale per lane, as the
    JAX local step does under vmap."""
    r = (rng(2).standard_normal((8, 75)) * np.arange(1, 9)[:, None]
         ).astype(np.float32)
    want = jax.vmap(lambda v: jqz.quantize_symmetric(v, bits=16))(
        jnp.asarray(r))
    got = qz.quantize_symmetric(to_torch(r), bits=16, axis=-1)
    assert_bits_equal(got.values, want.values)
    assert_bits_equal(got.scale[:, 0], want.scale)


def test_int8_limbs_bit_exact():
    v = np.concatenate([np.array([-32768, 32767, -1, 0, 1, 255, 256, -256,
                                  -129, 128], np.int16),
                        rng(3).integers(-32768, 32768, 500).astype(np.int16)])
    want = jqz.int8_limbs(jnp.asarray(v))
    got = qz.int8_limbs(to_torch(v))
    assert [w for w, _ in got] == [w for w, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert_bits_equal(g, w)
    (_, only), = qz.int8_limbs(to_torch(v.astype(np.int8)))
    assert only.dtype == torch.int16


def _ints(r, shape, dtype):
    info = np.iinfo(dtype)
    return r.integers(info.min, info.max + 1, shape).astype(dtype)


# K = 9000: two full 4096 chunks and a ragged one, with partials large
# enough that float32 rounding depends on the chunk order
@pytest.mark.parametrize("adt,bdt", [(np.int8, np.int16),
                                     (np.int16, np.int16),
                                     (np.int8, np.int8)])
def test_hybrid_dot_and_matmul_bit_exact(adt, bdt):
    r = rng(4)
    a, b = _ints(r, (3, 21, 9000), adt), _ints(r, (9000, 2), bdt)
    want = np.stack([np.asarray(jqz.hybrid_dot(jnp.asarray(x),
                                                jnp.asarray(b)))
                     for x in a])
    assert_bits_equal(qz.hybrid_dot(to_torch(a), to_torch(b)), want)
    assert_bits_equal(dispatch.hybrid_matmul(to_torch(a), to_torch(b)), want)
    # the transposed view (the gradient's X^T), per-lane right operand
    bl = _ints(r, (3, 21, 1), bdt)
    want_t = np.stack([np.asarray(jqz.hybrid_dot(jnp.asarray(x.T),
                                                  jnp.asarray(y)))
                       for x, y in zip(a, bl)])
    got_t = dispatch.hybrid_matmul(to_torch(a).transpose(-1, -2),
                                   to_torch(bl))
    assert_bits_equal(got_t, want_t)


def test_hybrid_matmul_vs_pallas_interpret():
    """The JAX dispatch with its Pallas kernel in interpret mode, small K
    and a small k_chunk so chunking is covered."""
    r = rng(5)
    a, b = _ints(r, (37, 100), np.int16), _ints(r, (100, 3), np.int16)
    want = jdispatch.hybrid_matmul(jnp.asarray(a), jnp.asarray(b),
                                   k_chunk=32)
    got = dispatch.hybrid_matmul(to_torch(a), to_torch(b), k_chunk=32)
    assert_bits_equal(got, want)


def test_kernels_off_path_is_hybrid_dot():
    r = rng(6)
    a, b = _ints(r, (40, 12), np.int16), _ints(r, (12, 3), np.int16)
    with dispatch.use_kernels(False):
        assert not dispatch.kernels_enabled()
        off = dispatch.hybrid_matmul(to_torch(a), to_torch(b))
    assert dispatch.kernels_enabled()
    assert torch.equal(off, dispatch.hybrid_matmul(to_torch(a),
                                                   to_torch(b)))


# every column count up to 20, past the 16 columns one fxp_matmul launch
# takes
@pytest.mark.parametrize("n", range(1, 21))
@pytest.mark.parametrize("adt,bdt", [(np.int8, np.int8), (np.int8, np.int16),
                                     (np.int16, np.int8),
                                     (np.int16, np.int16)])
def test_hybrid_matmul_any_column_count(adt, bdt, n):
    """With kernels on, ``hybrid_matmul`` splits ``b``'s columns into
    launch-sized groups and returns the bits of JAX's
    ``hybrid_matmul`` (its Pallas kernel in interpret mode) for a shared
    ``b``, and of JAX's ``hybrid_dot`` under vmap for a per-lane one;
    K = 40 in chunks of 16 covers the chunk order."""
    r = rng(100 + n)
    a, b = _ints(r, (3, 21, 40), adt), _ints(r, (40, n), bdt)
    assert dispatch.kernels_enabled()
    got = dispatch.hybrid_matmul(to_torch(a[0]), to_torch(b), k_chunk=16)
    assert_bits_equal(got, jdispatch.hybrid_matmul(
        jnp.asarray(a[0]), jnp.asarray(b), k_chunk=16))
    bl = _ints(r, (3, 40, n), bdt)
    want = jax.vmap(lambda x, y: jqz.hybrid_dot(x, y, k_chunk=16))(
        jnp.asarray(a), jnp.asarray(bl))
    assert_bits_equal(dispatch.hybrid_matmul(to_torch(a), to_torch(bl),
                                             k_chunk=16), want)
    # the gradient's layout: a transposed view of the resident rows
    rt = _ints(r, (3, 21, n), bdt)
    want_t = jax.vmap(lambda x, y: jqz.hybrid_dot(x.T, y, k_chunk=16))(
        jnp.asarray(a), jnp.asarray(rt))
    assert_bits_equal(dispatch.hybrid_matmul(
        to_torch(a).transpose(-1, -2), to_torch(rt), k_chunk=16), want_t)


def test_hybrid_launches_counts_column_groups():
    """One launch per group of at most ``MAX_N`` = 16 columns of b,
    whatever the types of a and b: the kernel splits both into limbs."""
    from repro_torch.kernels.fxp_matmul import MAX_N
    assert MAX_N == 16
    count = dispatch.hybrid_launches
    assert [count(n) for n in (1, 4, 5, 8, 10, 16, 17, 20, 32, 33)] == \
        [1, 1, 1, 1, 1, 1, 2, 2, 2, 3]
