"""Port parity: ``repro_torch.core.lut`` and the ``lut_activation`` wrapper
against the JAX package."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import lut as jlut  # noqa: E402
from repro.kernels import lut_activation as jlut_kernel  # noqa: E402
from repro_torch.core import lut  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.lut_activation import lut_activation  # noqa: E402
from torch_parity import assert_bits_equal, rng, to_torch  # noqa: E402


def _probe(n_entries: int = 1024, bound: float = 8.0) -> np.ndarray:
    """Exact midpoints between entries and their float32 neighbours,
    end points, far out-of-range values, and random draws."""
    step = np.float32((2 * bound) / (n_entries - 1))
    mids = (np.arange(n_entries - 1, dtype=np.float32) + np.float32(0.5)) \
        * step + np.float32(-bound)
    near = np.concatenate([mids, np.nextafter(mids, np.float32(np.inf)),
                           np.nextafter(mids, np.float32(-np.inf))])
    edge = np.array([-bound, bound, -100, 100, 0, -np.inf, np.inf, -1e30,
                     1e30, np.nan], np.float32)
    rand = (rng(7).standard_normal(4000) * 6).astype(np.float32)
    return np.concatenate([near, edge, rand])


def test_probe_holds_exact_ties():
    x = _probe()
    x = x[np.isfinite(x)]
    pos = (x - np.float32(-8.0)) / np.float32(16.0 / 1023)
    assert np.sum(pos - np.floor(pos) == 0.5) > 100


def test_sigmoid_table_bytes_equal():
    t, jt = lut.sigmoid_lut(), jlut.sigmoid_lut()
    assert_bits_equal(t.table, jt.table)
    assert (t.x_min, t.x_max, t.step) == (jt.x_min, jt.x_max, jt.step)


def test_index_and_values_bit_exact():
    x = _probe()
    t, jt = lut.sigmoid_lut(), jlut.sigmoid_lut()
    got_idx = lut._index(t, to_torch(x)).to(torch.int32)
    assert_bits_equal(got_idx, jlut._index(jt, jnp.asarray(x)))
    assert_bits_equal(lut.lut_lookup(t, to_torch(x)),
                      jlut.lut_lookup(jt, jnp.asarray(x)))


def test_wrapper_vs_pallas_interpret():
    """The JAX Pallas kernel in interpret mode against the port's wrapper
    (its plain version on the CPU), on a 2-D input.

    The Pallas kernel is jitted, and XLA rewrites its divide by the
    constant ``step`` into a multiply by ``1/step``; ``lut._index`` (and
    the port, on both devices) divides.  The two differ exactly where
    the quotient and the reciprocal product round to different sides of
    a tie — the midpoints of this probe — and nowhere else."""
    x = _probe()[:3072].reshape(48, 64)
    t, jt = lut.sigmoid_lut(), jlut.sigmoid_lut()
    pallas = np.asarray(jlut_kernel.lut_activation(
        jnp.asarray(x), jt.table, x_min=jt.x_min, x_max=jt.x_max,
        interpret=True))
    got = lut_activation(to_torch(x), t.table, x_min=t.x_min, x_max=t.x_max)
    assert torch.equal(dispatch.lut_apply(t, to_torch(x)), got)
    assert_bits_equal(got, jlut.lut_lookup(jt, jnp.asarray(x)))

    step = np.float32(jt.step)
    shifted = x - np.float32(jt.x_min)
    by_div = np.clip(np.round(shifted / step), 0, 1023).astype(np.int64)
    by_mul = np.clip(np.round(shifted * (np.float32(1) / step)), 0,
                     1023).astype(np.int64)
    table = np.asarray(jt.table)
    np.testing.assert_array_equal(pallas, table[by_mul])
    np.testing.assert_array_equal(got.numpy(), table[by_div])
    differ = (by_div != by_mul) & ~np.isnan(x)
    assert 0 < differ.sum() < 64
    np.testing.assert_array_equal(got.numpy()[~differ], pallas[~differ])


def test_interp_and_taylor_within_an_ulp():
    """Not bit-exact by design: XLA may contract the interpolation and
    Horner's rule into fused multiply-adds, PyTorch's CPU kernels do not;
    they agree to a few float32 ulps (|y| <= 1 on the sigmoid's range)."""
    x = np.clip(_probe(), -1e4, 1e4)         # NaN stays NaN in both
    t, jt = lut.sigmoid_lut(), jlut.sigmoid_lut()
    np.testing.assert_allclose(
        lut.lut_lookup_interp(t, to_torch(x)).numpy(),
        np.asarray(jlut.lut_lookup_interp(jt, jnp.asarray(x))),
        rtol=0, atol=2e-7)
    xs = x[np.abs(x) <= 4]
    np.testing.assert_allclose(
        lut.taylor_sigmoid(to_torch(xs)).numpy(),
        np.asarray(jlut.taylor_sigmoid(jnp.asarray(xs))),
        rtol=1e-6, atol=1e-6)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    t = lut.sigmoid_lut()
    x = torch.zeros(8)
    with pytest.raises(TypeError):
        lut_activation(x.double(), t.table, x_min=t.x_min, x_max=t.x_max)
    with pytest.raises(ValueError):
        lut_activation(torch.zeros(4, 4).t(), t.table, x_min=t.x_min,
                       x_max=t.x_max)
    with pytest.raises(ValueError):
        lut_activation(x, t.table[:1], x_min=t.x_min, x_max=t.x_max)


TABLES = {"gelu": (lut.gelu_lut, jlut.gelu_lut, jlut._np_gelu),
          "silu": (lut.silu_lut, jlut.silu_lut, jlut._np_silu),
          "tanh": (lut.tanh_lut, jlut.tanh_lut, np.tanh),
          "exp": (lut.exp_lut, jlut.exp_lut, np.exp)}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_stock_table_bytes_and_max_error_equal(name):
    """The four stock tables the softmax and the LM activations use: the
    same bytes, domain and step as JAX's, and ``lut_max_error`` equal to
    JAX's for the nearest lookup (the same eager divide, round and
    gather) and within 1e-6 for the interpolated one (XLA may fuse its
    multiply-adds)."""
    make, jmake, fn = TABLES[name]
    t, jt = make(), jmake()
    assert_bits_equal(t.table, jt.table)
    assert (t.x_min, t.x_max, t.step) == (jt.x_min, jt.x_max, jt.step)
    assert lut.lut_max_error(t, fn, n_probe=20_000) == \
        jlut.lut_max_error(jt, fn, n_probe=20_000)
    np.testing.assert_allclose(
        lut.lut_max_error(t, fn, n_probe=20_000, interp=True),
        jlut.lut_max_error(jt, fn, n_probe=20_000, interp=True),
        rtol=0, atol=1e-6)


def test_exp_table_through_the_wrapper():
    """The one-sided exp table through ``lut_activation``'s wrapper:
    bit-equal to JAX's lookup on -16, 0, the midpoints between entries,
    values below -16 and above 0 (clamped to the end entries) and NaN
    (entry 0)."""
    t, jt = lut.exp_lut(), jlut.exp_lut()
    step = np.float32(jt.step)
    mids = (np.arange(1023, dtype=np.float32) + np.float32(0.5)) * step \
        + np.float32(-16.0)
    x = np.concatenate([mids, np.array([-16.0, 0.0, -16.5, -1e30, -np.inf,
                                        0.5, np.inf, np.nan], np.float32),
                        -np.abs(rng(9).standard_normal(1000) * 8
                                ).astype(np.float32)])
    got = lut_activation(to_torch(x), t.table, x_min=t.x_min, x_max=t.x_max)
    assert_bits_equal(got, jlut.lut_lookup(jt, jnp.asarray(x)))
    table = t.table.numpy()
    assert got[1023] == table[0] and got[1024] == table[-1]
    assert got[1025] == got[1026] == got[1027] == table[0]
    assert got[1028] == got[1029] == table[-1] and got[1030] == table[0]
