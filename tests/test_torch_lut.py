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
