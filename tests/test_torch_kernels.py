"""The port's kernel wrappers: parity of ``fxp_matmul`` with the JAX
dispatch around its Pallas kernel, argument checks, routes, launch
counters, and the import boundary of the package.  The card-only
comparisons are in ``test_torch_cuda.py``."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import quantize as jqz  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro_torch.core import lut, make_grid  # noqa: E402
from repro_torch.core import quantize as qz  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.fxp_matmul import (MAX_N, fxp_matmul,  # noqa: E402
                                            route)
from repro_torch.kernels.lut_activation import lut_activation  # noqa: E402
from torch_parity import assert_bits_equal, rng, to_torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ints(r, shape, dtype):
    info = np.iinfo(dtype)
    return r.integers(info.min, info.max + 1, shape).astype(dtype)


def test_chunk_partials_vs_pallas_interpret():
    """``fxp_matmul`` on the CPU equals JAX's ``dispatch.hybrid_matmul``
    (its Pallas ``fxp_matmul`` in interpret mode on every limb pair and
    K-chunk, combined in float32) bit for bit, for int8 and int16 a and
    b, a row-major a and a transposed view of the resident rows; K = 300
    in chunks of 128 (two whole chunks and a ragged one)."""
    r = rng(8)
    for adt, bdt, N in ((np.int8, np.int16, 1), (np.int8, np.int8, 10),
                        (np.int16, np.int16, 4), (np.int16, np.int8, 16)):
        a, b = _ints(r, (37, 300), adt), _ints(r, (300, N), bdt)
        got = fxp_matmul(to_torch(a), to_torch(b), k_chunk=128)
        assert got.shape == (37, N) and got.dtype == torch.float32
        assert_bits_equal(got, jdispatch.hybrid_matmul(
            jnp.asarray(a), jnp.asarray(b), k_chunk=128))
        x = _ints(r, (300, 37), adt)                   # resident (R, d) rows
        rt = _ints(r, (300, N), bdt)
        got_t = fxp_matmul(to_torch(x).transpose(-1, -2), to_torch(rt),
                           k_chunk=128)
        assert_bits_equal(got_t, jdispatch.hybrid_matmul(
            jnp.asarray(x.T), jnp.asarray(rt), k_chunk=128))


@pytest.mark.parametrize("limb", [1, 2])
def test_int16_limbs_and_strided_views(limb):
    """An int16 a through a transposed view, with a per-lane b of ``limb``
    limbs (int8 or int16), equals ``hybrid_dot`` on the view made
    contiguous, per lane, and JAX's ``hybrid_dot`` on the same values."""
    r = rng(9 + limb)
    bdt = np.int8 if limb == 1 else np.int16
    x = _ints(r, (3, 50, 70), np.int16)
    b = _ints(r, (3, 50, 9), bdt)
    view = to_torch(x).transpose(-1, -2)
    got = fxp_matmul(view, to_torch(b), k_chunk=16)
    assert torch.equal(got, qz.hybrid_dot(view.contiguous(), to_torch(b),
                                          k_chunk=16))
    want = np.stack([np.asarray(jqz.hybrid_dot(jnp.asarray(xl.T),
                                               jnp.asarray(bl), k_chunk=16))
                     for xl, bl in zip(x, b)])
    assert_bits_equal(got, want)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a8 = torch.zeros(4, 8, dtype=torch.int8)
    b = torch.zeros(8, 2, dtype=torch.int16)
    with pytest.raises(TypeError):
        fxp_matmul(a8.to(torch.int32), b)
    with pytest.raises(TypeError):
        fxp_matmul(a8, b.to(torch.int32))
    with pytest.raises(ValueError):
        fxp_matmul(a8, b[:7])                         # K mismatch
    with pytest.raises(ValueError):
        fxp_matmul(a8, torch.zeros(8, MAX_N + 1, dtype=torch.int16))
    fxp_matmul(a8, torch.zeros(8, MAX_N, dtype=torch.int16))
    with pytest.raises(ValueError):
        fxp_matmul(a8, b, k_chunk=0)
    with pytest.raises(ValueError):
        fxp_matmul(a8[None].expand(2, 4, 8),
                   torch.zeros(3, 8, 2, dtype=torch.int16))


def test_route_of_every_workload_layout():
    """Every layout a workload hands the kernel is read in whole aligned
    pieces: the forward's resident rows, the gradient's transposed view,
    the minibatch's gathered (L, 1024, d) rows, 2-D request rows, and
    int16 rows; only a misaligned view falls to element loads."""
    X = torch.zeros((4, 4096, 64), dtype=torch.int8)
    batch = X.index_select(1, torch.arange(1024))
    X16 = torch.zeros((4, 300, 64), dtype=torch.int16)
    assert route(X) == route(batch) == route(X[0, :7]) == route(X16) \
        == "rows/16B"
    assert route(X.transpose(-1, -2)) == route(batch.transpose(-1, -2)) \
        == route(X16.transpose(-1, -2)) == "cols/8B"
    assert route(X[..., 1:]) == "rows/elements"


def test_cpu_tensors_never_move_the_counters():
    r = rng(11)
    n_fxp, n_lut = fxp_matmul.launches, lut_activation.launches
    a = to_torch(r.integers(-128, 128, (4, 30, 9)).astype(np.int8))
    b = to_torch(r.integers(-32768, 32768, (9, 1)).astype(np.int16))
    dispatch.hybrid_matmul(a, b)
    t = lut.sigmoid_lut()
    dispatch.lut_apply(t, torch.randn(100))
    assert (fxp_matmul.launches, lut_activation.launches) == (n_fxp, n_lut)


def test_make_grid_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_grid(64)
    assert make_grid(64, device="cpu").device.type == "cpu"


def test_port_imports_neither_jax_nor_repro():
    """Every repro_torch module and chip_smoke.py import without JAX or
    any module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 30, mods\n"
        "for m in ('kernels.kmeans_assign', 'kernels.split_hist',\n"
        "          'core.mlalgos.kmeans', 'core.mlalgos.dtree',\n"
        "          'kernels.flash_attention', 'models.common',\n"
        "          'models.attention', 'models.mlp', 'models.transformer',\n"
        "          'models.model_api', 'configs.qwen2_0_5b',\n"
        "          'launch.serve_lm', 'launch.train', 'core.mlalgos.svm',\n"
        "          'core.mlalgos.multinomial', 'core.minibatch',\n"
        "          'optim.optimizers', 'tree', 'distributed.merge_plan',\n"
        "          'tuning.controller', 'tuning.cost', 'tuning.measurement',\n"
        "          'roofline.hw', 'roofline.analysis'):\n"
        "    assert 'repro_torch.' + m in mods, m\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
