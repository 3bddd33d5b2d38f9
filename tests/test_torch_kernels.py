"""The port's kernel wrappers: parity of ``fxp_matmul`` with the JAX Pallas
kernel, argument checks, launch counters, and the import boundary of the
package.  The card-only comparisons are in ``test_torch_cuda.py``."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fxp_matmul import fxp_matmul as jfxp  # noqa: E402
from repro_torch.core import lut, make_grid  # noqa: E402
from repro_torch.core import quantize as qz  # noqa: E402
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels.fxp_matmul import fxp_matmul  # noqa: E402
from repro_torch.kernels.lut_activation import lut_activation  # noqa: E402
from torch_parity import assert_bits_equal, rng, to_torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _limbs(r, shape):
    v = r.integers(-32768, 32768, shape).astype(np.int16)
    return torch.cat([lb for _, lb in qz.int8_limbs(to_torch(v))], dim=-1)


def test_chunk_partials_vs_pallas_interpret():
    """Each K-chunk's int32 partial equals the JAX Pallas kernel (interpret
    mode) on that chunk, for an int8 a and int16-typed limbs b."""
    r = rng(8)
    a = r.integers(-128, 128, (37, 300)).astype(np.int8)
    b = _limbs(r, (300, 1))
    got = fxp_matmul(to_torch(a), b, k_chunk=128)
    assert got.shape == (3, 37, 2) and got.dtype == torch.int32
    for c, k0 in enumerate(range(0, 300, 128)):
        want = jfxp(jnp.asarray(a[:, k0:k0 + 128]),
                    jnp.asarray(b.numpy()[k0:k0 + 128]), interpret=True)
        assert_bits_equal(got[c], want)


@pytest.mark.parametrize("limb", [1, 2])
def test_int16_limbs_and_strided_views(limb):
    """An int16 a read as one limb, through a transposed view, equals the
    limb materialised and made contiguous."""
    r = rng(9 + limb)
    a = to_torch(r.integers(-32768, 32768, (3, 50, 70)).astype(np.int16))
    b = _limbs(r, (3, 50, 1))
    view = a.transpose(-1, -2)
    got = fxp_matmul(view, b, k_chunk=16, limb=limb)
    dense = ref.a_limb(view, limb).contiguous().to(torch.int32)
    want = torch.stack([
        (dense[..., k:k + 16].double() @ b[:, k:k + 16].double()).int()
        for k in range(0, 50, 16)], dim=1)
    assert torch.equal(got, want)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a8 = torch.zeros(4, 8, dtype=torch.int8)
    b = torch.zeros(8, 2, dtype=torch.int16)
    with pytest.raises(TypeError):
        fxp_matmul(a8.to(torch.int16), b)             # int16 needs a limb
    with pytest.raises(TypeError):
        fxp_matmul(a8, b.to(torch.int32))
    with pytest.raises(ValueError):
        fxp_matmul(a8, b[:7])                         # K mismatch
    with pytest.raises(ValueError):
        fxp_matmul(a8, torch.zeros(8, 9, dtype=torch.int16))  # N > 8
    with pytest.raises(ValueError):
        fxp_matmul(a8, b, limb=3)
    with pytest.raises(ValueError):
        fxp_matmul(a8, b, k_chunk=0)
    with pytest.raises(ValueError):
        fxp_matmul(a8[None].expand(2, 4, 8),
                   torch.zeros(3, 8, 2, dtype=torch.int16))


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
        "          'launch.serve_lm', 'core.mlalgos.svm',\n"
        "          'core.mlalgos.multinomial', 'core.minibatch'):\n"
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
