"""Card-only tests of the port: each CUDA kernel against its plain
PyTorch version, bit for bit, and a small fit on the card against its
``use_kernels(False)`` twin.  They skip where there is no CUDA device and
import no JAX, so the machine with the card runs them as they are:

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import datasets, lut, make_grid  # noqa: E402
from repro_torch.core.mlalgos import LinReg, LogReg, api  # noqa: E402
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels.fxp_matmul import fxp_matmul  # noqa: E402
from repro_torch.kernels.lut_activation import lut_activation  # noqa: E402
from torch_parity import require_cuda  # noqa: E402

pytestmark = pytest.mark.requires_cuda


# (L, M, K, N, transposed, a dtype): the vector kernels (aligned, K or M a
# multiple of the 16-byte vector, N <= 4) with ragged rows, idle threads
# and K > 4096, and the scalar ones (K or M ragged, N > 4)
@pytest.mark.parametrize("L,M,K,N,transposed,dtype", [
    (3, 1000, 64, 2, False, torch.int8), (3, 1000, 48, 3, False, torch.int8),
    (3, 80, 9000, 4, True, torch.int8), (3, 64, 9000, 2, True, torch.int8),
    (2, 77, 5000, 3, False, torch.int8), (1, 5, 7, 1, True, torch.int8),
    (2, 33, 64, 6, False, torch.int8), (2, 333, 64, 2, False, torch.int16),
    (2, 64, 333, 2, True, torch.int16), (2, 77, 63, 1, False, torch.int16)])
def test_fxp_kernel_equals_plain(L, M, K, N, transposed, dtype):
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    info = torch.iinfo(dtype)
    shape = (L, K, M) if transposed else (L, M, K)
    a = torch.randint(info.min, info.max + 1, shape, generator=g,
                      device=dev).to(dtype)
    a = a.transpose(-1, -2) if transposed else a
    b = torch.randint(-128, 256, (L, K, N), generator=g, device=dev
                      ).to(torch.int16)
    for limb in ((0,) if dtype == torch.int8 else (1, 2)):
        before = fxp_matmul.launches
        got = fxp_matmul(a, b, limb=limb)
        assert fxp_matmul.launches == before + 1
        assert torch.equal(got, ref.fxp_matmul_ref(a, b, k_chunk=4096,
                                                   limb=limb))


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
