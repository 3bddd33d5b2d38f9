"""Port parity of the training slice: one local step, whole trajectories,
the port's own engine oracle, weights carried across, and the options
that are not ported yet.

The JAX side runs under ``dispatch.use_kernels(False)``
(``tests/test_dispatch.py`` holds its Pallas path equal to that one).
Where the JAX side is jitted, XLA turns every divide by a constant
(``amax / qmax``, ``g / n``, ``(z - x_min) / step``) into a multiply by
the reciprocal; the port divides, as the un-jitted JAX functions do.
So one eager local step is compared bit for bit and jitted trajectories
by tolerance.
"""

import doctest

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import make_cpu_grid as jax_grid  # noqa: E402
from repro.core.mlalgos import LinReg as JLinReg  # noqa: E402
from repro.core.mlalgos import LinearSVM as JLinearSVM  # noqa: E402
from repro.core.mlalgos import LogReg as JLogReg  # noqa: E402
from repro.core.mlalgos import \
    MultinomialLogReg as JMultinomialLogReg  # noqa: E402
from repro.core.mlalgos import api as japi  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
import repro_torch.core.pim  # noqa: E402
import repro_torch.core.mlalgos.api  # noqa: E402
import repro_torch.kernels.dispatch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import lut, make_cpu_grid  # noqa: E402
from repro_torch.core.mlalgos import (LinearSVM, LinReg,  # noqa: E402
                                      LogReg, MultinomialLogReg, api)
from repro_torch.distributed.merge_plan import MergePlan  # noqa: E402
from torch_parity import (assert_bits_equal, classification,  # noqa: E402
                          mixture, regression, to_numpy, to_torch)

LANES, ROWS, D = 8, 603, 16          # 603 rows: the last lane is padded


def _pair(name):
    """(JAX workload, port workload, X, y) for a slice configuration."""
    Xc, yc = classification(0, ROWS, D)
    Xr, yr = regression(1, ROWS, D)
    Xm, ym = mixture(2, ROWS, D, 4)
    table = {
        "logreg-int8-lut": (JLogReg(lr=0.5, precision="int8", sigmoid="lut"),
                            LogReg(lr=0.5, precision="int8", sigmoid="lut"),
                            Xc, yc),
        "logreg-int16-lut": (
            JLogReg(lr=0.5, precision="int16", sigmoid="lut"),
            LogReg(lr=0.5, precision="int16", sigmoid="lut"), Xc, yc),
        "logreg-fp32-exact": (JLogReg(lr=0.5), LogReg(lr=0.5), Xc, yc),
        "linreg-int8": (JLinReg(lr=0.1, precision="int8"),
                        LinReg(lr=0.1, precision="int8"), Xr, yr),
        "linreg-int16": (JLinReg(lr=0.1, precision="int16"),
                         LinReg(lr=0.1, precision="int16"), Xr, yr),
        "linreg-fp32": (JLinReg(lr=0.1), LinReg(lr=0.1), Xr, yr),
        "svm-fp32": (JLinearSVM(lr=0.1), LinearSVM(lr=0.1), Xc, yc),
        "mn4-fp32-exact": (JMultinomialLogReg(n_classes=4),
                           MultinomialLogReg(n_classes=4), Xm, ym),
    }
    return table[name]


def _losses(history):
    return np.array([float(m["loss"]) for m in history])


# -- one local step ---------------------------------------------------------


@pytest.mark.parametrize("name", ["logreg-int8-lut", "logreg-int16-lut",
                                  "linreg-int8", "linreg-int16",
                                  "logreg-fp32-exact", "linreg-fp32"])
def test_one_local_step(name):
    """Resident placement bit-exact; per-lane integer products and ``g``
    bit-exact on the quantized paths (every step there is an exact
    integer product or an IEEE op in the same order); the fp32 paths'
    ``g`` within 1e-6 of the largest entry (a matmul sums each lane's
    rows in another order); the exact-log loss within rtol 1e-6; the
    merged ``g`` (a lane sum in another order) within 1e-6 of its
    summands' magnitude, Σ_lanes |g| per column: a column's lane sums
    cancel (one sums to -2.19 from terms of total 35), so a relative
    bar on the sum asks more than float32 summation order promises.

    The fp32 paths are also held against the same step in float64
    (``X @ w``, the sigmoid, ``(p - y0)·mask``, ``Xᵀ r``): per lane
    within γ_{R+D+4} · Σ_r |x_rj| (|r_r| + Σ_j' |x_rj' w_j'| + 1), the
    worst-case float32 bound of a D-term dot product, a rounded
    sigmoid and subtraction and an R-term sum (γ_n = n·u / (1 - n·u),
    u = 2^-24), and the merged ``g`` within γ_{R+D+4+L} of the lanes'
    summed magnitudes.  Measured for the logreg case: the port 3.3e-6
    per lane and 9.9e-6 merged, JAX 1.6e-6 and 7.7e-6, against bounds
    of 1.3e-3 and more: a wrong row, sign or mask moves ``g`` by far
    more."""
    jw, pw, X, y = _pair(name)
    w = (np.random.default_rng(5).standard_normal(D) * 0.3
         ).astype(np.float32)
    with jdispatch.use_kernels(False):
        jdata, jn, jc = jw.prepare(jax_grid(LANES), jnp.asarray(X),
                                   jnp.asarray(y))
        jparts = jax.vmap(lambda sl: jw.local_step(jc, jnp.asarray(w),
                                                   sl))(jdata)
    pdata, pn, pc = pw.prepare(make_cpu_grid(LANES), X, y)
    assert pn == jn == ROWS
    for key in jdata:
        assert_bits_equal(pdata[key], jdata[key])
    parts = pw.local_step(pc, to_torch(w), pdata)

    jg = np.asarray(jparts["g"])
    if "fp32" in name:
        np.testing.assert_allclose(parts["g"].numpy(), jg, rtol=0,
                                   atol=1e-6 * np.abs(jg).max())
    else:
        assert_bits_equal(pc["x_scale"], jc["x_scale"])
        assert_bits_equal(parts["g"], jg)
        from repro.core import quantize as jqz
        from repro_torch.core.mlalgos.linreg import (int_forward,
                                                     quantize_weight)
        jwq = jqz.quantize_symmetric(jnp.asarray(w) * jc["x_scale"][0],
                                     bits=16)
        jz = jax.vmap(lambda x: jqz.hybrid_dot(x, jwq.values[:, None])[:, 0]
                      * jwq.scale)(jdata["X"])
        z = int_forward(pdata["X"], quantize_weight(to_torch(w),
                                                    pc["x_scale"]))
        assert_bits_equal(z, jz)
    np.testing.assert_allclose(parts["loss"].numpy(),
                               np.asarray(jparts["loss"]), rtol=1e-6)
    merged_gap = np.abs(parts["g"].sum(0).numpy() - jg.sum(0))
    assert (merged_gap <= 1e-6 * np.abs(jg).sum(0)).all(), merged_gap
    if "fp32" in name:
        _assert_within_float32_bound(name, parts["g"].numpy(), pdata, w)


def _assert_within_float32_bound(name, g, pdata, w):
    """``g`` (per lane, and merged) against the fp32 local step evaluated
    in float64, within the worst-case float32 bound of the docstring of
    :func:`test_one_local_step`."""
    X = pdata["X"].double().numpy()                      # (L, R, D)
    y0 = pdata["y0"].double().numpy()
    mask = pdata["w"].double().numpy()
    w64 = w.astype(np.float64)
    z = X @ w64
    p = 1.0 / (1.0 + np.exp(-z)) if name.startswith("logreg") else z
    r = (p - y0) * mask
    g64 = np.einsum("lrd,lr->ld", X, r)
    L, R, D = X.shape
    u = 2.0 ** -24

    def gamma(n):
        return n * u / (1 - n * u)

    mag = np.einsum("lrd,lr->ld", np.abs(X),
                    (np.abs(r) + np.abs(X) @ np.abs(w64) + 1) * mask)
    assert (np.abs(g - g64) <= gamma(R + D + 4) * mag).all()
    assert (np.abs(g.sum(0) - g64.sum(0))
            <= gamma(R + D + 4 + L) * mag.sum(0)).all()


# -- whole trajectories ------------------------------------------------------


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", ["logreg-int8-lut", "linreg-int8",
                                  "linreg-fp32"])
def test_trajectory(name, k):
    """20 steps at cadence k.  The slice's bounds are final ``w`` within
    1e-3·max|w| and per-step loss within rtol 1e-3; measured gaps are
    near 1e-7·max|w| and 1e-5, so the asserts hold the tighter
    1e-5·max|w| and rtol 1e-4 (reciprocal-multiply vs divide and
    lane-sum order, compounding over 20 steps)."""
    jw, pw, X, y = _pair(name)
    with jdispatch.use_kernels(False):
        jres = japi.fit(jw, jax_grid(LANES), jnp.asarray(X), jnp.asarray(y),
                        steps=20, merge_every=k)
    res = api.fit(pw, make_cpu_grid(LANES), X, y, steps=20, merge_every=k)
    jstate = np.asarray(jres.state)
    np.testing.assert_allclose(res.state.numpy(), jstate, rtol=0,
                               atol=1e-5 * np.abs(jstate).max())
    np.testing.assert_allclose(_losses(res.history), _losses(jres.history),
                               rtol=1e-4)
    assert _losses(res.history)[-1] < _losses(res.history)[0]


# -- the port's own oracle -----------------------------------------------------


@pytest.mark.parametrize("k", [1, 4])
def test_scan_engine_equals_python_engine(k):
    """Bit-exact: same arithmetic, different host synchronisation; 11
    steps with a chunk of 3 rounds cover a remainder round and a partial
    chunk."""
    _, pw, X, y = _pair("logreg-int8-lut")
    program = pw.bind(make_cpu_grid(LANES), X, y)
    seen = []
    a = program.fit(steps=11, engine="python", merge_every=k,
                    callback=lambda i, s, m: seen.append(i))
    b = program.fit(steps=11, engine="scan", scan_chunk=3, merge_every=k)
    assert torch.equal(a.state, b.state)
    assert len(a.history) == len(b.history) == 11 and seen == list(range(11))
    for m, n in zip(a.history, b.history):
        assert torch.equal(m["loss"], n["loss"])


def test_cadence_one_round_is_a_merge_per_step():
    """A cadence-k fit whose remainder is one step takes the merge-per-step
    body for that step, as the JAX engine does."""
    _, pw, X, y = _pair("linreg-int8")
    program = pw.bind(make_cpu_grid(LANES), X, y)
    a = program.fit(steps=5, merge_every=4)
    grid = program.grid
    s, _ = grid.fit(init_state=program.state0, local_fn=program.local_fn,
                    update_fn=program.update_fn, data=program.data, steps=4,
                    merge_every=4)
    s, _ = grid.fit(init_state=s, local_fn=program.local_fn,
                    update_fn=program.update_fn, data=program.data, steps=1)
    assert torch.equal(a.state, s)


# -- weights carried across -----------------------------------------------


@pytest.mark.parametrize("name", ["logreg-int8-lut", "logreg-fp32-exact",
                                  "linreg-int8"])
def test_jax_trained_state_predicts_in_the_port(name):
    """rtol 1e-6 of JAX's ``predict``, on 1, 7 and 100 request rows."""
    jw, pw, X, y = _pair(name)
    with jdispatch.use_kernels(False):
        jres = japi.fit(jw, jax_grid(LANES), jnp.asarray(X), jnp.asarray(y),
                        steps=10)
    state = interop.state_from_numpy(np.asarray(jres.state), device="cpu")
    for n in (1, 7, 100):
        with jdispatch.use_kernels(False):
            want = np.asarray(jw.predict(jres.state, jnp.asarray(X[:n])))
        got = pw.predict(state, X[:n])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["logreg-int8-lut", "linreg-int16",
                                  "linreg-fp32", "logreg-fp32-exact",
                                  "svm-fp32", "mn4-fp32-exact"])
def test_predict_is_pad_invariant(name):
    """Zero rows appended to a request never change the real rows'
    predictions (a serving runner pads requests up to bucket sizes): the
    quantized paths' absmax ignores zero rows, and the fp32 paths sum
    each row on its own, whatever the row count."""
    _, pw, X, _ = _pair(name)
    shape = (D, 4) if name.startswith("mn4") else (D,)
    state = torch.linspace(-0.5, 0.5, int(np.prod(shape))).reshape(shape)
    got = pw.predict(state, X[:7])
    padded = pw.predict(state, np.concatenate([X[:7], np.zeros((9, D),
                                                                np.float32)]))
    assert torch.equal(got, padded[:7])


def test_jax_state_resumes_training_in_the_port():
    """10 JAX steps, then 10 in the port from the carried state, against
    20 JAX steps: within 1e-5·max|w| (the trajectory bound)."""
    jw, pw, X, y = _pair("logreg-int8-lut")
    with jdispatch.use_kernels(False):
        j10 = japi.fit(jw, jax_grid(LANES), jnp.asarray(X), jnp.asarray(y),
                       steps=10)
        j20 = japi.fit(jw, jax_grid(LANES), jnp.asarray(X), jnp.asarray(y),
                       steps=20)
    program = pw.bind(make_cpu_grid(LANES), X, y)
    state, hist = program.grid.fit(
        init_state=interop.state_from_numpy(np.asarray(j10.state), "cpu"),
        local_fn=program.local_fn, update_fn=program.update_fn,
        data=program.data, steps=10)
    want = np.asarray(j20.state)
    np.testing.assert_allclose(state.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(_losses(hist), _losses(j20.history)[10:],
                               rtol=1e-4)


def test_jax_values_carried_across_bit_exact():
    """A JAX LUT, quantized dataset and resident placement become the
    port's, bit for bit, and feed its step functions."""
    from repro.core import lut as jlut
    from repro.core import quantize as jqz

    jt = jlut.sigmoid_lut()
    t = interop.lut_from_numpy(np.asarray(jt.table), jt.x_min, jt.x_max,
                               device="cpu")
    assert_bits_equal(t.table, lut.sigmoid_lut().table)
    assert (t.x_min, t.x_max) == (jt.x_min, jt.x_max)

    jw, pw, X, y = _pair("logreg-int8-lut")
    jq = jqz.quantize_symmetric(jnp.asarray(X), bits=8, axis=0)
    q = interop.quantized_from_numpy(np.asarray(jq.values),
                                     np.asarray(jq.scale), device="cpu")
    assert q.values.dtype == torch.int8
    jdata, _, _ = jw.prepare(jax_grid(LANES), jnp.asarray(X), jnp.asarray(y))
    data = interop.resident_from_numpy(
        {k: np.asarray(v) for k, v in jdata.items()}, device="cpu")
    pdata, _, consts = pw.prepare(make_cpu_grid(LANES), X, y)
    assert_bits_equal(consts["x_scale"], q.scale)
    w = torch.full((D,), 0.1)
    a, b = pw.local_step(consts, w, data), pw.local_step(consts, w, pdata)
    assert torch.equal(a["g"], b["g"]) and torch.equal(a["loss"], b["loss"])


# -- the API surface ---------------------------------------------------------


def test_unported_options_raise():
    """``"auto"`` (ROADMAP item 16a) and the overlapped merge train; a
    compression that is not a ``CompressionConfig`` fails at its first
    attribute, as in the JAX package, and malformed plans raise."""
    _, pw, X, y = _pair("linreg-fp32")
    grid = make_cpu_grid(LANES)
    assert len(api.fit(pw, grid, X, y, steps=2,
                       merge_plan="auto").history) == 2
    assert len(api.fit(pw, grid, X, y, steps=2,
                       overlap_merge=True).history) == 2
    with pytest.raises(AttributeError, match="top_k_frac"):
        api.fit(pw, grid, X, y, steps=2, merge_compression=object())
    with pytest.raises(ValueError):
        MergePlan(cadence=0)
    with pytest.raises(ValueError):
        api.fit(pw, grid, X, y, steps=2, merge_plan=MergePlan(2),
                merge_every=4)
    res = api.fit(pw, grid, X, y, steps=3, merge_plan=MergePlan(2))
    assert len(res.history) == 3


def test_merge_caps_degrade_to_the_exact_default_with_a_warning():
    class ExactOnly(LinReg):
        merge_caps = api.MergeCaps(cadence=False, reason="discrete commits")

    _, _, X, y = _pair("linreg-int8")
    grid = make_cpu_grid(LANES)
    with pytest.warns(api.MergeFallbackWarning, match="merge_every=4"):
        a = api.fit(ExactOnly(precision="int8"), grid, X, y, steps=5,
                    merge_every=4)
    b = api.fit(LinReg(precision="int8"), grid, X, y, steps=5)
    assert torch.equal(a.state, b.state)


def test_history_is_host_scalars_and_state_stays_on_the_grid():
    _, pw, X, y = _pair("logreg-int8-lut")
    res = api.fit(pw, make_cpu_grid(LANES), X, y, steps=4, merge_every=2)
    assert all(m["loss"].shape == () and m["loss"].device.type == "cpu"
               for m in res.history)
    assert res.state.shape == (D,) and res.state.dtype == torch.float32
    assert 0.5 < res.eval(X, y)["accuracy"] <= 1.0
    assert to_numpy(pw.predict(res.state, X[:3])).shape == (3,)


@pytest.mark.parametrize("module", [repro_torch.core.pim,
                                    repro_torch.core.mlalgos.api,
                                    repro_torch.kernels.dispatch])
def test_doc_examples(module):
    failed, tried = doctest.testmod(module, verbose=False)
    assert tried > 0 and failed == 0
