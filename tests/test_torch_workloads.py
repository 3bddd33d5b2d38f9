"""Port parity of the linear SVM and multinomial logistic regression: one
local step against the JAX package's with its Pallas kernels in
interpret mode, whole trajectories, predictions from a JAX-trained
state, and the accuracy bars the JAX package's own tests hold.

Tolerances, where a comparison is not bit for bit:

* fp32 paths: a matmul sums each lane's rows in another order than XLA,
  so ``g`` within 1e-6 of its largest entry;
* the exact softmax: PyTorch's ``exp`` and XLA's differ in the last bit
  on ~10 % of inputs, and at C = 10 ``torch.sum`` adds the classes of the
  LUT softmax's normaliser in another order than XLA's in-order sum; on
  the quantized paths the residual is then requantized to 16 bits, where
  a one-ulp change can move a value by one quantum.  ``g`` within 1e-5
  of its largest entry there (measured ≤ 3e-6);
* trajectories (the JAX side jitted, which turns each divide by a
  constant into a multiply by the reciprocal): final state within
  1e-5·max|state| (measured ≤ 5.4e-7), and 1e-4·max|state| on the
  quantized multinomial paths at C = 10, where the requantization above
  compounds over 20 steps (measured ≤ 1.4e-5); per-step loss within
  rtol 1e-4 (measured ≤ 1.5e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import datasets as jdatasets  # noqa: E402
from repro.core import make_cpu_grid as jax_grid  # noqa: E402
from repro.core import quantize as jqz  # noqa: E402
from repro.core.mlalgos import LinearSVM as JLinearSVM  # noqa: E402
from repro.core.mlalgos import MultinomialLogReg as JMultinomial  # noqa: E402
from repro.core.mlalgos import api as japi  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import make_cpu_grid  # noqa: E402
from repro_torch.core.mlalgos import (LinearSVM,  # noqa: E402
                                      MultinomialLogReg, api,
                                      multinomial_accuracy, svm_accuracy,
                                      train_multinomial, train_svm)
from repro_torch.core.mlalgos.multinomial import int_logits  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from torch_parity import (assert_bits_equal, classification,  # noqa: E402
                          mixture, to_numpy, to_torch)

LANES, ROWS, D = 8, 603, 16          # 603 rows: the last lane is padded
KEY = jax.random.PRNGKey(0)


def _svm(precision, pm1=False):
    X, y = classification(0, ROWS, D)
    if pm1:
        y = np.where(y > 0, 1.0, -1.0).astype(np.float32)
    return (JLinearSVM(lr=0.1, precision=precision),
            LinearSVM(lr=0.1, precision=precision), X, y)


def _mn(C, precision, softmax):
    X, y = mixture(1, ROWS, D, C)
    kw = dict(n_classes=C, lr=0.5, precision=precision, softmax=softmax)
    return JMultinomial(**kw), MultinomialLogReg(**kw), X, y


def _losses(history):
    return np.array([float(m["loss"]) for m in history])


def _local_steps(jw, pw, X, y, state):
    """One local step of every lane in both packages, JAX with its
    Pallas kernels in interpret mode; the placements bit-equal."""
    assert jdispatch.kernels_enabled()
    jdata, jn, jc = jw.prepare(jax_grid(LANES), jnp.asarray(X),
                               jnp.asarray(y))
    jparts = jax.vmap(lambda sl: jw.local_step(jc, jnp.asarray(state),
                                               sl))(jdata)
    pdata, pn, pc = pw.prepare(make_cpu_grid(LANES), X, y)
    assert pn == jn == ROWS
    for key in jdata:
        assert_bits_equal(pdata[key], jdata[key])
    if "x_scale" in jc:
        assert_bits_equal(pc["x_scale"], jc["x_scale"])
    return jdata, jc, jparts, pdata, pc, pw.local_step(pc, to_torch(state),
                                                       pdata)


# -- one local step ----------------------------------------------------------


@pytest.mark.parametrize("precision", ["fp32", "int16", "int8"])
def test_svm_local_step(precision):
    """The quantized paths' ``g`` bit-equal (integer products and IEEE
    operations in the same order), fp32's within 1e-6 of its largest
    entry; the hinge loss within rtol 1e-6."""
    jw, pw, X, y = _svm(precision)
    w = (np.random.default_rng(5).standard_normal(D) * 0.3
         ).astype(np.float32)
    *_, jparts, _, _, parts = _local_steps(jw, pw, X, y, w)
    jg = np.asarray(jparts["g"])
    if precision == "fp32":
        np.testing.assert_allclose(to_numpy(parts["g"]), jg, rtol=0,
                                   atol=1e-6 * np.abs(jg).max())
    else:
        assert_bits_equal(parts["g"], jg)
    np.testing.assert_allclose(to_numpy(parts["loss"]),
                               np.asarray(jparts["loss"]), rtol=1e-6)


@pytest.mark.parametrize("C", [2, 4, 10])
@pytest.mark.parametrize("precision,softmax", [
    ("fp32", "exact"), ("fp32", "lut"), ("int16", "lut"), ("int16", "exact"),
    ("int8", "lut"), ("int8", "exact")])
def test_multinomial_local_step(C, precision, softmax):
    """Quantized logits ``Z`` bit-equal at every C (one 16-bit scale for
    the shared W, ``hybrid_matmul`` at N = C); ``g`` bit-equal on the
    quantized LUT paths up to C = 8 (at C = 10 the normaliser's sum
    order differs, see the module docstring), else within the stated
    tolerance; the exact-log-softmax loss within rtol 1e-6."""
    jw, pw, X, y = _mn(C, precision, softmax)
    W = (np.random.default_rng(6).standard_normal((D, C)) * 0.3
         ).astype(np.float32)
    jdata, jc, jparts, pdata, pc, parts = _local_steps(jw, pw, X, y, W)
    jg, g = np.asarray(jparts["g"]), to_numpy(parts["g"])
    assert g.shape == (LANES, D, C)
    if precision == "fp32":
        np.testing.assert_allclose(g, jg, rtol=0,
                                   atol=1e-6 * np.abs(jg).max())
    else:
        Wq = jqz.quantize_symmetric(jnp.asarray(W) * jc["x_scale"][0][:, None],
                                    bits=16)
        jz = jax.vmap(lambda x: jdispatch.hybrid_matmul(x, Wq.values)
                      * Wq.scale)(jdata["X"])
        assert_bits_equal(int_logits(pdata["X"], to_torch(W),
                                     pc["x_scale"]), jz)
        if softmax == "lut" and C <= 8:
            assert_bits_equal(g, jg)
        else:
            np.testing.assert_allclose(g, jg, rtol=0,
                                       atol=1e-5 * np.abs(jg).max())
    np.testing.assert_allclose(to_numpy(parts["loss"]),
                               np.asarray(jparts["loss"]), rtol=1e-6)


def test_lane_batched_weights_quantize_per_lane():
    """Inside a cadence round W is ``(L, d, C)``: one 16-bit scale per
    lane, as JAX's vmap gives, and the residual one per lane."""
    jw, pw, X, y = _mn(10, "int8", "lut")
    Wl = (np.random.default_rng(7).standard_normal((LANES, D, 10))
          * np.arange(1, LANES + 1)[:, None, None] * 0.1).astype(np.float32)
    jdata, _, jc = jw.prepare(jax_grid(LANES), jnp.asarray(X), jnp.asarray(y))
    jparts = jax.vmap(lambda W, sl: jw.local_step(jc, W, sl))(
        jnp.asarray(Wl), jdata)
    pdata, _, pc = pw.prepare(make_cpu_grid(LANES), X, y)
    parts = pw.local_step(pc, to_torch(Wl), pdata)
    jz = jax.vmap(lambda W, x: jdispatch.hybrid_matmul(
        x, jqz.quantize_symmetric(W * jc["x_scale"][0][:, None],
                                  bits=16).values)
        * jqz.quantize_symmetric(W * jc["x_scale"][0][:, None],
                                 bits=16).scale)(jnp.asarray(Wl), jdata["X"])
    assert_bits_equal(int_logits(pdata["X"], to_torch(Wl), pc["x_scale"]),
                      jz)
    jg = np.asarray(jparts["g"])
    np.testing.assert_allclose(to_numpy(parts["g"]), jg, rtol=0,
                               atol=1e-5 * np.abs(jg).max())


# -- whole trajectories ------------------------------------------------------


def _assert_trajectory(jw, pw, X, y, k, tol):
    with jdispatch.use_kernels(False):
        jres = japi.fit(jw, jax_grid(LANES), jnp.asarray(X), jnp.asarray(y),
                        steps=20, merge_every=k)
    res = api.fit(pw, make_cpu_grid(LANES), X, y, steps=20, merge_every=k)
    jstate = np.asarray(jres.state)
    np.testing.assert_allclose(to_numpy(res.state), jstate, rtol=0,
                               atol=tol * np.abs(jstate).max())
    np.testing.assert_allclose(_losses(res.history), _losses(jres.history),
                               rtol=1e-4)
    assert _losses(res.history)[-1] < _losses(res.history)[0]
    return res


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("labels", ["01", "pm1"])
@pytest.mark.parametrize("precision", ["fp32", "int16", "int8"])
def test_svm_trajectory(precision, labels, k):
    jw, pw, X, y = _svm(precision, pm1=labels == "pm1")
    res = _assert_trajectory(jw, pw, X, y, k, 1e-5)
    if labels == "pm1":                      # {0, 1} and ±1 train alike
        _, _, _, y01 = _svm(precision)
        twin = api.fit(pw, make_cpu_grid(LANES), X, y01, steps=20,
                       merge_every=k)
        assert torch.equal(res.state, twin.state)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("C", [2, 4, 10])
@pytest.mark.parametrize("softmax", ["exact", "lut"])
@pytest.mark.parametrize("precision", ["fp32", "int16", "int8"])
def test_multinomial_trajectory(precision, softmax, C, k):
    jw, pw, X, y = _mn(C, precision, softmax)
    tol = 1e-4 if precision != "fp32" and C > 8 else 1e-5
    res = _assert_trajectory(jw, pw, X, y, k, tol)
    assert res.state.shape == (D, C)


def test_scan_engine_equals_python_engine():
    """Bit-exact inside the port: 11 steps at cadence 4 with a chunk of 3
    rounds, the C = 10 int8 LUT path."""
    _, pw, X, y = _mn(10, "int8", "lut")
    program = pw.bind(make_cpu_grid(LANES), X, y)
    a = program.fit(steps=11, engine="python", merge_every=4)
    b = program.fit(steps=11, engine="scan", scan_chunk=3, merge_every=4)
    assert torch.equal(a.state, b.state)
    assert [torch.equal(m["loss"], n["loss"])
            for m, n in zip(a.history, b.history)] == [True] * 11


# -- weights carried across --------------------------------------------------


@pytest.mark.parametrize("name", ["svm-fp32", "svm-int8", "mn4-fp32-exact",
                                  "mn4-int8-lut", "mn10-int16-lut"])
def test_jax_trained_state_predicts_in_the_port(name):
    """A JAX-trained vector or ``(d, C)`` matrix carried across predicts
    within rtol 1e-6 of JAX's ``predict`` (one-ulp sums at C = 10), on
    1, 7 and 100 request rows; and the predictions are pad-invariant."""
    if name.startswith("svm"):
        jw, pw, X, y = _svm(name.split("-")[1])
    else:
        C, precision, softmax = name[2:].split("-")
        jw, pw, X, y = _mn(int(C), precision, softmax)
    with jdispatch.use_kernels(False):
        jres = japi.fit(jw, jax_grid(LANES), jnp.asarray(X), jnp.asarray(y),
                        steps=10)
    state = interop.state_from_numpy(np.asarray(jres.state), device="cpu")
    assert state.shape == jres.state.shape
    for n in (1, 7, 100):
        with jdispatch.use_kernels(False):
            want = np.asarray(jw.predict(jres.state, jnp.asarray(X[:n])))
        got = to_numpy(pw.predict(state, X[:n]))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    padded = pw.predict(state, np.concatenate(
        [X[:7], np.zeros((9, D), np.float32)]))
    assert torch.equal(pw.predict(state, X[:7]), padded[:7])


def test_minibatch_carry_crosses_as_a_pair():
    """A minibatch fit's ``(state, counter)`` carry crosses as a pair of
    float32 tensors and resumes in the port's engine."""
    _, pw, X, y = _mn(4, "int8", "lut")
    carry = interop.state_from_numpy(
        (np.zeros((D, 4), np.float32), np.float32(3.0)), device="cpu")
    assert isinstance(carry, tuple) and carry[1].shape == ()
    program = pw.bind(make_cpu_grid(LANES), X, y)
    lf, uf, _, unwrap = program._triple(16, 0)
    state, _ = program.grid.fit(init_state=carry, local_fn=lf, update_fn=uf,
                                data=program.data, steps=5, merge_every=4)
    assert float(state[1]) == 8.0 and unwrap(state).shape == (D, 4)


# -- the accuracy bars of the JAX package's tests ----------------------------


def _jax_data(kind, C=4):
    """The JAX package's own test sets, as numpy."""
    if kind == "svm":
        X, y, _ = jdatasets.binary_classification(KEY, 2048, 10)
    else:
        X, y = jdatasets.mixture_classification(KEY, 2048, 10, C)
    return np.array(X), np.array(y)


def test_svm_int8_accuracy_within_002_of_fp32():
    X, y = _jax_data("svm")
    grid = make_cpu_grid(8)
    r32 = train_svm(grid, X, y, lr=0.1, steps=100)
    r8 = train_svm(grid, X, y, lr=0.1, steps=100, precision="int8")
    assert abs(svm_accuracy(r32.w, X, y) - svm_accuracy(r8.w, X, y)) < 0.02


@pytest.mark.parametrize("C", [4, 10])
def test_multinomial_int8_accuracy_within_003_of_fp32(C):
    X, y = _jax_data("mn", C)
    grid = make_cpu_grid(8)
    r32 = train_multinomial(grid, X, y, n_classes=C, lr=0.5, steps=60)
    r8 = train_multinomial(grid, X, y, n_classes=C, lr=0.5, steps=60,
                           precision="int8", softmax="lut")
    a32, a8 = (multinomial_accuracy(r.W, X, y) for r in (r32, r8))
    assert abs(a32 - a8) < 0.03, (a32, a8)


def test_lut_softmax_accuracy_within_001_of_exact():
    X, y = _jax_data("mn")
    grid = make_cpu_grid(8)
    r_e = train_multinomial(grid, X, y, n_classes=4, lr=0.5, steps=80)
    r_l = train_multinomial(grid, X, y, n_classes=4, lr=0.5, steps=80,
                            softmax="lut")
    a_e, a_l = (multinomial_accuracy(r.W, X, y) for r in (r_e, r_l))
    assert abs(a_e - a_l) < 0.01 and a_e > 0.8


def test_lut_softmax_launches_once_a_step_on_the_lanes():
    """The LUT softmax is one ``lut_apply`` on the whole ``(L, R, C)``
    block; its rows sum to 1."""
    calls = []
    real = dispatch.lut_apply

    def spy(table, x):
        calls.append(tuple(x.shape))
        return real(table, x)

    _, pw, X, y = _mn(10, "int8", "lut")
    data, _, consts = pw.prepare(make_cpu_grid(LANES), X, y)
    dispatch.lut_apply = spy
    try:
        P = consts["sm"](torch.randn(LANES, 76, 10))
    finally:
        dispatch.lut_apply = real
    assert calls == [(LANES, 76, 10)]
    np.testing.assert_allclose(P.sum(-1).numpy(), 1.0, rtol=1e-6)
