"""Port parity of on-device minibatch sampling (``core.minibatch`` and
``api.fit(batch_size=...)``).

``jax.random.permutation`` cannot be replayed in torch, so the port's
per-epoch permutation is injectable: here JAX's permutations, computed
with ``jax`` inside the test, are injected, and the port's schedule and
fits are held against JAX's.  The port's default permutation (a hash
argsort on the device) is held to the schedule's own properties:
coverage, pad masking, seed and epoch sensitivity.

Fits compare by the bars of the full-batch parity tests
(``test_torch_train.py``, ``test_torch_workloads.py``,
``test_torch_kmeans.py``): the JAX side is jitted, so every divide by a
constant is a multiply by its reciprocal there; final state within
1e-5·max|state| (K-means: atol 1e-4, rtol 1e-5), losses within rtol
1e-4.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import make_cpu_grid as jax_grid  # noqa: E402
from repro.core import minibatch as jmb  # noqa: E402
from repro.core.mlalgos import KMeans as JKMeans  # noqa: E402
from repro.core.mlalgos import LinearSVM as JLinearSVM  # noqa: E402
from repro.core.mlalgos import LinReg as JLinReg  # noqa: E402
from repro.core.mlalgos import LogReg as JLogReg  # noqa: E402
from repro.core.mlalgos import MultinomialLogReg as JMultinomial  # noqa: E402
from repro.core.mlalgos import api as japi  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import make_cpu_grid  # noqa: E402
from repro_torch.core import minibatch as mb  # noqa: E402
from repro_torch.core.mlalgos import (DecisionTree, KMeans,  # noqa: E402
                                      LinearSVM, LinReg, LogReg,
                                      MultinomialLogReg, api, svm_accuracy)
from torch_parity import (assert_bits_equal, blobs,  # noqa: E402
                          classification, mixture, regression, to_numpy)

LANES, ROWS, D = 8, 603, 16          # 76 rows a lane, the last one padded


@functools.lru_cache(maxsize=None)
def _jax_perm(seed: int, epoch: int, per: int) -> np.ndarray:
    key = jax.random.fold_in(jax.random.PRNGKey(seed), epoch)
    return np.asarray(jax.random.permutation(key, per)).astype(np.int64)


def jax_permutation(seed, epoch, per):
    """JAX's per-epoch permutation, in the port's injectable form."""
    return torch.from_numpy(_jax_perm(seed, int(epoch), per)).to(
        epoch.device)


def _coverage(per, b, seed, epoch, permutation=None):
    E = mb.epoch_steps(per, b)
    counts = np.zeros(per, np.int64)
    for pos in range(E):
        idx, mask = mb.batch_indices(per, b, seed, epoch * E + pos,
                                     permutation=permutation)
        counts[to_numpy(idx)[to_numpy(mask) > 0]] += 1
    return counts


# -- the schedule --------------------------------------------------------------


@pytest.mark.parametrize("per,b", [(32, 8), (33, 8), (76, 16), (7, 3),
                                   (16, 16), (5, 1)])
def test_batch_indices_with_jax_permutation_bit_equal(per, b):
    """With JAX's permutation injected, ``batch_indices`` and both modes
    of ``host_schedule`` give JAX's indices and masks bit for bit, over
    three epochs."""
    E = mb.epoch_steps(per, b)
    assert E == jmb.epoch_steps(per, b)
    for step in range(3 * E):
        idx, mask = mb.batch_indices(per, b, 3, step,
                                     permutation=jax_permutation)
        jidx, jmask = jmb.batch_indices(per, b, 3, step)
        assert_bits_equal(idx, jidx)
        assert_bits_equal(mask, jmask)
        for shuffle in (True, False):
            got = mb.host_schedule(per, b, 3, step, shuffle=shuffle,
                                   permutation=jax_permutation)
            want = jmb.host_schedule(per, b, 3, step, shuffle=shuffle)
            assert_bits_equal(got[0], want[0])
            assert_bits_equal(got[1], want[1])


@pytest.mark.parametrize("per,b", [(32, 8), (33, 8), (128, 32), (7, 3),
                                   (16, 16), (5, 1), (65536, 1024)])
def test_default_permutation_covers_every_slot_once_an_epoch(per, b):
    for epoch in (0, 1, 3):
        np.testing.assert_array_equal(_coverage(per, b, 0, epoch),
                                      np.ones(per))


def test_default_permutation_pads_under_a_zero_mask():
    """per % b != 0: the last batch of an epoch holds E·b − per pad slots
    (repeats of leading slots) with mask 0."""
    per, b = 33, 8
    E = mb.epoch_steps(per, b)
    masks = [to_numpy(mb.batch_indices(per, b, 0, pos)[1])
             for pos in range(E)]
    assert E * b - per == 7 and sum(m.sum() for m in masks) == per
    assert (masks[-1] == np.array([1] + [0] * 7, np.float32)).all()
    assert all(m.dtype == np.float32 for m in masks)


def test_default_permutation_seed_and_epoch_sensitivity():
    """Another seed or epoch draws another order; the same (seed, epoch)
    draws the same; a tensor step on the device gives what an int
    gives; the permutation is pinned (checkpoints and the card rely on
    it)."""
    per, b = 64, 16
    first = [to_numpy(mb.batch_indices(per, b, 0, t)[0]) for t in range(4)]
    again = [to_numpy(mb.batch_indices(per, b, 0, torch.tensor(t))[0])
             for t in range(4)]
    later = [to_numpy(mb.batch_indices(per, b, 0, 4 + t)[0])
             for t in range(4)]
    other = to_numpy(mb.batch_indices(per, b, 1, 0)[0])
    assert all((a == c).all() for a, c in zip(first, again))
    assert not all((a == c).all() for a, c in zip(first, later))
    assert not (first[0] == other).all()
    assert mb.hashed_permutation(0, torch.tensor(3), 10).tolist() == \
        [8, 1, 3, 2, 6, 7, 0, 4, 9, 5]


def test_batch_size_validation():
    lf = uf = lambda *a: None                      # noqa: E731
    for b in (0, 9):
        with pytest.raises(ValueError, match="batch_size"):
            mb.minibatch_fns(lf, uf, torch.zeros(()), rows_per_vdpu=8,
                             batch_size=b)
    _, pw, X, y = _pair("logreg-int8-lut")
    with pytest.raises(ValueError, match="batch_size"):
        api.fit(pw, make_cpu_grid(LANES), X, y, steps=2, batch_size=77)


# -- fits against JAX's -------------------------------------------------------


def _pair(name):
    Xc, yc = classification(0, ROWS, D)
    Xr, yr = regression(1, ROWS, D)
    Xm, ym = mixture(2, ROWS, D, 4)
    table = {
        "logreg-int8-lut": (JLogReg(lr=0.5, precision="int8", sigmoid="lut"),
                            LogReg(lr=0.5, precision="int8", sigmoid="lut"),
                            Xc, yc),
        "linreg-fp32": (JLinReg(lr=0.05), LinReg(lr=0.05), Xr, yr),
        "svm-int8": (JLinearSVM(lr=0.1, precision="int8"),
                     LinearSVM(lr=0.1, precision="int8"), Xc, yc),
        "svm-fp32": (JLinearSVM(lr=0.1), LinearSVM(lr=0.1), Xc, yc),
        "multinomial-int8-lut": (
            JMultinomial(n_classes=4, precision="int8", softmax="lut"),
            MultinomialLogReg(n_classes=4, precision="int8", softmax="lut"),
            Xm, ym),
    }
    return table[name]


def _losses(history):
    return np.array([float(m["loss"]) for m in history])


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", ["logreg-int8-lut", "linreg-fp32",
                                  "svm-int8", "svm-fp32",
                                  "multinomial-int8-lut"])
def test_minibatch_fit_matches_jax(name, k):
    """21 steps of 16 rows a lane (5 steps an epoch, the fifth padded),
    seed 5, at cadence k, with JAX's permutations injected."""
    jw, pw, X, y = _pair(name)
    with jdispatch.use_kernels(False):
        jres = japi.fit(jw, jax_grid(LANES), jnp.asarray(X), jnp.asarray(y),
                        steps=21, merge_every=k, batch_size=16,
                        sample_seed=5)
    res = api.fit(pw, make_cpu_grid(LANES), X, y, steps=21, merge_every=k,
                  batch_size=16, sample_seed=5,
                  sample_permutation=jax_permutation)
    jstate = np.asarray(jres.state)
    assert res.state.shape == jstate.shape
    np.testing.assert_allclose(to_numpy(res.state), jstate, rtol=0,
                               atol=1e-5 * np.abs(jstate).max())
    np.testing.assert_allclose(_losses(res.history), _losses(jres.history),
                               rtol=1e-4)
    full = api.fit(pw, make_cpu_grid(LANES), X, y, steps=21, merge_every=k)
    assert not torch.equal(full.state, res.state)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("precision", ["fp32", "int16"])
def test_minibatch_kmeans_matches_jax(precision, k):
    """8 Lloyd iterations on 16 sampled rows a lane from JAX's initial
    centroids: centroids within atol 1e-4, rtol 1e-5 (the full-batch
    K-means bar), sse within rtol 1e-5."""
    X = blobs(4, ROWS, 6, 4)
    jw = JKMeans(k=4, precision=precision)
    with jdispatch.use_kernels(False):
        c0 = jw.prepare(jax_grid(LANES), jnp.asarray(X))[2]["_c0"]
        jres = japi.fit(jw, jax_grid(LANES), jnp.asarray(X), steps=8,
                        merge_every=k, batch_size=16, sample_seed=2)
    program = KMeans(k=4, precision=precision).bind(make_cpu_grid(LANES), X)
    program.state0 = interop.state_from_numpy(np.asarray(c0), device="cpu")
    res = program.fit(steps=8, merge_every=k, batch_size=16, sample_seed=2,
                      sample_permutation=jax_permutation)
    np.testing.assert_allclose(to_numpy(res.state), np.asarray(jres.state),
                               atol=1e-4, rtol=1e-5)
    for m, n in zip(res.history, jres.history):
        np.testing.assert_allclose(float(m["sse"]), float(n["sse"]),
                                   rtol=1e-5)


# -- the port's own oracles ---------------------------------------------------


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", ["logreg-int8-lut", "multinomial-int8-lut"])
def test_scan_engine_equals_python_engine(name, k):
    """Bit-exact with the default permutation; 11 steps in chunks of 3
    rounds, and the callback sees the caller's state, not the carry."""
    _, pw, X, y = _pair(name)
    program = pw.bind(make_cpu_grid(LANES), X, y)
    seen = []
    a = program.fit(steps=11, engine="python", merge_every=k, batch_size=16,
                    callback=lambda i, s, m: seen.append(tuple(s.shape)))
    b = program.fit(steps=11, engine="scan", scan_chunk=3, merge_every=k,
                    batch_size=16)
    assert torch.equal(a.state, b.state)
    assert seen == [tuple(program.state0.shape)] * 11
    for m, n in zip(a.history, b.history):
        assert torch.equal(m["loss"], n["loss"])


def test_counter_stays_exact_under_cadence():
    """The float32 step counter lands on exact integers through cadence
    averaging and remainder rounds, on 8 lanes and on 6 (1/6 is not a
    power of two)."""
    for lanes in (LANES, 6):
        _, pw, X, y = _pair("linreg-fp32")
        program = pw.bind(make_cpu_grid(lanes), X, y)
        lf, uf, s0, unwrap = program._triple(8, 0)
        for steps, k in ((24, 4), (25, 4), (10, 1), (13, 6)):
            state, _ = program.grid.fit(init_state=s0, local_fn=lf,
                                        update_fn=uf, data=program.data,
                                        steps=steps, merge_every=k)
            assert float(state[1]) == float(steps)
            assert state[1].dtype == torch.float32
            assert unwrap(state).shape == (D,)


def test_the_tree_drops_batch_size_with_a_warning():
    X, y = mixture(3, ROWS, D, 4)
    wl = DecisionTree(max_depth=3, n_bins=8, n_classes=4)
    grid = make_cpu_grid(LANES)
    with pytest.warns(api.MergeFallbackWarning, match="batch_size=16"):
        a = api.fit(wl, grid, X, y, steps=3, batch_size=16)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        b = api.fit(wl, grid, X, y, steps=3)
    assert torch.equal(a.state.feature, b.state.feature)
    assert torch.equal(a.state.threshold, b.state.threshold)


def test_minibatch_svm_keeps_the_full_batch_accuracy():
    """PIM-Opt's recipe (minibatch SGD at cadence 1 and 4) within 0.02 of
    the full-batch fit's accuracy, the JAX package's bar."""
    X, y = classification(7, 2048, 10)
    grid = make_cpu_grid(8)
    full = api.fit(LinearSVM(lr=0.1), grid, X, y, steps=150)
    acc = svm_accuracy(full.state, X, y)
    for k in (1, 4):
        res = api.fit(LinearSVM(lr=0.1), grid, X, y, steps=150,
                      merge_every=k, batch_size=64)
        assert svm_accuracy(res.state, X, y) >= acc - 0.02
