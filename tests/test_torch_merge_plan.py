"""Port parity of the merge plan's outer optimizers
(``repro_torch.distributed.merge_plan``): SlowMo and Nesterov against the
JAX package's numpy oracles and against its trajectories, the momentum
carried across fits and from JAX, and the plan's spellings and caps.

The JAX side runs under ``dispatch.use_kernels(False)``.  Its plan path
sums lanes as a ones-vector contraction with the scale folded in, where
the port sums with ``sum(dim=0)``, so trajectories against JAX are held
by tolerance (fp32 at 1e-5·max|w|, the bound of ``test_torch_train.py``;
int8 + LUT at 1e-4·max|w|, see :func:`test_trajectory_against_jax`);
inside the port the engines and split fits are bit-equal.
"""

import dataclasses
import doctest
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import make_cpu_grid as jax_grid  # noqa: E402
from repro.core.mlalgos import KMeans as JKMeans  # noqa: E402
from repro.core.mlalgos import LinReg as JLinReg  # noqa: E402
from repro.core.mlalgos import LogReg as JLogReg  # noqa: E402
from repro.configs.pim_ml import PimMLConfig as JPimMLConfig  # noqa: E402
from repro.core.mlalgos import api as japi  # noqa: E402
from repro.distributed import merge_plan as jmp  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
import repro_torch.distributed.merge_plan  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.pim_ml import PimMLConfig  # noqa: E402
from repro_torch.core import make_cpu_grid  # noqa: E402
from repro_torch.core.mlalgos import (DecisionTree, KMeans,  # noqa: E402
                                      LinReg, LogReg, api, closed_form,
                                      make_linreg_step, train_kmeans,
                                      train_linreg, train_logreg)
from repro_torch.distributed import compression as comp  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    CompressionConfig)
from repro_torch.distributed.merge_plan import (  # noqa: E402
    AdaptiveCadence, AverageCommit, MergeFallbackWarning, MergePlan,
    Nesterov, OuterOptimizer, SlowMo)
from repro_torch.optim import OptState  # noqa: E402
from torch_parity import (blobs, classification, mixture,  # noqa: E402
                          regression, rng, single_process_world,
                          top_two_gap)

LANES, ROWS, D = 8, 603, 16          # 603 rows: the last lane is padded
OUTERS = {"slowmo": (SlowMo, jmp.SlowMo), "nesterov": (Nesterov,
                                                       jmp.Nesterov)}


def _plans(outer: str, k: int, **kw):
    """The same plan in the port and in the JAX package."""
    ours, theirs = OUTERS[outer]
    return (MergePlan(cadence=k, outer=ours(**kw)),
            jmp.MergePlan(cadence=k, outer=theirs(**kw)))


def _pair(name):
    if name == "linreg-fp32":
        X, y = regression(1, ROWS, D)
        return JLinReg(lr=0.1), LinReg(lr=0.1), X, y
    X, y = classification(0, ROWS, D)
    return (JLogReg(lr=0.5, precision="int8", sigmoid="lut"),
            LogReg(lr=0.5, precision="int8", sigmoid="lut"), X, y)


def _losses(history):
    return np.array([float(m["loss"]) for m in history])


def _close(got, want, bound=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=bound * np.abs(want).max())


# -- the JAX package's numpy oracles ---------------------------------------


class TestOracles:
    """``tests/test_merge_plan.py``'s SlowMo and Nesterov oracles (exact
    wire, 200 steps) on the port's ``train_linreg``, at their bound
    (rtol = atol = 1e-3)."""

    BETA, ALPHA = 0.5, 1.0
    V, PER, DIM, LR = 4, 32, 6, 0.05

    def _data(self):
        X = rng(21).standard_normal((self.V * self.PER, self.DIM)).astype(
            np.float32)
        y = X @ np.linspace(-1.0, 1.0, self.DIM).astype(np.float32)
        return X, y

    def _commit(self, outer, w, proposed, m):
        if outer == "slowmo":      # m' = beta*m - delta, w' = w - alpha*m'
            m = self.BETA * m - (proposed - w)
            return (w - self.ALPHA * m).astype(np.float32), m
        g = -(proposed - w)        # m' = beta*m + g, w' = w - a(g + beta*m')
        m = self.BETA * m + g
        return (w - self.ALPHA * (g + self.BETA * m)).astype(np.float32), m

    def _oracle(self, outer, X, y, steps, k):
        V, per, lr, n = self.V, self.PER, self.LR, self.V * self.PER
        w = np.zeros((self.DIM,), np.float32)
        m = np.zeros((self.DIM,), np.float32)
        done = 0
        while done < steps:
            kk = min(k, steps - done)
            if k == 1:
                g = np.zeros((self.DIM,), np.float32)
                for v in range(V):
                    Xv, yv = X[v * per:(v + 1) * per], y[v * per:(v + 1) * per]
                    g += (Xv.T @ (Xv @ w - yv)).astype(np.float32)
                proposed = w - lr * g / n
            else:
                lanes = []
                for v in range(V):
                    Xv, yv = X[v * per:(v + 1) * per], y[v * per:(v + 1) * per]
                    wv = w.copy()
                    for _ in range(kk):
                        g = V * (Xv.T @ (Xv @ wv - yv)).astype(np.float32)
                        wv = wv - lr * g / n
                    lanes.append(wv)
                proposed = np.mean(lanes, axis=0).astype(np.float32)
            w, m = self._commit(outer, w, proposed, m)
            done += kk
        return w

    @pytest.mark.parametrize("k", [1, 4])
    @pytest.mark.parametrize("outer", ["slowmo", "nesterov"])
    def test_matches_the_numpy_oracle(self, outer, k):
        X, y = self._data()
        plan, _ = _plans(outer, k, beta=self.BETA, outer_lr=self.ALPHA)
        res = train_linreg(make_cpu_grid(self.V), X, y, lr=self.LR,
                           steps=200, merge_plan=plan)
        np.testing.assert_allclose(res.w.numpy(),
                                   self._oracle(outer, X, y, 200, k),
                                   rtol=1e-3, atol=1e-3)
        assert len(res.history) == 200

    def test_slowmo_converges_no_worse_than_average(self):
        """At cadence 4 SlowMo gets at least as close to the closed-form
        solution as the plain average, as in the JAX package."""
        X, y = self._data()
        w_star = closed_form(X, y).numpy()
        err = {}
        for name, plan in (("avg", MergePlan(cadence=4)),
                           ("slowmo", MergePlan(cadence=4, outer=SlowMo()))):
            res = train_linreg(make_cpu_grid(self.V), X, y, lr=self.LR,
                               steps=120, merge_plan=plan)
            err[name] = float(np.linalg.norm(res.w.numpy() - w_star))
        assert err["slowmo"] <= err["avg"] * 1.05 + 1e-5, err


# -- the port against the JAX package --------------------------------------


@pytest.mark.parametrize("name,outer,k,steps", [
    ("linreg-fp32", "slowmo", 1, 50), ("linreg-fp32", "slowmo", 4, 50),
    ("linreg-fp32", "nesterov", 4, 50), ("logreg-int8-lut", "slowmo", 1, 50),
    ("logreg-int8-lut", "slowmo", 4, 50),
    ("logreg-int8-lut", "nesterov", 4, 50),
    ("logreg-int8-lut", "slowmo", 8, 50), ("linreg-fp32", "nesterov", 8, 49),
])
def test_trajectory_against_jax(name, outer, k, steps):
    """Final ``w`` against JAX's and per-step loss within rtol 1e-4.  50
    steps at cadence 4 end in a trailing round of 2, at cadence 8 of 2,
    and 49 at cadence 8 in a round of one step, which runs on the state
    wire through the outer optimizer as in JAX.

    fp32 is held to 1e-5·max|w| (``test_torch_train.py``'s bound; the
    gaps measured are 1e-7).  int8 + LUT is held to 1e-4·max|w|, the
    port's bar for quantized trajectories (``test_torch_workloads.py``):
    the local step requantizes ``w`` to 16 bits, so a one-ulp gap (the
    lane sums add in another order) now and then rounds a weight to the
    next quantum, and the outer momentum carries each such step on.  The
    gaps measured are 1.5e-7 (SlowMo, cadence 1), 1.1e-6 (Nesterov,
    cadence 4), 5.0e-6 (SlowMo, cadence 8) and 1.3e-5 (SlowMo, cadence
    4); the default plan at cadence 1 crosses 1e-5 too, after 96 steps
    (1.4e-5)."""
    jw, pw, X, y = _pair(name)
    plan, jplan = _plans(outer, k)
    with jdispatch.use_kernels(False):
        jres = japi.fit(jw, jax_grid(LANES), jnp.asarray(X), jnp.asarray(y),
                        steps=steps, merge_plan=jplan)
    res = api.fit(pw, make_cpu_grid(LANES), X, y, steps=steps,
                  merge_plan=plan)
    _close(res.state.numpy(), jres.state,
           1e-5 if name == "linreg-fp32" else 1e-4)
    np.testing.assert_allclose(_losses(res.history), _losses(jres.history),
                               rtol=1e-4)


def test_kmeans_under_slowmo_against_jax():
    """5 Lloyd iterations under SlowMo at cadence 1 from JAX's initial
    centroids: centroids within atol 1e-4 (rtol 1e-5), per-iteration sse
    within rtol 1e-5, and the cluster counts of the final centroids equal
    over the rows whose two nearest centroids are more than 1e-4 apart
    (``test_torch_kmeans.py``'s masking)."""
    K, DK = 4, 6
    X = blobs(4, ROWS, DK, K)
    plan, jplan = _plans("slowmo", 1)
    jw = JKMeans(k=K)
    with jdispatch.use_kernels(False):
        _, _, consts = jw.prepare(jax_grid(LANES), jnp.asarray(X))
        jres = japi.fit(jw, jax_grid(LANES), jnp.asarray(X), steps=5,
                        merge_plan=jplan)
    program = KMeans(k=K).bind(make_cpu_grid(LANES), X)
    program.state0 = interop.state_from_numpy(np.asarray(consts["_c0"]),
                                              device="cpu")
    res = program.fit(steps=5, merge_plan=plan)
    jc = np.asarray(jres.state)
    np.testing.assert_allclose(res.state.numpy(), jc, atol=1e-4, rtol=1e-5)
    for m, n in zip(res.history, jres.history, strict=True):
        np.testing.assert_allclose(float(m["sse"]), float(n["sse"]),
                                   rtol=1e-5)
    keep = top_two_gap(X, jc) > 1e-4
    assert keep.sum() >= ROWS - 2
    ours = KMeans(k=K).predict(res.state, X).numpy()[keep]
    theirs = np.asarray(jw.predict(jres.state, jnp.asarray(X)))[keep]
    np.testing.assert_array_equal(np.bincount(ours, minlength=K),
                                  np.bincount(theirs, minlength=K))


def test_jax_momentum_resumes_in_the_port():
    """48 JAX steps of fp32 LinReg under SlowMo at cadence 4, then 48 in
    the port from JAX's state and momentum
    (``interop.momentum_from_numpy``), against 96 JAX steps: within
    1e-5·max|w|; the commit counter goes on from JAX's.  Without the
    momentum the port lands more than ten times
    the bound off."""
    jw, pw, X, y = _pair("linreg-fp32")
    plan, jplan = _plans("slowmo", 4)
    holder: dict = {}
    with jdispatch.use_kernels(False):
        j48 = japi.fit(jw, jax_grid(LANES), jnp.asarray(X), jnp.asarray(y),
                       steps=48, merge_plan=jplan, merge_state=holder)
        j96 = japi.fit(jw, jax_grid(LANES), jnp.asarray(X), jnp.asarray(y),
                       steps=96, merge_plan=jplan)
    mom = interop.momentum_from_numpy(
        jax.tree.map(np.asarray, holder["momentum"]), device="cpu")
    assert isinstance(mom, OptState) and int(mom.step) == 12
    assert mom.step.dtype == torch.int32 and mom.inner.shape == (D,)
    program = pw.bind(make_cpu_grid(LANES), X, y)
    ours = {"momentum": mom}

    def resume(merge_state):
        state, _ = program.grid.fit(
            init_state=interop.state_from_numpy(np.asarray(j48.state),
                                                "cpu"),
            local_fn=program.local_fn, update_fn=program.update_fn,
            data=program.data, steps=48, merge_plan=plan,
            merge_state=merge_state)
        return state.numpy()

    _close(resume(ours), j96.state)
    assert int(ours["momentum"].step) == 24
    want = np.asarray(j96.state)
    assert np.abs(resume(None) - want).max() > 10e-5 * np.abs(want).max()


# -- the port's own oracles --------------------------------------------------


@pytest.mark.parametrize("outer", ["slowmo", "nesterov"])
def test_beta0_alpha1_recovers_the_default_plan(outer):
    """β = 0, α = 1 commits the plain average up to float association
    (rtol 1e-5, atol 1e-6, the JAX package's bar)."""
    X, y = regression(3, 128, 6)
    grid = make_cpu_grid(4)
    avg = train_linreg(grid, X, y, lr=0.05, steps=40, merge_every=4)
    plan, _ = _plans(outer, 4, beta=0.0, outer_lr=1.0)
    res = train_linreg(grid, X, y, lr=0.05, steps=40, merge_plan=plan)
    np.testing.assert_allclose(res.w.numpy(), avg.w.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("outer", ["slowmo", "nesterov"])
def test_scan_engine_equals_python_engine(outer, k):
    """Bit-equal states, histories and momenta; 11 steps in chunks of 3
    rounds leave a trailing round and a partial chunk, and a python-engine
    callback sees every step."""
    _, pw, X, y = _pair("logreg-int8-lut")
    program = pw.bind(make_cpu_grid(LANES), X, y)
    plan, _ = _plans(outer, k)
    seen, ma, mb_ = [], {}, {}
    a = program.fit(steps=11, engine="python", merge_plan=plan,
                    merge_state=ma, callback=lambda i, s, m: seen.append(i))
    b = program.fit(steps=11, engine="scan", scan_chunk=3, merge_plan=plan,
                    merge_state=mb_)
    assert torch.equal(a.state, b.state)
    assert len(a.history) == len(b.history) == 11 and seen == list(range(11))
    for m, n in zip(a.history, b.history):
        assert torch.equal(m["loss"], n["loss"])
    assert torch.equal(ma["momentum"].inner, mb_["momentum"].inner)
    assert int(ma["momentum"].step) == -(-11 // k)


@pytest.mark.parametrize("k", [1, 4])
def test_momentum_continues_across_fits(k):
    """fit(48) then fit(48) with one holder is fit(96), bit for bit."""
    X, y = regression(4, 320, 6)
    grid = make_cpu_grid(4)
    data, _, lf, uf, w0 = make_linreg_step(grid, X, y, lr=0.05)
    plan = MergePlan(cadence=k, outer=SlowMo(beta=0.5))
    w_one, h_one = grid.fit(init_state=w0, local_fn=lf, update_fn=uf,
                            data=data, steps=96, merge_plan=plan)
    holder: dict = {}
    w_half, h_a = grid.fit(init_state=w0, local_fn=lf, update_fn=uf,
                           data=data, steps=48, merge_plan=plan,
                           merge_state=holder)
    assert isinstance(holder["momentum"], OptState)
    w_two, h_b = grid.fit(init_state=w_half, local_fn=lf, update_fn=uf,
                          data=data, steps=48, merge_plan=plan,
                          merge_state=holder)
    assert torch.equal(w_two, w_one)
    assert all(torch.equal(m["loss"], n["loss"])
               for m, n in zip(h_a + h_b, h_one, strict=True))


def test_dropping_momentum_between_fits_diverges():
    X, y = regression(4, 320, 6)
    grid = make_cpu_grid(4)
    data, _, lf, uf, w0 = make_linreg_step(grid, X, y, lr=0.05)
    plan = MergePlan(cadence=4, outer=SlowMo(beta=0.5))
    holder: dict = {}
    w_half, _ = grid.fit(init_state=w0, local_fn=lf, update_fn=uf,
                         data=data, steps=48, merge_plan=plan,
                         merge_state=holder)
    w_cont, _ = grid.fit(init_state=w_half, local_fn=lf, update_fn=uf,
                         data=data, steps=48, merge_plan=plan,
                         merge_state=holder)
    w_drop, _ = grid.fit(init_state=w_half, local_fn=lf, update_fn=uf,
                         data=data, steps=48, merge_plan=plan)
    assert not torch.equal(w_cont, w_drop)


def test_custom_outer_optimizer_runs_and_is_not_plain():
    """Overriding ``commit`` marks a subclass not plain, so ``run_fit``
    calls it: a half-step commit lands elsewhere than the average."""

    @dataclasses.dataclass(frozen=True)
    class HalfStep(OuterOptimizer):
        def commit(self, anchor, delta, buf):
            return anchor + 0.5 * delta, buf

    assert not HalfStep.plain_commit
    X, y = regression(5, 320, 6)
    grid = make_cpu_grid(4)
    res = train_linreg(grid, X, y, lr=0.05, steps=40,
                       merge_plan=MergePlan(cadence=4, outer=HalfStep()))
    avg = train_linreg(grid, X, y, lr=0.05, steps=40, merge_every=4)
    assert len(res.history) == 40 and bool(torch.isfinite(res.w).all())
    assert not torch.equal(res.w, avg.w)


def test_plans_hash_and_the_average_is_plain():
    assert MergePlan(cadence=4) == MergePlan(cadence=4)
    assert hash(MergePlan(outer=SlowMo(beta=0.5))) == \
        hash(MergePlan(outer=SlowMo(beta=0.5)))
    assert SlowMo(beta=0.5) != SlowMo(beta=0.9)
    assert len({Nesterov(), Nesterov(), SlowMo()}) == 2
    assert AverageCommit().plain_commit and AdaptiveCadence().plain_commit
    assert not SlowMo().plain_commit and not Nesterov().plain_commit
    assert MergePlan(cadence=8).is_exact_default
    assert not MergePlan(outer=SlowMo()).is_exact_default
    assert MergePlan(cadence=4, outer=SlowMo()).describe() == \
        "MergePlan(cadence=4, outer=SlowMo(beta=0.5, outer_lr=1.0))"


def test_default_plan_never_builds_a_momentum():
    """The exact default runs ``PimGrid.fit``'s own loop: the spellings
    agree bit for bit and the holder stays empty."""
    X, y = regression(6, 320, 6)
    grid = make_cpu_grid(4)
    holder: dict = {}
    a = train_linreg(grid, X, y, lr=0.05, steps=10, merge_every=4,
                     merge_state=holder)
    b = train_linreg(grid, X, y, lr=0.05, steps=10,
                     merge_plan=MergePlan(cadence=4))
    assert torch.equal(a.w, b.w) and holder == {}


# -- spellings and caps ------------------------------------------------------


def test_mixed_spellings_raise():
    X, y = regression(7, 100, 4)
    grid = make_cpu_grid(4)
    data, _, lf, uf, w0 = make_linreg_step(grid, X, y, lr=0.05)
    with pytest.raises(ValueError, match="not both"):
        grid.fit(init_state=w0, local_fn=lf, update_fn=uf, data=data,
                 steps=4, merge_every=2, merge_plan=MergePlan(cadence=2))
    with pytest.raises(ValueError, match="not both"):
        api.fit(LinReg(), grid, X, y, steps=2, overlap_merge=True,
                merge_plan=MergePlan(outer=SlowMo()))
    with pytest.raises(ValueError, match="string form"):
        api.fit(LinReg(), grid, X, y, steps=2, merge_plan="slowmo")


@pytest.mark.parametrize("kw,item", [
    ({"merge_plan": "auto"}, "16a"),
    ({"merge_plan": MergePlan(outer=AdaptiveCadence())}, "16a"),
    (None, "11"),
])
def test_unported_plans_name_their_item(kw, item):
    """What raised until its ROADMAP item was ported now runs.  Item 11's
    ``compressed_reduce`` reduces over a mesh (here the (1, 1) mesh of
    this process, where it is the emulated hop).  Item 16a's plans
    train: the config builds the plan the JAX config builds, and a
    2-step fit returns 2 entries and its decision trace."""
    if item == "11":
        from repro_torch.launch.mesh import make_pim_mesh

        tree = {"g": torch.tensor([1.0, -2.0, 0.25])}
        err = comp.init_error_state(tree)
        with single_process_world():
            got, _ = comp.compressed_reduce(tree, err, CompressionConfig(),
                                            mesh=make_pim_mesh(1, 1))
        want, _ = comp.ef_compress_tree(tree, err, CompressionConfig())
        assert torch.equal(got["g"], want["g"])
        return
    outer = "auto" if kw["merge_plan"] == "auto" else "adaptive"
    plan = PimMLConfig(merge_outer=outer).merge_plan()
    theirs = JPimMLConfig(merge_outer=outer).merge_plan()
    assert type(plan.outer).__name__ == type(theirs.outer).__name__
    assert dataclasses.asdict(plan.outer) == dataclasses.asdict(theirs.outer)
    assert (plan.cadence, plan.overlap, plan.compression) == \
        (theirs.cadence, theirs.overlap, theirs.compression)
    X, y = regression(8, 100, 4)
    holder: dict = {}
    res = api.fit(LinReg(), make_cpu_grid(4), X, y, steps=2,
                  merge_state=holder, **kw)
    assert len(res.history) == 2
    assert holder["tuning_trace"]["decisions"][-1]["steps_done"] == 2


@pytest.mark.parametrize("kw", [
    {"overlap_merge": True},
    {"merge_compression": object()},
    {"merge_plan": MergePlan(cadence=4, overlap=True, outer=SlowMo())},
])
def test_plans_of_item_10b_train(kw):
    """The plans that raised until item 10b was ported now train.  A
    compression that is not a ``CompressionConfig`` fails at its first
    attribute, as in the JAX package, which does not check the type."""
    X, y = regression(8, 100, 4)
    if kw.get("merge_compression") is not None:
        with pytest.raises(AttributeError, match="top_k_frac"):
            api.fit(LinReg(), make_cpu_grid(4), X, y, steps=2, **kw)
        return
    res = api.fit(LinReg(), make_cpu_grid(4), X, y, steps=6, **kw)
    assert len(res.history) == 6 and bool(torch.isfinite(res.state).all())


def test_plan_validation():
    with pytest.raises(ValueError, match="cadence"):
        MergePlan(cadence=0)
    with pytest.raises(ValueError, match="OuterOptimizer"):
        MergePlan(outer="slowmo")
    with pytest.raises(ValueError, match="overlap"):
        MergePlan(overlap=True, outer=AdaptiveCadence())
    with pytest.raises(ValueError, match="growth"):
        AdaptiveCadence(growth=1)


def test_the_tree_drops_the_outer_with_one_warning():
    """The tree lists every axis it drops in one warning and trains the
    exact tree."""
    X, y = mixture(9, 600, 6, 2)
    grid = make_cpu_grid(LANES)
    wl = DecisionTree(max_depth=3, n_bins=16, n_classes=2)
    with pytest.warns(MergeFallbackWarning) as record:
        a = api.fit(wl, grid, X, y, steps=3, merge_plan=MergePlan(
            cadence=4, overlap=True, outer=SlowMo()))
    fallbacks = [r for r in record if r.category is MergeFallbackWarning]
    assert len(fallbacks) == 1
    assert "merge_every=4 + overlap_merge + outer=SlowMo" in \
        str(fallbacks[0].message)
    assert api.MergeFallbackWarning is MergeFallbackWarning
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        b = api.fit(wl, grid, X, y, steps=3)
    assert torch.equal(a.state.feature, b.state.feature)
    assert torch.equal(a.state.threshold, b.state.threshold)
    assert torch.equal(a.state.leaf_value, b.state.leaf_value)


def test_minibatch_refuses_a_stateful_outer():
    X, y = classification(10, 256, 6)
    grid = make_cpu_grid(4)
    with pytest.raises(ValueError, match="outer optimizer"):
        train_logreg(grid, X, y, steps=4, batch_size=16,
                     merge_plan=MergePlan(cadence=2, outer=SlowMo()))
    res = train_logreg(grid, X, y, steps=4, batch_size=16,
                       merge_plan=MergePlan(cadence=2))
    assert len(res.history) == 4


def test_train_wrappers_take_a_plan_and_a_holder():
    """``train_kmeans`` (its ``(k, d)`` centroids) and ``train_logreg``
    under a plan fill the holder with a momentum shaped like the state."""
    holder: dict = {}
    res = train_kmeans(make_cpu_grid(4), blobs(11, 400, 3, 3), 3, iters=6,
                       merge_plan=MergePlan(cadence=2, outer=Nesterov()),
                       merge_state=holder)
    assert holder["momentum"].inner.shape == res.centroids.shape == (3, 3)
    assert int(holder["momentum"].step) == 3
    X, y = classification(12, 256, 5)
    holder = {}
    res = train_logreg(make_cpu_grid(4), X, y, steps=5,
                       merge_plan=MergePlan(outer=SlowMo()),
                       merge_state=holder)
    assert res.w.shape == holder["momentum"].inner.shape == (5,)
    assert res.sigmoid == "exact" and len(res.history) == 5


def test_config_builds_the_merge_plan():
    plan = PimMLConfig(merge_outer="slowmo", merge_every=4,
                       slowmo_beta=0.9).merge_plan()
    assert plan.cadence == 4 and plan.outer == SlowMo(beta=0.9)
    assert PimMLConfig(merge_outer="nesterov").merge_plan().outer == \
        Nesterov()
    assert PimMLConfig().merge_plan() == MergePlan(cadence=8)
    with pytest.raises(ValueError, match="merge_outer"):
        PimMLConfig(merge_outer="slow_mo").merge_plan()
    for outer in ("auto", "adaptive"):
        for kw in ({}, {"adaptive_k_max": 4, "merge_every": 2}):
            plan = PimMLConfig(merge_outer=outer, **kw).merge_plan()
            theirs = JPimMLConfig(merge_outer=outer, **kw).merge_plan()
            assert plan.describe() == theirs.describe()
            assert plan.outer.k_max == kw.get("adaptive_k_max", 16)
    # the merge pipeline's fields build the plan the JAX config builds
    X, y = regression(8, 100, 4)
    for kw in ({"merge_compression_bits": 8}, {"merge_top_k_frac": 0.25},
               {"overlap_merge": True},
               {"merge_compression_bits": 4, "merge_top_k_frac": 0.5,
                "overlap_merge": True, "merge_outer": "slowmo"}):
        plan = PimMLConfig(**kw).merge_plan()
        theirs = JPimMLConfig(**kw).merge_plan()
        assert plan.describe() == theirs.describe()
        assert plan.overlap == theirs.overlap == kw.get("overlap_merge",
                                                        False)
        res = api.fit(LinReg(), make_cpu_grid(4), X, y, steps=9,
                      merge_plan=plan)
        assert len(res.history) == 9


def test_doc_examples():
    failed, tried = doctest.testmod(repro_torch.distributed.merge_plan,
                                    verbose=False)
    assert tried > 0 and failed == 0
