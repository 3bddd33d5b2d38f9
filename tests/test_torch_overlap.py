"""Port parity of the compressed and overlapped merge plans
(``repro_torch.distributed.merge_plan.run_fit`` with ``overlap`` and
``compression``): JAX's numpy oracles, the port against JAX's
trajectories, and the port's own oracles bit for bit.

The JAX side runs under ``dispatch.use_kernels(False)``.  Its lane sums
are ones-vector contractions, the port's ``sum(dim=0)``, so a merged
partial can differ by an ulp; where that moves an absmax or sits on a
rounding tie, one int8 code differs and the error feedback carries the
difference on.  Trajectories are held as in ``test_torch_merge_plan.py``:
fp32 at 1e-5·max|w|, int8 + LUT at 1e-4·max|w|, per-step losses at rtol
1e-4 (the loss crosses the quantized wire at cadence 1).  The gaps
measured over 50 steps: fp32 3.7e-8 to 4.9e-7, int8 + LUT 7.8e-8 to
6.1e-7 but 2.6e-5 (int8 EF, cadence 1) and 3.4e-5 (overlap + int8 EF +
SlowMo, cadence 1); losses within 2.1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import make_cpu_grid as jax_grid  # noqa: E402
from repro.core.mlalgos import KMeans as JKMeans  # noqa: E402
from repro.core.mlalgos import LinReg as JLinReg  # noqa: E402
from repro.core.mlalgos import LogReg as JLogReg  # noqa: E402
from repro.core.mlalgos import api as japi  # noqa: E402
from repro.distributed import merge_plan as jmp  # noqa: E402
from repro.distributed.compression import (  # noqa: E402
    CompressionConfig as JCompressionConfig)
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import make_cpu_grid  # noqa: E402
from repro_torch.core.mlalgos import (KMeans, LinReg, LogReg,  # noqa: E402
                                      api, closed_form, make_linreg_step,
                                      train_kmeans, train_linreg)
from repro_torch.distributed.compression import (  # noqa: E402
    CompressionConfig)
from repro_torch.distributed.merge_plan import (  # noqa: E402
    AverageCommit, MergePlan, Nesterov, SlowMo)
from torch_parity import (blobs, classification, regression,  # noqa: E402
                          rng, top_two_gap)

LANES, ROWS, D = 8, 603, 16          # 603 rows: the last lane is padded
INT8 = CompressionConfig(bits=8)
AXES = {
    "int8": dict(compression=dict(bits=8)),
    "top-k": dict(compression=dict(bits=8, top_k_frac=0.25)),
    "top-k-raw": dict(compression=dict(bits=None, top_k_frac=0.25)),
    "overlap": dict(overlap=True),
    "overlap-int8-slowmo": dict(overlap=True, compression=dict(bits=8),
                                outer=True),
}


def _plans(axis: str, k: int):
    """The same plan in the port and in the JAX package."""
    spec = AXES[axis]
    c = spec.get("compression")
    kw = dict(cadence=k, overlap=spec.get("overlap", False))
    return (MergePlan(compression=CompressionConfig(**c) if c else None,
                      outer=SlowMo() if spec.get("outer") else
                      AverageCommit(), **kw),
            jmp.MergePlan(compression=JCompressionConfig(**c) if c else None,
                          outer=jmp.SlowMo() if spec.get("outer") else
                          jmp.AverageCommit(), **kw))


def _pair(name):
    if name == "linreg-fp32":
        X, y = regression(1, ROWS, D)
        return JLinReg(lr=0.1), LinReg(lr=0.1), X, y
    X, y = classification(0, ROWS, D)
    return (JLogReg(lr=0.5, precision="int8", sigmoid="lut"),
            LogReg(lr=0.5, precision="int8", sigmoid="lut"), X, y)


def _losses(history):
    return np.array([float(m["loss"]) for m in history])


def _close(got, want, bound):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=bound * np.abs(want).max())


# -- the JAX package's numpy oracles -----------------------------------------


def _ef_quantize_np(target, bits=8):
    qmax = 2 ** (bits - 1) - 1
    scale = max(np.max(np.abs(target)), 1e-12) / qmax
    deq = (np.clip(np.round(target / scale), -qmax - 1, qmax)
           * scale).astype(np.float32)
    return deq, target - deq


class TestOracles:
    """``tests/test_merge_plan.py``'s int8 + EF SlowMo oracles at cadence
    1 and 4 (rtol = atol = 2e-3) and ``tests/test_overlap_compression.
    py``'s int8 + EF oracle of the plain average (1e-3), 200 steps each,
    on the port's ``train_linreg``."""

    BETA, ALPHA = 0.5, 1.0
    V, PER, DIM, LR = 4, 32, 6, 0.05

    def _data(self):
        X = rng(21).standard_normal((self.V * self.PER, self.DIM)).astype(
            np.float32)
        return X, X @ np.linspace(-1.0, 1.0, self.DIM).astype(np.float32)

    def _oracle(self, X, y, steps, k, slowmo):
        V, per, lr, n = self.V, self.PER, self.LR, self.V * self.PER
        w = np.zeros((self.DIM,), np.float32)
        m = np.zeros((self.DIM,), np.float32)
        e = np.zeros((self.DIM,), np.float32)
        for _ in range(0, steps, k):
            lanes = []
            for v in range(V):
                Xv, yv = X[v * per:(v + 1) * per], y[v * per:(v + 1) * per]
                wv = w.copy()
                if k == 1:
                    lanes.append((Xv.T @ (Xv @ w - yv)).astype(np.float32))
                    continue
                for _ in range(k):
                    g = V * (Xv.T @ (Xv @ wv - yv)).astype(np.float32)
                    wv = wv - lr * g / n
                lanes.append(wv)
            wire = (np.sum(lanes, axis=0) if k == 1
                    else np.mean(lanes, axis=0)).astype(np.float32)
            wire, e = _ef_quantize_np(wire + e)
            proposed = w - lr * wire / n if k == 1 else wire
            if slowmo:
                m = self.BETA * m - (proposed - w)
                w = (w - self.ALPHA * m).astype(np.float32)
            else:
                w = proposed.astype(np.float32)
        return w

    @pytest.mark.parametrize("k", [1, 4])
    def test_slowmo_int8_ef_matches_the_numpy_oracle(self, k):
        X, y = self._data()
        res = train_linreg(make_cpu_grid(self.V), X, y, lr=self.LR,
                           steps=200, merge_plan=MergePlan(
                               cadence=k, compression=INT8,
                               outer=SlowMo(beta=self.BETA,
                                            outer_lr=self.ALPHA)))
        np.testing.assert_allclose(res.w.numpy(),
                                   self._oracle(X, y, 200, k, True),
                                   rtol=2e-3, atol=2e-3)

    def test_average_int8_ef_matches_the_numpy_oracle(self):
        X, y = self._data()
        res = train_linreg(make_cpu_grid(self.V), X, y, lr=self.LR,
                           steps=200, merge_plan=MergePlan(compression=INT8))
        np.testing.assert_allclose(res.w.numpy(),
                                   self._oracle(X, y, 200, 1, False),
                                   rtol=1e-3, atol=1e-3)

    def test_no_error_feedback_biases_more(self):
        """With EF the compressed run lands closer to exact than
        stateless quantization does."""
        X, y = self._data()
        grid = make_cpu_grid(self.V)

        def w(compression=None):
            return train_linreg(grid, X, y, lr=self.LR, steps=200,
                                merge_plan=MergePlan(compression=compression)
                                ).w.numpy()

        exact = w()
        ef = w(INT8)
        noef = w(CompressionConfig(bits=8, error_feedback=False))
        np.testing.assert_allclose(ef, exact, rtol=5e-3, atol=5e-3)
        assert np.linalg.norm(ef - exact) <= np.linalg.norm(noef - exact) \
            + 1e-6


# -- the port against the JAX package ----------------------------------------


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("axis", ["int8", "top-k", "overlap",
                                  "overlap-int8-slowmo"])
@pytest.mark.parametrize("name", ["linreg-fp32", "logreg-int8-lut"])
def test_trajectory_against_jax(name, axis, k):
    """50 steps: at cadence 4 twelve rounds (under overlap a prologue,
    twelve rounds and the drain) and a trailing round of 2 on the state
    wire.  Bounds and the gaps measured are in the module docstring."""
    _trajectory(name, axis, k)


def test_raw_top_k_trajectory_against_jax():
    """Top-k with values at native width (``bits=None``) on the delta
    wire, LogReg int8 + LUT at cadence 4."""
    _trajectory("logreg-int8-lut", "top-k-raw", 4)


def _trajectory(name, axis, k):
    jw, pw, X, y = _pair(name)
    plan, jplan = _plans(axis, k)
    with jdispatch.use_kernels(False):
        jres = japi.fit(jw, jax_grid(LANES), jnp.asarray(X), jnp.asarray(y),
                        steps=50, merge_plan=jplan)
    res = api.fit(pw, make_cpu_grid(LANES), X, y, steps=50, merge_plan=plan)
    _close(res.state.numpy(), jres.state,
           1e-5 if name == "linreg-fp32" else 1e-4)
    np.testing.assert_allclose(_losses(res.history), _losses(jres.history),
                               rtol=1e-4)


def test_kmeans_under_overlap_and_int8_against_jax():
    """10 Lloyd iterations under overlap + int8 EF at cadence 1 from
    JAX's initial centroids: the float counts and sums cross the
    quantized wire.  Centroids within atol 1e-4 (rtol 1e-5), per-step
    sse within rtol 1e-5, as ``test_torch_kmeans.py`` holds the exact
    merge, and the final SSE at most 1.2 × the default plan's + 1e-3
    (JAX's ``test_overlap_kmeans_converges``)."""
    K, DK = 4, 6
    X = blobs(4, ROWS, DK, K)
    plan = MergePlan(overlap=True, compression=INT8)
    jplan = jmp.MergePlan(overlap=True, compression=JCompressionConfig())
    jw = JKMeans(k=K)
    with jdispatch.use_kernels(False):
        _, _, consts = jw.prepare(jax_grid(LANES), jnp.asarray(X))
        jres = japi.fit(jw, jax_grid(LANES), jnp.asarray(X), steps=10,
                        merge_plan=jplan)
    program = KMeans(k=K).bind(make_cpu_grid(LANES), X)
    program.state0 = interop.state_from_numpy(np.asarray(consts["_c0"]),
                                              device="cpu")
    res = program.fit(steps=10, merge_plan=plan)
    base = program.fit(steps=10)
    jc = np.asarray(jres.state)
    np.testing.assert_allclose(res.state.numpy(), jc, atol=1e-4, rtol=1e-5)
    for m, n in zip(res.history, jres.history, strict=True):
        np.testing.assert_allclose(float(m["sse"]), float(n["sse"]),
                                   rtol=1e-5)
    assert top_two_gap(X, jc).min() > 1e-4
    assert float(res.history[-1]["sse"]) <= \
        1.2 * float(base.history[-1]["sse"]) + 1e-3


@functools.lru_cache(maxsize=None)
def _jax_perm(seed: int, epoch: int, per: int) -> np.ndarray:
    key = jax.random.fold_in(jax.random.PRNGKey(seed), epoch)
    return np.asarray(jax.random.permutation(key, per)).astype(np.int64)


def jax_permutation(seed, epoch, per):
    """JAX's per-epoch permutation, in the port's injectable form."""
    return torch.from_numpy(_jax_perm(seed, int(epoch), per)).to(
        epoch.device)


@pytest.mark.parametrize("axis", ["int8", "top-k"])
def test_minibatch_under_compression_against_jax(axis):
    """LogReg int8 + LUT on 16 rows a lane, 21 steps at cadence 8 (two
    rounds and a trailing round of 5), JAX's permutations injected.  The
    sampler's float32 counter crosses the wire with the state (quantized,
    or on the delta wire), as in the JAX package, and is rounded where it
    is read, so the schedule stays JAX's."""
    jw, pw, X, y = _pair("logreg-int8-lut")
    plan, jplan = _plans(axis, 8)
    with jdispatch.use_kernels(False):
        jres = japi.fit(jw, jax_grid(LANES), jnp.asarray(X), jnp.asarray(y),
                        steps=21, merge_plan=jplan, batch_size=16,
                        sample_seed=5)
    seen = []
    res = api.fit(pw, make_cpu_grid(LANES), X, y, steps=21, merge_plan=plan,
                  batch_size=16, sample_seed=5,
                  sample_permutation=jax_permutation,
                  callback=lambda i, s, m: seen.append(s.shape))
    _close(res.state.numpy(), jres.state, 1e-4)
    np.testing.assert_allclose(_losses(res.history), _losses(jres.history),
                               rtol=1e-4)
    assert seen == [(D,)] * 21
    full = api.fit(pw, make_cpu_grid(LANES), X, y, steps=21, merge_plan=plan)
    assert not torch.equal(full.state, res.state)


def test_jax_error_buffer_resumes_in_the_port():
    """48 JAX steps of fp32 LinReg under int8 EF at cadence 4, then 48
    in the port from JAX's state and error buffer
    (``interop.error_from_numpy``), against 96 JAX steps: within
    1e-5·max|w|.  Without the buffer the port lands further off."""
    jw, pw, X, y = _pair("linreg-fp32")
    plan, jplan = _plans("int8", 4)
    holder: dict = {}
    with jdispatch.use_kernels(False):
        j48 = japi.fit(jw, jax_grid(LANES), jnp.asarray(X), jnp.asarray(y),
                       steps=48, merge_plan=jplan, merge_state=holder)
        j96 = japi.fit(jw, jax_grid(LANES), jnp.asarray(X), jnp.asarray(y),
                       steps=96, merge_plan=jplan)
    err = interop.error_from_numpy(np.asarray(holder["error"]),
                                   device="cpu")
    assert err.shape == (1, D) and err.dtype == torch.float32
    assert float(err.abs().max()) > 0
    program = pw.bind(make_cpu_grid(LANES), X, y)

    def resume(merge_state):
        state, _ = program.grid.fit(
            init_state=interop.state_from_numpy(np.asarray(j48.state),
                                                "cpu"),
            local_fn=program.local_fn, update_fn=program.update_fn,
            data=program.data, steps=48, merge_plan=plan,
            merge_state=merge_state)
        return state.numpy()

    ours = {"error": err}
    want = np.asarray(j96.state)
    got = resume(ours)
    _close(got, want, 1e-5)
    assert ours["error"].shape == (1, D)
    assert np.abs(resume(None) - want).max() > np.abs(got - want).max()


# -- the port's own oracles ---------------------------------------------------


@pytest.mark.parametrize("kw", [
    {"overlap_merge": True},
    {"overlap_merge": True, "merge_compression": INT8},
    {"merge_compression": INT8},
    {"overlap_merge": True, "merge_every": 4},
    {"merge_compression": INT8, "merge_every": 5},
    {"overlap_merge": True, "merge_every": 5, "merge_compression":
     CompressionConfig(bits=8, top_k_frac=0.25)},
], ids=["overlap", "overlap-int8", "int8", "overlap-c4", "int8-c5",
        "overlap-top-k-c5"])
def test_scan_engine_equals_python_engine(kw):
    """Bit-equal states, histories and error buffers; 24 steps in chunks
    of 3 rounds leave partial chunks (and at cadence 5 a trailing round
    after the drain), and a python-engine callback sees every step."""
    X, y = regression(2, 400, 8)
    grid = make_cpu_grid(LANES)
    data, _, lf, uf, w0 = make_linreg_step(grid, X, y, lr=0.05)
    seen, ha, hb = [], {}, {}
    a, hist_a = grid.fit(init_state=w0, local_fn=lf, update_fn=uf,
                         data=data, steps=24, engine="python",
                         merge_state=ha,
                         callback=lambda i, s, m: seen.append(i), **kw)
    b, hist_b = grid.fit(init_state=w0, local_fn=lf, update_fn=uf,
                         data=data, steps=24, scan_chunk=3,
                         merge_state=hb, **kw)
    assert torch.equal(a, b) and seen == list(range(24))
    assert len(hist_a) == len(hist_b) == 24
    assert all(torch.equal(m["loss"], n["loss"])
               for m, n in zip(hist_a, hist_b))
    if "merge_compression" in kw:
        assert all(torch.equal(ha["error"][key], hb["error"][key])
                   for key in ha["error"]) if isinstance(ha["error"], dict) \
            else torch.equal(ha["error"], hb["error"])
    else:
        assert ha == hb == {}


@pytest.mark.parametrize("plan", [
    MergePlan(compression=INT8),
    MergePlan(cadence=4, compression=CompressionConfig(bits=8,
                                                       top_k_frac=0.25)),
    MergePlan(cadence=4, compression=INT8, outer=SlowMo()),
    MergePlan(compression=CompressionConfig(bits=None, top_k_frac=0.5),
              outer=Nesterov()),
], ids=["int8", "top-k-c4", "int8-slowmo-c4", "raw-top-k-nesterov"])
def test_error_feedback_continues_across_fits(plan):
    """fit(48) then fit(48) with one holder is fit(96), bit for bit; with
    the buffer dropped between them the trajectory differs."""
    X, y = regression(4, 320, 6)
    grid = make_cpu_grid(4)
    data, _, lf, uf, w0 = make_linreg_step(grid, X, y, lr=0.05)

    def fit(w, holder):
        return grid.fit(init_state=w, local_fn=lf, update_fn=uf, data=data,
                        steps=48, merge_plan=plan, merge_state=holder)

    w_one, h_one = grid.fit(init_state=w0, local_fn=lf, update_fn=uf,
                            data=data, steps=96, merge_plan=plan)
    holder: dict = {}
    w_half, h_a = fit(w0, holder)
    ef = holder["error"]
    assert all(e.shape[0] == 1 for e in (ef.values() if isinstance(ef, dict)
                                         else [ef]))
    w_two, h_b = fit(w_half, holder)
    assert torch.equal(w_two, w_one)
    assert all(torch.equal(m["loss"], n["loss"])
               for m, n in zip(h_a + h_b, h_one, strict=True))
    momentum = {"momentum": holder["momentum"]} if "momentum" in holder \
        else {}
    w_drop, _ = fit(w_half, dict(momentum))
    assert not torch.equal(w_drop, w_two)


class TestOverlap:
    """``tests/test_overlap_compression.py``'s overlap contracts on the
    port."""

    def test_cadence1_converges_within_tolerance(self):
        X, y = regression(5, 800, 8)
        w_star = closed_form(X, y).numpy()
        grid = make_cpu_grid(LANES)
        err = {ovl: float(np.linalg.norm(train_linreg(
            grid, X, y, lr=0.05, steps=200,
            merge_plan=MergePlan(overlap=ovl)).w.numpy() - w_star))
            for ovl in (False, True)}
        assert err[True] <= 1.5 * err[False] + 0.05, err

    def test_cadence_first_round_metrics_match_exact(self):
        """Round 1 of the cadence-k pipeline is the exact engine's round 1
        from the same state (the prologue commits nothing)."""
        X, y = regression(6, 240, 5)
        grid = make_cpu_grid(4)
        ovl = train_linreg(grid, X, y, lr=0.05, steps=12,
                           merge_plan=MergePlan(cadence=4, overlap=True))
        base = train_linreg(grid, X, y, lr=0.05, steps=12, merge_every=4)
        np.testing.assert_allclose(_losses(ovl.history[:4]),
                                   _losses(base.history[:4]), rtol=1e-6)

    def test_cadence_rounds_all_distinct(self):
        """The delayed-delta commit keeps one chain advancing every
        round: consecutive blocks of k reported losses differ (a
        replacement commit would repeat each phase)."""
        X, y = regression(7, 320, 6)
        k, rounds = 4, 6
        r = train_linreg(make_cpu_grid(4), X, y, lr=0.05, steps=k * rounds,
                         merge_plan=MergePlan(cadence=k, overlap=True))
        blocks = [tuple(_losses(r.history[i * k:(i + 1) * k]))
                  for i in range(rounds)]
        assert all(a != b for a, b in zip(blocks, blocks[1:])), blocks

    def test_cadence_keeps_full_progress_rate(self):
        """Staleness delays progress by about one round, it does not halve
        it: 15 overlapped rounds get at least as close as 13 exact ones
        (within 1.2× + 1e-4)."""
        X, y = regression(8, 800, 8)
        w_star = closed_form(X, y).numpy()
        grid = make_cpu_grid(LANES)
        k, rounds = 4, 15

        def err(steps, overlap=False):
            w = train_linreg(grid, X, y, lr=0.05, steps=steps,
                             merge_plan=MergePlan(cadence=k, overlap=overlap)
                             ).w.numpy()
            return float(np.linalg.norm(w - w_star))

        assert err(k * rounds, overlap=True) <= \
            err(k * (rounds - 2)) * 1.2 + 1e-4

    def test_kmeans_converges(self):
        X = blobs(9, 600, 4, 3)
        grid = make_cpu_grid(LANES)
        base = train_kmeans(grid, X, 3, iters=12)
        ovl = train_kmeans(grid, X, 3, iters=12, merge_plan=MergePlan(
            overlap=True, compression=INT8))
        assert float(ovl.history[-1]["sse"]) <= \
            1.2 * float(base.history[-1]["sse"]) + 1e-3
        assert len(ovl.history) == 12

    def test_fewer_steps_than_a_round(self):
        """A fit shorter than the cadence is one trailing round and no
        prologue; a fit of no steps returns the state it was given."""
        X, y = regression(9, 200, 4)
        grid = make_cpu_grid(4)
        plan = MergePlan(cadence=8, overlap=True, compression=INT8)
        short = train_linreg(grid, X, y, lr=0.05, steps=3, merge_plan=plan)
        plain = train_linreg(grid, X, y, lr=0.05, steps=3,
                             merge_plan=MergePlan(cadence=8, compression=INT8))
        assert torch.equal(short.w, plain.w) and len(short.history) == 3
        none = train_linreg(grid, X, y, lr=0.05, steps=0, merge_plan=plan)
        assert none.history == [] and not bool(none.w.any())
