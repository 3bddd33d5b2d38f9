"""Port parity of the serving layer (``repro_torch.serving`` and
``repro_torch.launch.serve``).

JAX's ``tests/test_serving.py`` case for case on the port
(``TestPredictProtocol``, ``TestPredictRunner``, ``TestMicroBatchQueue``
with its ``_StubRunner``, ``TestModelRegistry``), then the port against
the JAX package.  On the CPU a runner's entry runs the eager forward on
its static buffers (the rows padded to the bucket), so the port's runner
equals its own ``Workload.predict`` bit for bit; the CUDA graph path
runs on the card (``chip_smoke.py``, phase ``serve_pim``).  The hot swap
of two runners over one shared
:class:`~repro_torch.serving.runner.BucketEntry` runs here with a slowed
stand-in for the replay.

Tolerances, where a comparison is not bit for bit:

* the fp32 predict against the eval forward (``TestPredictProtocol``):
  ``predict`` sums each row on its own (``linreg.rowdot``, pad-invariant)
  and the eval forward is a BLAS product, so within 1e-6·max|out|;
* the port's runner against JAX's on a JAX-trained state carried across
  as numpy: fp32 within 1e-6·max|out| (``rowdot`` against XLA's
  ``X @ w``), quantized within 1e-6·max|out| (jitted XLA turns the
  scale's divide into a multiply by its reciprocal); the request's
  quantized integers bit for bit; K-means labels equal on every row
  whose two nearest centroids are more than 1e-4 apart in squared
  distance (a near-tie may go either way under another summation order).

Checkpoints cross packages bit for bit.
"""

import contextlib
import io
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.core import make_cpu_grid as jax_grid  # noqa: E402
from repro.core import quantize as jqz  # noqa: E402
from repro.core.mlalgos import api as japi  # noqa: E402
from repro.core.mlalgos.kmeans import KMeans as JKMeans  # noqa: E402
from repro.core.mlalgos.linreg import LinReg as JLinReg  # noqa: E402
from repro.core.mlalgos.logreg import LogReg as JLogReg  # noqa: E402
from repro.core.mlalgos.multinomial import (  # noqa: E402
    MultinomialLogReg as JMultinomial)
from repro.core.mlalgos.svm import LinearSVM as JLinearSVM  # noqa: E402
from repro.serving import ModelRegistry as JRegistry  # noqa: E402
from repro.serving import PredictRunner as JRunner  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import lut as lut_mod  # noqa: E402
from repro_torch.core import make_cpu_grid  # noqa: E402
from repro_torch.core import quantize as qz  # noqa: E402
from repro_torch.core.mlalgos import api  # noqa: E402
from repro_torch.core.mlalgos.dtree import DecisionTree  # noqa: E402
from repro_torch.core.mlalgos.kmeans import (KMeans,  # noqa: E402
                                             kmeans_assign_points)
from repro_torch.core.mlalgos.linreg import (BITS, LinReg,  # noqa: E402
                                             int_forward, linreg_predict,
                                             quantize_weight)
from repro_torch.core.mlalgos.logreg import LogReg, logreg_predict  # noqa: E402
from repro_torch.core.mlalgos.multinomial import (  # noqa: E402
    MultinomialLogReg, int_logits, multinomial_predict)
from repro_torch.core.mlalgos.svm import LinearSVM, svm_predict  # noqa: E402
from repro_torch.distributed import merge_plan as mp  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import (Backpressure, MicroBatchQueue,  # noqa: E402
                                 ModelRegistry, PredictRunner)
from repro_torch.serving.runner import BucketEntry  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402
from torch_parity import assert_bits_equal, rng, to_numpy  # noqa: E402

N, D = 96, 5
FP32_TOL = 1e-6      # x max|out|, see the module docstring
NEAR_TIE = 1e-4      # K-means: squared-distance gap of a near-tie


def _problem(name, seed=0):
    """Numpy requests and labels of ``name``'s shape, from ``seed``."""
    r = rng(seed)
    X = r.standard_normal((N, D)).astype(np.float32)
    if name == "multinomial":
        y = r.integers(0, 3, N).astype(np.int32)
    elif name in ("logreg", "svm"):
        y = (r.standard_normal(N) > 0).astype(np.float32)
    elif name == "kmeans":
        y = None
    else:
        y = r.standard_normal(N).astype(np.float32)
    return X, y


WORKLOADS = {
    "linreg": (lambda p: LinReg(lr=0.05, precision=p),
               lambda p: JLinReg(lr=0.05, precision=p)),
    "logreg": (lambda p: LogReg(lr=0.2, precision=p),
               lambda p: JLogReg(lr=0.2, precision=p)),
    "svm": (lambda p: LinearSVM(lr=0.05, precision=p),
            lambda p: JLinearSVM(lr=0.05, precision=p)),
    "multinomial": (lambda p: MultinomialLogReg(n_classes=3, lr=0.2,
                                                precision=p),
                    lambda p: JMultinomial(n_classes=3, lr=0.2,
                                           precision=p)),
    "kmeans": (lambda p: KMeans(k=4, precision=p),
               lambda p: JKMeans(k=4, precision=p)),
}


def _workload(name, precision="fp32"):
    return WORKLOADS[name][0](precision)


def _trained(name, precision="fp32", steps=8):
    """A port-trained state on the CPU: ``(workload, X, state)``."""
    wl = _workload(name, precision)
    X, y = _problem(name)
    return wl, X, api.fit(wl, make_cpu_grid(4), X, y, steps=steps).state


FWD = {"linreg": linreg_predict, "logreg": logreg_predict,
       "svm": svm_predict, "multinomial": multinomial_predict,
       "kmeans": kmeans_assign_points}


def _close(got, want, tol=FP32_TOL):
    got, want = to_numpy(got), to_numpy(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


class TestPredictProtocol:
    """Workload.predict: the eval forward at fp32, and pad-invariant at
    every precision (the bucketing contract)."""

    @pytest.mark.parametrize("name", sorted(FWD))
    def test_fp32_matches_eval_forward(self, name):
        wl, X, state = _trained(name)
        got, want = wl.predict(state, X), FWD[name](state, torch.tensor(X))
        if name == "kmeans":
            assert torch.equal(got, want)
        else:
            _close(got, want)

    @pytest.mark.parametrize("name", sorted(FWD))
    @pytest.mark.parametrize("precision", ["fp32", "int8"])
    def test_pad_invariance(self, name, precision):
        """Appended zero rows never change the first n outputs — zero
        rows cannot move a per-feature quantization absmax, and every
        forward reduction is row-local."""
        wl, X, state = _trained(name, precision)
        Xp = np.zeros((X.shape[0] + 13, D), np.float32)
        Xp[: X.shape[0]] = X
        assert_bits_equal(wl.predict(state, X),
                          wl.predict(state, Xp)[: X.shape[0]])

    def test_dtree_predicts_on_host(self):
        X, _ = _problem("linreg")
        y = (X[:, 0] > 0).astype(np.int32)
        wl = DecisionTree(max_depth=2, n_classes=2)
        res = wl.run(make_cpu_grid(4), X, y)
        pred = wl.predict(res.state, X)
        assert pred.shape == (N,)
        assert set(pred.tolist()) <= {0, 1}

    def test_dtree_refused_by_compiled_runner(self):
        """predict_device=False: the host-loop forward cannot be
        captured — the runner must refuse it loudly."""
        wl = DecisionTree(max_depth=2, n_classes=2)
        with pytest.raises(ValueError, match="predict_device"):
            PredictRunner(wl, state=None)


class TestPredictRunner:
    def test_bucketed_predict_matches_direct(self):
        """Every request size — sub-bucket, exact bucket, oversize
        split — returns exactly workload.predict on the unpadded
        rows."""
        wl, X, state = _trained("linreg")
        r = PredictRunner(wl, state, buckets=(8, 32))
        gen = rng(0)
        for n in (1, 3, 8, 9, 32, 33, 64, 77):
            Xq = gen.standard_normal((n, D)).astype(np.float32)
            assert_bits_equal(r.predict(Xq), wl.predict(state, Xq))

    def test_int8_bucketed_predict_matches_direct(self):
        wl, X, state = _trained("svm", "int8")
        r = PredictRunner(wl, state, buckets=(8, 32))
        assert_bits_equal(r.predict(X[:11]), wl.predict(state, X[:11]))

    def test_zero_steady_compile_misses(self):
        """The acceptance gate: after warmup, mixed request sizes —
        including oversize splits — never capture again."""
        wl, X, state = _trained("linreg")
        r = PredictRunner(wl, state, buckets=(8, 32))
        r.warmup(D)
        assert r.compile_misses == 2
        gen = rng(1)
        for n in (1, 5, 8, 17, 32, 40, 100):
            r.predict(gen.standard_normal((n, D)).astype(np.float32))
        assert r.steady_compile_misses == 0
        assert r.bucket_hits > 0

    def test_bucket_ladder_selection(self):
        wl, _, state = _trained("linreg")
        r = PredictRunner(wl, state, buckets=(8, 32, 128))
        assert r.bucket_for(1) == 8
        assert r.bucket_for(8) == 8
        assert r.bucket_for(9) == 32
        assert r.bucket_for(128) == 128
        assert r.bucket_for(129) is None

    def test_equal_configs_share_grid_cached_executables(self):
        """Two runners for equal estimator configs on one grid share
        entries — the second runner's warmup is all cache hits
        (fn_signature keys the workload by value)."""
        grid = make_cpu_grid(4)
        wl, X, state = _trained("linreg")
        a = PredictRunner(LinReg(lr=0.05), state, grid=grid)
        a.warmup(D)
        assert a.compile_misses == len(a.buckets)
        b = PredictRunner(LinReg(lr=0.05), state + 1.0, grid=grid)
        b.warmup(D)
        assert b.compile_misses == 0

    def test_state_is_argument_not_constant(self):
        """A hot-swapped state must change predictions through the SAME
        entry — the state is never baked in as a constant."""
        wl, X, state = _trained("linreg")
        r = PredictRunner(wl, state, buckets=(8,))
        r.warmup(D)
        before = to_numpy(r.predict(X[:4]))
        r.state = tree_map(lambda leaf: leaf * 2.0, state)
        after = to_numpy(r.predict(X[:4]))
        assert r.steady_compile_misses == 0
        assert not np.array_equal(before, after)

    def test_run_stream_matches_predict_in_order(self):
        wl, X, state = _trained("logreg")
        r = PredictRunner(wl, state, buckets=(8, 32))
        gen = rng(2)
        feed = [gen.standard_normal((n, D)).astype(np.float32)
                for n in (8, 3, 32, 17, 8)]
        outs = list(r.run_stream(feed))
        assert len(outs) == len(feed)
        for Xb, out in zip(feed, outs):
            assert_bits_equal(out, r.predict(Xb))

    def test_run_stream_rejects_oversize(self):
        wl, _, state = _trained("linreg")
        r = PredictRunner(wl, state, buckets=(8,))
        with pytest.raises(ValueError, match="ladder"):
            list(r.run_stream([np.zeros((9, D), np.float32)]))

    def test_input_validation(self):
        wl, _, state = _trained("linreg")
        r = PredictRunner(wl, state)
        with pytest.raises(ValueError, match="rows, features"):
            r.predict(np.zeros((D,), np.float32))
        with pytest.raises(ValueError, match="empty"):
            r.predict(np.zeros((0, D), np.float32))
        with pytest.raises(ValueError, match="positive"):
            PredictRunner(wl, state, buckets=(0, 8))

    def test_tensor_requests_equal_numpy_requests(self):
        """A request may be a tensor (rows on the card are copied on the
        card) or anything numpy takes: the same rows, the same bits."""
        wl, X, state = _trained("multinomial", "int8")
        r = PredictRunner(wl, state, buckets=(8, 32))
        assert_bits_equal(r.predict(torch.from_numpy(X[:20])),
                          r.predict(X[:20].tolist()))


class _StubRunner:
    """Scriptable predict target for queue tests (no torch dispatch)."""

    def __init__(self, delay_s=0.0, gate=None, fail=False):
        self.delay_s = delay_s
        self.gate = gate
        self.fail = fail
        self.batch_sizes = []

    def predict(self, X):
        if self.gate is not None:
            self.gate.wait()
        if self.fail:
            raise RuntimeError("model exploded")
        if self.delay_s:
            time.sleep(self.delay_s)
        self.batch_sizes.append(X.shape[0])
        return np.asarray(X).sum(axis=1)


class TestMicroBatchQueue:
    def test_results_match_and_latency_recorded(self):
        q = MicroBatchQueue(_StubRunner(), max_batch=8, max_wait_ms=1.0)
        rows = np.arange(20, dtype=np.float32).reshape(5, 4)
        tickets = [q.submit(r) for r in rows]
        got = np.asarray([t.get(timeout=10.0) for t in tickets])
        np.testing.assert_allclose(got, rows.sum(axis=1))
        q.close()
        s = q.stats()
        assert s["requests"] == 5
        assert all(t.latency_s >= 0 for t in tickets)
        assert "p50_ms" in s and "p99_ms" in s

    def test_backlog_coalesces_into_batches(self):
        """With the worker busy on a slow batch, followers pile up and
        must be served together — the coalescing win under load."""
        stub = _StubRunner(delay_s=0.02)
        q = MicroBatchQueue(stub, max_batch=64, max_wait_ms=1.0)
        tickets = [q.submit(np.zeros(3, np.float32), block=True)
                   for _ in range(40)]
        for t in tickets:
            t.get(timeout=10.0)
        q.close()
        assert q.batches_served < 40
        assert max(stub.batch_sizes) > 1

    def test_max_batch_bounds_coalescing(self):
        gate = threading.Event()
        q = MicroBatchQueue(_StubRunner(gate=gate), max_batch=4,
                            max_wait_ms=1.0)
        tickets = [q.submit(np.zeros(2, np.float32), block=True)
                   for _ in range(9)]
        gate.set()
        for t in tickets:
            t.get(timeout=10.0)
        q.close()
        assert q.batches_served >= 3          # 9 rows / max_batch 4

    def test_backpressure_surfaces_at_the_edge(self):
        gate = threading.Event()
        q = MicroBatchQueue(_StubRunner(gate=gate), max_batch=1,
                            max_wait_ms=0.5, max_pending=2)
        held = [q.submit(np.zeros(2, np.float32), block=True)]
        time.sleep(0.05)                      # worker blocks on gate
        for _ in range(2):
            held.append(q.submit(np.zeros(2, np.float32)))
        with pytest.raises(Backpressure):
            while True:                       # queue drain is racy by a
                held.append(                  # slot; the cap is 2 + the
                    q.submit(np.zeros(2, np.float32)))  # in-flight head
        gate.set()
        for t in held:
            t.get(timeout=10.0)
        q.close()

    def test_errors_propagate_to_every_ticket(self):
        q = MicroBatchQueue(_StubRunner(fail=True), max_batch=4,
                            max_wait_ms=1.0)
        t = q.submit(np.zeros(2, np.float32), block=True)
        with pytest.raises(RuntimeError, match="exploded"):
            t.get(timeout=10.0)
        q.close()

    def test_close_drains_submitted_requests(self):
        gate = threading.Event()
        q = MicroBatchQueue(_StubRunner(gate=gate), max_batch=4,
                            max_wait_ms=0.5)
        tickets = [q.submit(np.zeros(2, np.float32), block=True)
                   for _ in range(7)]
        gate.set()
        q.close()
        for t in tickets:
            assert t.get(timeout=0.1) == 0.0
        with pytest.raises(RuntimeError, match="closed"):
            q.submit(np.zeros(2, np.float32))

    def test_compiled_end_to_end_with_registry_version(self):
        """Full path: registry source, bucketed runner — results match
        the direct forward and tickets carry the serving version."""
        wl, X, state = _trained("linreg")
        reg = ModelRegistry(wl, state)
        reg.publish(state, version=3)
        q = MicroBatchQueue(reg, max_batch=8, max_wait_ms=1.0)
        tickets = [q.submit(X[i]) for i in range(6)]
        got = np.asarray([t.get(timeout=30.0) for t in tickets])
        q.close()
        assert_bits_equal(got, wl.predict(state, X[:6]))
        _close(got, linreg_predict(state, torch.tensor(X[:6])))
        assert all(t.version == 3 for t in tickets)


class TestModelRegistry:
    def _save(self, tmp_path, step, state, *, wrap=False):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        tree = {"model": state, "merge_error": torch.zeros(2)} if wrap \
            else state
        mgr.save(step, tree, extra={"step": step})
        return mgr

    def test_publish_and_current_snapshot(self):
        wl, X, state = _trained("linreg")
        reg = ModelRegistry(wl, state)
        with pytest.raises(RuntimeError, match="no published"):
            reg.current()
        reg.publish(state, version=0)
        version, runner = reg.current()
        assert version == 0 and reg.version == 0
        assert_bits_equal(runner.predict(X[:4]), wl.predict(state, X[:4]))

    def test_hot_swap_reuses_compiled_buckets(self):
        """Same-shaped new version on a shared grid: zero captures (the
        state is an input of the cached entries)."""
        grid = make_cpu_grid(4)
        wl, X, state = _trained("linreg")
        reg = ModelRegistry(wl, state, grid=grid)
        r0 = reg.publish(state, version=0)
        r0.warmup(D)
        old = reg.current()
        r1 = reg.publish(tree_map(lambda leaf: leaf * 2, state), version=1)
        r1.warmup(D)
        assert r1.compile_misses == 0
        assert reg.version == 1
        # the superseded snapshot keeps serving (no in-flight drop)
        assert_bits_equal(old[1].predict(X[:4]), wl.predict(state, X[:4]))

    def test_load_v1_bare_layout(self, tmp_path):
        wl, X, state = _trained("linreg")
        self._save(tmp_path, 5, state)
        reg = ModelRegistry(wl, torch.zeros_like(state),
                            ckpt_dir=str(tmp_path))
        assert reg.refresh() == 5
        _, runner = reg.current()
        assert_bits_equal(runner.state, state)
        assert runner.extra == {"step": 5}

    def test_load_v2_model_subtree_layout(self, tmp_path):
        """The Trainer's {"model": ..., "merge_*": ...} wrapping: the
        model subtree is selected by manifest name."""
        wl, X, state = _trained("linreg")
        self._save(tmp_path, 9, state, wrap=True)
        reg = ModelRegistry(wl, torch.zeros_like(state),
                            ckpt_dir=str(tmp_path))
        assert reg.refresh() == 9
        _, runner = reg.current()
        assert_bits_equal(runner.state, state)

    def test_leaves_take_the_templates_dtype(self, tmp_path):
        """A float64 leaf on disk restores as the template's float32."""
        wl, X, state = _trained("linreg")
        self._save(tmp_path, 2, state.double())
        reg = ModelRegistry(wl, torch.zeros_like(state),
                            ckpt_dir=str(tmp_path))
        reg.refresh()
        assert reg.current()[1].state.dtype == torch.float32
        assert_bits_equal(reg.current()[1].state, state)

    def test_refresh_skips_corrupt_newest(self, tmp_path):
        """sha256 validation: a tampered newest checkpoint is skipped
        and the newest VALID step is published instead — the restore
        path's trust model, inherited."""
        wl, X, state = _trained("linreg")
        mgr = self._save(tmp_path, 2, state)
        mgr.save(4, state + 1.0, extra={"step": 4})
        with open(os.path.join(mgr._step_path(4), "arrays.npz"),
                  "r+b") as f:
            f.seek(30)
            f.write(b"\xff\xff\xff\xff")
        reg = ModelRegistry(wl, torch.zeros_like(state),
                            ckpt_dir=str(tmp_path))
        assert reg.refresh() == 2
        assert_bits_equal(reg.current()[1].state, state)

    def test_refresh_without_newer_keeps_current(self, tmp_path):
        wl, X, state = _trained("linreg")
        self._save(tmp_path, 3, state)
        reg = ModelRegistry(wl, torch.zeros_like(state),
                            ckpt_dir=str(tmp_path))
        assert reg.refresh() == 3
        assert reg.refresh() == 3             # nothing newer: unchanged
        assert reg.version == 3

    def test_mismatched_layout_refused(self, tmp_path):
        wl, X, state = _trained("linreg")
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(1, {"something_else": torch.zeros(3)})
        reg = ModelRegistry(wl, torch.zeros_like(state),
                            ckpt_dir=str(tmp_path))
        with pytest.raises(ValueError, match="neither"):
            reg.load_step(1)

    def test_no_ckpt_dir_refuses_refresh(self):
        wl, _, state = _trained("linreg")
        reg = ModelRegistry(wl, state)
        with pytest.raises(RuntimeError, match="ckpt_dir"):
            reg.refresh()


# -- the shared entry under a hot swap ----------------------------------------


def test_hot_swap_two_threads_share_one_entry():
    """Two runners (versions v and v+1) replay one shared entry from two
    threads.  The entry's lock covers the state copy, the input copy, the
    replay and the clone, so each version's results are its own bit for
    bit.  The replay here is a CPU stand-in for the graph's: it reads the
    static state after a pause, where a state copied in by the other
    thread would show."""
    wl = LinReg()
    grid = make_cpu_grid(4)
    states = [torch.ones(D), torch.full((D,), -2.0)]
    runners = [PredictRunner(wl, s, grid=grid, buckets=(8,)) for s in states]
    key = runners[0].key(8, D)
    assert runners[1].key(8, D) == key

    static = [torch.zeros(D)]
    x, out = torch.zeros((8, D)), torch.zeros(8)

    def replay():
        time.sleep(5e-4)
        out.copy_(wl.predict(static[0], x))

    entry = BucketEntry(static, x, out, replay)
    mp.cache_put(grid, key, entry, runners[0]._fwd, runners[0]._fwd)
    rows = rng(3).standard_normal((40, 5, D)).astype(np.float32)
    wrong = []

    def serve(i):
        for Xb in rows:
            got = runners[i].predict(Xb)
            if not torch.equal(got, wl.predict(states[i], Xb)):
                wrong.append(i)

    threads = [threading.Thread(target=serve, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert wrong == []
    assert [r.compile_misses for r in runners] == [0, 0]


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_runners_on_one_grid_look_up_from_many_threads(warm):
    """Runners over one grid look the same key up from many threads at
    once, cold (the first lookups race to capture) or warm (the lookups
    race the cache's LRU reorder).  The grid's cache is one critical
    section: no lookup raises or misses, and the key is captured once in
    all."""
    old = sys.getswitchinterval()
    wl = LinReg()
    grid = make_cpu_grid(4)
    runners = [PredictRunner(wl, torch.full((D,), float(i)), grid=grid,
                             buckets=(8,)) for i in range(4)]
    if warm:
        runners[0].warmup(D)
    Xb = rng(4).standard_normal((5, D)).astype(np.float32)
    errors = []

    def serve(r):
        try:
            for _ in range(300):
                got = r.predict(Xb)
                if not torch.equal(got, wl.predict(r.state, Xb)):
                    errors.append("wrong")
        except Exception as e:          # noqa: BLE001 - the race's symptom
            errors.append(repr(e))

    threads = [threading.Thread(target=serve, args=(runners[i % 4],))
               for i in range(8)]
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert sum(r.compile_misses for r in runners) == 1


# -- the LUT, made once ---------------------------------------------------------


@pytest.mark.parametrize("name", ["logreg", "multinomial"])
def test_lut_predict_makes_no_new_table(name, monkeypatch):
    """``predict`` with a LUT activation builds its table once (per
    device), not on every call, and its outputs are those of a table
    built afresh, bit for bit."""
    wl = (LogReg(precision="int8", sigmoid="lut") if name == "logreg"
          else MultinomialLogReg(n_classes=3, precision="int8",
                                 softmax="lut"))
    X, y = _problem(name)
    state = api.fit(wl, make_cpu_grid(4), X, y, steps=4).state
    built = []
    real = lut_mod.build_lut

    def counting(*args, **kw):
        built.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(lut_mod, "build_lut", counting)
    got = wl.predict(state, X)
    first = len(built)
    assert first <= 1
    assert_bits_equal(wl.predict(state, X), got)
    assert len(built) == first

    Xt = torch.from_numpy(X)
    Xq = qz.quantize_symmetric(Xt, bits=BITS["int8"], axis=0)
    if name == "logreg":
        fresh = real(lut_mod._np_sigmoid, -8.0, 8.0, 1024)
        z = int_forward(Xq.values, quantize_weight(state, Xq.scale))
        want = lut_mod.lut_lookup(fresh, z)
    else:
        fresh = real(np.exp, -16.0, 0.0, 1024)
        z = int_logits(Xq.values, state, Xq.scale)
        e = lut_mod.lut_lookup(fresh, z - z.amax(dim=-1, keepdim=True))
        want = e / e.sum(dim=-1, keepdim=True)
    assert_bits_equal(got, want)


# -- the port against the JAX package ------------------------------------------

PARITY = [(name, p) for name in ("linreg", "logreg", "svm", "multinomial")
          for p in ("fp32", "int8")] + [("kmeans", "fp32"),
                                        ("kmeans", "int16")]
_JAX_STATES: dict = {}


def _jax_trained(name, precision):
    """A JAX-trained state (8 steps on a 4-lane grid) as numpy."""
    if (name, precision) not in _JAX_STATES:
        X, y = _problem(name)
        jwl = WORKLOADS[name][1](precision)
        res = japi.fit(jwl, jax_grid(4), jnp.asarray(X),
                       None if y is None else jnp.asarray(y), steps=8)
        _JAX_STATES[name, precision] = np.asarray(res.state)
    return _JAX_STATES[name, precision]


def _near_ties(centroids: np.ndarray, X: np.ndarray) -> np.ndarray:
    d = ((X[:, None, :].astype(np.float64) - centroids[None]) ** 2).sum(-1)
    two = np.sort(d, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) <= NEAR_TIE


@pytest.mark.parametrize("name,precision", PARITY)
def test_runner_matches_jax_runner(name, precision):
    """The port's runner against JAX's ``PredictRunner`` on one
    JAX-trained state and the same requests (sub-bucket, exact bucket,
    oversize), at the tolerances of the module docstring."""
    w = _jax_trained(name, precision)
    jr = JRunner(WORKLOADS[name][1](precision), jnp.asarray(w),
                 buckets=(8, 32))
    r = PredictRunner(_workload(name, precision),
                      interop.state_from_numpy(w, "cpu"), buckets=(8, 32))
    gen = rng(4)
    for n in (1, 7, 8, 30, 77):
        Xq = gen.standard_normal((n, D)).astype(np.float32)
        got, want = to_numpy(r.predict(Xq)), np.asarray(jr.predict(Xq))
        if name == "kmeans":
            Xd = Xq
            if precision != "fp32":
                q = jqz.quantize_symmetric(jnp.asarray(Xq), bits=16, axis=0)
                Xd = np.asarray(q.values, np.float32) * np.asarray(q.scale)
            keep = ~_near_ties(w, Xd)
            assert keep.sum() >= n // 2
            np.testing.assert_array_equal(got[keep], want[keep])
        else:
            _close(got, want)


@pytest.mark.parametrize("precision", ["int8", "int16"])
def test_request_integers_equal_jax(precision):
    """The request's quantized integers and scales, padded to its
    bucket, bit for bit with JAX's (the rows the graph's kernels read)."""
    Xp = np.zeros((32, D), np.float32)
    Xp[:19] = rng(5).standard_normal((19, D)).astype(np.float32)
    bits = BITS[precision]
    q = qz.quantize_symmetric(torch.from_numpy(Xp), bits=bits, axis=0)
    jq = jqz.quantize_symmetric(jnp.asarray(Xp), bits=bits, axis=0)
    assert_bits_equal(q.values, np.asarray(jq.values))
    assert_bits_equal(q.scale, np.asarray(jq.scale))


@pytest.mark.parametrize("wrap", [False, True], ids=["v1", "v2"])
def test_registry_restores_jax_checkpoints(tmp_path, wrap):
    """A checkpoint JAX's manager wrote (bare state or the Trainer's v2
    layout) publishes in the port's registry bit for bit."""
    w = _jax_trained("linreg", "int8")
    tree = ({"model": jnp.asarray(w), "merge_error": jnp.zeros((1, D))}
            if wrap else jnp.asarray(w))
    JManager(str(tmp_path), async_save=False).save(6, tree,
                                                   extra={"step": 6})
    reg = ModelRegistry(LinReg(precision="int8"), torch.zeros(D),
                        ckpt_dir=str(tmp_path))
    assert reg.refresh() == 6
    runner = reg.current()[1]
    assert_bits_equal(runner.state, w)
    assert runner.extra == {"step": 6}


def test_jax_registry_restores_port_checkpoint(tmp_path):
    """The reverse: JAX's registry publishes a v2 checkpoint the port's
    manager wrote, bit for bit."""
    wl, X, state = _trained("logreg", "int8")
    CheckpointManager(str(tmp_path), async_save=False).save(
        12, {"model": state, "merge_error": torch.zeros((1, D))})
    jreg = JRegistry(JLogReg(precision="int8"), jnp.zeros(D),
                     ckpt_dir=str(tmp_path))
    assert jreg.refresh() == 12
    assert_bits_equal(state, np.asarray(jreg.current()[1].state))


# -- the CLI ----------------------------------------------------------------------


def _cli(argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("workload,precision",
                         [("linreg", "int8"), ("multinomial", "int8"),
                          ("kmeans", "int16"), ("svm", "fp32")])
def test_cli_serves_on_cpu(workload, precision):
    out = _cli(["--workload", workload, "--precision", precision,
                "--requests", "64", "--rate", "4000", "--train-steps", "4",
                "--device", "cpu"])
    last = out.strip().splitlines()[-1]
    assert last.startswith(f"{workload}/{precision}: 64 requests")
    assert last.endswith("compile misses 4 (steady 0)")


def test_cli_restores_a_checkpoint(tmp_path):
    state = torch.from_numpy(rng(6).standard_normal(16).astype(np.float32))
    CheckpointManager(str(tmp_path), async_save=False).save(
        7, {"model": state})
    out = _cli(["--ckpt-dir", str(tmp_path), "--requests", "32",
                "--rate", "4000", "--device", "cpu"])
    assert "restored checkpoint step 7" in out
    assert "linreg/fp32: 32 requests" in out
