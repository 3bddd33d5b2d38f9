"""Port parity of out-of-core streaming fits (``api.fit`` over a
``repro_torch.data.StreamingDataset``): the port's counterpart of
``tests/test_streaming.py``.

* **Against the JAX package**: the streaming fit of LinReg (fp32, int8),
  LogReg int8 + LUT, LinearSVM int8 and MultinomialLogReg int8 + LUT on
  the same numpy data, with JAX's permutation injected
  (``StreamingDataset(permutation=)``), within
  ``test_torch_minibatch.py``'s bar: the JAX side is jitted (a divide by
  a constant is a multiply by its reciprocal there), so the final state
  within 1e-5·max|state| and the losses within rtol 1e-4.
* **The port against itself, bit for bit**: a ``shuffle=False`` single
  window against the resident full-batch fit; a rotation of one step a
  window against the resident minibatch fit at ``batch_size=part``; scan
  against python; int8 EF across windows; an armed empty ``FaultPlan``;
  ``Trainer.for_program`` against ``api.fit``, its resume, a NaN
  rollback that gathers its window again; and on a two-rank gloo mesh
  (``tests/torch_mesh_ref.py``) the mesh rotation against the mesh's
  resident minibatch fit.
* **Lifecycle**: labels ride in the stream, windows align with the
  cadence, controller plans and the tree are refused, the overlap
  statistics are recorded, the prefetch thread ends with the fit.
"""

import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import make_cpu_grid as jax_grid  # noqa: E402
from repro.core.mlalgos import LinearSVM as JLinearSVM  # noqa: E402
from repro.core.mlalgos import LinReg as JLinReg  # noqa: E402
from repro.core.mlalgos import LogReg as JLogReg  # noqa: E402
from repro.core.mlalgos import MultinomialLogReg as JMultinomial  # noqa: E402
from repro.core.mlalgos import api as japi  # noqa: E402
from repro.data import StreamingDataset as JStreamingDataset  # noqa: E402
from repro_torch.core import make_cpu_grid  # noqa: E402
from repro_torch.core.mlalgos import (DecisionTree, KMeans,  # noqa: E402
                                      LinearSVM, LinReg, LogReg,
                                      MultinomialLogReg, api)
from repro_torch.data import StreamingDataset  # noqa: E402
from repro_torch.distributed.compression import \
    CompressionConfig  # noqa: E402
from repro_torch.distributed.merge_plan import (AdaptiveCadence,  # noqa: E402
                                                MergePlan)
from repro_torch.resilience import FaultPlan, faults  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_minibatch import jax_permutation  # noqa: E402
from torch_parity import (assert_bits_equal, blobs,  # noqa: E402
                          classification, mixture, regression, to_numpy)
from torch_mesh_ref import STREAM_CELLS, run_world  # noqa: E402

LANES, ROWS, D = 8, 400, 6              # 50 slots a lane


def _data(seed=5):
    return regression(seed, ROWS, D)


def _equal(a, b):
    """States (a tensor or a tuple) and histories, bit for bit."""
    for x, y in zip(a.state if isinstance(a.state, tuple) else (a.state,),
                    b.state if isinstance(b.state, tuple) else (b.state,)):
        assert_bits_equal(x, y)
    assert len(a.history) == len(b.history)
    for ea, eb in zip(a.history, b.history):
        assert sorted(ea) == sorted(eb)
        for k in ea:
            assert_bits_equal(ea[k], eb[k])


# -- against the JAX package --------------------------------------------------


def _jax_case(name):
    """``(port workload, JAX workload, X, y)``."""
    if name.startswith("linreg"):
        X, y = regression(1, ROWS, D)
        prec = name.split()[1]
        return LinReg(lr=0.05, precision=prec), \
            JLinReg(lr=0.05, precision=prec), X, y
    if name == "logreg int8 lut":
        X, y = classification(2, ROWS, D)
        kw = dict(lr=0.5, precision="int8", sigmoid="lut")
        return LogReg(**kw), JLogReg(**kw), X, y
    if name == "svm int8":
        X, y = classification(3, ROWS, D)
        kw = dict(lr=0.1, precision="int8")
        return LinearSVM(**kw), JLinearSVM(**kw), X, y
    X, y = mixture(4, ROWS, D, 4)
    kw = dict(n_classes=4, lr=0.5, precision="int8", softmax="lut")
    return MultinomialLogReg(**kw), JMultinomial(**kw), X, y


@pytest.mark.parametrize("name", ["linreg fp32", "linreg int8",
                                  "logreg int8 lut", "svm int8",
                                  "multinomial int8 lut"])
def test_streaming_fit_tracks_jax(name):
    """Two steps a window over the padded epoch of 5 windows (part 12 of
    50 slots), 12 steps, then 8 at cadence 2, against JAX's streaming fit
    of the same rows."""
    wl, jwl, X, y = _jax_case(name)
    for steps, k in ((12, 1), (8, 2)):
        kw = dict(partition_rows=96, steps_per_window=2, seed=3)
        res = api.fit(wl, make_cpu_grid(LANES),
                      StreamingDataset(X, y, permutation=jax_permutation,
                                       **kw), steps=steps, merge_every=k)
        ref = japi.fit(jwl, jax_grid(LANES), JStreamingDataset(X, y, **kw),
                       steps=steps, merge_every=k)
        got, want = to_numpy(res.state), np.asarray(ref.state)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        np.testing.assert_allclose(
            [float(m["loss"]) for m in res.history],
            [float(m["loss"]) for m in ref.history], rtol=1e-4)


# -- the port against itself --------------------------------------------------


@pytest.mark.parametrize("precision,k", [("fp32", 1), ("int8", 4)])
def test_single_window_equals_resident_full_batch(precision, k):
    X, y = classification(6, ROWS, D)
    wl = LogReg(lr=0.5, precision=precision,
                sigmoid="lut" if precision == "int8" else "exact")
    grid = make_cpu_grid(LANES)
    sd = StreamingDataset(X, y, partition_rows=ROWS, steps_per_window=4,
                          shuffle=False)
    assert wl.bind_stream(grid, sd).data.exact_full
    _equal(api.fit(wl, grid, sd, steps=12, merge_every=k),
           api.fit(wl, grid, X, y, steps=12, merge_every=k))


@pytest.mark.parametrize("name", ["linreg fp32", "linreg int8", "svm int8",
                                  "logreg int8 lut", "kmeans int16"])
def test_rotation_equals_resident_minibatch(name):
    """One step a window: the sampler's schedule lifted to the host, the
    quantized paths on the whole dataset's scales."""
    if name == "kmeans int16":
        X = blobs(7, ROWS, D, 4)
        wl, y = KMeans(k=4, precision="int16", seed=2), None
    elif name.startswith("linreg"):
        X, y = _data()
        wl = LinReg(lr=0.05, precision=name.split()[1])
    else:
        X, y = classification(8, ROWS, D)
        wl = (LinearSVM(lr=0.05, precision="int8") if name == "svm int8"
              else LogReg(lr=0.5, precision="int8", sigmoid="lut"))
    grid = make_cpu_grid(LANES)
    sd = StreamingDataset(X, y, partition_rows=96, steps_per_window=1,
                          seed=3)
    part = wl.bind_stream(grid, sd).data.part
    _equal(api.fit(wl, grid, sd, steps=14),
           api.fit(wl, grid, X, y, steps=14, batch_size=part, sample_seed=3))


@pytest.mark.parametrize("k", [1, 4])
def test_scan_equals_python(k):
    X, y = _data()
    grid = make_cpu_grid(4)
    sd = StreamingDataset(X, y, partition_rows=120, steps_per_window=2 * k,
                          seed=1)
    _equal(api.fit(LinReg(lr=0.05), grid, sd, steps=12, merge_every=k),
           api.fit(LinReg(lr=0.05), grid, sd, steps=12, merge_every=k,
                   engine="python"))


def test_ef_buffer_continues_across_windows():
    """int8 EF: the buffer rides ``merge_state`` across windows as across
    fits, so the rotation equals the resident minibatch fit under EF."""
    X, y = _data()
    grid = make_cpu_grid(4)
    comp = CompressionConfig(bits=8)
    sd = StreamingDataset(X, y, partition_rows=120, steps_per_window=1,
                          seed=6)
    part = LinReg(lr=0.05).bind_stream(grid, sd).data.part
    ms_s, ms_r = {}, {}
    rs = api.fit(LinReg(lr=0.05), grid, sd, steps=12,
                 merge_compression=comp, merge_state=ms_s)
    rr = api.fit(LinReg(lr=0.05), grid, X, y, steps=12,
                 merge_compression=comp, merge_state=ms_r, batch_size=part,
                 sample_seed=6)
    _equal(rs, rr)
    got, want = tree_leaves(ms_s["error"]), tree_leaves(ms_r["error"])
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert_bits_equal(a, b)


def test_armed_empty_plan_equals_unarmed():
    """Each window's fit goes through the armed hook: an empty plan on
    the exact wire changes no bit."""
    X, y = _data()
    grid = make_cpu_grid(LANES)
    sd = StreamingDataset(X, y, partition_rows=96, steps_per_window=4,
                          seed=2)
    wl = LinReg(lr=0.05, precision="int8")
    ms = {}
    with faults.armed(FaultPlan()):
        armed = api.fit(wl, grid, sd, steps=16, merge_every=4,
                        merge_state=ms)
    _equal(armed, api.fit(wl, grid, sd, steps=16, merge_every=4))
    assert ms["resilience_report"]["restarts"] == 0
    assert ms["streaming_trace"]["windows"] == 4


# -- the Trainer --------------------------------------------------------------


def _program(part_rows=96, seed=3, depth=2):
    X, y = _data()
    sd = StreamingDataset(X, y, partition_rows=part_rows,
                          steps_per_window=2, seed=seed,
                          prefetch_depth=depth)
    return LinReg(lr=0.05).bind_stream(make_cpu_grid(4), sd)


def _cfg(path, **kw):
    return TrainerConfig(ckpt_dir=str(path), **{
        "ckpt_every": 4, "log_every": 100, **kw})


@pytest.mark.parametrize("k,depth", [(1, 2), (2, 0)])
def test_trainer_equals_api_fit_and_tags_checkpoints(tmp_path, k, depth):
    tr = Trainer.for_program(_program(depth=depth),
                             _cfg(tmp_path, merge_every=k, ckpt_keep=100))
    out = tr.run(12)
    ref = _program(depth=depth).fit(steps=12, merge_every=k)
    assert_bits_equal(tr.state, ref.state)
    assert [e["loss"] for e in out["history"]] == \
        [float(m["loss"]) for m in ref.history]
    assert tr.batch_fn._pf is None          # the feed's thread has ended
    steps = tr.ckpt.steps()
    assert steps
    for step in steps:
        with open(os.path.join(tr.ckpt.dir, f"step_{step:010d}",
                               "manifest.json")) as f:
            extra = json.load(f)["extra"]
        assert extra["stream_tag"] == _program().stream_tag
        assert extra["rotation_window"] == step // 2


def test_trainer_resume_is_exact(tmp_path):
    full = Trainer.for_program(_program(), _cfg(tmp_path / "a"))
    full.run(12)
    Trainer.for_program(_program(), _cfg(tmp_path / "b")).run(8)
    resumed = Trainer.for_program(_program(), _cfg(tmp_path / "b"))
    assert resumed.start_step == 8
    resumed.run(4)
    assert_bits_equal(resumed.state, full.state)


def test_trainer_nan_rollback_gathers_its_window_again(tmp_path):
    """A NaN loss at step 5 rolls back to the step-4 checkpoint; the feed
    sees a step out of order and gathers window 2 again; the run ends
    bit-equal to a clean one."""
    clean = Trainer.for_program(_program(), _cfg(tmp_path / "clean",
                                                 log_every=2))
    clean.run(12)
    prog = _program()
    rot = prog.data
    gathered = []
    host = rot.window_host

    def counted(t):
        gathered.append(t)
        return host(t)

    rot.window_host = counted
    tr = Trainer.for_program(prog, _cfg(tmp_path / "nan", log_every=2))
    orig, calls = tr.step_fn, {"n": 0}

    def poisoned(state, batch):
        state, m = orig(state, batch)
        calls["n"] += 1
        if calls["n"] == 6:
            m = dict(m, loss=m["loss"] * float("nan"))
        return state, m

    tr.step_fn = poisoned
    out = tr.run(12)
    assert out["restarts"] == 1
    assert gathered.count(2) >= 2
    assert_bits_equal(tr.state, clean.state)


def test_trainer_refuses_another_rotation(tmp_path):
    Trainer.for_program(_program(part_rows=96),
                        _cfg(tmp_path, ckpt_every=2)).run(4)
    with pytest.raises(ValueError, match="rotation schedule"):
        Trainer.for_program(_program(part_rows=200),
                            _cfg(tmp_path, ckpt_every=2))


# -- lifecycle ----------------------------------------------------------------


def test_labels_ride_inside_the_stream():
    X, y = _data()
    sd = StreamingDataset(X, y, partition_rows=64)
    with pytest.raises(ValueError, match="y=None"):
        api.fit(LinReg(), make_cpu_grid(4), sd, y, steps=2)


def test_cadence_alignment_enforced():
    X, y = _data()
    sd = StreamingDataset(X, y, partition_rows=64, steps_per_window=3)
    with pytest.raises(ValueError, match="cadence"):
        api.fit(LinReg(), make_cpu_grid(4), sd, steps=6, merge_every=2)


@pytest.mark.parametrize("plan", ["auto",
                                  MergePlan(outer=AdaptiveCadence(k_max=4))])
def test_controller_plans_refused(plan):
    X, y = _data()
    sd = StreamingDataset(X, y, partition_rows=64)
    with pytest.raises(ValueError, match="controller plans"):
        api.fit(LinReg(), make_cpu_grid(4), sd, steps=4, merge_plan=plan)


def test_tree_refused():
    X, y = _data()
    sd = StreamingDataset(X, (y > 0).astype(np.int32), partition_rows=64)
    with pytest.raises(ValueError, match="does not support"):
        DecisionTree().bind_stream(make_cpu_grid(4), sd)
    with pytest.raises(ValueError, match="does not support"):
        api.fit(DecisionTree(), make_cpu_grid(4), sd, steps=2)


@pytest.mark.parametrize("depth", [0, 2])
def test_overlap_stats_recorded_and_the_worker_ends(depth):
    X, y = _data()
    before = threading.active_count()
    sd = StreamingDataset(X, y, partition_rows=120, steps_per_window=2,
                          prefetch_depth=depth)
    ms = {}
    api.fit(LinReg(lr=0.05), make_cpu_grid(4), sd, steps=12, merge_state=ms)
    stats = ms["streaming_trace"]
    assert stats["windows"] == 6 and stats["prefetch_depth"] == depth
    assert stats["windows_per_epoch"] == 4 and stats["steps_per_window"] == 2
    assert 0.0 <= stats["ingest_overlap_fraction"] <= 1.0
    assert stats["ingest_s"] > 0.0 and stats["stall_s"] >= 0.0
    assert threading.active_count() == before


def test_a_fit_gathers_each_window_once():
    """The prefetcher stops at the fit's last window: no window past the
    end is gathered (``close`` would wait for it)."""
    X, y = _data()
    sd = StreamingDataset(X, y, partition_rows=120, steps_per_window=2,
                          prefetch_depth=3)
    prog = LinReg(lr=0.05).bind_stream(make_cpu_grid(4), sd)
    gathered = []
    host = prog.data.window_host

    def counted(t):
        gathered.append(t)
        return host(t)

    prog.data.window_host = counted
    prog.fit(steps=11)
    assert gathered == [0, 1, 2, 3, 4, 5]


def test_a_failed_gather_ends_the_fit_with_its_error():
    X, y = _data()
    sd = StreamingDataset(X, y, partition_rows=120, steps_per_window=2)
    prog = LinReg(lr=0.05).bind_stream(make_cpu_grid(4), sd)
    host = prog.data.window_host

    def failing(t):
        if t == 2:
            raise MemoryError("gather of window 2 failed")
        return host(t)

    prog.data.window_host = failing
    with pytest.raises(MemoryError, match="window 2"):
        prog.fit(steps=12)


# -- a mesh of two gloo ranks -------------------------------------------------


def test_mesh_rotation_equals_mesh_resident_minibatch(tmp_path):
    """Each rank gathers its 8 lanes' rows (the window and its scale are
    ``(8, ...)``); the rotation equals the same mesh's resident minibatch
    fit bit for bit, and the ranks agree."""
    ranks = run_world("stream_mesh_scenario", 2, str(tmp_path / "world"),
                      timeout=240.0)
    for r in ranks:
        assert r["n_local"] == 8
        for cell in STREAM_CELLS:
            c = r[cell]
            assert c["window_lanes"] == 8 and c["scale_shape"] == (8,)
            assert_bits_equal(c["stream"][0], c["resident"][0])
            assert c["stream"][1] == c["resident"][1]
            assert_bits_equal(c["stream"][0], ranks[0][cell]["stream"][0])
