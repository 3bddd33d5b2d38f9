"""Port parity of the fault-tolerant training loop (``repro_torch.runtime``),
the recovery policy (``repro_torch.resilience``) and
``Program.step_fn``/``round_fn``.

The port's counterparts of ``tests/test_runtime.py`` (``TestTrainer``,
``TestFusedFiniteParity``, ``TestAsyncMetricsSink``),
``test_merge_cadence.py::TestTrainerCadence``, the trainer tests of
``test_merge_plan.py::TestSlowMoContinuation`` and
``test_overlap_compression.py::TestTrainerCheckpointsEF``,
``test_resilience.py::TestTrainerRecovery`` and ``TestRecoveryPolicy``
(each value against JAX's on the same inputs),
``test_workload_api.py::TestTrainerIntegration`` and
``test_resilience_restart.py`` (SIGKILL and resume, bit for bit, in a
child process: ``tests/torch_trainer_ref.py``).  Beside them: the mesh
refusal, a kernel build or launch error raised at once, and JAX's
trainer and the port's resuming each other's checkpoints.

Tolerances: the port's own runs are compared bit for bit (a trainer
runs the calls ``Program.fit`` runs, in the same order).  Against JAX,
trajectories use ``tests/test_torch_train.py``'s bar: the JAX side is
jitted (a divide by a constant becomes a multiply by its reciprocal),
so final states agree within 1e-5·max|w| and losses within rtol 1e-4.
"""

import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import make_cpu_grid as jax_grid  # noqa: E402
from repro.core.mlalgos import LogReg as JLogReg  # noqa: E402
from repro.distributed.compression import \
    CompressionConfig as JCompressionConfig  # noqa: E402
from repro.distributed.merge_plan import MergePlan as JMergePlan  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.resilience import recovery as jrecovery  # noqa: E402
from repro.runtime import Trainer as JTrainer  # noqa: E402
from repro.runtime import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.core import make_cpu_grid, make_mesh_grid  # noqa: E402
from repro_torch.core.mlalgos import LinReg, LogReg  # noqa: E402
from repro_torch.distributed.compression import \
    CompressionConfig  # noqa: E402
from repro_torch.distributed.merge_plan import (AdaptiveCadence,  # noqa: E402
                                                MergePlan, SlowMo)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.optim.optimizers import slow_momentum  # noqa: E402
from repro_torch.resilience import (DivergenceDetector,  # noqa: E402
                                    RecoveryPolicy, replay_trace)
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402
from repro_torch.runtime.trainer import _MetricsSink, to_host  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_minibatch import jax_permutation  # noqa: E402
from torch_parity import (assert_bits_equal, classification,  # noqa: E402
                          regression, to_numpy)
import torch_trainer_ref as ref  # noqa: E402

INT8 = CompressionConfig(bits=8, error_feedback=True)
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")


def _toy(tmp_path, *, fail_at=None, subdir="", **cfg):
    """``tests/test_runtime.py``'s toy trainer: w -= 0.1·g with g =
    step % 3, loss |w|², a NaN loss at call ``fail_at``."""
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        w = state["w"] - 0.1 * batch["g"]
        loss = (w ** 2).sum()
        if fail_at is not None and calls["n"] == fail_at:
            loss = torch.tensor(float("nan"))
        return {"w": w}, {"loss": loss}

    def batch_fn(step):
        return {"g": torch.ones(2) * (step % 3)}

    base = dict(ckpt_dir=str(tmp_path / subdir) if subdir is not None
                else None, ckpt_every=2, max_restarts=2, log_every=100)
    base.update(cfg)
    return Trainer(step_fn, {"w": torch.ones(2)}, batch_fn,
                   TrainerConfig(**base)), calls


def _steps(out):
    return [e["step"] for e in out["history"]]


# -- TestTrainer ---------------------------------------------------------------


def test_runs_and_checkpoints(tmp_path):
    tr, _ = _toy(tmp_path)
    out = tr.run(6)
    assert out["final_step"] == 6 and out["restarts"] == 0
    assert tr.ckpt.latest_step() is not None


def test_nan_triggers_restore_and_replay(tmp_path):
    tr, _ = _toy(tmp_path, fail_at=6)
    out = tr.run(8)
    assert out["restarts"] == 1 and out["final_step"] == 8


@pytest.mark.parametrize("mode", ["sync", "fused=False", "async"])
def test_poisoned_window_never_reaches_history(tmp_path, mode):
    """A NaN at call 7 (step 6, the second of window [5, 6]): the finite
    step 5 must not be flushed before the raise, or the replay records
    it twice.  Under every flush (fused, legacy, background)."""
    kw = {"sync": {}, "fused=False": {"fused_finite": False},
          "async": {"async_metrics": True}}[mode]
    tr, _ = _toy(tmp_path, fail_at=7, **kw)
    out = tr.run(10)
    assert out["restarts"] == 1
    steps = _steps(out)
    assert steps.count(5.0) == 1 and steps.count(6.0) == 1


def test_auto_resume_from_checkpoint(tmp_path):
    tr1, _ = _toy(tmp_path)
    tr1.run(5)
    tr2, _ = _toy(tmp_path)
    assert tr2.start_step == 5
    assert_bits_equal(tr2.state["w"], tr1.state["w"])


def test_straggler_accounting():
    import time as _t
    times = iter([0.01] * 8 + [0.5] + [0.01] * 3)

    def step_fn(state, batch):
        _t.sleep(next(times, 0.01))
        return state, {"loss": torch.zeros(())}

    tr = Trainer(step_fn, {"w": torch.zeros(())}, lambda s: {},
                 TrainerConfig())
    assert tr.run(12)["stragglers"] >= 1


# -- TestFusedFiniteParity and TestAsyncMetricsSink ---------------------------


@pytest.mark.parametrize("other", [{"fused_finite": False},
                                   {"async_metrics": True}])
@pytest.mark.parametrize("fail_at", [None, 6])
def test_flush_modes_give_identical_histories(tmp_path, other, fail_at):
    """The fused flush against the legacy one and the background sink:
    the same steps in the same order, the same losses bit for bit, the
    same restarts."""
    a, _ = _toy(tmp_path, subdir="a", fail_at=fail_at)
    b, _ = _toy(tmp_path, subdir="b", fail_at=fail_at, **other)
    n = 12 if fail_at is None else 8
    out_a, out_b = a.run(n), b.run(n)
    assert out_a["restarts"] == out_b["restarts"] == (fail_at is not None)
    assert _steps(out_a) == _steps(out_b)
    assert [e["loss"] for e in out_a["history"]] \
        == [e["loss"] for e in out_b["history"]]


@pytest.mark.parametrize("async_metrics", [False, True])
def test_error_without_checkpoint_raises(async_metrics):
    tr, _ = _toy(None, subdir=None, fail_at=2, async_metrics=async_metrics)
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        tr.run(4)


def test_callback_sees_verified_entry(tmp_path):
    seen_a, seen_s = [], []
    _toy(tmp_path, subdir="a", async_metrics=True, log_every=3)[0].run(
        9, callback=lambda s, e: seen_a.append((s, e["loss"])))
    _toy(tmp_path, subdir="s", log_every=3)[0].run(
        9, callback=lambda s, e: seen_s.append((s, e["loss"])))
    assert seen_a == seen_s and [s for s, _ in seen_s] == [0, 3, 6]


def test_vector_loss_reports_floating_point_error():
    def step_fn(state, batch):
        return state, {"loss": torch.tensor([1.0, float("nan"), 2.0])}

    tr = Trainer(step_fn, {"w": torch.zeros(())}, lambda s: {},
                 TrainerConfig(fused_finite=True))
    with pytest.raises(FloatingPointError, match="non-finite loss nan"):
        tr.run(2)


def test_metrics_without_loss_key():
    def step_fn(state, batch):
        return state, {"throughput": torch.ones(())}

    tr = Trainer(step_fn, {"w": torch.zeros(())}, lambda s: {},
                 TrainerConfig(fused_finite=True))
    out = tr.run(3)
    assert len(out["history"]) == 3
    assert out["history"][0]["throughput"] == 1.0


def test_to_host_keeps_dtypes_shapes_and_values():
    vals = [torch.tensor(1.5), torch.arange(6, dtype=torch.int32).reshape(
        2, 3), torch.tensor(True), torch.tensor([0.25, -1.0]), 3.0,
            torch.tensor(2.5, dtype=torch.float64)]
    host = to_host(vals)
    for v, h in zip(vals, host):
        if isinstance(v, torch.Tensor):
            assert_bits_equal(h, v)
        else:
            assert h == v


def test_history_entries_are_host_floats(tmp_path):
    tr, _ = _toy(tmp_path)
    entry = tr.run(3)["history"][0]
    assert set(entry) == {"loss", "step", "wall_time", "stragglers"}
    assert all(type(v) is float for v in entry.values())


def test_background_sink_under_a_short_switch_interval(tmp_path):
    """A stress test of the sink's thread: a window a step for 240 steps,
    a NaN the first time steps 52 and 181 run, the interpreter switching
    threads every microsecond.  The history must equal the in-line
    flush's entry for entry (a lost or reordered append would break it);
    as in the JAX package, verified steps between the last checkpoint and
    a failure are replayed and appear twice in both."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        outs = []
        for sub, kw in (("s", {}), ("a", {"async_metrics": True})):
            poisoned = {52, 181}

            def step_fn(state, batch, poisoned=poisoned):
                w = state["w"] - 0.1 * batch["g"]
                loss = (w ** 2).sum()
                if batch["step"] in poisoned:
                    poisoned.discard(batch["step"])
                    loss = torch.tensor(float("nan"))
                return {"w": w}, {"loss": loss}

            cfg = TrainerConfig(ckpt_dir=str(tmp_path / sub), ckpt_every=7,
                                log_every=1, max_restarts=4, **kw)
            tr = Trainer(step_fn, {"w": torch.ones(2)},
                         lambda step: {"g": torch.ones(2) * (step % 3),
                                       "step": step}, cfg)
            outs.append(tr.run(240))
    finally:
        sys.setswitchinterval(old)
    sync_out, async_out = outs
    assert sync_out["restarts"] == async_out["restarts"] == 2
    assert _steps(async_out) == _steps(sync_out)
    assert sorted(set(_steps(async_out))) == list(map(float, range(240)))
    assert [e["loss"] for e in async_out["history"]] \
        == [e["loss"] for e in sync_out["history"]]


def test_sink_close_is_idempotent_and_rejects_late_submits():
    sink = _MetricsSink(lambda window: None)
    sink.submit([(0, {"loss": 1.0}, 0.0, 0)])
    sink.close()
    sink.close()
    assert not sink._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        sink.submit([(1, {"loss": 1.0}, 0.0, 0)])
    sink.drain()


def test_sink_close_registered_with_atexit(monkeypatch):
    import atexit

    reg, unreg = [], []
    monkeypatch.setattr(atexit, "register",
                        lambda f, *a, **k: reg.append(f) or f)
    monkeypatch.setattr(atexit, "unregister", lambda f: unreg.append(f))
    sink = _MetricsSink(lambda window: None)
    assert sink.close in reg
    sink.close()
    assert sink.close in unreg


def test_queued_window_failure_surfaces_at_drain_after_interrupt():
    """A window still queued when the run is interrupted flushes during
    close and parks its failure where a later ``drain()`` finds it."""
    import threading

    gate = threading.Event()

    def step_fn(state, batch):
        calls = state["n"] + 1
        if int(calls) == 5:
            gate.set()                # let the consumer catch up
            raise RuntimeError("interrupted")
        loss = torch.tensor(float("nan")) if int(calls) == 3 \
            else state["w"].sum()
        return {"w": state["w"], "n": calls}, {"loss": loss}

    cfg = TrainerConfig(async_metrics=True, log_every=3, max_restarts=0)
    tr = Trainer(step_fn, {"w": torch.ones(2), "n": torch.zeros(())},
                 lambda s: None, cfg)
    orig_flush = tr._flush

    def gated_flush(window):
        gate.wait(10.0)
        return orig_flush(window)

    tr._flush = gated_flush
    with pytest.raises(RuntimeError, match="interrupted"):
        tr.run(9)
    with pytest.raises(FloatingPointError, match="non-finite"):
        tr._sink.drain()
    tr._sink.drain()


# -- TestTrainerCadence ----------------------------------------------------------


@pytest.mark.parametrize("k,n,want", [(3, 7, [2, 5, 6]), (1, 3, [0, 1, 2])])
def test_flush_only_at_merge_boundaries(k, n, want):
    def step_fn(state, batch):
        w = state["w"] - 0.1
        return {"w": w}, {"loss": (w ** 2).sum()}

    tr = Trainer(step_fn, {"w": torch.ones(2)}, lambda s: None,
                 TrainerConfig(log_every=1, merge_every=k))
    seen = []
    tr.run(n, callback=lambda step, m: seen.append(step))
    assert seen == want
    assert [e["step"] for e in tr.history] == list(range(n))


def test_no_spurious_early_checkpoint(tmp_path):
    def step_fn(state, batch):
        return {"w": state["w"] - 0.1}, {"loss": torch.zeros(())}

    cfg = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=100,
                        merge_every=8, log_every=1000)
    tr = Trainer(step_fn, {"w": torch.ones(())}, lambda s: {}, cfg)
    tr.run(20)
    tr.ckpt.wait()
    assert tr.ckpt.steps() == [19]


# -- the merge-state holder: v2 layout, EF and momentum ----------------------


def _holder_trainer(tmp_path, holder, compression=INT8, ckpt_every=5):
    def step_fn(state, batch):
        w = state["w"] - 0.1 * batch["g"]
        return {"w": w}, {"loss": (w ** 2).sum()}

    cfg = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=ckpt_every,
                        log_every=100, merge_compression=compression)
    return Trainer(step_fn, {"w": torch.ones(3)},
                   lambda s: {"g": torch.ones(3)}, cfg, merge_state=holder)


def test_trainer_checkpoints_ef_and_momentum(tmp_path):
    opt = slow_momentum(1.0, beta=0.5)
    holder = {"error": {"g": torch.tensor([0.5, -0.25, 0.0])},
              "momentum": opt.init({"w": torch.tensor([0.25, -0.5, 1.0])})}
    tr = _holder_trainer(tmp_path, holder)
    tr.run(10)
    holder2 = {"error": {"g": torch.zeros(3)},
               "momentum": opt.init({"w": torch.zeros(3)})}
    tr2 = _holder_trainer(tmp_path, holder2)
    assert tr2.start_step == 10
    assert_bits_equal(holder2["error"]["g"], holder["error"]["g"])
    assert_bits_equal(holder2["momentum"].inner["w"],
                      holder["momentum"].inner["w"])
    assert_bits_equal(holder2["momentum"].step, holder["momentum"].step)
    assert_bits_equal(tr2.state["w"], tr.state["w"])


def test_compression_mismatch_refuses_resume(tmp_path):
    _holder_trainer(tmp_path, {"error": {"g": torch.zeros(3)}}).run(10)
    with pytest.raises(ValueError, match="compression"):
        _holder_trainer(tmp_path, {"error": {"g": torch.zeros(3)}},
                        compression=CompressionConfig(bits=4))


def test_unseeded_holder_resume_gives_clear_error(tmp_path):
    _holder_trainer(tmp_path, {"error": {"g": torch.zeros(3)}}).run(10)
    with pytest.raises(ValueError, match="init_merge_error"):
        _holder_trainer(tmp_path, {})


def test_seeded_holder_resumes_bare_checkpoint(tmp_path):
    tr = _holder_trainer(tmp_path, None, compression=None)
    tr.run(10)
    seeded = {"error": {"g": torch.tensor([0.5, 0.5, 0.5])}}
    tr2 = _holder_trainer(tmp_path, seeded)
    assert tr2.start_step == 10
    assert_bits_equal(tr2.state["w"], tr.state["w"])
    assert_bits_equal(seeded["error"]["g"], torch.tensor([0.5, 0.5, 0.5]))


def test_midrun_recovery_through_bare_checkpoint(tmp_path):
    def ok_step(state, batch):
        return {"w": state["w"] - 0.1}, {"loss": torch.zeros(())}

    Trainer(ok_step, {"w": torch.ones(2)}, lambda s: {},
            TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=2,
                          log_every=1)).run(6)
    calls = {"n": 0}

    def flaky_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected fault")
        return ok_step(state, batch)

    tr = Trainer(flaky_step, {"w": torch.ones(2)}, lambda s: {},
                 TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=2,
                               log_every=1, merge_compression=INT8),
                 merge_state={"error": {"g": torch.zeros(2)}})
    assert tr.run(4)["restarts"] == 1


def test_genuine_structure_mismatch_not_misdiagnosed(tmp_path):
    def step_fn(state, batch):
        return state, {"loss": torch.zeros(())}

    cfg = TrainerConfig(ckpt_dir=str(tmp_path))
    Trainer(step_fn, {"w": torch.ones(2)}, lambda s: {}, cfg).run(3)
    with pytest.raises(ValueError, match="structure mismatch"):
        Trainer(step_fn, {"renamed": torch.ones(2)}, lambda s: {}, cfg)


def test_merge_plan_config_spelling(tmp_path):
    plan = MergePlan(cadence=2, compression=INT8)

    def step_fn(state, batch):
        return {"w": state["w"] - 0.1}, {"loss": torch.zeros(())}

    tr = Trainer(step_fn, {"w": torch.ones(2)}, lambda s: {},
                 TrainerConfig(ckpt_dir=str(tmp_path), merge_plan=plan),
                 merge_state={"error": {"g": torch.zeros(2)}})
    assert tr._merge_every == 2
    assert tr._compression_tag() == repr(INT8) \
        == repr(JCompressionConfig(bits=8, error_feedback=True))
    with pytest.raises(ValueError, match="not both"):
        Trainer(step_fn, {"w": torch.ones(2)}, lambda s: {},
                TrainerConfig(merge_plan=plan, merge_every=4))
    for bad in (MergePlan(outer=AdaptiveCadence()), "auto"):
        with pytest.raises(ValueError, match="adaptive"):
            Trainer(step_fn, {"w": torch.ones(2)}, lambda s: {},
                    TrainerConfig(merge_plan=bad))


def test_stream_tag_drift_is_refused(tmp_path):
    def step_fn(state, batch):
        return state, {"loss": torch.zeros(())}

    cfg = TrainerConfig(ckpt_dir=str(tmp_path))
    Trainer(step_fn, {"w": torch.ones(2)}, lambda s: {}, cfg,
            stream_tag="rows=64/part=8/seed=0", stream_spw=4).run(3)
    with pytest.raises(ValueError, match="rotation schedule"):
        Trainer(step_fn, {"w": torch.ones(2)}, lambda s: {}, cfg)


# -- the recovery policy against JAX's ------------------------------------------


def test_recovery_policy_equals_jax():
    kw = dict(backoff_base_s=0.1, backoff_factor=2.0, backoff_max_s=0.5)
    pol, jpol = RecoveryPolicy(**kw), jrecovery.RecoveryPolicy(**kw)
    assert [pol.backoff_s(n) for n in range(12)] \
        == [jpol.backoff_s(n) for n in range(12)]
    for min_cadence in (1, 2, 3):
        p = MergePlan(cadence=8, overlap=True, compression=INT8)
        jp = JMergePlan(cadence=8, overlap=True, compression=JCompressionConfig(
            bits=8, error_feedback=True))
        pol = RecoveryPolicy(min_cadence=min_cadence)
        jpol = jrecovery.RecoveryPolicy(min_cadence=min_cadence)
        while jp is not None:
            assert p.describe() == jp.describe()
            p, jp = pol.degrade(p), jpol.degrade(jp)
        assert p is None
    for bad in (dict(max_restarts=-1), dict(backoff_factor=0.5),
                dict(degrade_after=0)):
        with pytest.raises(ValueError):
            RecoveryPolicy(**bad)


def test_divergence_detector_equals_jax():
    r = np.random.default_rng(3)
    losses = list(np.abs(r.standard_normal(40)) + 1.0)
    losses[7], losses[19], losses[25] = 40.0, float("nan"), float("inf")
    for factor, window in ((10.0, 4), (0.0, 8), (3.0, 1)):
        det = DivergenceDetector(factor=factor, window=window)
        jdet = jrecovery.DivergenceDetector(factor=factor, window=window)
        got = [det.observe(x) for x in losses]
        assert got == [jdet.observe(x) for x in losses]
        det.reset()
        jdet.reset()
        assert det.observe(1e9) == jdet.observe(1e9)
        assert list(det.window) == list(jdet.window)


def test_replay_trace_equals_jax():
    trace = [{"action": "rollback", "step": 5},
             {"action": "degrade", "to_cadence": 4},
             {"action": "degrade", "to_cadence": 2,
              "to_compression": "none"},
             {"action": "rollback", "step": 9},
             {"action": "degrade", "to_cadence": 2, "to_overlap": False}]
    start = MergePlan(cadence=8, overlap=True, compression=INT8)
    jstart = JMergePlan(cadence=8, overlap=True,
                        compression=JCompressionConfig(bits=8,
                                                       error_feedback=True))
    assert replay_trace(trace, start_plan=start) \
        == jrecovery.replay_trace(trace, start_plan=jstart)


# -- TestTrainerRecovery --------------------------------------------------------


def _linreg_program(n_vdpus=4):
    X, y = regression(0, 256, 6)
    return LinReg(lr=0.05).bind(make_cpu_grid(n_vdpus), X, y)


def _program_trainer(tmp_path, recovery, merge_every=4):
    program = _linreg_program()
    cfg = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=4, log_every=4,
                        merge_every=merge_every, recovery=recovery)
    return program, Trainer.for_program(program, cfg)


def test_clean_run_has_empty_trace_and_fit_parity(tmp_path):
    pol = RecoveryPolicy(backoff_base_s=0.0, spike_factor=100.0)
    program, tr = _program_trainer(tmp_path, pol)
    out = tr.run(16)
    assert out["recovery_trace"] == [] and out["restarts"] == 0
    assert_bits_equal(tr.state, program.fit(steps=16, merge_every=4).state)


def test_spike_triggers_backoff_and_rollback(tmp_path):
    losses = iter([1.0, 1.0, 1.0, 1.0, 1e8] + [1.0] * 100)

    def step_fn(state, batch):
        return state + 1.0, {"loss": torch.tensor(next(losses))}

    pol = RecoveryPolicy(max_restarts=4, backoff_base_s=0.0,
                         spike_factor=10.0)
    cfg = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=2, log_every=2,
                        recovery=pol)
    tr = Trainer(step_fn, torch.zeros(2), lambda s: None, cfg)
    out = tr.run(12)
    assert out["restarts"] == 1
    ev = out["recovery_trace"][0]
    assert ev["action"] == "rollback" and "loss spike" in ev["detail"]
    assert ev["to_step"] < ev["step"]
    assert _steps(out) == list(range(12))


def test_degradation_halves_program_cadence(tmp_path):
    pol = RecoveryPolicy(max_restarts=6, backoff_base_s=0.0,
                         degrade_after=2, min_cadence=1)
    program, tr = _program_trainer(tmp_path, pol)
    orig, n_fail = tr.step_fn, {"left": 2}

    def sabotaged(state, batch):
        out = orig(state, batch)
        if n_fail["left"] > 0:
            n_fail["left"] -= 1
            raise FloatingPointError("synthetic divergence")
        return out

    tr.step_fn = sabotaged
    out = tr.run(16)
    actions = [e["action"] for e in out["recovery_trace"]]
    assert actions.count("rollback") == 2 and "degrade" in actions
    deg = next(e for e in out["recovery_trace"] if e["action"] == "degrade")
    assert (deg["from_cadence"], deg["to_cadence"]) == (4, 2)
    assert tr._steps_per_call == 2 and tr._merge_every == 2
    assert _steps(out) == list(range(16))
    assert bool(torch.isfinite(tr.state).all())
    assert [e["to_cadence"] for e in out["recovery_trace"]
            if e["action"] == "degrade"][-1] == 2
    assert replay_trace(out["recovery_trace"], start_plan=MergePlan(
        cadence=4))[-1] == MergePlan(cadence=2).describe()


def test_recovery_trace_mirrored_into_merge_state(tmp_path):
    ms = {}

    def step_fn(state, batch):
        loss = torch.where(state[0] == 5.0, torch.tensor(float("nan")),
                           torch.tensor(1.0))
        return state + 1.0, {"loss": loss}

    pol = RecoveryPolicy(max_restarts=4, backoff_base_s=0.0)
    cfg = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=2, log_every=2,
                        recovery=pol)
    tr = Trainer(step_fn, torch.zeros(1), lambda s: None, cfg,
                 merge_state=ms)
    with pytest.raises(FloatingPointError):
        tr.run(20)
    assert ms["tuning_trace"]["recovery"] is tr.recovery_trace
    assert tr.recovery_trace


def test_recovery_budget_replaces_max_restarts(tmp_path):
    def step_fn(state, batch):
        return state + 1.0, {"loss": torch.tensor(float("nan"))}

    cfg = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=2, log_every=2,
                        max_restarts=0, recovery=RecoveryPolicy(
                            max_restarts=2, backoff_base_s=0.0))
    tr = Trainer(step_fn, torch.zeros(1), lambda s: None, cfg)
    with pytest.raises(FloatingPointError):
        tr.run(8)
    assert tr._restarts == 3


def test_origin_rollback_replays_from_a_copy(tmp_path):
    """With recovery and no checkpoint yet, a failure replays from the
    run's entry state, which in-place updates of the state cannot
    reach."""
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        state.add_(1.0)                      # in place
        if calls["n"] == 3:
            raise FloatingPointError("synthetic")
        return state, {"loss": state.sum()}

    cfg = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=100,
                        log_every=100, recovery=RecoveryPolicy(
                            backoff_base_s=0.0))
    tr = Trainer(step_fn, torch.zeros(2), lambda s: None, cfg)
    out = tr.run(4)
    assert out["restarts"] == 1
    assert out["recovery_trace"][0]["to_step"] == -1
    assert_bits_equal(tr.state, torch.full((2,), 4.0))


# -- a kernel that fails is not replayed -----------------------------------------


class _FakeLib:
    @staticmethod
    def fxp_matmul_error_string(err):
        return b"an illegal memory access was encountered"


@pytest.mark.parametrize("recovery", [None, RecoveryPolicy(
    backoff_base_s=0.0)])
def test_kernel_launch_error_is_raised_at_once(tmp_path, recovery):
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        if calls["n"] == 5:
            build.check(_FakeLib, "fxp_matmul", 700)
        return state + 1.0, {"loss": state.sum()}

    cfg = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=2, log_every=2,
                        recovery=recovery)
    tr = Trainer(step_fn, torch.zeros(2), lambda s: None, cfg)
    with pytest.raises(build.KernelError, match="launch failed"):
        tr.run(10)
    assert calls["n"] == 5 and tr._restarts == 0
    assert tr.recovery_trace == []


def test_kernel_build_errors_are_kernel_errors(tmp_path, monkeypatch):
    """``nvcc`` missing and ``nvcc`` failing both raise ``KernelError``,
    still a ``RuntimeError`` for every caller that caught one before."""
    assert issubclass(build.KernelError, RuntimeError)
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(build.KernelError, match="nvcc not found"):
        build.nvcc_path()
    monkeypatch.undo()
    monkeypatch.setattr(build, "nvcc_path", lambda: "/bin/false")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    src = tmp_path / "broken.cu"
    src.write_text("not CUDA\n")
    with pytest.raises(build.KernelError, match="nvcc failed"):
        build.build_all(("fxp_matmul",), sources={"fxp_matmul": src})

    def step_fn(state, batch):
        build.build_all(("fxp_matmul",), sources={"fxp_matmul": src})
        return state, {"loss": state.sum()}

    tr = Trainer(step_fn, torch.zeros(2), lambda s: None,
                 TrainerConfig(ckpt_dir=str(tmp_path / "ck")))
    with pytest.raises(build.KernelError):
        tr.run(3)
    assert tr._restarts == 0


# -- Program.step_fn / round_fn and Trainer.for_program -------------------------


def test_round_fn_refuses_cadence_below_one():
    with pytest.raises(ValueError, match="k >= 1"):
        _linreg_program().round_fn(0)


@pytest.mark.parametrize("k", [1, 4])
def test_step_and_round_fn_equal_fit(k):
    """``Program.fit`` runs these same calls: bit-equal states and
    losses (one round of k, or k merge-per-step steps)."""
    program = _linreg_program()
    if k == 1:
        fn, state = program.step_fn()
        hist = []
        for _ in range(4):
            state, m = fn(state, None)
            hist.append(m)
    else:
        fn, state = program.round_fn(k)
        state, hist = fn(state, None)
    res = program.fit(steps=4, merge_every=k)
    assert_bits_equal(state, res.state)
    for a, b in zip(hist, res.history):
        assert_bits_equal(a["loss"], b["loss"])


@pytest.mark.parametrize("k,steps", [(1, 20), (4, 10), (4, 16)])
def test_for_program_equals_fit_bit_for_bit(k, steps, tmp_path):
    """Cadence plans dispatch a round a call (a short last round
    included): the final state and every loss bit-equal to
    ``Program.fit`` at that cadence, an entry a local step."""
    program = _linreg_program()
    tr = Trainer.for_program(program, TrainerConfig(
        merge_every=k, ckpt_dir=str(tmp_path), ckpt_every=5, log_every=5))
    out = tr.run(steps)
    res = program.fit(steps=steps, merge_every=k)
    assert_bits_equal(tr.state, res.state)
    assert _steps(out) == list(range(steps))
    assert [e["loss"] for e in out["history"]] \
        == [float(m["loss"]) for m in res.history]
    tr.ckpt.wait()
    assert all((s + 1) % k == 0 or s == steps - 1 for s in tr.ckpt.steps())


def test_for_program_minibatch_runs_and_resumes(tmp_path):
    X, y = regression(0, 512, 8)
    program = LinReg(lr=0.05).bind(make_cpu_grid(8), X, y)
    cfg = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=10, log_every=5,
                        batch_size=16)
    tr = Trainer.for_program(program, cfg)
    tr.run(30)
    assert float(tr.state[1]) == 30.0
    tr2 = Trainer.for_program(program, cfg)
    assert tr2.start_step == 30 and float(tr2.state[1]) == 30.0
    res = program.fit(steps=30, batch_size=16)
    assert_bits_equal(tr2.state[0], res.state)


def test_for_program_ckpt_on_merge_boundary(tmp_path):
    program = _linreg_program()
    cfg = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=5,
                        merge_plan=MergePlan(cadence=4), log_every=100)
    Trainer.for_program(program, cfg).run(16)
    steps = {int(p.name.split("_")[1]) for p in tmp_path.iterdir()
             if p.name.startswith("step_")}
    assert steps and all((s + 1) % 4 == 0 for s in steps)
    assert Trainer.for_program(program, cfg).start_step == 16


def test_for_program_refuses_pipeline_plans():
    program = _linreg_program()
    for plan in (MergePlan(cadence=2, compression=CompressionConfig(bits=8)),
                 MergePlan(cadence=2, overlap=True),
                 MergePlan(outer=SlowMo()), MergePlan(
                     outer=AdaptiveCadence()), "auto"):
        with pytest.raises(ValueError, match="exact merge rounds"):
            Trainer.for_program(program, TrainerConfig(merge_plan=plan))


def test_for_program_refuses_a_mesh_grid():
    X, y = regression(0, 64, 4)
    grid = make_mesh_grid(4, device="cpu")
    try:
        program = LinReg(lr=0.05).bind(grid, X, y)
        with pytest.raises(NotImplementedError, match="12b"):
            Trainer.for_program(program, TrainerConfig())
    finally:
        torch.distributed.destroy_process_group()


# -- across packages: JAX's trainer and the port's resume each other ----------


LANES, ROWS, D = 8, 603, 8


def _jax_trainer(ckpt_dir, k, batch_size, program=None):
    X, y = classification(0, ROWS, D)
    program = program or JLogReg(lr=0.5, precision="int8",
                                 sigmoid="lut").bind(
        jax_grid(LANES), jnp.asarray(X), jnp.asarray(y))
    cfg = JTrainerConfig(ckpt_dir=str(ckpt_dir), ckpt_every=10,
                         log_every=10, merge_every=k, batch_size=batch_size)
    return JTrainer.for_program(program, cfg), program


def _port_trainer(ckpt_dir, k, batch_size):
    X, y = classification(0, ROWS, D)
    program = LogReg(lr=0.5, precision="int8", sigmoid="lut").bind(
        make_cpu_grid(LANES), X, y)
    cfg = TrainerConfig(ckpt_dir=str(ckpt_dir), ckpt_every=10, log_every=10,
                        merge_every=k, batch_size=batch_size)
    return Trainer.for_program(program, cfg,
                               sample_permutation=jax_permutation)


@pytest.mark.parametrize("k,batch_size", [(1, None), (4, 16)])
def test_resume_across_packages_matches_jax(k, batch_size, tmp_path):
    """JAX's ``Trainer.for_program`` trains LogReg(int8, LUT) 20 steps
    (checkpoints at its boundaries, the last at step 19); the port
    resumes from JAX's checkpoint to step 30, and JAX resumes from the
    port's: both within 1e-5·max|w| of JAX's uninterrupted 30 steps,
    losses within rtol 1e-4, history steps equal.  At cadence 4 with 16
    sampled rows a lane (JAX's permutations injected)."""
    with jdispatch.use_kernels(False):
        jfull, jprog = _jax_trainer(tmp_path / "full", k, batch_size)
        out_full = jfull.run(30)
        j20, _ = _jax_trainer(tmp_path / "jax", k, batch_size, jprog)
        j20.run(20)
    want = np.asarray(jfull.state[0] if batch_size else jfull.state)
    tol = 1e-5 * np.abs(want).max()
    full_losses = [e["loss"] for e in out_full["history"]]

    port = _port_trainer(tmp_path / "jax", k, batch_size)
    assert port.start_step == 20
    out = port.run(10)
    assert _steps(out) == [e["step"] for e in out_full["history"]][20:]
    np.testing.assert_allclose(to_numpy(tree_leaves(port.state)[0]), want,
                               rtol=0, atol=tol)
    if batch_size:
        assert float(port.state[1]) == 30.0
    np.testing.assert_allclose([e["loss"] for e in out["history"]],
                               full_losses[20:], rtol=1e-4)

    p20 = _port_trainer(tmp_path / "port", k, batch_size)
    p20.run(20)
    with jdispatch.use_kernels(False):
        jres, _ = _jax_trainer(tmp_path / "port", k, batch_size, jprog)
        assert jres.start_step == 20
        out_j = jres.run(10)
    np.testing.assert_allclose(
        np.asarray(jres.state[0] if batch_size else jres.state), want,
        rtol=0, atol=tol)
    np.testing.assert_allclose([e["loss"] for e in out_j["history"]],
                               full_losses[20:], rtol=1e-4)


# -- SIGKILL and resume (tests/test_resilience_restart.py) ----------------------


def test_sigkill_resume_matches_uninterrupted_bit_for_bit(tmp_path):
    ckpt_dir = tmp_path / "ckpt"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.abspath(SRC), HERE])
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "torch_trainer_ref.py"),
         str(ckpt_dir)], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert "UNREACHABLE" not in proc.stdout
    on_disk = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                     if d.startswith("step_") and ".corrupt" not in d
                     and not d.endswith(".tmp"))
    assert on_disk and on_disk[-1] == 7

    program, ms_oracle = ref.setup()
    tr_oracle = Trainer.for_program(program, ref.config(tmp_path / "o"),
                                    merge_state=ms_oracle)
    out_oracle = tr_oracle.run(ref.STEPS)

    program2, ms_resumed = ref.setup()
    tr2 = Trainer.for_program(program2, ref.config(ckpt_dir),
                              merge_state=ms_resumed)
    assert tr2.start_step == 8
    out2 = tr2.run(ref.STEPS - tr2.start_step)

    assert_bits_equal(tr2.state[0], tr_oracle.state[0])
    assert float(tr2.state[1]) == float(tr_oracle.state[1]) \
        == float(ref.STEPS)
    for key in ("error", "momentum"):
        a, b = tree_leaves(ms_resumed[key]), tree_leaves(ms_oracle[key])
        assert len(a) == len(b) > 0
        for la, lb in zip(a, b):
            assert_bits_equal(la, lb)
    assert ms_resumed["tuning_trace"]["note"] == ["segment-done"]
    tail = out_oracle["history"][tr2.start_step:]
    assert _steps(out2) == [e["step"] for e in tail]
    assert [e["loss"] for e in out2["history"]] == [e["loss"] for e in tail]
