"""Port parity of the fault-tolerant fit (``repro_torch.resilience``:
``faults``, ``survivor``, ``runtime``) and its engine hooks
(``PimGrid.fit`` under an armed plan, ``run_fit``'s warning on armed
controller plans, the torn checkpoint write).

The port's counterparts of ``tests/test_resilience.py`` (``TestFaultPlan``,
``TestInjectors``, ``TestArmedIdleParity``, ``TestSurvivorMerges``,
``TestFaultMatrix``, the torn write of ``TestCheckpointHardening``), each
value against JAX's on the same numpy inputs, at JAX's test size (8
vDPUs, 256 rows, d = 6, ``make_linreg_step``), and JAX's own assertions
on the port alone.  Beside them: one survivor round against JAX's, the
armed ``api.fit`` of LogReg(int8, LUT) against JAX's, the (2, 2) gloo
mesh against JAX's (2, 2) mesh (``tests/torch_mesh_ref.py``), the
port's torn checkpoint rejected by JAX's manager, and the mesh's refusal
of a checkpoint directory (ROADMAP item 12b).

Tolerances: fault plans, injectors, reports and traces are equal; one
survivor round within 1e-6·max|state| (exact wire) or 1e-4·max|state|
(compressed: a float32 rounding of the jitted JAX side can move an int8
code by one step); trajectories within 1e-5·max|w| (exact) or
1e-4·max|w| (compressed), the bars of ``tests/test_torch_overlap.py``.
The port against itself (armed and idle against unarmed, exact wire) is
bit for bit.
"""

import contextlib
import os
import warnings
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import \
    CheckpointManager as JCheckpointManager  # noqa: E402
from repro.core import make_cpu_grid as jax_grid  # noqa: E402
from repro.core.mlalgos import LogReg as JLogReg  # noqa: E402
from repro.core.mlalgos import api as japi  # noqa: E402
from repro.core.mlalgos.linreg import \
    make_linreg_step as jmake_linreg_step  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.distributed import merge_plan as jmp  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.resilience import faults as jflt  # noqa: E402
from repro.resilience import recovery as jrec  # noqa: E402
from repro.resilience import runtime as jruntime  # noqa: E402
from repro.resilience import survivor as jsurvivor  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import make_cpu_grid, make_mesh_grid  # noqa: E402
from repro_torch.core.mlalgos import LogReg, api  # noqa: E402
from repro_torch.core.mlalgos.linreg import (closed_form,  # noqa: E402
                                             make_linreg_step)
from repro_torch.distributed import compression as comp  # noqa: E402
from repro_torch.distributed import merge_plan as mp  # noqa: E402
from repro_torch import resilience  # noqa: E402
from repro_torch.resilience import (DispatchTimeout, FaultEvent,  # noqa: E402
                                    FaultPlan, RecoveryPolicy, drive_fit,
                                    faults, replay_trace)
from repro_torch.resilience import runtime, survivor  # noqa: E402
from torch_parity import (assert_bits_equal, classification,  # noqa: E402
                          single_process_world, to_numpy)
import torch_mesh_ref as ref  # noqa: E402

LANES, ROWS, D = 8, 256, 6
KINDS = ("nan_lane", "wire_bitflip", "dead_lane", "dead_pod", "timeout",
         "torn_ckpt")
WIRE_KW = {"exact": None, "int8ef": dict(bits=8, error_feedback=True),
           "topk": dict(bits=8, error_feedback=True, top_k_frac=0.25)}
# test_resilience.py's TestFaultMatrix policy
POLICY = dict(max_restarts=10, degrade_after=2, spike_factor=50.0,
              backoff_base_s=0.0)


def wire(cmod, name):
    kw = WIRE_KW[name]
    return None if kw is None else cmod.CompressionConfig(**kw)


def tol(name) -> float:
    return 1e-5 if name == "exact" else 1e-4


def plan_for(flt, kind):
    """``test_resilience.py``'s fault plan of each kind, in the package
    whose ``resilience.faults`` is ``flt``."""
    FE, FP = flt.FaultEvent, flt.FaultPlan
    if kind == "nan_lane":
        return FP(events=(FE(3, "nan_lane", lane=2),))
    if kind == "wire_bitflip":
        return FP(events=(FE(3, "wire_bitflip", leaf=0, index=2, bit=30),))
    if kind == "dead_lane":
        return FP(events=(FE(2, "dead_lane", lane=5),))
    if kind == "dead_pod":
        return FP(events=(FE(2, "dead_pod", pod=1),), pods=4)
    if kind == "timeout":
        return FP(events=(FE(3, "timeout", duration_s=0.002),))
    # every save torn, and a later divergence: the rollback must
    # quarantine the torn bytes and fall back to the fit's start
    return FP(events=tuple(FE(i, "torn_ckpt") for i in range(64)) +
              (FE(9, "nan_lane", lane=1),))


def data_np():
    r = np.random.default_rng(13)
    X = r.standard_normal((ROWS, D)).astype(np.float32)
    w = r.standard_normal(D).astype(np.float32)
    y = (X @ w + 0.1 * r.standard_normal(ROWS)).astype(np.float32)
    return X, y


def port_problem(lanes=LANES):
    X, y = data_np()
    grid = make_cpu_grid(lanes)
    data, n, lf, uf, w0 = make_linreg_step(grid, X, y, lr=0.1)
    return grid, X, y, data, lf, uf, w0


def jax_problem(lanes=LANES):
    X, y = data_np()
    grid = jax_grid(lanes)
    data, n, lf, uf, w0 = jmake_linreg_step(grid, jnp.asarray(X),
                                            jnp.asarray(y), lr=0.1)
    return grid, data, lf, uf, w0


def err(w, X, y) -> float:
    return float(torch.linalg.norm(w - closed_form(X, y)))


def summary(w, hist, rep) -> dict:
    """What is held against JAX: the final state, the losses, the
    report's decisions and each trace entry's action."""
    return {"w": to_numpy(w),
            "losses": np.asarray([float(h["loss"]) for h in hist]),
            "report": {k: rep[k] for k in ("restarts", "rounds", "fired",
                                           "survivors", "final_plan")},
            "trace": [(e["action"], e.get("to_step"), e.get("transient"))
                      for e in rep["trace"]]}


@contextlib.contextmanager
def quiet():
    """The plan fallbacks' warnings silenced, as JAX's matrix does."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


# -- the JAX package's runs, once for the module -----------------------------


@pytest.fixture(scope="module")
def jax_matrix(tmp_path_factory):
    """JAX's ``drive_fit`` on every (wire, kind) cell of the fault matrix,
    64 steps at cadence 4, checkpoints every 2 dispatches; and the
    dead-lane fit of ``test_dead_lane_still_converges``."""
    base = tmp_path_factory.mktemp("jax_matrix")
    grid, data, lf, uf, w0 = jax_problem()
    out = {}
    with quiet():
        for name in WIRE_KW:
            for kind in KINDS:
                w, hist, rep = jruntime.drive_fit(
                    grid, init_state=w0, local_fn=lf, update_fn=uf,
                    data=data, steps=64,
                    plan=jmp.MergePlan(cadence=4,
                                       compression=wire(jcomp, name)),
                    fault_plan=plan_for(jflt, kind),
                    recovery=jrec.RecoveryPolicy(**POLICY),
                    ckpt=str(base / f"{name}_{kind}"), ckpt_every_rounds=2)
                out[(name, kind)] = summary(w, hist, rep)
        w, hist, rep = jruntime.drive_fit(
            grid, init_state=w0, local_fn=lf, update_fn=uf, data=data,
            steps=48, plan=jmp.MergePlan(cadence=4),
            fault_plan=jflt.FaultPlan(events=(
                jflt.FaultEvent(1, "dead_lane", lane=2),)),
            recovery=jrec.RecoveryPolicy(backoff_base_s=0.0),
            ckpt=str(base / "dead_lane"))
        out["dead_lane"] = summary(w, hist, rep)
    return out


@pytest.fixture(scope="module")
def port_baselines():
    """The port's unfaulted 64-step error of each wire (TestFaultMatrix's
    bound is relative to the same wire's own)."""
    grid, X, y, data, lf, uf, w0 = port_problem()
    out = {}
    with quiet():
        for name in WIRE_KW:
            w, _, _ = drive_fit(grid, init_state=w0, local_fn=lf,
                                update_fn=uf, data=data, steps=64,
                                plan=mp.MergePlan(cadence=4,
                                                  compression=wire(comp,
                                                                   name)))
            out[name] = err(w, X, y)
    return out


# -- FaultPlan, arming, injectors ---------------------------------------------


GENERATE_CASES = {
    "all_kinds": dict(seed=3, rounds=40, n_lanes=8, pods=2,
                      rates={k: 0.1 for k in KINDS}),
    "dense": dict(seed=11, rounds=200, n_lanes=8, pods=2,
                  rates={k: 0.2 for k in KINDS}),
    "nan_only": dict(seed=7, rounds=20, n_lanes=8,
                     rates={"nan_lane": 0.2}),
    "saves": dict(seed=5, rounds=30, n_lanes=16, pods=4, saves=12,
                  rates={"torn_ckpt": 0.3, "dead_pod": 0.1,
                         "timeout": 0.15, "wire_bitflip": 0.05}),
}


@pytest.mark.parametrize("case", sorted(GENERATE_CASES))
def test_generate_matches_jax(case):
    kw = GENERATE_CASES[case]
    ours = FaultPlan.generate(**kw)
    theirs = jflt.FaultPlan.generate(**kw)
    assert ours.events
    assert [dataclass_tuple(e) for e in ours.events] == \
        [dataclass_tuple(e) for e in theirs.events]
    assert ours.describe() == theirs.describe()
    assert ours == FaultPlan.generate(**kw)
    assert hash(ours) == hash(FaultPlan.generate(**kw))
    for r in range(kw["rounds"]):
        assert [e.describe() for e in ours.events_at(r)] == \
            [e.describe() for e in theirs.events_at(r)]
        assert [e.describe() for e in ours.saves_at(r)] == \
            [e.describe() for e in theirs.saves_at(r)]
        assert ours.next_event_round(r) == theirs.next_event_round(r)


def dataclass_tuple(e):
    return (e.round, e.kind, e.lane, e.pod, e.leaf, e.index, e.bit,
            e.duration_s)


def test_generated_events_in_bounds():
    p = FaultPlan.generate(seed=11, rounds=200, n_lanes=8, pods=2,
                           rates={k: 0.2 for k in KINDS})
    for e in p.events:
        assert e.kind in faults.FAULT_KINDS and 0 <= e.round < 200
        if e.kind in ("nan_lane", "dead_lane"):
            assert 0 <= e.lane < 8
        if e.kind == "dead_pod":
            assert 0 <= e.pod < 2
        if e.kind == "wire_bitflip":
            assert 23 <= e.bit <= 30
        if e.kind == "timeout":
            assert 0.0 <= e.duration_s <= 0.01


def test_event_validation_and_queries():
    with pytest.raises(ValueError, match="kind"):
        FaultEvent(0, "meteor_strike")
    with pytest.raises(ValueError, match="round"):
        FaultEvent(-1, "nan_lane")
    p = FaultPlan(events=(FaultEvent(2, "nan_lane", lane=1),
                          FaultEvent(5, "timeout"),
                          FaultEvent(1, "torn_ckpt")))
    assert [e.kind for e in p.events_at(2)] == ["nan_lane"]
    assert p.events_at(1) == ()
    assert [e.kind for e in p.saves_at(1)] == ["torn_ckpt"]
    assert (p.next_event_round(0), p.next_event_round(3),
            p.next_event_round(6)) == (2, 5, None)
    cleared = p.clear_between(0, 6)
    assert cleared.next_event_round(0) is None and cleared.saves_at(1)


def test_armed_contextmanager_restores():
    outer, inner = FaultPlan(seed=1), FaultPlan(seed=2)
    assert faults.active() is None
    with faults.armed(outer, ckpt_every_rounds=3) as got:
        assert got is outer and faults.active() is outer
        assert faults.armed_context() == (outer, None, None, 3)
        with faults.armed(inner):
            assert faults.active() is inner
        assert faults.active() is outer
    assert faults.active() is None
    faults.arm(outer)
    assert faults.active() is outer
    faults.disarm()
    assert faults.armed_context() is None
    with pytest.raises(TypeError):
        faults.arm("not a plan")


def test_poison_tree_matches_jax():
    tree = {"w": np.arange(3, dtype=np.float32),
            "n": np.arange(4, dtype=np.int32)}
    ours = faults.poison_tree({k: torch.from_numpy(v)
                               for k, v in tree.items()})
    theirs = jflt.poison_tree({k: jnp.asarray(v) for k, v in tree.items()})
    for k in tree:
        assert_bits_equal(ours[k], np.asarray(theirs[k]))


@pytest.mark.parametrize("leaf,index,bit", [(0, 5, 30), (1, 3, 23),
                                            (3, 100, 31), (7, 2, 0)])
def test_bitflip_tree_matches_jax(leaf, index, bit):
    """Indices wrap over the float leaves and the elements; integer
    leaves are never chosen; a second flip restores the tree."""
    r = np.random.default_rng(leaf * 100 + index)
    tree = {"a": r.standard_normal((4, 4)).astype(np.float32),
            "b": np.zeros(7, np.float32),
            "c": np.arange(5, dtype=np.int32)}
    ours = faults.bitflip_tree({k: torch.from_numpy(v.copy())
                                for k, v in tree.items()},
                               leaf=leaf, index=index, bit=bit)
    theirs = jflt.bitflip_tree({k: jnp.asarray(v) for k, v in tree.items()},
                               leaf=leaf, index=index, bit=bit)
    for k in tree:
        assert_bits_equal(ours[k], np.asarray(theirs[k]))
    changed = sum(int((to_numpy(ours[k]).view(np.uint32)
                       != tree[k].view(np.uint32)).sum()) for k in "ab")
    assert changed == 1
    back = faults.bitflip_tree(ours, leaf=leaf, index=index, bit=bit)
    for k in tree:
        assert_bits_equal(back[k], tree[k])


def test_kill_lanes_matches_jax():
    mask = np.ones(8, np.float32)
    events = [("dead_lane", dict(lane=3)), ("dead_lane", dict(lane=11)),
              ("dead_pod", dict(pod=1)), ("dead_pod", dict(pod=5))]
    for pods in (1, 2, 4):
        ours, theirs = mask, mask
        for kind, kw in events:
            ours = faults.kill_lanes(ours, FaultEvent(0, kind, **kw),
                                     pods=pods)
            theirs = jflt.kill_lanes(theirs, jflt.FaultEvent(0, kind, **kw),
                                     pods=pods)
            assert_bits_equal(ours, theirs)
    assert mask.sum() == 8.0
    with pytest.raises(ValueError, match="lane-kill"):
        faults.kill_lanes(mask, FaultEvent(0, "timeout"), pods=2)


# -- one survivor round ------------------------------------------------------


MASKS = {"all": np.ones(LANES, np.float32),
         "one_dead": np.array([1, 1, 0, 1, 1, 1, 1, 1], np.float32),
         "all_dead": np.zeros(LANES, np.float32)}


@pytest.mark.parametrize("mask_name", sorted(MASKS))
@pytest.mark.parametrize("wire_name", sorted(WIRE_KW))
def test_survivor_round_matches_jax(wire_name, mask_name):
    """One masked round at cadence 4 from a state and an EF buffer off
    zero; with every lane dead the state and the buffer come back
    unchanged."""
    r = np.random.default_rng(4)
    w = r.standard_normal(D).astype(np.float32)
    e = (0.01 * r.standard_normal((1, D))).astype(np.float32)
    mask = MASKS[mask_name]

    grid, X, y, data, lf, uf, _ = port_problem()
    rs = survivor.survivor_runners(grid, lf, uf, merge_every=4,
                                   compression=wire(comp, wire_name))
    (state, m_out, ef), metrics = rs["round"](
        (torch.from_numpy(w), torch.from_numpy(mask), torch.from_numpy(e)),
        data)
    jgrid, jdata, jlf, juf, _ = jax_problem()
    jrs = jsurvivor.survivor_runners(jgrid, jlf, juf, merge_every=4,
                                     compression=wire(jcomp, wire_name))
    (jstate, _, jef), jmetrics = jrs["round"](
        (jnp.asarray(w), jnp.asarray(mask), jnp.asarray(e)), jdata)

    jstate, jef = np.asarray(jstate), np.asarray(jef)
    bar = (1e-6 if wire_name == "exact" else 1e-4) * np.abs(jstate).max()
    np.testing.assert_allclose(to_numpy(state), jstate, rtol=0, atol=bar)
    np.testing.assert_allclose(to_numpy(ef), jef, rtol=0, atol=bar)
    assert metrics["loss"].shape == (4,)
    np.testing.assert_allclose(to_numpy(metrics["loss"]),
                               np.asarray(jmetrics["loss"]), rtol=1e-5)
    assert_bits_equal(m_out, mask)
    if mask_name == "all_dead":
        assert_bits_equal(state, w)
        assert_bits_equal(ef, e)


def test_runner_stacks_rounds_on_the_device():
    grid, X, y, data, lf, uf, w0 = port_problem()
    rs = survivor.survivor_runners(grid, lf, uf, merge_every=3)
    carry = (w0, survivor.place_mask(grid, np.ones(LANES, np.float32)),
             mp.init_merge_error(grid, w0))
    (state, _, _), stacked = rs["runner"](carry, data, length=5)
    assert stacked["loss"].shape == (5, 3)
    one = carry
    losses = []
    for _ in range(5):
        one, m = rs["round"](one, data)
        losses.append(m["loss"])
    assert_bits_equal(state, one[0])
    assert_bits_equal(stacked["loss"], torch.stack(losses))


# -- drive_fit: the fault matrix ---------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("wire_name", sorted(WIRE_KW))
def test_fault_matrix_matches_jax(wire_name, kind, tmp_path, jax_matrix,
                                  port_baselines):
    """Every fault kind on every wire: JAX's assertions on the port, and
    the report, the trace and the final state against JAX's."""
    grid, X, y, data, lf, uf, w0 = port_problem()
    plan = mp.MergePlan(cadence=4, compression=wire(comp, wire_name))
    with quiet():
        w, hist, rep = drive_fit(
            grid, init_state=w0, local_fn=lf, update_fn=uf, data=data,
            steps=64, plan=plan, fault_plan=plan_for(faults, kind),
            recovery=RecoveryPolicy(**POLICY), ckpt=str(tmp_path),
            ckpt_every_rounds=2)
    assert faults.active() is None
    # test_resilience.py's own assertions
    assert bool(torch.isfinite(w).all())
    assert len(hist) == 64
    assert all(np.isfinite(float(m["loss"])) for m in hist)
    assert all(isinstance(m["loss"], torch.Tensor) and m["loss"].dim() == 0
               for m in hist)
    assert err(w, X, y) <= 2.0 * port_baselines[wire_name] + 0.25
    states = replay_trace(rep["trace"], start_plan=plan)
    assert (states[-1] if states else plan.describe()) == rep["final_plan"]
    rollbacks = [e for e in rep["trace"] if e["action"] == "rollback"]
    assert len(rollbacks) == rep["restarts"]
    if kind == "timeout":
        assert rep["restarts"] >= 1
        assert all(e["transient"] for e in rollbacks)
        assert rep["final_plan"] == plan.describe()
    if kind == "nan_lane":
        assert rep["restarts"] >= 1
    if kind == "torn_ckpt":
        assert rep["restarts"] >= 1
        assert [d for d in os.listdir(tmp_path) if ".corrupt" in d]
    # against JAX
    got, want = summary(w, hist, rep), jax_matrix[(wire_name, kind)]
    assert got["report"] == want["report"]
    assert got["trace"] == want["trace"]
    bar = tol(wire_name) * np.abs(want["w"]).max()
    np.testing.assert_allclose(got["w"], want["w"], rtol=0, atol=bar)
    assert len(got["losses"]) == len(want["losses"])


def test_dead_lane_fit_matches_jax(tmp_path, jax_matrix):
    """``test_dead_lane_still_converges``' fit (one lane dead from round
    1, 48 steps at cadence 4) against JAX's: the same final state, seven
    survivors, a full history.  JAX's closed-form bound on that test is
    not held here (ROADMAP queue C)."""
    grid, X, y, data, lf, uf, w0 = port_problem()
    w, hist, rep = drive_fit(
        grid, init_state=w0, local_fn=lf, update_fn=uf, data=data,
        steps=48, plan=mp.MergePlan(cadence=4),
        fault_plan=FaultPlan(events=(FaultEvent(1, "dead_lane", lane=2),)),
        recovery=RecoveryPolicy(backoff_base_s=0.0), ckpt=str(tmp_path))
    got, want = summary(w, hist, rep), jax_matrix["dead_lane"]
    assert rep["survivors"] == 7 and len(hist) == 48
    assert got["report"] == want["report"]
    np.testing.assert_allclose(got["w"], want["w"], rtol=0,
                               atol=1e-5 * np.abs(want["w"]).max())
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)


def test_dead_lanes_are_monotone_across_rollback(tmp_path):
    grid, X, y, data, lf, uf, w0 = port_problem()
    fp = FaultPlan(events=(FaultEvent(1, "dead_lane", lane=0),
                           FaultEvent(3, "nan_lane", lane=5)))
    w, _, rep = drive_fit(grid, init_state=w0, local_fn=lf, update_fn=uf,
                          data=data, steps=32, plan=mp.MergePlan(cadence=4),
                          fault_plan=fp,
                          recovery=RecoveryPolicy(backoff_base_s=0.0),
                          ckpt=str(tmp_path))
    assert rep["restarts"] >= 1 and rep["survivors"] == 7
    assert bool(torch.isfinite(w).all())


def test_metrics_are_survivor_weighted(tmp_path):
    grid, X, y, data, lf, uf, w0 = port_problem()
    fp = FaultPlan(events=(FaultEvent(0, "dead_pod", pod=1),), pods=4)
    w, hist, rep = drive_fit(grid, init_state=w0, local_fn=lf, update_fn=uf,
                             data=data, steps=24,
                             plan=mp.MergePlan(cadence=4), fault_plan=fp,
                             recovery=RecoveryPolicy(backoff_base_s=0.0),
                             ckpt=str(tmp_path))
    assert rep["survivors"] == 6
    assert all(np.isfinite(float(m["loss"])) for m in hist)


def test_one_host_sync_per_chunk():
    """An idle plan: 48 steps at cadence 4 with scan_chunk 8 are two
    chunks (8 + 4 rounds), so two host synchronisations; every dispatched
    chunk (a failed one too) is one."""
    grid, X, y, data, lf, uf, w0 = port_problem()
    _, hist, rep = drive_fit(grid, init_state=w0, local_fn=lf, update_fn=uf,
                             data=data, steps=48, plan=mp.MergePlan(cadence=4),
                             fault_plan=FaultPlan(), scan_chunk=8)
    assert rep["host_syncs"] == 2 and rep["rounds"] == 12
    _, _, rep = drive_fit(grid, init_state=w0, local_fn=lf, update_fn=uf,
                          data=data, steps=48, plan=mp.MergePlan(cadence=4),
                          fault_plan=plan_for(faults, "nan_lane"),
                          recovery=RecoveryPolicy(backoff_base_s=0.0),
                          scan_chunk=8)
    # rounds 0-2, the poisoned round 3, then the replay from the start:
    # rounds 0-7 and 8-11 (the event has fired)
    assert rep["restarts"] == 1 and rep["host_syncs"] == 4


def test_recovery_none_propagates_the_failure():
    grid, X, y, data, lf, uf, w0 = port_problem()
    fp = FaultPlan(events=(FaultEvent(1, "nan_lane", lane=0),))
    with pytest.raises(FloatingPointError, match="non-finite"):
        drive_fit(grid, init_state=w0, local_fn=lf, update_fn=uf, data=data,
                  steps=16, plan=mp.MergePlan(cadence=4), fault_plan=fp)


def test_timeout_raises_dispatch_timeout_without_recovery():
    grid, X, y, data, lf, uf, w0 = port_problem()
    fp = FaultPlan(events=(FaultEvent(1, "timeout", duration_s=0.001),))
    with pytest.raises(DispatchTimeout):
        drive_fit(grid, init_state=w0, local_fn=lf, update_fn=uf, data=data,
                  steps=16, plan=mp.MergePlan(cadence=4), fault_plan=fp)


def test_exhausted_restart_budget_reraises(tmp_path):
    grid, X, y, data, lf, uf, w0 = port_problem()
    fp = FaultPlan(events=tuple(FaultEvent(r, "nan_lane", lane=0)
                                for r in range(64)))
    with quiet():
        with pytest.raises(FloatingPointError):
            drive_fit(grid, init_state=w0, local_fn=lf, update_fn=uf,
                      data=data, steps=64, plan=mp.MergePlan(cadence=4),
                      fault_plan=fp,
                      recovery=RecoveryPolicy(max_restarts=3,
                                              backoff_base_s=0.0),
                      ckpt=str(tmp_path))


# -- armed but idle, the plans, the hooks -------------------------------------


def test_unarmed_fit_untouched():
    grid, X, y, data, lf, uf, w0 = port_problem()
    ms = {}
    grid.fit(init_state=w0, local_fn=lf, update_fn=uf, data=data, steps=8,
             merge_every=4, merge_state=ms)
    assert "resilience_report" not in ms


def test_armed_idle_exact_wire_bit_exact():
    grid, X, y, data, lf, uf, w0 = port_problem()
    w_plain, h_plain = grid.fit(init_state=w0, local_fn=lf, update_fn=uf,
                                data=data, steps=24, merge_every=4)
    ms = {}
    with faults.armed(FaultPlan()):
        w_armed, h_armed = grid.fit(init_state=w0, local_fn=lf,
                                    update_fn=uf, data=data, steps=24,
                                    merge_every=4, merge_state=ms)
    assert faults.active() is None
    assert_bits_equal(w_armed, w_plain)
    assert len(h_armed) == len(h_plain) == 24
    for a, b in zip(h_plain, h_armed):
        assert_bits_equal(b["loss"], a["loss"])
    assert ms["resilience_report"]["restarts"] == 0
    assert ms["tuning_trace"]["recovery"] == []


def test_armed_idle_compressed_wire_close():
    grid, X, y, data, lf, uf, w0 = port_problem()
    cfg = comp.CompressionConfig(bits=8, error_feedback=True)
    w_plain, _ = grid.fit(init_state=w0, local_fn=lf, update_fn=uf,
                          data=data, steps=24, merge_every=4,
                          merge_compression=cfg)
    ms = {}
    with faults.armed(FaultPlan()):
        w_armed, _ = grid.fit(init_state=w0, local_fn=lf, update_fn=uf,
                              data=data, steps=24, merge_every=4,
                              merge_compression=cfg, merge_state=ms)
    np.testing.assert_allclose(to_numpy(w_armed), to_numpy(w_plain),
                               atol=2e-2)
    assert ms["error"].shape == (1, D)


def test_armed_controller_plan_warns_and_skips_injection():
    grid, X, y, data, lf, uf, w0 = port_problem(lanes=4)
    ms = {}
    with faults.armed(FaultPlan(events=(FaultEvent(0, "nan_lane",
                                                   lane=0),))):
        with pytest.warns(mp.MergeFallbackWarning, match="controller-driven"):
            w, _ = grid.fit(init_state=w0, local_fn=lf, update_fn=uf,
                            data=data, steps=8, merge_plan="auto",
                            merge_state=ms)
    assert bool(torch.isfinite(w).all())
    assert "resilience_report" not in ms


@pytest.mark.parametrize("case", ["overlap", "slowmo", "both"])
def test_normalise_plan_matches_jax(case):
    kw = {"overlap": dict(overlap=True),
          "slowmo": dict(outer="slowmo"),
          "both": dict(overlap=True, outer="slowmo")}[case]

    def make(m, cm):
        outer = m.SlowMo(beta=0.5) if kw.get("outer") else m.AverageCommit()
        return m.MergePlan(cadence=4, overlap=kw.get("overlap", False),
                           compression=cm.CompressionConfig(bits=8),
                           outer=outer)

    with pytest.warns(mp.MergeFallbackWarning, match="resilience") as got:
        ours = runtime._normalise_plan(make(mp, comp))
    with warnings.catch_warnings(record=True) as theirs_w:
        warnings.simplefilter("always")
        theirs = jruntime._normalise_plan(make(jmp, jcomp))
    assert ours.describe() == theirs.describe()
    assert not ours.overlap and type(ours.outer) is mp.AverageCommit
    assert [str(w.message) for w in got] == \
        [str(w.message) for w in theirs_w]


def test_normalise_plan_refuses_controller_plans():
    for plan in (mp.MergePlan(outer=mp.AdaptiveCadence(k_max=8)),
                 mp.MergePlan.resolve("auto")):
        with pytest.raises(ValueError, match="controller plans"):
            runtime._normalise_plan(plan)


def test_torn_write_keys_on_save_ordinal(tmp_path):
    fp = FaultPlan(events=(FaultEvent(1, "torn_ckpt"),))
    state = {"w": torch.arange(8.0)}
    with faults.armed(fp):
        m = CheckpointManager(str(tmp_path), async_save=False)
        m.save(0, state)
        m.save(1, state)
    m.save(2, state)          # disarmed: intact
    assert m.validate(0) and not m.validate(1) and m.validate(2)


def test_torn_checkpoint_rejected_by_jax(tmp_path):
    """The port tears ordinal 1 of an armed plan; JAX's manager rejects
    that step and accepts the others, and restores the intact step to
    the port's bits."""
    state = {"w": torch.arange(8.0), "n": torch.tensor(3, dtype=torch.int32)}
    with faults.armed(FaultPlan(events=(FaultEvent(1, "torn_ckpt"),))):
        m = CheckpointManager(str(tmp_path), async_save=True)
        for step in range(3):
            m.save(step, state)
        m.wait()
    jm = JCheckpointManager(str(tmp_path), async_save=False)
    assert [jm.validate(s) for s in range(3)] == [True, False, True]
    tree, _ = jm.restore(0, {"w": jnp.zeros(8), "n": jnp.asarray(0)})
    assert_bits_equal(np.asarray(tree["w"]), state["w"])


def test_armed_fit_routes_through_the_driver(tmp_path):
    """``PimGrid.fit`` under ``faults.armed`` with a recovery policy and
    a checkpoint directory: the NaN round is rolled back and replayed,
    the report lands in ``merge_state``, and nothing stays armed."""
    grid, X, y, data, lf, uf, w0 = port_problem()
    ms = {}
    fp = FaultPlan(events=(FaultEvent(3, "nan_lane", lane=1),))
    with faults.armed(fp, recovery=RecoveryPolicy(backoff_base_s=0.0),
                      ckpt=str(tmp_path), ckpt_every_rounds=1):
        w, hist = grid.fit(init_state=w0, local_fn=lf, update_fn=uf,
                           data=data, steps=24, merge_every=4,
                           merge_state=ms)
    assert faults.armed_context() is None
    rep = ms["resilience_report"]
    assert rep["restarts"] == 1 and rep["trace"][0]["to_step"] == 12
    w_plain, h_plain = grid.fit(init_state=w0, local_fn=lf, update_fn=uf,
                                data=data, steps=24, merge_every=4)
    assert_bits_equal(w, w_plain)
    assert [float(h["loss"]) for h in hist] == \
        [float(h["loss"]) for h in h_plain]


def test_api_fit_logreg_int8_armed_matches_jax(tmp_path):
    """``api.fit(LogReg(int8, LUT))`` under an armed plan (a dead lane at
    round 1, a NaN lane at round 3, checkpoints every dispatch) against
    JAX's ``api.fit`` under JAX's ``faults.armed`` (plain path):
    decisions equal, the state within 1e-5·max|w|."""
    X, y = classification(3, LANES * 64 + 5, 8)
    events = ((1, "dead_lane", dict(lane=3)), (3, "nan_lane", dict(lane=5)))

    def run(flt, rec, fit, wl, grid, Xa, ya, ckpt):
        fp = flt.FaultPlan(events=tuple(flt.FaultEvent(r, k, **kw)
                                        for r, k, kw in events))
        ms = {}
        with flt.armed(fp, recovery=rec.RecoveryPolicy(backoff_base_s=0.0),
                       ckpt=ckpt, ckpt_every_rounds=1):
            res = fit(wl, grid, Xa, ya, steps=24, merge_every=4,
                      merge_state=ms)
        return res, ms["resilience_report"]

    ours, rep = run(faults, resilience.recovery, api.fit,
                    LogReg(lr=0.5, precision="int8", sigmoid="lut"),
                    make_cpu_grid(LANES), X, y, str(tmp_path / "port"))
    with jdispatch.use_kernels(False):
        theirs, jrep = run(jflt, jrec, japi.fit,
                           JLogReg(lr=0.5, precision="int8", sigmoid="lut"),
                           jax_grid(LANES), jnp.asarray(X), jnp.asarray(y),
                           str(tmp_path / "jax"))
    for key in ("restarts", "rounds", "fired", "survivors", "final_plan"):
        assert rep[key] == jrep[key], key
    assert rep["survivors"] == LANES - 1
    assert [(e["action"], e["to_step"]) for e in rep["trace"]] == \
        [(e["action"], e["to_step"]) for e in jrep["trace"]]
    want = np.asarray(theirs.state)
    np.testing.assert_allclose(to_numpy(ours.state), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose([float(h["loss"]) for h in ours.history],
                               [float(h["loss"]) for h in theirs.history],
                               rtol=1e-4)


# -- the mesh -----------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """(every rank's survivor cells on the port's (2, 2) gloo mesh, JAX's
    on its (2, 2) mesh of 4 forced CPU devices), started together."""
    tmp = tmp_path_factory.mktemp("survivor_mesh")
    jax_out = str(tmp / "jax.pkl")
    with ThreadPoolExecutor(1) as pool:
        jax = pool.submit(ref.run_jax, "jax_survivor_main", jax_out,
                          devices=4, timeout=300.0)
        ranks = ref.run_world("survivor_mesh_scenario", 4,
                              str(tmp / "world"), timeout=300.0)
        jax = jax.result(timeout=300.0)
    return ranks, jax


@pytest.mark.parametrize("wire_name", sorted(ref.SURVIVOR_WIRES))
def test_mesh_survivor_matrix_matches_jax(wire_name, mesh_runs):
    """``test_mesh_survivor_matrix``'s mixed plan on the (2, 2) mesh:
    JAX's assertions (finite, 48 entries, 8 survivors, near the closed
    form), every rank bit-equal, and the decisions and state against
    JAX's mesh."""
    ranks, jax = mesh_runs
    assert sorted((r["pod"], r["data"]) for r in ranks) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    cells = [r["cells"][wire_name] for r in ranks]
    got, want = cells[0], jax[wire_name]
    for other in cells[1:]:
        assert_bits_equal(other["w"], got["w"])
        assert_bits_equal(other["losses"], got["losses"])
        assert other["report"] == got["report"]
    X, y = ref.survivor_data()
    assert np.isfinite(got["w"]).all() and len(got["losses"]) == 48
    assert got["report"]["survivors"] == 8
    assert float(np.linalg.norm(got["w"] - to_numpy(closed_form(X, y)))) < 1.0
    assert got["report"] == want["report"]
    assert got["trace"] == want["trace"]
    bar = tol(wire_name) * np.abs(want["w"]).max()
    np.testing.assert_allclose(got["w"], want["w"], rtol=0, atol=bar)


def test_mesh_with_checkpoint_dir_is_refused(tmp_path):
    with single_process_world():
        grid = make_mesh_grid(8, device="cpu")
        X, y = data_np()
        data, n, lf, uf, w0 = make_linreg_step(grid, X, y, lr=0.1)
        with pytest.raises(NotImplementedError, match="12b"):
            drive_fit(grid, init_state=w0, local_fn=lf, update_fn=uf,
                      data=data, steps=8, plan=mp.MergePlan(cadence=4),
                      fault_plan=FaultPlan(), ckpt=str(tmp_path))
        # without one it runs, and matches the grid without a mesh
        w, _, rep = drive_fit(
            grid, init_state=w0, local_fn=lf, update_fn=uf, data=data,
            steps=8, plan=mp.MergePlan(cadence=4),
            fault_plan=FaultPlan(events=(FaultEvent(1, "dead_lane",
                                                    lane=2),)))
    plain = make_cpu_grid(8)
    pdata, _, plf, puf, pw0 = make_linreg_step(plain, X, y, lr=0.1)
    w_ref, _, _ = drive_fit(
        plain, init_state=pw0, local_fn=plf, update_fn=puf, data=pdata,
        steps=8, plan=mp.MergePlan(cadence=4),
        fault_plan=FaultPlan(events=(FaultEvent(1, "dead_lane", lane=2),)))
    assert rep["survivors"] == 7
    assert_bits_equal(w, w_ref)


def test_package_exports_match_jax():
    import repro.resilience as jres

    assert resilience.__all__ == jres.__all__
    assert faults.FAULT_KINDS == jflt.FAULT_KINDS
