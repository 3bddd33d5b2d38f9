"""Port parity of the plan controller (``repro_torch.tuning``,
``repro_torch.roofline``): ``PlanController`` against the JAX package's
on the same delta norms and measurements, the ladders, tags, records and
checks against JAX's, ``predict_round`` and ``wire_bytes`` against JAX's
on the same terms, the cost model's properties on the port, and the
controlled trajectories (``AdaptiveCadence`` and ``AutoTune`` without
exploration) against JAX's.

The controller is pure host Python, so its decisions, cadence traces and
trace dicts are held equal.  Trajectories are deterministic in both
packages; the JAX side runs under ``dispatch.use_kernels(False)`` and
sums lanes as a ones-vector contraction where the port sums with
``sum(dim=0)``, so values are held by tolerance: weights at
1e-5·max|w| (fp32) and 1e-4·max|w| (int8 + LUT), queue C's bounds;
delta norms at rtol 1e-5 (fp32) and, for int8 + LUT, at 1e-4 of the
largest norm, like its weights (an ulp that moves one int8 or int16
code moves the norms of a round: measured 1.7e-5 of the largest, 7.9e-5
of the smallest).  The cadence traces are held equal, on data where no
successive-norm ratio lies within 1e-3 of the stability or spike
thresholds (asserted).
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
from repro.core.mlalgos import LinReg as JLinReg  # noqa: E402
from repro.core.mlalgos import LogReg as JLogReg  # noqa: E402
from repro.core.mlalgos import api as japi  # noqa: E402
from repro.distributed import merge_plan as jmp  # noqa: E402
from repro.distributed.compression import (  # noqa: E402
    CompressionConfig as JCompressionConfig)
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.roofline import analysis as jra  # noqa: E402
from repro.roofline import hw as jhw  # noqa: E402
from repro import tuning as jtuning  # noqa: E402
from repro.tuning import cost as jcost  # noqa: E402
from repro.tuning.controller import shrink_k as jshrink_k  # noqa: E402
import repro_torch.roofline.analysis  # noqa: E402
from repro_torch.core import make_cpu_grid  # noqa: E402
from repro_torch.core.mlalgos import (DecisionTree, LinReg,  # noqa: E402
                                      LogReg, api, multinomial_accuracy,
                                      svm_accuracy, train_linreg,
                                      train_multinomial, train_svm)
from repro_torch.distributed import merge_plan as mp  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    CompressionConfig)
from repro_torch.roofline import analysis as ra  # noqa: E402
from repro_torch.roofline import hw  # noqa: E402
from repro_torch import tuning  # noqa: E402
from repro_torch.tuning import cost  # noqa: E402
from repro_torch.tuning import (AutoTune, CostModel,  # noqa: E402
                                Measurement, PlanChoice, PlanController,
                                auto_plan, cadence_ladder,
                                candidate_choices, choice_tag,
                                compression_tag)
from test_tuning import _oracle_cadence_trace  # noqa: E402
from torch_parity import (classification, mixture,  # noqa: E402
                          regression, rng)

LANES, ROWS, D = 8, 603, 16          # 603 rows: the last lane is padded
# JAX's TestAutoFit preset: explores and settles inside a few dozen steps
FAST = dict(k_max=4, min_steps_to_explore=8, hold_rounds=2, top_k_rungs=1)
# what a decision row records (JAX's run_controlled_fit)
ROW_KEYS = {"round", "steps_done", "cadence", "rounds_in_dispatch",
            "compression", "overlap", "warmup", "us_per_step",
            "predicted_us_per_step", "delta_norm"}
WIRES = {"exact": None, "int8": dict(bits=8), "int4": dict(bits=4),
         "top0.25@int8": dict(bits=8, top_k_frac=0.25),
         "top0.125@int8": dict(bits=8, top_k_frac=0.125),
         "top0.5@raw": dict(bits=None, top_k_frac=0.5),
         "int8-no-ef": dict(bits=8, error_feedback=False)}


def _wire(name, ours=True):
    kw = WIRES[name]
    if kw is None:
        return None
    return (CompressionConfig if ours else JCompressionConfig)(**kw)


# -- PlanController against JAX's ------------------------------------------

CONTROLLERS = {
    # exploration over the six auto candidates, the prior ranking them
    "explore": dict(explore_rounds=1, prior_margin=0.05, shrink=True,
                    prior={"exact": 10.0, "exact+ov": 10.0, "int8": 9.0,
                           "int8+ov": 9.0, "top0.25@int8": 12.0,
                           "top0.25@int8+ov": 12.0}),
    # two probes each, no margin
    "explore-twice": dict(explore_rounds=2, prior_margin=0.0, shrink=False,
                          prior={"exact": 3.0, "exact+ov": 4.0, "int8": 1.0,
                                 "int8+ov": 2.0, "top0.25@int8": 5.0,
                                 "top0.25@int8+ov": 6.0}),
    # the prior alone, compressed wires within the margin of exact
    "near-tie": dict(explore_rounds=0, prior_margin=0.05, shrink=True,
                     expect="exact",
                     prior={"exact": 100.0, "exact+ov": 100.0,
                            "int8": 96.0, "int8+ov": 96.0,
                            "top0.25@int8": 95.1, "top0.25@int8+ov": 95.1}),
    # the prior alone, a win past the margin
    "decisive": dict(explore_rounds=0, prior_margin=0.05, shrink=True,
                     expect="int8",
                     prior={"exact": 100.0, "exact+ov": 100.0,
                            "int8": 60.0, "int8+ov": 70.0,
                            "top0.25@int8": 94.9, "top0.25@int8+ov": 94.9}),
}


def _choices(ours):
    wires = [None, dict(bits=8), dict(bits=8, top_k_frac=0.25)]
    cc = CompressionConfig if ours else JCompressionConfig
    pc = PlanChoice if ours else jtuning.PlanChoice
    return [pc(None if w is None else cc(**w), ov) for w in wires
            for ov in (False, True)]


def _norms(seed: int, n: int) -> list:
    """Delta norms that grow stable, spike (past 4x) and drift."""
    r = rng(seed)
    level, out = 1.0, []
    for i in range(n):
        if i % 11 == 7:
            level *= float(r.uniform(4.5, 9.0))      # a spike
        elif i % 5 == 3:
            level *= float(r.uniform(1.6, 2.5))      # unstable
        else:
            level *= float(r.uniform(0.85, 1.15))    # stable
        out.append(level)
    return out


@pytest.mark.parametrize("name", sorted(CONTROLLERS))
def test_controller_decisions_match_jax(name):
    """The same sequence of decisions, measured rounds (warmups among
    them) and delta norms through both controllers: every ``decide()``,
    the cadence trace and ``trace_dict()`` equal."""
    spec = CONTROLLERS[name]
    kw = dict(k0=1, k_max=16, growth=2, stable_ratio=0.5, patience=2,
              shrink=spec["shrink"], spike_ratio=4.0, k_min=1,
              prior=spec["prior"], explore_rounds=spec["explore_rounds"],
              prior_margin=spec["prior_margin"])
    ours = PlanController(choices=_choices(True), **kw)
    theirs = jtuning.PlanController(choices=_choices(False), **kw)
    r = rng(3)
    seen = set()
    for i, dn in enumerate(_norms(5, 60)):
        (k, c), (jk, jc) = ours.decide(), theirs.decide()
        assert (k, choice_tag(c)) == (jk, jtuning.choice_tag(jc))
        tag = choice_tag(c)
        warm = (k, tag) not in seen
        seen.add((k, tag))
        seconds = float(r.uniform(1e-4, 1e-2))
        steps = k * int(r.integers(1, 3))
        key = ("plan", k, compression_tag(c.compression), c.overlap)
        ours.observe_round(Measurement(key=key, seconds=seconds, steps=steps,
                                       delta_norm=dn, warmup=warm), c)
        theirs.observe_round(jtuning.Measurement(
            key=key, seconds=seconds, steps=steps, delta_norm=dn,
            warmup=warm), jc)
        assert ours.cadence_trace == theirs.cadence_trace
        assert ours.settled() == theirs.settled()
        assert ours.chosen() == theirs.chosen()
    assert ours.trace_dict() == theirs.trace_dict()
    assert len(set(ours.cadence_trace)) > 2      # grew, and (shrink) fell
    if spec["explore_rounds"]:                   # every candidate probed
        assert len(ours.measured) == 6
    else:
        assert ours.chosen()["compression"] == spec["expect"]


@pytest.mark.parametrize("shrink", [False, True])
def test_cadence_rule_matches_the_oracle(shrink):
    """``observe`` against ``tests/test_tuning.py``'s pure-python cadence
    oracle, on a sequence with spikes."""
    norms = _norms(9, 80)
    kw = dict(k0=1, k_max=16, growth=2, stable_ratio=0.5, patience=2,
              shrink=shrink, spike_ratio=4.0, k_min=1)
    ctl = PlanController(**kw)
    for d in norms:
        ctl.observe(d)
    assert ctl.cadence_trace == _oracle_cadence_trace(norms, **kw)


def test_ladders_tags_and_records_match_jax():
    for args in ((1, 32, 2), (3, 8, 2), (8, 8, 2), (1, 16, 3), (2, 5, 2)):
        assert cadence_ladder(*args) == jtuning.cadence_ladder(*args)
    for k, k_min in ((8, 1), (1, 1), (5, 2), (2, 2)):
        assert tuning.shrink_k(k, k_min) == jshrink_k(k, k_min)
    for name in WIRES:
        assert compression_tag(_wire(name)) == \
            jtuning.compression_tag(_wire(name, False))
        for ov in (False, True):
            assert choice_tag(PlanChoice(_wire(name), ov)) == \
                jtuning.choice_tag(jtuning.PlanChoice(_wire(name, False), ov))
    presets = ((AutoTune(), jtuning.AutoTune()),
               (AutoTune(**FAST), jtuning.AutoTune(**FAST)),
               (AutoTune(bits=4, top_k_frac=0.5, top_k_rungs=3),
                jtuning.AutoTune(bits=4, top_k_frac=0.5, top_k_rungs=3)),
               (mp.AdaptiveCadence(), jmp.AdaptiveCadence()))
    for p, jp in presets:
        for w in ("exact", "int8"):
            got = [choice_tag(c) for c in candidate_choices(p, _wire(w))]
            want = [jtuning.choice_tag(c) for c in
                    jtuning.candidate_choices(jp, _wire(w, False))]
            assert got == want
    for m in (dict(key=("plan", 4, "int8", True), seconds=1.25e-3, steps=4,
                   delta_norm=0.5, warmup=True),
              dict(key=("plan", 1, "exact", False), seconds=2.0, steps=0,
                   source="prior"),
              dict(key=("fxp", (1, 2)), seconds=3e-7)):
        assert Measurement(**m).row() == jtuning.Measurement(**m).row()
        assert Measurement(**m).us_per_step() == \
            jtuning.Measurement(**m).us_per_step()


@pytest.mark.parametrize("kw", [
    {}, dict(k_min=9, k_max=8), dict(spike_ratio=1.0), dict(growth=1),
    dict(k_max=0), dict(prior_margin=1.0), dict(prior_margin=-0.1),
    dict(prior_margin=0.5, k_min=2, k_max=2, growth=3),
])
def test_autotune_checks_match_jax(kw):
    try:
        theirs = jtuning.AutoTune(**kw)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split()[0]):
            AutoTune(**kw)
        return
    assert dataclasses.asdict(AutoTune(**kw)) == dataclasses.asdict(theirs)
    assert AutoTune.is_auto and mp.MergePlan(outer=AutoTune(**kw)).auto


def test_plan_spellings():
    plan = mp.MergePlan.resolve("auto")
    assert plan.auto and isinstance(plan.outer, AutoTune)
    assert plan == auto_plan() and not plan.is_exact_default
    assert auto_plan(k_max=4, shrink=False).outer == \
        AutoTune(k_max=4, shrink=False)
    with pytest.raises(ValueError, match="not both"):
        mp.MergePlan.resolve("auto", merge_every=4)
    for outer in (AutoTune(), mp.AdaptiveCadence()):
        with pytest.raises(ValueError, match="overlap"):
            mp.MergePlan(overlap=True, outer=outer)
    a, ja = mp.AdaptiveCadence, jmp.AdaptiveCadence
    for attr in ("explore_rounds", "min_steps_to_explore", "hold_rounds"):
        assert getattr(a, attr) == getattr(ja, attr)
    plan = mp.MergePlan(outer=a())
    assert plan.adaptive and not plan.auto


# -- the roofline: predict_round and wire_bytes against JAX's ----------------


@pytest.mark.parametrize("case", [
    dict(flops=3e9, bytes=5e8, wire=256.0),
    dict(flops=3e12, bytes=5e8, wire=256.0, cadence=8),
    dict(flops=1e9, bytes=2e9, wire=68.0, encode=768.0, cadence=4),
    dict(flops=1e9, bytes=2e9, wire=6.4e7, encode=1e8, cadence=4,
         overlap=True),
    dict(flops=1e9, bytes=2e9, wire=6.4e7, cadence=2, overlap=True,
         hbm_wire=True),
    dict(flops=5e10, bytes=1e9, wire=1e6, cadence=16, baseline=2,
         collectives=True),
    dict(flops=5e10, bytes=1e9, wire=1e9, cadence=3, overlap=True,
         collectives=True),
])
def test_predict_round_matches_jax(case):
    """The same flops, bytes, collectives and wire through both
    formulas, the port fed JAX's TPU constants: every term within rtol
    1e-12."""
    parsed = jra.ParsedHLO(computations={}, entry="",
                           dot_flops=case["flops"],
                           traffic_bytes=case["bytes"])
    if case.get("collectives"):
        parsed.collectives = [
            jra.CollectiveRec("all-reduce", 4096, 4, 3.0, False),
            jra.CollectiveRec("all-gather", 1 << 20, 8, 1.0, False),
            jra.CollectiveRec("all-reduce", 1 << 16, 2, 2.0, True)]
    terms = jra.roofline_terms(parsed, {}, n_chips=1)
    kw = dict(cadence=case.get("cadence", 1), wire_bytes=case["wire"],
              overlap=case.get("overlap", False),
              baseline_cadence=case.get("baseline", 1),
              encode_bytes=case.get("encode", 0.0))
    wire_bw = jhw.HBM_BW if case.get("hbm_wire") else None
    want = jra.predict_round(parsed, n_chips=1, wire_bw=wire_bw, **kw)
    got = ra.predict_round(
        ra.RoundCount(ops={"bf16": case["flops"]}, bytes=case["bytes"]),
        ici_s=terms["ici_s"], dcn_s=terms["dcn_s"], hbm_bw=jhw.HBM_BW,
        peak_ops={"bf16": jhw.PEAK_FLOPS_BF16},
        wire_bw=jhw.DCN_BW_PER_CHIP if wire_bw is None else wire_bw, **kw)
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, float):
            np.testing.assert_allclose(got[key], value, rtol=1e-12,
                                       atol=0, err_msg=key)
        else:
            assert got[key] == value, key


def test_port_constants_are_the_h100s():
    assert hw.HBM_BW == 3.35e12
    assert hw.PEAK_OPS == {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12}
    count = ra.RoundCount(ops={"int8": 1979e9, "fp32": 67e9}, bytes=1.0)
    row = ra.predict_round(count, wire_bytes=3.35e9)
    assert row["t_local_s"] == pytest.approx(2e-3, rel=1e-12)
    assert row["t_merge_s"] == pytest.approx(1e-3, rel=1e-12)


STATES = {
    "vector": [((64,), "float32")],
    "minibatch": [((16,), "float32"), ((), "float32")],
    "matrix+int": [((3, 5), "float32"), ((4,), "int32")],
    "bf16": [((128,), "bfloat16"), ((7,), "float32")],
}


@pytest.mark.parametrize("state", sorted(STATES))
def test_wire_bytes_match_jax(state):
    """``CostModel.wire_bytes`` (and the encode passes' dense bytes) on
    the same state shapes, byte for byte."""
    leaves = STATES[state]
    ours = tuple(torch.empty(s, dtype=getattr(torch, t), device="meta")
                 for s, t in leaves)
    theirs = tuple(jax.ShapeDtypeStruct(s, getattr(jnp, t))
                   for s, t in leaves)
    model = CostModel(count=ra.RoundCount(), wire=ours)
    jmodel = jcost.CostModel(parsed=None, wire=theirs)
    for name in WIRES:
        assert model.wire_bytes(_wire(name)) == \
            jmodel.wire_bytes(_wire(name, False))
    assert cost._dense_float_bytes(ours) == jcost._dense_float_bytes(theirs)


# -- the round counter -------------------------------------------------------


def test_counter_charges_reads_writes_and_products():
    """Views are free, an expanded operand is read once, an in-place op
    reads and writes its tensor, products count 2·M·N·K by type, and a
    kernel wrapper's charge reaches every active counter."""
    a = torch.ones(4, 8)
    b = torch.ones(8, 3, dtype=torch.float64)
    p = torch.ones(2, 4, 8, dtype=torch.bfloat16)
    q = torch.ones(2, 8, 5, dtype=torch.bfloat16)
    with ra.RoundCounter() as outer:
        a.t(), a.reshape(32)[None].expand(5, 32)              # views only
        assert outer.count == ra.RoundCount()
        torch.mul(a[None].expand(6, 4, 8), 2.0)       # reads 128 B once
        assert outer.count.bytes == 128 + 6 * 128
        with ra.RoundCounter() as inner:
            a.add_(1.0)
            b.T @ b
            torch.bmm(p, q)
            ra.charge(1000, 64, "int8")
        assert inner.count.ops == {"fp32": 2 * 3 * 8 * 3,
                                   "bf16": 2 * 2 * 4 * 8 * 5, "int8": 64}
        assert inner.count.bytes == (2 * 128 + (192 + 192 + 72)
                                     + (128 + 160 + 80) + 1000)
    assert outer.count.bytes == 128 + 6 * 128 + inner.count.bytes
    ra.charge(5)                                   # no counter: no effect
    assert outer.count.bytes == 128 + 6 * 128 + inner.count.bytes


def test_doc_examples():
    failed, tried = doctest.testmod(repro_torch.roofline.analysis,
                                    verbose=False)
    assert tried > 0 and failed == 0


# -- the cost model on the port ----------------------------------------------


@pytest.fixture()
def linreg_setup():
    X, y = regression(2, 256, 8)
    program = LinReg(lr=0.05).bind(make_cpu_grid(4), X, y)
    return (program.grid, program.local_fn, program.update_fn,
            program.state0, program.data)


class TestCostModel:
    """``tests/test_tuning.py``'s cost-model properties, on the port."""

    INT8 = CompressionConfig(bits=8)
    TOPK = CompressionConfig(bits=8, top_k_frac=0.25)

    def test_wire_bytes_ordering(self, linreg_setup):
        model = CostModel.for_fit(*linreg_setup)
        exact, int8 = model.wire_bytes(None), model.wire_bytes(self.INT8)
        assert exact > int8 > 0 and model.wire_bytes(self.TOPK) < exact

    def test_predicted_us_per_step_falls_with_cadence(self, linreg_setup):
        model = CostModel.for_fit(*linreg_setup)
        us = [model.predict(cadence=k)["us_per_step"] for k in (1, 2, 4, 8)]
        assert all(a >= b for a, b in zip(us, us[1:])) and us[-1] > 0

    def test_prediction_is_a_prior_measurement(self, linreg_setup):
        model = CostModel.for_fit(*linreg_setup)
        m = model.prediction(cadence=4, compression=self.INT8)
        assert m.source == "prior" and m.steps == 4
        assert m.key == ("plan", 4, "int8", False)
        assert m.us_per_step() == pytest.approx(
            model.predict(cadence=4, compression=self.INT8)["us_per_step"])

    def test_table_sorted_best_first(self, linreg_setup):
        model = CostModel.for_fit(*linreg_setup)
        rows = model.table(cadences=(1, 4), compressions=(None, self.INT8))
        us = [r["us_per_step"] for r in rows]
        assert len(rows) == 4 and us == sorted(us)
        assert {(r["cadence"], r["compression"]) for r in rows} == \
            {(1, "exact"), (1, "int8"), (4, "exact"), (4, "int8")}

    def test_one_card_models_no_overlap_win(self, linreg_setup):
        model = CostModel.for_fit(*linreg_setup)
        plain, ov = model.predict(cadence=2), model.predict(cadence=2,
                                                            overlap=True)
        assert ov["overlap"] is True and plain["overlap"] is False
        assert ov["us_per_step"] == plain["us_per_step"]
        # and compression never wins on one card's HBM-priced hop
        for k in (1, 8):
            assert model.predict(cadence=k, compression=self.INT8)[
                "us_per_step"] > model.predict(cadence=k)["us_per_step"]

    def test_the_count_is_cached_on_the_grid(self, linreg_setup,
                                             monkeypatch):
        """One counted round per (functions, kernels flag): a second fit
        of one program counts nothing, and the count leaves the fit's
        state as it was."""
        grid, lf, uf, w0, data = linreg_setup
        calls = []
        counted = cost.count_round

        def spy(*args):
            calls.append(args)
            return counted(*args)

        monkeypatch.setattr(cost, "count_round", spy)
        before = w0.clone()
        m1 = CostModel.for_fit(grid, lf, uf, w0, data)
        assert CostModel.for_fit(grid, lf, uf, w0, data) is m1
        assert torch.equal(w0, before) and len(calls) == 1
        assert m1.count.bytes > 0 and m1.count.ops["fp32"] > 0
        for _ in range(2):
            grid.fit(init_state=w0, local_fn=lf, update_fn=uf, data=data,
                     steps=4, merge_plan="auto")
        assert len(calls) == 1
        size = len(grid._tuning_cache)
        grid.fit(init_state=w0, local_fn=lf, update_fn=uf, data=data,
                 steps=4, merge_plan="auto")
        assert len(grid._tuning_cache) == size


# -- controlled fits against JAX's -------------------------------------------


def _pair(name):
    if name == "linreg-fp32":
        X, y = regression(1, ROWS, D)
        return JLinReg(lr=0.1), LinReg(lr=0.1), X, y
    X, y = classification(0, ROWS, D)
    return (JLogReg(lr=0.5, precision="int8", sigmoid="lut"),
            LogReg(lr=0.5, precision="int8", sigmoid="lut"), X, y)


def _presets(preset):
    if preset == "adaptive":
        return (mp.MergePlan(outer=mp.AdaptiveCadence(k_max=8)),
                jmp.MergePlan(outer=jmp.AdaptiveCadence(k_max=8)))
    return (mp.MergePlan(outer=AutoTune(min_steps_to_explore=10 ** 9)),
            jmp.MergePlan(outer=jtuning.AutoTune(
                min_steps_to_explore=10 ** 9)))


@pytest.mark.parametrize("preset", ["adaptive", "auto"])
@pytest.mark.parametrize("name", ["linreg-fp32", "logreg-int8-lut"])
def test_controlled_trajectory_against_jax(name, preset):
    """50 steps under ``AdaptiveCadence(k_max=8)`` and under ``AutoTune``
    without exploration (the prior keeps the exact wire in both): equal
    cadence traces and decisions, delta norms and weights within the
    module's tolerances."""
    jw, pw, X, y = _pair(name)
    plan, jplan = _presets(preset)
    jms, ms = {}, {}
    with jdispatch.use_kernels(False):
        jres = japi.fit(jw, jax_grid(LANES), jnp.asarray(X), jnp.asarray(y),
                        steps=50, merge_plan=jplan, merge_state=jms)
    res = api.fit(pw, make_cpu_grid(LANES), X, y, steps=50, merge_plan=plan,
                  merge_state=ms)
    trace, jtrace = ms["tuning_trace"], jms["tuning_trace"]
    jn = np.array([d["delta_norm"] for d in jtrace["decisions"]])
    rel = np.abs(np.diff(jn)) / jn[:-1]
    assert np.abs(rel - 0.5).min() > 1e-3           # no threshold near-tie
    assert np.abs(jn[1:] / jn[:-1] - 4.0).min() > 4e-3
    assert ms["cadence_trace"] == jms["cadence_trace"]
    assert max(ms["cadence_trace"]) > 1
    assert set(trace) == set(jtrace) and trace["choices"] == jtrace["choices"]
    assert trace["chosen"] == jtrace["chosen"]
    assert trace["chosen"]["compression"] == "exact"
    for row, jrow in zip(trace["decisions"], jtrace["decisions"],
                         strict=True):
        assert set(row) == set(jrow) == ROW_KEYS
        for key in ("round", "steps_done", "cadence", "rounds_in_dispatch",
                    "compression", "overlap", "warmup"):
            assert row[key] == jrow[key], key
    n = np.array([d["delta_norm"] for d in trace["decisions"]])
    w, jw_ = res.state.numpy(), np.asarray(jres.state)
    if name == "linreg-fp32":
        np.testing.assert_allclose(n, jn, rtol=1e-5, atol=0)
        bound = 1e-5
    else:
        np.testing.assert_allclose(n, jn, rtol=0, atol=1e-4 * jn.max())
        bound = 1e-4
    np.testing.assert_allclose(w, jw_, rtol=0,
                               atol=bound * np.abs(jw_).max())
    assert len(res.history) == len(jres.history) == 50


def test_short_auto_fit_stays_on_the_exact_wire_in_both():
    """``merge_plan="auto"`` on a short fit (no exploration): the
    prior-margin rule keeps the exact wire, in the port as in JAX."""
    jw, pw, X, y = _pair("linreg-fp32")
    jms, ms = {}, {}
    with jdispatch.use_kernels(False):
        japi.fit(jw, jax_grid(LANES), jnp.asarray(X), jnp.asarray(y),
                 steps=24, merge_plan="auto", merge_state=jms)
    api.fit(pw, make_cpu_grid(LANES), X, y, steps=24, merge_plan="auto",
            merge_state=ms)
    for trace in (ms["tuning_trace"], jms["tuning_trace"]):
        assert trace["prior_margin"] == pytest.approx(0.05)
        assert trace["chosen"]["compression"] == "exact"
        assert all(d["compression"] == "exact" for d in trace["decisions"])
        assert trace["measured_us_per_step"].keys() <= {"exact"}
        assert trace["decisions"][0]["warmup"] is True
    assert ms["tuning_trace"]["choices"] == jms["tuning_trace"]["choices"]
    assert ms["cadence_trace"] == jms["cadence_trace"]


# -- controlled fits on the port ---------------------------------------------


def test_exploring_auto_fit_has_jaxs_structure():
    """JAX's ``TestAutoFit::test_linreg_auto_converges_with_trace`` on
    the port: JAX's trace keys and candidate list, a cost table of
    wires × overlap × the cadence ladder, the overlap variants visited,
    and the last decision at the step count."""
    X, y = regression(4, 256, 6)
    ms: dict = {}
    res = train_linreg(make_cpu_grid(4), X, y, lr=0.05, steps=40,
                       merge_plan=auto_plan(**FAST), merge_state=ms)
    assert len(res.history) == 40
    assert float(res.history[-1]["loss"]) < float(res.history[0]["loss"])
    trace = ms["tuning_trace"]
    assert set(trace) == set(jtuning.PlanController(k0=1, k_max=4)
                             .trace_dict())
    assert trace["choices"] == [
        jtuning.choice_tag(c) for c in jtuning.candidate_choices(
            jtuning.AutoTune(**FAST), None)]
    assert trace["chosen"]["compression"] in trace["choices"]
    assert 1 <= trace["chosen"]["cadence"] <= 4
    assert all(set(row) == ROW_KEYS for row in trace["decisions"])
    assert trace["decisions"][-1]["steps_done"] == 40
    assert any(d["overlap"] for d in trace["decisions"])
    assert set(trace["measured_us_per_step"]) == set(trace["choices"])
    assert len(trace["cost_table"]) == 3 * 2 * len(cadence_ladder(1, 4, 2))
    assert ms["error"].shape == (1, 6)        # the state-shaped EF buffer


def test_svm_and_multinomial_under_auto():
    X, y = classification(5, 256, 6)
    ms: dict = {}
    res = train_svm(make_cpu_grid(4), X, y, lr=0.3, steps=32,
                    merge_plan=auto_plan(**FAST), merge_state=ms)
    assert len(res.history) == 32 and svm_accuracy(res.w, X, y) > 0.7
    assert ms["tuning_trace"]["decisions"]
    X, y = mixture(6, 300, 6, 3)
    ms = {}
    res = train_multinomial(make_cpu_grid(4), X, y, n_classes=3, lr=0.5,
                            steps=32, merge_plan=auto_plan(**FAST),
                            merge_state=ms)
    assert len(res.history) == 32 and multinomial_accuracy(res.W, X, y) > 0.5
    assert ms["tuning_trace"]["chosen"]["cadence"] >= 1


def test_pinned_compression_leaves_only_the_cadence():
    X, y = regression(7, 128, 4)
    ms: dict = {}
    plan = mp.MergePlan(compression=CompressionConfig(bits=8),
                        outer=AutoTune(**FAST))
    train_linreg(make_cpu_grid(4), X, y, lr=0.05, steps=16, merge_plan=plan,
                 merge_state=ms)
    trace = ms["tuning_trace"]
    assert trace["choices"] == ["int8"] and trace["prior_us_per_step"] == {}
    assert all(d["compression"] == "int8" for d in trace["decisions"])
    assert ms["error"].shape == (1, 4)


def test_trace_replays_offline():
    """The recorded delta norms replay the cadence sequence through a
    fresh controller."""
    X, y = regression(8, 256, 6)
    ms: dict = {}
    preset = AutoTune(k_max=8, min_steps_to_explore=10 ** 9, hold_rounds=1)
    train_linreg(make_cpu_grid(4), X, y, lr=0.05, steps=48,
                 merge_plan=mp.MergePlan(outer=preset), merge_state=ms)
    replay = PlanController(
        k0=1, k_max=preset.k_max, growth=preset.growth,
        stable_ratio=preset.stable_ratio, patience=preset.patience,
        shrink=preset.shrink, spike_ratio=preset.spike_ratio,
        k_min=preset.k_min)
    for row in ms["tuning_trace"]["decisions"]:
        replay.observe(row["delta_norm"])
    assert replay.cadence_trace == ms["tuning_trace"]["cadence_trace"] \
        == ms["cadence_trace"]


def test_adaptive_preset_rides_the_controller():
    X, y = regression(9, 256, 6)
    ms: dict = {}
    res = train_linreg(make_cpu_grid(4), X, y, lr=0.05, steps=48,
                       merge_plan=mp.MergePlan(
                           outer=mp.AdaptiveCadence(k_max=8)),
                       merge_state=ms)
    assert len(res.history) == 48
    trace = ms["cadence_trace"]
    assert trace[0] == 1 and all(b >= a for a, b in zip(trace, trace[1:]))
    assert ms["tuning_trace"]["choices"] == ["exact"]
    assert "error" not in ms
    norms = [d["delta_norm"] for d in ms["tuning_trace"]["decisions"]]
    assert trace == _oracle_cadence_trace(norms, k0=1, k_max=8)


def test_callbacks_see_every_step_in_order():
    X, y = regression(10, 128, 4)
    seen = []
    res = api.fit(LinReg(lr=0.05), make_cpu_grid(4), X, y, steps=19,
                  merge_plan=auto_plan(**FAST),
                  callback=lambda i, w, m: seen.append((i, float(m["loss"]))))
    assert [i for i, _ in seen] == list(range(19))
    assert [v for _, v in seen] == [float(m["loss"]) for m in res.history]


def test_default_plan_writes_no_tuning_trace():
    """``merge_plan=None`` keeps the default engine: bit-equal to
    ``engine="python"``, and no trace."""
    X, y = regression(11, 128, 4)
    grid = make_cpu_grid(4)
    ms: dict = {}
    a = train_linreg(grid, X, y, lr=0.05, steps=10, merge_state=ms)
    b = train_linreg(grid, X, y, lr=0.05, steps=10, engine="python")
    assert torch.equal(a.w, b.w) and ms == {}
    # the grid's cache holds the scan engine's chunk runner, nothing of
    # the plan controller
    assert not [k for k in grid._tuning_cache
                if str(k[0]).startswith("tuning")]


def test_the_tree_drops_auto_with_jaxs_warning():
    X, y = mixture(12, 400, 5, 2)
    wl = DecisionTree(max_depth=3, n_bins=16, n_classes=2)
    grid = make_cpu_grid(4)
    with pytest.warns(mp.MergeFallbackWarning, match="outer=AutoTune"):
        a = api.fit(wl, grid, X, y, steps=3, merge_plan="auto")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        b = api.fit(wl, grid, X, y, steps=3)
    assert torch.equal(a.state.feature, b.state.feature)
    assert torch.equal(a.state.leaf_value, b.state.leaf_value)
