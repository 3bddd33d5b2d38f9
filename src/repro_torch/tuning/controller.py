"""The plan controller behind ``merge_plan="auto"`` and
``AdaptiveCadence``.

Port of ``repro.tuning.controller``.  ``PlanController`` is pure host
Python, a copy of the JAX package's:

* **cadence** — grow ``k`` geometrically once successive merged-delta
  norms stabilise, and optionally *shrink* it on a delta-norm spike;
* **compression** — candidates (exact / int8 EF / a top-k ladder from
  ``compression.top_k_ladder``) ranked by the ``CostModel`` prior (the
  H100 roofline of one counted round), then revised by measured round
  times arriving as :class:`~repro_torch.tuning.measurement.Measurement`
  records.  Short fits trust the prior; long fits probe each candidate
  once and exploit the measured winner;
* **overlap** — every wire format is offered with and without the
  deferred-commit pipeline (:class:`PlanChoice`); the prior never
  predicts an overlap win on one card, so only a measured probe can
  promote it there (on a mesh the prior lets the overlap hide the
  merge).

On a mesh every rank runs the controller.  Its decisions read two
host numbers: the delta norm, of the replicated state and so equal on
every rank, and the round's seconds, which each rank times on its own
clock and which are agreed (the maximum over the mesh) before the
controller sees them.  So every rank decides the same cadence, wire and
hold, and the ranks stay in step.

``run_controlled_fit`` drives a fit: one merge round a dispatch while
the controller is deciding, always on the state wire (so the error
feedback buffer keeps one shape across cadences and wire formats), and
held multi-round dispatches once it has settled.  A dispatch is built
from ``merge_plan``'s own round pieces (``pipeline_fns``,
``plain_round``, ``overlapped_body``, ``drain``), the pieces ``run_fit``
runs.  The port compiles nothing, but a configuration's first dispatch
still pays the allocator's growth and each kernel's first launch, so it
is marked ``warmup`` as in the JAX package.  Decisions land in
``merge_state["tuning_trace"]`` with the JAX package's keys.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed import compression as comp
from repro_torch.distributed import merge_plan as mp
from repro_torch.distributed.compression import CompressionConfig
from repro_torch.tree import tree_leaves
from repro_torch.tuning.cost import CostModel, compression_tag
from repro_torch.tuning.measurement import Measurement


@dataclasses.dataclass(frozen=True)
class AutoTune(mp.OuterOptimizer):
    """The ``merge_plan="auto"`` preset: a host-side controller that
    picks cadence AND wire format; the commit itself is the plain
    average (so auto never changes what a merge *means*, only when and
    how compressed it happens).

    ``MergePlan(outer=AutoTune())`` with ``compression=None`` lets the
    controller choose among exact / int8 / top-k wires; giving the plan
    an explicit ``compression`` pins the wire and leaves only cadence
    to the controller (the :class:`AdaptiveCadence` behaviour plus the
    shrink rule)."""

    k_max: int = 32
    growth: int = 2
    stable_ratio: float = 0.5
    patience: int = 2
    shrink: bool = True
    spike_ratio: float = 4.0
    k_min: int = 1
    bits: int = 8
    top_k_frac: float = 0.25
    top_k_rungs: int = 2
    explore_rounds: int = 1
    min_steps_to_explore: int = 96
    hold_rounds: int = 8
    # minimum predicted relative win a non-exact wire needs before the
    # prior alone may pick it: on small wires every candidate ties
    # within nanoseconds of modeled link time, and an argmin over that
    # noise would trade real encode compute for a fictional saving.
    # Measured evidence (an explored fit) is never subject to this.
    prior_margin: float = 0.05

    is_auto = True

    def __post_init__(self):
        if self.k_max < 1 or self.growth < 2:
            raise ValueError(
                f"AutoTune needs k_max >= 1 and growth >= 2, got "
                f"k_max={self.k_max} growth={self.growth}")
        if not 1 <= self.k_min <= self.k_max:
            raise ValueError(
                f"AutoTune needs 1 <= k_min <= k_max, got "
                f"k_min={self.k_min} k_max={self.k_max}")
        if self.spike_ratio <= 1.0:
            raise ValueError(
                f"AutoTune.spike_ratio must be > 1, got "
                f"{self.spike_ratio}")
        if not 0.0 <= self.prior_margin < 1.0:
            raise ValueError(
                f"AutoTune.prior_margin must be in [0, 1), got "
                f"{self.prior_margin}")


def auto_plan(**kwargs) -> "mp.MergePlan":
    """``MergePlan`` for the ``"auto"`` spelling — kwargs forward to
    :class:`AutoTune`."""
    return mp.MergePlan(outer=AutoTune(**kwargs))


@dataclasses.dataclass(frozen=True)
class PlanChoice:
    """One point on the controller's candidate grid: a wire format
    crossed with the overlap axis.  ``overlap=True`` dispatches rounds
    through the deferred-commit pipeline (``pipeline_runners``'s
    prologue/runner/drain triple — the paper's I5), hiding merge time
    behind the next round's local compute on grids that actually have
    two execution streams."""

    compression: Optional[CompressionConfig] = None
    overlap: bool = False


def as_choice(c) -> PlanChoice:
    """Normalize a legacy bare ``CompressionConfig | None`` candidate
    to a :class:`PlanChoice` (overlap off)."""
    return c if isinstance(c, PlanChoice) else PlanChoice(compression=c)


def choice_tag(choice) -> str:
    """Compact label for a candidate: the wire's ``compression_tag``
    plus an ``+ov`` suffix when the overlap pipeline is on —
    ``"exact"``, ``"int8+ov"``, ``"top0.25@int8"``."""
    ch = as_choice(choice)
    base = compression_tag(ch.compression)
    return base + "+ov" if ch.overlap else base


def cadence_ladder(k0: int, k_max: int, growth: int) -> List[int]:
    """The cadences a controller can visit: ``k0, k0*growth, ...``
    capped at ``k_max`` (the cost table enumerates exactly these)."""
    ks = [max(1, int(k0))]
    while ks[-1] < k_max:
        ks.append(min(ks[-1] * growth, k_max))
    return ks


def shrink_k(k: int, k_min: int = 1) -> int:
    """THE cadence shrink rule: halve toward ``k_min``.  Shared by
    ``PlanController.observe`` (delta-norm spike) and the recovery
    degradation ladder (``resilience.recovery.RecoveryPolicy.degrade``
    and the ``Trainer``'s cadence ladder), so divergence always walks
    the same cadence steps, whichever layer reacts first."""
    return max(max(1, int(k_min)), int(k) // 2)


class PlanController:
    """Mutable per-fit tuning state: the cadence rule folded in from
    ``merge_plan._CadenceController`` plus measured-vs-prior wire-format
    selection.  Pure host-side Python — ``observe``/``decide`` take and
    return plain floats and ints, so the whole decision sequence is
    testable against a numpy oracle without touching a device."""

    def __init__(self, *, k0: int, k_max: int, growth: int = 2,
                 stable_ratio: float = 0.5, patience: int = 2,
                 shrink: bool = False, spike_ratio: float = 4.0,
                 k_min: int = 1,
                 choices: Sequence[Optional[CompressionConfig]] = (None,),
                 prior: Optional[dict] = None,
                 explore_rounds: int = 0,
                 prior_margin: float = 0.0):
        self.k = max(1, int(k0))
        self.k_max = int(k_max)
        self.growth = int(growth)
        self.stable_ratio = float(stable_ratio)
        self.patience = int(patience)
        self.shrink = bool(shrink)
        self.spike_ratio = float(spike_ratio)
        self.k_min = max(1, int(k_min))
        self._prev: Optional[float] = None
        self._stable = 0
        self.cadence_trace: List[int] = [self.k]

        # candidates are (wire format, overlap) points; legacy bare
        # compression configs normalize to overlap-off choices
        self.choices = [as_choice(c) for c in choices]
        self.prior_margin = float(prior_margin)
        self.prior = dict(prior or {})          # tag -> predicted us/step
        self.measured: dict = {}                # tag -> best measured us/step
        self.cost_table: List[dict] = []
        self.trace: List[dict] = []
        # exploration queue: cost-ranked choice indices, each probed for
        # ``explore_rounds`` scored (non-warmup) rounds before the
        # controller commits to the measured winner
        order = sorted(range(len(self.choices)),
                       key=lambda i: self.prior.get(
                           choice_tag(self.choices[i]), float(i)))
        self._pending: List[int] = list(order) if explore_rounds > 0 \
            and len(self.choices) > 1 else []
        self._probe_left = {i: int(explore_rounds) for i in self._pending}
        self._explored = bool(self._pending)
        self.choice = self.choices[order[0]] if order else None

    # -- the cadence rule (folded _CadenceController) ------------------

    def observe(self, delta_norm: float) -> int:
        """Feed one round's merged-delta norm; returns the cadence for
        the next round.  Grow-on-stability exactly as the legacy
        controller; with ``shrink`` enabled a spike (norm jumping past
        ``spike_ratio`` × previous) halves ``k`` toward ``k_min`` and
        re-bases before any growth logic runs."""
        if self.shrink and self._prev is not None and \
                delta_norm > self.spike_ratio * max(self._prev, 1e-12):
            self.k = shrink_k(self.k, self.k_min)
            self._stable = 0
            self._prev = None     # k changed -> delta magnitude re-bases
            self.cadence_trace.append(self.k)
            return self.k
        if self._prev is not None:
            rel = abs(delta_norm - self._prev) / max(self._prev, 1e-12)
            self._stable = self._stable + 1 \
                if rel <= self.stable_ratio else 0
        self._prev = delta_norm
        if self._stable >= self.patience and self.k < self.k_max:
            self.k = min(self.k * self.growth, self.k_max)
            self._stable = 0
            self._prev = None     # k changed -> delta magnitude re-bases
        self.cadence_trace.append(self.k)
        return self.k

    # -- wire-format selection ----------------------------------------

    def decide(self) -> tuple:
        """``(cadence, compression)`` for the next round: the head of
        the exploration queue while probing; after exploration the
        measured argmin; without exploration the prior argmin.  Modeled
        (prior) and wall-clock (measured) microseconds are different
        scales — a prediction from roofline hardware constants must
        never be compared against a measured time on this host — so a
        decision ranks within exactly one of the two, never across.

        The prior-only branch additionally honours ``prior_margin``:
        the exact wire (when it is a candidate) keeps the choice unless
        the prior argmin beats it by more than that relative fraction.
        On a small wire the modeled link times of every format tie
        within nanoseconds, and a bare argmin would pick a compressed
        wire on noise — paying real encode compute for a saving the
        model can't resolve.  Measured timings are never margined."""
        if self._pending:
            self.choice = self.choices[self._pending[0]]
        elif self._explored and self.measured:
            self.choice = min(
                self.choices,
                key=lambda c: self.measured.get(choice_tag(c),
                                                float("inf")))
        elif len(self.choices) > 1:
            best = min(
                self.choices,
                key=lambda c: self.prior.get(choice_tag(c),
                                             float("inf")))
            exact = PlanChoice()
            exact_us = self.prior.get("exact", float("inf"))
            best_us = self.prior.get(choice_tag(best), float("inf"))
            if exact in self.choices and exact_us < float("inf") and \
                    not best_us < exact_us * (1.0 - self.prior_margin):
                best = exact
            self.choice = best
        else:
            self.choice = self.choices[0]
        return self.k, self.choice

    def observe_round(self, m: Measurement, choice=None) -> None:
        """Feed one dispatched round's outcome: non-warmup timings
        update the measured table (and retire exploration probes);
        the delta norm feeds the cadence rule."""
        tag = choice_tag(choice if choice is not None
                         else self.choice)
        if not m.warmup:
            us = m.us_per_step()
            cur = self.measured.get(tag)
            self.measured[tag] = us if cur is None else min(cur, us)
            if self._pending:
                head = self._pending[0]
                if choice_tag(self.choices[head]) == tag:
                    self._probe_left[head] -= 1
                    if self._probe_left[head] <= 0:
                        self._pending.pop(0)
        if m.delta_norm is not None:
            self.observe(float(m.delta_norm))

    def settled(self) -> bool:
        """No exploration left and the cadence cannot grow further —
        the driver may batch multiple rounds per dispatch (a shrink
        spike unsettles it again)."""
        return not self._pending and self.k >= self.k_max

    def chosen(self) -> dict:
        return {"cadence": int(self.k),
                "compression": choice_tag(self.choice),
                "overlap": bool(as_choice(self.choice).overlap)}

    def trace_dict(self) -> dict:
        """The ``merge_state["tuning_trace"]`` payload: everything
        needed to replay the decision sequence offline."""
        return {
            "choices": [choice_tag(c) for c in self.choices],
            "prior_margin": self.prior_margin,
            "prior_us_per_step": {t: round(v, 3)
                                  for t, v in self.prior.items()},
            "measured_us_per_step": {t: round(v, 3)
                                     for t, v in self.measured.items()},
            "cost_table": self.cost_table,
            "decisions": list(self.trace),
            "chosen": self.chosen(),
            "cadence_trace": list(self.cadence_trace),
        }


def candidate_choices(preset, compression,
                      overlaps=(False, True)) -> list:
    """The candidate grid for one controlled fit: wire formats crossed
    with the overlap axis.  A pinned compression (or a non-auto preset)
    collapses the grid to that single overlap-off choice; unpinned auto
    fits get exact / int8 / the top-k ladder, each with and without the
    overlap pipeline."""
    if compression is not None or not getattr(preset, "is_auto", False):
        return [PlanChoice(compression)]
    wires = [None, CompressionConfig(bits=preset.bits),
             *comp.top_k_ladder(preset.top_k_frac, bits=preset.bits,
                                rungs=preset.top_k_rungs)]
    return [PlanChoice(w, ov) for w in wires for ov in overlaps]


def delta_sq_norm(a, b) -> torch.Tensor:
    """The float32 squared l2 distance between two state trees, on the
    device: the controller brings this one scalar to the host a
    dispatch, never the state."""
    return sum(((x - y).to(torch.float32) ** 2).sum()
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _setup(grid, plan, preset, choices, local_fn, update_fn, state, data):
    """The prior of each candidate and the cost table of the cadence
    ladder, cached on the grid with the candidate grid in the key, so
    repeated fits of one program predict once."""
    from repro_torch.kernels.dispatch import kernels_enabled

    key = ("tuning_setup", mp.fn_signature(local_fn),
           mp.fn_signature(update_fn), kernels_enabled(),
           int(plan.cadence), int(preset.k_max), int(preset.growth),
           tuple(choice_tag(c) for c in choices))
    setup = mp.cache_get(grid, key)
    if setup is None:
        model = CostModel.for_fit(grid, local_fn, update_fn, state, data)
        prior = {choice_tag(c): model.prediction(
            cadence=plan.cadence, compression=c.compression,
            overlap=c.overlap).us_per_step() for c in choices}
        wires = {compression_tag(c.compression): c.compression
                 for c in choices}
        rows = model.table(
            cadences=cadence_ladder(plan.cadence, preset.k_max,
                                    preset.growth),
            compressions=list(wires.values()),
            overlaps=tuple(sorted({c.overlap for c in choices})))
        setup = (prior, rows)
        mp.cache_put(grid, key, setup, local_fn, update_fn)
    return setup


def run_controlled_fit(grid, plan, *, state, ef, local_fn, update_fn,
                       data, steps, callback):
    """Fit driver for adaptive and auto plans (called from
    ``merge_plan.run_fit``).  Returns ``(state, history, ef,
    controller)``; ``ef`` is None unless a candidate compresses.

    A dispatch of ``hold`` rounds at cadence ``k`` with choice ``c`` runs
    ``pipeline_fns(merge_every=k, compression=c.compression,
    state_wire=True, outer=AverageCommit())``: ``plain_round`` ``hold``
    times, or under overlap the prologue, ``hold`` overlapped rounds
    and the drain, so that a probe pays the whole pipeline.  Each
    dispatch ends in one host sync, the delta norm against the
    round-start state, which also makes the wall clock cover the
    dispatched work; its steps' metrics then reach the host in one
    transfer a key (``merge_plan.flush_metrics``), and a callback sees
    the dispatch's end state.
    """
    preset = plan.outer
    auto = getattr(preset, "is_auto", False)
    choices = candidate_choices(preset, plan.compression)
    prior, cost_rows = {}, []
    if len(choices) > 1:
        prior, cost_rows = _setup(grid, plan, preset, choices, local_fn,
                                  update_fn, state, data)

    explore = preset.explore_rounds if auto and len(choices) > 1 \
        and steps >= preset.min_steps_to_explore else 0
    ctl = PlanController(
        k0=plan.cadence, k_max=preset.k_max, growth=preset.growth,
        stable_ratio=preset.stable_ratio, patience=preset.patience,
        shrink=getattr(preset, "shrink", False),
        spike_ratio=getattr(preset, "spike_ratio", 4.0),
        k_min=getattr(preset, "k_min", 1),
        choices=choices, prior=prior, explore_rounds=explore,
        prior_margin=getattr(preset, "prior_margin", 0.0))
    ctl.cost_table = list(cost_rows)

    # one state-shaped EF buffer whenever any candidate compresses: every
    # wire format and cadence shares it, so the controller can switch
    # mid-fit
    need_ef = any(c.compression is not None for c in choices)
    if need_ef and ef is None:
        ef = mp.init_merge_error(grid, state)

    history: list = []
    done = 0
    # the round-start anchor of the delta norm: no commit of the port
    # writes its state in place, so it needs no copy
    prev = state
    hold_max = int(getattr(preset, "hold_rounds", 1))
    seen_cfg: set = set()
    round_i = 0
    while done < steps:
        k_dec, choice = ctl.decide()
        k = min(k_dec, steps - done)
        tag = choice_tag(choice)
        fns = mp.pipeline_fns(grid, local_fn, update_fn, merge_every=k,
                              compression=choice.compression,
                              state_wire=True, outer=mp.AverageCommit())
        hold = 1
        if hold_max > 1 and ctl.settled():
            hold = max(1, min(hold_max, (steps - done) // k))
        warm = (k, tag) not in seen_cfg
        seen_cfg.add((k, tag))
        metrics: list = []
        t0 = time.perf_counter()
        if choice.overlap:
            body = mp.overlapped_body(fns, data)
            carry = (state, fns[3](state, data)[0], ef, ())
            for _ in range(hold):
                carry, m = body(carry)
                metrics.extend(m)
            state, ef, _ = mp.drain(fns, carry, state_wire=True)
        else:
            carry = (state, ef, ())
            for _ in range(hold):
                carry, m = mp.plain_round(fns, data, carry, state_wire=True)
                metrics.extend(m)
            state, ef, _ = carry
        dn = float(torch.sqrt(delta_sq_norm(state, prev)))
        dt = time.perf_counter() - t0
        if grid.mesh is not None:
            # control flow: each rank timed the round on its own host
            # clock, and the ranks must decide alike.  A synchronous round
            # costs its slowest rank, so they agree on the maximum.  (The
            # delta norm is of the replicated state, equal on every rank.)
            dt = coll.mesh_max(grid.mesh, grid.data_axes, dt, grid.device)
        mp.flush_metrics(metrics, history, state, callback)
        done += hold * k
        meas = Measurement(
            key=("plan", k, compression_tag(choice.compression),
                 bool(choice.overlap)),
            seconds=dt, steps=hold * k, delta_norm=dn, warmup=warm,
            source="fit")
        ctl.observe_round(meas, choice)
        ctl.trace.append({
            "round": round_i, "steps_done": done, "cadence": k,
            "rounds_in_dispatch": hold, "compression": tag,
            "overlap": bool(choice.overlap), "warmup": warm,
            "us_per_step": round(meas.us_per_step(), 3),
            "predicted_us_per_step":
                round(prior[tag], 3) if tag in prior else None,
            "delta_norm": dn,
        })
        prev = state
        round_i += 1
    return state, history, (ef if need_ef else None), ctl
