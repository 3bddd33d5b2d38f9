"""Recovery policy: backoff, validated rollback, plan degradation.

Port of ``repro.resilience.recovery``.  A divergence (a non-finite loss
or state, a loss spike) is handled in stages, each recorded as a
JSON-able event so a recovery history replays offline:

1. **Backoff and rollback** — sleep ``backoff_base_s * factor^(n-1)``
   (capped) and restore the last valid checkpoint (checksums checked,
   corrupt steps quarantined: ``checkpoint.manager``).
2. **Degradation** — after ``degrade_after`` divergences in a row the
   plan steps down one rung: a compressed wire becomes exact, then the
   cadence halves by the plan controller's shrink rule
   (``tuning.controller.shrink_k``), then overlap is dropped.  A plan
   with no rung left is exhausted.
3. **Give up** — after ``max_restarts`` recoveries the failure is
   raised again.

The ``Trainer`` (``runtime.trainer``, ``TrainerConfig.recovery``) and
the resilient fit loop (``resilience.runtime.drive_fit``, which
``PimGrid.fit`` runs under an armed ``faults.FaultPlan``) read this
policy.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import List, Optional

from repro_torch.distributed import merge_plan as mp


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Immutable recovery configuration (hashable)."""

    max_restarts: int = 8
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_max_s: float = 2.0
    degrade_after: int = 2     # divergences in a row per rung
    min_cadence: int = 1
    spike_factor: float = 0.0  # 0: no loss-spike detection
    spike_window: int = 8

    def __post_init__(self):
        if self.max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        if self.backoff_factor < 1.0:
            raise ValueError("backoff_factor must be >= 1.0")
        if self.degrade_after < 1:
            raise ValueError("degrade_after must be >= 1")

    def backoff_s(self, restarts: int) -> float:
        """The backoff before the ``restarts``-th recovery (1-based),
        exponential and capped at ``backoff_max_s``."""
        if restarts <= 0:
            return 0.0
        return min(self.backoff_max_s,
                   self.backoff_base_s *
                   self.backoff_factor ** (restarts - 1))

    def degrade(self, plan: mp.MergePlan) -> Optional[mp.MergePlan]:
        """One rung down, or ``None`` when none is left: a compressed
        wire becomes exact, then the cadence halves, then overlap goes."""
        from repro_torch.tuning.controller import shrink_k

        if plan.compression is not None:
            return dataclasses.replace(plan, compression=None)
        if plan.cadence > self.min_cadence:
            return dataclasses.replace(
                plan, cadence=shrink_k(plan.cadence, self.min_cadence))
        if plan.overlap:
            return dataclasses.replace(plan, overlap=False)
        return None

    def detector(self) -> "DivergenceDetector":
        return DivergenceDetector(factor=self.spike_factor,
                                  window=self.spike_window)


class DivergenceDetector:
    """A loss monitor on the host: a non-finite loss is a divergence, and
    with ``factor > 0`` so is a loss above ``factor`` times the window's
    median (the finite blow-up a flipped exponent bit leaves)."""

    def __init__(self, *, factor: float = 0.0, window: int = 8):
        self.factor = float(factor)
        self.window: deque = deque(maxlen=max(int(window), 1))

    def observe(self, loss: float) -> bool:
        """Feed one scalar loss; True means a divergence, and the sample
        is then left out of the window, so a window after a rollback is
        not poisoned."""
        loss = float(loss)
        if not math.isfinite(loss):
            return True
        if self.factor > 0.0 and len(self.window) >= 2:
            med = sorted(self.window)[len(self.window) // 2]
            if loss > self.factor * max(med, 1e-12):
                return True
        self.window.append(loss)
        return False

    def reset(self) -> None:
        self.window.clear()


def replay_trace(trace: List[dict], *,
                 start_plan: mp.MergePlan) -> List[str]:
    """Fold a recovery trace's ``degrade`` events over ``start_plan`` and
    return the plan's description after every event: the last entry is
    the plan the live run ended on."""
    plan = start_plan
    states = []
    for ev in trace:
        if ev.get("action") == "degrade":
            plan = mp.MergePlan(
                cadence=int(ev["to_cadence"]),
                overlap=bool(ev.get("to_overlap", plan.overlap)),
                compression=None if ev.get("to_compression") == "none"
                else plan.compression,
                outer=plan.outer)
        states.append(plan.describe())
    return states
