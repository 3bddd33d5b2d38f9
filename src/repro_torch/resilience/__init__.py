"""Fault-tolerant training (port of ``repro.resilience``).

* ``faults``   — a seeded, round-indexed ``FaultPlan`` (non-finite
  lanes, corrupted wire words, dead lanes and pods, hung dispatches,
  torn checkpoints), armed with ``faults.arm`` / ``faults.armed`` and
  injected between dispatches, so the rounds are the fault-free ones;
* ``survivor`` — the survivor-weighted merge: a dead-lane mask rides the
  carry and the merge renormalises by the surviving lane count (exact
  and compressed wires, with or without a mesh);
* ``recovery`` — ``RecoveryPolicy``: backoff, rollback to the last valid
  checkpoint and the degradation ladder, which the ``Trainer`` reads too;
* ``runtime``  — ``drive_fit``, the resilient fit loop that
  ``PimGrid.fit`` runs whenever a plan is armed.

Nothing here runs unless a plan is armed: the unarmed cost is one
``is None`` check a ``fit`` call.
"""

from repro_torch.resilience.faults import (  # noqa: F401
    FAULT_KINDS, DispatchTimeout, FaultEvent, FaultPlan, active, arm,
    armed, armed_context, disarm)
from repro_torch.resilience.recovery import (  # noqa: F401
    DivergenceDetector, RecoveryPolicy, replay_trace)
from repro_torch.resilience.runtime import drive_fit  # noqa: F401
from repro_torch.resilience.survivor import survivor_runners  # noqa: F401

__all__ = [
    "FAULT_KINDS", "DispatchTimeout", "FaultEvent", "FaultPlan",
    "DivergenceDetector", "RecoveryPolicy", "replay_trace",
    "arm", "disarm", "armed", "armed_context", "active", "drive_fit",
    "survivor_runners",
]
