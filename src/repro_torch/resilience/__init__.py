"""Fault tolerance (port of ``repro.resilience``): so far the recovery
policy the ``Trainer`` reads (``recovery``).  The fault plans and
injectors (``faults``), the survivor-weighted merges (``survivor``) and
the resilient fit loop (``runtime``) are ROADMAP item 13."""

from repro_torch.resilience.recovery import (  # noqa: F401
    DivergenceDetector, RecoveryPolicy, replay_trace)

__all__ = ["DivergenceDetector", "RecoveryPolicy", "replay_trace"]
