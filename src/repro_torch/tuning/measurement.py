"""The one observation record every tuning mechanism speaks.

A copy of ``repro.tuning.measurement`` (the port imports nothing of the
JAX package).

The tuning layer has two measured channels — kernel-level candidate
timings (``tuning.autotune``, ROADMAP item 16b: one record a kernel
call) and
merge-round wall times observed by the plan controller
(``tuning.controller``) — plus the cost model's analytic priors.  They
all report through :class:`Measurement`, so a controller trace, an
autotune table entry and a roofline prediction are directly comparable
rows (``us_per_step`` is the shared ranking key).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Measurement:
    """One timed (or predicted) unit of work.

    ``key`` identifies what was run — ``("plan", cadence, compression
    tag)`` for a merge round, ``(kernel, table_key, blocks)`` for an
    autotune candidate.  ``seconds`` covers ``steps`` local steps (1 for
    a kernel call), so ``us_per_step`` normalises across cadences.
    ``warmup`` marks first-visit timings, which must not feed the timing
    model (they include compilation in the JAX package, and the
    allocator's growth and each kernel's first launch in the port).
    ``source`` is ``"fit"`` (a live merge round), ``"autotune"`` (the
    kernel bench harness) or ``"prior"`` (a cost-model prediction).
    """

    key: Tuple[Any, ...]
    seconds: float
    steps: int = 1
    delta_norm: Optional[float] = None
    warmup: bool = False
    source: str = "fit"

    def us_per_step(self) -> float:
        return self.seconds * 1e6 / max(int(self.steps), 1)

    def row(self) -> dict:
        """JSON-friendly form for traces and reports."""
        return {"key": list(self.key), "seconds": float(self.seconds),
                "steps": int(self.steps),
                "us_per_step": round(self.us_per_step(), 3),
                "delta_norm": self.delta_norm, "warmup": self.warmup,
                "source": self.source}
