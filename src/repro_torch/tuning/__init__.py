"""repro_torch.tuning — the plan controller and its cost model (port of
``repro.tuning``, ROADMAP item 16a).

* ``tuning.cost`` — :class:`CostModel`, the roofline prior: per-round
  time and wire bytes of a candidate ``(cadence, compression,
  overlap)`` from one counted round and the H100's constants.
* ``tuning.controller`` — :class:`PlanController` and
  ``run_controlled_fit``, the driver behind ``fit(merge_plan="auto")``
  and ``AdaptiveCadence``.
* ``tuning.measurement`` — :class:`Measurement`, the one record every
  measured or predicted timing speaks.

The JAX package's kernel block-shape autotuner (``block_shapes``,
``measure_candidates``, ``register_candidates``, ``autotune``) is item
16b and is not ported yet.  ``cost`` and ``controller`` load lazily (PEP
562): the controller imports the merge plan, whose ``resolve("auto")``
imports this package.
"""

from repro_torch.tuning.measurement import Measurement  # noqa: F401

_LAZY = {
    "CostModel": ("repro_torch.tuning.cost", "CostModel"),
    "compression_tag": ("repro_torch.tuning.cost", "compression_tag"),
    "AutoTune": ("repro_torch.tuning.controller", "AutoTune"),
    "PlanChoice": ("repro_torch.tuning.controller", "PlanChoice"),
    "PlanController": ("repro_torch.tuning.controller", "PlanController"),
    "choice_tag": ("repro_torch.tuning.controller", "choice_tag"),
    "auto_plan": ("repro_torch.tuning.controller", "auto_plan"),
    "cadence_ladder": ("repro_torch.tuning.controller", "cadence_ladder"),
    "candidate_choices": ("repro_torch.tuning.controller",
                          "candidate_choices"),
    "run_controlled_fit": ("repro_torch.tuning.controller",
                           "run_controlled_fit"),
    "shrink_k": ("repro_torch.tuning.controller", "shrink_k"),
}

__all__ = ["Measurement", *sorted(_LAZY)]


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(mod_name), attr)
