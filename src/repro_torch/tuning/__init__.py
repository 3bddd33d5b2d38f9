"""repro_torch.tuning — the plan controller, its cost model and the kernels'
block-shape autotuner (port of ``repro.tuning``, ROADMAP items 16a and
16b).

* ``tuning.cost`` — :class:`CostModel`, the roofline prior: per-round
  time and wire bytes of a candidate ``(cadence, compression,
  overlap)`` from one counted round and the H100's constants.
* ``tuning.controller`` — :class:`PlanController` and
  ``run_controlled_fit``, the driver behind ``fit(merge_plan="auto")``
  and ``AdaptiveCadence``.
* ``tuning.measurement`` — :class:`Measurement`, the one record every
  measured or predicted timing speaks.

* ``tuning.autotune`` — the kernels' launch layouts (item 16b):
  ``block_shapes`` (a measured table entry or the heuristic, at every
  kernel call of ``kernels.dispatch`` and ``kernels.ops``),
  ``measure_candidates``, ``register_candidates`` and ``autotune``.

``cost``, ``controller`` and ``autotune`` load lazily (PEP 562): the
controller imports the merge plan, whose ``resolve("auto")`` imports
this package, and ``autotune`` imports the kernel wrappers.
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
    "block_shapes": ("repro_torch.tuning.autotune", "block_shapes"),
    "measure_candidates": ("repro_torch.tuning.autotune",
                           "measure_candidates"),
    "register_candidates": ("repro_torch.tuning.autotune",
                            "register_candidates"),
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
