"""Merge side of the engine (``merge_plan``: cadence and the outer
optimizers)."""
