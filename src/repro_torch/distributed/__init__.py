"""Merge side of the engine (``merge_plan``: the exact default plan)."""
