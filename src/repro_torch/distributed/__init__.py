"""Merge side of the engine: ``merge_plan`` (cadence, overlap,
compression and the outer optimizers), ``compression`` (the EF and
top-k wire) and ``overlap`` (the double-buffered round)."""
