"""Merge side of the engine: ``merge_plan`` (cadence, overlap,
compression and the outer optimizers), ``compression`` (the EF and
top-k wire), ``overlap`` (the double-buffered round) and
``collectives`` (the hierarchical and quantized all-reduces of a mesh)."""
