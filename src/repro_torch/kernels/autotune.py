"""The block-shape autotuner under its old path, as in the JAX package
(``repro.kernels.autotune``): it lives in ``repro_torch.tuning.autotune``,
one axis of the tuning layer beside the plan controller and the cost
model.  This module re-exports its whole surface; the in-memory cache is
``tuning.autotune``'s, so both import paths share it."""

from repro_torch.tuning.autotune import (  # noqa: F401
    CANDIDATE_TABLE,
    KERNEL_DIMS,
    Measurement,
    Sweep,
    autotune,
    backend_of,
    block_shapes,
    cache_path,
    measure_candidates,
    register_candidates,
    reset_cache_for_tests,
    shape_bucket,
    store_best,
    table_key,
    _candidates,
    _heuristic,
    _load_cache,
    _store,
    _time_call,
)
