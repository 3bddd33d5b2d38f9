"""Serving: the request-driven execution path (port of
``repro.serving``).

``Workload.predict`` (core/mlalgos) is the forward pass;
:class:`PredictRunner` captures it once per (workload, bucket, features,
state shapes) as a CUDA graph behind a pad-to-bucket ladder, staged
through pinned buffers; :class:`ModelRegistry` versions checkpointed
states behind an atomic hot-swap; :class:`MicroBatchQueue` coalesces
single-row requests into bucket-sized micro-batches under a max-wait
deadline with backpressure and per-request latency accounting.
"""

from repro_torch.serving.queue import Backpressure, MicroBatchQueue
from repro_torch.serving.registry import ModelRegistry
from repro_torch.serving.runner import DEFAULT_BUCKETS, PredictRunner

__all__ = ["Backpressure", "DEFAULT_BUCKETS", "MicroBatchQueue",
           "ModelRegistry", "PredictRunner"]
