"""Data pipeline (port of ``repro.data``): the resident placement, the
synthetic token stream, the prefetcher and out-of-core streaming."""

from repro_torch.data.pipeline import (  # noqa: F401
    ShardedDataset, TokenStream, Prefetcher,
    StreamingDataset, PartitionRotation, RotationFeed,
    run_streaming_fit,
)
