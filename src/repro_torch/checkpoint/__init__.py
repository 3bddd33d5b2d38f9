"""Checkpoints (port of ``repro.checkpoint``): the JAX package's format
on disk, written asynchronously and restored onto the template's
devices."""

from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointCorruptError, CheckpointManager)
