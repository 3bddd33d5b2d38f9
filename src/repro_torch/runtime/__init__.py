"""The fault-tolerant training loop (port of ``repro.runtime``)."""

from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: F401
