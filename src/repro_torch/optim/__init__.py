"""Optimizers over trees of tensors (port of ``repro.optim``)."""

from repro_torch.optim.optimizers import (  # noqa: F401
    OptState, Optimizer, adamw, momentum, nesterov, sgd, slow_momentum,
)
