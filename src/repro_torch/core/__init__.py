"""PIM-style training on one device: ``pim`` (the PimGrid engine),
``quantize`` (insight I1), ``lut`` (insight I2), ``datasets`` and
``mlalgos`` (the Workload API, linear and logistic regression)."""

from repro_torch.core.pim import PimGrid, make_cpu_grid, make_grid  # noqa: F401
from repro_torch.core import quantize, lut, datasets  # noqa: F401
