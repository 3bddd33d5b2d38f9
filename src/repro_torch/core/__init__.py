"""PIM-style training on one device or a mesh of ranks: ``pim`` (the
PimGrid engine, ``make_grid`` and ``make_mesh_grid``),
``quantize`` (insight I1), ``lut`` (insight I2), ``datasets`` and
``mlalgos`` (the Workload API, linear and logistic regression)."""

from repro_torch.core.pim import (PimGrid, make_cpu_grid,  # noqa: F401
                                 make_grid, make_mesh_grid)
from repro_torch.core import quantize, lut, datasets  # noqa: F401
