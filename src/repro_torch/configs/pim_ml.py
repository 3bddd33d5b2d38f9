"""The paper's regression workloads as a configuration.

Port of the fields of ``repro.configs.pim_ml.PimMLConfig`` that the
training slice reads.  ``reg_rows=65536`` is the size the JAX package
scaled down to for its CPU container; ``chip_smoke.py`` runs the same
configuration at 2^24 rows, which the card holds for real.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class PimMLConfig:
    n_vdpus: int = 256
    # local update steps per host merge (1 = the paper's merge-per-step)
    merge_every: int = 8
    reg_rows: int = 65536
    reg_features: int = 64
    reg_steps: int = 50


CONFIG = PimMLConfig()
