"""The paper's four workloads as a configuration.

Port of the fields of ``repro.configs.pim_ml.PimMLConfig`` that the
ported slices read.  The row counts (65,536 and 32,768) are the sizes the
JAX package scaled down to for its CPU container; ``chip_smoke.py`` runs
the same configuration at 2^24 rows, which the card holds for real.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class PimMLConfig:
    n_vdpus: int = 256
    # local update steps per host merge (1 = the paper's merge-per-step)
    merge_every: int = 8
    # which workload the config-driven entry points train, and the
    # minibatch axis (core.minibatch): rows sampled per vDPU per local
    # step, 0 = full batch
    workload: str = "logreg"
    batch_size: int = 0
    svm_l2: float = 1e-3
    mn_classes: int = 4
    reg_rows: int = 65536
    reg_features: int = 64
    reg_steps: int = 50
    # K-means
    km_rows: int = 65536
    km_features: int = 16
    km_clusters: int = 8
    km_iters: int = 10
    # decision tree
    dt_rows: int = 32768
    dt_features: int = 16
    dt_classes: int = 4
    dt_depth: int = 6
    dt_bins: int = 32


CONFIG = PimMLConfig()
