"""The paper's four workloads as a configuration.

Port of ``repro.configs.pim_ml.PimMLConfig``'s workload and merge-plan
fields.  The row counts (65,536 and 32,768) are the sizes the
JAX package scaled down to for its CPU container; ``chip_smoke.py`` runs
the same configuration at 2^24 rows, which the card holds for real.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class PimMLConfig:
    n_vdpus: int = 256
    # local update steps per host merge (1 = the paper's merge-per-step)
    merge_every: int = 8
    # the merge pipeline: the merge overlapped with the next round's
    # compute (one round of staleness), float leaves quantized to
    # merge_compression_bits with error feedback (0 = exact), and top-k
    # sparsified merges keeping this fraction of each float leaf (0.0 =
    # dense; values at merge_compression_bits, or raw at 0 bits)
    overlap_merge: bool = False
    merge_compression_bits: int = 0
    merge_top_k_frac: float = 0.0
    # outer optimizer at the merge boundary: "avg" (the plain average),
    # "slowmo" (slow momentum), "nesterov" (its lookahead variant, with
    # the slowmo hyperparameters), "adaptive" (the cadence controller,
    # growing the cadence up to adaptive_k_max as merged deltas
    # stabilise) or "auto" (the plan controller: cadence and wire format
    # from the cost model's prior and measured round times)
    merge_outer: str = "avg"
    slowmo_beta: float = 0.5
    slowmo_outer_lr: float = 1.0
    adaptive_k_max: int = 16
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

    def merge_plan(self):
        """The config's merge fields as a
        ``distributed.merge_plan.MergePlan``."""
        from repro_torch.distributed.compression import CompressionConfig
        from repro_torch.distributed.merge_plan import (
            AdaptiveCadence, AverageCommit, MergePlan, Nesterov, SlowMo)
        from repro_torch.tuning import AutoTune

        compression = None
        if self.merge_compression_bits or self.merge_top_k_frac:
            compression = CompressionConfig(
                bits=self.merge_compression_bits or None,
                top_k_frac=self.merge_top_k_frac or None)
        outers = {"avg": AverageCommit(),
                  "slowmo": SlowMo(beta=self.slowmo_beta,
                                   outer_lr=self.slowmo_outer_lr),
                  "nesterov": Nesterov(beta=self.slowmo_beta,
                                       outer_lr=self.slowmo_outer_lr),
                  "adaptive": AdaptiveCadence(k_max=self.adaptive_k_max),
                  "auto": AutoTune(k_max=self.adaptive_k_max)}
        if self.merge_outer not in outers:
            raise ValueError(
                f"merge_outer must be one of {sorted(outers)}, got "
                f"{self.merge_outer!r}")
        return MergePlan(cadence=self.merge_every,
                         overlap=self.overlap_merge, compression=compression,
                         outer=outers[self.merge_outer])


CONFIG = PimMLConfig()
