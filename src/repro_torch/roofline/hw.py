"""NVIDIA H100 constants (one card) for the roofline model.

NVIDIA's data sheet for the SXM part, dense rates without sparsity, at
the full 700 W power limit: the card every run of ``chip_smoke.py`` so
far reported as ``NVIDIA H100 80GB HBM3, 700.00 W`` (``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``).  A card set
below 700 W runs slower under load than these rates say.

One card has no link to another, so unlike the JAX package's TPU table
there is no ICI or DCN rate: the slow hop of a single-card grid is an
in-memory reduction and is priced at ``HBM_BW``, as the JAX package
prices the hop of its single-chip grid (``repro.tuning.cost``).
"""

HBM_BW = 3.35e12                # bytes/s, HBM3
PEAK_OPS_INT8 = 1979e12         # int8 tensor-core operations/s
PEAK_FLOPS_BF16 = 989e12        # bf16 tensor-core FLOP/s
PEAK_FLOPS_FP32 = 67e12         # float32 FLOP/s outside the tensor cores
HBM_GB = 80.0

# the peak for each kind of operation a round count records
PEAK_OPS = {"int8": PEAK_OPS_INT8, "bf16": PEAK_FLOPS_BF16,
            "fp32": PEAK_FLOPS_FP32}
