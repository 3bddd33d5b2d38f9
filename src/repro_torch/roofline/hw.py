"""NVIDIA H100 constants (per card) for the roofline model.

NVIDIA's data sheet for the SXM part, dense rates without sparsity, at
the full 700 W power limit: the card every run of ``chip_smoke.py`` so
far reported as ``NVIDIA H100 80GB HBM3, 700.00 W`` (``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``).  A card set
below 700 W runs slower under load than these rates say.

The links.  A grid on a mesh (``core.pim.make_mesh_grid``) crosses two
of them, as the JAX package's TPU table has ICI and DCN:

* the fast ``data`` axis runs inside a node over NVLink 4;
* the slow ``pod`` axis, the paper's host hop, runs between nodes over
  the node's InfiniBand NIC, one NIC a GPU.

A grid without a mesh has no link: its slow hop is an in-memory
reduction and is priced at ``HBM_BW``, as the JAX package prices the
hop of its single-chip grid (``repro.tuning.cost``).
"""

HBM_BW = 3.35e12                # bytes/s, HBM3
PEAK_OPS_INT8 = 1979e12         # int8 tensor-core operations/s
PEAK_FLOPS_BF16 = 989e12        # bf16 tensor-core FLOP/s
PEAK_FLOPS_FP32 = 67e12         # float32 FLOP/s outside the tensor cores
HBM_GB = 80.0

# NVLink 4: 900 GB/s a GPU in both directions together (H100 SXM data
# sheet, "NVLink: 900GB/s"); a collective's bytes move one way, at half
NVLINK_BW = 450e9               # bytes/s a GPU, one direction
# one ConnectX-7 port of 400 Gb/s a GPU (DGX H100 data sheet: "8x
# single-port ConnectX-7 VPI, 400 Gb/s InfiniBand/Ethernet" for 8 GPUs)
NIC_BW_PER_GPU = 400e9 / 8      # bytes/s a GPU, one direction

# the peak for each kind of operation a round count records
PEAK_OPS = {"int8": PEAK_OPS_INT8, "bf16": PEAK_FLOPS_BF16,
            "fp32": PEAK_FLOPS_FP32}
