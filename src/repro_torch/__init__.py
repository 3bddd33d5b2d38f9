"""PyTorch/CUDA port of ``repro`` for an NVIDIA H100 (Hopper, ``sm_90a``).

The package mirrors ``repro``'s module names so each module's
counterpart is easy to find, but it imports neither JAX nor anything of
``repro``.  Plain tensor code is PyTorch; each of ``repro``'s five TPU
kernels is hand-written CUDA C++ (``kernels/csrc/``), built with
``nvcc`` at first use and bound through ``ctypes``.

Entry points (``make_grid``, ``make_mesh_grid``, ``PimGrid``, ``api.fit``,
``Workload.predict``, ``models.build``) run on ``cuda`` unless the caller
passes ``device="cpu"``; on the CPU every kernel wrapper runs its plain
PyTorch version.

Ported so far (the training and serving paths of the paper's four
workloads, and dense decoder LM serving):

  * ``core.quantize``  — symmetric quantization, int8 limbs, hybrid dot
  * ``core.lut``       — LUT tables and lookups, Taylor sigmoid
  * ``core.pim``       — ``PimGrid`` (shard, map-reduce, fit) on one
                         device or sharded over a mesh of ranks
                         (``make_mesh_grid``)
  * ``core.datasets``  — regression, classification, blobs, mixture sets
  * ``core.mlalgos``   — Workload API, ``LinReg``, ``LogReg``, ``KMeans``,
                         ``DecisionTree``, ``LinearSVM``,
                         ``MultinomialLogReg``
  * ``kernels``        — ``fxp_matmul``, ``lut_activation``,
                         ``kmeans_assign``, ``split_hist``,
                         ``flash_attention`` + dispatch
  * ``distributed``    — merge plans: the cadence, the SlowMo and
                         Nesterov outer optimizers, the EF and top-k
                         wire and the overlapped merge (``run_fit``);
                         the hierarchical and quantized collectives on
                         ``torch.distributed``
  * ``tuning``         — the plan controller behind ``merge_plan="auto"``
                         and ``AdaptiveCadence``, and its cost model
  * ``roofline``       — the H100's constants, the round counter and the
                         per-round prediction the cost model reads
  * ``optim``          — sgd, momentum, Nesterov, slow momentum, AdamW
  * ``checkpoint``     — async, crash-consistent checkpoints in the JAX
                         package's format (either resumes the other's)
  * ``runtime``        — the fault-tolerant ``Trainer``
                         (``Trainer.for_program`` over a bound program)
  * ``resilience``     — fault plans and their injection, the
                         survivor-weighted merge, the recovery policy
                         (backoff, the divergence detector, the ladder)
                         and ``drive_fit``, the fit under an armed plan
  * ``tree``           — ``tree_map`` / ``tree_leaves`` over tensor trees
  * ``models``         — dense decoder LMs: norms, RoPE, GQA attention
                         with a KV cache, SwiGLU/GELU MLP, prefill and
                         decode behind ``Model``
  * ``configs``        — ``pim_ml`` (the four workloads' fields of
                         ``PimMLConfig``) and ``qwen2_0_5b``
  * ``serving``        — ``PredictRunner`` (``Workload.predict`` behind a
                         bucket ladder, one CUDA graph a bucket),
                         ``ModelRegistry`` (checkpointed versions, an
                         atomic hot-swap) and ``MicroBatchQueue``
  * ``launch.serve``   — the serving CLI: train or restore, publish,
                         an open-loop burst through the queue
  * ``launch.serve_lm`` — batched greedy serving
  * ``launch.mesh``    — the process group and the ``("pod", "data")``
                         mesh
  * ``data``           — the data pipeline: the prefetcher, the token
                         stream and out-of-core streaming
                         (``StreamingDataset`` rotated through the device
                         by ``run_streaming_fit``)
  * ``interop``        — values carried across from the JAX package
"""

from repro_torch.device import resolve_device  # noqa: F401
from repro_torch.core.pim import make_mesh_grid  # noqa: F401
from repro_torch.data import (  # noqa: F401
    ShardedDataset, TokenStream, Prefetcher,
    StreamingDataset, PartitionRotation, RotationFeed,
    run_streaming_fit,
)
