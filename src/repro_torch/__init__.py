"""PyTorch/CUDA port of ``repro`` for an NVIDIA H100 (Hopper, ``sm_90a``).

The package mirrors ``repro``'s module names so each module's
counterpart is easy to find, but it imports neither JAX nor anything of
``repro``.  Plain tensor code is PyTorch; the two TPU kernels on the
training path are hand-written CUDA C++ (``kernels/csrc/``), built with
``nvcc`` at first use and bound through ``ctypes``.

Entry points (``make_grid``, ``PimGrid``, ``api.fit``,
``Workload.predict``) run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain
PyTorch version.

Ported so far (the training path of ``examples/quickstart.py``):

  * ``core.quantize``  — symmetric quantization, int8 limbs, hybrid dot
  * ``core.lut``       — LUT tables and lookups, Taylor sigmoid
  * ``core.pim``       — single-device ``PimGrid`` (shard, map-reduce, fit)
  * ``core.datasets``  — synthetic regression / classification sets
  * ``core.mlalgos``   — Workload API, ``LinReg``, ``LogReg``
  * ``kernels``        — ``fxp_matmul`` and ``lut_activation`` + dispatch
  * ``distributed.merge_plan`` — the exact default merge plan
  * ``configs.pim_ml`` — the regression fields of ``PimMLConfig``
  * ``interop``        — values carried across from the JAX package
"""

from repro_torch.device import resolve_device  # noqa: F401
