"""Hand-written Hopper kernels and their dispatch.

Layout: ``csrc/<name>.cu`` (CUDA C++ for ``sm_90a`` with a plain C
interface), ``<name>.py`` (its ``ctypes`` wrapper and launch counter),
``ref.py`` (the plain PyTorch versions), ``build.py`` (``nvcc`` at first
use), ``dispatch.py`` (the mlalgos' entry points and
``use_kernels``).
"""
