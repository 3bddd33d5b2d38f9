"""Build the CUDA kernels from ``kernels/csrc/`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its
own by ``nvcc`` into ``_build/lib<name>-<digest>.so`` next to this file
(the directory is git-ignored), then loaded with ``ctypes``.  The digest
covers the source and the flags, so an edited source is rebuilt and a
stale library is never loaded.  :func:`build_all` starts one ``nvcc``
per missing library, all at once, and waits for them together.

The flags target Hopper only (``sm_90a``) and leave out
``--use_fast_math``: the LUT index must be an IEEE float32 divide.

A traced call (:func:`traced`: a fake or ``meta`` tensor, which the dry
runs make) launches nothing: each wrapper returns empty outputs of its
kernel's shapes and dtypes and charges what a launch charges.  A
``DTensor`` never reaches a wrapper (:func:`traced` raises on one):
``kernels.dispatch`` runs each rank's shard through ``local_map``.

A kernel that cannot be built or launched raises :class:`KernelError`,
a ``RuntimeError``, so that a caller which retries failed steps (the
``Trainer``'s restore-and-replay) can tell it from a step that merely
diverged and raise it at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("fxp_matmul", "lut_activation", "kmeans_assign", "split_hist",
           "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


class KernelError(RuntimeError):
    """A kernel could not be built (no ``nvcc``, a failed compile) or its
    launch returned a CUDA error.  Retrying the step cannot help."""


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc`` or the one on
    ``PATH``; raises when there is none."""
    candidates = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                               "nvcc"),
                  "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise KernelError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels are built from kernels/csrc/ at first use")


def library_path(name: str, src: Path | None = None) -> Path:
    """Where the library of ``src`` (default ``csrc/<name>.cu``) is built."""
    src = CSRC / f"{name}.cu" if src is None else Path(src)
    digest = hashlib.sha256(src.read_bytes() +
                            " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=KERNELS, sources: dict | None = None) -> dict:
    """Compile every library in ``names`` that is not built yet, all in
    parallel; ``sources`` maps a name to a source other than
    ``csrc/<name>.cu`` (an edited copy, for comparing versions).  Returns
    ``{name: ptxas report}`` (registers, shared memory, spills) for the
    ones built here; raises with nvcc's output if any build fails."""
    srcs = {n: (sources or {}).get(n, CSRC / f"{n}.cu") for n in names}
    todo = [n for n in names if not library_path(n, srcs[n]).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(prefix=f"lib{name}-", suffix=".so.tmp",
                                   dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(srcs[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{out}")
            os.unlink(tmp)
            continue
        os.replace(tmp, library_path(name, srcs[name]))
        logs[name] = out
    if failed:
        raise KernelError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed.
    ``signatures`` maps each C function to ``(restype, argtypes)``."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = _LIBS[name] = bind(library_path(name), signatures)
    return lib


def bind(path: Path, signatures: dict) -> ctypes.CDLL:
    """Load the library at ``path`` and declare ``signatures``."""
    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in signatures.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err:
        msg = getattr(lib, f"{name}_error_string")(err)
        raise KernelError(f"{name} launch failed: CUDA error {err} "
                           f"({msg.decode() if msg else '?'})")


def traced(*tensors) -> bool:
    """True when the tensors are fake (``FakeTensorMode``) or ``meta``:
    a trace that holds no data, which the wrappers answer with empty
    outputs and no launch.  A real CPU or CUDA tensor is not traced.
    Raises ``TypeError`` on a ``DTensor``: a wrapper takes a rank's local
    tensors, never the sharded ones."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor

    ts = [t for t in tensors if t is not None]
    if any(isinstance(t, DTensor) for t in ts):
        raise TypeError("a kernel wrapper takes local tensors, not "
                        "DTensors: call it through kernels.dispatch, which "
                        "runs each rank's shard by local_map")
    return any(isinstance(t, FakeTensor) or t.is_meta for t in ts)
