"""The process group and the meshes of the port.

Port of ``repro.launch.mesh``.  JAX's mesh is one process over N
devices; ``torch.distributed`` runs one process a rank, every rank the
same program (multi-controller).  A mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
process group, with named axes, built by functions so that importing
this module starts nothing.

* :func:`init_world` starts the process group when none exists: the
  launcher's world when it set ``WORLD_SIZE`` (``torchrun``), else a
  world of one process on an in-process store, so a single process can
  build a ``(1, 1)`` mesh, as ``make_mesh_grid(8)`` does in JAX.
* :func:`make_pim_mesh` — the PIM engine's ``("pod", "data")`` mesh.
  Rank ``r`` sits at ``(pod, data) = divmod(r, data)``, the pod-major
  order of JAX's ``P(("pod", "data"))``.
* :func:`make_host_mesh` — a small ``("data", "model")`` mesh.
* :func:`make_production_mesh` — the production shapes: ``(16, 16)``
  ``("data", "model")`` over 256 ranks, or ``(2, 16, 16)`` ``("pod",
  "data", "model")`` over 512, the ``pod`` axis the slow hop between
  nodes (the dry runs build them over a fake world,
  ``launch.dryrun.fake_mesh``).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def init_world(backend: str | None = None, store=None, *, rank: int = 0,
               world_size: int = 1, device_type: str | None = None) -> None:
    """Start the default process group unless one exists.

    ``backend=None`` takes the one that carries ``device_type``: NCCL
    for ``"cuda"``, gloo for ``"cpu"``, and for ``None`` NCCL where
    there is a card.  With ``store`` (a ``FileStore`` or ``HashStore``)
    the group is ``rank`` of ``world_size`` on it; without one, a
    launcher's environment (``WORLD_SIZE`` set, as ``torchrun`` sets it)
    is used, and otherwise a world of one process on a ``HashStore``,
    which opens no socket."""
    if dist.is_initialized():
        return
    if backend is None:
        if device_type is None:
            device_type = "cuda" if torch.cuda.is_available() else "cpu"
        backend = "nccl" if device_type == "cuda" else "gloo"
    if store is None and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
        return
    if store is None:
        store = dist.HashStore()
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)


def _device_type(device_type: str | None) -> str:
    """The mesh's device type: as asked, else the one the world's
    backend carries.  A CPU mesh over an NCCL world is refused: NCCL has
    no CPU transport."""
    backend = dist.get_backend()
    if device_type is None:
        return "cuda" if backend == "nccl" else "cpu"
    if device_type == "cpu" and backend == "nccl":
        raise ValueError(
            "the world runs NCCL, which carries no CPU tensors; start it "
            "over gloo (init_world(device_type='cpu')) for a CPU mesh")
    return device_type


def make_pim_mesh(pods: int = 1, data: int | None = None,
                  device_type: str | None = None):
    """The PIM engine's data mesh over the world: axes ``("pod",
    "data")``, the layout ``PimGrid`` shards its vDPU axis over
    (``core.pim.make_mesh_grid``).

    ``pod`` is the slow host hop (the compressible axis), ``data`` the
    fast axis inside a pod.  ``data=None`` takes every rank not taken by
    ``pods``.  Starts a world (:func:`init_world`) when none exists.
    The world is started over the backend of ``device_type``;
    ``device_type=None``: ``"cuda"`` under NCCL, ``"cpu"`` otherwise
    (gloo carries CPU and CUDA tensors alike)."""
    from torch.distributed.device_mesh import init_device_mesh

    init_world(device_type=device_type)
    n = dist.get_world_size()
    if pods < 1 or n % pods:
        raise ValueError(
            f"pods={pods} does not divide the world of {n} ranks")
    if data is None:
        data = n // pods
    if pods * data != n:
        raise ValueError(
            f"a ({pods}, {data}) mesh does not cover the world of {n} "
            f"ranks")
    return init_device_mesh(_device_type(device_type), (pods, data),
                            mesh_dim_names=("pod", "data"))


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: str | None = None):
    """A ``(data, model)`` mesh over a world of ``data * model`` ranks
    (axes ``("data", "model")``)."""
    from torch.distributed.device_mesh import init_device_mesh

    init_world(device_type=device_type)
    return init_device_mesh(_device_type(device_type), (data, model),
                            mesh_dim_names=("data", "model"))


PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(multi_pod: bool = False,
                         device_type: str | None = None):
    """The ``(16, 16)`` ``("data", "model")`` mesh, or with ``multi_pod``
    the ``(2, 16, 16)`` ``("pod", "data", "model")`` mesh, over the world
    (JAX's ``make_production_mesh``).  Raises ``ValueError`` naming both
    numbers when the world does not have 256 (512) ranks, as
    ``jax.make_mesh`` does with too few devices, before starting any
    world (none is left behind); otherwise starts the launcher's world
    (:func:`init_world`) when none exists."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    need = 1
    for n in shape:
        need *= n
    have = (dist.get_world_size() if dist.is_initialized()
            else int(os.environ.get("WORLD_SIZE", 1)))
    if have != need:
        raise ValueError(
            f"the {shape} production mesh needs a world of {need} ranks; "
            f"this world has {have}")
    init_world(device_type=device_type)
    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=axes)
