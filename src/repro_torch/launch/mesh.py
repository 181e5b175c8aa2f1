"""Meshes over ``torch.distributed`` ranks (the port of
``repro/launch/mesh.py``).

The port serves and trains SPMD: one process per rank, every rank running
the same host loop on its own shard.  ``init_world`` joins this process to
the world's process group; ``parse_mesh`` lays the initialised world out as
a ``torch.distributed.device_mesh.DeviceMesh`` with dims ``("data",
"model")`` ("DxM") or ``("pod", "data", "model")`` ("PxDxM").  The
``"model"`` dim carries the tensor-parallel ring (the paged serve path's,
the static one's and the training step's), ``"data"`` data parallelism and the FSDP shard
of the training state, ``"pod"`` the slow cross-pod data-parallel axis
(its gradient mean is int8-compressed).  An engine builds its mesh from a
"DxM" spec itself (``device_mesh``); ``make_small_mesh`` lays the world out
on data, (world, 1), as the reference's does by default.

A launcher starts the ranks (``torchrun --nproc-per-node D*M`` sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous address), or a
caller passes ``rank`` / ``world_size`` / ``init_method`` itself (the
tests' spawned ranks, the smoke's two ranks on one card).

``MeshShape`` is a mesh's dims and sizes without processes: the plans
and the deployment pricing read only those, so a 4- or 8-way plan can be
priced in one process (``DeploymentSpec.resolve`` prices a "DxM" spec as
one, making no process group).  ``make_production_mesh`` is the
reference's 256 / 512-chip mesh as a ``MeshShape`` ((16, 16) or (2, 16,
16)), for pricing and plan checks.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os

import torch
import torch.distributed as dist

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")
TIMEOUT_S = 60          # a rank that diverges fails instead of hanging


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's dims and sizes, with ``DeviceMesh``'s reading API
    (``mesh_dim_names``, ``size``, ``device_type``) and no process group
    behind it: for pricing and plan checks, never for serving."""
    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...] = AXES
    device_type: str = "cpu"

    def size(self, mesh_dim: int | None = None) -> int:
        if mesh_dim is None:
            return math.prod(self.shape)
        return self.shape[mesh_dim]


def init_world(device: str | torch.device = "cuda", backend: str | None = None,
               *, rank: int | None = None, world_size: int | None = None,
               init_method: str | None = None,
               timeout_s: float = TIMEOUT_S) -> str:
    """Join this process to the world's process group (once; a second call
    with the group up returns its backend).  ``backend`` defaults to
    ``gloo`` for CPU tensors and ``nccl`` for CUDA ones; ``gloo`` with CUDA
    tensors is allowed (several ranks sharing one card: NCCL refuses two
    ranks on one device), and then the collectives stage through pinned
    host memory (``parallel.hints.TPComm``).  Without ``rank`` /
    ``world_size`` / ``init_method`` the launcher's environment gives them
    (``env://``).  A CUDA rank takes card ``LOCAL_RANK % device_count``
    before the group starts.  Returns the backend."""
    if dist.is_initialized():
        return dist.get_backend()
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kw = {}
    if rank is not None:
        kw.update(rank=rank, world_size=world_size)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return backend


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> MeshShape:
    """The reference's production mesh as a ``MeshShape``: (data=16,
    model=16), or (pod=2, data=16, model=16) with ``multi_pod``.  It
    prices and checks plans; no process group stands behind it."""
    if multi_pod:
        return MeshShape((2, 16, 16), POD_AXES, device_type)
    return MeshShape((16, 16), AXES, device_type)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_mesh(device_type: str, *dims: int):
    from torch.distributed.device_mesh import init_device_mesh
    names = AXES if len(dims) == 2 else POD_AXES
    return init_device_mesh(device_type, tuple(dims), mesh_dim_names=names)


def mesh_shape(spec) -> tuple[int, ...]:
    """``"DxM"`` / ``"PxDxM"`` or a tuple of 2 or 3 sizes -> the sizes."""
    if isinstance(spec, str):
        try:
            dims = tuple(int(x) for x in spec.lower().split("x"))
        except ValueError:
            dims = ()
        if len(dims) not in (2, 3):
            raise ValueError(f"a mesh spec wants DxM or PxDxM (e.g. 2x4, "
                             f"2x1x2), got {spec!r}")
        return dims
    dims = tuple(int(x) for x in spec)
    if len(dims) not in (2, 3):
        raise ValueError(f"a mesh has 2 (data, model) or 3 (pod, data, "
                         f"model) dims, got {spec!r}")
    return dims


def mesh_dims(spec) -> tuple[int, int]:
    """``"DxM"`` or ``(D, M)`` -> ``(D, M)``."""
    dims = mesh_shape(spec)
    if len(dims) != 2:
        raise ValueError(f"a serving mesh wants DxM (e.g. 2x4), got {spec!r}")
    return dims


def parse_mesh(spec: str, device: str | torch.device = "cuda"):
    """``"DxM"`` -> a (data=D, model=M) ``DeviceMesh`` over the initialised
    world, ``"PxDxM"`` -> a (pod=P, data=D, model=M) one, its tensors on
    ``device``'s type (the card unless the caller passes the CPU, as
    ``init_world``).  The product must equal the world size: launch that
    many ranks (``torchrun --nproc-per-node D*M``)."""
    dims = mesh_shape(spec)
    n = world_size()
    need = math.prod(dims)
    if need != n:
        label = "x".join(str(d) for d in dims)
        raise ValueError(f"mesh {label} needs {need} ranks, the world size "
                         f"is {n} (launch them with torchrun "
                         f"--nproc-per-node {need})")
    return _device_mesh(torch.device(device).type, *dims)


def make_small_mesh(device: str | torch.device = "cuda"):
    """A (data, model) ``DeviceMesh`` laying the initialised world out on
    data, (world, 1): the reference's ``make_small_mesh()``."""
    return parse_mesh(f"{world_size()}x1", device)


def device_mesh(mesh, device: str | torch.device):
    """The ``DeviceMesh`` an engine serves on: ``mesh`` itself when it is
    one, or a "DxM" / (D, M) spec built over the initialised world
    (``parse_mesh``) with ``device``'s tensor type; None stays None.  A
    ``MeshShape`` only prices and is refused."""
    if mesh is None or hasattr(mesh, "get_group"):
        return mesh
    if isinstance(mesh, (str, tuple, list)):
        d, m = mesh_dims(mesh)
        return parse_mesh(f"{d}x{m}", device)
    raise ValueError(f"mesh={mesh!r}: serving needs a DeviceMesh over "
                     f"initialised ranks, or a 'DxM' spec to build one "
                     f"(launch.mesh.parse_mesh); a MeshShape only prices")

