"""Device meshes (port of ``repro.launch.mesh``).

Production: single pod (data=16, model=16) — 256 ranks; multi-pod
(pod=2, data=16, model=16) — 512 ranks, where "pod" composes with "data"
into the DP/FSDP dimension (specs name ("pod", "data") tuples), so the
same sharding rules scale to N pods.

A mesh is a ``torch.distributed.DeviceMesh`` over the default process
group, which the caller initializes (``init_process_group`` with its own
address, rank and world size: nothing on a machine names a cluster).
``make_mesh`` builds any shape: on the card by default (NCCL); only a
caller who asks for ``device_type="cpu"`` gets the CPU (gloo), as the
tests do. Functions, never module-level constants, so importing this
module touches no process group.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


def make_mesh(shape: tuple, names: tuple, device_type: str = "cuda"):
    """A DeviceMesh of ``shape`` with axis ``names`` over the first
    prod(shape) ranks of the default process group."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device_type='cpu' for a "
            "gloo mesh on the CPU")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized default process group "
            "(torch.distributed.init_process_group with its address, rank "
            "and world size)")
    need = math.prod(shape)
    if dist.get_world_size() != need:
        raise RuntimeError(f"mesh {tuple(shape)} needs {need} ranks, the "
                           f"process group has {dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


class AbstractMesh:
    """A mesh's axis names and sizes without ranks or devices: what
    ``sharding.spec_for`` reads (the dry run lays cells out over it)."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)

    def __repr__(self):
        return "x".join(str(v) for v in self.shape.values())

    def size(self) -> int:
        """The mesh's ranks, as ``DeviceMesh.size()`` counts them."""
        return math.prod(self.shape.values())


def production_shape(multi_pod: bool = False) -> dict:
    """``{axis: size}`` of a production mesh."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_production_mesh(*, multi_pod: bool = False):
    names = production_shape(multi_pod)
    shape, axes = tuple(names.values()), tuple(names)
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks, found {have} — lay the cells "
            f"out without a process group under `python -m "
            f"repro_torch.launch.dryrun`")
    return make_mesh(shape, axes)


def data_axes_of(mesh) -> tuple:
    """The DP/FSDP axis group for a mesh (everything except 'model')."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return tuple(a for a in names if a != "model")
