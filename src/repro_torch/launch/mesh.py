"""Meshes of the port, the counterparts of ``repro.launch.mesh``:
``make_production_mesh`` (the 16x16 pod, 2x16x16 with the pod axis) and
``make_device_mesh`` (a ``torch.distributed`` ``DeviceMesh`` of any shape
over the current process group), both for the sharded steps of
``dist.sharding``; and ``make_host_mesh`` for the partitioned GNN steps.

NCCL takes one rank per GPU, so a mesh on the card has as many ranks as
cards (a one-card host gives the (1, 1) mesh); gloo ranks on the CPU take
any shape.

A ``HostMesh`` names the mesh axes of the one-process route of
``dist.partitioned_gnn``: every partition of the mesh lives on one explicit
``torch.device`` (the card by default), and ``devices`` only carries the
mesh's shape, so ``dist.multihost.split_mesh_axes`` reads it unchanged.
The route of one partition a process takes a
``torch.distributed.device_mesh.DeviceMesh`` instead.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def make_device_mesh(shape, axes=("data", "model"), *, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks 0 ..
    prod(shape) - 1 of the current process group (which the caller has
    initialized: NCCL on ``"cuda"``, the default, or gloo on ``"cpu"``).
    Raises ``RuntimeError`` when the group has fewer ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes) or any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} does not fit axes {axes}")
    n = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(f"need {n} ranks for mesh {shape}, have {world}")
    return DeviceMesh(device, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh on the card: (16, 16) ``("data", "model")``, or
    (2, 16, 16) with ``"pod"`` in front.  Raises ``RuntimeError`` when the
    process group is smaller."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    import torch.distributed as dist
    n = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(f"need {n} ranks for mesh {shape}, have {world}")
    if world == n:
        from torch.distributed.device_mesh import init_device_mesh
        return init_device_mesh("cuda", shape, mesh_dim_names=axes)
    return make_device_mesh(shape, axes)


@dataclass(frozen=True, eq=False)
class HostMesh:
    """Mesh axes over partitions that all live on ``device``."""
    axis_names: tuple
    devices: np.ndarray          # object array of ``device``, mesh-shaped
    device: torch.device

    @property
    def shape(self) -> tuple:
        return tuple(self.devices.shape)


def make_host_mesh(shape=(1, 1), axes=("data", "model"), *,
                   device="cuda") -> HostMesh:
    """A mesh of ``shape`` named ``axes`` on one ``device`` (``"cuda"``
    unless the caller asks for another, e.g. ``"cpu"``)."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes) or any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} does not fit axes {axes}")
    device = torch.device(device)
    devices = np.empty(shape, dtype=object)
    devices.fill(device)
    return HostMesh(axis_names=axes, devices=devices, device=device)
