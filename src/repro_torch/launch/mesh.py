"""Host meshes for the port's partitioned steps, the counterpart of
``repro.launch.mesh.make_host_mesh``.

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
