"""Device mesh helpers — the substrate replacing the reference's
``torch.distributed`` process groups (``MQGCN.py:100-109``): single-controller JAX,
named mesh axes, XLA collectives (NCCL on GPUs).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    axis_names: Sequence[str] = ("data",),
    shape: Optional[Sequence[int]] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a mesh over all (or given) devices.

    Default: 1-D ``data`` axis over every device. Pass ``shape`` for N-D meshes,
    e.g. ``make_mesh(("data", "model"), (4, 2))``.
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    arr = np.asarray(devices).reshape(tuple(shape))
    return Mesh(arr, tuple(axis_names))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def sharded_dim0(mesh: Mesh, axis: str = "data") -> NamedSharding:
    return NamedSharding(mesh, P(axis))
