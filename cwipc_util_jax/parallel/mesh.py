"""Device-mesh helpers for multi-device point-cloud processing.

The reference's parallelism axes (SURVEY.md §2.7) map to JAX constructs:

* tile/camera parallelism  -> a 1-D ``cameras`` mesh axis: each device owns
  one (or more) camera's cloud and runs the per-tile pipeline locally;
* point-axis parallelism   -> sharding the point dimension of one huge
  cloud across devices (``points`` axis);
* cross-camera fusion      -> ``all_gather`` + an on-device merge
  (the device equivalent of the reference's cwipc_join + synchronizer,
  reference: src/cwipc_filters.cpp:388-418,
  python/cwipc/net/source_synchronizer.py:106-200).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CAMERA_AXIS = "cameras"


def make_mesh(
    n_devices: Optional[int] = None,
    axis: str = CAMERA_AXIS,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """A 1-D mesh over the first n devices (all devices by default).

    Pass ``devices`` explicitly to build the mesh on a non-default backend
    (e.g. a virtual CPU mesh from a process whose default backend is the
    GPU, as the multi-device dry run does).  Every device reaches every
    other directly, so the mesh is 1-D and follows the algorithm alone.
    """
    if devices is None:
        devices = jax.devices()
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def cpu_devices(min_devices: int = 1) -> list[jax.Device]:
    """The host CPU devices, or [] if fewer than ``min_devices`` exist.

    The CPU backend honors ``--xla_force_host_platform_device_count`` in
    ``XLA_FLAGS`` at first use; callers that need N virtual devices must
    inject that flag before ANY code touches the CPU backend.
    """
    try:
        cpus = jax.local_devices(backend="cpu")
    except RuntimeError:
        return []
    return cpus if len(cpus) >= min_devices else []


def camera_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding that puts one camera (leading axis) per device."""
    return NamedSharding(mesh, P(CAMERA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
