"""Fixed-capacity SoA point buffers — the device-resident point-cloud object.

Device-first redesign of the reference's point-cloud storage
(reference: src/cwipc_util.cpp:94-410 keeps points as a PCL cloud or a raw
``cwipc_point[]``).  XLA compiles static shapes, so a cloud here is a
*fixed-capacity* structure-of-arrays resident in device memory:

* ``xyz``  — float32 ``[capacity, 3]`` positions,
* ``rgba`` — uint32 ``[capacity]`` packed ``tile<<24 | r<<16 | g<<8 | b``
  (the same bit layout PCL uses for its ``rgba`` field, so the colormap
  bit-mask semantics of the reference carry over unchanged,
  reference: src/cwipc_filters.cpp:362-386),
* ``count`` — int32 scalar, the number of valid points (a *device* scalar so
  op chains never synchronize with the host).

Capacities are bucketed to powers of two so jitted kernels are reused across
frames.  Points at index >= count are padding and must be ignored by every
kernel; the convention is enforced by :func:`valid_mask`.

External interop keeps the reference's exact 16-byte point record
(reference: include/cwipc_util/api.h:88-96): 3x float32 + r,g,b,tile uint8.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# The reference's external point record: 16 bytes, little-endian
# (include/cwipc_util/api.h:88-96).
POINT_DTYPE = np.dtype(
    [
        ("x", "<f4"),
        ("y", "<f4"),
        ("z", "<f4"),
        ("r", "u1"),
        ("g", "u1"),
        ("b", "u1"),
        ("tile", "u1"),
    ]
)
POINT_SIZE = 16
assert POINT_DTYPE.itemsize == POINT_SIZE

MIN_CAPACITY = 128


def bucket_capacity(n: int) -> int:
    """Smallest power-of-two capacity >= n (min MIN_CAPACITY).

    Bucketing keeps the number of distinct compiled kernel shapes small.
    """
    n = int(n)
    if n <= MIN_CAPACITY:
        return MIN_CAPACITY
    return 1 << (n - 1).bit_length()


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PointBuffer:
    """Device-resident SoA point cloud with padding + valid count."""

    xyz: jax.Array  # f32 [capacity, 3]
    rgba: jax.Array  # u32 [capacity]
    count: jax.Array  # i32 scalar

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def valid_mask(self) -> jax.Array:
        return jnp.arange(self.capacity, dtype=jnp.int32) < self.count


def pack_rgba(r: jax.Array, g: jax.Array, b: jax.Array, tile: jax.Array) -> jax.Array:
    """Pack channel arrays (any integer dtype, values 0..255) into uint32."""
    r = r.astype(jnp.uint32)
    g = g.astype(jnp.uint32)
    b = b.astype(jnp.uint32)
    tile = tile.astype(jnp.uint32)
    return (tile << 24) | (r << 16) | (g << 8) | b


def unpack_rgba(rgba: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Unpack uint32 rgba into (r, g, b, tile) uint32 arrays (values 0..255)."""
    r = (rgba >> 16) & 0xFF
    g = (rgba >> 8) & 0xFF
    b = rgba & 0xFF
    tile = (rgba >> 24) & 0xFF
    return r, g, b, tile


def empty_buffer(capacity: int = MIN_CAPACITY) -> PointBuffer:
    return PointBuffer(
        xyz=jnp.zeros((capacity, 3), jnp.float32),
        rgba=jnp.zeros((capacity,), jnp.uint32),
        count=jnp.asarray(0, jnp.int32),
    )


def buffer_from_arrays(
    xyz: np.ndarray,
    r: np.ndarray,
    g: np.ndarray,
    b: np.ndarray,
    tile: np.ndarray,
    capacity: int | None = None,
) -> PointBuffer:
    """Build a PointBuffer from host arrays, padding to a capacity bucket."""
    n = int(xyz.shape[0])
    cap = bucket_capacity(n) if capacity is None else capacity
    assert cap >= n
    xyz_p = np.zeros((cap, 3), np.float32)
    xyz_p[:n] = xyz
    rgba_p = np.zeros((cap,), np.uint32)
    rgba_p[:n] = (
        (tile.astype(np.uint32) << 24)
        | (r.astype(np.uint32) << 16)
        | (g.astype(np.uint32) << 8)
        | b.astype(np.uint32)
    )
    return PointBuffer(
        xyz=jnp.asarray(xyz_p),
        rgba=jnp.asarray(rgba_p),
        count=jnp.asarray(n, jnp.int32),
    )


def buffer_from_numpy(points: np.ndarray, capacity: int | None = None) -> PointBuffer:
    """Build a PointBuffer from a structured array with POINT_DTYPE fields."""
    if points.dtype != POINT_DTYPE:
        points = points.astype(POINT_DTYPE, copy=False)
    xyz = np.stack([points["x"], points["y"], points["z"]], axis=-1).astype(np.float32)
    return buffer_from_arrays(
        xyz, points["r"], points["g"], points["b"], points["tile"], capacity
    )


def buffer_to_numpy(buf: PointBuffer) -> np.ndarray:
    """Copy a PointBuffer back to a host structured array (trimmed to count)."""
    xyz, rgba, count = jax.device_get((buf.xyz, buf.rgba, buf.count))
    n = int(count)
    out = np.zeros(n, POINT_DTYPE)
    out["x"] = xyz[:n, 0]
    out["y"] = xyz[:n, 1]
    out["z"] = xyz[:n, 2]
    rgba = rgba[:n]
    out["r"] = (rgba >> 16) & 0xFF
    out["g"] = (rgba >> 8) & 0xFF
    out["b"] = rgba & 0xFF
    out["tile"] = (rgba >> 24) & 0xFF
    return out


def buffer_from_bytes(data: bytes | bytearray | memoryview, capacity: int | None = None) -> PointBuffer:
    """Build a PointBuffer from packed 16-byte point records."""
    arr = np.frombuffer(bytes(data), dtype=POINT_DTYPE)
    return buffer_from_numpy(arr, capacity)


def buffer_to_bytes(buf: PointBuffer) -> bytearray:
    """Serialize a PointBuffer to packed 16-byte point records."""
    return bytearray(buffer_to_numpy(buf).tobytes())
