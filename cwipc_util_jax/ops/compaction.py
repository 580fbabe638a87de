"""Masked stream-compaction ops: tilefilter, tilemap, crop, colormap, join.

Device equivalents of the reference's point-loop operators
(reference: src/cwipc_filters.cpp:281-418).  On a static-shape compiler,
"remove some points" becomes: compute a keep-mask, cumsum the mask into
destination slots, scatter into a same-capacity output, and update the device
count scalar.  No host synchronization happens anywhere in this module; the
count stays a device scalar so chains of ops fuse under one jit.

Semantics preserved exactly from the reference:

* ``tilefilter(pc, t)``: keeps points whose tile == t, or ALL points when
  t == 0 (exact equality, NOT a bitmask test — cwipc_filters.cpp:295-299).
* ``tilemap``: tile' = lut[tile], 256-entry LUT (cwipc_filters.cpp:308-331).
* ``crop``: bbox test is lower-inclusive / upper-exclusive
  (cwipc_filters.cpp:347-354).
* ``colormap``: rgba' = (rgba & ~clearBits) | setBits on the PCL-layout
  packed value, i.e. the masks can also touch the tile byte (bits 24-31)
  (cwipc_filters.cpp:362-386).
* ``join``: concatenation, order pc1 then pc2 (cwipc_filters.cpp:388-418);
  timestamp/cellsize combination is done by the host wrapper.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.buffers import PointBuffer


def _sort_compact(cap, x, y, z, rgba, keep):
    """Kept rows first, in their original order: one stable sort on the
    packed (dropped, index) key carrying the four payload words."""
    idx = jnp.arange(cap, dtype=jnp.int32)
    dropped = (~keep).astype(jnp.int32)
    payload = (
        jax.lax.bitcast_convert_type(x, jnp.int32),
        jax.lax.bitcast_convert_type(y, jnp.int32),
        jax.lax.bitcast_convert_type(z, jnp.int32),
        rgba.astype(jnp.int32),
    )
    if cap <= (1 << 30):
        sxi, syi, szi, srgba = jax.lax.sort(
            (dropped * cap + idx,) + payload, num_keys=1
        )[1:]
    else:
        sxi, syi, szi, srgba = jax.lax.sort(
            (dropped, idx) + payload, num_keys=2
        )[2:]
    return (
        jax.lax.bitcast_convert_type(sxi, jnp.float32),
        jax.lax.bitcast_convert_type(syi, jnp.float32),
        jax.lax.bitcast_convert_type(szi, jnp.float32),
        srgba.astype(jnp.uint32),
    )


def compact(buf: PointBuffer, keep: jax.Array) -> PointBuffer:
    """Keep the masked points, preserving order; padding slots are zeroed.

    ``keep`` is a bool[capacity] mask; it is automatically restricted to the
    valid region of the buffer.

    The compaction is a stable sort on (dropped-flag, original index)
    carrying the point payload (XLA lowers unsorted scatters poorly).
    The two keys pack into ONE int32 — the index is unique, so the
    combined key yields the identical total order with a single sort key.
    The packed key (dropped * capacity + idx) needs capacity <= 2^30;
    larger buffers keep the two-key form.
    """
    cap = buf.capacity
    keep = jnp.logical_and(keep, buf.valid_mask())

    sx, sy, sz, srgba = _sort_compact(
        cap, buf.xyz[:, 0], buf.xyz[:, 1], buf.xyz[:, 2], buf.rgba, keep
    )
    sxyz = jnp.stack([sx, sy, sz], axis=-1)
    new_count = keep.sum(dtype=jnp.int32)
    out_valid = jnp.arange(cap, dtype=jnp.int32) < new_count
    new_xyz = jnp.where(out_valid[:, None], sxyz, 0.0)
    new_rgba = jnp.where(out_valid, srgba, 0)
    return PointBuffer(xyz=new_xyz, rgba=new_rgba, count=new_count)


def compact_cm(x, y, z, rgba, keep, count) -> PointBuffer:
    """Channel-major compaction (coordinate rows in): the fused chain's
    form — the [N,3] output is materialized exactly once, here."""
    cap = x.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    keep = jnp.logical_and(keep, idx < count)

    cx, cy, cz, crgba = _sort_compact(cap, x, y, z, rgba, keep)
    new_count = keep.sum(dtype=jnp.int32)
    out_valid = idx < new_count
    new_xyz = jnp.where(
        out_valid[:, None], jnp.stack([cx, cy, cz], axis=-1), 0.0
    )
    new_rgba = jnp.where(out_valid, crgba, 0)
    return PointBuffer(xyz=new_xyz, rgba=new_rgba, count=new_count)


@jax.jit
def tilefilter(buf: PointBuffer, tile: jax.Array) -> PointBuffer:
    """Select points with tile == tile, or all points when tile == 0."""
    tile = jnp.asarray(tile, jnp.uint32)
    point_tile = (buf.rgba >> 24) & 0xFF
    keep = jnp.logical_or(tile == 0, point_tile == tile)
    return compact(buf, keep)


@jax.jit
def tilemap(buf: PointBuffer, lut: jax.Array) -> PointBuffer:
    """Rewrite every point's tile through a 256-entry LUT."""
    lut = lut.astype(jnp.uint32)
    point_tile = (buf.rgba >> 24) & 0xFF
    new_tile = lut[point_tile]
    new_rgba = (buf.rgba & jnp.uint32(0x00FFFFFF)) | (new_tile << 24)
    new_rgba = jnp.where(buf.valid_mask(), new_rgba, 0)
    return PointBuffer(xyz=buf.xyz, rgba=new_rgba, count=buf.count)


@jax.jit
def crop(buf: PointBuffer, bbox: jax.Array) -> PointBuffer:
    """Keep points inside [x0,x1) x [y0,y1) x [z0,z1); bbox is f32[6]."""
    bbox = bbox.astype(jnp.float32)
    lo = bbox[0::2]  # x0, y0, z0
    hi = bbox[1::2]  # x1, y1, z1
    inside = jnp.all((buf.xyz >= lo) & (buf.xyz < hi), axis=-1)
    return compact(buf, inside)


@jax.jit
def colormap(buf: PointBuffer, clear_bits: jax.Array, set_bits: jax.Array) -> PointBuffer:
    """rgba' = (rgba & ~clearBits) | setBits (PCL packed layout, tile byte included)."""
    clear_bits = jnp.asarray(clear_bits, jnp.uint32)
    set_bits = jnp.asarray(set_bits, jnp.uint32)
    new_rgba = (buf.rgba & ~clear_bits) | set_bits
    new_rgba = jnp.where(buf.valid_mask(), new_rgba, 0)
    return PointBuffer(xyz=buf.xyz, rgba=new_rgba, count=buf.count)


@partial(jax.jit, static_argnames=("capacity",))
def join(buf1: PointBuffer, buf2: PointBuffer, capacity: int) -> PointBuffer:
    """Concatenate two buffers into a buffer of the given (static) capacity.

    Points of buf1 come first, then points of buf2, as in the reference
    (cwipc_filters.cpp:403-409).
    """
    cap = capacity
    idx1 = jnp.arange(buf1.capacity, dtype=jnp.int32)
    idx2 = jnp.arange(buf2.capacity, dtype=jnp.int32)
    tgt1 = jnp.where(idx1 < buf1.count, idx1, cap)
    tgt2 = jnp.where(idx2 < buf2.count, idx2 + buf1.count, cap)
    xyz = jnp.zeros((cap, 3), jnp.float32)
    rgba = jnp.zeros((cap,), jnp.uint32)
    xyz = xyz.at[tgt1].set(buf1.xyz, mode="drop").at[tgt2].set(buf2.xyz, mode="drop")
    rgba = rgba.at[tgt1].set(buf1.rgba, mode="drop").at[tgt2].set(buf2.rgba, mode="drop")
    return PointBuffer(xyz=xyz, rgba=rgba, count=buf1.count + buf2.count)


@jax.jit
def transform44(buf: PointBuffer, matrix: jax.Array) -> PointBuffer:
    """Apply a 4x4 homogeneous transform to all points (registration helper).

    Equivalent of the reference's cwipc_transform in
    python/cwipc/registration/util.py:295-309, but on-device: a [N,3]x[3,3]
    matmul plus translation.
    """
    m = matrix.astype(jnp.float32)
    rot = m[:3, :3]
    trans = m[:3, 3]
    # HIGHEST precision: a reduced-precision matmul (TF32 on the GPU)
    # would smear transformed coordinates by ~1e-3 relative (sub-mm at
    # body scale, but visible in registration residuals and round-trip
    # tests)
    new_xyz = (
        jax.lax.dot_general(
            buf.xyz, rot.T,
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        + trans
    )
    new_xyz = jnp.where(buf.valid_mask()[:, None], new_xyz, 0.0)
    return PointBuffer(xyz=new_xyz, rgba=buf.rgba, count=buf.count)
