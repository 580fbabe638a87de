"""Voxel-grid downsample: Morton sort + batched segment-reduce centroids.

Device re-design of the reference's two downsamplers
(reference: src/cwipc_filters.cpp:30-172):

* The reference's plain path (`cwipc_downsample_voxelgrid`) is a PCL
  VoxelGrid: points are binned by ``floor(coord / cellsize)`` per axis, each
  occupied voxel emits one point whose x,y,z,r,g,b are the arithmetic mean
  of the contributors and whose tile is the bitwise OR of contributors'
  tiles.
* The reference's default path additionally splits the cloud through a
  64*cellsize octree first — purely a work-chunking device for PCL; the
  voxel semantics are the same, except voxels straddling an octree-leaf
  boundary can be emitted twice.  We implement the mathematically clean
  single-grid semantics for both paths (documented divergence: no duplicated
  straddle-voxels; parity is set-equality of centroids within fp tolerance).

Device mapping (sort and sorted-segment reductions, no searchsorted or
random gathers):

1. quantize ``v = floor(xyz / cellsize)`` (int32, clamped), rebase by the
   cloud minimum,
2. build a 30-bit Morton (bit-interleaved) key so the sort also produces a
   *spatially local* output order — downstream neighborhood ops (windowed
   kNN outlier removal, ops/outliers.py) exploit this for gather-free
   candidate search,
3. one multi-operand ``lax.sort`` carrying the exact (vx,vy,vz) keys (ties
   broken after the clamped Morton key, so correctness is independent of
   the Morton clamp) plus the point payload — no permutation-gather,
4. segment boundaries -> segment ids via cumsum; ONE batched segment-sum
   over a [cap, 15] channel matrix (xyz, rgb, count, 8 tile bits) — int32
   on the fast path (10-bit in-voxel offsets), so its result does not
   depend on the order of the device's scatter-adds,
5. the segment id IS the output slot, so the result is born compacted, in
   Morton order.

Everything is static-shape; ``out_capacity`` optionally shrinks the output
buffer (overflow voxels are dropped and reflected in the count — callers
that set it guarantee capacity by construction).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.buffers import PointBuffer, pack_rgba

# Quantized coordinates are clamped to +/-2^29 so the sentinel (INT32_MAX)
# stays strictly larger than any real voxel id.
_CLAMP = 1 << 29
_SENTINEL = jnp.iinfo(jnp.int32).max

# Morton key: 10 bits per axis (after rebasing by the cloud min).  Clouds
# wider than 1024 cells per axis clamp — the exact (vx,vy,vz) tiebreak keys
# keep the reduction correct; only the spatial locality of the output order
# degrades at the clamped fringe.
_MORTON_BITS = 10
_MORTON_MAX = (1 << _MORTON_BITS) - 1

def _part1by2(x: jax.Array) -> jax.Array:
    """Spread the low 10 bits of x so there are two zero bits between each."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _unpart1by2(x: jax.Array) -> jax.Array:
    """Inverse of _part1by2: extract every third bit back to 10 bits."""
    x = x & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    x = (x | (x >> 16)) & 0x000003FF
    return x


def morton3(vx: jax.Array, vy: jax.Array, vz: jax.Array) -> jax.Array:
    """30-bit Morton interleave of three 10-bit coordinates (int32 in/out)."""
    return (
        (_part1by2(vz) << 2) | (_part1by2(vy) << 1) | _part1by2(vx)
    ).astype(jnp.int32)




def _run_sums(new_seg, channels, count, *, ocap):
    """Per-run sums of ``channels`` [cap, C] over the sorted valid points
    (slots [0, count); invalid keys are all sentinel and sort last).  Run
    ``s`` is output slot ``s``; runs past ``ocap`` are dropped.  Returns
    (sums [ocap, C], segment id and weight mask per point, output count)."""
    cap = new_seg.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    seg = jnp.cumsum(new_seg.astype(jnp.int32)) - 1
    last = jnp.clip(count - 1, 0, cap - 1)
    total = jnp.where(count > 0, seg[last] + 1, 0)
    in_range = seg < ocap
    w = jnp.logical_and(idx < count, in_range)
    seg = jnp.where(in_range, seg, 0)  # weight 0 => no corruption
    sums = jax.ops.segment_sum(
        jnp.where(w[:, None], channels, 0), seg, num_segments=ocap,
        indices_are_sorted=True,
    )
    return sums, seg, w, jnp.minimum(total, ocap)


def _color_tile_channels(srgba):
    """int32 [cap, 12] channels of each point: r, g, b, 1, 8 tile bits."""
    u = srgba.astype(jnp.uint32)
    rgb = (u[:, None] >> jnp.array([16, 8, 0], jnp.uint32)) & 0xFF
    bits = (u[:, None] >> (24 + jnp.arange(8, dtype=jnp.uint32))) & 1
    one = jnp.ones_like(u)[:, None]
    return jnp.concatenate([rgb, one, bits], axis=-1).astype(jnp.int32)


def _pack_voxels(xyz, ct_sums, out_count, *, ocap):
    """Output points from per-voxel centroids and the summed
    _color_tile_channels: truncated mean color (PCL's VoxelGrid averages
    colors and truncates on store), OR of the tile bits."""
    cnt = jnp.maximum(ct_sums[:, 3], 1)
    mean_rgb = (ct_sums[:, 0:3] // cnt[:, None]).astype(jnp.uint32)
    out_tile = (
        (ct_sums[:, 4:12] > 0).astype(jnp.uint32)
        * (1 << jnp.arange(8, dtype=jnp.uint32))
    ).sum(axis=-1, dtype=jnp.uint32)
    out_valid = jnp.arange(ocap, dtype=jnp.int32) < out_count
    out_xyz = jnp.where(out_valid[:, None], xyz, 0.0)
    out_rgba = jnp.where(
        out_valid,
        pack_rgba(mean_rgb[:, 0], mean_rgb[:, 1], mean_rgb[:, 2], out_tile),
        0,
    )
    return PointBuffer(xyz=out_xyz, rgba=out_rgba, count=out_count)


def _reduce_segments_xla(new_seg, sx, sy, sz, srgba, count, *, ocap):
    """Reduction of exact-coordinate sorted runs: one float32 segment_sum
    of (x, y, z, color, count, tile bits).  The integer channels are exact
    (below 2^24 per voxel); on the GPU the coordinate sums are atomics in a
    run-dependent order, so centroids may differ in the last bit between
    runs."""
    ct = _color_tile_channels(srgba).astype(jnp.float32)
    channels = jnp.concatenate([jnp.stack([sx, sy, sz], axis=-1), ct], axis=-1)
    sums, _, _, out_count = _run_sums(new_seg, channels, count, ocap=ocap)
    ct_sums = sums[:, 3:].astype(jnp.int32)
    xyz = sums[:, 0:3] / jnp.maximum(ct_sums[:, 3], 1).astype(jnp.float32)[:, None]
    return _pack_voxels(xyz, ct_sums, out_count, ocap=ocap)


def _reduce_runs_xla_cm(smk, sfr, srgba, count, vmin_safe, cell, *, ocap):
    """Channel-major wrapper of the run reduction."""
    pb = _reduce_runs_xla(smk, sfr, srgba, count, vmin_safe, cell, ocap=ocap)
    return pb.xyz[:, 0], pb.xyz[:, 1], pb.xyz[:, 2], pb.rgba, pb.count


def _reduce_runs_xla(smk, sfr, srgba, count, vmin_safe, cell, *, ocap):
    """Reduction of the quantized-payload sorted runs: ONE int32
    segment_sum of the 10-bit in-voxel offsets, colors, count and tile
    bits.  Integer sums are exact in any order, so the result is the same
    bits on every device and every run (GPU scatter-adds are atomics in a
    run-dependent order).  The sums are exact while a voxel holds fewer
    than 2^21 points (1023 * 2^21 < 2^31).

    Centroid = (vmin + demorton(key) + (sum_q + n/2) / (1024 n)) * cell:
    the +1/2 LSB centers the truncated quantization."""
    cap = smk.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    new_seg = jnp.logical_or(idx == 0, smk != jnp.roll(smk, 1))
    q = (sfr[:, None] >> jnp.array([20, 10, 0], jnp.int32)) & 1023
    channels = jnp.concatenate([q, _color_tile_channels(srgba)], axis=-1)
    sums, seg, w, out_count = _run_sums(new_seg, channels, count, ocap=ocap)
    # each run's Morton key (max is order-independent; masked points add 0,
    # below every valid key)
    key = jax.ops.segment_max(
        jnp.where(w, smk, 0), seg, num_segments=ocap, indices_are_sorted=True
    )
    v = jnp.stack(
        [_unpart1by2(key), _unpart1by2(key >> 1), _unpart1by2(key >> 2)], axis=-1
    ) + vmin_safe[None, :]
    n = jnp.maximum(sums[:, 6], 1).astype(jnp.float32)[:, None]
    frac = (sums[:, 0:3].astype(jnp.float32) + 0.5 * n) / (1024.0 * n)
    xyz = (v.astype(jnp.float32) + frac) * cell
    return _pack_voxels(xyz, sums[:, 3:], out_count, ocap=ocap)


@partial(jax.jit, static_argnames=("out_capacity", "exact_keys", "merged_exact"))
def downsample(
    buf: PointBuffer,
    cellsize: jax.Array,
    out_capacity: int | None = None,
    exact_keys: bool = False,
    merged_exact: bool = False,
) -> PointBuffer:
    """Voxel-grid downsample at the given cellsize (f32 scalar, > 0).

    The output buffer has capacity ``out_capacity`` (default: the input
    capacity) and its points are ordered along a Morton space-filling curve.

    Within the 1024^3-cell Morton domain the 30-bit key is UNIQUE per voxel,
    so the sort needs only that one key (carrying the three exact
    coordinates as tiebreak keys multiplies the sort's key work).  Scenes
    wider than 1024 cells per axis clamp at the fringe; pass ``exact_keys=True`` to
    carry the exact voxel-coordinate keys for such scenes (the wrapper
    layer chooses based on the cloud's bounding box).  ``merged_exact``
    (valid when every axis spans < 2^15 cells — the wrapper checks) packs
    the rebased (vy, vz) into one tiebreak key: 3 sort keys instead of 4,
    identical grouping and order (the rebase is a monotonic shift).
    """
    cap = buf.capacity
    ocap = cap if out_capacity is None else out_capacity
    idx = jnp.arange(cap, dtype=jnp.int32)
    valid = idx < buf.count
    inv = 1.0 / jnp.asarray(cellsize, jnp.float32)

    v = jnp.floor(buf.xyz * inv).astype(jnp.int32)
    v = jnp.clip(v, -_CLAMP, _CLAMP)
    # Rebase so Morton coordinates are non-negative.
    vmin = jnp.min(jnp.where(valid[:, None], v, _SENTINEL), axis=0)
    vr = v - jnp.where(vmin == _SENTINEL, 0, vmin)[None, :]
    vm = jnp.clip(vr, 0, _MORTON_MAX)
    mkey = morton3(vm[:, 0], vm[:, 1], vm[:, 2])
    mkey = jnp.where(valid, mkey, _SENTINEL)

    # The four payload words (x, y, z, rgba) of the exact-key forms ride
    # in TWO complex64 operands.  Payloads are never compared (arbitrary
    # bit patterns, NaNs included, pass through unharmed).
    pay1 = jax.lax.complex(buf.xyz[:, 0], buf.xyz[:, 1])
    pay2 = jax.lax.complex(
        buf.xyz[:, 2],
        jax.lax.bitcast_convert_type(buf.rgba.astype(jnp.int32), jnp.float32),
    )
    if exact_keys and merged_exact:
        # rebased coords are >= 0 and < 2^15 per axis here, so (vy, vz)
        # pack into one int32 tiebreak key; ordering matches the unmerged
        # form because the rebase shift is monotonic per axis.
        kx = jnp.where(valid, vr[:, 0], _SENTINEL)
        kyz = jnp.where(valid, (vr[:, 1] << 15) | vr[:, 2], _SENTINEL)
        smk, skx, skyz, sp1, sp2 = jax.lax.sort(
            (mkey, kx, kyz, pay1, pay2), num_keys=3
        )
        new_seg = jnp.logical_or(
            idx == 0,
            (skx != jnp.roll(skx, 1)) | (skyz != jnp.roll(skyz, 1)),
        )
        srgba = jax.lax.bitcast_convert_type(jnp.imag(sp2), jnp.int32)
        return _reduce_segments_xla(
            new_seg, jnp.real(sp1), jnp.imag(sp1), jnp.real(sp2), srgba,
            buf.count, ocap=ocap,
        )
    elif exact_keys:
        kx = jnp.where(valid, v[:, 0], _SENTINEL)
        ky = jnp.where(valid, v[:, 1], _SENTINEL)
        kz = jnp.where(valid, v[:, 2], _SENTINEL)
        smk, skx, sky, skz, sp1, sp2 = jax.lax.sort(
            (mkey, kx, ky, kz, pay1, pay2), num_keys=4
        )
        new_seg = jnp.logical_or(
            idx == 0,
            (skx != jnp.roll(skx, 1))
            | (sky != jnp.roll(sky, 1))
            | (skz != jnp.roll(skz, 1)),
        )
        srgba = jax.lax.bitcast_convert_type(jnp.imag(sp2), jnp.int32)
        return _reduce_segments_xla(
            new_seg, jnp.real(sp1), jnp.imag(sp1), jnp.real(sp2), srgba,
            buf.count, ocap=ocap,
        )
    else:
        mx, my, mz, rgba, cnt = _downsample_fast_cm(
            buf, cellsize, ocap, idx, valid, inv, v, vmin, mkey
        )
        return PointBuffer(
            xyz=jnp.stack([mx, my, mz], axis=-1), rgba=rgba, count=cnt
        )


def _downsample_fast_cm(buf, cellsize, ocap, idx, valid, inv, v, vmin, mkey):
    """Fast-path tail, CHANNEL-MAJOR result (x, y, z, rgba, count rows).

    The absolute voxel coordinate is reconstructible from the Morton key
    (+ vmin), so the sort payload only needs the IN-VOXEL offset —
    quantized to 10 bits per axis and packed into a single int32 (error <=
    cellsize/2048 once centered).  2 sort operands instead of 5.
    """
    frac = buf.xyz * inv - v.astype(jnp.float32)
    q = jnp.clip((frac * 1024.0).astype(jnp.int32), 0, 1023)
    fracs = (q[:, 0] << 20) | (q[:, 1] << 10) | q[:, 2]
    # Both payload words ride in ONE complex64 operand, so the sort is a
    # key/value pair sort.  Payloads are never compared (num_keys=1), so
    # arbitrary bit patterns bitcast to f32 — NaNs included — pass through
    # unharmed.
    payload = jax.lax.complex(
        jax.lax.bitcast_convert_type(fracs, jnp.float32),
        jax.lax.bitcast_convert_type(buf.rgba.astype(jnp.int32), jnp.float32),
    )
    smk, spay = jax.lax.sort((mkey, payload), num_keys=1)
    sfr = jax.lax.bitcast_convert_type(jnp.real(spay), jnp.int32)
    srgba = jax.lax.bitcast_convert_type(jnp.imag(spay), jnp.int32)
    vmin_safe = jnp.where(vmin == _SENTINEL, 0, vmin)
    cell = jnp.asarray(cellsize, jnp.float32)
    return _reduce_runs_xla_cm(
        smk, sfr, srgba, buf.count, vmin_safe, cell, ocap=ocap
    )


def downsample_cm(buf: PointBuffer, cellsize, out_capacity: int, vmin=None):
    """Channel-major fast-path downsample for the fused chain: returns
    (x, y, z, rgba, count) rows, skipping the [N,3] materialization that
    the chain's window-kNN/compaction stages would immediately undo.

    ``vmin`` optionally injects the rebase origin (quantized int32 [3]
    cell coordinates).  Sharded callers pass a collectively-agreed global
    minimum so every shard's Morton keys live in ONE key space and the
    per-shard outputs are globally range-partitionable
    (parallel/rangemerge.py); the default recomputes the local minimum,
    which is the single-device behavior."""
    cap = buf.capacity
    idx = jnp.arange(cap, dtype=jnp.int32)
    valid = idx < buf.count
    inv = 1.0 / jnp.asarray(cellsize, jnp.float32)
    v = jnp.floor(buf.xyz * inv).astype(jnp.int32)
    v = jnp.clip(v, -_CLAMP, _CLAMP)
    if vmin is None:
        vmin = jnp.min(jnp.where(valid[:, None], v, _SENTINEL), axis=0)
    vr = v - jnp.where(vmin == _SENTINEL, 0, vmin)[None, :]
    vm = jnp.clip(vr, 0, _MORTON_MAX)
    mkey = morton3(vm[:, 0], vm[:, 1], vm[:, 2])
    mkey = jnp.where(valid, mkey, _SENTINEL)
    return _downsample_fast_cm(
        buf, cellsize, out_capacity, idx, valid, inv, v, vmin, mkey
    )
