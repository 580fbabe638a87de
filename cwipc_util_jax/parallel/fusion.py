"""Multi-camera fusion over a device mesh.

The full multi-chip step of the framework: D cameras' clouds, one per
device, are (1) voxel-downsampled, outlier-cleaned and tile-tagged locally,
(2) fused across the mesh with an ``all_gather``, and
(3) dedup-voxelized globally so points seen by several cameras merge into
single points whose tile byte carries the OR of contributing camera masks.

This is the device equivalent of the reference's per-camera capture
threads + cwipc_join + downsample fusion pipeline
(reference: python/cwipc/net/source_synchronizer.py:106-200 merges per-tile
streams with cwipc_join; src/cwipc_filters.cpp:388-418 join semantics).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..core.buffers import PointBuffer
from ..ops import compaction, outliers, voxelize
from .mesh import CAMERA_AXIS


def _local_clean(xyz, rgba, count, cellsize, k, mult, cell_cap):
    """Per-camera local pipeline: downsample + statistical outlier removal."""
    buf = PointBuffer(xyz=xyz, rgba=rgba, count=count)
    down = voxelize.downsample(buf, cellsize)
    # grid exactness precondition (ops/outliers.py header): a 3c cell of a
    # c-downsampled cloud holds <= 27 voxel points, within cell_cap=32;
    # 4c cells can hold 64 and would silently truncate candidate sets
    cell = jnp.asarray(cellsize, jnp.float32) * 3.0
    clean = outliers.remove_outliers(
        down, k, mult, method="grid", cell=cell, cell_cap=cell_cap
    )
    return clean


def make_fusion_step(mesh: Mesh, k: int = 12, cell_cap: int = 32):
    """Build the jitted multi-camera fusion step for the given mesh.

    Takes per-camera arrays with a leading camera axis sharded over the
    mesh: xyz [D, cap, 3], rgba [D, cap], counts [D]; returns a fused,
    replicated PointBuffer of capacity D*cap.
    """

    def per_device(xyz, rgba, count, cellsize, mult):
        # local shapes: [1, cap, 3], [1, cap], [1]
        clean = _local_clean(
            xyz[0], rgba[0], count[0], cellsize, k, mult, cell_cap
        )
        # Fuse across cameras: gather every camera's cleaned cloud.  The
        # gathered sizes are the (small) post-cleaning capacities, not the
        # raw input clouds.
        g_xyz = jax.lax.all_gather(clean.xyz, CAMERA_AXIS)  # [D, cap, 3]
        g_rgba = jax.lax.all_gather(clean.rgba, CAMERA_AXIS)  # [D, cap]
        g_count = jax.lax.all_gather(clean.count, CAMERA_AXIS)  # [D]

        d, cap = g_rgba.shape
        flat_xyz = g_xyz.reshape(d * cap, 3)
        flat_rgba = g_rgba.reshape(d * cap)
        slot = jax.lax.broadcasted_iota(jnp.int32, (d, cap), 1)
        mask = (slot < g_count[:, None]).reshape(d * cap)

        # Pack valid points to the front, then dedup-voxelize the union so
        # overlapping camera views merge (tile OR = camera-contribution
        # mask, as in the reference's downsample-after-join).
        merged = compaction.compact(
            PointBuffer(
                xyz=flat_xyz,
                rgba=flat_rgba,
                count=jnp.asarray(d * cap, jnp.int32),
            ),
            mask,
        )
        fused = voxelize.downsample(merged, cellsize)
        return fused.xyz, fused.rgba, fused.count

    sharded = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(CAMERA_AXIS), P(CAMERA_AXIS), P(CAMERA_AXIS), P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )

    @jax.jit
    def step(xyz, rgba, counts, cellsize, mult):
        fx, frgba, fcount = sharded(xyz, rgba, counts, cellsize, mult)
        return PointBuffer(xyz=fx, rgba=frgba, count=fcount)

    return step
