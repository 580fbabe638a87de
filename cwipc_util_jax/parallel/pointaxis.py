"""Point-axis sharding: one huge cloud split across devices.

The reference's "long axis" is point count (SURVEY.md §5.7): its octree
split chunks a big cloud into independently-reducible blocks.  The device
equivalent shards the point dimension over the mesh: each device voxel-
reduces its shard locally, the (much smaller) per-device voxel sets are
exchanged with ``all_gather``, and a final dedup-voxelize merges voxels that
straddled shard boundaries.  The result is replicated.

This reuses the camera-fusion machinery (parallel/fusion.py) — a shard of
one cloud and a camera's cloud are the same thing to the kernels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from ..core.buffers import PointBuffer
from .fusion import make_fusion_step
from .mesh import camera_sharding


def check_morton_extent(buf: PointBuffer, cellsize: float) -> None:
    """Reject scenes wider than the 10-bit Morton domain (1024 cells) at
    this cell size: the sharded paths quantize with clamped keys, which
    would silently merge distinct fringe voxels (the single-device wrapper
    switches to exact keys instead, ops/__init__.py)."""
    from ..core.errors import CwipcError
    from ..ops.voxelize import _MORTON_MAX

    n = int(buf.count)
    if n == 0:
        return
    xyz = np.asarray(buf.xyz)[:n]
    cells = np.floor(xyz / float(cellsize))
    extent = cells.max(axis=0) - cells.min(axis=0)
    if (extent > _MORTON_MAX).any():
        raise CwipcError(
            f"sharded chain: scene spans {int(extent.max())} cells at cellsize"
            f" {cellsize} (max {_MORTON_MAX}); use a larger cellsize or the"
            " single-device path"
        )


def shard_pointbuffer(buf: PointBuffer, n_devices: int):
    """Split a PointBuffer into n_devices equal shards along the point axis.

    Returns host arrays (xyz [D, cap/D, 3], rgba [D, cap/D], counts [D])
    ready for device_put with a camera/point sharding.
    """
    cap = buf.capacity
    assert cap % n_devices == 0, "capacity must divide evenly over devices"
    shard = cap // n_devices
    xyz = np.asarray(buf.xyz).reshape(n_devices, shard, 3)
    rgba = np.asarray(buf.rgba).reshape(n_devices, shard)
    total = int(buf.count)
    starts = np.arange(n_devices) * shard
    counts = np.clip(total - starts, 0, shard).astype(np.int32)
    return xyz, rgba, counts


def make_sharded_downsample(mesh: Mesh, k: int = 8, cell_cap: int = 32):
    """Jitted sharded downsample(+clean) over the mesh's devices.

    Callable as step(xyz, rgba, counts, cellsize, mult) with per-shard
    arrays from :func:`shard_pointbuffer`; returns a replicated fused
    PointBuffer.  The per-shard pipeline includes the outlier stage — pass
    mult=inf to make it a pure downsample.
    """
    return make_fusion_step(mesh, k=k, cell_cap=cell_cap)


def sharded_downsample(
    mesh: Mesh, buf: PointBuffer, cellsize: float, mult: float = float("inf")
) -> PointBuffer:
    """Convenience one-shot: shard, downsample across the mesh, fuse."""
    check_morton_extent(buf, float(cellsize))
    n = len(mesh.devices.ravel())
    xyz, rgba, counts = shard_pointbuffer(buf, n)
    sh = camera_sharding(mesh)
    step = make_sharded_downsample(mesh)
    return step(
        jax.device_put(xyz, sh),
        jax.device_put(rgba, sh),
        jax.device_put(counts, sh),
        jnp.float32(cellsize),
        jnp.float32(mult),
    )


def make_sharded_chain(mesh: Mesh, k: int = 30, window: int = 16):
    """The HEADLINE chain (downsample -> outlier removal -> tilefilter)
    sharded along the point axis over the mesh.

    Per shard: a local voxel downsample shrinks the shard ~5x; the (small)
    partial-voxel sets are exchanged with ``all_gather``; a global
    dedup-voxelize merges voxels that straddled shard boundaries; the
    outlier keep-mask (Morton-window kNN) and tile selection then run on
    the fused cloud exactly as in the single-chip chain (ops/chain.py).
    The expensive 1M-point sort+reduce shards N/D per device, which is
    where the linear multi-chip scaling comes from.  Result is replicated.
    """
    from jax.sharding import PartitionSpec as P

    from ..ops import compaction, voxelize
    from ..ops.chain import chain_tail_cm
    from .fusion import CAMERA_AXIS, shard_map

    def per_device(xyz, rgba, count, cellsize, mult, tile):
        buf = PointBuffer(xyz=xyz[0], rgba=rgba[0], count=count[0])
        down = voxelize.downsample(buf, cellsize)

        g_xyz = jax.lax.all_gather(down.xyz, CAMERA_AXIS)  # [D, cap, 3]
        g_rgba = jax.lax.all_gather(down.rgba, CAMERA_AXIS)
        g_count = jax.lax.all_gather(down.count, CAMERA_AXIS)
        d, cap = g_rgba.shape
        slot = jax.lax.broadcasted_iota(jnp.int32, (d, cap), 1)
        mask = (slot < g_count[:, None]).reshape(d * cap)
        merged = compaction.compact(
            PointBuffer(
                xyz=g_xyz.reshape(d * cap, 3),
                rgba=g_rgba.reshape(d * cap),
                count=jnp.asarray(d * cap, jnp.int32),
            ),
            mask,
        )
        x, y, z, prgba, cnt = voxelize.downsample_cm(merged, cellsize, d * cap)
        # identical post-downsample tail as the single-chip chain
        out = chain_tail_cm(
            x, y, z, prgba, cnt, k=k, window=window, mult=mult, tile=tile
        )
        return out.xyz, out.rgba, out.count

    sharded = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(CAMERA_AXIS), P(CAMERA_AXIS), P(CAMERA_AXIS), P(), P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )

    @jax.jit
    def step(xyz, rgba, counts, cellsize, mult, tile):
        fx, frgba, fcount = sharded(xyz, rgba, counts, cellsize, mult, tile)
        return PointBuffer(xyz=fx, rgba=frgba, count=fcount)

    return step


def sharded_chain(
    mesh: Mesh, buf: PointBuffer, cellsize: float, k: int = 30,
    mult: float = 1.0, tile: int = 0, window: int = 16,
) -> PointBuffer:
    """Convenience one-shot sharded headline chain."""
    check_morton_extent(buf, float(cellsize))
    n = len(mesh.devices.ravel())
    xyz, rgba, counts = shard_pointbuffer(buf, n)
    sh = camera_sharding(mesh)
    step = make_sharded_chain(mesh, k=k, window=window)
    return step(
        jax.device_put(xyz, sh),
        jax.device_put(rgba, sh),
        jax.device_put(counts, sh),
        jnp.float32(cellsize),
        jnp.float32(mult),
        jnp.uint32(tile),
    )


def make_sharded_chain_exact(
    mesh: Mesh, k: int, gy: int, gz: int, cap: int, chunk: int = 256,
):
    """The EXACT chain (downsample -> column-grid exact outlier removal ->
    tilefilter) sharded over the mesh.

    The exact outlier stage's cost is the per-chunk candidate selection
    (ops/cols_knn.py phase 2, ~95% of the exact chain); the column-grid
    PLANE chunks shard perfectly — every device builds the (small,
    replicated) slot grid, selects only its own slab of plane chunks, and
    an ``all_gather`` reassembles the per-slot results.  The
    downsample shards along the point axis as in make_sharded_chain.
    Exactness is untouched: the per-chunk computation is independent by
    construction.
    """
    from jax.sharding import PartitionSpec as P

    from ..ops import compaction, outliers, voxelize
    from ..ops.cols_knn import (
        _cols_build,
        _cols_finish,
        _cols_select,
        bruteforce_md_subset,
    )
    from .fusion import CAMERA_AXIS, shard_map

    n_dev = len(mesh.devices.ravel())
    gyz = gy * gz
    nchunks = -(-gyz // chunk)
    per_dev = -(-nchunks // n_dev)

    def per_device(xyz, rgba, count, cellsize, mult, tile):
        buf = PointBuffer(xyz=xyz[0], rgba=rgba[0], count=count[0])
        down = voxelize.downsample(buf, cellsize)

        g_xyz = jax.lax.all_gather(down.xyz, CAMERA_AXIS)  # [D, cap, 3]
        g_rgba = jax.lax.all_gather(down.rgba, CAMERA_AXIS)
        g_count = jax.lax.all_gather(down.count, CAMERA_AXIS)
        d, cap_in = g_rgba.shape
        slot = jax.lax.broadcasted_iota(jnp.int32, (d, cap_in), 1)
        mask = (slot < g_count[:, None]).reshape(d * cap_in)
        merged = compaction.compact(
            PointBuffer(
                xyz=g_xyz.reshape(d * cap_in, 3),
                rgba=g_rgba.reshape(d * cap_in),
                count=jnp.asarray(d * cap_in, jnp.int32),
            ),
            mask,
        )
        x, y, z, prgba, cnt = voxelize.downsample_cm(merged, cellsize, d * cap_in)
        pxyz = jnp.stack([x, y, z], axis=-1)

        # exact outlier stage, plane chunks sharded across the mesh
        xs_g, ys_g, zs_g, valid0, drop_ring, point_slot = _cols_build(
            pxyz, cnt, cellsize, gy=gy, gz=gz, cap=cap, chunk=chunk,
        )
        me = jax.lax.axis_index(CAMERA_AXIS)

        # chunks beyond nchunks read harmlessly into the plane's tail
        # padding (all-invalid slots); their results are sliced off
        c0s = (me * per_dev + jnp.arange(per_dev, dtype=jnp.int32)) * chunk
        sums_l, kths_l = _cols_select(
            xs_g, ys_g, zs_g, c0s, k=k, gy=gy, gz=gz, cap=cap, chunk=chunk,
            voxel_unique=True,
        )
        sums = jax.lax.all_gather(sums_l, CAMERA_AXIS).reshape(
            n_dev * per_dev * chunk, cap
        )[:gyz]
        kths = jax.lax.all_gather(kths_l, CAMERA_AXIS).reshape(
            n_dev * per_dev * chunk, cap
        )[:gyz]
        md, unc = _cols_finish(
            sums, kths, point_slot, valid0, drop_ring, cellsize, k=k, gy=gy,
            gz=gz, cap=cap,
        )
        md = jnp.where(unc, bruteforce_md_subset(pxyz, cnt, unc, k), md)

        keep = outliers._keep_from_mean_dists(md, valid0, mult)
        point_tile = (prgba >> 24) & 0xFF
        tile_u = jnp.asarray(tile, jnp.uint32)
        keep = keep & ((tile_u == 0) | (point_tile == tile_u))
        out = compaction.compact_cm(x, y, z, prgba, keep, cnt)
        return out.xyz, out.rgba, out.count

    sharded = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(CAMERA_AXIS), P(CAMERA_AXIS), P(CAMERA_AXIS), P(), P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )

    @jax.jit
    def step(xyz, rgba, counts, cellsize, mult, tile):
        fx, frgba, fcount = sharded(xyz, rgba, counts, cellsize, mult, tile)
        return PointBuffer(xyz=fx, rgba=frgba, count=fcount)

    return step


def sharded_chain_exact(
    mesh: Mesh, buf: PointBuffer, cellsize: float, k: int, gy: int, gz: int,
    cap: int, mult: float = 1.0, tile: int = 0, chunk: int = 256,
) -> PointBuffer:
    """Convenience one-shot sharded EXACT chain."""
    check_morton_extent(buf, float(cellsize))
    n = len(mesh.devices.ravel())
    xyz, rgba, counts = shard_pointbuffer(buf, n)
    sh = camera_sharding(mesh)
    step = make_sharded_chain_exact(
        mesh, k=k, gy=gy, gz=gz, cap=cap, chunk=chunk,
    )
    return step(
        jax.device_put(xyz, sh),
        jax.device_put(rgba, sh),
        jax.device_put(counts, sh),
        jnp.float32(cellsize),
        jnp.float32(mult),
        jnp.uint32(tile),
    )
