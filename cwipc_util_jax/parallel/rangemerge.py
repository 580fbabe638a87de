"""Range-partitioned sharded chain: the merge scales with the mesh.

The first sharded chain (parallel/pointaxis.py `make_sharded_chain`)
all_gathers every shard's partial voxels and re-reduces the WHOLE union on
every device — a replicated O(total) merge that becomes the Amdahl term as
the mesh grows (BASELINE.md's scaling table: the merge dominates at 8
chips).  This module replaces that with a distributed sample sort, the
classic multi-node sort recipe mapped onto the mesh collectives:

1. every shard voxel-downsamples LOCALLY on a collectively-agreed grid
   origin (``lax.pmin`` of the quantized minima), so all shards' Morton
   keys live in one key space and each shard's output is globally ordered;
2. a tiny key sample per shard rides one ``all_gather``; its quantiles are
   the D-1 range splitters — identical on every device, balanced by
   construction (sample sort);
3. each shard's (already sorted) centroids fall into D CONTIGUOUS key
   segments, located with D-1 scalar searchsorteds and sliced — no
   scatter, no gather; the [D, B] blocks ride ONE ``all_to_all``;
4. every device merge-reduces ONLY ITS RANGE (a sort of O(total/D) rows),
   runs the window-kNN outlier stage on its range with W-point halo
   exchange over ``ppermute`` (seam candidates match the single-device
   window exactly), psums the mean-distance moments so the PCL keep
   threshold uses GLOBAL statistics, tile-filters and compacts locally;
5. the per-range outputs (already globally Morton-ordered end to end)
   ride one final ``all_gather`` and a small gap compaction replicates the
   result.

Every post-downsample array is O(total/D) instead of O(total); the only
replicated work is the final gather+compact over the OUTPUT (which also
shrinks as ranges drop outliers).  Collective traffic: the sample
(D*64*4 B), the centroid blocks (real payload only, ~16 B/centroid), two
W-row halos and a 3-scalar psum.

Static-shape safety: per-(source, target) blocks are a fixed B rows; a
pathological split that overflows B is DETECTED (flags bit 0) never
silent, as is a range thinner than the kNN window (flags bit 1, seam
candidates then under-filled exactly like a cloud edge).  Reference
semantics: PCL global-statistics outlier threshold preserved exactly
(reference: src/cwipc_filters.cpp:181-278); the downsample voxel SET
matches ops/voxelize.py exactly, while centroids of voxels whose raw
points straddle INPUT-shard boundaries average the per-shard partials
unweighted (deviation bounded by the voxel cell — see the routing note in
the chain body).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core.buffers import PointBuffer
from ..ops import compaction, outliers, voxelize
from ..ops.chain import window_mean_distance_cm
from ..ops.voxelize import _CLAMP, _MORTON_MAX, _SENTINEL, morton3
from .fusion import CAMERA_AXIS, shard_map

_SAMPLES = 64  # splitter sample rows per shard


def _morton_keys(x, y, z, valid, vmin_safe, cell):
    """Globally-consistent Morton keys for channel-major rows (the same
    quantization ops/voxelize.py applies, with an injected origin)."""
    inv = 1.0 / jnp.asarray(cell, jnp.float32)
    vx = jnp.clip(jnp.floor(x * inv).astype(jnp.int32), -_CLAMP, _CLAMP)
    vy = jnp.clip(jnp.floor(y * inv).astype(jnp.int32), -_CLAMP, _CLAMP)
    vz = jnp.clip(jnp.floor(z * inv).astype(jnp.int32), -_CLAMP, _CLAMP)
    mx = jnp.clip(vx - vmin_safe[0], 0, _MORTON_MAX)
    my = jnp.clip(vy - vmin_safe[1], 0, _MORTON_MAX)
    mz = jnp.clip(vz - vmin_safe[2], 0, _MORTON_MAX)
    key = morton3(mx, my, mz)
    return jnp.where(valid, key, _SENTINEL)


def _merge_downsample_cm(x, y, z, rgba, valid, vmin_safe, cell, ocap):
    """Voxel-reduce channel-major rows whose validity is a MASK (the
    received all_to_all blocks), not a prefix.  The sort moves sentinel
    keys to the tail, so post-sort validity is a prefix and the standard
    run reduction applies unchanged."""
    from ..ops.voxelize import _reduce_runs_xla_cm

    key = _morton_keys(x, y, z, valid, vmin_safe, cell)
    inv = 1.0 / jnp.asarray(cell, jnp.float32)
    vx = jnp.clip(jnp.floor(x * inv).astype(jnp.int32), -_CLAMP, _CLAMP)
    vy = jnp.clip(jnp.floor(y * inv).astype(jnp.int32), -_CLAMP, _CLAMP)
    vz = jnp.clip(jnp.floor(z * inv).astype(jnp.int32), -_CLAMP, _CLAMP)
    fx = jnp.clip(((x * inv - vx) * 1024.0).astype(jnp.int32), 0, 1023)
    fy = jnp.clip(((y * inv - vy) * 1024.0).astype(jnp.int32), 0, 1023)
    fz = jnp.clip(((z * inv - vz) * 1024.0).astype(jnp.int32), 0, 1023)
    fracs = (fx << 20) | (fy << 10) | fz
    payload = jax.lax.complex(
        jax.lax.bitcast_convert_type(fracs, jnp.float32),
        jax.lax.bitcast_convert_type(rgba.astype(jnp.int32), jnp.float32),
    )
    smk, spay = jax.lax.sort((key, payload), num_keys=1)
    sfr = jax.lax.bitcast_convert_type(jnp.real(spay), jnp.int32)
    srgba = jax.lax.bitcast_convert_type(jnp.imag(spay), jnp.int32)
    n_valid = valid.sum(dtype=jnp.int32)
    return _reduce_runs_xla_cm(
        smk, sfr, srgba, n_valid, vmin_safe, jnp.asarray(cell, jnp.float32),
        ocap=ocap,
    )


def make_sharded_chain_rangemerge(
    mesh: Mesh,
    k: int = 30,
    window: int = 16,
    down_cap: int | None = None,
    block: int | None = None,
):
    """Jitted range-partitioned sharded headline chain over the mesh.

    Callable as ``step(xyz, rgba, counts, cellsize, mult, tile)`` with
    per-shard arrays from :func:`..parallel.pointaxis.shard_pointbuffer`;
    returns ``(PointBuffer, flags)`` where the replicated result has
    capacity ``D * D * block`` and flags is an int32 bitmask: bit 0 = a
    per-target block overflowed (results dropped rows — rerun with a
    larger ``block``), bit 1 = a seam halo carried fewer rows than exist
    beyond it (a range thinner than ``window`` in the middle of the
    cloud), so seam kNN candidates were under-filled; bit 2 = the scene is
    wider than 1024 cells at this cell size, so clamped Morton keys merged
    distinct fringe voxels (use a larger cellsize, or the single-device
    path which switches to exact keys).

    ``down_cap`` bounds the assumed per-shard row count for the block-size
    default (default: the shard capacity); ``block`` is the
    per-(source, target) exchange block B (default: ``2 * down_cap / D`` —
    slack 2 over a perfectly balanced split of a full-capacity shard).
    """
    n_dev = len(mesh.devices.ravel())
    d = n_dev

    def per_device(xyz, rgba, count, cellsize, mult, tile):
        xyz, rgba, count = xyz[0], rgba[0], count[0]
        cap_s = xyz.shape[0]
        rcap = cap_s if down_cap is None else down_cap
        b = max(1, -(-2 * rcap // d)) if block is None else block
        cell = jnp.asarray(cellsize, jnp.float32)
        idx_s = jnp.arange(cap_s, dtype=jnp.int32)
        valid_in = idx_s < count

        # 1. collectively-agreed grid origin -> one global Morton key space
        inv = 1.0 / cell
        v = jnp.clip(jnp.floor(xyz * inv).astype(jnp.int32), -_CLAMP, _CLAMP)
        vmin_l = jnp.min(jnp.where(valid_in[:, None], v, _SENTINEL), axis=0)
        vmin = jax.lax.pmin(vmin_l, CAMERA_AXIS)
        vmin_safe = jnp.where(vmin == _SENTINEL, 0, vmin)

        # Local pre-reduce, then route the reduced rows.  NOTE a documented
        # approximation: a voxel whose RAW points are split across INPUT
        # shards contributes one partial centroid per shard, and the merge
        # averages those partials unweighted (mean of means, not the
        # count-weighted single-device centroid).  Only voxels straddling
        # input-shard boundaries are affected; the deviation is bounded by
        # the voxel cell.  Routing raw rows instead would be exact but
        # needs per-(source,target) blocks of the full shard size for
        # spatially-coherent shards (the realistic sharding), collapsing
        # the O(total/D) merge this module exists to provide.
        buf = PointBuffer(xyz=xyz, rgba=rgba, count=count)
        lx, ly, lz, lrgba, lcnt = voxelize.downsample_cm(buf, cell, rcap, vmin=vmin)
        lvalid = jnp.arange(rcap, dtype=jnp.int32) < lcnt
        lkey = _morton_keys(lx, ly, lz, lvalid, vmin_safe, cell)

        # 2. sample-sort splitters (identical on every device)
        pos = jnp.clip((jnp.arange(_SAMPLES, dtype=jnp.int32) * lcnt) // _SAMPLES, 0, rcap - 1)
        sample = jnp.where(lcnt > 0, lkey[pos], _SENTINEL)
        g_sample = jax.lax.all_gather(sample, CAMERA_AXIS).reshape(d * _SAMPLES)
        g_sample = jnp.sort(g_sample)
        splitters = g_sample[(jnp.arange(d - 1, dtype=jnp.int32) + 1) * _SAMPLES]

        # 3. contiguous per-target segments -> [D, B] blocks, one all_to_all
        s = jnp.searchsorted(lkey, splitters, side="left").astype(jnp.int32)
        starts = jnp.concatenate([jnp.zeros((1,), jnp.int32), s])
        ends = jnp.concatenate([s, lcnt[None]])
        seg_n = jnp.maximum(ends - starts, 0)
        send_ovf = jnp.any(seg_n > b)
        seg_n = jnp.minimum(seg_n, b)

        def seg_slices(a, fill):
            ap = jnp.concatenate([a, jnp.full((b,), fill, a.dtype)])
            return jnp.stack(
                [jax.lax.dynamic_slice(ap, (starts[t],), (b,)) for t in range(d)]
            )

        bx = jax.lax.all_to_all(seg_slices(lx, 0.0), CAMERA_AXIS, 0, 0, tiled=True)
        by = jax.lax.all_to_all(seg_slices(ly, 0.0), CAMERA_AXIS, 0, 0, tiled=True)
        bz = jax.lax.all_to_all(seg_slices(lz, 0.0), CAMERA_AXIS, 0, 0, tiled=True)
        brgba = jax.lax.all_to_all(
            seg_slices(lrgba.astype(jnp.int32), 0), CAMERA_AXIS, 0, 0, tiled=True
        )
        bcnt = jax.lax.all_to_all(seg_n, CAMERA_AXIS, 0, 0, tiled=True)

        # 4a. merge-reduce MY range only: O(total/D) rows
        mcap = d * b
        slot = jax.lax.broadcasted_iota(jnp.int32, (d, b), 1)
        bvalid = (slot < bcnt[:, None]).reshape(mcap)
        mx, my, mz, mrgba, mcnt = _merge_downsample_cm(
            bx.reshape(mcap), by.reshape(mcap), bz.reshape(mcap),
            brgba.reshape(mcap).astype(jnp.uint32), bvalid, vmin_safe, cell, mcap,
        )
        midx = jnp.arange(mcap, dtype=jnp.int32)
        mvalid = midx < mcnt

        # 4b. halo exchange: the last/first W rows of the neighbor ranges,
        # so seam windows see the same candidates as the single-device
        # Morton order.  ppermute zero-fills the mesh edges (count 0).
        w = window
        lv_src = jnp.minimum(mcnt, w)
        r_start = jnp.maximum(mcnt - w, 0)

        def right_edge(a):
            sl = jax.lax.dynamic_slice(a, (r_start,), (w,))
            return jnp.roll(sl, w - lv_src)  # right-align valid rows

        perm_r = [(i, i + 1) for i in range(d - 1)]  # my right edge -> right nbr
        perm_l = [(i + 1, i) for i in range(d - 1)]  # my left edge -> left nbr
        lh_x = jax.lax.ppermute(right_edge(mx), CAMERA_AXIS, perm_r)
        lh_y = jax.lax.ppermute(right_edge(my), CAMERA_AXIS, perm_r)
        lh_z = jax.lax.ppermute(right_edge(mz), CAMERA_AXIS, perm_r)
        lv = jax.lax.ppermute(lv_src, CAMERA_AXIS, perm_r)
        rh_x = jax.lax.ppermute(mx[:w], CAMERA_AXIS, perm_l)
        rh_y = jax.lax.ppermute(my[:w], CAMERA_AXIS, perm_l)
        rh_z = jax.lax.ppermute(mz[:w], CAMERA_AXIS, perm_l)
        rv = jax.lax.ppermute(lv_src, CAMERA_AXIS, perm_l)

        def haloed(a, left, right):
            h = jnp.concatenate([left, a, jnp.zeros((w,), a.dtype)])
            h = jax.lax.dynamic_update_slice(h, right, (w + mcnt,))
            # valid left-halo rows end at position w; shift so validity
            # is the prefix the kNN kernels expect
            return jnp.roll(h, lv - w)

        hx = haloed(mx, lh_x, rh_x)
        hy = haloed(my, lh_y, rh_y)
        hz = haloed(mz, lh_z, rh_z)
        hcnt = lv + mcnt + rv

        # Seam-deficiency flag: my halo is under-filled only if FEWER rows
        # arrived than exist beyond the seam (a thin-but-final or empty
        # neighbor loses nothing — the single-device window truncates at
        # the cloud edge the same way).  One scalar all_gather decides it.
        g_mcnt = jax.lax.all_gather(mcnt, CAMERA_AXIS)
        me = jax.lax.axis_index(CAMERA_AXIS)
        rng = jnp.arange(d, dtype=jnp.int32)
        left_total = jnp.where(rng < me, g_mcnt, 0).sum()
        right_total = jnp.where(rng > me, g_mcnt, 0).sum()
        thin = (mcnt > 0) & (
            (lv < jnp.minimum(window, left_total))
            | (rv < jnp.minimum(window, right_total))
        )

        md_h = window_mean_distance_cm(hx, hy, hz, hcnt, k=k, window=window)
        md = jax.lax.dynamic_slice(md_h, (lv,), (mcap,))

        # 4c. GLOBAL outlier statistics: psum the moments over the mesh
        mdv = jnp.where(mvalid, md, 0.0)
        n_g, s_g, sq_g = jax.lax.psum(
            jnp.stack([mvalid.sum(dtype=jnp.float32), mdv.sum(), (mdv * mdv).sum()]),
            CAMERA_AXIS,
        )
        keep = outliers._keep_from_moments(md, mvalid, mult, n_g, s_g, sq_g)
        point_tile = (mrgba >> 24) & 0xFF
        tile_u = jnp.asarray(tile, jnp.uint32)
        keep = keep & ((tile_u == 0) | (point_tile == tile_u))
        out = compaction.compact_cm(mx, my, mz, mrgba, keep, mcnt)

        # 5. gather the (globally ordered) per-range outputs + gap compact
        g_xyz = jax.lax.all_gather(out.xyz, CAMERA_AXIS).reshape(d * mcap, 3)
        g_rgba = jax.lax.all_gather(out.rgba, CAMERA_AXIS).reshape(d * mcap)
        g_cnt = jax.lax.all_gather(out.count, CAMERA_AXIS)
        gslot = jax.lax.broadcasted_iota(jnp.int32, (d, mcap), 1)
        gmask = (gslot < g_cnt[:, None]).reshape(d * mcap)
        final = compaction.compact(
            PointBuffer(
                xyz=g_xyz, rgba=g_rgba, count=jnp.asarray(d * mcap, jnp.int32)
            ),
            gmask,
        )
        # bit 2: the scene exceeds the 10-bit Morton domain at this cell
        # size — clamped keys would silently merge distinct fringe voxels
        # (the single-device wrapper switches to exact keys in this case,
        # ops/__init__.py; the sharded chain reports it instead)
        ext_ovf = jnp.any(((v - vmin_safe[None, :]) > _MORTON_MAX) & valid_in[:, None])
        any_ovf, any_thin, any_ext = jax.lax.psum(
            jnp.stack([send_ovf.astype(jnp.int32), thin.astype(jnp.int32),
                       ext_ovf.astype(jnp.int32)]),
            CAMERA_AXIS,
        )
        flags = (
            (any_ovf > 0) + 2 * (any_thin > 0) + 4 * (any_ext > 0)
        ).astype(jnp.int32)
        return final.xyz, final.rgba, final.count, flags

    sharded = shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(CAMERA_AXIS), P(CAMERA_AXIS), P(CAMERA_AXIS), P(), P(), P()),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )

    @jax.jit
    def step(xyz, rgba, counts, cellsize, mult, tile):
        fx, frgba, fcount, flags = sharded(xyz, rgba, counts, cellsize, mult, tile)
        return PointBuffer(xyz=fx, rgba=frgba, count=fcount), flags

    return step


def sharded_chain_rangemerge(
    mesh: Mesh, buf: PointBuffer, cellsize: float, k: int = 30,
    mult: float = 1.0, tile: int = 0, window: int = 16,
    down_cap: int | None = None, block: int | None = None,
):
    """Convenience one-shot range-merge sharded chain -> (buffer, flags)."""
    from .mesh import camera_sharding
    from .pointaxis import shard_pointbuffer

    n = len(mesh.devices.ravel())
    xyz, rgba, counts = shard_pointbuffer(buf, n)
    sh = camera_sharding(mesh)
    step = make_sharded_chain_rangemerge(
        mesh, k=k, window=window, down_cap=down_cap, block=block
    )
    return step(
        jax.device_put(xyz, sh),
        jax.device_put(rgba, sh),
        jax.device_put(counts, sh),
        jnp.float32(cellsize),
        jnp.float32(mult),
        jnp.uint32(tile),
    )
