"""Multi-device sharding tests on the 8-way virtual CPU mesh."""

import jax
import numpy as np
import pytest

import cwipc_util_jax as cwipc
from cwipc_util_jax.parallel.mesh import cpu_devices, make_mesh
from cwipc_util_jax.parallel.pointaxis import sharded_downsample


@pytest.fixture(scope="module")
def mesh():
    # Explicit CPU device objects: the virtual 8-device mesh is pinned by
    # device object, never by default platform.
    cpus = cpu_devices(2)
    if not cpus:
        pytest.skip("needs multiple (virtual) CPU devices")
    return make_mesh(devices=cpus)


class TestPointAxisSharding:
    def test_sharded_downsample_matches_single_device(self, mesh):
        gen = cwipc.cwipc_synthetic(0, 4000)
        gen.start()
        pc = gen.get()
        gen.stop()
        cellsize = 0.05

        expected = cwipc.cwipc_downsample(pc, cellsize)
        fused = sharded_downsample(mesh, pc._access_buffer(), cellsize)
        n = int(fused.count)
        assert n == expected.count()

        # same voxel set (order differs)
        inv = np.float32(1.0) / np.float32(cellsize)
        got_xyz = np.asarray(fused.xyz[:n])
        exp = expected.get_numpy_matrix(onlyGeometry=True)
        got_keys = {tuple(k) for k in np.floor(got_xyz * inv).astype(np.int64)}
        exp_keys = {tuple(k) for k in np.floor(exp.astype(np.float32) * inv).astype(np.int64)}
        assert got_keys == exp_keys

    def test_camera_fusion_dryrun(self, mesh):
        """The full multi-camera fusion step (the dryrun_multichip path)."""
        import __graft_entry__ as graft

        graft.dryrun_multichip(mesh.devices.size)


class TestCameraFusionSemantics:
    def test_overlapping_cameras_merge_with_or_tiles(self, mesh):
        """Points seen by several cameras must fuse into single points whose
        tile byte ORs the camera masks (the reference's join+downsample
        fusion semantics, cwipc_filters.cpp:89-172 tile OR)."""
        import jax.numpy as jnp

        from cwipc_util_jax.parallel.fusion import make_fusion_step
        from cwipc_util_jax.parallel.mesh import camera_sharding

        d = mesh.devices.size
        cap = 2048
        n = 500
        rng = np.random.default_rng(0)
        pts = (rng.random((n, 3)) * 0.5).astype(np.float32)
        xyz = np.zeros((d, cap, 3), np.float32)
        rgba = np.zeros((d, cap), np.uint32)
        counts = np.zeros((d,), np.int32)
        for cam in range(d):
            xyz[cam, :n] = pts  # every camera sees the same points
            tile = np.uint32(1 << (cam % 8))
            rgba[cam, :n] = (tile << 24) | 0x00808080
            counts[cam] = n
        step = make_fusion_step(mesh, k=4)
        sh = camera_sharding(mesh)
        fused = step(
            jax.device_put(xyz, sh), jax.device_put(rgba, sh),
            jax.device_put(counts, sh), 0.01, 3.0,
        )
        m = int(fused.count)
        assert 0 < m <= n  # merged, never duplicated
        tiles = (np.asarray(fused.rgba[:m]) >> 24) & 0xFF
        want = 0
        for cam in range(d):
            want |= 1 << (cam % 8)
        assert (tiles == want).all(), f"tiles {np.unique(tiles)} != {want:#x}"


class TestShardedChain:
    def test_sharded_chain_matches_single_device(self, mesh):
        """The point-axis-sharded headline chain must produce the same voxel
        set and survivor statistics as the single-device fused chain."""
        import jax.numpy as jnp

        from cwipc_util_jax.ops.chain import downsample_outliers_tilefilter
        from cwipc_util_jax.parallel.pointaxis import sharded_chain

        gen = cwipc.cwipc_synthetic(0, 4000)
        gen.start()
        pc = gen.get()
        gen.stop()
        cellsize = 0.05
        buf = pc._access_buffer()

        expected = downsample_outliers_tilefilter(
            buf, jnp.float32(cellsize), k=8, mult=jnp.float32(2.0),
            tile=jnp.uint32(1),
        )
        got = sharded_chain(mesh, buf, cellsize, k=8, mult=2.0, tile=1)

        n_exp, n_got = int(expected.count), int(got.count)
        inv = np.float32(1.0) / np.float32(cellsize)
        exp_keys = {
            tuple(kk)
            for kk in np.floor(np.asarray(expected.xyz[:n_exp]) * inv).astype(np.int64)
        }
        got_keys = {
            tuple(kk)
            for kk in np.floor(np.asarray(got.xyz[:n_got]) * inv).astype(np.int64)
        }
        # voxel sets match up to shard-straddle centroid averaging: require
        # a near-complete overlap and matching scale
        assert abs(n_exp - n_got) <= max(2, n_exp // 50)
        overlap = len(exp_keys & got_keys) / max(1, len(exp_keys))
        assert overlap > 0.95, f"only {overlap:.2%} voxel overlap"
        # tile selection applied: every survivor carries tile 1
        tiles = (np.asarray(got.rgba[:n_got]) >> 24) & 0xFF
        assert (tiles == 1).all()


class TestShardedChainRangeMerge:
    def test_rangemerge_chain_matches_single_device(self, mesh):
        """The range-partitioned sharded chain (sample-sort splitters +
        all_to_all + per-range merge with halo'd window kNN and psum'd
        outlier statistics) must reproduce the single-device chain's voxel
        set, with clean flags."""
        import jax.numpy as jnp

        from cwipc_util_jax.ops.chain import downsample_outliers_tilefilter
        from cwipc_util_jax.parallel.rangemerge import sharded_chain_rangemerge

        gen = cwipc.cwipc_synthetic(0, 4000)
        gen.start()
        pc = gen.get()
        gen.stop()
        cellsize = 0.05
        buf = pc._access_buffer()

        expected = downsample_outliers_tilefilter(
            buf, jnp.float32(cellsize), k=8, mult=jnp.float32(2.0),
            tile=jnp.uint32(1),
        )
        got, flags = sharded_chain_rangemerge(
            mesh, buf, cellsize, k=8, mult=2.0, tile=1
        )
        assert int(flags) == 0, f"flags {int(flags)}"

        n_exp, n_got = int(expected.count), int(got.count)
        inv = np.float32(1.0) / np.float32(cellsize)
        exp_keys = {
            tuple(kk)
            for kk in np.floor(np.asarray(expected.xyz[:n_exp]) * inv).astype(np.int64)
        }
        got_keys = {
            tuple(kk)
            for kk in np.floor(np.asarray(got.xyz[:n_got]) * inv).astype(np.int64)
        }
        # the merge averages centroids-of-centroids for voxels fed by
        # several shards, so near-threshold keep decisions can flip at fp
        # scale (same tolerance as the all_gather sharded chain)
        assert abs(n_exp - n_got) <= max(2, n_exp // 50)
        overlap = len(exp_keys & got_keys) / max(1, len(exp_keys))
        assert overlap > 0.95, f"only {overlap:.2%} voxel overlap"
        tiles = (np.asarray(got.rgba[:n_got]) >> 24) & 0xFF
        assert (tiles == 1).all()

    def test_rangemerge_output_is_morton_ordered(self, mesh):
        """Range concatenation must preserve the single-device output
        contract: global Morton order end to end."""
        from cwipc_util_jax.ops.voxelize import morton3
        from cwipc_util_jax.parallel.rangemerge import sharded_chain_rangemerge

        gen = cwipc.cwipc_synthetic(0, 4000)
        gen.start()
        pc = gen.get()
        gen.stop()
        cellsize = 0.05
        got, flags = sharded_chain_rangemerge(
            mesh, pc._access_buffer(), cellsize, k=8, mult=2.0, tile=0
        )
        assert int(flags) == 0
        n = int(got.count)
        v = np.floor(np.asarray(got.xyz[:n]) / np.float32(cellsize)).astype(np.int64)
        v -= v.min(axis=0)
        assert v.max() < 1024  # within the Morton domain
        keys = np.asarray(
            morton3(*(np.ascontiguousarray(v[:, i]).astype(np.int32) for i in range(3)))
        )
        assert (np.diff(keys) >= 0).all(), "output not Morton-ordered"

    def test_rangemerge_block_overflow_is_flagged(self, mesh):
        """A per-target block too small for the split must raise flag bit 0,
        never silently drop rows."""
        from cwipc_util_jax.parallel.rangemerge import sharded_chain_rangemerge

        gen = cwipc.cwipc_synthetic(0, 4000)
        gen.start()
        pc = gen.get()
        gen.stop()
        _, flags = sharded_chain_rangemerge(
            mesh, pc._access_buffer(), 0.05, k=8, mult=2.0, tile=0, block=2
        )
        assert int(flags) & 1

    def test_rangemerge_degenerate_single_voxel(self, mesh):
        """All input points in ONE voxel: the sample-sort splitters are all
        equal (every sampled key identical), so every row routes to a
        single range — the split must stay within the block bound and the
        merge must emit exactly one centroid, clean flags."""
        import jax.numpy as jnp

        from cwipc_util_jax.core.buffers import PointBuffer
        from cwipc_util_jax.parallel.rangemerge import sharded_chain_rangemerge

        cap = 1024
        rng = np.random.default_rng(7)
        xyz = (0.5 + rng.uniform(0, 0.01, size=(cap, 3))).astype(np.float32)
        buf = PointBuffer(
            xyz=jax.numpy.asarray(xyz),
            rgba=jnp.full((cap,), (1 << 24) | 0x808080, jnp.uint32),
            count=jnp.asarray(cap, jnp.int32),
        )
        got, flags = sharded_chain_rangemerge(
            mesh, buf, 0.05, k=8, mult=2.0, tile=0
        )
        assert int(flags) == 0, f"flags {int(flags)}"
        assert int(got.count) == 1
        c = np.asarray(got.xyz[0])
        assert np.allclose(c, xyz.mean(axis=0), atol=1e-3)

    def test_rangemerge_empty_and_partial_shards(self, mesh):
        """A count that covers only the first shard (the rest all padding)
        and the fully-empty cloud must both run clean: no flags, parity
        with the single-device chain / zero output respectively."""
        import jax.numpy as jnp

        from cwipc_util_jax.core.buffers import PointBuffer
        from cwipc_util_jax.ops.chain import downsample_outliers_tilefilter
        from cwipc_util_jax.parallel.rangemerge import sharded_chain_rangemerge

        gen = cwipc.cwipc_synthetic(0, 4000)
        gen.start()
        pc = gen.get()
        gen.stop()
        full = pc._access_buffer()
        d = len(mesh.devices.ravel())
        small_n = full.capacity // d // 2  # strictly inside shard 0
        buf = PointBuffer(
            xyz=full.xyz, rgba=full.rgba, count=jnp.asarray(small_n, jnp.int32)
        )
        expected = downsample_outliers_tilefilter(
            buf, jnp.float32(0.05), k=8, mult=jnp.float32(2.0), tile=jnp.uint32(0)
        )
        got, flags = sharded_chain_rangemerge(mesh, buf, 0.05, k=8, mult=2.0, tile=0)
        assert int(flags) == 0, f"flags {int(flags)}"
        assert abs(int(expected.count) - int(got.count)) <= 2

        empty = PointBuffer(
            xyz=full.xyz, rgba=full.rgba, count=jnp.asarray(0, jnp.int32)
        )
        got0, flags0 = sharded_chain_rangemerge(mesh, empty, 0.05, k=8, mult=2.0, tile=0)
        assert int(flags0) == 0
        assert int(got0.count) == 0


class TestShardedChainExact:
    def test_sharded_exact_chain_matches_single_device(self, mesh):
        """The plane-chunk-sharded EXACT chain must reproduce the
        single-device exact chain's survivor set identically (the
        per-chunk selection is independent by construction, so sharding
        it cannot change results)."""
        import jax.numpy as jnp

        from cwipc_util_jax.ops.chain import downsample_outliers_tilefilter_exact
        from cwipc_util_jax.parallel.pointaxis import sharded_chain_exact

        gen = cwipc.cwipc_synthetic(0, 4000)
        gen.start()
        pc = gen.get()
        gen.stop()
        cellsize = 0.05
        buf = pc._access_buffer()
        gy, gz, cap = 64, 64, 32

        expected, _resid = downsample_outliers_tilefilter_exact(
            buf, jnp.float32(cellsize), k=8, mult=jnp.float32(2.0),
            tile=jnp.uint32(1), out_capacity=buf.capacity,
            gy=gy, gz=gz, cap=cap,
        )
        got = sharded_chain_exact(
            mesh, buf, cellsize, k=8, gy=gy, gz=gz, cap=cap, mult=2.0, tile=1
        )
        n_exp, n_got = int(expected.count), int(got.count)
        assert n_exp == n_got, (n_exp, n_got)
        # the sharded downsample merges per-shard partial voxels
        # (centroid-of-centroids), so coordinates differ at fp scale;
        # the survivor VOXEL SET must match exactly (same comparison as
        # the approximate sharded-chain parity test)
        inv = np.float32(1.0) / np.float32(cellsize)
        a = {
            tuple(kk)
            for kk in np.floor(np.asarray(expected.xyz[:n_exp]) * inv).astype(np.int64)
        }
        b = {
            tuple(kk)
            for kk in np.floor(np.asarray(got.xyz[:n_got]) * inv).astype(np.int64)
        }
        assert a == b, f"{len(a ^ b)} mismatched voxels"


class TestMortonExtentGuard:
    def test_wide_scene_rejected(self):
        """Scenes wider than 1024 cells at the given cellsize must be
        rejected by the sharded convenience wrappers (clamped keys would
        silently merge fringe voxels; the single-device wrapper switches
        to exact keys instead)."""
        import numpy as np

        import cwipc_util_jax as cwipc
        from cwipc_util_jax.parallel.pointaxis import check_morton_extent

        pts = [(0.0, 0.0, 0.0, 0, 0, 0, 0), (30.0, 0.0, 0.0, 0, 0, 0, 0)]
        pc = cwipc.cwipc_from_points(pts, 0)
        buf = pc._access_buffer()
        with pytest.raises(cwipc.CwipcError):
            check_morton_extent(buf, 0.01)  # 3000 cells wide
        check_morton_extent(buf, 0.1)  # 300 cells: fine


class TestShardedRegistration:
    """Per-camera registration on the camera axis (VERDICT r4 #4;
    reference per-camera loop: registration/multicamera.py:632-741):
    the sharded NN sweep and fused fine-alignment run must match the
    single-device programs per camera."""

    def test_sharded_camera_nn_and_align_match_single_device(self, mesh):
        from cwipc_util_jax.ops.knn import nn_search
        from cwipc_util_jax.parallel.registration import (
            pack_camera_views,
            sharded_camera_align,
            sharded_camera_nn,
        )
        from cwipc_util_jax.registration.fine import _icp_fused

        import jax.numpy as jnp

        D = mesh.devices.size
        rng = np.random.default_rng(3)
        base = rng.normal(size=(400, 3)).astype(np.float32)
        base /= np.linalg.norm(base, axis=1, keepdims=True)
        cams = []
        for d in range(D):
            view = base[d % 2 :: 2]
            cams.append(view + 0.003 * rng.standard_normal(3).astype(np.float32))
        s_xyz, s_cnt, r_xyz, r_cnt = pack_camera_views(cams)
        corr = 0.05

        dist_sh, idx_sh = jax.device_get(sharded_camera_nn(
            mesh, jnp.asarray(s_xyz), jnp.asarray(s_cnt),
            jnp.asarray(r_xyz), jnp.asarray(r_cnt), corr,
        ))
        poses_sh = np.asarray(sharded_camera_align(
            mesh, jnp.asarray(s_xyz), jnp.asarray(s_cnt),
            jnp.asarray(r_xyz), jnp.asarray(r_cnt), corr, max_iters=6,
        ))
        assert poses_sh.shape == (D, 4, 4)
        for d in range(D):
            d1, i1 = jax.device_get(nn_search(
                jnp.asarray(s_xyz[d]), jnp.int32(s_cnt[d]),
                jnp.asarray(r_xyz[d]), jnp.int32(r_cnt[d]),
                jnp.float32(corr),
            ))
            assert np.array_equal(i1, idx_sh[d])
            assert np.allclose(
                np.nan_to_num(d1, posinf=1e30),
                np.nan_to_num(dist_sh[d], posinf=1e30), atol=1e-6,
            )
            T1 = np.asarray(_icp_fused(
                jnp.asarray(s_xyz[d]), jnp.int32(s_cnt[d]),
                jnp.asarray(r_xyz[d]), jnp.int32(r_cnt[d]),
                jnp.float32(corr), jnp.float32(1e-6),
                jnp.zeros((r_xyz.shape[1], 3), jnp.float32),
                jnp.zeros((s_xyz.shape[1], 3), jnp.float32),
                jnp.float32(1e-3),
                variant="p2point", max_iters=6,
            ))
            assert np.allclose(T1, poses_sh[d], atol=1e-5)
            # the recovered translation counters the camera's shift
            assert abs(poses_sh[d][:3, 3]).max() < 0.05
