"""Property tests: random clouds through every op, checked against direct
numpy oracles (seeded, deterministic)."""

import numpy as np
import pytest

import cwipc_util_jax as cwipc


def random_cloud(rng, n, scale=1.0):
    arr = np.zeros(n, cwipc.POINT_DTYPE)
    xyz = rng.uniform(-scale, scale, size=(n, 3)).astype(np.float32)
    arr["x"], arr["y"], arr["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    for ch in ("r", "g", "b"):
        arr[ch] = rng.integers(0, 256, size=n)
    arr["tile"] = rng.integers(0, 8, size=n)
    return arr, cwipc.cwipc_from_numpy_array(arr, rng.integers(0, 2**40))


@pytest.mark.parametrize("seed", [0, 1, 2])
class TestOpProperties:
    def test_tilefilter_matches_numpy(self, seed):
        rng = np.random.default_rng(seed)
        arr, pc = random_cloud(rng, int(rng.integers(1, 3000)))
        for tile in (0, 1, 3, 7, 200):
            got = cwipc.cwipc_tilefilter(pc, tile).get_numpy_array()
            expect = arr if tile == 0 else arr[arr["tile"] == tile]
            assert np.array_equal(got, expect), f"tile {tile}"

    def test_crop_matches_numpy(self, seed):
        rng = np.random.default_rng(seed + 10)
        arr, pc = random_cloud(rng, int(rng.integers(1, 3000)))
        bbox = sorted(rng.uniform(-1, 1, 2).tolist()) + sorted(rng.uniform(-1, 1, 2).tolist()) + sorted(rng.uniform(-1, 1, 2).tolist())
        got = cwipc.cwipc_crop(pc, bbox).get_numpy_array()
        sel = (
            (arr["x"] >= bbox[0]) & (arr["x"] < bbox[1])
            & (arr["y"] >= bbox[2]) & (arr["y"] < bbox[3])
            & (arr["z"] >= bbox[4]) & (arr["z"] < bbox[5])
        )
        assert np.array_equal(got, arr[sel])

    def test_tilemap_matches_numpy(self, seed):
        rng = np.random.default_rng(seed + 20)
        arr, pc = random_cloud(rng, int(rng.integers(1, 3000)))
        lut = rng.integers(0, 256, size=256).astype(np.uint8)
        got = cwipc.cwipc_tilemap(pc, bytes(lut)).get_numpy_array()
        expect = arr.copy()
        expect["tile"] = lut[arr["tile"]]
        assert np.array_equal(got, expect)

    def test_colormap_matches_numpy(self, seed):
        rng = np.random.default_rng(seed + 30)
        arr, pc = random_cloud(rng, int(rng.integers(1, 3000)))
        clear = int(rng.integers(0, 2**32))
        setb = int(rng.integers(0, 2**32))
        got = cwipc.cwipc_colormap(pc, clear, setb).get_numpy_array()
        rgba = (
            (arr["tile"].astype(np.uint32) << 24)
            | (arr["r"].astype(np.uint32) << 16)
            | (arr["g"].astype(np.uint32) << 8)
            | arr["b"].astype(np.uint32)
        )
        rgba = (rgba & ~np.uint32(clear)) | np.uint32(setb)
        expect = arr.copy()
        expect["tile"] = (rgba >> 24) & 0xFF
        expect["r"] = (rgba >> 16) & 0xFF
        expect["g"] = (rgba >> 8) & 0xFF
        expect["b"] = rgba & 0xFF
        assert np.array_equal(got, expect)

    def test_downsample_voxel_set(self, seed):
        rng = np.random.default_rng(seed + 40)
        arr, pc = random_cloud(rng, int(rng.integers(10, 3000)))
        cellsize = float(rng.uniform(0.05, 0.5))
        out = cwipc.cwipc_downsample(pc, cellsize)
        inv = np.float32(1.0) / np.float32(cellsize)
        xyz = np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float32)
        uniq = np.unique(np.floor(xyz * inv).astype(np.int64), axis=0)
        assert out.count() == uniq.shape[0]

    def test_serialization_roundtrips(self, seed, tmp_path):
        rng = np.random.default_rng(seed + 50)
        arr, pc = random_cloud(rng, int(rng.integers(0, 2000)), scale=100.0)
        pc._set_cellsize(float(rng.uniform(0, 1)))
        # packet
        pc2 = cwipc.cwipc_from_packet(pc.get_packet())
        assert np.array_equal(pc2.get_numpy_array(), arr)
        assert pc2.timestamp() == pc.timestamp()
        # binary ply
        fn = str(tmp_path / f"f{seed}.ply")
        cwipc.cwipc_write(fn, pc, cwipc.CWIPC_FLAGS_BINARY)
        assert np.array_equal(cwipc.cwipc_read(fn, 0).get_numpy_array(), arr)
        # ascii ply (exact f32 round trip through %.9g)
        fn2 = str(tmp_path / f"fa{seed}.ply")
        cwipc.cwipc_write(fn2, pc)
        assert np.array_equal(cwipc.cwipc_read(fn2, 0).get_numpy_array(), arr)

    def test_join_concat(self, seed):
        rng = np.random.default_rng(seed + 60)
        a_arr, a = random_cloud(rng, int(rng.integers(0, 1000)))
        b_arr, b = random_cloud(rng, int(rng.integers(0, 1000)))
        out = cwipc.cwipc_join(a, b).get_numpy_array()
        assert np.array_equal(out, np.concatenate([a_arr, b_arr]))


class TestCodecFuzz:
    def test_decoder_rejects_corruption_cleanly(self):
        """Bit flips, truncations and garbage-with-magic must raise
        CwipcError (or decode to something) — never crash with an
        unrelated exception.  Covers the octree/JPEG stream paths."""
        import cwipc_util_jax as cwipc
        from cwipc_util_jax import codec
        from cwipc_util_jax.core.errors import CwipcError

        gen = cwipc.cwipc_synthetic(0, 4000)
        gen.start()
        pc = gen.get()
        gen.stop()
        enc = codec.cwipc_new_encoder(
            params=codec.cwipc_encoder_params(octree_bits=9)
        )
        enc.feed(pc)
        data = enc.get_bytes()
        rng = np.random.default_rng(0)
        for trial in range(60):
            buf = bytearray(data)
            mode = trial % 3
            if mode == 0:
                for _ in range(int(rng.integers(1, 8))):
                    buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
            elif mode == 1:
                buf = buf[: int(rng.integers(0, len(buf)))]
            else:
                buf = bytearray(
                    rng.integers(0, 256, int(rng.integers(10, 400)), dtype=np.uint8).tobytes()
                )
                buf[:4] = b"CTC1"
            dec = codec.cwipc_new_decoder()
            try:
                dec.feed(bytes(buf))
                out = dec.get()
                if out is not None:
                    out.free()
            except CwipcError:
                pass  # the contract: corrupt streams raise CwipcError


class TestChainFuzz:
    @pytest.mark.parametrize("seed", range(4))
    def test_fused_chain_matches_staged_ops(self, seed):
        """The fused downsample+outlier+tilefilter chain must equal the
        same three ops applied separately (catches fusion regressions in
        the channel-major plumbing)."""
        import jax.numpy as jnp

        from cwipc_util_jax.core.buffers import buffer_from_arrays
        from cwipc_util_jax.ops import compaction, outliers, voxelize
        from cwipc_util_jax.ops.chain import downsample_outliers_tilefilter

        rng = np.random.default_rng(seed)
        n = int(rng.integers(300, 4000))
        xyz = rng.random((n, 3), np.float32) * 2.0 - 1.0
        r, g, b = (rng.integers(0, 256, n, dtype=np.uint8) for _ in range(3))
        tiles = rng.integers(0, 4, n, dtype=np.uint8)
        buf = buffer_from_arrays(xyz, r, g, b, tiles)
        cellsize = jnp.float32(0.07)
        k, mult, tile = 8, jnp.float32(1.5), jnp.uint32(1)

        fused = downsample_outliers_tilefilter(
            buf, cellsize, k=k, mult=mult, tile=tile
        )

        down = voxelize.downsample(buf, cellsize)
        clean = outliers.remove_outliers(down, k, mult, method="window", window=16)
        staged = compaction.tilefilter(clean, tile)

        nf, ns = int(fused.count), int(staged.count)
        assert nf == ns, f"fused kept {nf}, staged kept {ns}"
        np.testing.assert_allclose(
            np.asarray(fused.xyz[:nf]), np.asarray(staged.xyz[:ns]),
            rtol=1e-5, atol=1e-6,
        )
        np.testing.assert_array_equal(
            np.asarray(fused.rgba[:nf]), np.asarray(staged.rgba[:ns])
        )

    @pytest.mark.parametrize("seed", range(4))
    def test_exact_chain_matches_staged_exact_ops(self, seed):
        """The EXACT chain variant must reproduce staged downsample ->
        brute-force-exact outlier removal -> tilefilter: same survivor
        set, i.e. the fused outlier stage is semantically exact, not an
        approximation (the keep threshold sits inside the distance
        distribution, so approximation errors flip decisions)."""
        import jax.numpy as jnp

        from cwipc_util_jax.core.buffers import buffer_from_arrays
        from cwipc_util_jax.ops import compaction, outliers, voxelize
        from cwipc_util_jax.ops.chain import downsample_outliers_tilefilter_exact

        rng = np.random.default_rng(seed + 7)
        n = int(rng.integers(300, 4000))
        xyz = rng.random((n, 3), np.float32) * 2.0 - 1.0
        r, g, b = (rng.integers(0, 256, n, dtype=np.uint8) for _ in range(3))
        tiles = rng.integers(0, 4, n, dtype=np.uint8)
        buf = buffer_from_arrays(xyz, r, g, b, tiles)
        cellsize = jnp.float32(0.07)
        k, mult, tile = 8, jnp.float32(1.5), jnp.uint32(1)

        fused, resid = downsample_outliers_tilefilter_exact(
            buf, cellsize, k=k, mult=mult, tile=tile,
            out_capacity=buf.capacity, gy=64, gz=64, cap=32,
        )

        down = voxelize.downsample(buf, cellsize)
        clean = outliers.remove_outliers(down, k, mult, method="exact")
        staged = compaction.tilefilter(clean, tile)

        nf, ns = int(fused.count), int(staged.count)
        assert nf == ns, f"exact fused kept {nf}, staged exact kept {ns}"
        np.testing.assert_allclose(
            np.asarray(fused.xyz[:nf]), np.asarray(staged.xyz[:ns]),
            rtol=1e-5, atol=1e-6,
        )
        np.testing.assert_array_equal(
            np.asarray(fused.rgba[:nf]), np.asarray(staged.rgba[:ns])
        )

    @pytest.mark.parametrize("seed", range(3))
    def test_cols_md_matches_bruteforce(self, seed):
        """The column-grid exact kNN + brute-force fixup reproduces the
        brute-force mean distances for every point."""
        import jax.numpy as jnp

        from cwipc_util_jax.ops.cols_knn import (
            bruteforce_md_subset,
            cols_knn_mean_distance,
        )
        from cwipc_util_jax.ops.outliers import _mean_knn_dist_bruteforce

        rng = np.random.default_rng(seed + 77)
        n = int(rng.integers(500, 5000))
        cell = 0.05
        # voxel-unique cloud: distinct cells with in-cell jitter
        cells = rng.choice(40**3, n, replace=False)
        v = np.stack([cells // 1600, (cells // 40) % 40, cells % 40], -1)
        xyz = ((v + rng.random((n, 3))) * cell).astype(np.float32)
        cap_n = 8192
        full = np.zeros((cap_n, 3), np.float32)
        full[:n] = xyz
        k = 12
        md, unc = cols_knn_mean_distance(
            jnp.asarray(full), jnp.int32(n), jnp.float32(cell), k,
            gy=64, gz=64, cap=64, voxel_unique=True,
        )
        md = np.asarray(md)
        if bool(np.asarray(unc).any()):
            fix = np.asarray(
                bruteforce_md_subset(jnp.asarray(full), jnp.int32(n), unc, k)
            )
            md = np.where(np.asarray(unc), fix, md)
        ref = np.asarray(
            _mean_knn_dist_bruteforce(jnp.asarray(full), jnp.int32(n), k)
        )
        np.testing.assert_allclose(md[:n], ref[:n], rtol=1e-4, atol=2e-6)

    def test_cols_clipped_origin_far_outlier(self):
        """A grid sized from percentile-clipped extents must ANCHOR at
        the clipped origin (vmin_override): with the default global-min
        rebase, one far-negative outlier shifts the whole core out of
        the grid (every point uncovered -> the O(N^2) fixup).  The
        override keeps the core covered and the result exact."""
        import jax.numpy as jnp

        from cwipc_util_jax.ops.cols_knn import (
            bruteforce_md_subset,
            cols_knn_mean_distance,
        )
        from cwipc_util_jax.ops.outliers import _mean_knn_dist_bruteforce

        rng = np.random.default_rng(9)
        n = 3000
        cell = 0.05
        cells = rng.choice(40**3, n - 1, replace=False)
        v = np.stack([cells // 1600, (cells // 40) % 40, cells % 40], -1)
        xyz = ((v + rng.random((n - 1, 3))) * cell).astype(np.float32)
        far = np.array([[-30.0, -30.0, -30.0]], np.float32)  # 600 cells away
        full = np.zeros((4096, 3), np.float32)
        full[: n - 1] = xyz
        full[n - 1 : n] = far
        k = 12
        # origin from the core (the outlier is outside any percentile clip)
        origin = np.floor(xyz.min(axis=0) / cell).astype(np.int32)
        md, unc = cols_knn_mean_distance(
            jnp.asarray(full), jnp.int32(n), jnp.float32(cell), k,
            gy=64, gz=64, cap=64,
            vmin_override=jnp.asarray(origin),
        )
        unc_np = np.asarray(unc)
        assert unc_np[n - 1]
        # the core stays in-grid: the uncovered rate must match the
        # no-outlier control (ring-limited points only) — without the
        # anchored origin the outlier rebases the grid and EVERYTHING
        # comes back uncovered
        ctrl = np.zeros((4096, 3), np.float32)
        ctrl[: n - 1] = xyz
        _, unc_ctrl = cols_knn_mean_distance(
            jnp.asarray(ctrl), jnp.int32(n - 1), jnp.float32(cell), k,
            gy=64, gz=64, cap=64,
        )
        ctrl_rate = float(np.asarray(unc_ctrl)[: n - 1].mean())
        assert unc_np[: n - 1].mean() <= ctrl_rate + 0.05
        md = np.asarray(md)
        fix = np.asarray(
            bruteforce_md_subset(jnp.asarray(full), jnp.int32(n), unc, k)
        )
        md = np.where(unc_np, fix, md)
        ref = np.asarray(
            _mean_knn_dist_bruteforce(jnp.asarray(full), jnp.int32(n), k)
        )
        np.testing.assert_allclose(md[:n], ref[:n], rtol=1e-4, atol=2e-6)

    def test_cols_exact_despite_dropped_points(self):
        """An UNDERSIZED grid (tiny cap + clipped extents) drops points;
        the drops must poison their NEIGHBORS' coverage too — a dropped
        point is missing from nearby candidate sets, so 'covered' results
        near a drop would be silently wrong without ring invalidation
        (the round-3 bug found on the public accelerator path)."""
        import jax.numpy as jnp

        from cwipc_util_jax.ops.cols_knn import (
            bruteforce_md_subset,
            cols_knn_mean_distance,
        )
        from cwipc_util_jax.ops.outliers import _mean_knn_dist_bruteforce

        rng = np.random.default_rng(5)
        n = 2500
        cell = 0.05
        # a dense lump (columns overflow cap=8) plus a surrounding shell
        lump = rng.normal(0, 0.04, (800, 3))
        shell = rng.normal(0, 0.3, (n - 800, 3))
        xyz = np.concatenate([lump, shell]).astype(np.float32)
        cap_n = 4096
        full = np.zeros((cap_n, 3), np.float32)
        full[:n] = xyz
        k = 10
        md, unc = cols_knn_mean_distance(
            jnp.asarray(full), jnp.int32(n), jnp.float32(cell), k,
            gy=32, gz=32, cap=8,
        )
        md = np.asarray(md)
        unc_j = jnp.asarray(np.asarray(unc))
        fix = np.asarray(
            bruteforce_md_subset(jnp.asarray(full), jnp.int32(n), unc_j, k)
        )
        md = np.where(np.asarray(unc), fix, md)
        ref = np.asarray(
            _mean_knn_dist_bruteforce(jnp.asarray(full), jnp.int32(n), k)
        )
        np.testing.assert_allclose(md[:n], ref[:n], rtol=1e-4, atol=2e-6)

    @pytest.mark.parametrize("seed", range(2))
    def test_cols_md_exact_on_duplicate_cells(self, seed):
        """The public-op path: clouds that are NOT voxel-unique (several
        points per cell) must still come out exact — the per-column
        pre-selection is only legal under voxel uniqueness, so
        voxel_unique=False must keep every slot a candidate."""
        import jax.numpy as jnp

        from cwipc_util_jax.ops.cols_knn import (
            bruteforce_md_subset,
            cols_knn_mean_distance,
        )
        from cwipc_util_jax.ops.outliers import _mean_knn_dist_bruteforce

        rng = np.random.default_rng(seed + 170)
        n = 3000
        cell = 0.05
        # ~3 points per occupied cell on average
        cells = rng.choice(20**3, n // 3, replace=False)
        cells = np.repeat(cells, 3)[:n]
        v = np.stack([cells // 400, (cells // 20) % 20, cells % 20], -1)
        xyz = ((v + rng.random((n, 3))) * cell).astype(np.float32)
        cap_n = 4096
        full = np.zeros((cap_n, 3), np.float32)
        full[:n] = xyz
        k = 10
        md, unc = cols_knn_mean_distance(
            jnp.asarray(full), jnp.int32(n), jnp.float32(cell), k,
            gy=32, gz=32, cap=32, voxel_unique=False,
        )
        md = np.asarray(md)
        if bool(np.asarray(unc).any()):
            fix = np.asarray(
                bruteforce_md_subset(jnp.asarray(full), jnp.int32(n), unc, k)
            )
            md = np.where(np.asarray(unc), fix, md)
        ref = np.asarray(
            _mean_knn_dist_bruteforce(jnp.asarray(full), jnp.int32(n), k)
        )
        np.testing.assert_allclose(md[:n], ref[:n], rtol=1e-4, atol=2e-6)
