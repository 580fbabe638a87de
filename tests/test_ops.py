"""Operator invariant tests, mirroring the reference oracles
(test_cwipc_util.py:428-594) plus exact-semantics parity checks against
straightforward numpy implementations."""

import gc

import numpy as np
import pytest

import cwipc_util_jax as cwipc


@pytest.fixture(scope="module")
def synth_pc():
    gen = cwipc.cwipc_synthetic()
    gen.start()
    pc = gen.get()
    gen.stop()
    assert pc is not None
    return pc


@pytest.fixture(scope="module")
def small_pc():
    gen = cwipc.cwipc_synthetic(0, 2500)
    gen.start()
    pc = gen.get()
    gen.stop()
    assert pc is not None
    return pc


class TestTilefilter:
    def test_partition(self, synth_pc):
        pc_all = cwipc.cwipc_tilefilter(synth_pc, 0)
        assert pc_all.count() == synth_pc.count()
        pc1 = cwipc.cwipc_tilefilter(synth_pc, 1)
        pc2 = cwipc.cwipc_tilefilter(synth_pc, 2)
        assert synth_pc.count() == pc1.count() + pc2.count()
        assert synth_pc.timestamp() == pc1.timestamp()
        assert synth_pc.timestamp() == pc2.timestamp()
        # every selected point really has the tile
        assert (pc1.get_numpy_array()["tile"] == 1).all()
        assert (pc2.get_numpy_array()["tile"] == 2).all()

    def test_empty(self):
        pc = cwipc.cwipc_from_points([], 0)
        filtered = cwipc.cwipc_tilefilter(pc, 0)
        assert filtered.count() == 0

    def test_order_preserved(self, small_pc):
        arr = small_pc.get_numpy_array()
        expect = arr[arr["tile"] == 1]
        got = cwipc.cwipc_tilefilter(small_pc, 1).get_numpy_array()
        assert np.array_equal(expect, got)


class TestJoin:
    def test_count(self, small_pc):
        pc2 = small_pc.clone()
        out = cwipc.cwipc_join(small_pc, pc2)
        assert out.count() == small_pc.count() * 2
        # order: pc1's points first
        arr = out.get_numpy_array()
        assert np.array_equal(arr[: small_pc.count()], small_pc.get_numpy_array())

    def test_join_multi(self, small_pc):
        pcs = [small_pc.clone() for _ in range(3)]
        out = cwipc.cwipc_join_multi(pcs)
        assert out.count() == small_pc.count() * 3

    def test_timestamp_cellsize_min(self):
        a = cwipc.cwipc_from_points([(0, 0, 0, 0, 0, 0, 1)], 100)
        b = cwipc.cwipc_from_points([(1, 1, 1, 0, 0, 0, 2)], 50)
        a._set_cellsize(0.5)
        b._set_cellsize(0.25)
        out = cwipc.cwipc_join(a, b)
        assert out.timestamp() == 50
        assert out.cellsize() == 0.25


class TestTilemap:
    def test_permutation(self, synth_pc):
        f1 = cwipc.cwipc_tilefilter(synth_pc, 1).count()
        f2 = cwipc.cwipc_tilefilter(synth_pc, 2).count()
        mapped = cwipc.cwipc_tilemap(synth_pc, {1: 5, 2: 6})
        assert cwipc.cwipc_tilefilter(mapped, 5).count() == f1
        assert cwipc.cwipc_tilefilter(mapped, 6).count() == f2
        assert cwipc.cwipc_tilefilter(mapped, 1).count() == 0
        assert cwipc.cwipc_tilefilter(mapped, 2).count() == 0

    def test_list_mapping(self, small_pc):
        lut = list(range(256))
        lut[1], lut[2] = 2, 1
        mapped = cwipc.cwipc_tilemap(small_pc, lut)
        a = small_pc.get_numpy_array()
        b = mapped.get_numpy_array()
        assert ((a["tile"] == 1) == (b["tile"] == 2)).all()


class TestColormap:
    def test_full_overwrite(self, small_pc):
        pc2 = cwipc.cwipc_colormap(small_pc, 0xFFFFFFFF, 0x010203)
        a = small_pc.get_numpy_array()
        b = pc2.get_numpy_array()
        assert a.shape == b.shape
        assert np.array_equal(a["x"], b["x"])
        assert (b["r"] == 1).all()
        assert (b["g"] == 2).all()
        assert (b["b"] == 3).all()
        assert (b["tile"] == 0).all()

    def test_partial_mask(self, small_pc):
        # only clear the red channel (PCL layout: r is bits 16-23)
        pc2 = cwipc.cwipc_colormap(small_pc, 0x00FF0000, 0)
        a = small_pc.get_numpy_array()
        b = pc2.get_numpy_array()
        assert (b["r"] == 0).all()
        assert np.array_equal(a["g"], b["g"])
        assert np.array_equal(a["tile"], b["tile"])


class TestCrop:
    def test_partition(self, synth_pc):
        left = cwipc.cwipc_crop(synth_pc, [-999, 0, -999, 999, -999, 999])
        right = cwipc.cwipc_crop(synth_pc, [0, 999, -999, 999, -999, 999])
        assert synth_pc.count() == left.count() + right.count()
        assert (left.get_numpy_array()["x"] < 0).all()
        assert (right.get_numpy_array()["x"] >= 0).all()


class TestDownsample:
    def test_monotone_until_few(self, synth_pc):
        count_orig = synth_pc.count()
        count_filtered = count_orig
        cellsize = synth_pc.cellsize() / 2
        while cellsize < 16:
            pc_f = cwipc.cwipc_downsample(synth_pc, cellsize)
            count_filtered = pc_f.count()
            assert count_filtered >= 1
            assert count_filtered <= count_orig
            assert pc_f.timestamp() == synth_pc.timestamp()
            if count_filtered < 2:
                break
            cellsize *= 2
        assert count_filtered <= 8

    def test_voxelgrid_variant(self, synth_pc):
        # negative cellsize = plain voxelgrid path
        pc_f = cwipc.cwipc_downsample(synth_pc, -(synth_pc.cellsize() * 4))
        assert 1 <= pc_f.count() <= synth_pc.count()

    def test_empty(self):
        pc = cwipc.cwipc_from_points([], 0)
        filtered = cwipc.cwipc_downsample(pc, 1)
        assert filtered.count() == 0

    def test_semantics_vs_numpy(self, small_pc):
        """Exact voxel semantics: centroid mean, tile OR, against numpy."""
        cellsize = 0.05
        out = cwipc.cwipc_downsample(small_pc, cellsize)
        got = out.get_numpy_array()
        assert out.cellsize() == cellsize

        arr = small_pc.get_numpy_array()
        xyz = np.stack([arr["x"], arr["y"], arr["z"]], axis=-1).astype(np.float32)
        # quantization in f32 with a reciprocal multiply, as PCL (and the
        # kernel) do: floor(x * (1/cellsize))
        inv_cell = np.float32(1.0) / np.float32(cellsize)
        keys = np.floor(xyz * inv_cell).astype(np.int64)
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        assert got.shape[0] == uniq.shape[0]

        # build expected centroids per voxel
        expect = {}
        for i in range(uniq.shape[0]):
            sel = inv == i
            cx = xyz[sel].astype(np.float64).mean(axis=0)
            tile_or = np.bitwise_or.reduce(arr["tile"][sel])
            expect[tuple(uniq[i])] = (cx, tile_or, sel.sum())
        for p in got:
            k = tuple(
                np.floor(np.array([p["x"], p["y"], p["z"]], np.float32) * inv_cell).astype(np.int64)
            )
            assert k in expect, f"unexpected voxel {k}"
            cx, tile_or, _ = expect[k]
            assert np.allclose([p["x"], p["y"], p["z"]], cx, atol=1e-4)
            assert p["tile"] == tile_or

    def test_cellsize_max_rule(self, small_pc):
        pc = small_pc.clone()
        pc._set_cellsize(0.5)
        out = cwipc.cwipc_downsample(pc, 0.1)
        # result cellsize = max(input cellsize, requested)
        assert out.cellsize() == 0.5


class TestRemoveOutliers:
    def test_fewer_but_nonzero(self, synth_pc):
        count_orig = synth_pc.count()
        pc_f = cwipc.cwipc_remove_outliers(synth_pc, 30, 1.0, True)
        assert 0 < pc_f.count() < count_orig

    def test_exact_vs_numpy(self):
        """Exact path parity against a direct numpy PCL-semantics oracle."""
        rng = np.random.default_rng(42)
        n = 500
        pts = rng.normal(size=(n, 3)).astype(np.float32)
        pts[::50] *= 10.0  # inject outliers
        arr = np.zeros(n, cwipc.POINT_DTYPE)
        arr["x"], arr["y"], arr["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
        pc = cwipc.cwipc_from_numpy_array(arr, 0)
        k, mult = 10, 1.0
        out = cwipc.cwipc_remove_outliers(pc, k, mult, False)

        d = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1))
        np.fill_diagonal(d, np.inf)
        knn = np.sort(d, axis=1)[:, :k]
        md = knn.mean(axis=1)
        mean, s, sq = md.mean(), md.sum(), (md * md).sum()
        sigma = np.sqrt((sq - s * s / n) / (n - 1))
        keep = md <= mean + mult * sigma
        expect = arr[keep]
        got = out.get_numpy_array()
        assert got.shape[0] == expect.shape[0]
        assert np.array_equal(got["x"], expect["x"])

    def test_outlier_actually_removed_grid(self):
        """Grid path must drop an isolated far-away point."""
        rng = np.random.default_rng(0)
        n = 8192
        pts = rng.uniform(0, 1, size=(n, 3)).astype(np.float32)
        pts[0] = [100.0, 100.0, 100.0]
        arr = np.zeros(n, cwipc.POINT_DTYPE)
        arr["x"], arr["y"], arr["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
        pc = cwipc.cwipc_from_numpy_array(arr, 0)
        out = cwipc.cwipc_remove_outliers(pc, 8, 2.0, False)
        got = out.get_numpy_array()
        assert got.shape[0] < n
        assert not (got["x"] > 50).any()

    def test_per_tile_partition(self, small_pc):
        out_per_tile = cwipc.cwipc_remove_outliers(small_pc, 8, 1.0, True)
        # per-tile results concatenated in tile-first-appearance order
        tiles = out_per_tile.get_numpy_array()["tile"]
        first_1 = np.argmax(tiles == 1) if (tiles == 1).any() else -1
        # all tile-1 points come before tile-2 points iff tile 1 appears first
        orig_tiles = small_pc.get_numpy_array()["tile"]
        if orig_tiles[0] == 1:
            boundary = np.searchsorted(np.cumsum(tiles == 2), 1)
            assert (tiles[:boundary] == 1).all() or first_1 == 0


class TestWideScene:
    def test_downsample_wide_extent_exact_keys(self):
        """Scenes wider than the 1024-cell Morton domain must still produce
        the exact voxel set (the wrapper switches to exact tiebreak keys)."""
        rng = np.random.default_rng(3)
        n = 5000
        pts = np.zeros(n, cwipc.POINT_DTYPE)
        # 200m extent at 5cm cells = 4000 cells per axis (>> 1024)
        xyz = rng.uniform(-100, 100, size=(n, 3)).astype(np.float32)
        pts["x"], pts["y"], pts["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
        pts["tile"] = rng.integers(1, 3, size=n)
        pc = cwipc.cwipc_from_numpy_array(pts, 0)
        cellsize = 0.05
        out = cwipc.cwipc_downsample(pc, cellsize)

        inv = np.float32(1.0) / np.float32(cellsize)
        keys = np.floor(xyz * inv).astype(np.int64)
        uniq = np.unique(keys, axis=0)
        assert out.count() == uniq.shape[0]
        got = out.get_numpy_matrix(onlyGeometry=True)
        got_keys = np.unique(np.floor(got.astype(np.float32) * inv).astype(np.int64), axis=0)
        assert got_keys.shape[0] == uniq.shape[0]
        assert (got_keys == uniq).all()


def test_downsample_merged_exact_matches_full_exact():
    """The merged (vy,vz) tiebreak key must reproduce the 4-key exact path
    bit-for-bit on a wide scene (extent > 1023 cells, < 2^15)."""
    import jax.numpy as jnp
    from cwipc_util_jax.core.buffers import PointBuffer
    from cwipc_util_jax.ops import voxelize

    rng = np.random.default_rng(5)
    cap = 8192
    n = 7000
    xyz = np.zeros((cap, 3), np.float32)
    xyz[:n] = (rng.random((n, 3)) * 50.0 - 25.0).astype(np.float32)  # 5000 cells wide
    rgba = rng.integers(0, 2**32, cap, dtype=np.uint64).astype(np.uint32)
    buf = PointBuffer(xyz=jnp.asarray(xyz), rgba=jnp.asarray(rgba), count=jnp.int32(n))
    a = voxelize.downsample(buf, jnp.float32(0.01), exact_keys=True, merged_exact=True)
    b = voxelize.downsample(buf, jnp.float32(0.01), exact_keys=True, merged_exact=False)
    assert int(a.count) == int(b.count)
    m = int(a.count)
    assert np.array_equal(np.asarray(a.xyz[:m]), np.asarray(b.xyz[:m]))
    assert np.array_equal(np.asarray(a.rgba[:m]), np.asarray(b.rgba[:m]))


def test_spacing_estimate_not_inflated_by_distant_prefix():
    """The spacing estimator must find true local neighbors even when the
    cloud's array prefix is spatially far from later points (a fixed-prefix
    or subset-vs-subset search overestimates spacing by large factors,
    inflating the outlier grid cells ~1000x in candidate count)."""
    import numpy as np

    import cwipc_util_jax as cwipc
    from cwipc_util_jax.ops import _estimate_spacing

    rng = np.random.default_rng(7)
    n = 20000
    # two dense blobs 100 apart; spacing inside each blob ~0.01
    a = rng.random((n // 2, 3), np.float32) * 0.5
    b = rng.random((n // 2, 3), np.float32) * 0.5 + 100.0
    pts = [(float(x), float(y), float(z), 0, 0, 0, 0)
           for x, y, z in np.concatenate([a, b])]
    pc = cwipc.cwipc_from_points(pts, 0)
    try:
        spacing = _estimate_spacing(pc)
        # true median NN distance in a 0.5^3 cube with 10k points ~ 0.012
        assert spacing < 0.1, f"spacing overestimated: {spacing}"
    finally:
        pc.free()


def test_remove_outliers_inf_mult_on_uniform_grid_keeps_all():
    """mult=inf is the documented pure-downsample mode; a zero-variance
    mean-distance population (uniform grid) must keep everything instead
    of producing a NaN threshold that drops every point."""
    g = np.linspace(0.0, 0.3, 8, dtype=np.float32)
    xx, yy, zz = np.meshgrid(g, g, g)
    pts = [(float(x), float(y), float(z), 0, 0, 0, 0)
           for x, y, z in zip(xx.ravel(), yy.ravel(), zz.ravel())]
    pc = cwipc.cwipc_from_points(pts, 0)
    out = cwipc.cwipc_remove_outliers(pc, 6, float("inf"), False)
    assert out.count() == pc.count()


def test_tilemap_dict_rejects_out_of_range_keys():
    pc = cwipc.cwipc_from_points([cwipc.cwipc_point(0, 0, 0, 1, 2, 3, 1)], 0)
    with pytest.raises(cwipc.CwipcError):
        cwipc.cwipc_tilemap(pc, {256: 1})
    with pytest.raises(cwipc.CwipcError):
        cwipc.cwipc_tilemap(pc, {-1: 5})


def test_join_multi_frees_intermediates():
    from cwipc_util_jax import cwipc_dangling_allocations, cwipc_join_multi

    gc.collect()  # free earlier tests' cyclic garbage first
    before = cwipc_dangling_allocations(False)
    pcs = [
        cwipc.cwipc_from_points([cwipc.cwipc_point(i, 0, 0, 1, 2, 3, 1)], 0)
        for i in range(4)
    ]
    joined = cwipc_join_multi(pcs)
    assert joined.count() == 4
    joined.free()
    for p in pcs:
        p.free()
    assert cwipc_dangling_allocations(False) == before
