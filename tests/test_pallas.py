"""Device-path tests that need no GPU: the Pallas window kernel in
interpret mode, the XLA forms of the other stages against plain numpy /
scipy oracles, and every device program lowered for CUDA."""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cwipc_util_jax.core.buffers import PointBuffer, buffer_from_arrays
from cwipc_util_jax.ops import compaction, outliers
from cwipc_util_jax.ops.pallas_window_knn import BLOCK, window_knn_mean_distance_cm


def _window_md(xyz, count, k, window):
    return window_knn_mean_distance_cm(
        xyz[:, 0], xyz[:, 1], xyz[:, 2], count, k, window=window, interpret=True
    )


class TestWindowKnnKernel:
    @pytest.mark.parametrize("count", [4000, 4096, 100, 0])
    def test_matches_xla_path(self, count):
        rng = np.random.default_rng(count)
        cap = 8 * BLOCK
        xyz = jnp.asarray(np.sort(rng.random((cap, 3), dtype=np.float32), axis=0))
        c = jnp.int32(count)
        ref = np.asarray(outliers._mean_knn_dist_window(xyz, c, 30, window=32))
        got = np.asarray(_window_md(xyz, c, 30, 32))
        assert np.allclose(ref, got, atol=1e-6), np.abs(ref - got).max()

    @pytest.mark.parametrize(
        "cap,count,k,window",
        [
            (1500, 1400, 30, 16),  # production: drop the 2 largest
            (1024, 1000, 5, 16),  # keep the 5 smallest
            (700, 650, 16, 8),  # k == 2W: nothing dropped
            (600, 37, 40, 4),  # k > 2W: divisor is 2W
            (2048, 2047, 20, 16),  # drop 12 of 32
        ],
    )
    def test_selection_branches_match_xla(self, cap, count, k, window):
        """Both register-list strategies (drop the largest / keep the
        smallest), padding to the block size, and k beyond the window."""
        rng = np.random.default_rng(cap + k)
        xyz = jnp.asarray(np.sort(rng.random((cap, 3), dtype=np.float32), axis=0))
        c = jnp.int32(count)
        ref = np.asarray(outliers._mean_knn_dist_window(xyz, c, k, window=window))
        got = np.asarray(_window_md(xyz, c, k, window))
        assert got.shape == (cap,)
        # float32 summation order differs (sum-then-subtract vs sorted sum)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
        assert not got[count:].any()

    def test_remove_outliers_method(self):
        """The window method's survivors equal a compaction driven by the
        kernel's mean distances."""
        rng = np.random.default_rng(1)
        cap = 8 * BLOCK
        n = 4000
        pts = np.sort(rng.random((cap, 3), dtype=np.float32), axis=0)
        z = np.zeros(cap, np.uint8)
        buf = buffer_from_arrays(pts, z, z, z, z, capacity=cap)
        buf = type(buf)(xyz=buf.xyz, rgba=buf.rgba, count=jnp.int32(n))
        a = outliers.remove_outliers(buf, 30, jnp.float32(1.0), method="window")
        md = _window_md(buf.xyz, buf.count, 30, 32)
        keep = outliers._keep_from_mean_dists(md, buf.valid_mask(), jnp.float32(1.0))
        b = compaction.compact(buf, keep)
        assert int(a.count) == int(b.count)
        na, nb = np.asarray(a.xyz[: int(a.count)]), np.asarray(b.xyz[: int(b.count)])
        assert np.array_equal(na, nb)


# ---------------------------------------------------------------------------
# The XLA run reduction (the downsample's segment sum) vs numpy
# ---------------------------------------------------------------------------


def _reduce(smk, sfr, srgba, count, ocap=2048, cell=1.0):
    from cwipc_util_jax.ops.voxelize import _reduce_runs_xla_cm

    return _reduce_runs_xla_cm(
        jnp.asarray(smk), jnp.asarray(sfr), jnp.asarray(srgba), jnp.int32(count),
        jnp.zeros(3, jnp.int32), jnp.float32(cell), ocap=ocap,
    )


def _demorton(keys):
    def compact(v):
        out = np.zeros_like(v)
        for b in range(10):
            out |= ((v >> (3 * b)) & 1) << b
        return out

    keys = keys.astype(np.int64)
    return compact(keys), compact(keys >> 1), compact(keys >> 2)


class TestSegmentReduce:
    @pytest.mark.parametrize(
        "count,nruns",
        [(3500, 300), (4096, 500), (100, 7), (0, 1), (3000, 5), (2100, 1)],
    )
    def test_matches_numpy_oracle(self, count, nruns):
        rng = np.random.default_rng(count + nruns)
        cap = 4096
        if count:
            lens = rng.multinomial(count, np.ones(nruns) / nruns)
            keys = np.repeat(
                np.sort(rng.choice(1 << 29, size=nruns, replace=False)).astype(np.int32), lens
            )[:count]
        else:
            keys = np.zeros(0, np.int32)
        smk = np.full(cap, np.iinfo(np.int32).max, np.int32)
        smk[: len(keys)] = keys
        sfr = rng.integers(0, 1 << 30, size=cap).astype(np.int32)
        srgba = rng.integers(-(2**31), 2**31, size=cap).astype(np.int32)
        x, y, z, rgba, nseg = map(np.asarray, _reduce(smk, sfr, srgba, len(keys)))
        uniq, inv = np.unique(keys, return_inverse=True)
        assert int(nseg) == len(uniq)
        assert not x[len(uniq):].any() and not rgba[len(uniq):].any()
        if not len(keys):
            return
        u = srgba[: len(keys)].astype(np.int64) & 0xFFFFFFFF
        fr = sfr[: len(keys)].astype(np.int64)
        vx, vy, vz = _demorton(uniq)
        for s in range(len(uniq)):
            sel = inv == s
            fx = (((fr[sel] >> 20) & 1023) + 0.5).mean() / 1024
            fz = (((fr[sel]) & 1023) + 0.5).mean() / 1024
            # the offsets are summed exactly (int32); only the final
            # float32 (v + frac) rounds: one ulp of the coordinate
            assert abs(x[s] - (vx[s] + fx)) <= np.spacing(np.float32(vx[s] + 1))
            assert abs(z[s] - (vz[s] + fz)) <= np.spacing(np.float32(vz[s] + 1))
            r = int(((u[sel] >> 16) & 0xFF).mean())
            assert int((int(rgba[s]) >> 16) & 0xFF) == r
            assert (int(rgba[s]) >> 24) == np.bitwise_or.reduce(u[sel] >> 24)

    def test_block_aligned_runs(self):
        """Runs of 1024 identical keys: counts, tile OR and colors."""
        rng = np.random.default_rng(11)
        run = 1024
        keys = np.repeat(np.array([5, 9, 1000, 70000], np.int32), run)
        sfr = rng.integers(0, 1 << 30, keys.size).astype(np.int32)
        srgba = rng.integers(-(2**31), 2**31, keys.size).astype(np.int32)
        x, y, z, rgba, nseg = map(np.asarray, _reduce(keys, sfr, srgba, keys.size))
        assert int(nseg) == 4
        u = srgba.astype(np.int64) & 0xFFFFFFFF
        for s in range(4):
            sel = slice(s * run, (s + 1) * run)
            assert (int(rgba[s]) >> 24) == np.bitwise_or.reduce(u[sel] >> 24)
            assert ((int(rgba[s]) >> 8) & 0xFF) == int(((u[sel] >> 8) & 0xFF).mean())

    @pytest.mark.parametrize("seed", [0, 1])
    def test_order_within_runs_does_not_change_bits(self, seed):
        """The sums are integer, so permuting the points inside each run
        (as a device's scatter-add order may) gives the same bits."""
        rng = np.random.default_rng(seed)
        lens = rng.integers(1, 400, 20)
        keys = np.repeat(np.sort(rng.choice(1 << 29, 20, replace=False)), lens)
        keys = keys.astype(np.int32)
        sfr = rng.integers(0, 1 << 30, keys.size).astype(np.int32)
        srgba = rng.integers(-(2**31), 2**31, keys.size).astype(np.int32)
        perm = np.concatenate([
            s + rng.permutation(n) for s, n in zip(np.cumsum(lens) - lens, lens)
        ])
        a = _reduce(keys, sfr, srgba, keys.size, ocap=64, cell=0.004)
        b = _reduce(keys, sfr[perm], srgba[perm], keys.size, ocap=64, cell=0.004)
        for u, v in zip(a, b):
            assert np.array_equal(np.asarray(u), np.asarray(v))


class TestLongRunTileOr:
    def test_tile_or_exact_for_runs_over_2048(self):
        """A single voxel holding >= 2048 same-tile points keeps the exact
        tile OR."""
        cap = 1 << 12  # 4096 points, all in ONE voxel run
        smk = np.zeros(cap, np.int32)
        sfr = np.zeros(cap, np.int32)
        tile = 1
        srgba = np.full(cap, (tile << 24) | 0x00AABBCC, np.uint32).astype(np.int32)
        x, y, z, rgba, nseg = _reduce(smk, sfr, srgba, cap, ocap=256)
        assert int(nseg) == 1
        assert int(np.asarray(rgba)[0]) >> 24 == tile
        assert int(np.asarray(rgba)[0]) & 0xFFFFFF == 0xAABBCC

    def test_tile_or_exact_mixed_bits_long_runs(self):
        """Long runs mixing low and high tile bits keep both."""
        cap = 1 << 12
        smk = np.concatenate([np.zeros(cap // 2, np.int32), np.ones(cap // 2, np.int32)])
        sfr = np.zeros(cap, np.int32)
        tiles = np.concatenate([
            np.full(cap // 4, 0x01, np.uint32),  # run 0: bits 0 and 4
            np.full(cap // 4, 0x10, np.uint32),
            np.full(cap // 2, 0x88, np.uint32),  # run 1: bits 3 and 7
        ])
        srgba = ((tiles << 24) | 0x00112233).astype(np.int32)
        x, y, z, rgba, nseg = _reduce(smk, sfr, srgba, cap, ocap=256)
        rgba = np.asarray(rgba)
        assert int(nseg) == 2
        assert int(rgba[0]) >> 24 == 0x11
        assert int(rgba[1]) >> 24 == 0x88


# ---------------------------------------------------------------------------
# Compaction (sort form) vs numpy
# ---------------------------------------------------------------------------


class TestCompactKernel:
    @pytest.mark.parametrize("count,frac", [(5000, 0.8), (2048, 1.0), (300, 0.3), (4096, 0.0)])
    def test_matches_sort_compaction(self, count, frac):
        """compact_cm is an order-preserving subset with a zeroed tail."""
        cap = 1 << 13
        rng = np.random.default_rng(count)
        xyz = rng.standard_normal((cap, 3)).astype(np.float32)
        rgba = rng.integers(0, 1 << 32, cap, dtype=np.uint32)
        keep = rng.random(cap) < frac
        out = jax.jit(compaction.compact_cm)(
            *(jnp.asarray(xyz[:, i]) for i in range(3)), jnp.asarray(rgba),
            jnp.asarray(keep), jnp.int32(count),
        )
        keep[count:] = False
        n = int(out.count)
        assert n == keep.sum()
        np.testing.assert_array_equal(np.asarray(out.xyz)[:n], xyz[keep])
        np.testing.assert_array_equal(np.asarray(out.rgba)[:n], rgba[keep])
        assert not np.asarray(out.xyz)[n:].any()

    def test_nonfinite_payload_roundtrip(self):
        """Bitcast transport survives inf/nan/-0.0/subnormal payloads."""
        cap = 1 << 10
        xyz = np.zeros((cap, 3), np.float32)
        xyz[0] = [np.inf, -np.inf, np.nan]
        xyz[1] = [-0.0, 1e-42, 3.4e38]  # subnormal + near-max
        rgba = np.arange(cap, dtype=np.uint32)
        keep = np.zeros(cap, bool)
        keep[:4] = True
        buf = PointBuffer(xyz=jnp.asarray(xyz), rgba=jnp.asarray(rgba), count=jnp.int32(cap))
        out = jax.jit(compaction.compact)(buf, jnp.asarray(keep))
        got = np.asarray(out.xyz)
        assert int(out.count) == 4
        np.testing.assert_array_equal(got[:2].view(np.uint32), xyz[:2].view(np.uint32))
        np.testing.assert_array_equal(np.asarray(out.rgba)[:4], rgba[:4])


# ---------------------------------------------------------------------------
# Column-grid exact kNN (plain XLA) vs scipy's float64 KD-tree
# ---------------------------------------------------------------------------


def _kdtree_md(pts, k):
    from scipy.spatial import cKDTree

    p = pts.astype(np.float64)
    dist, _ = cKDTree(p).query(p, k=k + 1)
    return dist[:, 1:].mean(axis=1)


class TestColsKnn:
    @pytest.mark.parametrize(
        "n,k,cap,voxel_unique",
        [
            (900, 8, 12, False),
            (300, 5, 12, False),
            (40, 30, 12, False),  # fewer than k neighbours in reach
            (2000, 12, 4, False),  # over-cap columns: dropped + fixed up
            (1500, 30, 28, True),  # the downsample postcondition
            (700, 6, 12, False),
        ],
    )
    def test_fixed_up_md_matches_kdtree(self, n, k, cap, voxel_unique):
        from cwipc_util_jax.ops.cols_knn import (
            bruteforce_md_subset,
            cols_knn_mean_distance,
        )

        rng = np.random.default_rng(n + k)
        cell = 0.02
        capn = 1 << int(np.ceil(np.log2(max(n, 2))))
        if voxel_unique:  # one point per distinct cell
            cells = rng.choice(24 * 24 * 24, size=n, replace=False)
            v = np.stack(np.unravel_index(cells, (24, 24, 24)), axis=1)
            pts = ((v + 0.1 + 0.8 * rng.random((n, 3))) * cell).astype(np.float32)
        else:
            pts = (rng.random((n, 3)) * 0.3).astype(np.float32)
        xyz = np.zeros((capn, 3), np.float32)
        xyz[:n] = pts
        x, c = jnp.asarray(xyz), jnp.int32(n)
        md, unc = cols_knn_mean_distance(
            x, c, jnp.float32(cell), k, gy=24, gz=24, cap=cap, chunk=64,
            voxel_unique=voxel_unique,
        )
        md = np.asarray(jnp.where(unc, bruteforce_md_subset(x, c, unc, k), md))
        kk = min(k, n - 1)
        if kk == k:
            np.testing.assert_allclose(md[:n], _kdtree_md(pts, k), rtol=1e-5, atol=1e-6)
        assert not md[n:].any()

    def test_far_outlier_with_clipped_origin(self):
        """A far outlier outside the grid is reported uncovered and fixed
        up exactly; the core stays in the grid (vmin_override)."""
        from cwipc_util_jax.ops.cols_knn import (
            bruteforce_md_subset,
            cols_knn_mean_distance,
        )

        rng = np.random.default_rng(3)
        n, k, cell = 800, 8, 0.02
        pts = (rng.random((n, 3)) * 0.3).astype(np.float32)
        pts[0] = (-5.0, -5.0, -5.0)
        xyz = np.zeros((1024, 3), np.float32)
        xyz[:n] = pts
        x, c = jnp.asarray(xyz), jnp.int32(n)
        md, unc = cols_knn_mean_distance(
            x, c, jnp.float32(cell), k, gy=24, gz=24, cap=12, chunk=64,
            vmin_override=jnp.zeros(3, jnp.int32),
        )
        # the dropped outlier taints the ring of border columns it clamps to
        assert bool(unc[0]) and int(unc.sum()) < n // 2
        md = np.asarray(jnp.where(unc, bruteforce_md_subset(x, c, unc, k), md))
        np.testing.assert_allclose(md[:n], _kdtree_md(pts, k), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Two-scale grid NN (ICP correspondences) vs brute force
# ---------------------------------------------------------------------------


class TestNNSearch:
    @pytest.mark.parametrize(
        "nr,nq,maxd,clump",
        [(800, 500, 0.03, False), (3000, 2000, 0.03, True),
         (400, 900, 0.05, False), (2000, 100, 0.01, True)],
    )
    def test_matches_bruteforce(self, nr, nq, maxd, clump):
        from cwipc_util_jax.ops.knn import nn_search

        rng = np.random.default_rng(nr + nq)
        rcap = 1 << int(np.ceil(np.log2(nr)))
        scap = 1 << int(np.ceil(np.log2(nq)))
        ref = np.zeros((rcap, 3), np.float32)
        qry = np.zeros((scap, 3), np.float32)
        ref[:nr] = rng.random((nr, 3), dtype=np.float32) * 0.4
        if clump:  # a dense clump: fine cells overflow, the coarse pass covers
            ref[100:200] = ref[100] + rng.random((100, 3), np.float32) * 0.001
        qry[:nq] = rng.random((nq, 3), dtype=np.float32) * 0.45 - 0.02
        d, i = nn_search(jnp.asarray(qry), jnp.int32(nq), jnp.asarray(ref),
                         jnp.int32(nr), jnp.float32(maxd))
        d, i = np.asarray(d), np.asarray(i)
        full = np.sqrt(((qry[:nq, None, :] - ref[None, :nr, :]) ** 2).sum(-1))
        best = full.min(axis=1)
        inside = best <= maxd * (1 - 1e-5)
        np.testing.assert_allclose(d[:nq][inside], best[inside], rtol=1e-5, atol=1e-6)
        found = np.isfinite(d[:nq])
        assert (found >= inside).all()
        assert (d[:nq][found] <= maxd * (1 + 1e-5)).all()
        np.testing.assert_allclose(
            full[np.arange(nq)[found], i[:nq][found]], d[:nq][found], atol=1e-6
        )
        assert not np.isfinite(d[nq:]).any() and (i[nq:] == -1).all()


# ---------------------------------------------------------------------------
# Every device program lowers for CUDA
# ---------------------------------------------------------------------------


def _bench_buf(cap=4096):
    from cwipc_util_jax.models.synthetic import _generate

    return _generate(48, 48, cap, jnp.float32(0.5))


def _lower_chain():
    from cwipc_util_jax.ops.chain import downsample_outliers_tilefilter

    f = lambda b: downsample_outliers_tilefilter(
        b, jnp.float32(0.08), k=30, mult=jnp.float32(1.0), tile=jnp.uint32(1),
        out_capacity=2048)
    return f, (_bench_buf(),)


def _lower_exact_chain():
    from cwipc_util_jax.ops.chain import downsample_outliers_tilefilter_exact

    f = lambda b: downsample_outliers_tilefilter_exact(
        b, jnp.float32(0.08), k=30, mult=jnp.float32(1.0), tile=jnp.uint32(1),
        out_capacity=2048, gy=32, gz=16, cap=28)
    return f, (_bench_buf(),)


def _lower_downsample(exact_keys, merged):
    from cwipc_util_jax.ops.voxelize import downsample

    f = lambda b: downsample(b, jnp.float32(0.08), exact_keys=exact_keys,
                             merged_exact=merged)
    return f, (_bench_buf(),)


def _lower_compact():
    b = _bench_buf()
    return (lambda b, keep: compaction.compact(b, keep)), (b, b.valid_mask())


def _lower_compact_cm():
    b = _bench_buf()
    return (lambda x, keep, c: compaction.compact_cm(x[:, 0], x[:, 1], x[:, 2],
                                                     b.rgba, keep, c)), (
        b.xyz, b.valid_mask(), b.count)


def _lower_cols_knn():
    from cwipc_util_jax.ops.cols_knn import cols_knn_mean_distance

    b = _bench_buf()
    f = lambda x, c: cols_knn_mean_distance(x, c, jnp.float32(0.08), 30, gy=32,
                                            gz=16, cap=28, voxel_unique=True)
    return f, (b.xyz, b.count)


def _lower_icp(variant):
    from cwipc_util_jax.registration.fine import _icp_fused

    b = _bench_buf()
    z = jnp.zeros_like(b.xyz)
    f = lambda s, c, n: _icp_fused(
        s, c, s, c, jnp.float32(0.05), jnp.float32(1e-6), n, n,
        jnp.float32(1e-3), variant=variant, max_iters=4)
    return f, (b.xyz, b.count, z)


def _sharded_args():
    cap = 1024
    return (jnp.zeros((2, cap, 3)), jnp.zeros((2, cap), jnp.uint32),
            jnp.zeros((2,), jnp.int32), jnp.float32(0.05), jnp.float32(1.0),
            jnp.uint32(0))


def _lower_rangemerge():
    from cwipc_util_jax.parallel.mesh import make_mesh
    from cwipc_util_jax.parallel.rangemerge import make_sharded_chain_rangemerge

    return make_sharded_chain_rangemerge(make_mesh(2), k=8), _sharded_args()


def _lower_sharded_exact():
    from cwipc_util_jax.parallel.mesh import make_mesh
    from cwipc_util_jax.parallel.pointaxis import make_sharded_chain_exact

    step = make_sharded_chain_exact(make_mesh(2), k=8, gy=32, gz=32, cap=16)
    return step, _sharded_args()


def _lower_sharded_chain():
    from cwipc_util_jax.parallel.mesh import make_mesh
    from cwipc_util_jax.parallel.pointaxis import make_sharded_chain

    return make_sharded_chain(make_mesh(2), k=8), _sharded_args()


# (builder, whether the Triton window kernel is part of the program)
LOWERINGS = {
    "fast_chain": (_lower_chain, True),
    "exact_chain": (_lower_exact_chain, False),
    "downsample": (lambda: _lower_downsample(False, False), False),
    "downsample_exact_keys": (lambda: _lower_downsample(True, False), False),
    "downsample_merged_keys": (lambda: _lower_downsample(True, True), False),
    "compact": (_lower_compact, False),
    "compact_cm": (_lower_compact_cm, False),
    "cols_knn_mean_distance": (_lower_cols_knn, False),
    "icp_p2point": (lambda: _lower_icp("p2point"), False),
    "icp_p2plane": (lambda: _lower_icp("p2plane"), False),
    "icp_gicp": (lambda: _lower_icp("gicp"), False),
    "rangemerge": (_lower_rangemerge, True),
    "sharded_chain": (_lower_sharded_chain, True),
    "sharded_chain_exact": (_lower_sharded_exact, False),
}


@pytest.mark.parametrize("name", sorted(LOWERINGS))
def test_lowers_for_cuda(name):
    build, has_kernel = LOWERINGS[name]
    f, args = build()
    text = jax.jit(f).trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    # every custom call is a CUDA one: the Triton kernel or a CUDA library
    targets = set(re.findall(r"custom_call @([\w.$]+)", text))
    assert all(t.startswith(("__gpu$", "cu")) for t in targets), targets
    assert ("__gpu$xla.gpu.triton" in targets) == has_kernel


class TestGpuDispatch:
    def test_window_md_picks_kernel_for_cuda_only(self):
        from cwipc_util_jax.ops.chain import window_mean_distance_cm

        x = jnp.zeros((2048,), jnp.float32)
        f = jax.jit(lambda x, c: window_mean_distance_cm(x, x, x, c, k=30, window=16))
        low = lambda p: f.trace(x, jnp.int32(5)).lower(lowering_platforms=(p,)).as_text()
        assert "xla.gpu.triton" in low("cuda")
        assert "triton" not in low("cpu")

    def test_public_remove_outliers_takes_column_grid_on_gpu(self, monkeypatch):
        """cwipc_remove_outliers sends a GPU backend to the column-grid
        kNN (plain XLA), the CPU backend to scipy's KD-tree."""
        import cwipc_util_jax as cwipc
        from cwipc_util_jax.ops import cols_knn

        gen = cwipc.cwipc_synthetic(0, 10000)
        gen.start()
        pc = cwipc.cwipc_downsample(gen.get(), 0.02)
        gen.stop()
        assert pc.count() > 4096
        calls = []
        real = cols_knn.cols_knn_mean_distance
        monkeypatch.setattr(cols_knn, "cols_knn_mean_distance",
                            lambda *a, **kw: (calls.append(1), real(*a, **kw))[1])
        cpu_out = cwipc.cwipc_remove_outliers(pc, 30, 1.0, False)
        assert not calls
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        gpu_out = cwipc.cwipc_remove_outliers(pc, 30, 1.0, False)
        assert calls
        # both exact: the same survivors
        a = cpu_out.get_numpy_matrix(onlyGeometry=True)
        b = gpu_out.get_numpy_matrix(onlyGeometry=True)
        assert np.array_equal(a, b)
