"""GPU-marked regression subset: the device paths on an NVIDIA GPU.

The main suite is pinned to CPU (tests/conftest.py); this module opts back
in with explicit device placement and runs the paths whose GPU lowering
differs from the CPU one — the Pallas (Triton) window-kNN kernel, the
GPU sort and segment sums — against the CPU results and plain oracles.

Run on a machine with a GPU, with both backends visible:

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_gpu_smoke.py -m gpu

Every test skips when no GPU is present.  chip_smoke.py drives the same
paths at full size through the public entry points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("no GPU (run with JAX_PLATFORMS=cuda,cpu on a GPU host)")
    return gpus[0]


def _random_cloud(n, seed=0, tile=1):
    import cwipc_util_jax as cwipc

    rng = np.random.default_rng(seed)
    pts = [
        (float(x), float(y), float(z), 128, 64, 32, tile)
        for x, y, z in rng.random((n, 3))
    ]
    return cwipc.cwipc_from_points(pts, 0)


def _on(buf, dev):
    from cwipc_util_jax.core.buffers import PointBuffer

    return PointBuffer(
        xyz=jax.device_put(buf.xyz, dev),
        rgba=jax.device_put(buf.rgba, dev),
        count=jax.device_put(buf.count, dev),
    )


def _oracle_keep(pts, k, mult):
    from scipy.spatial import cKDTree

    dist, _ = cKDTree(pts).query(pts, k=k + 1, workers=-1)
    md = dist[:, 1:].mean(axis=1)
    var = ((md * md).sum() - md.sum() ** 2 / len(md)) / (len(md) - 1)
    return md <= md.mean() + mult * np.sqrt(max(var, 0.0))


@pytest.mark.parametrize("n", [50, 300, 1500])
def test_small_cloud_downsample_gpu_matches_cpu(gpu, n):
    """The GPU downsample (sort + integer segment sums) yields the CPU
    result: the same voxels in the same order, colors and tiles exact,
    centroids to float32 rounding."""
    from cwipc_util_jax.ops.voxelize import downsample

    buf = _random_cloud(n)._access_buffer()
    cellsize = jnp.float32(0.1)
    cpu_out = downsample(buf, cellsize)  # default device is CPU in tests
    gpu_out = downsample(_on(buf, gpu), jax.device_put(cellsize, gpu))
    nc, ng = int(cpu_out.count), int(gpu_out.count)
    assert nc == ng
    np.testing.assert_allclose(
        np.asarray(gpu_out.xyz[:ng]), np.asarray(cpu_out.xyz[:nc]),
        rtol=1e-6, atol=1e-7,
    )
    assert np.array_equal(np.asarray(gpu_out.rgba[:ng]), np.asarray(cpu_out.rgba[:nc]))
    tiles = (np.asarray(gpu_out.rgba[:ng]) >> 24) & 0xFF
    assert (tiles == 1).all()


def test_small_cloud_fused_chain_gpu(gpu):
    """The fused chain on a 300-point cloud, below one kernel block:
    the same survivors as the CPU's XLA window form (float32 sums in
    another order can only move points at the threshold)."""
    from cwipc_util_jax.ops.chain import downsample_outliers_tilefilter

    buf = _random_cloud(300)._access_buffer()
    args = dict(k=4, mult=jnp.float32(3.0), tile=jnp.uint32(0))
    cpu_out = downsample_outliers_tilefilter(buf, jnp.float32(0.05), **args)
    out = downsample_outliers_tilefilter(
        _on(buf, gpu), jax.device_put(jnp.float32(0.05), gpu), **args
    )
    n = int(out.count)
    assert 0 < n <= 300 and abs(n - int(cpu_out.count)) <= 1
    assert bool(jnp.isfinite(out.xyz[:n]).all())


def test_window_kernel_matches_xla_form_on_gpu(gpu):
    """The compiled Triton kernel against the XLA form at a real width."""
    from cwipc_util_jax.ops import outliers
    from cwipc_util_jax.ops.pallas_window_knn import window_knn_mean_distance_cm

    rng = np.random.default_rng(2)
    cap, n = 1 << 18, 250000
    xyz = np.sort(rng.random((cap, 3), dtype=np.float32), axis=0)
    x = jax.device_put(jnp.asarray(xyz), gpu)
    c = jax.device_put(jnp.int32(n), gpu)
    got = np.asarray(window_knn_mean_distance_cm(x[:, 0], x[:, 1], x[:, 2], c, 30))
    ref = np.asarray(outliers._mean_knn_dist_window(x, c, 30, window=16))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


def test_public_downsample_small_cloud_on_gpu_default(gpu):
    """The public wrapper path with the GPU as default device."""
    import cwipc_util_jax as cwipc

    pc = _random_cloud(300)
    with jax.default_device(gpu):
        out = cwipc.cwipc_downsample(pc, 0.1)
        assert 0 < out.count() <= 300


def test_exact_chain_keep_mask_matches_oracle_on_bench_cloud(gpu):
    """On the 1M-point bench cloud the exact-outlier chain's survivors are
    the float64 KD-tree oracle's, voxel for voxel."""
    from cwipc_util_jax.models.synthetic import _generate
    from cwipc_util_jax.ops.chain import downsample_outliers_tilefilter_exact
    from cwipc_util_jax.ops.voxelize import downsample

    hsteps = 1000
    out_capacity = 229376
    cellsize = jnp.float32(2.0 / hsteps * 2.0)
    k, mult = 30, np.float32(1.0)

    with jax.default_device(gpu):
        buf = _generate(hsteps, hsteps, 1 << 20, jnp.float32(0.5))
        out, resid = downsample_outliers_tilefilter_exact(
            buf, cellsize, k=k, mult=jnp.float32(mult), tile=jnp.uint32(0),
            out_capacity=out_capacity, gy=504, gz=152, cap=28,
        )
        n_out = int(out.count)
        got_xyz = np.asarray(out.xyz[:n_out])
        down = downsample(buf, cellsize, out_capacity=out_capacity)
        pts = np.asarray(down.xyz[: int(down.count)]).astype(np.float64)

    keep = _oracle_keep(pts, k, mult)
    assert n_out == keep.sum(), (n_out, keep.sum(), int(resid))
    # same SET of survivors, not just the same count
    kept_ref = pts[keep].astype(np.float32)
    a = kept_ref[np.lexsort(kept_ref.T)]
    b = got_xyz[np.lexsort(got_xyz.T)]
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_public_remove_outliers_exact_on_gpu(gpu):
    """The public op's GPU path (column-grid kNN with percentile-clipped
    grid) matches the host KD-tree oracle."""
    import cwipc_util_jax as cwipc

    with jax.default_device(gpu):
        gen = cwipc.cwipc_synthetic(0, 40000)
        gen.start()
        pc = gen.get()
        gen.stop()
        down = cwipc.cwipc_downsample(pc, 0.008)
        assert down.count() > 4096  # the cols path, not the brute-force one
        clean = cwipc.cwipc_remove_outliers(down, 30, 1.0, False)
        kept = clean.count()
    pts = down.get_numpy_matrix(onlyGeometry=True).astype(np.float64)
    assert kept == int(_oracle_keep(pts, 30, 1.0).sum())


def test_registration_icp_on_gpu(gpu):
    """Fine registration with the GPU as default device recovers a small
    known transform."""
    import cwipc_util_jax as cwipc
    from cwipc_util_jax.registration.fine import RegistrationComputer_ICP_Point2Point
    from cwipc_util_jax.registration.util import (
        cwipc_transform,
        transformation_compare,
        transformation_identity,
    )

    rng = np.random.default_rng(4)
    npts = 3000
    # a bumpy sheet: enough structure for p2point to lock all 6 DoF
    xy = rng.random((npts, 2)) * 0.5
    z = 0.05 * np.sin(xy[:, 0] * 20) + 0.05 * np.cos(xy[:, 1] * 17)
    m = np.zeros((npts, 7))
    m[:, 0] = xy[:, 0]
    m[:, 1] = 1.0 + z
    m[:, 2] = xy[:, 1]
    ref = cwipc.cwipc_from_numpy_matrix(m, 0)
    c, s = np.cos(0.03), np.sin(0.03)
    true_T = np.array(
        [[c, 0, s, 0.01], [0, 1, 0, 0.005], [-s, 0, c, -0.008], [0, 0, 0, 1]]
    )
    moved = cwipc_transform(ref, true_T)

    with jax.default_device(gpu):
        aligner = RegistrationComputer_ICP_Point2Point()
        aligner.max_iterations = 15
        aligner.set_source_pointcloud(moved)
        aligner.set_reference_pointcloud(ref)
        aligner.set_correspondence(0.05)
        assert aligner.run()
        est = aligner.get_result_transformation()

    dt, dr = transformation_compare(est @ true_T, transformation_identity())
    assert dt < 0.004, f"translation residual {dt}"
    assert dr < 0.02, f"rotation residual {dr}"
