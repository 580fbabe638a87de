#!/usr/bin/env python3
"""Run the library's hot path once on an NVIDIA GPU and check every result
against a plain reference.

    python chip_smoke.py               # phases 0-4 on one GPU
    python chip_smoke.py --four-cards  # the mesh paths on four GPUs, each
                                       # compared with the same input on one

Phases (one GPU):

0. the card: ``nvidia-smi`` name and power limit, JAX version, devices;
1. the public API on the upstream default synthetic cloud (160k points):
   ``cwipc_downsample`` against a numpy voxel reduction,
   ``cwipc_remove_outliers`` against a float64 scipy KD-tree,
   ``cwipc_tilefilter`` against a numpy filter;
2. the fused chains at 1M points (the benchmark's shapes): the exact chain's
   keep mask against the float64 KD-tree oracle, the fast chain's window
   mean distances against a numpy reference of the same window rule, the
   Pallas window kernel against its XLA form, per-stage wall times;
3. the codec: CTC1 at octree_bits 9 / quality 85, device geometry against
   the host twin, bit for bit;
4. fine registration: ICP point-to-plane and GICP on a 3-camera synthetic
   scene, against the numpy ICP loop and the scene's ground truth.

Tolerances, each with its reason, sit next to their checks.  Any failed
check raises, so the script exits nonzero.  It exits nonzero without a
result line when JAX finds no GPU.  The last line of standard output is
one JSON object: ``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

K = 30
MULT = 1.0
WINDOW = 16
# a point whose float64 mean distance lies this close (relative) to the
# keep threshold may go either way in float32: excluded from keep-mask
# comparisons and counted
THRESHOLD_BAND = 1e-6


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def require_gpus(n: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n:
        print(f"chip_smoke: needs {n} GPU(s), JAX found {devs}", file=sys.stderr)
        sys.exit(2)
    return devs


def wall(fn, *args, reps: int = 5) -> float:
    """Median host wall time of fn(*args) in ms, each call ended by
    block_until_ready (first call excluded: compilation)."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def kdtree_mean_dist(pts64: np.ndarray, k: int) -> np.ndarray:
    from scipy.spatial import cKDTree

    dist, _ = cKDTree(pts64).query(pts64, k=k + 1, workers=-1)
    return dist[:, 1:].mean(axis=1)


def pcl_threshold(md: np.ndarray, mult: float) -> float:
    """PCL's keep threshold mu + mult * sigma, (n-1) sample variance."""
    n = len(md)
    var = ((md * md).sum() - md.sum() ** 2 / n) / max(n - 1, 1)
    return float(md.mean() + mult * np.sqrt(max(var, 0.0)))


def row_set(xyz: np.ndarray) -> set:
    return {r.tobytes() for r in np.ascontiguousarray(xyz, np.float32)}


def voxel_keys(xyz: np.ndarray, cell: float) -> set:
    inv = np.float32(1.0) / np.float32(cell)
    return {tuple(k) for k in np.floor(xyz * inv).astype(np.int64)}


def check_keep(name: str, pts: np.ndarray, got: np.ndarray, md: np.ndarray,
               thr: float, key=row_set) -> None:
    """The survivors ``got`` must be exactly pts[md <= thr], except points
    inside the threshold band, which may go either way.  ``key`` maps rows
    to the identities compared (the rows' bits by default)."""
    band = np.abs(md - thr) <= THRESHOLD_BAND * abs(thr)
    want = key(pts[(md <= thr) & ~band])
    maybe = key(pts[band])
    got_s = key(got)
    missing = want - got_s
    extra = got_s - want - maybe
    log(f"{name}: {len(got_s)} kept, oracle {len(want)} certain + "
        f"{len(maybe)} within {THRESHOLD_BAND:g} of the threshold; "
        f"missing {len(missing)}, extra {len(extra)}")
    assert not missing and not extra, f"{name}: keep mask differs from oracle"


def voxel_reference(xyz: np.ndarray, rgb: np.ndarray, tile: np.ndarray,
                    cell: float):
    """numpy voxel reduction: keys as the device quantizes them (float32
    xyz * float32(1/cell), floored), per-voxel means and tile OR."""
    inv = np.float32(1.0) / np.float32(cell)
    keys = np.floor(xyz.astype(np.float32) * inv).astype(np.int64)
    uniq, inv_idx, counts = np.unique(
        keys, axis=0, return_inverse=True, return_counts=True
    )
    inv_idx = inv_idx.ravel()
    mean = np.zeros((len(uniq), 3))
    np.add.at(mean, inv_idx, xyz.astype(np.float64))
    mean /= counts[:, None]
    col = np.zeros((len(uniq), 3))
    np.add.at(col, inv_idx, rgb.astype(np.float64))
    col = np.floor(col / counts[:, None])
    tor = np.zeros(len(uniq), np.int64)
    np.bitwise_or.at(tor, inv_idx, tile.astype(np.int64))
    return uniq, mean, col, tor


def check_voxels(name: str, xyz, rgb, tile, oxyz, ocol, otile,
                 cell: float) -> str:
    """The downsample's output (oxyz, ocol, otile) against voxel_reference
    of its input; returns the summary for the log."""
    uniq, mean, col, tor = voxel_reference(xyz, rgb, tile, cell)
    inv = np.float32(1.0) / np.float32(cell)
    okeys = np.floor(oxyz * inv).astype(np.int64)
    order = np.lexsort(okeys.T[::-1])
    okeys, oxyz, ocol, otile = okeys[order], oxyz[order], ocol[order], otile[order]
    # the voxel SET, the tile OR and the truncated mean colors are exact:
    # the device sums colors and counts in int32
    assert len(okeys) == len(uniq), (name, len(okeys), len(uniq))
    assert np.array_equal(okeys, uniq), f"{name}: voxel set differs"
    assert np.array_equal(otile.astype(np.int64), tor), f"{name}: tile OR differs"
    assert np.array_equal(ocol.astype(np.float64), col), f"{name}: colors differ"
    # centroids: each point's in-voxel offset is carried in 10 bits
    # (truncated, then centered: <= cell/2048 per point, so on the mean;
    # a voxel of one point truncated by almost a step comes close to it).
    # The offsets are summed exactly (int32, any order); float32 rounds
    # x * (1/cell), 1/cell itself, v + frac and the product with cell, each
    # by at most half an ulp (2^-24 relative) of the largest coordinate,
    # and the mean offset by half an ulp of one cell
    cerr = np.abs(oxyz - mean).max()
    ctol = cell / 2048 + 4 * 2.0**-24 * np.abs(xyz).max() + cell * 2.0**-25
    assert cerr <= ctol, f"{name}: centroid error {cerr:.3g} > {ctol:.3g}"
    return (f"voxel set, colors and tile OR exact ({len(uniq)} voxels), "
            f"centroid max err {cerr:.3g} (tol {ctol:.3g})")


# ---------------------------------------------------------------------------
# Phase 1: the public API
# ---------------------------------------------------------------------------


def phase1(npoints: int = 160000, voxel: float = 0.008) -> None:
    import cwipc_util_jax as cwipc

    gen = cwipc.cwipc_synthetic(0, npoints)
    gen.start()
    pc = gen.get()
    gen.stop()
    t0 = time.perf_counter()
    down = cwipc.cwipc_downsample(pc, voxel)
    n_down = down.count()
    t_down = (time.perf_counter() - t0) * 1e3
    src = pc.get_numpy_array()
    xyz = np.stack([src["x"], src["y"], src["z"]], axis=1)
    rgb = np.stack([src["r"], src["g"], src["b"]], axis=1)
    out = down.get_numpy_array()
    oxyz = np.stack([out["x"], out["y"], out["z"]], axis=1)
    ocol = np.stack([out["r"], out["g"], out["b"]], axis=1)
    # the wrapper raises the cell to the cloud's own cellsize when that is
    # larger (upstream semantics); the output carries the cell it used
    cerr = check_voxels("phase1 downsample", xyz, rgb, src["tile"], oxyz,
                        ocol, out["tile"], down.cellsize())
    log(f"phase1 downsample: {npoints} -> {n_down} voxels in {t_down:.1f} ms"
        f" (first call, compile included); {cerr}")

    t0 = time.perf_counter()
    clean = cwipc.cwipc_remove_outliers(down, K, MULT, False)
    n_clean = clean.count()
    t_ro = (time.perf_counter() - t0) * 1e3
    pts = down.get_numpy_matrix(onlyGeometry=True)
    md = kdtree_mean_dist(pts.astype(np.float64), K)
    thr = pcl_threshold(md, MULT)
    log(f"phase1 remove_outliers(k={K}, {MULT}): {n_down} -> {n_clean} in "
        f"{t_ro:.1f} ms (first call)")
    check_keep("phase1 remove_outliers vs float64 KD-tree", pts,
               clean.get_numpy_matrix(onlyGeometry=True), md, thr)

    part = cwipc.cwipc_tilefilter(clean, 1)
    cl = clean.get_numpy_array()
    want = cl[cl["tile"] == 1]
    got = part.get_numpy_array()
    assert np.array_equal(got, want), "tilefilter differs from numpy"
    log(f"phase1 tilefilter(1): {n_clean} -> {part.count()}, equal to numpy")


# ---------------------------------------------------------------------------
# Phase 2: the fused chains
# ---------------------------------------------------------------------------


def window_md_numpy(x, y, z, n: int, k: int, window: int) -> np.ndarray:
    """The window rule of ops/outliers.py in float64: the mean of the k
    smallest distances among the +/-window array neighbours."""
    p = np.stack([x[:n], y[:n], z[:n]], axis=1).astype(np.float64)
    offs = [w for w in range(-window, window + 1) if w != 0]
    d = np.full((len(offs), n), np.inf)
    for i, w in enumerate(offs):
        lo, hi = max(0, -w), min(n, n - w)
        d[i, lo:hi] = np.sqrt(((p[lo:hi] - p[lo + w:hi + w]) ** 2).sum(1))
    kk = min(k, 2 * window)
    sm = np.sort(d, axis=0)[:kk]
    return np.where(np.isfinite(sm), sm, 0.0).sum(axis=0) / kk


def phase2(hsteps: int = 1000, capacity: int = 1 << 20,
           out_capacity: int = 229376, gy: int = 504, gz: int = 152,
           cap: int = 28) -> None:
    import jax
    import jax.numpy as jnp

    from cwipc_util_jax.models.synthetic import _generate
    from cwipc_util_jax.ops import compaction, outliers, voxelize
    from cwipc_util_jax.ops.chain import (
        downsample_outliers_tilefilter,
        downsample_outliers_tilefilter_exact,
        window_mean_distance_cm,
    )

    n_points = hsteps * hsteps
    buf = _generate(hsteps, hsteps, capacity, jnp.float32(0.5))
    cell = jnp.float32(2.0 / hsteps * 2.0)
    mult = jnp.float32(MULT)
    tile = jnp.uint32(0)
    ocap = out_capacity

    down = jax.jit(lambda b: voxelize.downsample_cm(b, cell, ocap))
    md_kernel = jax.jit(
        lambda x, y, z, c: window_mean_distance_cm(x, y, z, c, k=K, window=WINDOW)
    )
    md_xla = jax.jit(lambda x, y, z, c: outliers._mean_knn_dist_window(
        jnp.stack([x, y, z], axis=-1), c, k=K, window=WINDOW))

    def keep_of(md, c):
        valid = jnp.arange(ocap, dtype=jnp.int32) < c
        return outliers._keep_from_mean_dists(md, valid, mult)

    compact = jax.jit(lambda x, y, z, rgba, md, c: compaction.compact_cm(
        x, y, z, rgba, keep_of(md, c), c))

    def fast(b):
        return downsample_outliers_tilefilter(
            b, cell, k=K, mult=mult, tile=tile, out_capacity=ocap)

    @jax.jit
    def fast_xla_twin(b):
        x, y, z, rgba, c = voxelize.downsample_cm(b, cell, ocap)
        return compaction.compact_cm(
            x, y, z, rgba, keep_of(md_xla(x, y, z, c), c), c)

    def exact(b):
        return downsample_outliers_tilefilter_exact(
            b, cell, k=K, mult=mult, tile=tile, out_capacity=ocap,
            gy=gy, gz=gz, cap=cap)

    # which sort XLA chose for the Morton sort
    hlo = down.lower(buf).compile().as_text()
    radix = "DeviceRadixSort" in hlo or "cub" in hlo.lower()
    log("phase2 morton sort: " + ("CUB radix sort (custom call)" if radix
                                   else "XLA comparison sort"))
    # the Pallas kernel is in the chain's program (on the GPU; a rehearsal
    # on the CPU lowers the XLA form)
    if jax.devices()[0].platform == "gpu":
        assert "xla.gpu.triton" in jax.jit(fast).lower(buf).as_text(), \
            "window kernel missing from chain"

    ex_c = jax.jit(exact).lower(buf).compile()
    ma = ex_c.memory_analysis()
    log("phase2 exact chain memory_analysis: "
        f"temp {ma.temp_size_in_bytes / 2**20:.1f} MiB, "
        f"arguments {ma.argument_size_in_bytes / 2**20:.1f} MiB, "
        f"output {ma.output_size_in_bytes / 2**20:.1f} MiB")

    x, y, z, rgba, c = down(buf)
    n = int(c)
    # the downsample at 1M points against numpy, and run to run: its sums
    # are integer, so a second run gives the same bits
    again = down(buf)
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip((x, y, z, rgba, c), again)), \
        "downsample not reproducible"
    src_rgba = np.asarray(buf.rgba)[:n_points].astype(np.int64)
    orgba = np.asarray(rgba)[:n].astype(np.int64)
    channels = lambda u: np.stack([(u >> 16) & 0xFF, (u >> 8) & 0xFF, u & 0xFF],
                                  axis=1)
    summary = check_voxels(
        "phase2 downsample", np.asarray(buf.xyz)[:n_points],
        channels(src_rgba), (src_rgba >> 24) & 0xFF,
        np.stack([np.asarray(a)[:n] for a in (x, y, z)], axis=1),
        channels(orgba), (orgba >> 24) & 0xFF, float(cell))
    log(f"phase2 downsample: {n_points} -> {n}, bit-identical on a second "
        f"run; {summary}")
    md_k = md_kernel(x, y, z, c)
    md_x = md_xla(x, y, z, c)
    xs, ys, zs = (np.asarray(a) for a in (x, y, z))
    md_ref = window_md_numpy(xs, ys, zs, n, K, WINDOW)
    mk, mx = np.asarray(md_k)[:n], np.asarray(md_x)[:n]
    # float32 distances (squared-difference rounding) against float64,
    # summed over k terms in another order: 1e-5 relative
    err_ref = np.abs(mk - md_ref).max() / md_ref.max()
    err_xla = np.abs(mk - mx).max() / md_ref.max()
    log(f"phase2 window md ({n} points): Pallas kernel vs float64 numpy "
        f"max rel err {err_ref:.3g} (tol 1e-5); vs XLA form {err_xla:.3g} "
        "(tol 1e-5, float32 summation order)")
    assert err_ref <= 1e-5 and err_xla <= 1e-5
    assert not np.asarray(md_k)[n:].any()

    # fast chain survivors against the numpy window rule's keep decision,
    # compared by their coordinates' bits (the chain's own downsample gives
    # the bits checked above)
    pts = np.stack([xs[:n], ys[:n], zs[:n]], axis=1)
    fout = fast(buf)
    nf = int(fout.count)
    check_keep("phase2 fast chain vs float64 window rule", pts,
               np.asarray(fout.xyz)[:nf], md_ref, pcl_threshold(md_ref, MULT))

    # exact chain survivors against the float64 KD-tree
    eout, resid = ex_c(buf)
    ne = int(eout.count)
    md64 = kdtree_mean_dist(pts.astype(np.float64), K)
    check_keep("phase2 exact chain vs float64 KD-tree", pts,
               np.asarray(eout.xyz)[:ne], md64, pcl_threshold(md64, MULT))
    vkey = lambda a: voxel_keys(a, float(cell))
    fs, es = vkey(np.asarray(fout.xyz)[:nf]), vkey(np.asarray(eout.xyz)[:ne])
    log(f"phase2 fast vs exact voxel-set agreement: "
        f"{100.0 * (n - len(fs ^ es)) / n:.2f}% of {n} decisions "
        f"(exact chain brute-force fixups: {int(resid)})")

    stages = {
        "downsample (Morton sort + segment reduce)": (down, buf),
        "window md, Pallas kernel": (md_kernel, x, y, z, c),
        "window md, XLA form": (md_xla, x, y, z, c),
        "compaction (sort form)": (compact, x, y, z, rgba, md_k, c),
        "fast chain, Pallas window kernel": (jax.jit(fast), buf),
        "fast chain, XLA window form": (fast_xla_twin, buf),
        "exact chain (column-grid kNN, XLA)": (ex_c, buf),
    }
    for name, (fn, *args) in stages.items():
        log(f"phase2 stage {name}: {wall(fn, *args):.3f} ms "
            f"({n_points} input points, median of 5)")


# ---------------------------------------------------------------------------
# Phase 3: the codec
# ---------------------------------------------------------------------------


def phase3(npoints: int = 160000) -> None:
    import struct

    import cwipc_util_jax as cwipc
    from cwipc_util_jax import codec

    gen = cwipc.cwipc_synthetic(0, npoints)
    gen.start()
    pc = gen.get()
    gen.stop()
    blobs = {}
    for mode, name in (("0", "device"), ("1", "host")):
        os.environ["CWIPC_CODEC_HOST"] = mode
        enc = codec.cwipc_new_encoder(
            params=codec.cwipc_encoder_params(octree_bits=9, jpeg_quality=85))
        enc.feed(pc)
        blobs[name] = enc.get_bytes()
        t = wall(lambda: (enc.feed(pc), enc.get_bytes())[1], reps=5)
        log(f"phase3 encode ({name} geometry): {len(blobs[name])} bytes, "
            f"{t:.2f} ms median of 5")
    del os.environ["CWIPC_CODEC_HOST"]
    assert blobs["device"] == blobs["host"], "device geometry differs from host"
    hdr = struct.unpack(codec._HDR_FMT, blobs["device"][:struct.calcsize(codec._HDR_FMT)])
    flags, m = hdr[2], hdr[4]
    jpeg = bool(flags & codec._FLAG_JPEG)
    dec = codec.cwipc_new_decoder()
    dec.feed(blobs["device"])
    out = dec.get()
    assert out is not None and out.count() == m
    log(f"phase3 codec: device and host geometry bit-identical, {m} voxels; "
        "color plane: " + ("JPEG (cv2)" if jpeg else
                           "lossless zlib (cv2 missing or JPEG not smaller)"))


# ---------------------------------------------------------------------------
# Phase 4: fine registration
# ---------------------------------------------------------------------------


def phase4(npoints: int = 90000, ref_points: int = 160000) -> None:
    import cwipc_util_jax as cwipc
    from cwipc_util_jax.filters.simulatecams import SimulatecamsFilter
    from cwipc_util_jax.registration.fine import (
        RegistrationComputer_ICP_Generalized,
        RegistrationComputer_ICP_Point2Plane,
    )
    from cwipc_util_jax.registration.util import (
        cwipc_transform,
        transformation_compare,
    )

    def synthetic(n):
        gen = cwipc.cwipc_synthetic(0, n)
        gen.start()
        pc = gen.get()
        gen.stop()
        return pc

    # three cameras of npoints/3 each; the reference body is sampled on
    # other rings, so no rotation maps a view exactly onto reference
    # points (the body is a surface of revolution: with shared samples a
    # ring-step rotation would be an equally perfect alias of the truth)
    scene = SimulatecamsFilter(3, hard=True).filter(synthetic(npoints))
    ref = synthetic(ref_points)
    c, s = np.cos(0.03), np.sin(0.03)
    true_T = np.array([[1, 0, 0, 0.01], [0, c, -s, 0.005],
                       [0, s, c, -0.008], [0, 0, 0, 1.0]])
    for cam in range(3):
        view = cwipc.cwipc_tilefilter(scene, 1 << cam)
        moved = cwipc_transform(view, true_T)
        for cls in (RegistrationComputer_ICP_Point2Plane,
                    RegistrationComputer_ICP_Generalized):
            poses, t_fused = {}, []
            # the fused program twice (the second run is compiled), then
            # the numpy loop
            for fused in ("1", "1", "0"):
                os.environ["CWIPC_FUSED_ICP"] = fused
                al = cls()
                al.set_source_pointcloud(moved)
                al.set_reference_pointcloud(ref)
                al.set_correspondence(0.05)
                t0 = time.perf_counter()
                assert al.run()
                poses[fused] = al.get_result_transformation()
                if fused == "1":
                    t_fused.append((time.perf_counter() - t0) * 1e3)
            del os.environ["CWIPC_FUSED_ICP"]
            # tolerances of tests/test_registration.py.  The body is a
            # surface of revolution about the y axis, so a rotation about
            # that axis is unobservable: the residual is compared with the
            # nearest such rotation
            res = poses["1"] @ true_T
            th = np.arctan2(res[0, 2], res[0, 0])
            sym = np.identity(4)
            sym[[0, 0, 2, 2], [0, 2, 0, 2]] = (np.cos(th), np.sin(th),
                                               -np.sin(th), np.cos(th))
            gt_t, gt_r = transformation_compare(res, sym)
            fh_t, fh_r = transformation_compare(poses["1"], poses["0"])
            log(f"phase4 camera {cam} ({view.count()} pts) {cls.__name__}: "
                f"fused {t_fused[0]:.0f} ms first run (compile included), "
                f"{t_fused[1]:.0f} ms second run; vs "
                f"ground truth (modulo the y-axis symmetry, {th:+.3f} rad) "
                f"dt {gt_t:.2e} (tol 4e-3) dr {gt_r:.2e} (tol "
                f"2e-2); vs numpy ICP loop dt {fh_t:.2e} (tol 1e-3) dr "
                f"{fh_r:.2e} (tol 5e-3)")
            assert gt_t < 0.004 and gt_r < 0.02, "pose off the ground truth"
            assert fh_t < 1e-3 and fh_r < 5e-3, "fused pose off the numpy loop"


# ---------------------------------------------------------------------------
# --four-cards: the mesh paths, each against one card
# ---------------------------------------------------------------------------


def four_cards(hsteps: int = 1000, cam_points: int = 160000,
               gy: int = 504, gz: int = 152, cap: int = 28,
               reg_points: int = 30000) -> None:
    import jax
    import jax.numpy as jnp

    from cwipc_util_jax.core.buffers import PointBuffer, bucket_capacity
    from cwipc_util_jax.models.synthetic import _generate
    from cwipc_util_jax.ops import compaction, voxelize
    from cwipc_util_jax.ops.chain import (
        downsample_outliers_tilefilter,
        downsample_outliers_tilefilter_exact,
    )
    from cwipc_util_jax.parallel.fusion import _local_clean, make_fusion_step
    from cwipc_util_jax.parallel.mesh import camera_sharding, make_mesh
    from cwipc_util_jax.parallel.pointaxis import sharded_chain, sharded_chain_exact
    from cwipc_util_jax.parallel.rangemerge import sharded_chain_rangemerge
    from cwipc_util_jax.parallel.registration import (
        pack_camera_views,
        sharded_camera_align,
    )
    from cwipc_util_jax.registration.fine import _icp_fused

    mesh = make_mesh(4)
    d = 4

    def parity(name, got, want, slack, t_mesh, t_one):
        diff = len(got ^ want)
        log(f"four-cards {name}: {len(got)} voxels on 4 cards vs {len(want)} "
            f"on one, symmetric difference {diff} (allowed {slack}); "
            f"{t_mesh:.1f} ms vs {t_one:.1f} ms (first call, compile "
            "included)")
        assert diff <= slack, f"{name} diverges from one card"

    def timed(fn):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        return out, (time.perf_counter() - t0) * 1e3

    # camera fusion: 4 synthetic cameras of 160k points, one per card
    side = int(np.sqrt(cam_points))
    ccap = bucket_capacity(side * side)
    cams = [_generate(side, side, ccap, jnp.float32(0.1 * i)) for i in range(d)]
    xyz = np.stack([np.asarray(b.xyz) for b in cams])
    rgba = np.stack([np.asarray(b.rgba) for b in cams])
    cnt = np.stack([np.asarray(b.count) for b in cams])
    fcell, fk, fmult = 0.008, 12, 2.0
    sh = camera_sharding(mesh)
    step = make_fusion_step(mesh, k=fk, cell_cap=32)
    fused, t_mesh = timed(lambda: step(
        jax.device_put(xyz, sh), jax.device_put(rgba, sh),
        jax.device_put(cnt, sh), jnp.float32(fcell), jnp.float32(fmult)))

    @jax.jit
    def one_card(xyz, rgba, cnt):
        parts = [_local_clean(xyz[i], rgba[i], cnt[i], jnp.float32(fcell), fk,
                              jnp.float32(fmult), 32) for i in range(d)]
        flat = PointBuffer(
            xyz=jnp.concatenate([p.xyz for p in parts]),
            rgba=jnp.concatenate([p.rgba for p in parts]),
            count=jnp.asarray(d * ccap, jnp.int32),
        )
        slot = jnp.arange(ccap, dtype=jnp.int32)
        mask = jnp.concatenate([slot < p.count for p in parts])
        return voxelize.downsample(compaction.compact(flat, mask), jnp.float32(fcell))

    ref, t_one = timed(lambda: one_card(jnp.asarray(xyz), jnp.asarray(rgba),
                                        jnp.asarray(cnt)))
    nf, nr = int(fused.count), int(ref.count)
    got, want = (voxel_keys(np.asarray(fused.xyz)[:nf], fcell),
                 voxel_keys(np.asarray(ref.xyz)[:nr], fcell))
    # the mesh program and the one-card program are compiled apart, and XLA
    # may order their float32 reductions (the outlier statistics) apart, so
    # a few threshold-adjacent keep decisions may differ
    parity(f"fusion (4 x {side * side} point cameras)", got, want,
           max(2, nr // 100),
           t_mesh, t_one)

    # point-axis sharded chains on the 1M benchmark cloud
    big = _generate(hsteps, hsteps, 1 << 20, jnp.float32(0.5))
    cell = 2.0 / hsteps * 2.0
    n_keys = lambda out: voxel_keys(np.asarray(out.xyz)[:int(out.count)], cell)
    single, t_one = timed(lambda: downsample_outliers_tilefilter(
        big, jnp.float32(cell), k=K, mult=jnp.float32(MULT), tile=jnp.uint32(0)))
    want = n_keys(single)
    got, t_mesh = timed(lambda: sharded_chain(mesh, big, cell, k=K, mult=MULT,
                                              tile=0, window=WINDOW))
    # the shards' partial voxels merge as means of means, so md and the
    # threshold move in the last bits: threshold-adjacent voxels may flip
    label = f"({hsteps * hsteps} points)"
    parity(f"sharded_chain {label}", n_keys(got), want, max(2, len(want) // 100),
           t_mesh, t_one)
    (got, flags), t_mesh = timed(lambda: sharded_chain_rangemerge(
        mesh, big, cell, k=K, mult=MULT, tile=0, window=WINDOW))
    assert int(flags) == 0, f"rangemerge flags {int(flags)}"
    parity(f"sharded_chain_rangemerge {label}", n_keys(got), want,
           max(2, len(want) // 50), t_mesh, t_one)
    (single, _r), t_one = timed(lambda: downsample_outliers_tilefilter_exact(
        big, jnp.float32(cell), k=K, mult=jnp.float32(MULT), tile=jnp.uint32(0),
        out_capacity=big.capacity, gy=gy, gz=gz, cap=cap))
    got, t_mesh = timed(lambda: sharded_chain_exact(
        mesh, big, cell, k=K, gy=gy, gz=gz, cap=cap, mult=MULT, tile=0))
    want = n_keys(single)
    parity(f"sharded_chain_exact {label}", n_keys(got), want,
           max(2, len(want) // 100), t_mesh, t_one)

    # per-camera registration: 4 views of 30k points, one per card
    rng = np.random.default_rng(7)
    base = rng.normal(size=(d * reg_points, 3)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    base *= 0.5
    views = [base[i::d] + 0.004 * rng.standard_normal(3).astype(np.float32)
             for i in range(d)]
    s_xyz, s_cnt, r_xyz, r_cnt = pack_camera_views(views)
    corr = 0.05
    poses, t_mesh = timed(lambda: sharded_camera_align(
        mesh, jnp.asarray(s_xyz), jnp.asarray(s_cnt), jnp.asarray(r_xyz),
        jnp.asarray(r_cnt), corr, max_iters=8))
    poses = np.asarray(poses)
    worst = 0.0
    t0 = time.perf_counter()
    for i in range(d):
        T1 = np.asarray(_icp_fused(
            jnp.asarray(s_xyz[i]), jnp.int32(s_cnt[i]), jnp.asarray(r_xyz[i]),
            jnp.int32(r_cnt[i]), jnp.float32(corr), jnp.float32(1e-6),
            jnp.zeros((r_xyz.shape[1], 3), jnp.float32),
            jnp.zeros((s_xyz.shape[1], 3), jnp.float32), jnp.float32(1e-3),
            variant="p2point", max_iters=8))
        worst = max(worst, float(np.abs(T1 - poses[i]).max()))
        assert abs(poses[i][:3, 3]).max() < 0.05
    t_one = (time.perf_counter() - t0) * 1e3
    # float32 reductions may be ordered differently per card: 1e-4
    log(f"four-cards sharded_camera_align (4 x {reg_points} pts): max pose "
        f"element diff vs one card {worst:.2e} (tol 1e-4); {t_mesh:.1f} ms "
        f"vs {t_one:.1f} ms (first call, compile included)")
    assert worst <= 1e-4, "per-camera pose diverges from one card"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run the mesh paths on four GPUs, each against one")
    args = ap.parse_args()
    n_cards = 4 if args.four_cards else 1
    devs = require_gpus(n_cards)
    import jax

    import cwipc_util_jax  # noqa: F401  (enables the compile cache)

    log(card_line())
    log("jax", jax.__version__, "devices:", devs)
    t0 = time.perf_counter()
    phases = ((four_cards,) if args.four_cards
              else (phase1, phase2, phase3, phase4))
    for ph in phases:
        t = time.perf_counter()
        ph()
        log(f"{ph.__name__} ok in {time.perf_counter() - t:.1f} s")
    log(f"all phases ok in {time.perf_counter() - t0:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
