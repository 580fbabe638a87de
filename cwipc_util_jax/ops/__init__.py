"""Point-cloud operators on wrapper objects — the reference op API.

This module is the public op surface matching the reference's module-level
functions (reference: python/cwipc/util.py:1284-1332, implemented natively in
src/cwipc_filters.cpp).  Each op takes and returns
:class:`~cwipc_util_jax.core.pointcloud.cwipc_pointcloud_wrapper` host
objects; the compute runs on device via the kernels in the sibling modules.

Timestamp/cellsize bookkeeping preserved from the reference:

* downsample: result cellsize = max(input cellsize, requested |cellsize|)
  (cwipc_filters.cpp:103-106); negative cellsize selects the plain
  voxel-grid variant (same math here; the octree split of the default path
  is a PCL work-chunking artifact — see ops/voxelize.py).
* tilefilter/tilemap/crop/colormap/remove_outliers: timestamp and cellsize
  pass through.
* join: timestamp and cellsize are the minima of the inputs
  (cwipc_filters.cpp:411-414).
"""

from __future__ import annotations

import functools
from typing import Dict, Iterable, List, Union

import jax.numpy as jnp
import numpy as np

from ..core.buffers import bucket_capacity
from ..core.errors import CwipcError
from ..core.pointcloud import cwipc_pointcloud_wrapper
from . import compaction, outliers, voxelize

__all__ = [
    "cwipc_downsample",
    "cwipc_remove_outliers",
    "cwipc_tilefilter",
    "cwipc_tilemap",
    "cwipc_colormap",
    "cwipc_crop",
    "cwipc_join",
    "cwipc_join_multi",
]


def _wrap(buf, template: cwipc_pointcloud_wrapper, cellsize=None, timestamp=None):
    return cwipc_pointcloud_wrapper(
        buf,
        template.timestamp() if timestamp is None else timestamp,
        template.cellsize() if cellsize is None else cellsize,
    )


def cwipc_downsample(
    pc: cwipc_pointcloud_wrapper, voxelsize: float
) -> cwipc_pointcloud_wrapper:
    """Voxelize to cubes of the given size; negative selects the plain grid."""
    cellsize = abs(float(voxelsize))
    if pc.cellsize() >= cellsize:
        cellsize = pc.cellsize()
    if cellsize <= 0:
        # zero-size voxels: no-op copy (a 1/cellsize quantization would
        # divide by zero)
        return pc.clone()
    buf = pc._access_buffer()
    # The fast single-Morton-key sort is exact within a 1024^3-cell domain;
    # wider scenes need the exact per-axis tiebreak keys.  Use the host
    # cache for the bounding box when present (a device reduction +
    # readback costs a full dispatch round trip per call otherwise).
    if pc.count() == 0:
        extent_cells = 0.0
    elif pc._np_cache is not None:
        arr = pc._np_cache
        extent_cells = float(
            max(
                arr["x"].max() - arr["x"].min(),
                arr["y"].max() - arr["y"].min(),
                arr["z"].max() - arr["z"].min(),
            )
        ) / cellsize
    else:
        valid = buf.valid_mask()
        big = jnp.float32(3.0e38)
        lo = jnp.min(jnp.where(valid[:, None], buf.xyz, big), axis=0)
        hi = jnp.max(jnp.where(valid[:, None], buf.xyz, -big), axis=0)
        extent_cells = float(jnp.max(hi - lo)) / cellsize
    exact = extent_cells >= 1023.0
    # Scenes under 2^15 cells per axis (all realistic captures) use the
    # cheaper merged-tiebreak exact sort; wider ones carry all three keys.
    merged = exact and extent_cells < 32000.0
    out = voxelize.downsample(
        buf, jnp.float32(cellsize), exact_keys=exact, merged_exact=merged
    )
    return _wrap(out, pc, cellsize=cellsize)


def _estimate_spacing(pc: cwipc_pointcloud_wrapper) -> float:
    """Typical point spacing: the cloud's cellsize if set, else a sampled
    median nearest-neighbor distance."""
    if pc.cellsize() > 0:
        return pc.cellsize()
    arr = pc.get_numpy_matrix(onlyGeometry=True)
    n = arr.shape[0]
    if n < 2:
        return 1.0
    # Nearest neighbors are searched in a window around each sample's own
    # array position: capture and Morton orders are spatially coherent, so
    # the window contains the true neighborhood.  (Searching a fixed
    # prefix — or a sparse subset — overestimates spacing by large factors
    # for samples far from it, which inflates the grid cells downstream.)
    step = max(1, n // 512)
    idxs = np.arange(0, n, step)[:512]
    half = 2048
    nns = []
    for i in idxs:
        lo, hi = max(0, i - half), min(n, i + half)
        d2 = ((arr[i] - arr[lo:hi]) ** 2).sum(-1)
        d2[i - lo] = np.inf
        d2[d2 == 0] = np.inf  # exact duplicates are not "spacing"
        m = d2.min()
        if np.isfinite(m):
            nns.append(np.sqrt(m))
    # clamp: an all-duplicate window must not produce a zero grid cell
    return max(1e-6, float(np.median(nns))) if nns else 1.0


def _cols_grid_params(xyz: np.ndarray, cell: float, budget: int = 8_000_000):
    """Host-side column-grid parameter choice for ops/cols_knn.py: pick
    the column axis minimizing plane*cap, bucket the extents and cap.
    Extents are PERCENTILE-clipped so a single far outlier cannot explode
    the dense plane — out-of-grid points are reported uncovered by the
    kernel and fixed up exactly by brute force.  Returns
    (perm, gy, gz, cap, origin_cells) or None when no axis fits the slot
    budget; origin_cells (absolute cell coords, UNPERMUTED [3]) must be
    passed to the kernel so the grid anchors at the clipped core — a
    global-min rebase would let one far-negative outlier shift the whole
    core out of the grid (every point uncovered -> O(N^2) fixup)."""
    lo = np.percentile(xyz, 0.5, axis=0)
    hi = np.percentile(xyz, 99.5, axis=0)
    core = xyz[np.all((xyz >= lo) & (xyz <= hi), axis=1)]
    if core.shape[0] < 2:
        core = xyz
    v = np.floor(core / cell).astype(np.int64)
    origin_cells = v.min(axis=0)
    v -= origin_cells
    ext = v.max(axis=0) + 1

    def bucket(x, step=32):
        return int(-(-int(x) // step) * step)

    best = None
    for ax in range(3):
        a1, a2 = [i for i in range(3) if i != ax]
        ck = v[:, a1] * (1 << 21) + v[:, a2]
        _, cnt = np.unique(ck, return_counts=True)
        # multiple-of-4 cap: nothing in the column grid needs a power of
        # two, and pow2 rounding wastes up to 2x slots (selection cost is
        # linear in slots)
        cap = max(8, int(-(-int(cnt.max()) // 4) * 4))
        gy, gz = bucket(ext[a1]), bucket(ext[a2])
        cost = gy * gz * cap
        if best is None or cost < best[0]:
            best = (cost, (ax, a1, a2), gy, gz, cap)
    cost, perm, gy, gz, cap = best
    if cost > budget:
        return None
    return perm, gy, gz, cap, origin_cells


def _remove_outliers_single(
    pc: cwipc_pointcloud_wrapper, k: int, mult: float
) -> cwipc_pointcloud_wrapper:
    buf = pc._access_buffer()
    n = pc.count()
    if n <= 1:
        return _wrap(buf, pc)
    k_eff = min(int(k), n - 1)
    if n <= 4096:
        out = outliers.remove_outliers(buf, k_eff, jnp.float32(mult), method="exact")
        return _wrap(out, pc)
    # EXACT path for large clouds (replacing the neighborhood-grid
    # method, whose surrogate distance for ring-missing neighbors made
    # it inexact whenever the k-th neighbor fell outside its 3x3x3 ring
    # — at bench-cloud density a third of all points):
    #
    # * CPU backend: scipy cKDTree — the right exact tool for a host;
    # * GPU: the column-grid exact kNN (ops/cols_knn.py, plain XLA) with
    #   brute-force fixup for ring-uncovered points; degenerate grids
    #   (extents beyond the slot budget even after percentile clipping)
    #   fall back to the KD-tree on host.
    import jax

    xyz_host = np.asarray(buf.xyz)[:n].astype(np.float64)
    params = None
    if jax.default_backend() != "cpu":
        from .cols_knn import bruteforce_md_subset, cols_knn_mean_distance

        spacing = _estimate_spacing(pc)
        # ring covers < 4*cell; d_k ~ spacing*sqrt(k/pi) for surfaces
        cell = max(1.0, float(np.sqrt(k_eff / np.pi)) / 3.0) * spacing
        params = _cols_grid_params(xyz_host, cell)
    if params is not None:
        perm, gy, gz, cap, origin_cells = params
        xyz_perm = buf.xyz[:, list(perm)]
        md, unc = cols_knn_mean_distance(
            xyz_perm, buf.count, jnp.float32(cell), k_eff, gy=gy, gz=gz, cap=cap,
            vmin_override=jnp.asarray(origin_cells[list(perm)], jnp.int32),
        )
        md_fix = bruteforce_md_subset(xyz_perm, buf.count, unc, k_eff)
        md = jnp.where(unc, md_fix, md)
        keep = outliers._keep_from_mean_dists(md, buf.valid_mask(), jnp.float32(mult))
    else:
        from scipy.spatial import cKDTree

        tree = cKDTree(xyz_host)
        dist, _ = tree.query(xyz_host, k=k_eff + 1, workers=-1)
        md_host = np.atleast_2d(dist)[:, 1:].sum(axis=1) / k_eff
        md_full = np.zeros(buf.capacity, np.float32)
        md_full[:n] = md_host
        keep = outliers._keep_from_mean_dists(
            jnp.asarray(md_full), buf.valid_mask(), jnp.float32(mult)
        )
    out = compaction.compact(buf, keep)
    return _wrap(out, pc)


def cwipc_remove_outliers(
    pc: cwipc_pointcloud_wrapper, kNeighbors: int, stdDesvMultThresh: float, perTile: bool
) -> cwipc_pointcloud_wrapper:
    """Statistical outlier removal, optionally per tile.

    The per-tile variant mirrors the reference exactly
    (cwipc_filters.cpp:238-261): distinct tile values in order of first
    appearance, each selected with tilefilter (so a tile value of 0 selects
    the whole cloud — reference quirk preserved), cleaned independently and
    concatenated.
    """
    if not perTile:
        return _remove_outliers_single(pc, kNeighbors, stdDesvMultThresh)
    tiles_arr = pc.get_numpy_array()["tile"]
    _, first_idx = np.unique(tiles_arr, return_index=True)
    tiles_in_order = tiles_arr[np.sort(first_idx)]
    parts: List[cwipc_pointcloud_wrapper] = []
    for tile in tiles_in_order:
        sub = cwipc_tilefilter(pc, int(tile))
        parts.append(_remove_outliers_single(sub, kNeighbors, stdDesvMultThresh))
        sub.free()
    if not parts:
        return _wrap(pc._access_buffer(), pc)
    rv = parts[0]
    for p in parts[1:]:
        joined = cwipc_join(rv, p)
        rv.free()
        p.free()
        rv = joined
    rv._set_timestamp(pc.timestamp())
    rv._set_cellsize(pc.cellsize())
    return rv


def cwipc_tilefilter(pc: cwipc_pointcloud_wrapper, tile: int) -> cwipc_pointcloud_wrapper:
    """Select points whose tile equals `tile` (0 selects all points)."""
    buf = compaction.tilefilter(pc._access_buffer(), jnp.uint32(tile))
    return _wrap(buf, pc)


def cwipc_tilemap(
    pc: cwipc_pointcloud_wrapper,
    mapping: Union[List[int], Dict[int, int], bytes, bytearray],
) -> cwipc_pointcloud_wrapper:
    """Rewrite tile numbers through a 256-entry map (list/bytes/dict)."""
    if isinstance(mapping, dict):
        lut = np.zeros(256, np.uint8)
        for k, v in mapping.items():
            if not 0 <= k <= 255 or not 0 <= v <= 255:
                # a bare IndexError / silent negative-wrap would remap the
                # wrong tile
                raise CwipcError(f"cwipc_tilemap: entry {k}:{v} out of 0..255")
            lut[k] = v
    else:
        lut = np.frombuffer(bytes(mapping), np.uint8).copy()
        if lut.shape[0] != 256:
            raise CwipcError("cwipc_tilemap: mapping must have 256 entries")
    buf = compaction.tilemap(pc._access_buffer(), jnp.asarray(lut))
    return _wrap(buf, pc)


def cwipc_colormap(
    pc: cwipc_pointcloud_wrapper, clearBits: int, setBits: int
) -> cwipc_pointcloud_wrapper:
    """rgba' = (rgba & ~clearBits) | setBits; masks may touch the tile byte."""
    buf = compaction.colormap(
        pc._access_buffer(),
        jnp.uint32(clearBits & 0xFFFFFFFF),
        jnp.uint32(setBits & 0xFFFFFFFF),
    )
    rv = _wrap(buf, pc)
    # Reference moves metadata to the result (python/cwipc/util.py:1309-1317).
    if pc._metadata is not None:
        rv.access_metadata()._copy_from(pc._metadata)
    return rv


def cwipc_crop(
    pc: cwipc_pointcloud_wrapper, bbox: Union[tuple, List[float]]
) -> cwipc_pointcloud_wrapper:
    """Crop to [minx,maxx) x [miny,maxy) x [minz,maxz)."""
    buf = compaction.crop(pc._access_buffer(), jnp.asarray(list(bbox), jnp.float32))
    return _wrap(buf, pc)


def cwipc_join(
    pc1: cwipc_pointcloud_wrapper, pc2: cwipc_pointcloud_wrapper
) -> cwipc_pointcloud_wrapper:
    """Concatenate two pointclouds (pc1's points first)."""
    n1, n2 = pc1.count(), pc2.count()
    cap = bucket_capacity(n1 + n2)
    buf = compaction.join(pc1._access_buffer(), pc2._access_buffer(), capacity=cap)
    return cwipc_pointcloud_wrapper(
        buf,
        min(pc1.timestamp(), pc2.timestamp()),
        min(pc1.cellsize(), pc2.cellsize()),
        _count_hint=n1 + n2,
    )


def cwipc_join_multi(pcs: Iterable[cwipc_pointcloud_wrapper]) -> cwipc_pointcloud_wrapper:
    # free intermediate join results: reduce() would otherwise leave N-2
    # unreleased device buffers per call (a per-frame leak in fusion loops)
    it = iter(pcs)
    try:
        acc = next(it)
    except StopIteration:
        raise TypeError("cwipc_join_multi: empty iterable") from None
    first = True
    for pc in it:
        joined = cwipc_join(acc, pc)
        if not first:
            acc.free()
        acc = joined
        first = False
    return acc
