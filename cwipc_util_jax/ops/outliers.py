"""Statistical outlier removal on device.

Semantics follow the reference's use of PCL StatisticalOutlierRemoval
(reference: src/cwipc_filters.cpp:181-278):

1. for every point, the mean Euclidean distance to its k nearest neighbors
   (excluding itself),
2. global mean mu and stddev sigma of those per-point means, with the
   (n-1) sample variance PCL uses,
3. keep points whose mean distance <= mu + mult * sigma,
4. surviving points keep their original order.

Two device paths:

* ``exact``  — tiled brute-force kNN.  The [B, N] squared-distance tiles are
  computed via the |a-b|^2 = |a|^2 + |b|^2 - 2ab^T expansion so the 2ab^T
  term is a matmul; rows are processed in chunks under
  ``lax.map`` so the full N^2 matrix never materializes.  O(N^2) — used for
  parity tests and small clouds.
* ``grid``   — neighborhood-grid kNN: points are sorted by a quantized cell
  key, neighbor cells are located with binary search over the sorted key
  array, and a bounded number of candidates per cell is gathered.  Exact
  whenever (a) each cell holds <= CELL_CAP points and (b) the true k-th
  neighbor lies within the 3x3x3 cell ring; both hold by construction when
  the cloud was voxel-downsampled at cellsize c and the grid cell is >= 3c
  with k <= 30.  O(N * candidates) — the production path for the fused
  downsample+outlier+tilefilter chain.

The per-tile variant of the reference (cwipc_filters.cpp:238-261) is
orchestrated by the host wrapper (see cwipc_util_jax/ops/__init__.py) since
it concatenates independent per-tile results in tile-first-appearance order.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.buffers import PointBuffer
from .compaction import compact

_F32_MAX = jnp.finfo(jnp.float32).max


def _keep_from_mean_dists(mean_dist: jax.Array, valid: jax.Array, mult) -> jax.Array:
    """PCL's global mean/stddev threshold test over per-point mean distances."""
    n = valid.sum(dtype=jnp.float32)
    md = jnp.where(valid, mean_dist, 0.0)
    return _keep_from_moments(mean_dist, valid, mult, n, md.sum(), (md * md).sum())


def _keep_from_moments(mean_dist, valid, mult, n, s, sq) -> jax.Array:
    """Threshold test from externally-supplied moments (n, sum, sum-of-
    squares) of the mean-distance population.  Sharded callers psum their
    per-shard moments over the mesh first so mu/sigma are GLOBAL — the PCL
    statistics are over the whole cloud, not a shard (parallel/rangemerge)."""
    n_safe = jnp.maximum(n, 1.0)
    mean = s / n_safe
    # PCL: variance = (sq_sum - sum^2/n) / (n-1)
    var = (sq - s * s / n_safe) / jnp.maximum(n - 1.0, 1.0)
    sigma = jnp.sqrt(jnp.maximum(var, 0.0))
    m = jnp.asarray(mult, jnp.float32)
    # mult=inf is the documented "pure downsample" mode: inf * sigma is NaN
    # when sigma == 0 (uniform or single-point populations), which would
    # drop EVERY point instead of keeping all
    thr = jnp.where(jnp.isinf(m), jnp.inf, mean + m * sigma)
    return jnp.logical_and(valid, mean_dist <= thr)


# ---------------------------------------------------------------------------
# Exact brute-force path
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("k", "block"))
def _mean_knn_dist_bruteforce(
    xyz: jax.Array, count: jax.Array, k: int, block: int = 1024
) -> jax.Array:
    """Per-point mean distance to the k nearest neighbors (excluding self)."""
    cap = xyz.shape[0]
    block = min(block, cap)
    valid = jnp.arange(cap, dtype=jnp.int32) < count
    sq_norms = jnp.sum(xyz * xyz, axis=-1)
    col_mask = jnp.where(valid, 0.0, _F32_MAX)

    nblocks = cap // block if cap % block == 0 else cap // block + 1
    pad = nblocks * block

    def row_block(start):
        rows = jax.lax.dynamic_slice(xyz, (start, 0), (block, 3))
        row_sq = jax.lax.dynamic_slice(sq_norms, (start,), (block,))
        row_idx = start + jnp.arange(block, dtype=jnp.int32)
        # d2[b, j] = |a_b|^2 + |x_j|^2 - 2 a_b . x_j  (the dot is a matmul;
        # HIGHEST precision because a reduced-precision matmul corrupts the
        # cancellation-sensitive expansion — see cols_knn.py)
        cross = jnp.dot(
            rows, xyz.T, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        d2 = row_sq[:, None] + sq_norms[None, :] - 2.0 * cross
        d2 = jnp.maximum(d2, 0.0) + col_mask[None, :]
        # exclude self-distance
        self_col = jax.lax.broadcasted_iota(jnp.int32, (block, cap), 1) == row_idx[:, None]
        d2 = jnp.where(self_col, _F32_MAX, d2)
        neg_top, _ = jax.lax.top_k(-d2, k)
        dists = jnp.sqrt(jnp.maximum(-neg_top, 0.0))
        dists = jnp.where(jnp.isfinite(dists) & (-neg_top < _F32_MAX / 2), dists, 0.0)
        return dists.sum(axis=-1) / float(k)

    starts = jnp.arange(nblocks, dtype=jnp.int32) * block
    out = jax.lax.map(row_block, starts).reshape(pad)[:cap]
    return jnp.where(valid, out, 0.0)


# ---------------------------------------------------------------------------
# Grid-accelerated path
# ---------------------------------------------------------------------------

# Bits per axis in the packed cell key.  Extents are clamped to fit, which
# coarsens the grid for pathological scenes but never crashes.
_AXIS_BITS = 10
_AXIS_MAX = (1 << _AXIS_BITS) - 1


@partial(jax.jit, static_argnames=("k", "cell_cap", "block"))
def _mean_knn_dist_grid(
    xyz: jax.Array,
    count: jax.Array,
    cell: jax.Array,
    k: int,
    cell_cap: int = 32,
    block: int = 8192,
) -> jax.Array:
    """Grid-bucketed kNN mean distance; candidates from the 3x3x3 cell ring."""
    cap = xyz.shape[0]
    block = min(block, cap)
    idx = jnp.arange(cap, dtype=jnp.int32)
    valid = idx < count

    cell = jnp.asarray(cell, jnp.float32)
    # Rebase cell coords so they are non-negative and fit in _AXIS_BITS.
    v = jnp.floor(xyz / cell).astype(jnp.int32)
    vmin = jnp.min(jnp.where(valid[:, None], v, jnp.iinfo(jnp.int32).max), axis=0)
    v = jnp.clip(v - vmin[None, :], 0, _AXIS_MAX)
    key = (v[:, 0] << (2 * _AXIS_BITS)) | (v[:, 1] << _AXIS_BITS) | v[:, 2]
    key = jnp.where(valid, key, jnp.iinfo(jnp.int32).max)

    skey, perm = jax.lax.sort((key, idx), num_keys=1)
    sxyz = xyz[perm]
    sv = v[perm]

    # 27 neighbor-cell offsets.
    off = jnp.arange(-1, 2, dtype=jnp.int32)
    ox, oy, oz = jnp.meshgrid(off, off, off, indexing="ij")
    offsets = jnp.stack([ox.ravel(), oy.ravel(), oz.ravel()], axis=-1)  # [27,3]

    nblocks = cap // block if cap % block == 0 else cap // block + 1
    pad = nblocks * block

    def row_block(start):
        rows_xyz = jax.lax.dynamic_slice(sxyz, (start, 0), (block, 3))
        rows_v = jax.lax.dynamic_slice(sv, (start, 0), (block, 3))
        rows_i = start + jnp.arange(block, dtype=jnp.int32)

        nb = rows_v[:, None, :] + offsets[None, :, :]  # [block, 27, 3]
        in_grid = jnp.all((nb >= 0) & (nb <= _AXIS_MAX), axis=-1)
        nb_key = (nb[..., 0] << (2 * _AXIS_BITS)) | (nb[..., 1] << _AXIS_BITS) | nb[..., 2]
        lo = jnp.searchsorted(skey, nb_key.ravel(), side="left").reshape(block, 27)
        hi = jnp.searchsorted(skey, nb_key.ravel(), side="right").reshape(block, 27)
        hi = jnp.where(in_grid, hi, lo)

        # candidate indices: per neighbor cell, up to cell_cap entries
        cand = lo[:, :, None] + jnp.arange(cell_cap, dtype=jnp.int32)[None, None, :]
        cand_ok = cand < hi[:, :, None]
        cand = jnp.clip(cand, 0, cap - 1).reshape(block, 27 * cell_cap)
        cand_ok = cand_ok.reshape(block, 27 * cell_cap)

        cxyz = sxyz[cand]  # [block, 27*cell_cap, 3]
        diff = cxyz - rows_xyz[:, None, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        is_self = cand == rows_i[:, None]
        d2 = jnp.where(cand_ok & ~is_self, d2, _F32_MAX)

        neg_top, _ = jax.lax.top_k(-d2, k)
        dists = jnp.sqrt(jnp.maximum(-neg_top, 0.0))
        # A missing neighbor (fewer than k candidates in the ring) is at
        # least one cell away; use 2*cell as its surrogate distance so
        # isolated points bias toward removal instead of toward survival.
        dists = jnp.where(-neg_top < _F32_MAX / 2, dists, 2.0 * cell)
        return dists.sum(axis=-1) / float(k)

    starts = jnp.arange(nblocks, dtype=jnp.int32) * block
    sorted_md = jax.lax.map(row_block, starts).reshape(pad)[:cap]
    # scatter back to original order
    md = jnp.zeros((cap,), jnp.float32).at[perm].set(sorted_md)
    return jnp.where(valid, md, 0.0)


# ---------------------------------------------------------------------------
# Morton-window path (gather-free)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("k", "window"))
def _mean_knn_dist_window(
    xyz: jax.Array, count: jax.Array, k: int, window: int = 32
) -> jax.Array:
    """Approximate kNN mean distance using a sliding window in array order.

    Assumes the points are spatially ordered (Morton order — exactly what
    ops/voxelize.py emits), so a point's k nearest neighbors are almost
    always among its +/-window neighbors in the array.  Candidate access is
    pure shifting — no random gathers.  Window boundaries of the
    space-filling curve make this approximate; the `exact`/`grid` methods
    remain for parity.

    Selection sorts the [2*window, cap] distance matrix along axis 0.  On
    the GPU the chain runs the fused kernel instead
    (ops/pallas_window_knn.py); this form is the reference it is tested
    against and the path on every other platform.
    """
    cap = xyz.shape[0]
    idx = jnp.arange(cap, dtype=jnp.int32)
    valid = idx < count

    def shift_d2(_, w):
        rolled = jnp.roll(xyz, -w, axis=0)
        diff = xyz - rolled
        d2 = jnp.sum(diff * diff, axis=-1)
        nb = idx + w
        ok = jnp.logical_and(nb >= 0, nb < count)
        return None, jnp.where(ok, d2, _F32_MAX)

    offsets = jnp.asarray(
        [w for w in range(-window, window + 1) if w != 0], jnp.int32
    )
    # scan keeps the HLO small (one rolled-distance body, 2*window trips)
    _, d2 = jax.lax.scan(shift_d2, None, offsets)  # [2*window, cap]

    kk = min(k, 2 * window)
    smallest = jnp.sort(d2, axis=0)[:kk]  # [k, cap]
    found = smallest < _F32_MAX / 2
    dists = jnp.where(found, jnp.sqrt(jnp.maximum(smallest, 0.0)), 0.0)
    # divide by the EFFECTIVE k (the Pallas kernel does the same): with
    # k > 2*window only 2*window candidates exist
    md = dists.sum(axis=0) / float(kk)
    return jnp.where(valid, md, 0.0)


# ---------------------------------------------------------------------------
# Public op
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("k", "method", "cell_cap", "window"))
def remove_outliers(
    buf: PointBuffer,
    k: int,
    mult: jax.Array,
    method: str = "exact",
    cell: jax.Array | None = None,
    cell_cap: int = 32,
    window: int = 32,
) -> PointBuffer:
    """Statistical outlier removal over the whole buffer (no tiling)."""
    if method == "grid":
        assert cell is not None, "grid method needs a cell size"
        md = _mean_knn_dist_grid(buf.xyz, buf.count, cell, k, cell_cap=cell_cap)
    elif method == "window":
        md = _mean_knn_dist_window(buf.xyz, buf.count, k, window=window)
    else:
        md = _mean_knn_dist_bruteforce(buf.xyz, buf.count, k)
    keep = _keep_from_mean_dists(md, buf.valid_mask(), mult)
    return compact(buf, keep)
