"""Cross-cloud nearest-neighbor search on device (grid-bucketed, two-scale).

The registration toolkit's inner kernel: for every point of a source cloud,
the nearest point of a reference cloud within a maximum correspondence
distance.  The reference uses scipy KDTree / Open3D searches
(reference: python/cwipc/registration/analyze.py:116-123,
registration/fine.py ICP correspondence); here the reference cloud is
bucketed on a grid, sorted once per scale, and each source point scans the
3x3x3 cell ring.

A single grid scale with bounded per-cell candidates can miss the true
neighbor in pathologically dense cells (e.g. the synthetic body's apex,
where a whole ring of points collapses to one spot).  Two scales fix this:

* a FINE pass (cell = max_distance/8) resolves near matches exactly — and a
  dense region by definition has a near neighbor, so overflow there is
  harmless;
* a COARSE pass (cell = max_distance) guarantees ring coverage of the full
  correspondence radius for sparse regions, where cells cannot overflow.

The per-point minimum over both passes is returned.  Matches beyond the
radius report distance +inf / index -1 ("no correspondence"), exactly the
semantics ICP and the analyzers need.  All access patterns are sorts +
bounded gathers; no host KD-tree.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

_SENTINEL = jnp.iinfo(jnp.int32).max
_F32_MAX = jnp.finfo(jnp.float32).max

_AXIS_BITS = 10
_AXIS_MAX = (1 << _AXIS_BITS) - 1

FINE_FACTOR = 8.0


def _nn_prepare(ref_xyz, rvalid, ridx, cell):
    """Reference-side preparation for one grid scale: cell keys, the key
    sort and the gathered coordinates.  Loop-invariant for iterative
    callers (ICP re-queries a MOVING source against a FIXED reference
    every iteration — re-sorting the reference per iteration would put
    two sorts and a large gather inside the loop body)."""
    rv = jnp.floor(ref_xyz / cell).astype(jnp.int32)
    vmin = jnp.min(jnp.where(rvalid[:, None], rv, _SENTINEL), axis=0)
    vmin = jnp.where(vmin == _SENTINEL, 0, vmin)
    vc = jnp.clip(rv - vmin[None, :], 0, _AXIS_MAX)
    rkey = (vc[:, 0] << (2 * _AXIS_BITS)) | (vc[:, 1] << _AXIS_BITS) | vc[:, 2]
    rkey = jnp.where(rvalid, rkey, _SENTINEL)
    srkey, sridx = jax.lax.sort((rkey, ridx), num_keys=1)
    srxyz = ref_xyz[sridx]
    return srkey, sridx, srxyz, vmin


def _nn_query(
    src_xyz: jax.Array,
    sv_valid: jax.Array,
    prep,
    cell: jax.Array,
    radius: jax.Array,
    cell_cap: int,
    block: int,
):
    """Query one prepared grid scale: NN within `radius`, candidates from
    the 3x3x3 cell ring (exact when radius <= cell and cells don't
    overflow)."""
    scap = src_xyz.shape[0]
    srkey, sridx, srxyz, vmin = prep
    rcap = srxyz.shape[0]

    sv = jnp.clip(
        jnp.floor(src_xyz / cell).astype(jnp.int32) - vmin[None, :],
        0, _AXIS_MAX,
    )

    off = jnp.arange(-1, 2, dtype=jnp.int32)
    ox, oy, oz = jnp.meshgrid(off, off, off, indexing="ij")
    offsets = jnp.stack([ox.ravel(), oy.ravel(), oz.ravel()], axis=-1)  # [27,3]

    nblocks = scap // block if scap % block == 0 else scap // block + 1
    pad = nblocks * block

    def row_block(start):
        bxyz = jax.lax.dynamic_slice(src_xyz, (start, 0), (block, 3))
        bv = jax.lax.dynamic_slice(sv, (start, 0), (block, 3))

        nb = bv[:, None, :] + offsets[None, :, :]
        in_grid = jnp.all((nb >= 0) & (nb <= _AXIS_MAX), axis=-1)
        nb_key = (nb[..., 0] << (2 * _AXIS_BITS)) | (nb[..., 1] << _AXIS_BITS) | nb[..., 2]
        lo = jnp.searchsorted(srkey, nb_key.ravel(), side="left").reshape(block, 27)
        hi = jnp.searchsorted(srkey, nb_key.ravel(), side="right").reshape(block, 27)
        hi = jnp.where(in_grid, hi, lo)

        cand = lo[:, :, None] + jnp.arange(cell_cap, dtype=jnp.int32)[None, None, :]
        cand_ok = cand < hi[:, :, None]
        cand = jnp.clip(cand, 0, rcap - 1).reshape(block, 27 * cell_cap)
        cand_ok = cand_ok.reshape(block, 27 * cell_cap)

        cxyz = srxyz[cand]
        diff = cxyz - bxyz[:, None, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        d2 = jnp.where(cand_ok, d2, _F32_MAX)
        best = jnp.argmin(d2, axis=-1)
        best_d2 = jnp.take_along_axis(d2, best[:, None], axis=-1)[:, 0]
        best_ridx = jnp.take_along_axis(sridx[cand], best[:, None], axis=-1)[:, 0]
        dist = jnp.sqrt(jnp.maximum(best_d2, 0.0))
        found = (best_d2 < _F32_MAX / 2) & (dist <= radius)
        return jnp.where(found, dist, jnp.inf), jnp.where(found, best_ridx, -1)

    starts = jnp.arange(nblocks, dtype=jnp.int32) * block
    dists, idxs = jax.lax.map(row_block, starts)
    return dists.reshape(pad)[:scap], idxs.reshape(pad)[:scap]


def _nn_pass(
    src_xyz: jax.Array,
    sv_valid: jax.Array,
    ref_xyz: jax.Array,
    rvalid: jax.Array,
    ridx: jax.Array,
    cell: jax.Array,
    radius: jax.Array,
    cell_cap: int,
    block: int,
):
    """One grid scale end-to-end: prepare the reference, then query."""
    prep = _nn_prepare(ref_xyz, rvalid, ridx, cell)
    return _nn_query(src_xyz, sv_valid, prep, cell, radius, cell_cap, block)


@partial(jax.jit, static_argnames=("cell_cap", "block"))
def nn_search(
    src_xyz: jax.Array,
    src_count: jax.Array,
    ref_xyz: jax.Array,
    ref_count: jax.Array,
    max_distance: jax.Array,
    cell_cap: int = 48,
    block: int = 4096,
):
    """For each source point: (distance, ref index) of the nearest reference
    point within max_distance; (+inf, -1) when there is none.

    Returns (dist f32[src_cap], idx i32[src_cap]); padding slots get
    (+inf, -1) as well.
    """
    scap = src_xyz.shape[0]
    block = min(block, scap)
    maxd = jnp.maximum(jnp.asarray(max_distance, jnp.float32), 1e-9)

    sidx = jnp.arange(scap, dtype=jnp.int32)
    ridx = jnp.arange(ref_xyz.shape[0], dtype=jnp.int32)
    svalid = sidx < src_count
    rvalid = ridx < ref_count

    # fine pass: exact for matches within maxd/FINE_FACTOR
    fine_cell = maxd / FINE_FACTOR
    d_f, i_f = _nn_pass(
        src_xyz, svalid, ref_xyz, rvalid, ridx, fine_cell, fine_cell, cell_cap, block
    )
    # coarse pass: full-radius coverage
    d_c, i_c = _nn_pass(
        src_xyz, svalid, ref_xyz, rvalid, ridx, maxd, maxd, cell_cap, block
    )

    take_fine = d_f <= d_c
    dist = jnp.where(take_fine, d_f, d_c)
    idx = jnp.where(take_fine, i_f, i_c)
    dist = jnp.where(svalid, dist, jnp.inf)
    idx = jnp.where(svalid, idx, -1)
    return dist, idx
