"""EXACT k-NN mean distance for voxel-unique clouds: the column grid.

The outlier stage of the reference (PCL StatisticalOutlierRemoval,
reference: src/cwipc_filters.cpp:181-278) needs, per point, the mean
distance to its k nearest neighbors — EXACTLY, because the keep threshold
mu + mult*sigma sits inside the bulk of the distance distribution and any
approximation flips keep decisions (measured: Morton-window kNN agrees on
only ~81% of keeps on the 1M-point bench cloud).

Candidate neighborhoods come from FIXED per-query offsets into a dense
slot grid, so no per-candidate gather is needed.  The design:

1. quantize to the `cell` grid and key every point by its (y, z) column;
   rank points within a column by x (one sort) — a voxel-unique cloud
   has at most max-column-occupancy ranks, bounded by the CAP bucket,
2. scatter into a dense [GY*GZ, CAP] slot grid (x-sorted columns),
3. candidates for a query are ALL slots of the 9x9 ring of columns
   (|dy|, |dz| <= 4) — complete by construction, no rank-alignment
   assumptions — accessed via static plane slices,
4. exact per-slot selection of the k smallest squared distances
   (lax.top_k over the candidate axis),
5. scatter the mean distances back to the caller's point order.

Coverage: |delta| < 4*cell per axis implies column offsets <= 4, so the
ring contains EVERY point within radius 4*cell of the query.  Points
whose k-th found neighbor is not strictly inside 4*cell (or with fewer
than k candidates, or dropped by CAP/extent clamps) are marked UNCOVERED;
the caller recomputes them exactly (coarser second pass or brute force).
The 1M-point bench cloud measures d30 <= 4.12*cell with 0.05% of points
beyond 4*cell, so the uncovered set is small on real clouds — the
adversarial worst case degrades to brute force, like a KD-tree's.

Cost model: exact selection dominates — top_k over C = 81*CAP candidates
for every slot.  This op is the framework's exactness anchor (parity
tests, exact mode); the fused chain's default outlier stage remains the
documented Morton-window approximation.

Everything is static-shape XLA: one sort, two scatters, static slices,
one top_k per chunk.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

_F32_MAX = jnp.finfo(jnp.float32).max
_SENTINEL = jnp.iinfo(jnp.int32).max
_M = 4  # ring radius in cells; guarantees coverage of balls < _M*cell


def _k_smallest_sum(d2: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """Sum of sqrt of the k smallest entries along the last axis, and the
    k-th smallest distance itself.  d2: [..., C] with invalid = F32_MAX."""
    neg, _ = jax.lax.top_k(-d2, k)
    # top_k sorts descending in -d2, i.e. ascending in d2
    small = -neg
    found = small < _F32_MAX / 2
    dist = jnp.where(found, jnp.sqrt(jnp.maximum(small, 0.0)), 0.0)
    kth = jnp.sqrt(jnp.maximum(small[..., -1], 0.0))
    kth = jnp.where(found[..., -1], kth, _F32_MAX)
    return dist.sum(axis=-1), kth


def _cols_build(xyz, count, cell, *, gy, gz, cap, chunk, vmin_override=None):
    """Phase 1: slot-grid construction.  Returns the padded plane
    channel arrays plus (valid, drop_ring, point_slot) for the finish
    phase.

    ``vmin_override`` ([3] int32, absolute cell coordinates) anchors the
    grid explicitly — callers that size gy/gz from percentile-clipped
    extents MUST pass the matching clipped origin, otherwise one
    far-negative outlier rebases the grid away from the core and every
    point lands uncovered (an O(N^2) brute-force stall).  Points below
    the origin are out-of-grid: reported uncovered, exactly like
    points beyond the upper extents."""
    n = xyz.shape[0]
    # the rank sort packs the column key and the x-cell into one int32
    assert gy * gz <= 1_000_000, "column plane too large for the int32 sort key"
    idx = jnp.arange(n, dtype=jnp.int32)
    valid = idx < count
    inv = 1.0 / jnp.asarray(cell, jnp.float32)

    v = jnp.floor(xyz * inv).astype(jnp.int32)
    if vmin_override is None:
        vmin = jnp.min(jnp.where(valid[:, None], v, _SENTINEL), axis=0)
        vmin = jnp.where(vmin == _SENTINEL, 0, vmin)
    else:
        vmin = jnp.asarray(vmin_override, jnp.int32)
    vr = v - vmin[None, :]
    in_grid = valid & (vr[:, 1] >= 0) & (vr[:, 1] < gy) & (vr[:, 2] >= 0) & (vr[:, 2] < gz)
    ck = jnp.where(in_grid, vr[:, 1] * gz + vr[:, 2], gy * gz)  # overflow col

    # rank within column by x-cell: sort by (ck, vx); rank = i - run_start
    sort_key = ck * 2048 + jnp.clip(vr[:, 0], 0, 2047)
    sort_key = jnp.where(in_grid, sort_key, _SENTINEL)
    pay1 = jax.lax.complex(xyz[:, 0], xyz[:, 1])
    pay2 = jax.lax.complex(xyz[:, 2], jax.lax.bitcast_convert_type(idx, jnp.float32))
    skey, sck, sp1, sp2 = jax.lax.sort((sort_key, ck, pay1, pay2), num_keys=1)
    si = jnp.arange(n, dtype=jnp.int32)
    new_col = jnp.logical_or(si == 0, sck != jnp.roll(sck, 1))
    starts = jnp.where(new_col, si, 0)
    run_start = jax.lax.associative_scan(jnp.maximum, starts)
    rank = si - run_start
    sidx = jax.lax.bitcast_convert_type(jnp.imag(sp2), jnp.int32)
    fits = (skey < _SENTINEL) & (rank < cap)
    addr = jnp.where(fits, sck * cap + rank, gy * gz * cap)  # dropped -> sink

    # dense slot grid [gy*gz*cap]; dropped points address the sink slot
    slots = gy * gz * cap
    gyz = gy * gz
    nchunks = -(-gyz // chunk)
    pad_rows = nchunks * chunk - gyz
    off_max = _M * gz + _M

    # Channel planes are scattered DIRECTLY into their padded layout
    # ([off_max halo, gyz, pad_rows + off_max tail] rows of `cap`, so the
    # ring slices of any chunk never wrap): padding via concatenation
    # after an unpadded fill cost three extra 2.1M-element copies.
    prows = off_max + gyz + pad_rows + off_max
    addr_p = jnp.where(fits, addr + off_max * cap, prows * cap)

    def fill_padded(vals):
        base = jnp.full((prows * cap + 1,), _F32_MAX, vals.dtype)
        return base.at[addr_p].set(
            jnp.where(fits, vals, _F32_MAX)
        )[: prows * cap].reshape(prows, cap)

    xs_g = fill_padded(jnp.real(sp1))
    ys_g = fill_padded(jnp.imag(sp1))
    zs_g = fill_padded(jnp.real(sp2))

    # inverse map point -> slot (one n-sized scatter): the finish phase
    # then GATHERS per-point results instead of scattering over ALL
    # gyz*cap slots (2 x 2.1M scattered writes at bench scale)
    point_slot = (
        jnp.full((n + 1,), slots, jnp.int32)
        .at[jnp.where(fits, sidx, n)]
        .set(jnp.where(fits, addr, slots))[:n]
    )

    # A DROPPED point (column capacity or grid-extent overflow) is absent
    # from its neighbors' candidate sets, so every query within reach of
    # a drop must be recomputed, not just the dropped point itself.
    #
    # Rank overflows keep their true column (post-sort sck < gy*gz);
    # extent overflows flag their nearest border column (pre-sort clip:
    # only drops within _M cells of the border can be true neighbors of
    # an in-grid covered query, and for those the clamp moves the flag
    # by at most _M columns).  Dilating by 2*_M covers both the ring
    # radius and the clamp displacement; jnp.roll's wrap only ever
    # over-marks.
    rank_drop = (skey < _SENTINEL) & (rank >= cap)
    ext_drop = valid & jnp.logical_not(in_grid)

    def _drop_ring(_):
        rank_addr = jnp.where(rank_drop, sck, gyz)
        vy_c = jnp.clip(vr[:, 1], 0, gy - 1)
        vz_c = jnp.clip(vr[:, 2], 0, gz - 1)
        ext_addr = jnp.where(ext_drop, vy_c * gz + vz_c, gyz)
        drop_flag = (
            jnp.zeros((gyz + 1,), jnp.float32)
            .at[rank_addr].add(1.0)
            .at[ext_addr].add(1.0)[:gyz]
            > 0
        )
        # separable box dilation by EXACTLY radius 2*_M per axis: each
        # pass rolls the PRE-DILATION base (accumulating rolls of the
        # running result would compound the radius to sum(1..2*_M) and
        # over-mark ~18x the area, multiplying the brute-fixup cost)
        base = drop_flag.reshape(gy, gz)
        f = base
        for j in range(1, 2 * _M + 1):
            f = f | jnp.roll(base, j, 0) | jnp.roll(base, -j, 0)
        base = f
        for j in range(1, 2 * _M + 1):
            f = f | jnp.roll(base, j, 1) | jnp.roll(base, -j, 1)
        return f.reshape(gyz)

    # A well-sized grid drops NOTHING, so the two 262k-update scatter-adds
    # plus the dilation run only when a drop actually exists — the
    # reduction deciding that is two cheap jnp.any passes.  With any drop
    # present the full flag+dilation body runs unchanged.
    drop_ring = jax.lax.cond(
        jnp.any(rank_drop) | jnp.any(ext_drop),
        _drop_ring,
        lambda _: jnp.zeros((gyz,), jnp.bool_),
        None,
    )
    return xs_g, ys_g, zs_g, valid, drop_ring, point_slot


def _cols_select(xs_g, ys_g, zs_g, c0s, *, k, gy, gz, cap, chunk, voxel_unique):
    """Phase 2 (the expensive one): per-chunk candidate distances and
    exact selection for the plane chunks whose start rows are `c0s`
    (traced values — a sharded caller passes its own slab's chunks).
    Returns (sums, kths) stacked per chunk."""
    gyz = gy * gz
    off_max = _M * gz + _M
    ncols = (2 * _M + 1) ** 2

    def chunk_body(c0):
        q = lambda a: jax.lax.dynamic_slice(a, (c0 + off_max, 0), (chunk, cap))
        qx, qy, qz = q(xs_g), q(ys_g), q(zs_g)  # [chunk, cap]
        cands = []
        for dy in range(-_M, _M + 1):
            for dz in range(-_M, _M + 1):
                row_off = c0 + off_max + dy * gz + dz
                cand = lambda a: jax.lax.dynamic_slice(a, (row_off, 0), (chunk, cap))
                cands.append((cand(xs_g), cand(ys_g), cand(zs_g)))
        cx = jnp.stack([c[0] for c in cands], axis=1)  # [chunk, 81, cap]
        cy = jnp.stack([c[1] for c in cands], axis=1)
        cz = jnp.stack([c[2] for c in cands], axis=1)
        # [chunk, cap_q, 81, cap_c] distances by broadcasting
        d2 = (
            (qx[:, :, None, None] - cx[:, None, :, :]) ** 2
            + (qy[:, :, None, None] - cy[:, None, :, :]) ** 2
            + (qz[:, :, None, None] - cz[:, None, :, :]) ** 2
        )
        bad = (cx >= _F32_MAX / 2)[:, None, :, :] | (qx >= _F32_MAX / 2)[:, :, None, None]
        # self-pair: the (dy, dz) == (0, 0) column at the query's own slot
        self_col = ncols // 2
        qslot = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
        cslot = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 3)
        colid = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 2)
        is_self = (colid == self_col) & (qslot == cslot)
        d2 = jnp.where(bad | is_self, _F32_MAX, d2)
        # Two-stage exact selection.  Stage 1: top-9 per candidate COLUMN
        # — exact because a column's points occupy distinct x-cells, so at
        # most 9 of them can lie within the |dx| < 4*cell ball span of any
        # query; top_k on short rows measures ~3.7x cheaper per element
        # than on the full 81*CAP row.  Stage 2: exact top-k over the
        # 81*9 survivors.
        # The <=9 bound REQUIRES voxel uniqueness (distinct x-cells per
        # column); for general clouds every column slot stays a candidate.
        keep_per_col = min(9, cap) if voxel_unique else cap
        if keep_per_col < cap:
            neg1, _ = jax.lax.top_k(
                -d2.reshape(chunk * cap * ncols, cap), keep_per_col
            )
            survivors = (-neg1).reshape(chunk * cap, ncols * keep_per_col)
        else:
            survivors = d2.reshape(chunk * cap, ncols * cap)
        ssum, kth = _k_smallest_sum(survivors, k)
        return ssum.reshape(chunk, cap), kth.reshape(chunk, cap)

    return jax.lax.map(chunk_body, c0s)


def _cols_finish(sums, kths, point_slot, valid, drop_ring, cell, *, k, gy, gz, cap):
    """Phase 3: slot results back to the caller's point order, by a
    per-POINT gather through the build's inverse map.  (The previous
    slot-side form scattered over all gyz*cap slots — 10x the work of
    gathering n results.)  ``sums``/``kths`` are flat [gyz, cap]
    plane arrays; ``point_slot`` maps each point to its slot, or to the
    sink value gyz*cap for dropped/overflow points."""
    n = valid.shape[0]
    gyz = gy * gz
    slots = gyz * cap
    r_cut = float(_M) * jnp.asarray(cell, jnp.float32)
    sums = sums.reshape(slots)
    # Queries whose ring lost a dropped candidate are not trustworthy:
    # fold that taint into kths BEFORE the per-point gather — an
    # elementwise mask over the [gyz, cap] plane is far cheaper than a
    # second 262k-row gather (the whole-plane select is
    # bandwidth-trivial).
    # Tainted slots get kth = F32_MAX, which fails the covered test.
    kths = jnp.where(
        drop_ring[:, None], _F32_MAX, kths.reshape(gyz, cap)
    ).reshape(slots)

    has_slot = point_slot < slots
    ps = jnp.minimum(point_slot, slots - 1)
    md = jnp.where(has_slot, sums[ps] / float(k), 0.0)
    covered = kths[ps] < r_cut * (1.0 - 1e-6)
    unc = jnp.logical_not(has_slot & covered)
    unc = jnp.where(valid, unc, False)
    return jnp.where(valid & has_slot, md, 0.0), unc


@partial(jax.jit, static_argnames=(
    "k", "gy", "gz", "cap", "chunk", "voxel_unique"))
def cols_knn_mean_distance(
    xyz: jax.Array,
    count: jax.Array,
    cell: jax.Array,
    k: int,
    gy: int,
    gz: int,
    cap: int,
    chunk: int = 256,
    voxel_unique: bool = False,
    vmin_override: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Exact mean k-NN distance over the column grid.

    Returns (md, uncovered): md [N] is exact for every point where
    uncovered is False; uncovered entries hold the ring-limited result
    and must be fixed up by the caller.

    Requirements: rebased y/z extents fit (gy, gz) and no (y, z) column
    holds more than `cap` points.  `voxel_unique` promises distinct
    cells per point (the downsample postcondition), enabling the
    per-column pre-selection.  Violations of the stated promises aside,
    errors are reported via `uncovered`, never silently wrong.
    """
    gyz = gy * gz
    nchunks = -(-gyz // chunk)
    xs_g, ys_g, zs_g, valid, drop_ring, point_slot = _cols_build(
        xyz, count, cell, gy=gy, gz=gz, cap=cap, chunk=chunk,
        vmin_override=vmin_override,
    )

    c0s = jnp.arange(nchunks, dtype=jnp.int32) * chunk
    sums, kths = _cols_select(
        xs_g, ys_g, zs_g, c0s, k=k, gy=gy, gz=gz, cap=cap, chunk=chunk,
        voxel_unique=voxel_unique,
    )
    sums = sums.reshape(nchunks * chunk, cap)[:gyz]
    kths = kths.reshape(nchunks * chunk, cap)[:gyz]
    return _cols_finish(
        sums, kths, point_slot, valid, drop_ring, cell, k=k, gy=gy, gz=gz,
        cap=cap,
    )


@partial(jax.jit, static_argnames=("k", "block"))
def bruteforce_md_subset(
    xyz: jax.Array,
    count: jax.Array,
    sel: jax.Array,
    k: int,
    block: int = 128,
) -> jax.Array:
    """Exact md for the selected points only, by compacted brute force.

    The selected row indices are compacted to the front of an index
    list (one cheap scatter), then processed in gathered blocks of
    ``block`` queries with a dynamic trip count of ceil(n_sel / block) —
    so the cost scales with the number of SELECTED points, not with the
    cloud size.  (The previous formulation mapped over every cloud
    block with a lax.cond skip, so ~100 scattered uncovered points
    touched ~100 blocks; the compacted form is one block.)  Output is 0
    for non-selected rows."""
    cap = xyz.shape[0]
    block = min(block, cap)  # tiny clouds: one block covers everything
    idx = jnp.arange(cap, dtype=jnp.int32)
    valid = idx < count
    sel = sel & valid
    sq = jnp.sum(xyz * xyz, axis=-1)
    col_mask = jnp.where(valid, 0.0, _F32_MAX)

    # compact the selected indices to the front of ilist [cap]
    pos = jnp.cumsum(sel.astype(jnp.int32)) - 1
    n_sel = jnp.maximum(pos[-1] + 1, 0)
    ilist = (
        jnp.full((cap + 1,), -1, jnp.int32)
        .at[jnp.where(sel, pos, cap)]
        .set(jnp.where(sel, idx, -1))[:cap]
    )

    def row_block(b, md_acc):
        bidx = jax.lax.dynamic_slice(ilist, (b * block,), (block,))
        bval = bidx >= 0
        bidx_c = jnp.maximum(bidx, 0)
        rows = xyz[bidx_c]  # gather: `block` rows, cheap at this scale
        row_sq = sq[bidx_c]
        # HIGHEST precision is mandatory: a reduced-precision matmul
        # (bf16, or TF32 on the GPU) has ~1e-3 relative error on the
        # cross term, which the |a|^2+|b|^2-2ab expansion turns into
        # ~1e-2 absolute distance error — far beyond the keep threshold's
        # sensitivity (112 corrupted md values once shifted the bench
        # threshold enough to flip ~2000 keep decisions).
        cross = jnp.dot(
            rows, xyz.T, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        d2 = row_sq[:, None] + sq[None, :] - 2.0 * cross
        d2 = jnp.maximum(d2, 0.0) + col_mask[None, :]
        self_col = (
            jax.lax.broadcasted_iota(jnp.int32, (block, cap), 1)
            == bidx_c[:, None]
        )
        d2 = jnp.where(self_col, _F32_MAX, d2)
        neg, _ = jax.lax.top_k(-d2, k)
        d = jnp.sqrt(jnp.maximum(-neg, 0.0))
        d = jnp.where(-neg < _F32_MAX / 2, d, 0.0)
        mdb = d.sum(axis=-1) / float(k)
        tgt = jnp.where(bval, bidx, cap)  # sink slot absorbs padding
        return md_acc.at[tgt].set(jnp.where(bval, mdb, 0.0))

    nblk = -(-n_sel // block)
    md = jax.lax.fori_loop(
        0, nblk, row_block, jnp.zeros((cap + 1,), jnp.float32)
    )[:cap]
    return jnp.where(sel, md, 0.0)
