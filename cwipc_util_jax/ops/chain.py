"""Fused op pipelines — the framework's hot path.

The reference applies its operators one C call at a time with a host copy
between stages (e.g. the downsample -> outlier-removal -> tilefilter chain
used as this project's headline benchmark, reference:
src/cwipc_filters.cpp:89-306).  Here the whole chain is a single jitted XLA
program: intermediate clouds never leave HBM, counts stay device scalars,
and XLA fuses the masking/packing elementwise work between the sort and the
segment reductions.

Pipeline structure (sorts and contiguous traffic, no searchsorted):

1. downsample emits voxel centroids in Morton order (ops/voxelize.py),
2. the outlier stage runs the gather-free sliding-window kNN directly on
   that Morton order (ops/outliers.py `window` method),
3. tilefilter is a mask plus one sort-based compaction.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.buffers import PointBuffer
from . import compaction, outliers, voxelize


@partial(jax.jit, static_argnames=("k", "window", "out_capacity"))
def downsample_outliers_tilefilter(
    buf: PointBuffer,
    cellsize: jax.Array,
    k: int,
    mult: jax.Array,
    tile: jax.Array,
    window: int = 16,
    out_capacity: int | None = None,
) -> PointBuffer:
    """Fused voxel downsample -> statistical outlier removal -> tilefilter.

    ``out_capacity`` bounds the post-downsample buffer (callers that know
    the reduction factor shrink it to cut downstream cost); the outlier
    stage uses the Morton sliding-window kNN, exact for all but the few
    points whose k-th neighbor falls across a space-filling-curve seam.

    ``window`` defaults to 16.  TWO agreement numbers exist for the
    window approximation, measured on the 1M-pt bench cloud against the
    exact chain — do not mix them up:

    * KEEP-DECISION agreement (the same keep/drop decision for every
      downsampled point; tile 0 so every decision shows in the output
      voxel sets): 80.9% at W=16, 81.3% at W=32 — the window
      approximation itself, not its width, causes the divergence;
    * bench.py's ``fast_keep_agreement_pct`` (the same voxel-set
      symmetric difference with both chains filtered to tile 1, over all
      decisions): 90.5% — it reads higher because only about half of the
      flipped decisions survive the tile filter.

    See BASELINE.md "Approximation contract".  W=16 keeps the selection
    short: k=30 of 32 candidates is two max-drops per point.
    """
    # The whole post-sort pipeline stays CHANNEL-MAJOR: the segment reduce
    # produces coordinate rows, the window kNN and the compaction consume
    # rows — the [N,3] form is materialized exactly once, at the output.
    ocap = buf.capacity if out_capacity is None else out_capacity
    x, y, z, rgba, cnt = voxelize.downsample_cm(buf, cellsize, ocap)
    return chain_tail_cm(x, y, z, rgba, cnt, k=k, window=window, mult=mult, tile=tile)


def window_mean_distance_cm(x, y, z, cnt, *, k, window):
    """Morton-window kNN mean distance on coordinate rows.  Lowered for
    CUDA it is the fused Pallas kernel (ops/pallas_window_knn.py); every
    other platform gets the XLA form (ops/outliers.py)."""
    from .pallas_window_knn import window_knn_mean_distance_cm

    def _md_xla(x, y, z, cnt):
        return outliers._mean_knn_dist_window(
            jnp.stack([x, y, z], axis=-1), cnt, k=k, window=window
        )

    return jax.lax.platform_dependent(
        x, y, z, cnt,
        default=_md_xla,
        cuda=partial(window_knn_mean_distance_cm, k=k, window=window),
    )


def chain_tail_cm(x, y, z, rgba, cnt, *, k, window, mult, tile) -> PointBuffer:
    """Post-downsample tail of the fused chain on CHANNEL-MAJOR rows:
    window-kNN outlier keep-mask fused with the tile selection, then one
    compaction pass.  Shared with the point-axis-sharded chain
    (parallel/pointaxis.py) so tuning applies to both.

    The window kNN is ``window_mean_distance_cm``: the Triton kernel on
    the GPU, the XLA form everywhere else.
    """
    md = window_mean_distance_cm(x, y, z, cnt, k=k, window=window)
    valid = jnp.arange(x.shape[0], dtype=jnp.int32) < cnt
    keep = outliers._keep_from_mean_dists(md, valid, mult)
    point_tile = (rgba >> 24) & 0xFF
    tile = jnp.asarray(tile, jnp.uint32)
    keep = keep & ((tile == 0) | (point_tile == tile))
    return compaction.compact_cm(x, y, z, rgba, keep, cnt)


@partial(jax.jit, static_argnames=(
    "k", "out_capacity", "gy", "gz", "cap", "chunk"))
def downsample_outliers_tilefilter_exact(
    buf: PointBuffer,
    cellsize: jax.Array,
    k: int,
    mult: jax.Array,
    tile: jax.Array,
    out_capacity: int,
    gy: int,
    gz: int,
    cap: int,
    chunk: int = 256,
) -> tuple[PointBuffer, jax.Array]:
    """EXACT-outlier variant of the fused chain: the outlier stage uses
    the column-grid exact kNN (ops/cols_knn.py) plus a blocked brute-force
    fixup for the ring-uncovered points, so keep decisions match the
    brute-force oracle bit-for-bit in candidate SET (fp summation order
    aside).  Slower than the window chain (exact selection dominates
    — see cols_knn.py); this is the parity-faithful mode.  gy/gz/cap are the column-grid buckets for the downsampled
    cloud (plane extents of y/z in cells; max points per (y,z) column).

    Returns (result, n_uncovered_residual): the residual counts points
    whose md came from the brute-force fixup — the result is exact
    regardless; the count is exposed so callers/tests can see coverage.
    """
    from .cols_knn import bruteforce_md_subset, cols_knn_mean_distance

    x, y, z, rgba, cnt = voxelize.downsample_cm(buf, cellsize, out_capacity)
    xyz = jnp.stack([x, y, z], axis=-1)
    # voxel_unique: the downsample postcondition enables the per-column
    # top-9 pre-selection (see cols_knn.py)
    md, unc = cols_knn_mean_distance(
        xyz, cnt, jnp.asarray(cellsize, jnp.float32), k, gy=gy, gz=gz, cap=cap,
        chunk=chunk, voxel_unique=True,
    )
    md_fix = bruteforce_md_subset(xyz, cnt, unc, k)
    md = jnp.where(unc, md_fix, md)
    valid = jnp.arange(x.shape[0], dtype=jnp.int32) < cnt
    keep = outliers._keep_from_mean_dists(md, valid, mult)
    point_tile = (rgba >> 24) & 0xFF
    tile = jnp.asarray(tile, jnp.uint32)
    keep = keep & ((tile == 0) | (point_tile == tile))
    return compaction.compact_cm(x, y, z, rgba, keep, cnt), unc.sum()
