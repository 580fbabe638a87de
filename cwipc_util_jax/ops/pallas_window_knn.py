"""Pallas kernel (Triton route): fused Morton-window kNN mean distance.

The XLA form of the window-kNN outlier stage (ops/outliers.py
``_mean_knn_dist_window``) writes a [2W, N] squared-distance array to
device memory and sorts it along the window axis.  This kernel fuses the
stage per block of points:

* one program takes BLOCK consecutive (Morton-ordered) points; the
  coordinates arrive padded by W zero rows on either side, so the 2W
  shifted loads of the block never leave the buffer (the halo loads are
  served from cache, so device memory sees one read of xyz and one write
  of the result, ~16 B per point);
* the 2W squared distances are formed in registers, invalid neighbours
  (beyond the cloud's ends) carry F32_MAX;
* selection keeps a small sorted register list per point: the 2W-k
  largest distances when that is the shorter list (sum everything, then
  subtract them), otherwise the k smallest.  Either way the result is
  the mean over the k smallest candidates, as in the XLA form.

Block sizes are powers of two, as Triton requires.  Programs are
independent, so the grid runs in any order.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_F32_MAX = float(jnp.finfo(jnp.float32).max)

BLOCK = 512
NUM_WARPS = 4


def _valid_sqrt(d2):
    return jnp.where(d2 < _F32_MAX / 2, jnp.sqrt(jnp.maximum(d2, 0.0)), 0.0)


def _window_knn_kernel(count_ref, x_ref, y_ref, z_ref, md_ref, *,
                       window: int, k: int):
    start = pl.program_id(0) * BLOCK
    count = count_ref[0]
    ids = start + jnp.arange(BLOCK, dtype=jnp.int32)

    def coords(off):
        s = pl.ds(start + window + off, BLOCK)
        return (plgpu.load(x_ref.at[s]), plgpu.load(y_ref.at[s]),
                plgpu.load(z_ref.at[s]))

    bx, by, bz = coords(0)
    drop = 2 * window - k
    keep_largest = drop <= k  # track the shorter of the two lists
    n_track = drop if keep_largest else k
    fill = -1.0 if keep_largest else _F32_MAX

    def candidate(i, carry):
        total, tracked = carry
        w = i - window + (i >= window).astype(jnp.int32)  # skip offset 0
        nx, ny, nz = coords(w)
        dx, dy, dz = bx - nx, by - ny, bz - nz
        d2 = dx * dx + dy * dy + dz * dz
        nb = ids + w
        c = jnp.where((nb >= 0) & (nb < count), d2, _F32_MAX)
        if keep_largest:
            total = total + _valid_sqrt(c)
        # insertion into the sorted register list (descending for the
        # largest, ascending for the smallest)
        out = []
        for t in tracked:
            if keep_largest:
                out.append(jnp.maximum(t, c))
                c = jnp.minimum(t, c)
            else:
                out.append(jnp.minimum(t, c))
                c = jnp.maximum(t, c)
        return total, tuple(out)

    init = (
        jnp.zeros((BLOCK,), jnp.float32),
        tuple(jnp.full((BLOCK,), fill, jnp.float32) for _ in range(n_track)),
    )
    total, tracked = jax.lax.fori_loop(0, 2 * window, candidate, init)
    picked = jnp.zeros((BLOCK,), jnp.float32)
    for t in tracked:
        picked = picked + _valid_sqrt(t)
    kept = total - picked if keep_largest else picked
    md = jnp.where(ids < count, kept / float(k), 0.0)
    plgpu.store(md_ref.at[pl.ds(start, BLOCK)], md)


@partial(jax.jit, static_argnames=("k", "window", "interpret"))
def window_knn_mean_distance_cm(
    x: jax.Array, y: jax.Array, z: jax.Array, count: jax.Array, k: int,
    window: int = 16, interpret: bool = False,
) -> jax.Array:
    """Per-point mean distance to the k nearest among the +/-window
    array neighbours, on coordinate rows.  Same semantics as the XLA
    ``outliers._mean_knn_dist_window`` (whose divisor is min(k, 2W)).

    ``interpret`` runs the kernel in the Pallas interpreter (tests on a
    host without a GPU)."""
    cap = x.shape[0]
    kk = min(k, 2 * window)
    npad = -(-cap // BLOCK) * BLOCK

    def padded(a):
        lo = jnp.zeros((window,), jnp.float32)
        hi = jnp.zeros((window + npad - cap,), jnp.float32)
        return jnp.concatenate([lo, a.astype(jnp.float32), hi])

    md = pl.pallas_call(
        partial(_window_knn_kernel, window=window, k=kk),
        out_shape=jax.ShapeDtypeStruct((npad,), jnp.float32),
        grid=(npad // BLOCK,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="window_knn_mean_distance",
    )(jnp.asarray(count, jnp.int32).reshape(1), padded(x), padded(y), padded(z))
    return md[:cap]
