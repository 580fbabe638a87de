"""On-device surface-normal estimation.

The reference estimates normals with Open3D KDTree searches
(reference: python/cwipc/registration/util.py:114-144,
python/cwipc/registration/fine.py:246-276).  Device version: points are
sorted along a Morton curve, each point's neighborhood is its +/-window
neighbors in that order (gather-free, see ops/outliers.py for the same
pattern), the local covariance is accumulated with masked contiguous
shifts, and the normal is the eigenvector of the smallest eigenvalue of the
batched 3x3 covariance (jnp.linalg.eigh on [N,3,3] — tiny batched
solves).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.buffers import PointBuffer
from ..ops.voxelize import _MORTON_MAX, morton3

_SENTINEL = jnp.iinfo(jnp.int32).max


@partial(jax.jit, static_argnames=("window",))
def estimate_normals(
    buf: PointBuffer,
    radius: jax.Array,
    window: int = 16,
) -> jax.Array:
    """Outward-oriented unit normals [capacity, 3] (zeros for padding).

    radius: neighborhood radius (neighbors beyond it are excluded, matching
    the reference's KDTreeSearchParamHybrid(radius, max_nn) contract).
    """
    cap = buf.capacity
    idx = jnp.arange(cap, dtype=jnp.int32)
    valid = idx < buf.count

    # Morton-order the points (cell = radius so the window covers the ball).
    inv = 1.0 / jnp.maximum(jnp.asarray(radius, jnp.float32), 1e-9)
    v = jnp.floor(buf.xyz * inv).astype(jnp.int32)
    vmin = jnp.min(jnp.where(valid[:, None], v, _SENTINEL), axis=0)
    vm = jnp.clip(v - jnp.where(vmin == _SENTINEL, 0, vmin)[None, :], 0, _MORTON_MAX)
    key = jnp.where(valid, morton3(vm[:, 0], vm[:, 1], vm[:, 2]), _SENTINEL)
    skey, sx, sy, sz, sidx = jax.lax.sort(
        (key, buf.xyz[:, 0], buf.xyz[:, 1], buf.xyz[:, 2], idx), num_keys=1
    )
    sxyz = jnp.stack([sx, sy, sz], axis=-1)

    r2 = jnp.asarray(radius, jnp.float32) ** 2

    def accum(carry, w):
        # accumulate moments of d = neighbor - query, NOT of absolute
        # coordinates: |d| <= radius, so E[dd^T] - E[d]E[d]^T (the same
        # covariance — a per-row constant shift cancels) stays conditioned
        # in f32, while absolute second moments of a cloud meters from the
        # origin would drown the ~radius^2 variance in rounding noise
        s, sw, sww = carry
        rolled = jnp.roll(sxyz, -w, axis=0)
        nb = idx + w
        ok = (nb >= 0) & (nb < buf.count) & (idx < buf.count)
        d = rolled - sxyz
        ok = ok & (jnp.sum(d * d, axis=-1) <= r2)
        wgt = ok.astype(jnp.float32)[:, None]
        s = s + d * wgt
        sw = sw + wgt[:, 0]
        sww = sww + (d[:, :, None] * d[:, None, :]) * wgt[:, :, None]
        return (s, sw, sww), None

    offsets = jnp.asarray([w for w in range(-window, window + 1)], jnp.int32)
    (s, sw, sww), _ = jax.lax.scan(
        accum,
        (
            jnp.zeros((cap, 3), jnp.float32),
            jnp.zeros((cap,), jnp.float32),
            jnp.zeros((cap, 3, 3), jnp.float32),
        ),
        offsets,
    )

    n = jnp.maximum(sw, 1.0)[:, None]
    mean = s / n
    cov = sww / n[:, :, None] - mean[:, :, None] * mean[:, None, :]
    # smallest-eigenvalue eigenvector of each 3x3 covariance
    _, vecs = jnp.linalg.eigh(cov)
    normal = vecs[:, :, 0]

    # orient outward from the cloud centroid (the reference flips Open3D's
    # toward-camera orientation, registration/util.py:131-141)
    total = jnp.maximum(buf.count.astype(jnp.float32), 1.0)
    centroid = jnp.sum(jnp.where(valid[:, None], buf.xyz, 0.0), axis=0) / total
    outward = jnp.sum(normal * (sxyz - centroid), axis=-1) < 0
    normal = jnp.where(outward[:, None], -normal, normal)

    # scatter back to original order
    out = jnp.zeros((cap, 3), jnp.float32).at[sidx].set(normal)
    return jnp.where(valid[:, None], out, 0.0)
