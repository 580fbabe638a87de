"""Multi-device registration: the per-camera axis on a device mesh.

The reference's registration flows loop over cameras — each camera's
cloud is analyzed/aligned against the union of all others (reference:
python/cwipc/registration/multicamera.py:632-741 per-camera loop,
registration/analyze.py per-tile sweeps).  On an N-camera rig with an
N-device mesh that loop is embarrassingly parallel: one camera per
device, the same per-pair program the single-device toolkit runs
(ops/knn.nn_search for analysis, registration/fine._icp_fused for
alignment), shard_mapped over the camera axis.  Device d holds camera
d's cloud and its own packed reference (everyone else's points); there
is no cross-device traffic inside a sweep — the win is pure N-way
latency hiding of the dominant NN searches.

Used by the multi-device dry run (__graft_entry__.dryrun_multichip)
with pose/stat parity asserted against the single-device loop, and by
tests/test_parallel.py on the virtual CPU mesh.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from .mesh import CAMERA_AXIS


def sharded_camera_nn(mesh, src_xyz, src_count, ref_xyz, ref_count, maxd):
    """Per-camera NN sweep, one camera per device.

    src_xyz [D, cap, 3] — camera d's points (padded), src_count [D];
    ref_xyz [D, rcap, 3] — camera d's reference = the other cameras'
    points packed on the host (padded), ref_count [D].  Returns
    (dist [D, cap], idx [D, cap]) with the single-device
    ops/knn.nn_search semantics per camera: +inf / -1 beyond ``maxd``.
    """
    from ..ops.knn import nn_search

    def per_cam(s_xyz, s_cnt, r_xyz, r_cnt):
        d, i = nn_search(
            s_xyz[0], s_cnt[0], r_xyz[0], r_cnt[0], jnp.float32(maxd)
        )
        return d[None], i[None]

    fn = shard_map(
        per_cam,
        mesh=mesh,
        in_specs=(P(CAMERA_AXIS), P(CAMERA_AXIS), P(CAMERA_AXIS), P(CAMERA_AXIS)),
        out_specs=(P(CAMERA_AXIS), P(CAMERA_AXIS)),
    )
    return jax.jit(fn)(src_xyz, src_count, ref_xyz, ref_count)


def sharded_camera_align(
    mesh, src_xyz, src_count, ref_xyz, ref_count, corr,
    *, variant: str = "p2point", max_iters: int = 10,
):
    """One fused fine-alignment run per camera, one camera per device.

    Same inputs as :func:`sharded_camera_nn`; returns the per-camera pose
    stack [D, 4, 4] from registration/fine._icp_fused.  ``corr`` may be
    scalar or [D]."""
    from ..registration.fine import _icp_fused

    corr_v = jnp.broadcast_to(jnp.asarray(corr, jnp.float32), (src_xyz.shape[0],))
    rcap = ref_xyz.shape[1]
    scap = src_xyz.shape[1]

    def per_cam(s_xyz, s_cnt, r_xyz, r_cnt, c):
        T = _icp_fused(
            s_xyz[0], s_cnt[0], r_xyz[0], r_cnt[0], c[0],
            jnp.float32(1e-6),
            jnp.zeros((rcap, 3), jnp.float32),
            jnp.zeros((scap, 3), jnp.float32),
            jnp.float32(1e-3),
            variant=variant, max_iters=max_iters,
        )
        return T[None]

    # check_vma off: the fused loop's converged-iteration lax.cond has a
    # pass-through branch whose outputs the varying-axis checker cannot
    # type (both branches are per-device-local math; nothing communicates)
    fn = shard_map(
        per_cam,
        mesh=mesh,
        in_specs=(
            P(CAMERA_AXIS), P(CAMERA_AXIS), P(CAMERA_AXIS), P(CAMERA_AXIS),
            P(CAMERA_AXIS),
        ),
        out_specs=P(CAMERA_AXIS),
        check_vma=False,
    )
    return jax.jit(fn)(src_xyz, src_count, ref_xyz, ref_count, corr_v)


def pack_camera_views(clouds):
    """Host-side packing for the per-camera sweeps: given a list of D
    (n_d, 3) float32 arrays, returns (src [D, cap, 3], src_count [D],
    ref [D, rcap, 3], ref_count [D]) where camera d's reference is the
    concatenation of every OTHER camera's points.  Pads with 3e38 (the
    framework's empty-slot coordinate)."""
    import numpy as np

    D = len(clouds)
    cap = 1 << max(3, int(np.ceil(np.log2(max(len(c) for c in clouds)))))
    rtot = max(sum(len(c) for j, c in enumerate(clouds) if j != d) for d in range(D))
    rcap = 1 << max(3, int(np.ceil(np.log2(max(rtot, 1)))))
    src = np.full((D, cap, 3), np.float32(3e38))
    ref = np.full((D, rcap, 3), np.float32(3e38))
    scnt = np.zeros((D,), np.int32)
    rcnt = np.zeros((D,), np.int32)
    for d, c in enumerate(clouds):
        src[d, : len(c)] = c
        scnt[d] = len(c)
        others = np.concatenate(
            [clouds[j] for j in range(D) if j != d], axis=0
        ) if D > 1 else np.zeros((0, 3), np.float32)
        ref[d, : len(others)] = others
        rcnt[d] = len(others)
    return src, scnt, ref, rcnt
