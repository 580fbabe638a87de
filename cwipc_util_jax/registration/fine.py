"""Pairwise fine alignment: the ICP family, jitted on device.

Re-implementation of the reference's ICP aligners
(reference: python/cwipc/registration/fine.py, built on Open3D there):

* RegistrationComputer        — base class with the auto-correspondence
  heuristic (half the centroid distance, fine.py:53-62),
* point-to-point ICP          — correspondence via the grid NN search,
  closed-form Kabsch/SVD update,
* point-to-plane ICP          — reference normals from the on-device
  Morton-window estimator, 6x6 linearized solve per iteration,
* generalized (plane-to-plane) ICP — the default, as in the reference
  (fine.py:290-317, o3d GeneralizedICP there): per-point disc
  covariances C = I - (1-eps) n n^T on BOTH clouds from the on-device
  normal estimator, correspondences weighted by the Mahalanobis matrix
  M_i = (C_ref + R C_src R^T)^-1, one damped 6x6 Gauss-Newton step per
  iteration.

Each iteration is: one device NN search + small linear algebra; an
optional per-iteration callback mirrors the tensor-ICP variant's hook
(fine.py:135-210).
"""

from __future__ import annotations

import os
from functools import partial
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.pointcloud import cwipc_pointcloud_wrapper
from ..ops.knn import nn_search
from .abstract import AlignmentAlgorithm, RegistrationTransformation
from .util import BaseAlgorithm, cwipc_transform, transformation_identity

DEFAULT_MAX_ITERATIONS = 30
DEFAULT_RELATIVE_TOLERANCE = 1e-6


# ---------------------------------------------------------------------------
# Fused device ICP: the whole loop as ONE XLA program.
#
# The host loop below dispatches one NN-search program per iteration and
# reads the matches back each time.  This variant puts the loop under
# lax.fori_loop — one dispatch per aligner run.  f32 throughout (x64 is
# disabled); the solves operate on residual /
# centered quantities, so final-pose precision is set by the last
# iteration's small residuals rather than absolute-coordinate cancellation
# (validated against the host-loop thresholds in tests/test_registration.py).
# Break semantics mirror the host loop exactly: stop with the pose
# unchanged when matches < 3, stop after applying the step when the rmse
# stabilizes within the relative tolerance.
# ---------------------------------------------------------------------------


def _small_rotation_j(x):
    """Rodrigues rotation from small-angle parameters ([3] f32)."""
    theta = jnp.sqrt(jnp.sum(x * x))
    k = x / jnp.maximum(theta, 1e-20)
    K = jnp.array(
        [[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]], jnp.float32
    )
    K = K.at[0, 1].set(-k[2]).at[0, 2].set(k[1])
    K = K.at[1, 0].set(k[2]).at[1, 2].set(-k[0])
    K = K.at[2, 0].set(-k[1]).at[2, 1].set(k[0])
    R = (
        jnp.eye(3, dtype=jnp.float32)
        + jnp.sin(theta) * K
        + (1.0 - jnp.cos(theta)) * jnp.matmul(K, K, precision=_HI)
    )
    return jnp.where(theta < 1e-12, jnp.eye(3, dtype=jnp.float32), R)


def _delta_from_x(x):
    T = jnp.eye(4, dtype=jnp.float32)
    T = T.at[:3, :3].set(_small_rotation_j(x[:3]))
    return T.at[:3, 3].set(x[3:6])


_HI = jax.lax.Precision.HIGHEST


@partial(jax.jit, static_argnames=("variant", "max_iters"))
def _icp_fused(
    src0, src_count, ref_xyz, ref_count, corr, tol,
    ref_normals, src_normals, gicp_eps,
    *, variant: str, max_iters: int,
):
    cap = src0.shape[0]
    rcap = ref_xyz.shape[0]
    row = jnp.arange(cap, dtype=jnp.int32)
    I3 = jnp.eye(3, dtype=jnp.float32)
    I6 = jnp.eye(6, dtype=jnp.float32)

    def delta_p2point(src, dst, w, m, T):
        wn = jnp.maximum(m, 1.0)
        cs = jnp.sum(src * w[:, None], axis=0) / wn
        cd = jnp.sum(dst * w[:, None], axis=0) / wn
        H = jnp.matmul(
            ((src - cs) * w[:, None]).T, dst - cd, precision=_HI
        )
        U, _s, Vt = jnp.linalg.svd(H)
        d = jnp.sign(jnp.linalg.det(jnp.matmul(Vt.T, U.T, precision=_HI)))
        D = jnp.diag(jnp.array([1.0, 1.0, 0.0], jnp.float32)) + jnp.diag(
            jnp.array([0.0, 0.0, 1.0], jnp.float32)
        ) * d
        R = jnp.matmul(jnp.matmul(Vt.T, D, precision=_HI), U.T, precision=_HI)
        t = cd - jnp.matmul(R, cs, precision=_HI)
        T4 = jnp.eye(4, dtype=jnp.float32)
        return T4.at[:3, :3].set(R).at[:3, 3].set(t)

    def delta_p2plane(src, dst, idx_c, w, m, T):
        n = ref_normals[idx_c]
        c = jnp.cross(src, n)
        A = jnp.concatenate([c, n], axis=1)  # [cap, 6]
        b = jnp.sum((dst - src) * n, axis=1)
        Aw = A * w[:, None]
        G = jnp.matmul(Aw.T, A, precision=_HI)
        g = jnp.matmul(Aw.T, b, precision=_HI)
        # tiny Tikhonov term stands in for lstsq's min-norm behavior on
        # (near-)degenerate scenes; well-conditioned solves are unchanged
        G = G + I6 * (1e-8 * jnp.maximum(jnp.trace(G) / 6.0, 1.0))
        return _delta_from_x(jnp.linalg.solve(G, g))

    def delta_gicp(src, dst, idx_c, w, m, T):
        eps = gicp_eps
        n_d = ref_normals[idx_c]
        n_s = jnp.matmul(src_normals, T[:3, :3].T, precision=_HI)

        def disc(nrm):
            nn = nrm[:, :, None] * nrm[:, None, :]
            okn = jnp.sum(nrm * nrm, axis=1) > 0.5
            return jnp.where(okn[:, None, None], I3[None] - (1.0 - eps) * nn, I3[None])

        # closed-form batched 3x3 inverse: a batched small-matrix LU
        # (jnp.linalg.inv) is a poor fit for a per-point 3x3 system
        C = disc(n_d) + disc(n_s)
        a, b, c = C[:, 0, 0], C[:, 0, 1], C[:, 0, 2]
        d, e, f = C[:, 1, 0], C[:, 1, 1], C[:, 1, 2]
        g, h, i = C[:, 2, 0], C[:, 2, 1], C[:, 2, 2]
        co00 = e * i - f * h
        co01 = c * h - b * i
        co02 = b * f - c * e
        co10 = f * g - d * i
        co11 = a * i - c * g
        co12 = c * d - a * f
        co20 = d * h - e * g
        co21 = b * g - a * h
        co22 = a * e - b * d
        det = a * co00 + b * co10 + c * co20
        inv_det = w / jnp.where(jnp.abs(det) > 1e-30, det, 1.0)
        M = jnp.stack(
            [
                jnp.stack([co00, co01, co02], axis=1),
                jnp.stack([co10, co11, co12], axis=1),
                jnp.stack([co20, co21, co22], axis=1),
            ],
            axis=1,
        ) * inv_det[:, None, None]

        def inner(_i, carry):
            Td = carry
            cur = jnp.matmul(src, Td[:3, :3].T, precision=_HI) + Td[:3, 3]
            r = dst - cur
            Z = jnp.zeros((cap,), jnp.float32)
            S = jnp.stack(
                [
                    jnp.stack([Z, -cur[:, 2], cur[:, 1]], axis=1),
                    jnp.stack([cur[:, 2], Z, -cur[:, 0]], axis=1),
                    jnp.stack([-cur[:, 1], cur[:, 0], Z], axis=1),
                ],
                axis=1,
            )  # [cap, 3, 3]
            J = jnp.concatenate(
                [-S, jnp.broadcast_to(I3, (cap, 3, 3))], axis=2
            )  # [cap, 3, 6]
            JtM = jnp.einsum("mij,mik->mjk", J, M, precision=_HI)  # [cap,6,3]
            A6 = jnp.einsum("mji,mjk->ik", JtM.transpose(0, 2, 1), J, precision=_HI)
            b6 = jnp.einsum("mjk,mk->j", JtM, r, precision=_HI)
            A6 = A6 + I6 * (1e-9 * jnp.maximum(jnp.trace(A6) / 6.0, 1.0))
            x = jnp.linalg.solve(A6, b6)
            return jnp.matmul(_delta_from_x(x), Td, precision=_HI)

        return jax.lax.fori_loop(0, 4, inner, jnp.eye(4, dtype=jnp.float32))

    # Reference-side NN preparation (grid keys, sort, gather) is
    # loop-invariant — the reference cloud never moves, only the source
    # pose does — so only the query runs inside the loop.
    from ..ops.knn import FINE_FACTOR, _nn_prepare, _nn_query

    rcap_full = ref_xyz.shape[0]
    ridx_full = jnp.arange(rcap_full, dtype=jnp.int32)
    rvalid = ridx_full < ref_count
    svalid = row < src_count
    maxd = jnp.maximum(jnp.asarray(corr, jnp.float32), 1e-9)
    fine_cell = maxd / FINE_FACTOR
    prep_f = _nn_prepare(ref_xyz, rvalid, ridx_full, fine_cell)
    prep_c = _nn_prepare(ref_xyz, rvalid, ridx_full, maxd)
    qblock = min(4096, cap)

    def nn_query(src):
        d_f, i_f = _nn_query(src, svalid, prep_f, fine_cell, fine_cell, 48, qblock)
        d_c, i_c = _nn_query(src, svalid, prep_c, maxd, maxd, 48, qblock)
        take_fine = d_f <= d_c
        dist = jnp.where(take_fine, d_f, d_c)
        idx = jnp.where(take_fine, i_f, i_c)
        dist = jnp.where(svalid, dist, jnp.inf)
        return dist, jnp.where(svalid, idx, -1)

    def body(it, carry):
        # Converged/stopped iterations skip the whole body via lax.cond —
        # the fixed-trip loop would otherwise run the NN query for all
        # max_iters even after convergence at iteration 3.
        return jax.lax.cond(carry[2], lambda c: c, _iteration, carry)

    def _iteration(carry):
        T, prev_err, done = carry
        # HIGHEST on every coordinate/pose matmul: a reduced-precision
        # default (TF32 on the GPU) would round absolute coordinates by
        # ~1e-3 relative into each NN search and degrade the composed pose
        src = jnp.matmul(src0, T[:3, :3].T, precision=_HI) + T[:3, 3]
        dist, idx = nn_query(src)
        valid = jnp.isfinite(dist) & (row < src_count)
        w = valid.astype(jnp.float32)
        m = jnp.sum(w)
        err = jnp.sqrt(
            jnp.sum(jnp.where(valid, dist * dist, 0.0)) / jnp.maximum(m, 1.0)
        )
        idx_c = jnp.clip(idx, 0, rcap - 1)
        dst = ref_xyz[idx_c]
        if variant == "p2point":
            delta = delta_p2point(src, dst, w, m, T)
        elif variant == "p2plane":
            delta = delta_p2plane(src, dst, idx_c, w, m, T)
        else:
            delta = delta_gicp(src, dst, idx_c, w, m, T)
        too_few = m < 3.0
        delta = jnp.where(too_few, jnp.eye(4, dtype=jnp.float32), delta)
        T2 = jnp.matmul(delta, T, precision=_HI)
        conv = jnp.abs(prev_err - err) < tol * jnp.maximum(prev_err, 1e-12)
        return (T2, err, done | too_few | conv)

    T0 = jnp.eye(4, dtype=jnp.float32)
    T, _e, _d = jax.lax.fori_loop(
        0, max_iters, body, (T0, jnp.float32(jnp.inf), jnp.bool_(False))
    )
    return T


class RegistrationComputer(BaseAlgorithm, AlignmentAlgorithm):
    """Base class for the pairwise aligners."""

    max_iterations = DEFAULT_MAX_ITERATIONS
    _fused_variant: Optional[str] = None  # set by subclasses that fuse

    def __init__(self) -> None:
        BaseAlgorithm.__init__(self)
        self.correspondence: Optional[float] = None
        self._transformation = transformation_identity()
        self._result_pc: Optional[cwipc_pointcloud_wrapper] = None
        self.per_iteration_callback: Optional[Callable[[int, float], None]] = None

    def set_correspondence(self, correspondence: float) -> None:
        self.correspondence = correspondence

    def _auto_correspondence(self) -> float:
        """Half the distance between the two cloud centroids, with a floor
        (reference heuristic, fine.py:53-62)."""
        a = self.get_filtered_source_pointcloud().get_numpy_matrix(onlyGeometry=True)
        b = self.get_filtered_reference_pointcloud().get_numpy_matrix(onlyGeometry=True)
        if a.shape[0] == 0 or b.shape[0] == 0:
            return 0.1
        d = float(np.linalg.norm(a.mean(axis=0) - b.mean(axis=0)))
        return max(d / 2, 0.02)

    # -- results ---------------------------------------------------------------

    def get_result_transformation(self) -> RegistrationTransformation:
        return self._transformation

    def get_result_pointcloud(self) -> cwipc_pointcloud_wrapper:
        if self._result_pc is None:
            self._result_pc = cwipc_transform(self.get_source_pointcloud(), self._transformation)
        return self._result_pc

    def get_result_pointcloud_full(self) -> cwipc_pointcloud_wrapper:
        from .. import cwipc_join

        moved = self.get_result_pointcloud()
        return cwipc_join(moved, self.get_reference_pointcloud())

    # -- the ICP loop ------------------------------------------------------------

    def _correspondences(self, src_xyz: np.ndarray, corr: float):
        """NN matches src->ref via the device grid search."""
        from ..core.buffers import buffer_from_arrays

        n = src_xyz.shape[0]
        z = np.zeros(n, np.uint8)
        sbuf = buffer_from_arrays(src_xyz.astype(np.float32), z, z, z, z)
        rbuf = self._ref_buf
        dist, idx = nn_search(sbuf.xyz, sbuf.count, rbuf.xyz, rbuf.count, jnp.float32(corr))
        # host-side slicing: a device [:n] slice is one tiny program per
        # distinct n
        dist = np.asarray(dist)[:n]
        idx = np.asarray(idx)[:n]
        ok = np.isfinite(dist)
        return ok, idx, dist

    def _solve_step(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        dst_idx: np.ndarray,
        src_idx: np.ndarray,
        T: np.ndarray,
    ) -> np.ndarray:
        raise NotImplementedError

    def run(self) -> bool:
        src_pc = self.get_filtered_source_pointcloud()
        ref_pc = self.get_filtered_reference_pointcloud()
        if src_pc.count() == 0 or ref_pc.count() == 0:
            return False
        corr = self.correspondence if self.correspondence else self._auto_correspondence()

        self._ref_buf = ref_pc._access_buffer()
        self._ref_xyz = ref_pc.get_numpy_matrix(onlyGeometry=True).astype(np.float64)
        self._prepare_reference()

        # fused path: the whole loop as ONE device program (see
        # _icp_fused).  The host loop remains for per-iteration callbacks
        # (the tensor-ICP hook) and via CWIPC_FUSED_ICP=0.
        use_fused = os.environ.get("CWIPC_FUSED_ICP", "") != "0"
        if (
            self._fused_variant is not None
            and self.per_iteration_callback is None
            and use_fused
        ):
            sbuf = src_pc._access_buffer()
            rbuf = self._ref_buf
            rcap = rbuf.xyz.shape[0]
            scap = sbuf.xyz.shape[0]
            refn = np.zeros((rcap, 3), np.float32)
            srcn = np.zeros((scap, 3), np.float32)
            if self._fused_variant in ("p2plane", "gicp"):
                refn[: self._ref_normals.shape[0]] = self._ref_normals
            if self._fused_variant == "gicp":
                srcn[: self._src_normals.shape[0]] = self._src_normals
            T_dev = _icp_fused(
                sbuf.xyz, sbuf.count, rbuf.xyz, rbuf.count,
                jnp.float32(corr), jnp.float32(DEFAULT_RELATIVE_TOLERANCE),
                jnp.asarray(refn), jnp.asarray(srcn),
                jnp.float32(getattr(self, "gicp_epsilon", 1e-3)),
                variant=self._fused_variant,
                max_iters=self.max_iterations,
            )
            self._transformation = np.asarray(T_dev, np.float64)
            self._result_pc = None
            return True

        src0 = src_pc.get_numpy_matrix(onlyGeometry=True).astype(np.float64)
        T = np.identity(4)
        prev_err = np.inf
        for it in range(self.max_iterations):
            src = src0 @ T[:3, :3].T + T[:3, 3]
            ok, idx, dist = self._correspondences(src, corr)
            if ok.sum() < 3:
                break
            err = float(np.sqrt((dist[ok] ** 2).mean()))
            if self.per_iteration_callback:
                self.per_iteration_callback(it, err)
            delta = self._solve_step(
                src[ok], self._ref_xyz[idx[ok]], idx[ok], np.nonzero(ok)[0], T
            )
            T = delta @ T
            if abs(prev_err - err) < DEFAULT_RELATIVE_TOLERANCE * max(prev_err, 1e-12):
                break
            prev_err = err
        self._transformation = T
        self._result_pc = None
        return True

    def _prepare_reference(self) -> None:
        pass


def _kabsch(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Closed-form rigid transform minimizing |R src + t - dst|^2."""
    cs = src.mean(axis=0)
    cd = dst.mean(axis=0)
    H = (src - cs).T @ (dst - cd)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    t = cd - R @ cs
    T = np.identity(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


class RegistrationComputer_ICP_Point2Point(RegistrationComputer):
    """Point-to-point ICP (reference: fine.py:81-133)."""

    _fused_variant = "p2point"

    def _solve_step(self, src, dst, dst_idx, src_idx, T):
        return _kabsch(src, dst)


class RegistrationComputer_Tensor_ICP_Point2Point(RegistrationComputer_ICP_Point2Point):
    """Alias of the device-kernel point-to-point path; the reference's
    "tensor" variant (fine.py:135-210) exists for its per-iteration callback,
    which the base class supports directly here."""


class RegistrationComputer_ICP_Point2Plane(RegistrationComputer):
    """Point-to-plane ICP: minimizes sum(((R s + t - d) . n_d)^2) with
    normals estimated on-device (reference: fine.py:212-288, normal radius
    0.02 / 30 neighbors, outward orientation)."""

    normal_radius = 0.02  # reference default; raised to cover sparse clouds
    _fused_variant = "p2plane"

    def _effective_normal_radius(self, pc: cwipc_pointcloud_wrapper) -> float:
        """The neighborhood must span a few points: max(configured radius,
        3x the cloud's point spacing)."""
        spacing = pc.cellsize()
        if spacing <= 0:
            m = pc.get_numpy_matrix(onlyGeometry=True)
            if m.shape[0] > 1:
                sample = m[:: max(1, m.shape[0] // 256)][:256]
                d2 = ((sample[:, None, :] - sample[None, :, :]) ** 2).sum(-1)
                np.fill_diagonal(d2, np.inf)
                spacing = float(np.median(np.sqrt(d2.min(axis=1))))
            else:
                spacing = 0.01
        return max(self.normal_radius, spacing * 3)

    def _prepare_reference(self) -> None:
        from .normals import estimate_normals

        ref_pc = self.get_filtered_reference_pointcloud()
        radius = self._effective_normal_radius(ref_pc)
        rbuf = self._ref_buf
        normals = np.asarray(estimate_normals(rbuf, jnp.float32(radius)))
        self._ref_normals = normals[: self._ref_xyz.shape[0]].astype(np.float64)

    def _solve_step(self, src, dst, dst_idx, src_idx, T):
        n = self._ref_normals[dst_idx]
        # linearized rotation: x = [rx, ry, rz, tx, ty, tz]
        c = np.cross(src, n)
        A = np.concatenate([c, n], axis=1)  # [m, 6]
        b = np.sum((dst - src) * n, axis=1)  # [m]
        x, *_ = np.linalg.lstsq(A, b, rcond=None)
        rx, ry, rz, tx, ty, tz = x
        R = _small_rotation(rx, ry, rz)
        T = np.identity(4)
        T[:3, :3] = R
        T[:3, 3] = (tx, ty, tz)
        return T


def _small_rotation(rx: float, ry: float, rz: float) -> np.ndarray:
    """Proper rotation from small-angle parameters (via Rodrigues)."""
    theta = float(np.sqrt(rx * rx + ry * ry + rz * rz))
    if theta < 1e-12:
        return np.identity(3)
    k = np.array([rx, ry, rz]) / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.identity(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


class RegistrationComputer_ICP_Generalized(RegistrationComputer_ICP_Point2Plane):
    """Generalized (plane-to-plane) ICP, the reference's default fine
    aligner (reference: fine.py:290-317, o3d GeneralizedICP there, after
    Segal et al.): every point carries a disc covariance
    C = I - (1 - eps) n n^T (eps along the normal, 1 in-plane) from its
    estimated normal; each correspondence is weighted by the Mahalanobis
    matrix M_i = (C_ref_i + R C_src_i R^T)^-1 and one damped Gauss-Newton
    step solves the 6x6 normal equations."""

    gicp_epsilon = 1e-3  # Segal's disc regularization along the normal
    _fused_variant = "gicp"

    def _prepare_reference(self) -> None:
        super()._prepare_reference()
        from .normals import estimate_normals

        src_pc = self.get_filtered_source_pointcloud()
        radius = self._effective_normal_radius(src_pc)
        sbuf = src_pc._access_buffer()
        normals = np.asarray(estimate_normals(sbuf, jnp.float32(radius)))
        self._src_normals = normals[: src_pc.count()].astype(np.float64)

    def _solve_step(self, src, dst, dst_idx, src_idx, T):
        eps = self.gicp_epsilon
        n_d = self._ref_normals[dst_idx]  # [m, 3]
        # source normals rotated into the current pose
        n_s = self._src_normals[src_idx] @ T[:3, :3].T

        def disc_cov(n):
            # I - (1-eps) n n^T; for unnormalized/zero normals fall back to I
            nn = n[:, :, None] * n[:, None, :]
            norm2 = np.sum(n * n, axis=1)
            ok = norm2 > 0.5
            return np.where(
                ok[:, None, None], np.identity(3)[None] - (1.0 - eps) * nn,
                np.identity(3)[None],
            )

        # M_i = (C_ref + R C_src R^T)^-1: 3x3 batched inverse
        Csum = disc_cov(n_d) + disc_cov(n_s)
        M = np.linalg.inv(Csum)

        # Gauss-Newton on the Mahalanobis cost with FIXED matches and
        # weights, iterated a few times: with the disc model's strong
        # anisotropy (1/eps: 1 weight ratio along the normal) one
        # linearized step underestimates the motion, which left the pose
        # short of convergence on noisy pairs (the reference's o3d GICP
        # also runs an inner optimization per correspondence set).
        m = src.shape[0]
        Td = np.identity(4)
        cur = src
        for _ in range(4):
            r = dst - cur
            S = np.zeros((m, 3, 3))
            S[:, 0, 1] = -cur[:, 2]
            S[:, 0, 2] = cur[:, 1]
            S[:, 1, 0] = cur[:, 2]
            S[:, 1, 2] = -cur[:, 0]
            S[:, 2, 0] = -cur[:, 1]
            S[:, 2, 1] = cur[:, 0]
            Jw = -S  # [m, 3, 3]
            J = np.concatenate(
                [Jw, np.broadcast_to(np.identity(3), (m, 3, 3))], axis=2
            )  # [m,3,6]
            JtM = np.einsum("mij,mik->mjk", J, M)  # [m, 6, 3]
            A = np.einsum("mji,mjk->ik", JtM.transpose(0, 2, 1), J)  # 6x6
            b = np.einsum("mjk,mk->j", JtM, r)
            # light Levenberg damping keeps degenerate scenes solvable
            A = A + np.identity(6) * (1e-9 * max(np.trace(A) / 6.0, 1.0))
            x = np.linalg.solve(A, b)
            rx, ry, rz, tx, ty, tz = x
            Ts = np.identity(4)
            Ts[:3, :3] = _small_rotation(rx, ry, rz)
            Ts[:3, 3] = (tx, ty, tz)
            Td = Ts @ Td
            cur = src @ Td[:3, :3].T + Td[:3, 3]
            if np.abs(x).max() < 1e-9:
                break
        return Td


DEFAULT_FINE_ALIGNMENT_ALGORITHM = RegistrationComputer_ICP_Generalized

# Reference-parity names (reference: registration/fine.py:16,321-325).  The
# reference types ICP outcomes as open3d's RegistrationResult (aliased to
# Any); here results are plain (transformation, rmse, correspondences).
RegistrationResult = Any

ALL_FINE_ALIGNMENT_ALGORITHMS = [
    RegistrationComputer_ICP_Point2Point,
    RegistrationComputer_ICP_Point2Plane,
    RegistrationComputer_ICP_Generalized,
]

HELP_FINE_ALIGNMENT_ALGORITHMS = """
Fine alignment algorithms:
    RegistrationComputer_ICP_Point2Point   classic point-to-point ICP
    RegistrationComputer_ICP_Point2Plane   point-to-plane ICP
    RegistrationComputer_ICP_Generalized   plane-to-plane GICP (default)
"""
