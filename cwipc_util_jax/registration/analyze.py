"""Alignment analyzers: nearest-distance statistics between clouds.

Re-implementation of the reference's analyzer family
(reference: python/cwipc/registration/analyze.py): per-point
nearest-neighbor distances from source to reference (scipy KDTree there;
the device grid search ops/knn.py here), distance histogram, and
"correspondence" extraction — the distance that best characterizes how far
the source is from the reference — via mean / trimmed mean / median / mode
(histogram peak) / 2mode / q=NN (percentile) measures.  The distance
density defaults to a gaussian-KDE histogram like the reference
(analyze.py:171-179, use_kde at :48,275); `use_kde = False` selects the
raw histogram.  The symmetric variant (default, analyze.py:284) analyzes
both directions and keeps the worse correspondence.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.pointcloud import cwipc_pointcloud_wrapper
from ..ops.knn import nn_search
from .abstract import AnalysisAlgorithm, AnalysisResults, OverlapAnalysisAlgorithm, OverlapAnalysisResults
from .util import BaseAlgorithm

DEFAULT_MAX_CORRESPONDENCE = 0.1  # 10cm: sane upper bound for camera misalignment
DEFAULT_MIN_CORRESPONDENCE = 0.0001
HISTOGRAM_BINS = 400  # reference: histogram_bincount default (analyze.py:35)
FLOOR_LEVEL = 0.1  # points below this Y are "floor" and can be excluded


def _nn_distances(src: cwipc_pointcloud_wrapper, ref: cwipc_pointcloud_wrapper, max_distance: float, ignore_nearest: int = 0) -> np.ndarray:
    """Finite NN distances source->reference (inf = no match in range)."""
    sbuf = src._access_buffer()
    rbuf = ref._access_buffer()
    if ignore_nearest > 0:
        # self-precision mode: the distance to the (ignore_nearest)-th real
        # neighbor.  A 1-NN query of a cloud against itself always returns
        # the point itself at distance 0, so this needs a k-th-neighbor
        # query (the reference's scipy-KDTree k-offset, analyze.py:120-123).
        from scipy.spatial import cKDTree

        # slice AFTER the host transfer: a device-side [:count] slice is
        # its own tiny program per distinct count
        spts = np.asarray(sbuf.xyz)[: src.count()]
        rpts = np.asarray(rbuf.xyz)[: ref.count()]
        if len(rpts) <= ignore_nearest:
            return np.empty(0, np.float32)
        tree = cKDTree(rpts)
        dist, _ = tree.query(spts, k=ignore_nearest + 1, workers=-1)
        d = np.atleast_2d(dist)[:, -1]
        return d[np.isfinite(d) & (d <= max_distance)].astype(np.float32)
    dist, _ = nn_search(
        sbuf.xyz, sbuf.count, rbuf.xyz, rbuf.count, jnp.float32(max_distance)
    )
    return np.asarray(dist)[: src.count()]


# One device program for a whole batch of same-capacity NN queries: the
# multicamera pre/post analysis sweeps run K (camera vs union-of-others)
# analyses back to back — vmapping the queries turns 2K dispatches into 2.
_nn_search_batch = jax.jit(jax.vmap(nn_search, in_axes=(0, 0, 0, 0, None)))

# variant with ONE shared reference cloud (the iterative strategy's
# candidate-overlap scan): avoids replicating the registered set k times
# and keeps its capacity out of the batch dimension
_nn_search_batch_shared = jax.jit(jax.vmap(nn_search, in_axes=(0, 0, None, None, None)))


def nn_distances_batch(
    src_pts: "list[np.ndarray]",
    ref_pts: "list[np.ndarray]",
    max_distance: float,
) -> "list[np.ndarray]":
    """Finite-or-inf NN distances for K (source, reference) point-set pairs,
    computed in ONE device dispatch.  Entry i of the result has length
    len(src_pts[i])."""
    from ..core.buffers import bucket_capacity

    k = len(src_pts)
    assert k == len(ref_pts)
    scap = bucket_capacity(max(max((len(p) for p in src_pts), default=1), 1))
    rcap = bucket_capacity(max(max((len(p) for p in ref_pts), default=1), 1))
    sx = np.zeros((k, scap, 3), np.float32)
    rx = np.zeros((k, rcap, 3), np.float32)
    sc = np.empty(k, np.int32)
    rc = np.empty(k, np.int32)
    for i, (s, r) in enumerate(zip(src_pts, ref_pts)):
        sx[i, : len(s)] = s
        rx[i, : len(r)] = r
        sc[i] = len(s)
        rc[i] = len(r)
    dist, _ = _nn_search_batch(
        jnp.asarray(sx), jnp.asarray(sc), jnp.asarray(rx), jnp.asarray(rc),
        jnp.float32(max_distance),
    )
    dist = np.asarray(dist)
    return [dist[i, : len(s)] for i, s in enumerate(src_pts)]


def nn_distances_batch_shared_ref(
    src_pts: "list[np.ndarray]",
    ref_pts: np.ndarray,
    max_distance: float,
) -> "list[np.ndarray]":
    """nn_distances_batch with ONE reference point set shared by every
    query — the reference cloud is not replicated across the batch."""
    from ..core.buffers import bucket_capacity

    k = len(src_pts)
    scap = bucket_capacity(max(max((len(p) for p in src_pts), default=1), 1))
    rcap = bucket_capacity(max(len(ref_pts), 1))
    sx = np.zeros((k, scap, 3), np.float32)
    sc = np.empty(k, np.int32)
    for i, s in enumerate(src_pts):
        sx[i, : len(s)] = s
        sc[i] = len(s)
    rx = np.zeros((rcap, 3), np.float32)
    rx[: len(ref_pts)] = ref_pts
    dist, _ = _nn_search_batch_shared(
        jnp.asarray(sx), jnp.asarray(sc), jnp.asarray(rx),
        jnp.int32(len(ref_pts)), jnp.float32(max_distance),
    )
    dist = np.asarray(dist)
    return [dist[i, : len(s)] for i, s in enumerate(src_pts)]


class RegistrationAnalyzer(BaseAlgorithm, AnalysisAlgorithm):
    """One-directional analyzer: how far is the source from the reference."""

    plot_label: Optional[str] = None

    def __init__(self) -> None:
        BaseAlgorithm.__init__(self)
        self.correspondence_method = "mean"
        self._extra_methods: Tuple[str, ...] = ()
        self.max_correspondence = DEFAULT_MAX_CORRESPONDENCE
        self.min_correspondence = DEFAULT_MIN_CORRESPONDENCE
        # binsize semantics engage only when the caller SETS a minimum
        # correspondence (reference: histogram_binsize defaults to 0 and
        # the default histogram is bincount=400, analyze.py:35-37,148-159)
        self._histogram_binsize: float | None = None
        self.ignore_nearest = 0
        self.ignore_floor = False
        # Reference parity: the distance density defaults to a gaussian
        # KDE evaluated on the histogram grid (analyze.py:48,171-179,275).
        self.use_kde = True
        self.gaussian_bw_method = None
        self.histogram_bincount = HISTOGRAM_BINS
        self._results: Optional[AnalysisResults] = None

    # -- configuration -------------------------------------------------------

    def set_correspondence_measure(self, method: str, *other_methods: str) -> None:
        self.correspondence_method = method
        self._extra_methods = other_methods

    def set_max_correspondence_distance(self, correspondence: float) -> None:
        self.max_correspondence = correspondence

    def set_min_correspondence_distance(self, correspondence: float) -> None:
        self.min_correspondence = correspondence
        self._histogram_binsize = correspondence

    def set_ignore_nearest(self, ignore_nearest: int) -> None:
        self.ignore_nearest = ignore_nearest

    def set_ignore_floor(self, ignoreFloor: bool) -> None:
        self.ignore_floor = ignoreFloor

    # -- run ------------------------------------------------------------------

    def _maybe_drop_floor(self, pc: cwipc_pointcloud_wrapper) -> cwipc_pointcloud_wrapper:
        if not self.ignore_floor:
            return pc
        from .util import cwipc_floor_filter

        return cwipc_floor_filter(pc, FLOOR_LEVEL, keep_floor=False)

    def _distances(self) -> np.ndarray:
        src = self._maybe_drop_floor(self.get_filtered_source_pointcloud())
        ref = self._maybe_drop_floor(self.get_filtered_reference_pointcloud())
        return _nn_distances(src, ref, self.max_correspondence, self.ignore_nearest)

    def run(self) -> bool:
        d = self._distances()
        self._results = self._compute_results(
            d,
            self.get_filtered_source_pointcloud().count(),
            self.get_filtered_reference_pointcloud().count(),
        )
        return True

    def _compute_results(self, d: np.ndarray, n_src: int, n_ref: int) -> AnalysisResults:
        res = AnalysisResults()
        res.algorithm = self.__class__.__name__
        res.variant = self.correspondence_method
        res.sourcePointCount = n_src
        res.referencePointCount = n_ref
        res.tilemask = self.source_tilemask
        res.referenceTilemask = self.reference_tilemask

        finite = d[np.isfinite(d)]
        if finite.size == 0:
            res.minCorrespondence = self.max_correspondence
            return res

        res.mean = float(finite.mean())
        res.stddev = float(finite.std())
        res.median = float(np.median(finite))
        from scipy import stats as _stats

        # reference: scipy trim_mean with 10% trimmed per tail (analyze.py:207)
        res.tmean = float(_stats.trim_mean(finite, 0.1)) if finite.size else res.mean

        hist, edges = self._compute_histogram(finite)
        res.histogram = hist
        res.histogramEdges = edges
        # reference's _mode_from_histogram: the RIGHT edge of the peak bin
        # (analyze.py:136-139)
        peak = int(np.argmax(hist))
        res.mode = float(edges[peak + 1])

        method = self.correspondence_method
        if method == "2mode":
            measure = 2.0 * res.mode
        elif method.startswith("q="):
            try:
                q = float(method[2:])  # superset of the reference's int
            except ValueError:
                raise ValueError(f"Unknown correspondence measure '{method}'")
            measure = float(np.percentile(finite, q))
        else:
            known = {
                "mean": res.mean,
                "median": res.median,
                "tmean": res.tmean,
                "mode": res.mode,
            }
            if method not in known:
                # reference rejects unknown measures (analyze.py:240
                # `assert False`); a silent fallback would quietly change
                # the multicamera accept/reject thresholds
                raise ValueError(f"Unknown correspondence measure '{method}'")
            measure = known[method]
        res.minCorrespondence = float(measure)
        res.minCorrespondenceCount = int((finite <= res.minCorrespondence).sum())
        return res

    def _histogram_bins(self, finite: np.ndarray) -> int:
        """Reference semantics (analyze.py:141-159): an EXPLICITLY-set
        minimum correspondence is the minimum meaningful granularity,
        i.e. the BIN SIZE; otherwise the default bincount applies."""
        max_d = float(finite.max())
        if self._histogram_binsize and self._histogram_binsize > 0 and max_d > 0:
            bins = int(max_d / self._histogram_binsize)
            return max(1, min(bins, 100_000))
        return self.histogram_bincount

    def _compute_histogram(self, finite: np.ndarray):
        bins = self._histogram_bins(finite)
        max_d = float(finite.max())
        if self.use_kde and finite.size > 2 and max_d > 0 and float(finite.min()) < max_d:
            # gaussian-KDE density evaluated on the histogram grid
            # (reference analyze.py:171-179): edges from 0 to max distance,
            # the density sampled at each bin's right edge.
            from scipy import stats as _stats

            try:
                kde = _stats.gaussian_kde(finite, bw_method=self.gaussian_bw_method)
                edges = np.linspace(0.0, max_d, bins + 1)
                values = kde.evaluate(edges[1:])
                return values, edges
            except Exception:
                pass  # singular data etc: fall through to the raw histogram
        return np.histogram(finite, bins=bins)

    def get_results(self) -> AnalysisResults:
        assert self._results is not None
        return self._results

    def run_precomputed(
        self,
        d_fwd: np.ndarray,
        d_rev: Optional[np.ndarray],
        n_src: int,
        n_ref: int,
    ) -> bool:
        """run() with externally-computed NN distances (the multicamera
        batcher, which evaluates a whole analysis sweep in one device
        dispatch).  Statistics are identical to run()'s."""
        self._results = self._compute_results(d_fwd, n_src, n_ref)
        return True


class RegistrationAnalyzerSymmetric(RegistrationAnalyzer):
    """Analyzes both directions, keeping the worse (larger) correspondence —
    the default analyzer (reference: analyze.py:284-336, 389)."""

    def run(self) -> bool:
        src = self._maybe_drop_floor(self.get_filtered_source_pointcloud())
        ref = self._maybe_drop_floor(self.get_filtered_reference_pointcloud())
        d_fwd = _nn_distances(src, ref, self.max_correspondence, self.ignore_nearest)
        d_rev = _nn_distances(ref, src, self.max_correspondence, self.ignore_nearest)
        return self.run_precomputed(d_fwd, d_rev, src.count(), ref.count())

    def run_precomputed(
        self,
        d_fwd: np.ndarray,
        d_rev: Optional[np.ndarray],
        n_src: int,
        n_ref: int,
    ) -> bool:
        assert d_rev is not None
        r_fwd = self._compute_results(d_fwd, n_src, n_ref)
        r_rev = self._compute_results(d_rev, n_ref, n_src)
        self._results = (
            r_fwd if r_fwd.minCorrespondence >= r_rev.minCorrespondence else r_rev
        )
        self._results.sourcePointCount = n_src
        self._results.referencePointCount = n_ref
        self._results.tilemask = self.source_tilemask
        self._results.referenceTilemask = self.reference_tilemask
        return True


class OverlapAnalyzer(BaseAlgorithm, OverlapAnalysisAlgorithm):
    """Fitness/RMSE overlap measure (reference: analyze.py:338-387, built on
    open3d evaluate_registration there): fitness = fraction of source points
    with a reference neighbor within the correspondence distance, rmse over
    those inliers."""

    def __init__(self) -> None:
        BaseAlgorithm.__init__(self)
        self.correspondence = DEFAULT_MAX_CORRESPONDENCE
        self._results: Optional[OverlapAnalysisResults] = None

    def set_correspondence(self, correspondence: float) -> None:
        self.correspondence = correspondence

    def run(self) -> bool:
        src = self.get_filtered_source_pointcloud()
        ref = self.get_filtered_reference_pointcloud()
        d = _nn_distances(src, ref, self.correspondence)
        inliers = d[np.isfinite(d)]
        res = OverlapAnalysisResults()
        res.sourcePointCount = src.count()
        res.referencePointCount = ref.count()
        res.tilemask = self.source_tilemask
        res.referenceTilemask = self.reference_tilemask
        if src.count() > 0 and inliers.size > 0:
            res.fitness = float(inliers.size / src.count())
            res.rmse = float(np.sqrt((inliers**2).mean()))
        self._results = res
        return True

    def get_results(self) -> OverlapAnalysisResults:
        assert self._results is not None
        return self._results


DEFAULT_ANALYZER_ALGORITHM = RegistrationAnalyzerSymmetric

# Reference-parity names (reference: registration/analyze.py:18-20,391-395).
# The reference's KD tree is scipy's; this framework dispatches NN search
# per case (device grid search / scipy), but code that builds its own trees via
# KD_TREE_TYPE keeps working.
import scipy.spatial as _scipy_spatial

KD_TREE_TYPE = _scipy_spatial.KDTree
BaseRegistrationAnalyzer = RegistrationAnalyzer

ALL_ANALYZER_ALGORITHMS = [
    RegistrationAnalyzer,
    RegistrationAnalyzerSymmetric,
    OverlapAnalyzer,
]

HELP_ANALYZER_ALGORITHMS = """
Analyzer algorithms:
    RegistrationAnalyzer           one-directional NN-distance statistics
    RegistrationAnalyzerSymmetric  both directions, worse wins (default)
    OverlapAnalyzer                fitness/rmse overlap measure
Correspondence measures: mean, median, tmean, mode, 2mode, q=NN (percentile).
The distance density is a gaussian-KDE histogram by default (use_kde).
"""
