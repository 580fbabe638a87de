"""Registration toolkit tests with known ground truth (the reference's
strategy: simulatecams + noise + known perturbations,
scripts/cwipc_create_analysis_test.py)."""

import math

import numpy as np
import pytest

import cwipc_util_jax as cwipc
from cwipc_util_jax.filters.simulatecams import SimulatecamsFilter
from cwipc_util_jax.registration.analyze import (
    OverlapAnalyzer,
    RegistrationAnalyzer,
    RegistrationAnalyzerSymmetric,
)
from cwipc_util_jax.registration.cameraconfig import CameraConfig, default_cameraconfig
from cwipc_util_jax.registration.fine import (
    RegistrationComputer_ICP_Generalized,
    RegistrationComputer_ICP_Point2Plane,
    RegistrationComputer_ICP_Point2Point,
)
from cwipc_util_jax.registration.multicamera import (
    MultiCameraIterative,
    MultiCameraOneToAllOthers,
)
from cwipc_util_jax.registration.util import (
    cwipc_tilefilter_masked,
    cwipc_transform,
    get_tiles_used,
    transformation_compare,
    transformation_identity,
)


def _rotation_y(angle):
    c, s = math.cos(angle), math.sin(angle)
    T = np.identity(4)
    T[0, 0], T[0, 2], T[2, 0], T[2, 2] = c, s, -s, c
    return T


def _translation(x, y, z):
    T = np.identity(4)
    T[:3, 3] = (x, y, z)
    return T


@pytest.fixture(scope="module")
def synth_pc():
    gen = cwipc.cwipc_synthetic(0, 4000)
    gen.start()
    pc = gen.get()
    gen.stop()
    return pc


@pytest.fixture(scope="module")
def tiled_pc(synth_pc):
    """Synthetic cloud split over 3 simulated cameras (hard assignment)."""
    return SimulatecamsFilter(3, hard=True).filter(synth_pc.clone())


class TestAnalyzer:
    def test_self_analysis_zero(self, synth_pc):
        an = RegistrationAnalyzer()
        an.set_source_pointcloud(synth_pc)
        an.set_reference_pointcloud(synth_pc)
        an.run()
        r = an.get_results()
        assert r.mean == 0.0
        assert r.minCorrespondence <= 0.001

    def test_shifted_analysis(self, synth_pc):
        shifted = cwipc_transform(synth_pc, _translation(0.01, 0, 0))
        an = RegistrationAnalyzerSymmetric()
        an.set_source_pointcloud(shifted)
        an.set_reference_pointcloud(synth_pc)
        an.run()
        r = an.get_results()
        # shifted by 1cm: correspondence should be of that order
        assert 0.002 < r.minCorrespondence < 0.02
        assert r.histogram is not None and r.histogram.sum() > 0

    def test_overlap(self, synth_pc):
        an = OverlapAnalyzer()
        an.set_source_pointcloud(synth_pc)
        an.set_reference_pointcloud(synth_pc)
        an.set_correspondence(0.01)
        an.run()
        r = an.get_results()
        assert r.fitness == 1.0
        assert r.rmse == 0.0

    def test_correspondence_measures(self, synth_pc):
        """All reference measure strings are accepted (mean/tmean/median/
        mode/2mode/q=NN, reference analyze.py:210-247) and behave sanely
        on a known 1cm offset."""
        shifted = cwipc_transform(synth_pc, _translation(0.01, 0, 0))
        values = {}
        for measure in ("mean", "tmean", "median", "mode", "2mode", "q=50", "q=90"):
            an = RegistrationAnalyzer()
            an.set_source_pointcloud(shifted)
            an.set_reference_pointcloud(synth_pc)
            an.set_correspondence_measure(measure)
            an.run()
            values[measure] = an.get_results().minCorrespondence
        assert values["2mode"] == pytest.approx(2 * values["mode"])
        assert values["q=50"] == pytest.approx(values["median"], rel=1e-6)
        assert values["q=90"] >= values["q=50"]
        for v in values.values():
            assert 0 < v < 0.05

    def test_kde_density_default(self, synth_pc):
        """The default histogram is a gaussian-KDE density on a 0..max grid
        (reference analyze.py:171-179); the raw histogram stays available
        via use_kde=False."""
        shifted = cwipc_transform(synth_pc, _translation(0.005, 0, 0))
        kde_an = RegistrationAnalyzer()
        kde_an.set_source_pointcloud(shifted)
        kde_an.set_reference_pointcloud(synth_pc)
        assert kde_an.use_kde
        kde_an.run()
        kde_r = kde_an.get_results()
        assert kde_r.histogramEdges[0] == 0.0
        assert kde_r.histogram.dtype.kind == "f"  # density, not counts

        raw_an = RegistrationAnalyzer()
        raw_an.set_source_pointcloud(shifted)
        raw_an.set_reference_pointcloud(synth_pc)
        raw_an.use_kde = False
        raw_an.run()
        raw_r = raw_an.get_results()
        assert raw_r.histogram.sum() == pytest.approx(raw_r.sourcePointCount, rel=0.05)
        # both modes should land near the actual 5mm offset
        for r in (kde_r, raw_r):
            assert 0.001 < r.mode < 0.02

    def test_min_correspondence_is_binsize(self, synth_pc):
        """set_min_correspondence_distance sets the histogram granularity
        (reference analyze.py:58-60,148-152)."""
        shifted = cwipc_transform(synth_pc, _translation(0.01, 0, 0))
        an = RegistrationAnalyzer()
        an.set_source_pointcloud(shifted)
        an.set_reference_pointcloud(synth_pc)
        an.set_min_correspondence_distance(0.002)
        an.run()
        r = an.get_results()
        binsize = r.histogramEdges[1] - r.histogramEdges[0]
        assert binsize == pytest.approx(0.002, rel=0.25)

    def test_tilemask_selection(self, tiled_pc):
        tiles = get_tiles_used(tiled_pc)
        an = RegistrationAnalyzer()
        an.set_source_pointcloud(tiled_pc, tiles[0])
        an.set_reference_pointcloud(tiled_pc, tiles[1])
        an.run()
        r = an.get_results()
        assert r.sourcePointCount > 0
        assert r.tilemask == tiles[0]


class TestICP:
    @pytest.mark.parametrize(
        "cls",
        [
            RegistrationComputer_ICP_Point2Point,
            RegistrationComputer_ICP_Point2Plane,
            RegistrationComputer_ICP_Generalized,
        ],
    )
    def test_recovers_small_transform(self, synth_pc, cls):
        true_T = _translation(0.01, 0.005, -0.008) @ _rotation_y(0.03)
        moved = cwipc_transform(synth_pc, true_T)
        aligner = cls()
        aligner.set_source_pointcloud(moved)
        aligner.set_reference_pointcloud(synth_pc)
        aligner.set_correspondence(0.05)
        assert aligner.run()
        est = aligner.get_result_transformation()
        # est should recover inverse(true_T)
        residual = est @ true_T
        dt, dr = transformation_compare(residual, transformation_identity())
        assert dt < 0.004, f"translation residual {dt}"
        assert dr < 0.02, f"rotation residual {dr}"

    @pytest.mark.parametrize(
        "cls",
        [
            RegistrationComputer_ICP_Point2Point,
            RegistrationComputer_ICP_Point2Plane,
            RegistrationComputer_ICP_Generalized,
        ],
    )
    def test_fused_matches_host_loop(self, synth_pc, cls, monkeypatch):
        """The single-dispatch lax.while_loop ICP (fine.py:_icp_fused) must
        land on the same pose as the per-iteration host loop — same NN
        kernel, same break rules; only f32-vs-f64 solve arithmetic may
        differ."""
        true_T = _translation(0.008, -0.004, 0.006) @ _rotation_y(-0.025)
        moved = cwipc_transform(synth_pc, true_T)

        def run(fused):
            monkeypatch.setenv("CWIPC_FUSED_ICP", "1" if fused else "0")
            aligner = cls()
            aligner.set_source_pointcloud(moved)
            aligner.set_reference_pointcloud(synth_pc)
            aligner.set_correspondence(0.05)
            assert aligner.run()
            return aligner.get_result_transformation()

        dt, dr = transformation_compare(run(True), run(False))
        assert dt < 1e-3, f"fused-vs-host translation drift {dt}"
        assert dr < 5e-3, f"fused-vs-host rotation drift {dr}"

    def test_result_pointcloud(self, synth_pc):
        moved = cwipc_transform(synth_pc, _translation(0.01, 0, 0))
        aligner = RegistrationComputer_ICP_Point2Point()
        aligner.set_source_pointcloud(moved)
        aligner.set_reference_pointcloud(synth_pc)
        assert aligner.run()
        out = aligner.get_result_pointcloud()
        assert out.count() == moved.count()
        full = aligner.get_result_pointcloud_full()
        assert full.count() == moved.count() + synth_pc.count()


class TestGICP:
    def test_gicp_converges_where_p2plane_misaligns(self):
        """True plane-to-plane GICP (the reference's default fine aligner,
        fine.py:290-317): on a half-cylinder + end-cap pair whose reference
        is sampled anisotropically (dense rings, sparse rows — which biases
        the reference's windowed normal estimates), point-to-plane stalls at
        a visibly wrong pose while GICP, weighing BOTH clouds' disc
        covariances, recovers the ground-truth transform."""
        from cwipc_util_jax import cwipc_from_numpy_matrix
        from cwipc_util_jax.registration.fine import (
            RegistrationComputer_ICP_Generalized,
            RegistrationComputer_ICP_Point2Plane,
        )

        def make_pc(pts):
            m = np.zeros((len(pts), 7), np.float32)
            m[:, :3] = pts
            m[:, 3:6] = 128
            return cwipc_from_numpy_matrix(m, 0)

        def scene(n_rows, n_cols, noise, seed):
            r = np.random.default_rng(seed)
            th = np.linspace(0, np.pi, n_cols)
            y = np.linspace(0, 0.5, n_rows)
            TH, Y = np.meshgrid(th, y)
            pts = np.stack([0.3 * np.cos(TH), Y, 0.3 * np.sin(TH)], -1).reshape(-1, 3)
            rr = np.sqrt(r.random(400)) * 0.3
            a = r.random(400) * np.pi
            cap = np.stack([rr * np.cos(a), np.zeros(400), rr * np.sin(a)], -1)
            return np.concatenate([pts, cap]) + r.normal(0, noise, (len(pts) + 400, 3))

        src_pts = scene(40, 80, 0.003, seed=2)
        ref_pts = scene(8, 400, 0.003, seed=3)
        ang = 0.25
        c, s = math.cos(ang), math.sin(ang)
        T_true = np.identity(4)
        T_true[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        T_true[:3, 3] = [0.03, 0.02, -0.02]
        Ti = np.linalg.inv(T_true)
        src_mis = src_pts @ Ti[:3, :3].T + Ti[:3, 3]

        errs = {}
        for cls in (RegistrationComputer_ICP_Point2Plane, RegistrationComputer_ICP_Generalized):
            al = cls()
            al.set_source_pointcloud(make_pc(src_mis))
            al.set_reference_pointcloud(make_pc(ref_pts))
            assert al.run()
            T = al.get_result_transformation()
            errs[cls] = float(np.linalg.norm(T @ Ti - np.identity(4)))
        assert errs[RegistrationComputer_ICP_Generalized] < 0.02
        assert errs[RegistrationComputer_ICP_Point2Plane] > 0.04

    def test_gicp_exact_on_clean_pair(self, synth_pc):
        """GICP recovers a small rigid misalignment on identical clouds.

        The synthetic body is sampled on rings, so rotating by one angular
        step (~0.1 rad) maps the point set EXACTLY onto itself — a perfect
        (rmse 0) alias registration.  The misalignment must stay well inside
        half that alias spacing or the aligner may legitimately land on the
        neighboring alias."""
        from cwipc_util_jax.registration.fine import RegistrationComputer_ICP_Generalized

        T_true = _rotation_y(0.03) @ _translation(0.01, 0.005, -0.01)
        moved = cwipc_transform(synth_pc, np.linalg.inv(T_true))
        al = RegistrationComputer_ICP_Generalized()
        al.set_source_pointcloud(moved)
        al.set_reference_pointcloud(synth_pc)
        assert al.run()
        T = al.get_result_transformation()
        assert np.linalg.norm(T @ np.linalg.inv(T_true) - np.identity(4)) < 0.02


class TestMulticamera:
    def _perturbed(self, tiled_pc, magnitude=0.01):
        tiles = get_tiles_used(tiled_pc)
        parts = []
        rng = np.random.default_rng(7)
        truths = {}
        for i, tilemask in enumerate(tiles):
            tile_pc = cwipc_tilefilter_masked(tiled_pc, tilemask)
            T = _translation(*rng.uniform(-magnitude, magnitude, 3)) @ _rotation_y(
                rng.uniform(-0.02, 0.02)
            )
            parts.append(cwipc_transform(tile_pc, T))
            truths[tilemask] = T
        return cwipc.cwipc_join_multi(parts), truths

    def test_iterative_improves(self, synth_pc):
        # soft camera assignment: tiles overlap at sector boundaries, which
        # is what gives fine alignment its correspondences
        soft_tiled = SimulatecamsFilter(3, hard=False).filter(synth_pc.clone())
        perturbed, _ = self._perturbed(soft_tiled)
        algo = MultiCameraIterative()
        algo.set_tiled_pointcloud(perturbed)
        algo.set_max_correspondence(0.05)
        assert algo.run()
        pre = max(r.minCorrespondence for r in algo.pre_analysis_results)
        post = max(r.minCorrespondence for r in algo.post_analysis_results)
        assert post <= pre * 1.05
        assert algo.proposed_cellsize > 0
        assert len(algo.get_result_transformations()) == algo.camera_count()
        out = algo.get_result_pointcloud_full()
        assert out.count() == perturbed.count()

    def test_one_to_all_others(self, tiled_pc):
        perturbed, _ = self._perturbed(tiled_pc, magnitude=0.005)
        algo = MultiCameraOneToAllOthers()
        algo.set_tiled_pointcloud(perturbed)
        algo.set_max_correspondence(0.05)
        assert algo.run()
        assert len(algo.get_result_transformations()) == algo.camera_count()

    def test_batched_analysis_matches_sequential(self, tiled_pc, monkeypatch):
        """The batched pre/post analysis sweep (one vmapped NN dispatch,
        multicamera._analyse_all_cameras) must reproduce the per-camera
        sequential analyses exactly — same kernel, same shapes semantics."""
        monkeypatch.setenv("CWIPC_BATCHED_ANALYSIS", "1")  # CPU defaults off
        perturbed, _ = self._perturbed(tiled_pc, magnitude=0.005)
        algo = MultiCameraIterative()
        algo.set_tiled_pointcloud(perturbed)
        algo.set_max_correspondence(0.05)
        batched = algo._analyse_all_cameras()
        sequential = [algo._analyse_camera(i) for i in range(algo.camera_count())]
        assert len(batched) == len(sequential) == 3
        for b, s in zip(batched, sequential):
            assert b.sourcePointCount == s.sourcePointCount
            assert b.referencePointCount == s.referencePointCount
            np.testing.assert_allclose(b.minCorrespondence, s.minCorrespondence, rtol=1e-5)
            np.testing.assert_allclose(b.mean, s.mean, rtol=1e-5)
            np.testing.assert_allclose(b.mode, s.mode, rtol=1e-5)

    def test_batched_overlaps_match_analyzer(self, tiled_pc, monkeypatch):
        """_overlaps_batched must reproduce OverlapAnalyzer fitness per
        candidate camera."""
        monkeypatch.setenv("CWIPC_BATCHED_ANALYSIS", "1")  # CPU defaults off
        perturbed, _ = self._perturbed(tiled_pc, magnitude=0.005)
        algo = MultiCameraIterative()
        algo.set_tiled_pointcloud(perturbed)
        algo.set_max_correspondence(0.05)
        registered = algo._moved_pc(0)
        cams = [1, 2]
        batched = algo._overlaps_batched(cams, registered)
        for f, i in zip(batched, cams):
            expected = algo._overlap(algo._moved_pc(i), registered)
            np.testing.assert_allclose(f, expected, rtol=1e-6)

    def test_camera_index_mapping(self, tiled_pc):
        algo = MultiCameraIterative()
        algo.set_tiled_pointcloud(tiled_pc)
        n = algo.camera_count()
        assert n == 3
        for i in range(n):
            mask = algo.tilemask_for_camera_index(i)
            assert algo.camera_index_for_tilemask(mask) == i


class TestCameraConfig:
    def test_roundtrip_and_backup(self, tmp_path):
        import json

        fn = str(tmp_path / "cameraconfig.json")
        data = default_cameraconfig("synthetic", ["a", "b"])
        with open(fn, "w") as fp:
            json.dump(data, fp)
        cfg = CameraConfig(fn)
        cfg.load()
        assert cfg.camera_count() == 2
        assert cfg.all_identity()
        assert cfg.get_serial_dict() == {"a": 1, "b": 2}
        T = np.identity(4)
        T[0, 3] = 0.5
        cfg.set_transform(0, T)
        assert cfg.is_dirty()
        cfg.save()
        assert not cfg.is_dirty()
        assert (tmp_path / "cameraconfig.json~").exists()
        cfg2 = CameraConfig(fn)
        cfg2.load()
        assert np.allclose(cfg2.get_transform(0).get_matrix(), T)

    def test_dotted_override(self, tmp_path):
        import json

        fn = str(tmp_path / "cameraconfig.json")
        with open(fn, "w") as fp:
            json.dump(default_cameraconfig("synthetic", ["a"]), fp)
        cfg = CameraConfig(fn)
        cfg.load()
        cfg.set_entry_from_string("camera.0.serial=xyz")
        assert cfg.get_entry("camera.0.serial") == "xyz"


class TestCoarseAruco:
    def test_detects_synthetic_marker(self):
        """A floor cloud containing an ArUco pattern must be registered to
        the marker's known pose."""
        import cv2

        from cwipc_util_jax.registration.coarse import (
            DEFAULT_MARKER_SIZE,
            MultiCameraCoarseAruco,
            _marker_world_corners,
        )

        # build a synthetic floor with the marker pattern (plus the physical
        # marker's white quiet zone) at a known offset
        dictionary = cv2.aruco.getPredefinedDictionary(cv2.aruco.DICT_5X5_250)
        marker_px = 100
        pad = 30
        img = cv2.aruco.generateImageMarker(dictionary, 0, marker_px)
        canvas = np.full((marker_px + 2 * pad, marker_px + 2 * pad), 255, np.uint8)
        canvas[pad : pad + marker_px, pad : pad + marker_px] = img
        size = canvas.shape[0]
        spacing = DEFAULT_MARKER_SIZE / marker_px
        ys, xs = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
        n = size * size
        pts = np.zeros((n, 7), np.float32)
        pts[:, 0] = (xs.ravel() - size / 2) * spacing
        pts[:, 2] = (ys.ravel() - size / 2) * spacing
        val = canvas.ravel().astype(np.float32)
        pts[:, 3] = pts[:, 4] = pts[:, 5] = val
        pts[:, 6] = 1  # tile 1
        # known ground-truth displacement of the camera's view of the marker
        offset = np.array([0.3, 0.0, -0.2], np.float32)
        pts[:, 0:3] += offset
        pc = cwipc.cwipc_from_numpy_matrix(pts, 0)

        algo = MultiCameraCoarseAruco()
        algo.set_tiled_pointcloud(pc)
        ok = algo.run()
        assert ok, "marker not found/registered"
        T = algo.get_result_transformations()[0]
        # the transform must undo the offset
        moved = cwipc_transform(pc, T)
        m = moved.get_numpy_matrix(onlyGeometry=True)
        center = m.mean(axis=0)
        assert np.linalg.norm(center) < 0.02, f"marker center off by {center}"


class TestPointPicking:
    def test_pick_index_at_projects_correctly(self, synth_pc):
        """The interactive picker's deprojection core: clicking exactly on
        a point's projected pixel returns that point (front-most wins)."""
        from cwipc_util_jax.io.render import OrbitCamera
        from cwipc_util_jax.registration.util import (
            pick_index_at,
            project_point_indices,
        )

        xyz = synth_pc.get_numpy_matrix(onlyGeometry=True).astype(np.float32)
        cam = OrbitCamera()
        w, h = 640, 480
        u, v, z = project_point_indices(xyz, cam, w, h)
        onscreen = np.where(
            np.isfinite(u) & (u >= 10) & (u < w - 10) & (v >= 10) & (v < h - 10)
        )[0]
        assert onscreen.size > 100
        hits = 0
        for idx in onscreen[:: max(1, onscreen.size // 25)][:25]:
            got = pick_index_at(xyz, cam, w, h, float(u[idx]), float(v[idx]))
            assert got >= 0
            # the clicked point or a nearer point projecting to ~the same
            # pixel — either way the pick lands within a few pixels and at
            # a depth no farther than the clicked point's
            assert (u[got] - u[idx]) ** 2 + (v[got] - v[idx]) ** 2 <= 12**2
            assert z[got] <= z[idx] * 1.02 + 1e-6
            hits += int(got == idx)
        # dense clouds have many points per pixel neighborhood, so the
        # front-most-wins rule legitimately returns a different point for
        # some clicks; a healthy fraction must still hit exactly
        assert hits >= 5

    def test_pick_points_headless_returns_empty(self, synth_pc):
        from cwipc_util_jax.registration.util import pick_points

        assert pick_points("t", synth_pc, count=4, timeout_ms=100) == []

    def test_interactive_colortarget_falls_back(self):
        """Headless: the interactive ColorTarget variant falls back to the
        automated color segmentation."""
        from cwipc_util_jax.registration.coarse import (
            MultiCameraCoarseColorTargetInteractive,
        )

        assert MultiCameraCoarseColorTargetInteractive is not None


class TestNormals:
    def test_plane_normals_point_outward(self):
        """Normals of a planar patch must be the plane normal, oriented away
        from the centroid side (reference: o3d estimate_normals +
        orient_normals semantics used by the point2plane aligners)."""
        import jax.numpy as jnp

        from cwipc_util_jax.core.buffers import PointBuffer
        from cwipc_util_jax.registration.normals import estimate_normals

        n_side = 32
        g = np.linspace(0.0, 0.31, n_side, dtype=np.float32)
        xx, yy = np.meshgrid(g, g)
        cap = 2048
        xyz = np.zeros((cap, 3), np.float32)
        pts = np.stack([xx.ravel(), yy.ravel(), np.zeros(n_side * n_side, np.float32)], 1)
        xyz[: len(pts)] = pts
        buf = PointBuffer(
            xyz=jnp.asarray(xyz),
            rgba=jnp.zeros(cap, jnp.uint32),
            count=jnp.int32(len(pts)),
        )
        normals = np.asarray(estimate_normals(buf, jnp.float32(0.05)))
        nz = normals[: len(pts), 2]
        interior = (pts[:, 0] > 0.05) & (pts[:, 0] < 0.26) & (pts[:, 1] > 0.05) & (pts[:, 1] < 0.26)
        assert np.all(np.abs(nz[interior]) > 0.99), "interior normals not +/-z"
        norms = np.linalg.norm(normals[: len(pts)][interior], axis=1)
        assert np.allclose(norms, 1.0, atol=1e-3)
        assert np.allclose(normals[len(pts):], 0.0)

    def test_plane_normals_far_from_origin(self):
        """f32 conditioning: a patch 50 m from the origin must still get
        clean normals — the covariance is accumulated from CENTERED
        neighbor offsets, so absolute-coordinate cancellation cannot drown
        the ~radius^2 neighborhood variance (normals.py accum)."""
        import jax.numpy as jnp

        from cwipc_util_jax.core.buffers import PointBuffer
        from cwipc_util_jax.registration.normals import estimate_normals

        n_side = 32
        g = np.linspace(0.0, 0.31, n_side, dtype=np.float32)
        xx, yy = np.meshgrid(g, g)
        cap = 2048
        xyz = np.zeros((cap, 3), np.float32)
        pts = np.stack([xx.ravel(), yy.ravel(), np.zeros(n_side * n_side, np.float32)], 1)
        pts += np.array([50.0, -30.0, 40.0], np.float32)  # far from origin
        xyz[: len(pts)] = pts
        buf = PointBuffer(
            xyz=jnp.asarray(xyz),
            rgba=jnp.zeros(cap, jnp.uint32),
            count=jnp.int32(len(pts)),
        )
        normals = np.asarray(estimate_normals(buf, jnp.float32(0.05)))
        nz = normals[: len(pts), 2]
        rel = pts - pts.min(axis=0)
        interior = (rel[:, 0] > 0.05) & (rel[:, 0] < 0.26) & (rel[:, 1] > 0.05) & (rel[:, 1] < 0.26)
        assert np.all(np.abs(nz[interior]) > 0.99), "far-origin normals degraded"


class TestCoarsePreSeed:
    """A camera pre-seeded via set_transformation() must seed the marker
    propagation chain: markers it observes have known world poses through
    its matrix, exactly as if it had been registered in an earlier pass
    (reference: multicoarse.py run loop republishes marker poses from
    registered cameras)."""

    @staticmethod
    def _stub(observations):
        from cwipc_util_jax.registration.coarse import MultiCameraCoarse

        class StubCoarse(MultiCameraCoarse):
            def __init__(self, obs):
                super().__init__()
                self._obs = obs

            def camera_count(self):
                return len(self._obs)

            def get_pc_for_camnum(self, camnum):
                return camnum  # _find_markers keys on it directly

            def _find_markers(self, camnum):
                return {
                    mid: np.asarray(c, np.float64)
                    for mid, c in self._obs[camnum].items()
                }

        return StubCoarse(observations)

    def _observations(self):
        from cwipc_util_jax.registration.coarse import _marker_world_corners

        # marker 5 lives at a known world pose; neither camera sees the
        # floor marker 0, so camera 1 can only register through camera 0's
        # published pose of marker 5
        w5 = _marker_world_corners() + np.array([1.0, 0.0, 0.5])
        t0 = np.array([0.3, 0.1, -0.2])
        t1 = np.array([-0.5, 0.2, 0.4])
        obs = [{5: w5 - t0}, {5: w5 - t1}]
        return obs, t0, t1

    def test_preseeded_camera_seeds_marker_propagation(self):
        obs, t0, t1 = self._observations()
        algo = self._stub(obs)
        T0 = np.identity(4)
        T0[:3, 3] = t0
        algo.set_transformation(0, T0)
        assert algo.run(), "camera 1 did not register through the pre-seed"
        T1 = algo.get_result_transformations()[1]
        np.testing.assert_allclose(T1[:3, 3], t1, atol=1e-9)
        np.testing.assert_allclose(T1[:3, :3], np.identity(3), atol=1e-9)

    def test_without_preseed_chain_cannot_start(self):
        # control: with no pre-seed nobody sees a known marker, so the
        # propagation chain never starts
        obs, _, _ = self._observations()
        algo = self._stub(obs)
        assert not algo.run()
