"""Filter framework tests: factory parsing and per-filter invariants."""

import numpy as np
import pytest

import cwipc_util_jax as cwipc
from cwipc_util_jax import filters


@pytest.fixture(scope="module")
def pc():
    gen = cwipc.cwipc_synthetic(0, 2500)
    gen.start()
    rv = gen.get()
    gen.stop()
    return rv


class TestFactory:
    def test_no_args(self):
        f = filters.factory("passthrough")
        assert f.filtername == "passthrough"

    def test_with_args(self):
        f = filters.factory("voxelize(0.05)")
        assert f.vsize == 0.05

    def test_multi_args(self):
        f = filters.factory("crop(-1, 1, -1, 1, -1, 1)")
        assert f.bounding_box == (-1, 1, -1, 1, -1, 1)

    def test_string_arg(self):
        f = filters.factory("colorize(1.0, 'camera')")
        assert f.weight == 1.0

    def test_unknown(self):
        with pytest.raises(ValueError):
            filters.factory("nonexistent")

    def test_injection_rejected(self):
        with pytest.raises(ValueError):
            filters.factory("__import__('os').system('true')")

    def test_custom_py(self, tmp_path):
        fn = tmp_path / "custom.py"
        fn.write_text(
            "from cwipc_util_jax.filters.abstract import BaseFilter\n"
            "class CustomFilter(BaseFilter):\n"
            "    filtername = 'custom'\n"
            "    def _process(self, pc):\n"
            "        return pc\n"
        )
        f = filters.factory(str(fn))
        assert f.filtername == "custom"


class TestFilterBehavior:
    def test_passthrough_identity(self, pc):
        out = filters.factory("passthrough").filter(pc.clone())
        assert out.count() == pc.count()

    def test_voxelize_reduces(self, pc):
        out = filters.factory("voxelize(0.05)").filter(pc.clone())
        assert 0 < out.count() < pc.count()

    def test_transform_moves(self, pc):
        out = filters.factory("transform(1.0, 0, 0, 1.0)").filter(pc.clone())
        a = pc.get_numpy_matrix(onlyGeometry=True)
        b = out.get_numpy_matrix(onlyGeometry=True)
        assert np.allclose(b[:, 0], a[:, 0] + 1.0, atol=1e-5)

    def test_transform_scale(self, pc):
        out = filters.factory("transform(0, 0, 0, 2.0)").filter(pc.clone())
        a = pc.get_numpy_matrix(onlyGeometry=True)
        b = out.get_numpy_matrix(onlyGeometry=True)
        assert np.allclose(b, a * 2.0, atol=1e-4)

    def test_simulatecams_tiles(self, pc):
        out = filters.factory("simulatecams(4, True)").filter(pc.clone())
        tiles = set(np.unique(out.get_numpy_array()["tile"]))
        assert tiles <= {1, 2, 4, 8}
        assert len(tiles) >= 2

    def test_noise_bounded(self, pc):
        out = filters.factory("noise(0.01)").filter(pc.clone())
        a = pc.get_numpy_matrix(onlyGeometry=True)
        b = out.get_numpy_matrix(onlyGeometry=True)
        d = np.linalg.norm(a - b, axis=1)
        assert d.max() <= 0.0101
        assert d.mean() > 0.001

    def test_colorize_camera(self, pc):
        out = filters.factory("colorize(1.0, 'camera')").filter(pc.clone())
        arr = out.get_numpy_array()
        t1 = arr[arr["tile"] == 1]
        # tile 1 maps to pure red in the camera colormap
        assert (t1["r"] == 255).all() and (t1["g"] == 0).all()

    def test_randomize_floor_preserves_count(self, pc):
        out = filters.factory("randomize_floor(0.5)").filter(pc.clone())
        assert out.count() == pc.count()

    def test_statistics_runs(self, pc, capsys):
        f = filters.factory("voxelize(0.05)")
        f.filter(pc.clone())
        f.statistics()
        out = capsys.readouterr().out
        assert "voxelize" in out and "count=1" in out


class TestReviewRegressions:
    def test_colorize_contributions_covers_tile_255(self):
        """Tile 255 (all 8 cameras contributed) must be colorized too —
        the colormap is built over the full 0..255 range."""
        from cwipc_util_jax import cwipc_from_points, cwipc_point

        pc = cwipc_from_points([cwipc_point(0, 0, 0, 10, 20, 30, 255)], 0)
        out = filters.factory("colorize(1.0,'contributions')").filter(pc)
        p = list(out.get_points())[0]
        # 8 bits set -> _colorForBitCount[8] == (0, 0, 0)
        assert (p.r, p.g, p.b) == (0, 0, 0)
        assert p.tile == 255

    def test_simulatecams_fractional_skew_no_nan(self, pc):
        """Soft assignment with a fractional skew must not produce NaN
        weights (negative dot products are clamped before powering)."""
        out = filters.factory("simulatecams(3,False,1.5)").filter(pc.clone())
        tiles = np.array([p.tile for p in out.get_points()])
        assert set(np.unique(tiles)) <= {1, 2, 4}
        # every camera sector should get SOME points on the synthetic body
        assert len(np.unique(tiles)) == 3
