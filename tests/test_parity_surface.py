"""Behavior tests for the reference-parity API surface added in round 3:
pointer handoff (as_cwipc_p), raw tileinfo structs, cameraconfig method
aliases, the Plotter class, filter print1stat, and the script driver
classes (TransformFinder / AnalyzePointCloud / AnalysisTestCreator /
DropWriter / FileWriter)."""

import ctypes
import gc
import json
import os
import sys

import numpy as np
import pytest

import cwipc_util_jax as cwipc
from cwipc_util_jax.registration.cameraconfig import CameraConfig, Transform


class TestNativeHandoff:
    def test_as_cwipc_p_roundtrip(self):
        """as_cwipc_p materializes a native twin usable through the C ABI."""
        # the allocation counter is per process: clouds that earlier tests
        # left in reference cycles count until the collector frees them
        gc.collect()
        pc = cwipc.cwipc_from_points(
            [(1.0, 2.0, 3.0, 10, 20, 30, 1), (4.0, 5.0, 6.0, 40, 50, 60, 2)], 1234
        )
        pc._set_cellsize(0.5)
        handle = pc.as_cwipc_p()
        assert handle
        assert pc.as_cwipc_p() is handle  # cached
        from cwipc_util_jax.util import cwipc_util_dll_load

        dll = cwipc_util_dll_load()
        dll.cwipc_pointcloud_count.restype = ctypes.c_int
        dll.cwipc_pointcloud_count.argtypes = [ctypes.c_void_p]
        dll.cwipc_pointcloud_timestamp.restype = ctypes.c_uint64
        dll.cwipc_pointcloud_timestamp.argtypes = [ctypes.c_void_p]
        assert dll.cwipc_pointcloud_count(handle) == 2
        assert dll.cwipc_pointcloud_timestamp(handle) == 1234
        # detach moves the native twin to the new wrapper
        detached = pc.detach()
        assert pc._native_handle is None
        assert detached._native_handle is handle
        detached.free()
        assert cwipc.cwipc_dangling_allocations(False) == 0

    def test_metadata_pointer(self):
        pc = cwipc.cwipc_from_points([(0.0, 0.0, 0.0, 1, 2, 3, 1)], 0)
        md = pc.access_metadata()
        md._add("test-item", "", b"hello")
        p = md.pointer(0)
        assert p.value  # a real address
        assert ctypes.string_at(p, md.size(0)) == b"hello"
        pc.free()

    def test_python_native_handles_raise(self):
        from cwipc_util_jax.abstract import cwipc_sink_wrapper, cwipc_source_wrapper
        from cwipc_util_jax.core.errors import CwipcError

        with pytest.raises(CwipcError):
            cwipc_source_wrapper(None).as_cwipc_source_p()
        with pytest.raises(CwipcError):
            cwipc_sink_wrapper(None).as_cwipc_sink_p()
        pc = cwipc.cwipc_from_points([(0.0, 0.0, 0.0, 1, 2, 3, 1)], 0)
        md = pc.access_metadata()
        with pytest.raises(CwipcError):
            md.as_cwipc_metadata_p()
        pc.free()

    def test_get_tileinfo_raw(self):
        src = cwipc.cwipc_synthetic()
        info = src.get_tileinfo_raw(1)
        assert info is not None
        d = src.get_tileinfo_dict(1)
        assert info.cameraMask == d["cameraMask"]
        assert info.normal.x == d["normal"]["x"]
        assert src.get_tileinfo_raw(250) is None
        src.free()


class TestCameraConfigParity:
    def test_transform_get_and_apply(self):
        t = Transform()
        assert t.get() == np.identity(4).tolist()
        t.apply_matrix(np.identity(4))
        assert not t.is_dirty()  # identity apply is a no-op
        move = np.identity(4)
        move[0, 3] = 1.0
        t.apply_matrix(move)
        assert t.is_dirty()
        assert t.get_matrix()[0, 3] == 1.0
        t.apply_matrix(move)  # left-multiplied accumulation
        assert t.get_matrix()[0, 3] == 2.0

    def test_cameraconfig_aliases(self, tmp_path):
        fn = str(tmp_path / "cameraconfig.json")
        cfg = CameraConfig(fn)
        cfg.load(json.dumps(dict(
            version=5, type="synthetic",
            camera=[dict(serial="a", type="synthetic", trafo=np.identity(4).tolist())],
        )).encode())
        assert cfg.is_identity()
        cfg.transforms[0].set_matrix(np.diag([2.0, 1, 1, 1]))
        assert not cfg.is_identity()
        cfg.refresh_transforms()
        assert json.loads(cfg.get())["camera"][0]["trafo"][0][0] == 2.0
        cfg.init_transforms()
        assert cfg.transforms[0].get_matrix()[0, 0] == 2.0
        cfg.save()
        cfg2 = CameraConfig(fn)
        cfg2.load_from_file()
        assert cfg2.transforms[0].get_matrix()[0, 0] == 2.0


class TestPlotter:
    def test_plotter_writes_file(self, tmp_path):
        from cwipc_util_jax.registration.abstract import AnalysisResults
        from cwipc_util_jax.registration.plot import Plotter, set_default_plot_style

        res = AnalysisResults()
        res.tilemask = 1
        res.minCorrespondence = 0.01
        res.histogram = np.ones(32)
        res.histogramEdges = np.linspace(0, 0.05, 33)
        out = str(tmp_path / "plot.png")
        p = Plotter("test plot")
        p.set_results([res])
        p.plot(filename=out, which=["count", "cumulative", "delta"])
        assert os.path.getsize(out) > 0
        set_default_plot_style("count,delta")
        from cwipc_util_jax.registration import plot as plot_mod

        assert plot_mod.DEFAULT_PLOT_STYLE == ["count", "delta"]
        set_default_plot_style(["count", "cumulative"])


class TestFilterStats:
    def test_print1stat(self, capsys):
        from cwipc_util_jax.filters.voxelize import CustomFilter

        f = CustomFilter(0.05)
        f.print1stat("duration", [0.5, 1.5])
        out = capsys.readouterr().out
        assert "count=2" in out and "average=1.000" in out
        f.print1stat("empty", [])
        assert "count=0" in capsys.readouterr().out


class TestScriptClasses:
    def _grab_args(self, **kw):
        import argparse

        from cwipc_util_jax.scripts.cwipc_grab import make_parser

        argv = kw.pop("argv")
        return make_parser().parse_args(argv)

    def test_filewriter_save_pc_and_setup_encoder(self, tmp_path):
        from cwipc_util_jax.scripts.cwipc_grab import FileWriter

        w = FileWriter(str(tmp_path), "pointcloud-%s.ply")
        pc = cwipc.cwipc_from_points([(0.0, 0.0, 0.0, 1, 2, 3, 1)], 42)
        assert w.save_pc(pc)
        assert list(tmp_path.glob("*.ply"))
        w.setup_encoder(dict(octree_bits=8))
        assert w.encoder is not None and w.compressed
        w.stop()

    def test_filewriter_run_waits_for_producer(self, tmp_path):
        import threading
        import time

        from cwipc_util_jax.scripts.cwipc_grab import FileWriter

        w = FileWriter(str(tmp_path), "pointcloud-%s.ply", incore=True)
        producer = threading.Thread(target=lambda: time.sleep(0.2))
        w.set_producer(producer)
        producer.start()
        pc = cwipc.cwipc_from_points([(0.0, 0.0, 0.0, 1, 2, 3, 1)], 7)
        w.feed(pc)
        assert not list(tmp_path.glob("*.ply"))  # buffered (incore)
        assert w.run() is True  # waits for producer, then flushes
        assert list(tmp_path.glob("*.ply"))

    def test_dropwriter_records(self, tmp_path):
        import argparse

        from cwipc_util_jax.scripts.cwipc_timing import DropWriter

        out = str(tmp_path / "t.csv")
        args = argparse.Namespace(details=False, savergb=0, output=out)
        w = DropWriter(args)
        for ts in (100, 133):
            pc = cwipc.cwipc_from_points([(0.0, 0.0, 0.0, 1, 2, 3, 1)], ts)
            w.record_pc(pc)
            pc.free()
        w.stop()
        lines = open(out).read().strip().splitlines()
        assert len(lines) == 3
        assert "timestamp_ms" in lines[0]
        assert lines[2].split(",")[4] == "33"  # frame_duration_ms

    def test_analysis_test_creator(self, tmp_path):
        import argparse

        from cwipc_util_jax.scripts.cwipc_create_analysis_test import AnalysisTestCreator

        args = argparse.Namespace(
            ncamera=2, noise=0.0, translation=0.01, rotation=0.02, seed=1,
            verbose=0, synthetic=True, playback=None, fps=0, npoints=2000,
            loop=False, inpoint=None, outpoint=None, retimestamp=False,
            nodecode=False, netclient=None, mt_netclient=None, lldplay=None,
            mt_lldplay=None, proxy=None, cameraconfig=None,
        )
        c = AnalysisTestCreator(args)
        c.load_input()
        c.create_default_description()
        assert [e["tilemask"] for e in c.description] == [1, 2]
        assert c.run()
        out = str(tmp_path / "fixture.ply")
        c.save_output(out)
        assert os.path.exists(out) and os.path.exists(out + ".gt.json")
        gt = json.load(open(out + ".gt.json"))
        assert set(gt.keys()) == {"1", "2"}
