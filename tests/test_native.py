"""Native C ABI tests: build libcwipc_util_jax.so, bind it with ctypes, and
verify cross-language parity — files and packets written by the native lib
must read back identically through the Python/JAX layer and vice versa
(the reference's C-ABI interop contract, include/cwipc_util/api.h)."""

import ctypes
import os
import pathlib
import subprocess

import numpy as np
import pytest

import cwipc_util_jax as cwipc

NATIVE_DIR = pathlib.Path(__file__).parent.parent / "cwipc_util_jax" / "native"


@pytest.fixture(scope="module")
def native_lib():
    so = NATIVE_DIR / "build" / "libcwipc_util_jax.so"
    if not so.exists():
        rv = subprocess.run(["make", "-C", str(NATIVE_DIR)], capture_output=True, text=True)
        if rv.returncode != 0:
            pytest.skip(f"native build failed: {rv.stderr[-500:]}")
    lib = ctypes.CDLL(str(so))
    lib.cwipc_from_points.restype = ctypes.c_void_p
    lib.cwipc_from_points.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_uint64,
    ]
    lib.cwipc_from_packet.restype = ctypes.c_void_p
    lib.cwipc_from_packet.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_char_p), ctypes.c_uint64,
    ]
    lib.cwipc_read.restype = ctypes.c_void_p
    lib.cwipc_read.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_char_p), ctypes.c_uint64,
    ]
    lib.cwipc_write.restype = ctypes.c_int
    lib.cwipc_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p)]
    lib.cwipc_pointcloud_count.restype = ctypes.c_int
    lib.cwipc_pointcloud_count.argtypes = [ctypes.c_void_p]
    lib.cwipc_pointcloud_timestamp.restype = ctypes.c_uint64
    lib.cwipc_pointcloud_timestamp.argtypes = [ctypes.c_void_p]
    lib.cwipc_pointcloud_copy_packet.restype = ctypes.c_size_t
    lib.cwipc_pointcloud_copy_packet.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.cwipc_pointcloud_copy_uncompressed.restype = ctypes.c_int
    lib.cwipc_pointcloud_copy_uncompressed.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.cwipc_pointcloud_free.argtypes = [ctypes.c_void_p]
    lib.cwipc_downsample.restype = ctypes.c_void_p
    lib.cwipc_downsample.argtypes = [ctypes.c_void_p, ctypes.c_float]
    lib.cwipc_remove_outliers.restype = ctypes.c_void_p
    lib.cwipc_remove_outliers.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ]
    lib.cwipc_dangling_allocations.restype = ctypes.c_int
    lib.cwipc_dangling_allocations.argtypes = [ctypes.c_int]
    return lib


def _py_cloud():
    return cwipc.cwipc_from_points(
        [(1, 2, 3, 0x10, 0x20, 0x30, 1), (4, 5, 6, 0x40, 0x50, 0x60, 2)], 4242
    )


class TestNativeInterop:
    def test_packet_python_to_native(self, native_lib):
        """Packets serialized by the Python layer parse in the native lib."""
        pc = _py_cloud()
        packet = bytes(pc.get_packet())
        err = ctypes.c_char_p()
        buf = ctypes.create_string_buffer(packet, len(packet))
        npc = native_lib.cwipc_from_packet(buf, len(packet), ctypes.byref(err), cwipc.CWIPC_API_VERSION)
        assert not err.value, err.value
        assert npc
        assert native_lib.cwipc_pointcloud_count(npc) == 2
        assert native_lib.cwipc_pointcloud_timestamp(npc) == 4242
        native_lib.cwipc_pointcloud_free(npc)

    def test_packet_native_to_python(self, native_lib):
        """Packets serialized natively parse in the Python layer, bit-equal."""
        pc = _py_cloud()
        pts = bytes(pc.get_bytes())
        err = ctypes.c_char_p()
        buf = ctypes.create_string_buffer(pts, len(pts))
        npc = native_lib.cwipc_from_points(buf, len(pts), 2, 4242, ctypes.byref(err), cwipc.CWIPC_API_VERSION)
        assert npc
        need = native_lib.cwipc_pointcloud_copy_packet(npc, None, 0)
        out = ctypes.create_string_buffer(int(need))
        assert native_lib.cwipc_pointcloud_copy_packet(npc, out, need) == need
        pc2 = cwipc.cwipc_from_packet(out.raw)
        assert list(pc2.get_points()) == list(pc.get_points())
        assert pc2.timestamp() == 4242
        native_lib.cwipc_pointcloud_free(npc)

    def test_ply_cross_read(self, native_lib, tmp_path):
        """Native-written PLY reads in Python and vice versa (ascii+binary)."""
        pc = _py_cloud()
        err = ctypes.c_char_p()
        for flags in (0, cwipc.CWIPC_FLAGS_BINARY):
            fn = str(tmp_path / f"py_{flags}.ply")
            cwipc.cwipc_write(fn, pc, flags)
            npc = native_lib.cwipc_read(fn.encode(), 0, ctypes.byref(err), cwipc.CWIPC_API_VERSION)
            assert npc, err.value
            assert native_lib.cwipc_pointcloud_count(npc) == 2
            fn2 = str(tmp_path / f"native_{flags}.ply")
            assert native_lib.cwipc_write(fn2.encode(), npc, ctypes.byref(err)) == 0
            pc2 = cwipc.cwipc_read(fn2, 0)
            assert list(pc2.get_points()) == list(pc.get_points())
            native_lib.cwipc_pointcloud_free(npc)

    def test_native_remove_outliers_exact(self, native_lib):
        """The native shell-expansion kNN is EXACT: its keep set equals the
        scipy-KDTree oracle's (the old fixed-ring surrogate was silently
        wrong whenever the k-th neighbor fell outside the 3x3x3 ring)."""
        from scipy.spatial import cKDTree

        gen = cwipc.cwipc_synthetic(0, 9000)
        gen.start()
        pc = gen.get()
        gen.stop()
        down = cwipc.cwipc_downsample(pc, 0.01)
        k, mult = 30, 1.0
        pts_m = down.get_numpy_matrix(onlyGeometry=True).astype(np.float64)
        tree = cKDTree(pts_m)
        dist, _ = tree.query(pts_m, k=k + 1, workers=-1)
        md = dist[:, 1:].mean(axis=1)
        mu = md.mean()
        var = ((md * md).sum() - md.sum() ** 2 / len(md)) / (len(md) - 1)
        keep = md <= mu + mult * np.sqrt(max(var, 0.0))

        pts = bytes(down.get_bytes())
        err = ctypes.c_char_p()
        buf = ctypes.create_string_buffer(pts, len(pts))
        npc = native_lib.cwipc_from_points(
            buf, len(pts), down.count(), 0, ctypes.byref(err), cwipc.CWIPC_API_VERSION
        )
        nclean = native_lib.cwipc_remove_outliers(
            npc, k, ctypes.c_float(mult), False
        )
        n = native_lib.cwipc_pointcloud_count(nclean)
        assert n == int(keep.sum()), (n, int(keep.sum()))
        native_lib.cwipc_pointcloud_free(npc)
        native_lib.cwipc_pointcloud_free(nclean)

    def test_native_remove_outliers_flying_pixel(self, native_lib):
        """An isolated far point must be REMOVED: the shell expansion
        runs out of shells with < k neighbors there, and the old code
        divided the deficit by k, scoring the most-isolated point as the
        strongest inlier (md=0).  Keep set must equal the KD-tree
        oracle's, which removes it."""
        from scipy.spatial import cKDTree

        rng = np.random.default_rng(3)
        n = 800
        m = np.zeros((n, 7))
        m[: n - 1, :3] = rng.random((n - 1, 3)) * 0.5
        m[n - 1, :3] = (50.0, 50.0, 50.0)  # flying pixel, far outside
        pc = cwipc.cwipc_from_numpy_matrix(m, 0)
        k, mult = 12, 1.0
        tree = cKDTree(m[:, :3])
        dist, _ = tree.query(m[:, :3], k=k + 1, workers=-1)
        md = dist[:, 1:].mean(axis=1)
        mu = md.mean()
        var = ((md * md).sum() - md.sum() ** 2 / n) / (n - 1)
        keep = md <= mu + mult * np.sqrt(max(var, 0.0))
        assert not keep[n - 1]  # the oracle removes the flying pixel

        pts = bytes(pc.get_bytes())
        err = ctypes.c_char_p()
        buf = ctypes.create_string_buffer(pts, len(pts))
        npc = native_lib.cwipc_from_points(
            buf, len(pts), n, 0, ctypes.byref(err), cwipc.CWIPC_API_VERSION
        )
        nclean = native_lib.cwipc_remove_outliers(
            npc, k, ctypes.c_float(mult), False
        )
        got = native_lib.cwipc_pointcloud_count(nclean)
        assert got == int(keep.sum()), (got, int(keep.sum()))
        native_lib.cwipc_pointcloud_free(npc)
        native_lib.cwipc_pointcloud_free(nclean)

    def test_native_downsample_matches_python(self, native_lib):
        """The native hash-grid downsample and the JAX downsample agree on the
        voxel set (order-independent)."""
        gen = cwipc.cwipc_synthetic(0, 2500)
        gen.start()
        pc = gen.get()
        gen.stop()
        py_down = cwipc.cwipc_downsample(pc, 0.05)

        pts = bytes(pc.get_bytes())
        err = ctypes.c_char_p()
        buf = ctypes.create_string_buffer(pts, len(pts))
        npc = native_lib.cwipc_from_points(buf, len(pts), pc.count(), 0, ctypes.byref(err), cwipc.CWIPC_API_VERSION)
        ndown = native_lib.cwipc_downsample(npc, 0.05)
        n = native_lib.cwipc_pointcloud_count(ndown)
        assert n == py_down.count()
        out = ctypes.create_string_buffer(n * 16)
        native_lib.cwipc_pointcloud_copy_uncompressed(ndown, out, n * 16)
        native_arr = np.frombuffer(out.raw, cwipc.POINT_DTYPE)
        py_arr = py_down.get_numpy_array()

        # set equality keyed by voxel id (hash map order != Morton order, and
        # f32-vs-f64 accumulation gives sub-1e-5 centroid differences)
        def as_dict(arr):
            inv = np.float32(1.0) / np.float32(0.05)
            keys = np.floor(
                np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float32) * inv
            ).astype(np.int64)
            return {
                tuple(k): (float(x), float(y), float(z), int(t))
                for k, x, y, z, t in zip(keys, arr["x"], arr["y"], arr["z"], arr["tile"])
            }

        nd, pd = as_dict(native_arr), as_dict(py_arr)
        assert set(nd.keys()) == set(pd.keys())
        for k in nd:
            nx, ny, nz, nt = nd[k]
            px, py_, pz, pt = pd[k]
            assert abs(nx - px) < 1e-4 and abs(ny - py_) < 1e-4 and abs(nz - pz) < 1e-4
            assert nt == pt, f"tile mismatch at voxel {k}: {nt} vs {pt}"
        native_lib.cwipc_pointcloud_free(npc)
        native_lib.cwipc_pointcloud_free(ndown)

    def test_native_leak_oracle(self, native_lib):
        before = native_lib.cwipc_dangling_allocations(0)
        pc = _py_cloud()
        pts = bytes(pc.get_bytes())
        buf = ctypes.create_string_buffer(pts, len(pts))
        err = ctypes.c_char_p()
        npc = native_lib.cwipc_from_points(buf, len(pts), 2, 0, ctypes.byref(err), cwipc.CWIPC_API_VERSION)
        assert native_lib.cwipc_dangling_allocations(0) == before + 1
        native_lib.cwipc_pointcloud_free(npc)
        assert native_lib.cwipc_dangling_allocations(0) == before

    def test_native_apps_roundtrip(self, native_lib, tmp_path):
        """The native CLI apps convert files the Python layer can read."""
        build = NATIVE_DIR / "build"
        rv = subprocess.run(
            [str(build / "cwipc_generate"), "1", str(tmp_path)],
            capture_output=True, text=True,
        )
        assert rv.returncode == 0, rv.stderr
        ply = rv.stdout.strip().splitlines()[-1]
        dump = str(tmp_path / "out.cwipcdump")
        rv = subprocess.run([str(build / "cwipc_ply2dump"), ply, dump], capture_output=True, text=True)
        assert rv.returncode == 0, rv.stderr
        pc = cwipc.cwipc_read_debugdump(dump)
        assert pc.count() == 160000


def test_native_proxy_receives_packet(native_lib):
    """The native cwipc_proxy must accept our legacy packets and hand over
    the newest cloud (latest-wins) with a timestamp ack
    (reference protocol: src/cwipc_proxy.cpp:158-254)."""
    import socket
    import struct
    import time

    lib = native_lib
    lib.cwipc_proxy.restype = ctypes.c_void_p
    lib.cwipc_proxy.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p), ctypes.c_uint64,
    ]
    lib.cwipc_source_get.restype = ctypes.c_void_p
    lib.cwipc_source_get.argtypes = [ctypes.c_void_p]
    lib.cwipc_source_available.restype = ctypes.c_int
    lib.cwipc_source_available.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cwipc_pointcloud_timestamp.restype = ctypes.c_uint64
    lib.cwipc_pointcloud_timestamp.argtypes = [ctypes.c_void_p]
    lib.cwipc_pointcloud_count.restype = ctypes.c_int
    lib.cwipc_pointcloud_count.argtypes = [ctypes.c_void_p]
    lib.cwipc_pointcloud_free.argtypes = [ctypes.c_void_p]
    lib.cwipc_source_free.argtypes = [ctypes.c_void_p]

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    err = ctypes.c_char_p()
    src = lib.cwipc_proxy(b"127.0.0.1", port, ctypes.byref(err), 0x20260129)
    assert src, err.value
    try:
        conn = socket.create_connection(("127.0.0.1", port), timeout=10)
        payload = struct.pack("<fffBBBB", 1.0, 2.0, 3.0, 10, 20, 30, 1)
        hdr = struct.pack("<IIQfI", 0x20201016, len(payload), 4242, 0.05, 0)
        conn.sendall(hdr + payload)
        ack = conn.recv(8)
        assert struct.unpack("<Q", ack)[0] == 4242
        deadline = time.time() + 10
        while not lib.cwipc_source_available(src, 1) and time.time() < deadline:
            pass
        pc = lib.cwipc_source_get(src)
        assert pc
        assert lib.cwipc_pointcloud_timestamp(pc) == 4242
        assert lib.cwipc_pointcloud_count(pc) == 1
        lib.cwipc_pointcloud_free(pc)
        conn.close()
    finally:
        lib.cwipc_source_free(src)


def test_timing_harness_runs():
    """The accessor benchmark harness must run end-to-end on a small cloud
    (reference: python/timing_tests.py)."""
    import subprocess
    import sys

    env = dict(os.environ)
    env["PYTHONPATH"] = str(pathlib.Path(__file__).parent.parent)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-m", "cwipc_util_jax.benchmarks.timing_tests", "2000"],
        capture_output=True, text=True, timeout=240, env=env,
    )
    assert r.returncode == 0, r.stderr[-500:]
    assert "get_points" in r.stdout or "get_numpy" in r.stdout


# ---------------------------------------------------------------------------
# Full extern "C" surface parity (reference: include/cwipc_util/api.h:598-1143
# plus internal/capturers.hpp:515) — function-for-function symbol check.
# ---------------------------------------------------------------------------

REFERENCE_ABI_SYMBOLS = [
    # logging / diagnostics
    "_cwipc_log_emit", "cwipc_log_configure", "cwipc_dangling_allocations",
    "cwipc_get_version",
    # point cloud object
    "cwipc_from_points", "cwipc_from_packet", "cwipc_pointcloud_free",
    "cwipc_pointcloud_timestamp", "cwipc_pointcloud_cellsize",
    "cwipc_pointcloud__set_cellsize", "cwipc_pointcloud__set_timestamp",
    "cwipc_pointcloud_count", "cwipc_pointcloud_get_uncompressed_size",
    "cwipc_pointcloud_copy_uncompressed", "cwipc_pointcloud_copy_packet",
    "cwipc_pointcloud_access_metadata", "cwipc_pointcloud__shallowcopy",
    # serialization
    "cwipc_read", "cwipc_write", "cwipc_write_ext",
    "cwipc_read_debugdump", "cwipc_write_debugdump",
    # operators
    "cwipc_downsample", "cwipc_remove_outliers", "cwipc_tilefilter",
    "cwipc_tilemap", "cwipc_crop", "cwipc_colormap", "cwipc_join",
    # sources
    "cwipc_synthetic", "cwipc_capturer", "cwipc_proxy",
    "cwipc_source_free", "cwipc_source_get", "cwipc_source_available",
    "cwipc_source_eof",
    # activesource
    "cwipc_activesource_start", "cwipc_activesource_stop",
    "cwipc_activesource_reload_config", "cwipc_activesource_get_config",
    "cwipc_activesource_seek", "cwipc_activesource_maxtile",
    "cwipc_activesource_get_tileinfo", "cwipc_activesource_request_metadata",
    "cwipc_activesource_is_metadata_requested",
    "cwipc_activesource_auxiliary_operation",
    # sink / window
    "cwipc_sink_free", "cwipc_sink_feed", "cwipc_sink_caption",
    "cwipc_sink_interact", "cwipc_window",
    # metadata
    "cwipc_metadata_count", "cwipc_metadata_name",
    "cwipc_metadata_description", "cwipc_metadata_size",
    "cwipc_metadata_pointer", "cwipc_metadata__move",
    # capturer plugin registry
    "_cwipc_register_capturer",
]


def test_abi_symbol_parity(native_lib):
    """Every extern "C" function of the reference ABI resolves in our .so."""
    missing = []
    for name in REFERENCE_ABI_SYMBOLS:
        try:
            getattr(native_lib, name)
        except AttributeError:
            missing.append(name)
    assert not missing, f"ABI symbols missing: {missing}"


def _bind_activesource(lib):
    lib.cwipc_synthetic.restype = ctypes.c_void_p
    lib.cwipc_synthetic.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p), ctypes.c_uint64,
    ]
    lib.cwipc_activesource_start.argtypes = [ctypes.c_void_p]
    lib.cwipc_activesource_stop.argtypes = [ctypes.c_void_p]
    lib.cwipc_activesource_request_metadata.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.cwipc_activesource_is_metadata_requested.restype = ctypes.c_int
    lib.cwipc_activesource_is_metadata_requested.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.cwipc_activesource_auxiliary_operation.restype = ctypes.c_int
    lib.cwipc_activesource_auxiliary_operation.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_size_t,
    ]
    lib.cwipc_activesource_seek.restype = ctypes.c_int
    lib.cwipc_activesource_seek.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.cwipc_activesource_maxtile.restype = ctypes.c_int
    lib.cwipc_activesource_maxtile.argtypes = [ctypes.c_void_p]
    lib.cwipc_source_get.restype = ctypes.c_void_p
    lib.cwipc_source_get.argtypes = [ctypes.c_void_p]
    lib.cwipc_source_free.argtypes = [ctypes.c_void_p]
    lib.cwipc_pointcloud_access_metadata.restype = ctypes.c_void_p
    lib.cwipc_pointcloud_access_metadata.argtypes = [ctypes.c_void_p]
    lib.cwipc_metadata_count.restype = ctypes.c_int
    lib.cwipc_metadata_count.argtypes = [ctypes.c_void_p]
    lib.cwipc_metadata_name.restype = ctypes.c_char_p
    lib.cwipc_metadata_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cwipc_metadata_size.restype = ctypes.c_size_t
    lib.cwipc_metadata_size.argtypes = [ctypes.c_void_p, ctypes.c_int]


def test_activesource_metadata_and_aux_op(native_lib):
    """The synthetic source's test hooks work through the activesource ABI
    (reference: src/cwipc_synthetic.cpp:134-139 test-angle metadata,
    :169-179 test-setangle aux op; test model test_cwipc_util.py:342-389)."""
    lib = native_lib
    _bind_activesource(lib)
    src = lib.cwipc_synthetic(0, 1000, None, 0x20260129)
    assert src
    try:
        assert lib.cwipc_activesource_maxtile(src) == 3
        assert not lib.cwipc_activesource_is_metadata_requested(src, b"test-angle")
        lib.cwipc_activesource_request_metadata(src, b"test-angle")
        assert lib.cwipc_activesource_is_metadata_requested(src, b"test-angle")
        assert lib.cwipc_activesource_start(src)
        pc = lib.cwipc_source_get(src)
        assert pc
        md = lib.cwipc_pointcloud_access_metadata(pc)
        names = [lib.cwipc_metadata_name(md, i) for i in range(lib.cwipc_metadata_count(md))]
        assert b"test-angle" in names
        idx = names.index(b"test-angle")
        assert lib.cwipc_metadata_size(md, idx) == 4
        lib.cwipc_pointcloud_free(pc)

        inval = ctypes.c_float(1.5)
        outval = ctypes.c_float(0.0)
        ok = lib.cwipc_activesource_auxiliary_operation(
            src, b"test-setangle", ctypes.byref(inval), 4, ctypes.byref(outval), 4)
        assert ok
        assert abs(outval.value - 1.5) < 1e-6
        # unknown op and bad sizes must fail
        assert not lib.cwipc_activesource_auxiliary_operation(
            src, b"no-such-op", ctypes.byref(inval), 4, ctypes.byref(outval), 4)
        assert not lib.cwipc_activesource_auxiliary_operation(
            src, b"test-setangle", ctypes.byref(inval), 2, ctypes.byref(outval), 4)
        # synthetic cannot seek or reload
        assert not lib.cwipc_activesource_seek(src, 1234)
        lib.cwipc_activesource_stop(src)
    finally:
        lib.cwipc_source_free(src)


def _bind_sink(lib):
    lib.cwipc_window.restype = ctypes.c_void_p
    lib.cwipc_window.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_uint64,
    ]
    lib.cwipc_sink_free.argtypes = [ctypes.c_void_p]
    lib.cwipc_sink_feed.restype = ctypes.c_int
    lib.cwipc_sink_feed.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.cwipc_sink_caption.restype = ctypes.c_int
    lib.cwipc_sink_caption.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.cwipc_sink_interact.restype = ctypes.c_char
    lib.cwipc_sink_interact.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32,
    ]
    lib._cwipc_window_inject_key.argtypes = [ctypes.c_void_p, ctypes.c_char]


def test_window_sink_protocol(native_lib, tmp_path):
    """cwipc_window implements the full sink contract headlessly: feed renders
    into the framebuffer, caption succeeds, interact honors the responses
    filter and timeout (reference: api.h:452-507)."""
    lib = native_lib
    _bind_activesource(lib)
    _bind_sink(lib)
    snap = tmp_path / "frame.ppm"
    os.environ["CWIPC_WINDOW_SNAPSHOT"] = str(snap)
    try:
        sink = lib.cwipc_window(b"test-window", None, 0x20260129)
        assert sink
        src = lib.cwipc_synthetic(0, 1000, None, 0x20260129)
        lib.cwipc_activesource_start(src)
        pc = lib.cwipc_source_get(src)
        assert lib.cwipc_sink_feed(sink, pc, 1)
        lib.cwipc_pointcloud_free(pc)
        lib.cwipc_source_free(src)
        assert lib.cwipc_sink_caption(sink, b"new caption")
        # no key queued + no wait -> NUL
        assert lib.cwipc_sink_interact(sink, b"prompt", b"qc", 0) == b"\x00"
        # queued key matching the responses filter is returned
        lib._cwipc_window_inject_key(sink, b"q")
        assert lib.cwipc_sink_interact(sink, b"prompt", b"qc", 100) == b"q"
        # non-matching key is swallowed, times out with NUL
        lib._cwipc_window_inject_key(sink, b"x")
        assert lib.cwipc_sink_interact(sink, b"prompt", b"qc", 50) == b"\x00"
        lib.cwipc_sink_free(sink)
        data = snap.read_bytes()
        assert data.startswith(b"P6")
        assert any(b for b in data[20:])  # rendered something
    finally:
        os.environ.pop("CWIPC_WINDOW_SNAPSHOT", None)


def test_viewsynthetic_app():
    """The native cwipc_viewsynthetic app runs headlessly (reference:
    apps/cwipc_viewsynthetic/cwipc_viewsynthetic.cpp)."""
    app = NATIVE_DIR / "build" / "cwipc_viewsynthetic"
    if not app.exists():
        subprocess.run(["make", "-C", str(NATIVE_DIR)], capture_output=True)
    r = subprocess.run([str(app), "0", "1000", "2"], capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stderr[-500:]
    assert "displayed 2 frames" in r.stdout


def test_pcl2dump_app(tmp_path):
    """cwipc_pcl2dump reads a .ply with its own (PCL-analog) reader and
    converts via the public ABI (reference: apps/cwipc_pcl2dump)."""
    build = NATIVE_DIR / "build"
    gen = subprocess.run([str(build / "cwipc_generate"), "1", str(tmp_path)],
                         capture_output=True, text=True, timeout=60)
    assert gen.returncode == 0, gen.stderr[-300:]
    ply = gen.stdout.strip().splitlines()[-1]
    dump = str(tmp_path / "out.cwipcdump")
    r = subprocess.run([str(build / "cwipc_pcl2dump"), ply, dump],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr[-300:]
    assert "160000 points" in r.stderr
    # the dump must read back identically through the Python layer
    import cwipc_util_jax as cwipc

    pc = cwipc.cwipc_read_debugdump(dump)
    assert pc.count() == 160000
    pc.free()
    # "-" performance mode skips the save
    r = subprocess.run([str(build / "cwipc_pcl2dump"), ply, "-"],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0
    assert "Skipping save" in r.stderr


def test_native_degenerate_args(native_lib):
    """Edge arguments must not invoke UB: k<1 outlier removal clamps to 1
    (no before-begin nth_element / division by zero), cellsize-0
    downsample is a no-op copy (no inf->int cast), and out-of-range
    metadata indexes return NULL instead of throwing across the C ABI."""
    import cwipc_util_jax as cwipc

    gen = cwipc.cwipc_synthetic(0, 2000)
    gen.start()
    pc = gen.get()
    gen.stop()
    pts = bytes(pc.get_bytes())
    err = ctypes.c_char_p()
    buf = ctypes.create_string_buffer(pts, len(pts))
    npc = native_lib.cwipc_from_points(
        buf, len(pts), pc.count(), 0, ctypes.byref(err), cwipc.CWIPC_API_VERSION
    )
    # k=0: must not crash and must not delete the whole cloud
    nclean = native_lib.cwipc_remove_outliers(npc, 0, ctypes.c_float(1.0), False)
    n = native_lib.cwipc_pointcloud_count(nclean)
    assert 0 < n <= pc.count()
    native_lib.cwipc_pointcloud_free(nclean)
    # cellsize 0: no-op copy
    ndown = native_lib.cwipc_downsample(npc, ctypes.c_float(0.0))
    assert native_lib.cwipc_pointcloud_count(ndown) == pc.count()
    native_lib.cwipc_pointcloud_free(ndown)
    native_lib.cwipc_pointcloud_free(npc)


def test_codec_native_paths_bit_exact(native_lib, monkeypatch):
    """The native codec fast paths (cwipc_enc_geometry, cwipc_enc_octree /
    cwipc_dec_octree, cwipc_dec_geometry) must be BIT-IDENTICAL to their
    numpy twins: same bitstream from the encoder, same decoded point
    records — the native path is a speed choice, never a semantic one
    (round 4; CWIPC_CODEC_NATIVE=0 forces the numpy twins)."""
    import numpy as np

    import cwipc_util_jax as cwipc
    import cwipc_util_jax.codec as C

    def reset():
        for attr in ("_NATIVE_GEO", "_NATIVE_OCT", "_NATIVE_DECG"):
            setattr(C, attr, None)

    gen = cwipc.cwipc_synthetic(0, 40000)
    gen.start()
    pc = gen.get()
    gen.stop()
    blobs, decs = {}, {}
    for mode, env in (("native", None), ("numpy", "0")):
        reset()
        if env is None:
            monkeypatch.delenv("CWIPC_CODEC_NATIVE", raising=False)
        else:
            monkeypatch.setenv("CWIPC_CODEC_NATIVE", env)
        for ob in (9, 11):  # narrow + wide-key paths
            enc = C.cwipc_new_encoder(
                params=C.cwipc_encoder_params(octree_bits=ob, jpeg_quality=85)
            )
            enc.feed(pc)
            blobs[(mode, ob)] = enc.get_bytes()
            dec = C.cwipc_new_decoder()
            dec.feed(blobs[(mode, ob)])
            decs[(mode, ob)] = dec.get().get_numpy_array().copy()
        # tilemask path through the geometry stage
        enc = C.cwipc_new_encoder(
            params=C.cwipc_encoder_params(octree_bits=9, tilenumber=1)
        )
        enc.feed(pc)
        blobs[(mode, "tile1")] = enc.get_bytes()
    reset()
    monkeypatch.delenv("CWIPC_CODEC_NATIVE", raising=False)
    for k in (9, 11, "tile1"):
        assert blobs[("native", k)] == blobs[("numpy", k)], f"bitstream {k}"
    for ob in (9, 11):
        assert np.array_equal(decs[("native", ob)], decs[("numpy", ob)])
