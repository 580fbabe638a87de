"""cwipc_util_jax — a JAX point-cloud framework for NVIDIA GPUs.

Brand-new implementation (JAX/XLA/Pallas) of the capability surface of the
reference ``cwipc_util`` library: the opaque point-cloud object, sources,
sinks, operators, streaming pipeline, registration toolkit and CLI suite.
Public names and semantics follow the reference's Python package
(reference: python/cwipc/__init__.py, python/cwipc/util.py) so existing user
code ports by changing the import; the implementation underneath is
device-first: clouds are fixed-capacity SoA buffers in device memory and
the operators are jitted XLA programs (one Pallas kernel on the GPU).
"""

from .core.compile_cache import enable_persistent_cache as _enable_persistent_cache

# Before anything can trigger a jit compile: every compiled program is
# persisted across processes (see core/compile_cache.py) — repeat
# registrations must not pay every program's compile twice.
_enable_persistent_cache()

from .abstract import (
    cwipc_activesource_abstract,
    cwipc_activesource_wrapper,
    cwipc_pointcloud_abstract,
    cwipc_sink_abstract,
    cwipc_sink_wrapper,
    cwipc_source_abstract,
    cwipc_source_wrapper,
)
from .core.buffers import POINT_DTYPE, POINT_SIZE, PointBuffer
from .core.errors import CwipcError
from .core.metadata import cwipc_metadata
from .core.pointcloud import (
    CWIPC_API_VERSION,
    cwipc_dangling_allocations,
    cwipc_point,
    cwipc_point_array,
    cwipc_point_numpy_dtype,
    cwipc_pointcloud_wrapper,
    cwipc_skeleton_collection,
    cwipc_skeleton_joint,
    parse_skeleton_collection,
)
from .io.dump import (
    CWIPC_CWIPCDUMP_HEADER,
    CWIPC_CWIPCDUMP_VERSION,
    pointcloud_from_packet,
    read_debugdump,
    write_debugdump,
)
from .io.ply import CWIPC_FLAGS_BINARY, read_ply, write_ply
from .ops import (
    cwipc_colormap,
    cwipc_crop,
    cwipc_downsample,
    cwipc_join,
    cwipc_join_multi,
    cwipc_remove_outliers,
    cwipc_tilefilter,
    cwipc_tilemap,
)
from .utils.logging import (
    CWIPC_LOG_LEVEL_DEBUG,
    CWIPC_LOG_LEVEL_ERROR,
    CWIPC_LOG_LEVEL_NONE,
    CWIPC_LOG_LEVEL_TRACE,
    CWIPC_LOG_LEVEL_WARNING,
    _cwipc_log_emit,
    cwipc_log_configure,
    cwipc_log_default_callback,
)
from .version import __version__

# ---------------------------------------------------------------------------
# Factories and converters (reference: python/cwipc/util.py:1084-1342)
# ---------------------------------------------------------------------------

import numpy as _np



def cwipc_get_version() -> str:
    return __version__


def cwipc_from_points(points, timestamp: int) -> cwipc_pointcloud_wrapper:
    """Create a pointcloud from a cwipc_point array, list of tuples, or bytes."""
    import ctypes as _ctypes

    if not isinstance(points, _ctypes.Array):
        points = cwipc_point_array(values=points)
    data = bytes(memoryview(points).cast("B")) if len(points) else b""
    arr = _np.frombuffer(data, POINT_DTYPE).copy()
    return cwipc_pointcloud_wrapper(None, timestamp, 0.0, _host_points=arr)


def cwipc_from_numpy_array(np_points, timestamp: int) -> cwipc_pointcloud_wrapper:
    """Create a pointcloud from a structured numpy array (POINT_DTYPE fields).

    Host-backed: the device buffer materializes lazily on first op use
    (the input is copied, so later caller mutations do not leak in)."""
    if np_points.dtype != POINT_DTYPE:
        np_points = np_points.astype(POINT_DTYPE)  # already a fresh copy
    else:
        np_points = np_points.copy()
    return cwipc_pointcloud_wrapper(
        None, timestamp, 0.0, _host_points=np_points
    )


def cwipc_from_numpy_matrix(np_points_matrix, timestamp: int) -> cwipc_pointcloud_wrapper:
    """Create a pointcloud from an Nx7 float matrix (x,y,z,r,g,b,tile)."""
    count = np_points_matrix.shape[0]
    assert np_points_matrix.shape == (count, 7)
    assert np_points_matrix.dtype in (_np.float32, _np.float64)
    arr = _np.zeros(count, POINT_DTYPE)
    arr["x"] = np_points_matrix[:, 0]
    arr["y"] = np_points_matrix[:, 1]
    arr["z"] = np_points_matrix[:, 2]
    arr["r"] = np_points_matrix[:, 3].astype(_np.uint8)
    arr["g"] = np_points_matrix[:, 4].astype(_np.uint8)
    arr["b"] = np_points_matrix[:, 5].astype(_np.uint8)
    arr["tile"] = np_points_matrix[:, 6].astype(_np.uint8)
    return cwipc_from_numpy_array(arr, timestamp)


def cwipc_from_o3d_pointcloud(o3d_pc, timestamp: int) -> cwipc_pointcloud_wrapper:
    """Create a pointcloud from an Open3D PointCloud (tile is lost).

    Color scaling quirk preserved from the reference
    (python/cwipc/util.py:1203-1211): colors are multiplied by 256, not 255.
    """
    points = _np.asarray(o3d_pc.points)
    colors = _np.asarray(o3d_pc.colors)
    n = points.shape[0]
    m = _np.zeros((n, 7))
    m[:, 0:3] = points
    m[:, 3:6] = colors * 256
    return cwipc_from_numpy_matrix(m, timestamp)


def cwipc_from_packet(packet) -> cwipc_pointcloud_wrapper:
    return pointcloud_from_packet(packet)


def cwipc_read(filename: str, timestamp: int) -> cwipc_pointcloud_wrapper:
    """Read a pointcloud from a .ply file."""
    return read_ply(filename, timestamp)


def cwipc_write(filename: str, pointcloud: cwipc_pointcloud_wrapper, flags: int = 0) -> int:
    """Write a pointcloud to a .ply file (CWIPC_FLAGS_BINARY for binary)."""
    return write_ply(filename, pointcloud, flags)


def cwipc_read_debugdump(filename: str) -> cwipc_pointcloud_wrapper:
    return read_debugdump(filename)


def cwipc_write_debugdump(filename: str, pointcloud: cwipc_pointcloud_wrapper) -> int:
    return write_debugdump(filename, pointcloud)


def cwipc_synthetic(fps: int = 0, npoints: int = 0):
    """Create a synthetic pointcloud source (the universal camera stand-in)."""
    from .models.synthetic import cwipc_source_synthetic

    return cwipc_source_synthetic(fps, npoints)


def cwipc_capturer(conffile=None):
    """Create a capturer through the plugin registry ("auto" probes types)."""
    from .models.capturer import cwipc_capturer as _factory

    return _factory(conffile)


def cwipc_proxy(host: str, port: int):
    """Create a source that receives pointcloud packets over TCP."""
    from .net.proxy import cwipc_proxy_source

    return cwipc_proxy_source(host, port)


def cwipc_window(title: str):
    """Create a viewer sink (interactive window or headless)."""
    from .io.visualizer_sink import cwipc_window_sink

    return cwipc_window_sink(title)


def cwipc_check_module(name: str) -> bool:
    """Probe availability of an optional capturer/codec module."""
    from .models.capturer import check_module

    return check_module(name)


CWIPC_POINT_PACKETHEADER_MAGIC = 0x20201016

__all__ = [
    "CWIPC_API_VERSION",
    "CWIPC_CWIPCDUMP_HEADER",
    "CWIPC_CWIPCDUMP_VERSION",
    "CWIPC_FLAGS_BINARY",
    "CWIPC_LOG_LEVEL_DEBUG",
    "CWIPC_LOG_LEVEL_ERROR",
    "CWIPC_LOG_LEVEL_NONE",
    "CWIPC_LOG_LEVEL_TRACE",
    "CWIPC_LOG_LEVEL_WARNING",
    "CWIPC_POINT_PACKETHEADER_MAGIC",
    "CwipcError",
    "PointBuffer",
    "cwipc_activesource_abstract",
    "cwipc_capturer",
    "cwipc_check_module",
    "cwipc_colormap",
    "cwipc_crop",
    "cwipc_dangling_allocations",
    "cwipc_downsample",
    "cwipc_from_numpy_array",
    "cwipc_from_numpy_matrix",
    "cwipc_from_o3d_pointcloud",
    "cwipc_from_packet",
    "cwipc_from_points",
    "cwipc_get_version",
    "cwipc_join",
    "cwipc_join_multi",
    "cwipc_log_configure",
    "cwipc_log_default_callback",
    "cwipc_metadata",
    "cwipc_point",
    "cwipc_point_array",
    "cwipc_point_numpy_dtype",
    "cwipc_pointcloud_abstract",
    "cwipc_pointcloud_wrapper",
    "cwipc_proxy",
    "cwipc_read",
    "cwipc_read_debugdump",
    "cwipc_remove_outliers",
    "cwipc_sink_abstract",
    "cwipc_source_abstract",
    "cwipc_synthetic",
    "cwipc_tilefilter",
    "cwipc_tilemap",
    "cwipc_window",
    "cwipc_write",
    "cwipc_write_debugdump",
    "_cwipc_log_emit",
]
