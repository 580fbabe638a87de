"""Host-side point-cloud object with the reference-compatible API.

This is the JAX `cwipc_pointcloud`: a thin host wrapper around a
device-resident :class:`~cwipc_util_jax.core.buffers.PointBuffer`, carrying
the host metadata (timestamp, cellsize, metadata collection) and implementing
the accessor/ownership protocol of the reference Python binding
(reference: python/cwipc/util.py:573-740 for the wrapper surface,
src/cwipc_util.cpp:94-410 for the underlying object semantics).

Design choices vs the reference:

* points live on-device; ``get_points``/``get_bytes`` lazily copy to host and
  cache (mirroring the lazy `_initialize_points_and_bytes`,
  python/cwipc/util.py:721-730);
* ``count`` is a device scalar until someone asks for it — op chains never
  synchronize;
* alloc/dealloc counters are kept as a leak-test oracle, mirroring
  ``cwipc_dangling_allocations`` (src/cwipc_util.cpp:89-93, 420-430).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Any, List, Optional, Union

import numpy as np

from .buffers import (
    POINT_DTYPE,
    POINT_SIZE,
    PointBuffer,
    buffer_from_numpy,
    buffer_to_numpy,
    empty_buffer,
)
from .errors import CwipcError
from .metadata import cwipc_metadata

CWIPC_API_VERSION = 0x20260129

# ---------------------------------------------------------------------------
# ctypes point record — bit-compatible with the reference
# (include/cwipc_util/api.h:88-96, python/cwipc/util.py:260-294)
# ---------------------------------------------------------------------------


class cwipc_point(ctypes.Structure):
    """Point data as a ctypes structure: x,y,z float32; r,g,b,tile uint8."""

    _fields_ = [
        ("x", ctypes.c_float),
        ("y", ctypes.c_float),
        ("z", ctypes.c_float),
        ("r", ctypes.c_ubyte),
        ("g", ctypes.c_ubyte),
        ("b", ctypes.c_ubyte),
        ("tile", ctypes.c_ubyte),
    ]

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, cwipc_point):
            return False
        return all(
            getattr(self, f) == getattr(other, f)
            for f in ("x", "y", "z", "r", "g", "b", "tile")
        )

    def __ne__(self, other: Any) -> bool:
        return not self.__eq__(other)

    def __repr__(self) -> str:
        return (
            f"cwipc_point({self.x}, {self.y}, {self.z},"
            f" {self.r}, {self.g}, {self.b}, {self.tile})"
        )


assert ctypes.sizeof(cwipc_point) == POINT_SIZE

cwipc_point_tuple = tuple
cwipc_point_numpy_dtype = [
    ("x", "<f4"),
    ("y", "<f4"),
    ("z", "<f4"),
    ("r", "u1"),
    ("g", "u1"),
    ("b", "u1"),
    ("tile", "u1"),
]

cwipc_point_array_value_type = Union[
    None, bytearray, bytes, "ctypes.Array[cwipc_point]", List[tuple]
]


def cwipc_point_array(
    *, count: Optional[int] = None, values: Any = ()
) -> "ctypes.Array[cwipc_point]":
    """Create an array of cwipc_point, optionally initialized.

    ``values`` may be a list of 7-tuples, bytes/bytearray of packed records,
    or an existing cwipc_point array; mirrors python/cwipc/util.py:557-568.
    """
    if isinstance(values, (bytes, bytearray, memoryview)):
        if count is None:
            count = len(values) // POINT_SIZE
        allocator = cwipc_point * count
        if isinstance(values, bytes):
            return allocator.from_buffer_copy(values)
        return allocator.from_buffer(values)
    if count is None:
        count = len(values)
    allocator = cwipc_point * count
    return allocator(*[cwipc_point(*v) if isinstance(v, tuple) else v for v in values])


# ---------------------------------------------------------------------------
# Allocation tracking (leak-test oracle)
# ---------------------------------------------------------------------------

_alloc_lock = threading.Lock()
_n_alloc = 0
_n_dealloc = 0


def _track_alloc() -> None:
    global _n_alloc
    with _alloc_lock:
        _n_alloc += 1


def _track_dealloc() -> None:
    global _n_dealloc
    with _alloc_lock:
        _n_dealloc += 1


def cwipc_dangling_allocations(log: bool) -> int:
    """Return the number of live (not-yet-freed) pointcloud objects."""
    from ..utils.logging import CWIPC_LOG_LEVEL_WARNING, _cwipc_log_emit

    with _alloc_lock:
        n = _n_alloc - _n_dealloc
    if log and n != 0:
        _cwipc_log_emit(
            CWIPC_LOG_LEVEL_WARNING,
            "cwipc_pointcloud",
            f"{n} free() mismatch. nAlloc={_n_alloc}, nFree={_n_dealloc}",
        )
    return abs(n)


# ---------------------------------------------------------------------------
# The point-cloud object
# ---------------------------------------------------------------------------


class cwipc_pointcloud_wrapper:
    """An opaque pointcloud: device SoA buffer + host metadata."""

    def __init__(
        self,
        buffer: Optional[PointBuffer] = None,
        timestamp: int = 0,
        cellsize: float = 0.0,
        _count_hint: Optional[int] = None,
        _host_points: Optional[np.ndarray] = None,
    ):
        """``_host_points`` (a POINT_DTYPE structured array) makes the
        wrapper HOST-backed: the device buffer materializes lazily on
        first ``_access_buffer``.  Host-only flows — decode -> view,
        file -> serialize — then never touch the accelerator (an eager
        upload and readback would copy the cloud both ways).  The array
        doubles as the host accessor cache and must not be mutated by the
        caller afterwards (same contract as the cached
        ``get_numpy_array`` result)."""
        self._buffer = buffer
        self._timestamp = int(timestamp)
        self._cellsize = float(cellsize)
        self._metadata: Optional[cwipc_metadata] = None
        self._points: Optional[ctypes.Array[cwipc_point]] = None
        self._bytes: Optional[bytearray] = None
        self._lazy_host: Optional[np.ndarray] = _host_points
        self._np_cache: Optional[np.ndarray] = _host_points
        if _host_points is not None and _count_hint is None:
            _count_hint = int(_host_points.shape[0])
        self._count_cache: Optional[int] = _count_hint
        self._native_handle: Optional[ctypes.c_void_p] = None
        self._owned = buffer is not None or _host_points is not None
        if self._owned:
            _track_alloc()

    def __del__(self):
        try:
            self.free()
        except Exception:
            pass

    # -- ownership protocol (python/cwipc/util.py:599-628) ----------------

    def free(self, *, force: bool = False) -> None:
        if self._owned:
            self._owned = False
            _track_dealloc()
        if getattr(self, "_native_handle", None):
            from ..util import cwipc_util_dll_load

            dll = cwipc_util_dll_load()
            dll.cwipc_pointcloud_free.argtypes = [ctypes.c_void_p]
            dll.cwipc_pointcloud_free(self._native_handle)
            self._native_handle = None
        self._buffer = None
        self._lazy_host = None
        # freed means freed: host caches go too, so accessors raise like
        # the reference's use-after-free instead of serving stale data
        self._np_cache = None
        self._points = None
        self._bytes = None

    def detach(self) -> "cwipc_pointcloud_wrapper":
        """Hand ownership to a new wrapper; self no longer frees the data."""
        rv = cwipc_pointcloud_wrapper.__new__(cwipc_pointcloud_wrapper)
        rv.__dict__.update(self.__dict__)
        self._owned = False
        self._native_handle = None  # rv owns the native twin now
        self._buffer = None
        self._lazy_host = None
        self._np_cache = None
        self._points = None
        self._bytes = None
        return rv

    def clone(self) -> "cwipc_pointcloud_wrapper":
        """Shallow copy: shares the (immutable) buffer(s), new identity."""
        self._assert_alive()
        rv = cwipc_pointcloud_wrapper(
            self._buffer, self._timestamp, self._cellsize,
            _count_hint=self._count_cache, _host_points=self._lazy_host,
        )
        return rv

    def _assert_alive(self) -> None:
        if self._buffer is None and self._lazy_host is None:
            raise CwipcError("cwipc: pointcloud already freed")

    def as_cwipc_p(self) -> ctypes.c_void_p:
        """ctypes-compatible handle for this cloud, for handing to C code
        built against the native ABI (reference: util.py:594-597).

        The reference wraps a native object and returns its live pointer;
        here the cloud is a device/host buffer, so the first call
        materializes a native twin through libcwipc_util_jax's
        ``cwipc_from_packet`` (same points, timestamp and cellsize).  The
        handle is cached, freed with this wrapper, and transferred by
        ``detach()`` like the reference's pointer."""
        self._assert_alive()
        if self._native_handle:
            return self._native_handle
        from ..util import cwipc_util_dll_load

        dll = cwipc_util_dll_load()
        dll.cwipc_from_packet.restype = ctypes.c_void_p
        dll.cwipc_from_packet.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_uint64,
        ]
        packet = bytes(self.get_packet())
        err = ctypes.c_char_p(None)
        handle = dll.cwipc_from_packet(
            packet, len(packet), ctypes.byref(err), CWIPC_API_VERSION
        )
        if not handle:
            raise CwipcError(
                err.value.decode("utf8") if err.value else "cwipc_from_packet failed"
            )
        self._native_handle = ctypes.c_void_p(handle)
        return self._native_handle

    # -- accessors ---------------------------------------------------------

    def _access_buffer(self) -> PointBuffer:
        self._assert_alive()
        if self._buffer is None:
            self._buffer = buffer_from_numpy(self._lazy_host)
        return self._buffer

    def timestamp(self) -> int:
        return self._timestamp

    def cellsize(self) -> float:
        return self._cellsize

    def _set_cellsize(self, cellsize: float) -> None:
        """Set cellsize; negative asks for the reference's guess heuristic.

        Quirk preserved from src/cwipc_util.cpp:176-204: the reference's
        "adjacent point" scan never advances its prev iterator, so the guess
        is the minimum distance from any point to the FIRST point.
        """
        if cellsize < 0 and (self._buffer is not None or self._lazy_host is not None):
            arr = self._numpy()
            if arr.shape[0] >= 2:
                xyz = np.stack([arr["x"], arr["y"], arr["z"]], axis=-1)
                d = np.linalg.norm(xyz[1:] - xyz[0], axis=-1)
                cellsize = float(d.min()) if d.size else 0.0
            else:
                cellsize = 0.0
        self._cellsize = float(cellsize)

    def _set_timestamp(self, timestamp: int) -> None:
        self._timestamp = int(timestamp)

    def count(self) -> int:
        if self._buffer is None and not self._owned:
            # Freed object: the reference's count() logs a warning and
            # returns 0 (src/cwipc_util.cpp:210-216 for the NULL case).
            from ..utils.logging import CWIPC_LOG_LEVEL_WARNING, cwipc_log

            cwipc_log(CWIPC_LOG_LEVEL_WARNING, "cwipc_util", "count: freed pointcloud")
            return 0
        if self._count_cache is None:
            self._count_cache = int(self._access_buffer().count)
        return self._count_cache

    def get_uncompressed_size(self) -> int:
        return self.count() * POINT_SIZE

    def _numpy(self) -> np.ndarray:
        if self._np_cache is None:
            self._np_cache = buffer_to_numpy(self._access_buffer())
            self._count_cache = int(self._np_cache.shape[0])
        return self._np_cache

    def get_points(self) -> "ctypes.Array[cwipc_point]":
        if self._points is None:
            self._points = cwipc_point_array(values=self.get_bytes())
        return self._points

    def get_bytes(self) -> bytearray:
        if self._bytes is None:
            self._bytes = bytearray(self._numpy().tobytes())
        return self._bytes

    def get_numpy_array(self) -> np.ndarray:
        return self._numpy().copy()

    def get_numpy_matrix(self, onlyGeometry: bool = False) -> np.ndarray:
        arr = self._numpy()
        ncol = 3 if onlyGeometry else 7
        m = np.zeros((arr.shape[0], ncol), np.float32)
        m[:, 0] = arr["x"]
        m[:, 1] = arr["y"]
        m[:, 2] = arr["z"]
        if not onlyGeometry:
            m[:, 3] = arr["r"]
            m[:, 4] = arr["g"]
            m[:, 5] = arr["b"]
            m[:, 6] = arr["tile"]
        return m

    def get_o3d_pointcloud(self):
        """Return an Open3D point cloud (requires open3d installed)."""
        import open3d  # optional dependency, gated

        m = self.get_numpy_matrix()
        pc = open3d.geometry.PointCloud()
        pc.points = open3d.utility.Vector3dVector(m[:, 0:3].astype(np.float64))
        pc.colors = open3d.utility.Vector3dVector((m[:, 3:6] / 255.0).astype(np.float64))
        return pc

    def get_packet(self) -> bytearray:
        from ..io.dump import packet_from_pointcloud

        return packet_from_pointcloud(self)

    def access_metadata(self) -> cwipc_metadata:
        if self._metadata is None:
            self._metadata = cwipc_metadata()
        return self._metadata


# ---------------------------------------------------------------------------
# Skeleton structures (k4abt body tracking interop,
# reference: include/cwipc_util/api.h:118-141, python/cwipc/util.py)
# ---------------------------------------------------------------------------


class cwipc_skeleton_joint(ctypes.Structure):
    """Per-joint skeleton information as reported by a body tracker."""

    _fields_ = [
        ("confidence", ctypes.c_uint32),
        ("x", ctypes.c_float),
        ("y", ctypes.c_float),
        ("z", ctypes.c_float),
        ("q_w", ctypes.c_float),
        ("q_x", ctypes.c_float),
        ("q_y", ctypes.c_float),
        ("q_z", ctypes.c_float),
    ]


class cwipc_skeleton_collection(ctypes.Structure):
    """Header of a skeleton collection; joints follow contiguously."""

    _fields_ = [
        ("n_skeletons", ctypes.c_uint32),
        ("n_joints", ctypes.c_uint32),
    ]


def parse_skeleton_collection(data: bytes):
    """Parse a skeleton-collection metadata blob into
    (n_skeletons, n_joints, [joint, ...])."""
    hdr = cwipc_skeleton_collection.from_buffer_copy(data[:8])
    joints = (cwipc_skeleton_joint * (hdr.n_skeletons * hdr.n_joints)).from_buffer_copy(
        data[8:]
    )
    return hdr.n_skeletons, hdr.n_joints, list(joints)
