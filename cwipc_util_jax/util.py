"""Module-path alias: the reference's binding module is cwipc.util
(python/cwipc/util.py); user code does `from cwipc.util import ...`.
Everything it would import from there is re-exported here."""

from . import *  # noqa: F401,F403
from .abstract import (  # noqa: F401
    cwipc_activesource_abstract,
    cwipc_activesource_wrapper,
    cwipc_pointcloud_abstract,
    cwipc_sink_abstract,
    cwipc_sink_wrapper,
    cwipc_source_abstract,
    cwipc_source_wrapper,
)
from .core.buffers import POINT_DTYPE, POINT_SIZE, PointBuffer  # noqa: F401
from .core.errors import CwipcError  # noqa: F401
from .core.pointcloud import (  # noqa: F401
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

# ---------------------------------------------------------------------------
# Binding-surface types the reference defines directly in cwipc/util.py
# (reference: python/cwipc/util.py:289-355,368-400,555-571).  The structs
# match the native ABI (native/cwipc_capi.h == reference api.h); note the
# reference's own util.py carries a STALE cwipc_point_packetheader layout
# (hdr/magic/... with magic 0x20210208) that disagrees with its api.h and
# its toproxy wire code — we mirror the wire-true api.h layout instead.

import ctypes as _ctypes
import os as _os
from typing import Any as _Any, Callable as _Callable, List as _List, Optional as _Optional, Union as _Union

import numpy as _numpy
import numpy.typing as _numpy_typing

# Pythonic representation of a cwipc_point
cwipc_point_tuple = tuple
# Argument types accepted by cwipc_from_points / returned by get_points
cwipc_point_array_value_type = _Union[
    None, bytearray, bytes, _ctypes.Array, _List[tuple]
]
cwipc_point_numpy_array_value_type = _numpy_typing.NDArray[_Any]
cwipc_point_numpy_matrix_value_type = _numpy_typing.NDArray[_numpy.floating]

# Python-side logging callback signature (level, utf-8 message)
cwipc_log_callback_type = _Callable[[int, bytes], None]


class cwipc_vector(_ctypes.Structure):
    """A vector (reference util.py:296-318 / api.h cwipc_vector)."""

    _fields_ = [
        ("x", _ctypes.c_double),
        ("y", _ctypes.c_double),
        ("z", _ctypes.c_double),
    ]

    def __eq__(self, other: _Any) -> bool:
        if not isinstance(other, cwipc_vector):
            return False
        return all(getattr(self, f) == getattr(other, f) for f in ("x", "y", "z"))

    def __ne__(self, other: _Any) -> bool:
        return not self.__eq__(other)


class cwipc_tileinfo(_ctypes.Structure):
    """Direction/camera info of a pointcloud tile (api.h:150-155)."""

    _fields_ = [
        ("normal", cwipc_vector),
        ("cameraName", _ctypes.c_char_p),
        ("ncamera", _ctypes.c_uint8),
        ("cameraMask", _ctypes.c_uint8),
    ]


class cwipc_point_packetheader(_ctypes.Structure):
    """24-byte packet header for talking to a cwipc_proxy server
    (api.h:100-106; magic CWIPC_POINT_PACKETHEADER_MAGIC)."""

    _fields_ = [
        ("magic", _ctypes.c_uint32),
        ("dataCount", _ctypes.c_uint32),
        ("timestamp", _ctypes.c_uint64),
        ("cellsize", _ctypes.c_float),
        ("unused", _ctypes.c_uint32),
    ]


# Opaque native handles (the reference exposes ctypes pointer aliases for
# plugin authors; our native objects are equally opaque)
cwipc_pointcloud_p = _ctypes.c_void_p
cwipc_source_p = _ctypes.c_void_p
cwipc_activesource_p = _ctypes.c_void_p
cwipc_sink_p = _ctypes.c_void_p
cwipc_metadata_p = _ctypes.c_void_p

_cwipc_util_dll_reference: _Optional[_ctypes.CDLL] = None


def cwipc_util_dll_load(libname: _Optional[str] = None) -> _ctypes.CDLL:
    """Load the native cwipc_util shared library (building it on first use
    if the checkout ships only sources) and return the ctypes handle
    (reference: python/cwipc/util.py:368-400).  The framework's Python
    path never needs this — the native library exists for C-ABI interop
    (native/cwipc_capi.h) — but plugin authors can bind it directly."""
    global _cwipc_util_dll_reference
    if _cwipc_util_dll_reference is not None and libname is None:
        return _cwipc_util_dll_reference
    if libname is None:
        native_dir = _os.path.join(_os.path.dirname(__file__), "native")
        libname = _os.path.join(native_dir, "build", "libcwipc_util_jax.so")
        if not _os.path.exists(libname):
            import subprocess

            rv = subprocess.run(
                ["make", "-C", native_dir, "build/libcwipc_util_jax.so"],
                capture_output=True,
                text=True,
            )
            if not _os.path.exists(libname):
                raise RuntimeError(
                    f"Dynamic library cwipc_util not found ({rv.stderr[-200:]})"
                )
    dll = _ctypes.CDLL(libname)
    if _cwipc_util_dll_reference is None:
        _cwipc_util_dll_reference = dll
    return dll
