"""Point-cloud compression codec (the framework's `cwipc_codec` equivalent).

The reference suite compresses clouds with the external `_cwipc_codec`
plugin (MPEG-anchor octree + JPEG, re-exported by python/cwipc/codec.py; API
usage at python/cwipc/net/sink_encoder.py:147-156).  This module provides
the same Python API surface — ``cwipc_encoder_params``,
``cwipc_new_encoder``, ``cwipc_new_encodergroup``, ``cwipc_new_decoder`` —
backed by a device-side codec:

* geometry: voxel quantization at ``octree_bits`` depth runs on-device
  through the Morton-sort downsample kernel (ops/voxelize.py), which emits
  the occupied voxels already in Morton order; the host stage
  delta-encodes the sorted 30-bit Morton codes and entropy-codes them with
  zlib (deltas of a sorted spatial curve are tiny).
* color/tile: per-voxel averaged RGB bytes and tile bytes in Morton order,
  zlib-compressed; ``jpeg_quality`` maps to the entropy-coder effort level.

The wire format ("CTC1") is self-consistent but deliberately NOT
bit-compatible with the MPEG anchor (that codec's bitstream is defined by
an external standard); the capability surface — tiled encoder groups,
multi-quality streams, .cwicpc playback — is equivalent.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..core.buffers import POINT_DTYPE, buffer_from_arrays
from ..core.errors import CwipcError
from ..core.pointcloud import cwipc_pointcloud_wrapper

MAGIC = b"CTC1"
_HDR_FMT = "<4sBBHIQ4fIII"
_HDR_SIZE = struct.calcsize(_HDR_FMT)

# header flag bits
# delta element width code: 0=u32 (legacy streams have flags==0), 1=u8,
# 2=u16, 3=u64
_FLAG_WIDTH_MASK = 0x03
_WIDTH_DTYPES = {0: np.uint32, 1: np.uint8, 2: np.uint16, 3: np.uint64}
_FLAG_WIDE_KEYS = 0x04  # 45-bit Morton keys (octree_bits > 10)
_FLAG_OCTREE = 0x08  # geometry = octree occupancy-byte stream (not deltas)
_FLAG_JPEG = 0x10  # colors = JPEG plane in Morton order (not zlib bytes)


_NATIVE_OCT = None  # (enc, dec) ctypes functions, or 0 when unavailable


def _native_octree():
    """ctypes handles to cwipc_enc_octree/cwipc_dec_octree (native shim);
    None when the shim cannot load or CWIPC_CODEC_NATIVE=0."""
    global _NATIVE_OCT
    if _NATIVE_OCT is not None:
        return _NATIVE_OCT or None
    if os.environ.get("CWIPC_CODEC_NATIVE", "") in ("0", "false"):
        _NATIVE_OCT = 0
        return None
    try:
        import ctypes

        from ..util import cwipc_util_dll_load

        dll = cwipc_util_dll_load()
        enc = dll.cwipc_enc_octree
        enc.restype = ctypes.c_int
        enc.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p]
        dec = dll.cwipc_dec_octree
        dec.restype = ctypes.c_int
        dec.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_int]
        _NATIVE_OCT = (enc, dec)
        return _NATIVE_OCT
    except Exception:
        _NATIVE_OCT = 0
        return None


_NATIVE_DECG = None


def _native_dec_geometry():
    """ctypes handle to cwipc_dec_geometry (fused native decode tail);
    None when the shim cannot load or CWIPC_CODEC_NATIVE=0."""
    global _NATIVE_DECG
    if _NATIVE_DECG is not None:
        return _NATIVE_DECG or None
    if os.environ.get("CWIPC_CODEC_NATIVE", "") in ("0", "false"):
        _NATIVE_DECG = 0
        return None
    try:
        import ctypes

        from ..util import cwipc_util_dll_load

        fn = cwipc_util_dll_load().cwipc_dec_geometry
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        _NATIVE_DECG = fn
        return fn
    except Exception:
        _NATIVE_DECG = 0
        return None


def _octree_pack(keys: np.ndarray, depth: int) -> np.ndarray:
    """Occupancy-byte stream (root-first) for sorted unique Morton keys.

    Level L holds one byte per occupied node: the 8-bit mask of occupied
    children.  Total size ~ N/7 bytes before deflate — the structure the
    reference's MPEG-anchor codec exploits, rebuilt here on the
    already-Morton-sorted voxel stream (children of one node are
    consecutive, so the masks are a bitwise_or.reduceat away).  The
    native shim runs the same construction as one C pass when available
    (bit-identical stream; pinned by tests/test_native.py)."""
    nat = _native_octree()
    if nat is not None and len(keys) and depth <= 15:
        import ctypes

        k64 = np.ascontiguousarray(keys, np.int64)
        out = np.empty(len(keys) * depth + depth, np.uint8)
        total = nat[0](
            k64.ctypes.data_as(ctypes.c_void_p), len(k64), depth,
            out.ctypes.data_as(ctypes.c_void_p),
        )
        if total >= 0:
            return out[:total]
    levels = []
    cur = keys.astype(np.int64)
    for _ in range(depth):
        parents = cur >> 3
        child_bit = np.left_shift(np.uint8(1), (cur & 7).astype(np.uint8))
        newp = np.empty(len(cur), bool)
        newp[0] = True
        np.not_equal(parents[1:], parents[:-1], out=newp[1:])
        starts = np.nonzero(newp)[0]
        levels.append(np.bitwise_or.reduceat(child_bit, starts))
        cur = parents[starts]
    levels.reverse()
    return np.concatenate(levels)


# Per-byte expansion tables for _octree_unpack: for every occupancy mask
# value, the count of set bits and the set-bit indices packed as nibbles
# (ascending).  Turns the per-level child expansion into three vectorized
# passes (repeat + rank + shift) with no unpackbits/nonzero.
_OCC_COUNT = np.array([bin(m).count("1") for m in range(256)], np.int64)
_OCC_PACK = np.array(
    [
        sum(b << (4 * i) for i, b in enumerate(j for j in range(8) if m >> j & 1))
        for m in range(256)
    ],
    np.int64,
)


def _octree_unpack(stream: np.ndarray, depth: int, n: int) -> np.ndarray:
    """Inverse of _octree_pack: sorted unique keys from the byte stream."""
    nat = _native_octree()
    if nat is not None and depth <= 15 and n > 0:
        import ctypes

        sarr = np.ascontiguousarray(stream, np.uint8)
        keys = np.empty(n, np.int64)
        got = nat[1](
            sarr.ctypes.data_as(ctypes.c_void_p), len(sarr), depth,
            keys.ctypes.data_as(ctypes.c_void_p), n,
        )
        if got == n:
            return keys
        raise CwipcError("cwipc_decoder: inconsistent octree stream")
    cur = np.zeros(1, np.int64)
    pos = 0
    for level in range(depth):
        nn = len(cur)
        if pos + nn > len(stream):
            raise CwipcError("cwipc_decoder: truncated octree stream")
        masks = stream[pos : pos + nn]
        pos += nn
        counts = _OCC_COUNT[masks]
        total = int(counts.sum())
        # rank of each child within its node: position minus its node's start
        starts = np.repeat(np.cumsum(counts) - counts, counts)
        rank = np.arange(total, dtype=np.int64) - starts
        if level <= 9:
            # parent keys fit above the 32-bit nibble pack (parents have
            # <= 3*level+3 <= 30 bits here): ONE repeat carries both
            combo = np.repeat((cur << 35) | _OCC_PACK[masks], counts)
            child = (combo >> (rank << 2)) & 7
            cur = (combo >> 32) | child
        else:  # deep wide-key levels: parents would overflow the combo
            parent_rep = np.repeat(cur << 3, counts)
            pack_rep = np.repeat(_OCC_PACK[masks], counts)
            child = (pack_rep >> (rank << 2)) & 7
            cur = parent_rep | child
    if pos != len(stream) or len(cur) != n:
        raise CwipcError("cwipc_decoder: inconsistent octree stream")
    return cur


def _jpeg_pack(rgb: np.ndarray, quality: int) -> Optional[bytes]:
    """Colors as a JPEG plane in Morton order (spatially local, so JPEG's
    DCT blocks see smooth gradients — the reference's anchor codec also
    carries colors as JPEG).  Returns None when cv2 is unavailable."""
    try:
        import cv2
    except ImportError:
        return None
    m = rgb.shape[0]
    w = max(16, int(np.ceil(np.sqrt(m) / 16.0)) * 16)
    h = (m + w - 1) // w
    img = np.zeros((h * w, 3), np.uint8)
    img[:m] = rgb[:, ::-1]  # cv2 is BGR
    img[m:] = rgb[-1, ::-1] if m else 0  # edge-pad: compresses to nothing
    ok, blob = cv2.imencode(
        ".jpg", img.reshape(h, w, 3), [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)]
    )
    return blob.tobytes() if ok else None


def _jpeg_unpack_bgr(blob: bytes, n: int) -> np.ndarray:
    """Decode the JPEG color plane to a CONTIGUOUS [n, 3] BGR array (the
    native decode tail swaps channels itself)."""
    try:
        import cv2
    except ImportError as e:
        raise CwipcError("cwipc_decoder: JPEG colors need cv2") from e
    img = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise CwipcError("cwipc_decoder: corrupt JPEG color plane")
    bgr = img.reshape(-1, 3)
    if bgr.shape[0] < n:
        raise CwipcError("cwipc_decoder: JPEG color plane too small")
    return bgr[:n]


def _jpeg_unpack(blob: bytes, n: int) -> np.ndarray:
    # a (negative-strided) view: consumers read per-column, so the
    # BGR->RGB materialization copy is pure waste
    return _jpeg_unpack_bgr(blob, n)[:, ::-1]


def _spread1by4_64(x: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of int64 x with two zero bits between each."""
    x = x.astype(np.int64) & 0x1FFFFF
    x = (x | (x << 32)) & 0x1F00000000FFFF
    x = (x | (x << 16)) & 0x1F0000FF0000FF
    x = (x | (x << 8)) & 0x100F00F00F00F00F
    x = (x | (x << 4)) & 0x10C30C30C30C30C3
    x = (x | (x << 2)) & 0x1249249249249249
    return x


def _compact1by4_64(x: np.ndarray) -> np.ndarray:
    """Inverse of _spread1by4_64."""
    x = x.astype(np.int64) & 0x1249249249249249
    x = (x | (x >> 2)) & 0x10C30C30C30C30C3
    x = (x | (x >> 4)) & 0x100F00F00F00F00F
    x = (x | (x >> 8)) & 0x1F0000FF0000FF
    x = (x | (x >> 16)) & 0x1F00000000FFFF
    x = (x | (x >> 32)) & 0x1FFFFF
    return x


def _spread1by2_np(x: np.ndarray) -> np.ndarray:
    """Forward Morton bit-spread for 10-bit cell coordinates (host)."""
    x = x.astype(np.uint32)
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


# 10-bit spread as a table lookup: one gather replaces the 8-op shift
# chain per axis in the encoder hot path (measured ~2x on key build)
_SPREAD_TAB = _spread1by2_np(np.arange(1024, dtype=np.uint32))


def _use_host_geometry() -> bool:
    """The geometry stage runs on the host when the jax backend is CPU:
    the fused XLA program measured ~88 ms/160k points on one host core vs
    ~30 ms for the numpy formulation (argsort + reduceat), and there is no
    accelerator to keep busy.  CWIPC_CODEC_HOST=0/1 forces either path."""
    forced = os.environ.get("CWIPC_CODEC_HOST")
    if forced is not None:
        return forced not in ("0", "false", "")
    import jax

    return jax.default_backend() == "cpu"


_NATIVE_GEO = None  # 0 = unavailable/disabled, else the ctypes function


def _native_geometry():
    """ctypes handle to the C geometry stage (cwipc_enc_geometry in the
    native shim): the same arithmetic as the numpy twin in one pass +
    radix sort, measured ~4x faster on this one-core host.  Returns None
    when the shim cannot be built or CWIPC_CODEC_NATIVE=0."""
    global _NATIVE_GEO
    if _NATIVE_GEO is not None:
        return _NATIVE_GEO or None
    if os.environ.get("CWIPC_CODEC_NATIVE", "") in ("0", "false"):
        _NATIVE_GEO = 0
        return None
    try:
        import ctypes

        from ..util import cwipc_util_dll_load

        dll = cwipc_util_dll_load()
        fn = dll.cwipc_enc_geometry
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ]
        _NATIVE_GEO = fn
        return fn
    except Exception:
        _NATIVE_GEO = 0
        return None


def _geometry_host(pc: cwipc_pointcloud_wrapper, *, octree_bits: int,
                   exp_factor: float, voxelsize: float, tilemask: int):
    """Host (numpy) twin of _encode_device_impl for octree_bits <= 10:
    same f32 bbox/step arithmetic, same cell quantization and clamping,
    PCL-truncated mean colors, OR'd tiles.  Returns
    (m, sorted_unique_keys int64, drgba uint32, step, vmin) — m == 0 for
    an empty (post-tilefilter) cloud."""
    arr = pc._numpy()  # the wrapper's host cache; read-only here
    fn = _native_geometry() if octree_bits <= 10 else None
    if fn is not None:
        import ctypes

        carr = np.ascontiguousarray(arr)
        n_all = carr.shape[0]
        keys = np.empty(max(n_all, 1), np.int64)
        drgba = np.empty(max(n_all, 1), np.uint32)
        vmin = np.zeros(3, np.int32)
        step_c = ctypes.c_float(0.0)
        m = fn(
            carr.ctypes.data_as(ctypes.c_void_p), n_all,
            ctypes.c_uint32(tilemask), octree_bits,
            ctypes.c_float(max(exp_factor, 1.0)), ctypes.c_float(voxelsize),
            keys.ctypes.data_as(ctypes.c_void_p),
            drgba.ctypes.data_as(ctypes.c_void_p),
            vmin.ctypes.data_as(ctypes.c_void_p), ctypes.byref(step_c),
        )
        if m >= 0:
            if m == 0:
                return 0, None, None, 0.0, np.zeros(3, np.int32)
            return m, keys[:m], drgba[:m], float(step_c.value), vmin
        # m < 0: invalid args — fall through to the numpy twin
    if tilemask:
        arr = arr[(arr["tile"].astype(np.uint32) & np.uint32(tilemask)) != 0]
    n = arr.shape[0]
    zero3 = np.zeros(3, np.int32)
    if n == 0:
        return 0, None, None, 0.0, zero3
    # contiguous per-axis copies: every op below then runs at SIMD rates
    # instead of the structured array's 16-byte stride (measured ~1.5x on
    # the whole geometry stage)
    axes = [np.ascontiguousarray(arr[f]) for f in ("x", "y", "z")]
    extent = np.maximum(
        np.float32(max(np.float32(a.max()) - np.float32(a.min()) for a in axes))
        * np.float32(max(exp_factor, 1.0)),
        np.float32(1e-6),
    )
    step = extent / np.float32(1 << octree_bits)
    if voxelsize > 0:
        step = np.maximum(step, np.float32(voxelsize))
    cap = (1 << min(octree_bits, 10)) - 1
    vmin = np.empty(3, np.int32)
    key = np.zeros(n, np.uint32)
    for axis, a in enumerate(axes):
        # NOT np.floor_divide: it measured 5.3 ms/axis vs 0.16 for
        # floor(a/step) (floor_divide's fmod-consistency machinery)
        v = np.floor(a / step).astype(np.int32)
        vmin[axis] = v.min()
        key |= _SPREAD_TAB[np.clip(v - vmin[axis], 0, cap)] << np.uint32(axis)
    # pack (key, index) into one int64 and radix-sort it: measured faster
    # than argsort's index indirection, and the sorted keys fall out
    k64 = (key.astype(np.int64) << 32) | np.arange(n, dtype=np.int64)
    k64.sort()
    order = (k64 & 0xFFFFFFFF).astype(np.int64)
    ks = (k64 >> 32).astype(np.uint32)
    starts = np.flatnonzero(np.concatenate(([True], ks[1:] != ks[:-1])))
    counts_i = np.diff(np.append(starts, n))
    counts = counts_i.astype(np.float32)
    m = len(starts)
    # Per-voxel color sums via ONE wraparound int64 cumsum of the packed
    # (r<<42 | g<<21 | b) word: run sums are differences of the inclusive
    # cumsum (exact under int64 wraparound), and fields cannot carry into
    # each other while a run's channel sums stay < 2^21 — guaranteed for
    # voxel occupancy <= 8191, the overwhelming case (degenerate clouds
    # fall back to per-channel sums).  Replaces three f32 add.reduceat
    # passes (measured 6.0 -> ~1 ms on a 160k cloud).  Channel sums of
    # <= 255*count integers are exact in both forms, so results are
    # bit-identical to the previous float accumulation for any sane
    # occupancy.
    ends = np.append(starts[1:], n) - 1
    tile_s = np.ascontiguousarray(arr["tile"])[order]
    # Per-voxel channel sums as differences of an int32 inclusive cumsum
    # (exact: channel sums <= 255*n < 2^31 for n < 8.4M; wraparound
    # differences stay exact beyond that anyway).  Replaces three f32
    # add.reduceat passes (measured ~1.6x on the whole geometry stage).
    chans = []
    for f in ("r", "g", "b"):
        cf = np.ascontiguousarray(arr[f])[order].astype(np.int32)
        cs = np.cumsum(cf, dtype=np.int32)
        srun = cs[ends] - cs[starts] + cf[starts]
        chans.append((srun.astype(np.float32) / counts).astype(np.uint32))
    mr, mg, mb = chans
    tile_or = np.bitwise_or.reduceat(tile_s, starts).astype(np.uint32)
    drgba = (tile_or << 24) | (mr << 16) | (mg << 8) | mb
    return m, ks[starts].astype(np.int64), drgba, float(step), vmin


_ENCODE_DEVICE = None


def _encode_device(xyz, rgba, count, *, octree_bits, exp_factor, voxelsize, tilemask):
    """Lazily-jitted wrapper (keeps the decoder importable without touching
    JAX; jax.jit caches per static-arg combination)."""
    global _ENCODE_DEVICE
    if _ENCODE_DEVICE is None:
        import jax

        _ENCODE_DEVICE = jax.jit(
            _encode_device_impl,
            static_argnames=("octree_bits", "exp_factor", "voxelsize", "tilemask"),
        )
    return _ENCODE_DEVICE(
        xyz, rgba, count, octree_bits=octree_bits, exp_factor=exp_factor,
        voxelsize=voxelsize, tilemask=tilemask,
    )


def _encode_device_impl(xyz, rgba, count, *, octree_bits, exp_factor, voxelsize, tilemask):
    """The whole geometry stage as ONE device program (one dispatch, one
    readback): bounding box -> quantization step -> voxel-merge downsample
    (emits centroids already in Morton order) -> rebased Morton keys ->
    first-order deltas.  The v1 encoder did bbox on a host copy, the
    downsample on device, then re-quantized AND re-sorted on the host —
    three host round trips plus an argsort per frame.

    The key identity that removes the host re-sort: the downsample's output
    order is by floor(xyz/step) rebased to the occupied minimum cell, and
    the minimum occupied cell survives downsampling (its centroid stays
    inside it), so recomputing floor(centroid/step) - min reproduces the
    internal keys exactly and the delta stream is non-negative by
    construction.
    """
    import jax.numpy as jnp

    from ..core.buffers import PointBuffer
    from ..ops import compaction
    from ..ops.voxelize import downsample, morton3

    buf = PointBuffer(xyz=xyz, rgba=rgba, count=count)
    if tilemask:
        tile = (rgba >> 24) & jnp.uint32(0xFF)
        keep = (tile & jnp.uint32(tilemask)) != 0
        buf = compaction.compact(buf, keep & buf.valid_mask())
    valid = buf.valid_mask()
    big = jnp.float32(3.0e38)
    lo = jnp.min(jnp.where(valid[:, None], buf.xyz, big), axis=0)
    hi = jnp.max(jnp.where(valid[:, None], buf.xyz, -big), axis=0)
    extent = jnp.maximum(jnp.max(hi - lo) * max(exp_factor, 1.0), 1e-6)
    step = extent / (1 << octree_bits)
    if voxelsize > 0:
        step = jnp.maximum(step, jnp.float32(voxelsize))

    exact = octree_bits >= 10
    down = downsample(buf, step, exact_keys=exact, merged_exact=exact)
    dvalid = down.valid_mask()
    sentinel = jnp.iinfo(jnp.int32).max
    v = jnp.floor(down.xyz / step).astype(jnp.int32)
    vmin = jnp.min(jnp.where(dvalid[:, None], v, sentinel), axis=0)
    vmin = jnp.where(vmin == sentinel, 0, vmin)
    vr = jnp.clip(v - vmin[None, :], 0, (1 << min(octree_bits, 10)) - 1)
    mkey = jnp.where(dvalid, morton3(vr[:, 0], vr[:, 1], vr[:, 2]), 0)
    deltas = jnp.concatenate([mkey[:1], jnp.diff(mkey)])
    return down.count, deltas, down.rgba, step, vmin


@dataclass
class cwipc_encoder_params:
    """Encoder parameters, field-compatible with the reference's struct
    (do_inter_frame, gop_size, exp_factor, octree_bits, jpeg_quality,
    macroblock_size, tilenumber, voxelsize)."""

    do_inter_frame: bool = False
    gop_size: int = 1
    exp_factor: float = 1.0
    octree_bits: int = 9
    jpeg_quality: int = 85
    macroblock_size: int = 16
    tilenumber: int = 0
    voxelsize: float = 0.0


def _compact1by2(x: np.ndarray) -> np.ndarray:
    """Inverse of the Morton bit-spread: extract every third bit."""
    x = x & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    x = (x | (x >> 16)) & 0x000003FF
    return x


_MORTON_TABLE: Optional[np.ndarray] = None


def _morton_to_cells(morton: np.ndarray) -> tuple:
    """All three cell coordinates of 30-bit Morton codes via a 15-bit
    half-code table: 2 gathers + a shift/or per point instead of the
    ~15 mask/shift passes of 3x _compact1by2 (measured 11 -> ~3 ms for
    228k points — the decoder's largest host stage)."""
    global _MORTON_TABLE
    if _MORTON_TABLE is None:
        h = np.arange(1 << 15, dtype=np.uint32)
        # packed (x5 | y5 << 10 | z5 << 20) per 15-bit half
        tx = _compact1by2(h)
        ty = _compact1by2(h >> 1)
        tz = _compact1by2(h >> 2)
        _MORTON_TABLE = tx | (ty << 10) | (tz << 20)
    m = morton.astype(np.uint32)
    packed = _MORTON_TABLE[m & 0x7FFF] | (_MORTON_TABLE[(m >> 15) & 0x7FFF] << 5)
    return packed & 0x3FF, (packed >> 10) & 0x3FF, (packed >> 20) & 0x3FF


class cwipc_encoder_wrapper:
    """Single-quality encoder; feed() compresses one cloud per call."""

    def __init__(self, params: Optional[cwipc_encoder_params] = None, **kw):
        if params is None:
            params = cwipc_encoder_params(**kw)
        self.params = params
        self._result: Optional[bytes] = None
        # zlib level from jpeg_quality: high quality -> more effort
        # Deflate level: measured on 140k-point frames, level 9 costs
        # ~185 ms on the delta stream for ~4% better ratio than level 1
        # (16 ms).  Speed is the product requirement; very high
        # jpeg_quality values opt into the denser setting.
        self._zlevel = 1 if params.jpeg_quality <= 90 else 6

    def free(self, *, force: bool = False) -> None:
        self._result = None

    def feed(self, pc: cwipc_pointcloud_wrapper) -> None:
        p = self.params
        if p.octree_bits > 10:
            # beyond the 30-bit Morton domain: correct 45-bit host path
            # (the v1 encoder silently aliased coordinates above 1024 cells)
            self._feed_wide(pc)
            return

        if _use_host_geometry():
            # CPU backend: the numpy twin beats the XLA program ~3x on one
            # host core (and there is no chip to keep the data on)
            m, keys, drgba, step, vmin = _geometry_host(
                pc, octree_bits=p.octree_bits,
                exp_factor=float(max(p.exp_factor, 1.0)),
                voxelsize=float(p.voxelsize), tilemask=int(p.tilenumber),
            )
            if m == 0:
                self._result = struct.pack(
                    _HDR_FMT, MAGIC, p.octree_bits, 0, 0, 0, pc.timestamp(),
                    pc.cellsize(), 0.0, 0.0, 0.0, 0, 0, 0,
                )
                return
            origin = vmin.astype(np.float64) * step
            self._result = self._pack(
                p, m, pc.timestamp(), step, origin, None, drgba, wide=False,
                keys=keys,
            )
            return

        # The whole geometry stage is one fused device program followed by
        # ONE readback (v1 paid three host round trips per frame).
        import jax

        buf = pc._access_buffer()
        m_dev, deltas_all, drgba_all, step_dev, vmin_dev = jax.device_get(
            _encode_device(
                buf.xyz, buf.rgba, buf.count,
                octree_bits=p.octree_bits,
                exp_factor=float(max(p.exp_factor, 1.0)),
                voxelsize=float(p.voxelsize),
                tilemask=int(p.tilenumber),
            )
        )
        m = int(m_dev)
        step = float(step_dev)
        origin = vmin_dev.astype(np.float64) * step
        if m == 0:
            self._result = struct.pack(
                _HDR_FMT, MAGIC, p.octree_bits, 0, 0, 0, pc.timestamp(),
                pc.cellsize(), 0.0, 0.0, 0.0, 0, 0, 0,
            )
            return
        deltas = deltas_all[:m].astype(np.uint32)
        drgba = drgba_all[:m]
        self._result = self._pack(
            p, m, pc.timestamp(), step, origin, deltas, drgba, wide=False
        )

    def _feed_wide(self, pc: cwipc_pointcloud_wrapper) -> None:
        """octree_bits in (10, 15]: 45-bit Morton on the host (int64)."""
        p = self.params
        if p.tilenumber != 0:
            from ..registration.util import cwipc_tilefilter_masked

            pc = cwipc_tilefilter_masked(pc, p.tilenumber)
        arr = pc.get_numpy_array()
        n = arr.shape[0]
        if n == 0:
            self._result = struct.pack(
                _HDR_FMT, MAGIC, p.octree_bits, 0, 0, 0, pc.timestamp(),
                pc.cellsize(), 0.0, 0.0, 0.0, 0, 0, 0,
            )
            return
        xyz = np.stack([arr["x"], arr["y"], arr["z"]], axis=-1).astype(np.float64)
        lo = xyz.min(axis=0)
        extent = max(float((xyz.max(axis=0) - lo).max()) * max(p.exp_factor, 1.0), 1e-6)
        step = extent / (1 << p.octree_bits)
        if p.voxelsize > 0:
            step = max(step, p.voxelsize)
        coords = np.clip(
            np.floor((xyz - lo[None, :]) / step).astype(np.int64),
            0, (1 << p.octree_bits) - 1,
        )
        morton = (
            (_spread1by4_64(coords[:, 2]) << 2)
            | (_spread1by4_64(coords[:, 1]) << 1)
            | _spread1by4_64(coords[:, 0])
        )
        # merge duplicate voxels: mean color, OR'd tiles
        order = np.argsort(morton, kind="stable")
        morton = morton[order]
        rgba = (
            (arr["tile"].astype(np.uint32) << 24)
            | (arr["r"].astype(np.uint32) << 16)
            | (arr["g"].astype(np.uint32) << 8)
            | arr["b"].astype(np.uint32)
        )[order]
        new = np.empty(n, bool)
        new[0] = True
        np.not_equal(morton[1:], morton[:-1], out=new[1:])
        seg = np.cumsum(new) - 1
        m = int(seg[-1]) + 1
        counts = np.bincount(seg, minlength=m)
        mr = np.bincount(seg, ((rgba >> 16) & 0xFF).astype(np.float64), m) / counts
        mg = np.bincount(seg, ((rgba >> 8) & 0xFF).astype(np.float64), m) / counts
        mb = np.bincount(seg, (rgba & 0xFF).astype(np.float64), m) / counts
        tile_or = np.zeros(m, np.uint32)
        np.bitwise_or.at(tile_or, seg, (rgba >> 24) & 0xFF)
        drgba = (
            (tile_or << 24)
            | (mr.astype(np.uint32) << 16)
            | (mg.astype(np.uint32) << 8)
            | mb.astype(np.uint32)
        )
        ukeys = morton[new]
        self._result = self._pack(
            p, m, pc.timestamp(), step, lo, None, drgba, wide=True, keys=ukeys
        )

    def _pack(self, p, m, timestamp, step, origin, deltas, drgba, *, wide,
              keys=None):
        """Entropy stage: octree occupancy-byte geometry + JPEG color
        plane + zlib tile bytes (each with a lossless fallback).

        Callers holding the sorted keys pass them via ``keys`` (deltas
        then unused); delta-only callers (the device readback) pass
        ``deltas`` and the keys are rebuilt by cumsum."""
        flags = _FLAG_WIDE_KEYS if wide else 0

        # geometry: the sorted keys pack into the octree occupancy
        # stream (~N/7 bytes pre-deflate vs ~N delta bytes).
        if keys is not None:
            keys = keys.astype(np.int64, copy=False)
            depth = int(p.octree_bits) if wide else min(int(p.octree_bits), 10)
        elif wide:
            keys = np.cumsum(deltas.astype(np.int64), dtype=np.int64)
            depth = int(p.octree_bits)
        else:
            keys = np.cumsum(deltas.astype(np.uint32), dtype=np.uint32).astype(np.int64)
            depth = min(int(p.octree_bits), 10)
        # Make the stream strictly sorted-unique: fp roundoff in deriving
        # cell coords from centroids can produce a locally non-monotone
        # key, and far-edge clamping can merge boundary voxels into
        # duplicates.  (The legacy delta format survived both via uint32
        # wraparound; the octree stream is defined on sorted-unique keys.)
        # O(m) fast path: group/wide feeds arrive already sorted-unique, so
        # skip the O(m log m) np.unique re-sort unless monotonicity fails
        if m > 1 and not bool(np.all(np.diff(keys) > 0)):
            uniq, first = np.unique(keys, return_index=True)
            keys = uniq
            drgba = drgba[first]
            m = len(uniq)
        occ = _octree_pack(keys, depth)
        pos_octree = zlib.compress(occ.tobytes(), self._zlevel)
        # adaptive-width delta fallback: only worth COMPUTING for tiny
        # clouds (above ~2k voxels the occupancy stream wins by many x,
        # and deflating the delta stream too costs real encode time)
        pos_blob = pos_octree
        flags |= _FLAG_OCTREE
        if m < 2048:
            deltas = np.diff(keys, prepend=np.int64(0))
            dmax = int(deltas.max()) if m else 0
            if dmax < 0x100:
                width, darr = 1, deltas.astype(np.uint8)
            elif dmax < 0x10000:
                width, darr = 2, deltas.astype(np.uint16)
            elif dmax < 2**32:
                width, darr = 0, deltas.astype(np.uint32)
            else:
                width, darr = 3, deltas.astype(np.uint64)
            pos_delta = zlib.compress(darr.tobytes(), self._zlevel)
            if len(pos_delta) < len(pos_octree):
                flags = (flags & ~_FLAG_OCTREE) | width
                pos_blob = pos_delta

        rgb = np.empty((m, 3), np.uint8)
        rgb[:, 0] = (drgba >> 16) & 0xFF
        rgb[:, 1] = (drgba >> 8) & 0xFF
        rgb[:, 2] = drgba & 0xFF
        col_jpeg = _jpeg_pack(rgb, p.jpeg_quality) if p.jpeg_quality < 100 else None
        if col_jpeg is not None and len(col_jpeg) < 3 * m // 2:
            # clearly winning: skip deflating the raw bytes entirely
            flags |= _FLAG_JPEG
            col_blob = col_jpeg
        else:
            col_zlib = zlib.compress(rgb.tobytes(), self._zlevel)
            if col_jpeg is not None and len(col_jpeg) < len(col_zlib):
                flags |= _FLAG_JPEG
                col_blob = col_jpeg
            else:
                col_blob = col_zlib

        tiles = ((drgba >> 24) & 0xFF).astype(np.uint8)
        tile_blob = zlib.compress(tiles.tobytes(), self._zlevel)
        hdr = struct.pack(
            _HDR_FMT, MAGIC, p.octree_bits, flags, 0, m, timestamp,
            float(step), float(origin[0]), float(origin[1]), float(origin[2]),
            len(pos_blob), len(col_blob), len(tile_blob),
        )
        return hdr + pos_blob + col_blob + tile_blob

    def available(self, wait: bool = False) -> bool:
        return self._result is not None

    def get_encoded_size(self) -> int:
        return len(self._result) if self._result else 0

    def get_bytes(self) -> bytes:
        if self._result is None:
            raise CwipcError("cwipc_encoder: no encoded data available")
        rv = self._result
        self._result = None
        return rv

    def at_gop_boundary(self) -> bool:
        return True


class cwipc_encodergroup_wrapper:
    """Fan-out: one feed() compresses the cloud with every added encoder."""

    def __init__(self) -> None:
        self._encoders: List[cwipc_encoder_wrapper] = []

    def addencoder(self, version: int = 1, params: Optional[cwipc_encoder_params] = None, **kw) -> cwipc_encoder_wrapper:
        enc = cwipc_encoder_wrapper(params=params, **kw)
        self._encoders.append(enc)
        return enc

    def feed(self, pc: cwipc_pointcloud_wrapper) -> None:
        # Shared-core multi-quality encode: group members that differ
        # only in octree depth / jpeg quality share ONE device geometry
        # pass at the deepest level, and every coarser level is derived
        # on the host — morton(x >> d) == morton(x) >> 3d, so ancestor
        # keys are a shift away, colors become unweighted child means
        # and tiles OR together.  Derived streams decode to the same
        # cell-center positions a direct encode would produce on the
        # deep grid's origin (quantization error is identically bounded
        # by half the coarse voxel).  A 4-quality DASH/TCP server thus
        # pays one device dispatch per frame instead of four.  (The
        # reference's group runs N independent MPEG encoders; this is
        # the device equivalent, and CTC1 is already documented as
        # not anchor-bit-compatible.)
        groups: dict = {}
        for enc in self._encoders:
            p = enc.params
            if 0 < p.octree_bits <= 10 and p.voxelsize <= 0:
                key = (int(p.tilenumber), float(max(p.exp_factor, 1.0)))
                groups.setdefault(key, []).append(enc)
            else:
                enc.feed(pc)  # wide / voxelsize-bound: independent path
        for (tilemask, expf), encs in groups.items():
            if len(encs) == 1:
                encs[0].feed(pc)
            else:
                self._feed_group(pc, encs, tilemask, expf)

    def _feed_group(self, pc, encs, tilemask: int, expf: float) -> None:
        ob_max = max(e.params.octree_bits for e in encs)
        ts = pc.timestamp()
        host = _use_host_geometry()
        if host:
            # same host/device split as the solo encoder, so the group's
            # deepest member stays bit-identical to a solo encode on
            # either backend
            m, keys, drgba, step, _vmin = _geometry_host(
                pc, octree_bits=ob_max, exp_factor=expf, voxelsize=0.0,
                tilemask=tilemask,
            )
            origin = _vmin.astype(np.float64) * step if m else np.zeros(3)
        else:
            import jax

            buf = pc._access_buffer()
            m_dev, deltas_all, drgba_all, step_dev, vmin_dev = jax.device_get(
                _encode_device(
                    buf.xyz, buf.rgba, buf.count, octree_bits=ob_max,
                    exp_factor=expf, voxelsize=0.0, tilemask=tilemask,
                )
            )
            m = int(m_dev)
            step = float(step_dev)
            origin = vmin_dev.astype(np.float64) * step
        if m == 0:
            for e in encs:
                e._result = struct.pack(
                    _HDR_FMT, MAGIC, e.params.octree_bits, 0, 0, 0, ts,
                    pc.cellsize(), 0.0, 0.0, 0.0, 0, 0, 0,
                )
            return
        if not host:
            # sorted-unique fine keys (same cleanup _pack applies); the
            # host path is sorted-unique by construction
            keys = np.cumsum(
                deltas_all[:m].astype(np.uint32), dtype=np.uint32
            ).astype(np.int64)
            drgba = np.asarray(drgba_all[:m])
            uniq, first = np.unique(keys, return_index=True)
            if len(uniq) != m or not np.array_equal(uniq, keys):
                keys, drgba, m = uniq, drgba[first], len(uniq)
        for e in encs:
            p = e.params
            d = ob_max - p.octree_bits
            if d == 0:
                ke, rg, me = keys, drgba, m
            else:
                ck = keys >> (3 * d)  # ancestor keys, still sorted
                starts = np.flatnonzero(np.diff(ck, prepend=ck[0] - 1))
                me = len(starts)
                counts = np.diff(np.append(starts, m))
                r = np.add.reduceat((drgba >> 16) & 0xFF, starts) / counts
                g = np.add.reduceat((drgba >> 8) & 0xFF, starts) / counts
                b = np.add.reduceat(drgba & 0xFF, starts) / counts
                t = np.bitwise_or.reduceat(
                    ((drgba >> 24) & 0xFF).astype(np.uint32), starts
                )
                rg = (
                    (t.astype(np.uint32) << 24)
                    | (np.round(r).astype(np.uint32) << 16)
                    | (np.round(g).astype(np.uint32) << 8)
                    | np.round(b).astype(np.uint32)
                )
                ke = ck[starts]
            de = np.diff(ke, prepend=np.int64(0))
            e._result = e._pack(
                p, me, ts, step * (1 << d), origin, de, rg, wide=False
            )

    def close(self) -> None:
        self._encoders = []

    def free(self, *, force: bool = False) -> None:
        self.close()


class cwipc_decoder_wrapper:
    """Decoder for the CTC1 format."""

    def __init__(self) -> None:
        self._result: Optional[cwipc_pointcloud_wrapper] = None

    def free(self, *, force: bool = False) -> None:
        self._result = None

    def feed(self, data: bytes) -> None:
        if len(data) < _HDR_SIZE:
            raise CwipcError("cwipc_decoder: packet too short")
        (magic, octree_bits, flags, _res, n, timestamp, step, ox, oy, oz,
         lpos, lcol, ltile) = struct.unpack(_HDR_FMT, data[:_HDR_SIZE])
        if magic != MAGIC:
            # Loud, specific rejection of foreign bitstreams: the most
            # likely source of a non-CTC1 .cwicpc is the reference
            # ecosystem's MPEG-anchor `_cwipc_codec` plugin (encoder use:
            # reference python/cwipc/net/sink_encoder.py:147-156), whose
            # bitstream this codec deliberately does not implement (see
            # module docstring).  Name the incompatibility instead of a
            # bare "bad magic" so users know WHY their file fails.
            raise CwipcError(
                "cwipc_decoder: not a CTC1 stream (magic "
                f"{magic!r}, expected {MAGIC!r}). This framework's codec "
                "uses its own CTC1 wire format and cannot decode "
                "MPEG-anchor bitstreams produced by the reference "
                "cwipc_codec plugin; re-encode the source material with "
                "this framework's encoder (e.g. `cwipc copy in.ply "
                "out.cwicpc`)."
            )
        off = _HDR_SIZE
        if n == 0:
            # host-backed like the n>0 path: an empty frame must not force
            # JAX backend init / a device upload in an accelerator-free
            # decode pipeline
            self._result = cwipc_pointcloud_wrapper(
                None, timestamp, step, _host_points=np.zeros(0, POINT_DTYPE)
            )
            return
        pos_blob = data[off : off + lpos]; off += lpos
        col_blob = data[off : off + lcol]; off += lcol
        tile_blob = data[off : off + ltile]; off += ltile

        # fused native decode tail (octree streams): occupancy expansion,
        # Morton->cell->position arithmetic and the interleaved point-
        # record fill in ONE C pass — identical arithmetic to the numpy
        # path below (decode 10 -> ~6 ms/160k frame on this host)
        nat = _native_dec_geometry()
        if nat is not None and (flags & _FLAG_OCTREE):
            import ctypes

            try:
                occ = np.frombuffer(zlib.decompress(pos_blob), np.uint8)
                tile_raw = zlib.decompress(tile_blob)
                if flags & _FLAG_JPEG:
                    colarr = np.ascontiguousarray(_jpeg_unpack_bgr(col_blob, n))
                    is_bgr = 1
                else:
                    col_raw = zlib.decompress(col_blob)
                    if len(col_raw) != n * 3:
                        raise CwipcError(
                            "cwipc_decoder: inconsistent stream sizes")
                    colarr = np.frombuffer(col_raw, np.uint8).reshape(n, 3)
                    is_bgr = 0
            except zlib.error as e:
                raise CwipcError(f"cwipc_decoder: corrupt stream: {e}") from e
            if len(tile_raw) != n:
                raise CwipcError("cwipc_decoder: inconsistent stream sizes")
            wide = int(bool(flags & _FLAG_WIDE_KEYS))
            depth = int(octree_bits) if wide else min(int(octree_bits), 10)
            tiles = np.frombuffer(tile_raw, np.uint8)
            origin = np.array([ox, oy, oz], np.float32)
            pts = np.empty(n, POINT_DTYPE)
            got = nat(
                occ.ctypes.data_as(ctypes.c_void_p), len(occ), depth, wide,
                ctypes.c_float(step),
                origin.ctypes.data_as(ctypes.c_void_p),
                colarr.ctypes.data_as(ctypes.c_void_p), is_bgr,
                tiles.ctypes.data_as(ctypes.c_void_p),
                pts.ctypes.data_as(ctypes.c_void_p), n,
            )
            if got != n:
                raise CwipcError("cwipc_decoder: inconsistent octree stream")
            self._result = cwipc_pointcloud_wrapper(
                None, timestamp, step, _host_points=pts
            )
            return

        try:
            tile_raw = zlib.decompress(tile_blob)
            if flags & _FLAG_OCTREE:
                occ = np.frombuffer(zlib.decompress(pos_blob), np.uint8)
                depth = int(octree_bits) if flags & _FLAG_WIDE_KEYS else min(int(octree_bits), 10)
                morton = _octree_unpack(occ, depth, n)
            else:
                dtype = _WIDTH_DTYPES[flags & _FLAG_WIDTH_MASK]
                deltas = np.frombuffer(zlib.decompress(pos_blob), dtype)
                if deltas.shape[0] != n:
                    raise CwipcError("cwipc_decoder: inconsistent stream sizes")
                if flags & _FLAG_WIDE_KEYS:
                    morton = np.cumsum(deltas.astype(np.int64), dtype=np.int64)
                else:
                    morton = np.cumsum(deltas.astype(np.uint32), dtype=np.uint32)
            if flags & _FLAG_JPEG:
                rgb = _jpeg_unpack(col_blob, n)
            else:
                col_raw = zlib.decompress(col_blob)
                if len(col_raw) != n * 3:
                    raise CwipcError("cwipc_decoder: inconsistent stream sizes")
                rgb = np.frombuffer(col_raw, np.uint8).reshape(n, 3)
        except zlib.error as e:
            raise CwipcError(f"cwipc_decoder: corrupt stream: {e}") from e
        if len(tile_raw) != n:
            raise CwipcError("cwipc_decoder: inconsistent stream sizes")
        if flags & _FLAG_WIDE_KEYS:
            morton = morton.astype(np.int64)
            cx = _compact1by4_64(morton)
            cy = _compact1by4_64(morton >> 1)
            cz = _compact1by4_64(morton >> 2)
        else:
            cx, cy, cz = _morton_to_cells(morton)
        xyz = np.empty((n, 3), np.float32)
        xyz[:, 0] = cx
        xyz[:, 1] = cy
        xyz[:, 2] = cz
        xyz += 0.5
        xyz *= step
        xyz += np.array([ox, oy, oz], np.float32)

        tiles = np.frombuffer(tile_raw, np.uint8)

        # host-backed cloud: the device buffer materializes only if an
        # op needs it — a decode->view/serialize pipeline stays off the
        # accelerator entirely
        pts = np.empty(n, POINT_DTYPE)
        pts["x"] = xyz[:, 0]
        pts["y"] = xyz[:, 1]
        pts["z"] = xyz[:, 2]
        pts["r"] = rgb[:, 0]
        pts["g"] = rgb[:, 1]
        pts["b"] = rgb[:, 2]
        pts["tile"] = tiles
        self._result = cwipc_pointcloud_wrapper(
            None, timestamp, step, _count_hint=n, _host_points=pts
        )

    def available(self, wait: bool = False) -> bool:
        return self._result is not None

    def get(self) -> Optional[cwipc_pointcloud_wrapper]:
        rv = self._result
        self._result = None
        return rv


def cwipc_new_encoder(version: int = 1, params: Optional[cwipc_encoder_params] = None, **kw) -> cwipc_encoder_wrapper:
    return cwipc_encoder_wrapper(params=params, **kw)


def cwipc_new_encodergroup() -> cwipc_encodergroup_wrapper:
    return cwipc_encodergroup_wrapper()


def cwipc_new_decoder() -> cwipc_decoder_wrapper:
    return cwipc_decoder_wrapper()
