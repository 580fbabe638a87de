"""Deterministic synthetic point-cloud source, generated on-device.

Device rebuild of the reference's synthetic capturer
(reference: src/cwipc_synthetic.cpp:19-242): a rotating parametric body on a
hsteps x asteps grid with animated colors and blinking "eyes".  The point
math is pure elementwise trig, generated directly on the device via one
jitted function — no host-side point loop, no H2D copy of point data.

Behavioral parity:

* default 160,000 points (400x400 grid: hsteps = asteps = floor(sqrt(n)));
* cellsize = 2.0 / hsteps;
* tiles: z<0 -> 1, z>=0 -> 2; maxtile()==3 with the reference's static
  tileinfo table (cwipc_synthetic.cpp:145-167);
* fps gating: available(False) is False until 1000/fps ms after the last
  get(); get() sleeps until the gate opens (cwipc_synthetic.cpp:95-128);
* test hooks: "test-angle" metadata and the "test-setangle" auxiliary op
  (cwipc_synthetic.cpp:134-139, 169-179).
"""

from __future__ import annotations

import math
import struct
import time
from functools import partial
from typing import Optional, Set

import jax
import jax.numpy as jnp

from ..abstract import cwipc_activesource_abstract
from ..core.buffers import PointBuffer, bucket_capacity, pack_rgba
from ..core.errors import CwipcError
from ..core.pointcloud import cwipc_pointcloud_wrapper
from ..utils.logging import CWIPC_LOG_LEVEL_ERROR, CWIPC_LOG_LEVEL_WARNING, cwipc_log

_PI = math.pi


@partial(jax.jit, static_argnames=("hsteps", "asteps", "capacity"))
def _generate(hsteps: int, asteps: int, capacity: int, angle: jax.Array) -> PointBuffer:
    """Generate the parametric body at animation angle `angle` (seconds)."""
    angle = jnp.asarray(angle, jnp.float32)
    # height-major grid, matching the reference's loop nest order
    # (cwipc_synthetic.cpp:190-221): height index outer, angle index inner.
    hi = jax.lax.broadcasted_iota(jnp.float32, (hsteps, asteps), 0)
    ai = jax.lax.broadcasted_iota(jnp.float32, (hsteps, asteps), 1)
    height = hi * (2.0 / hsteps)
    a = ai * (2.0 * _PI / asteps)

    radius = 0.3 * jnp.power(jnp.cos(height * _PI / 3 - _PI / 6), 0.71)
    x = radius * jnp.sin(a)
    y = radius * jnp.cos(a)

    r = (1 + jnp.sin(2 * _PI * height + angle + a)) / 2
    g = (1 + jnp.sin(3 * _PI * height + angle + a)) / 2
    b = (1 + jnp.sin(4 * _PI * height + angle + a)) / 2
    rr = (r * 255.0).astype(jnp.int32)
    gg = (g * 255.0).astype(jnp.int32)
    bb = (b * 255.0).astype(jnp.int32)

    eye_band = (height > 1.7) & (height < 1.8)
    eye_arc = ((a > _PI * 0.083) & (a < _PI * 0.1667)) | (
        (a > _PI * 1.833) & (a < _PI * 1.917)
    )
    blink_open = jnp.mod(angle, _PI / 2) > 0.08
    eyes = eye_band & eye_arc & blink_open
    rr = jnp.where(eyes, 255, rr)
    gg = jnp.where(eyes, 255, gg)
    bb = jnp.where(eyes, 255, bb)

    tile = jnp.where(y < 0, 1, 2).astype(jnp.uint32)
    xyz = jnp.stack([-x, height, y], axis=-1).reshape(hsteps * asteps, 3)
    rgba = pack_rgba(rr.ravel(), gg.ravel(), bb.ravel(), tile.ravel())

    n = hsteps * asteps
    pad = capacity - n
    xyz = jnp.concatenate([xyz, jnp.zeros((pad, 3), jnp.float32)], axis=0)
    rgba = jnp.concatenate([rgba, jnp.zeros((pad,), jnp.uint32)], axis=0)
    return PointBuffer(xyz=xyz, rgba=rgba, count=jnp.asarray(n, jnp.int32))


def _use_host_generate() -> bool:
    """Generate on the host when the jax backend is CPU: the XLA-CPU
    program measured 11.6 ms/160k frame (scalarized trig) vs ~2 ms for
    the numpy twin (SIMD sin), and a host-backed cloud also skips the
    materialize-for-serialization copy in streaming pipelines.  On
    the GPU the on-device program stands (generation stays on the
    card).  CWIPC_SYNTHETIC_HOST=0/1 forces either path."""
    import os

    forced = os.environ.get("CWIPC_SYNTHETIC_HOST")
    if forced is not None:
        return forced not in ("0", "false", "")
    return jax.default_backend() == "cpu"


def _generate_host(hsteps: int, asteps: int, angle: float):
    """numpy twin of _generate returning POINT_DTYPE records directly
    (same formulas; trig values differ from XLA's in final ulps, which
    the synthetic contract — a deterministic parametric body — permits;
    separable terms are computed per-axis and broadcast)."""
    import numpy as np

    from ..core.buffers import POINT_DTYPE

    angle = np.float32(angle)
    h = (np.arange(hsteps, dtype=np.float32) * np.float32(2.0 / hsteps))[:, None]
    a = (np.arange(asteps, dtype=np.float32) * np.float32(2.0 * _PI / asteps))[None, :]
    radius = np.float32(0.3) * np.power(
        np.cos(h * np.float32(_PI / 3) - np.float32(_PI / 6)), np.float32(0.71)
    )
    sin_a, cos_a = np.sin(a), np.cos(a)
    x = radius * sin_a  # [hsteps, asteps] via broadcast
    y = radius * cos_a

    def chan(k):
        v = (1.0 + np.sin(np.float32(k * _PI) * h + angle + a)) * np.float32(0.5)
        return (v * np.float32(255.0)).astype(np.int32)

    rr, gg, bb = chan(2), chan(3), chan(4)
    eye_band = ((h > 1.7) & (h < 1.8)).astype(bool)
    eye_arc = ((a > _PI * 0.083) & (a < _PI * 0.1667)) | (
        (a > _PI * 1.833) & (a < _PI * 1.917)
    )
    blink_open = math.fmod(angle, _PI / 2) > 0.08
    eyes = eye_band & eye_arc & blink_open
    n = hsteps * asteps
    pts = np.empty(n, POINT_DTYPE)
    pts["x"] = (-x).ravel()
    pts["y"] = np.broadcast_to(h, (hsteps, asteps)).ravel()
    pts["z"] = y.ravel()
    pts["r"] = np.where(eyes, 255, rr).ravel()
    pts["g"] = np.where(eyes, 255, gg).ravel()
    pts["b"] = np.where(eyes, 255, bb).ravel()
    pts["tile"] = np.where(y < 0, 1, 2).ravel()
    return pts


_SYNTHETIC_TILEINFO = [
    {"normal": {"x": 0, "y": 0, "z": 0}, "cameraName": b"synthetic", "ncamera": 2, "cameraMask": 0},
    {"normal": {"x": 0, "y": 0, "z": 1}, "cameraName": b"synthetic-right", "ncamera": 1, "cameraMask": 1},
    {"normal": {"x": 0, "y": 0, "z": -1}, "cameraName": b"synthetic-left", "ncamera": 1, "cameraMask": 2},
]


class cwipc_source_synthetic(cwipc_activesource_abstract):
    """Active source producing the synthetic body at an optional fps cap."""

    def __init__(self, fps: int = 0, npoints: int = 0):
        if npoints == 0:
            npoints = 160000
        self._hsteps = self._asteps = int(math.sqrt(npoints))
        self._capacity = bucket_capacity(self._hsteps * self._asteps)
        self._fps = fps
        self._angle = 0.0
        self._started = False
        self._start_time: Optional[float] = None
        self._earliest_next: Optional[float] = None
        self._requested_metadata: Set[str] = set()

    # -- source protocol ---------------------------------------------------

    def free(self, *, force: bool = False) -> None:
        pass

    def start(self) -> bool:
        if self._started:
            cwipc_log(CWIPC_LOG_LEVEL_WARNING, "cwipc_synthetic", "start() called when already started")
            return True
        self._start_time = time.time()
        self._earliest_next = self._start_time
        self._started = True
        return True

    def stop(self) -> None:
        self._started = False

    def eof(self) -> bool:
        return False

    def seek(self, timestamp: int) -> bool:
        return False

    def available(self, wait: bool) -> bool:
        if not self._started:
            cwipc_log(CWIPC_LOG_LEVEL_ERROR, "cwipc_synthetic", "available() called before start()")
            return False
        if (
            not wait
            and self._fps != 0
            and self._earliest_next is not None
            and time.time() < self._earliest_next
        ):
            return False
        return True

    def get(self) -> Optional[cwipc_pointcloud_wrapper]:
        if not self._started:
            cwipc_log(CWIPC_LOG_LEVEL_ERROR, "cwipc_synthetic", "get() called before start()")
            return None
        if self._fps != 0 and self._earliest_next is not None:
            delay = self._earliest_next - time.time()
            if delay > 0:
                time.sleep(delay)
        now = time.time()
        timestamp = int(now * 1000)
        assert self._start_time is not None
        if self._fps != 0:
            # ABSOLUTE deadline ladder, like the reference's sleep_until
            # (reference: src/cwipc_synthetic.cpp:110-128): scheduling the
            # next frame relative to the wake time accumulates the sleep
            # overshoot into every period and caps delivery at ~28 of a
            # nominal 30 fps (measured round 4).  A consumer that stalls
            # more than one period resynchronizes instead of bursting.
            base = self._earliest_next if self._earliest_next is not None else now
            nxt = base + 1.0 / self._fps
            if nxt < now:
                nxt = now + 1.0 / self._fps
            self._earliest_next = nxt
        self._angle = now - self._start_time
        if _use_host_generate():
            pts = _generate_host(self._hsteps, self._asteps, self._angle)
            pc = cwipc_pointcloud_wrapper(
                None, timestamp, 2.0 / self._hsteps, _host_points=pts
            )
        else:
            buf = _generate(self._hsteps, self._asteps, self._capacity, self._angle)
            pc = cwipc_pointcloud_wrapper(
                buf, timestamp, 2.0 / self._hsteps,
                _count_hint=self._hsteps * self._asteps,
            )
        if "test-angle" in self._requested_metadata:
            pc.access_metadata()._add("test-angle", "", struct.pack("<f", self._angle))
        return pc

    # -- tiling contract ----------------------------------------------------

    def maxtile(self) -> int:
        return 3

    def get_tileinfo_dict(self, tilenum: int) -> dict:
        if 0 <= tilenum < 3:
            info = _SYNTHETIC_TILEINFO[tilenum]
            return {k: (dict(v) if isinstance(v, dict) else v) for k, v in info.items()}
        raise CwipcError(f"cwipc_synthetic: no tileinfo for tile {tilenum}")

    # -- config / metadata / aux ops -----------------------------------------

    def reload_config(self, config) -> bool:
        cwipc_log(CWIPC_LOG_LEVEL_WARNING, "cwipc_synthetic", "reload_config() not implemented (nor needed)")
        return False

    def get_config(self) -> bytes:
        raise CwipcError("cwipc_synthetic: no config available")

    def request_metadata(self, name: str) -> None:
        self._requested_metadata.add(name)

    def is_metadata_requested(self, name: str) -> bool:
        return name in self._requested_metadata

    def auxiliary_operation(self, op: str, inbuf: bytes, outbuf: bytearray) -> bool:
        if op != "test-setangle":
            return False
        if inbuf is None or len(inbuf) != 4:
            return False
        if outbuf is None or len(outbuf) != 4:
            return False
        (self._angle,) = struct.unpack("<f", inbuf)
        outbuf[:] = struct.pack("<f", self._angle)
        return True

    def statistics(self) -> None:
        pass
