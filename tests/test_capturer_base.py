"""Capturer base-framework tests: lifecycle phases, tiling contract,
config round trip, greenscreen helper."""

import json

import numpy as np
import pytest

import cwipc_util_jax as cwipc
from cwipc_util_jax.core.buffers import POINT_DTYPE
from cwipc_util_jax.models.capturer_base import (
    CwipcBaseCamera,
    CwipcBaseCameraConfig,
    CwipcBaseCapture,
    CwipcBaseCaptureConfig,
    cwipc_capturer_impl_base,
    greenscreen_mask,
    remove_greenscreen,
    rgb_to_hsv,
)


class FakeCamera(CwipcBaseCamera):
    """A test camera producing a fixed point at its serial-indexed offset."""

    phases = []

    def __init__(self, config, index):
        super().__init__(config)
        self.index = index
        self.frames_left = 3

    def pre_start_all_cameras(self):
        FakeCamera.phases.append(("pre", self.index))

    def start_camera(self):
        FakeCamera.phases.append(("start", self.index))
        return True

    def start_camera_streaming(self):
        FakeCamera.phases.append(("stream", self.index))
        return True

    def stop_camera(self):
        pass

    def eof(self):
        return self.frames_left <= 0

    def capture_pointcloud(self):
        if self.frames_left <= 0:
            return None
        self.frames_left -= 1
        arr = np.zeros(10, POINT_DTYPE)
        arr["x"] = self.index  # camera-local coordinate
        arr["r"] = 100 + self.index
        return arr


class FakeCapture(CwipcBaseCapture):
    def create_cameras(self):
        self.cameras = [
            FakeCamera(cfg, i) for i, cfg in enumerate(self.config.cameras)
        ]


def _make_source(ncam=2):
    cfg = CwipcBaseCaptureConfig("fake")
    for i in range(ncam):
        cam = CwipcBaseCameraConfig(serial=f"cam{i}", camera_type="fake")
        cam.trafo[0, 3] = i * 10.0  # translate each camera by 10*i in x
        cfg.cameras.append(cam)
    return cwipc_capturer_impl_base(FakeCapture(cfg))


class TestLifecycle:
    def test_four_phase_start_order(self):
        FakeCamera.phases = []
        src = _make_source(2)
        assert src.start()
        # every camera completes a phase before any camera enters the next
        names = [p[0] for p in FakeCamera.phases]
        assert names == ["pre", "pre", "start", "start", "stream", "stream"]
        # first active camera is the sync master
        assert src.grabber.cameras[0].is_sync_master
        assert not src.grabber.cameras[1].is_sync_master
        src.stop()

    def test_capture_applies_trafo_and_tiles(self):
        src = _make_source(2)
        src.start()
        pc = src.get()
        assert pc is not None and pc.count() == 20
        arr = pc.get_numpy_array()
        t1 = arr[arr["tile"] == 1]
        t2 = arr[arr["tile"] == 2]
        assert t1.shape[0] == 10 and t2.shape[0] == 10
        # camera 0: x=0 + trafo 0; camera 1: x=1 + trafo 10
        assert np.allclose(t1["x"], 0.0)
        assert np.allclose(t2["x"], 11.0)
        src.stop()

    def test_eof_after_frames(self):
        src = _make_source(1)
        src.start()
        for _ in range(3):
            assert not src.eof()
            src.get()
        assert src.eof()
        src.stop()

    def test_tileinfo_contract(self):
        src = _make_source(3)
        assert src.maxtile() == 4
        assert src.get_tileinfo_dict(0)["ncamera"] == 3
        info = src.get_tileinfo_dict(2)
        assert info["cameraMask"] == 2
        assert info["cameraName"] == b"cam1"
        with pytest.raises(cwipc.CwipcError):
            src.get_tileinfo_dict(9)

    def test_config_roundtrip(self):
        src = _make_source(2)
        data = json.loads(src.get_config())
        assert data["type"] == "fake"
        assert len(data["camera"]) == 2
        data["camera"][0]["serial"] = "renamed"
        src.grabber.create_cameras()
        assert src.reload_config(json.dumps(data))
        assert src.grabber.config.cameras[0].serial == "renamed"


class TestColorHelpers:
    def test_hsv_known_values(self):
        rgb = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 255]], np.uint8)
        hsv = rgb_to_hsv(rgb)
        assert np.allclose(hsv[:, 0], [0, 120, 240, 0], atol=1e-6)
        assert np.allclose(hsv[:, 1], [1, 1, 1, 0], atol=1e-6)
        assert np.allclose(hsv[:, 2], [1, 1, 1, 1], atol=1e-6)

    def test_greenscreen_mask(self):
        rgb = np.array([[30, 200, 40], [200, 30, 40], [10, 10, 10]], np.uint8)
        mask = greenscreen_mask(rgb)
        assert mask.tolist() == [True, False, False]

    def test_remove_greenscreen(self):
        arr = np.zeros(4, POINT_DTYPE)
        arr["g"] = [200, 200, 10, 10]
        arr["r"] = [30, 30, 200, 200]
        arr["b"] = [40, 40, 10, 10]
        pc = cwipc.cwipc_from_numpy_array(arr, 0)
        out = remove_greenscreen(pc)
        assert out.count() == 2
        assert (out.get_numpy_array()["r"] == 200).all()
