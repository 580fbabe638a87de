"""The hardware-GL render path (io/gl_render.py): headless EGL context,
fixed-function GL_POINTS draw, parity with the numpy splat renderer.

Reference counterpart: the GLFW/OpenGL viewer window
(src/cwipc_window.cpp:74-134, src/window_util.cpp:61-149).  This
environment has Mesa's surfaceless EGL, so the GL pipeline runs
headless; the tests skip if EGL cannot initialize.
"""

import numpy as np
import pytest

from cwipc_util_jax.io.gl_render import gl_available, render_points_gl
from cwipc_util_jax.io.render import OrbitCamera, render_points

pytestmark = pytest.mark.skipif(not gl_available(), reason="no EGL/GL")


def _scene():
    cam = OrbitCamera(center=(0, 1, 0), distance=2.5)
    xyz = np.array(
        [[0, 1, 0], [0.3, 1.2, 0.1], [-0.2, 0.8, -0.1], [0.1, 1.1, 0.4]],
        np.float32,
    )
    rgb = np.array(
        [[255, 0, 0], [0, 255, 0], [0, 0, 255], [255, 255, 0]], np.uint8
    )
    return cam, xyz, rgb


class TestGLRenderer:
    def test_matches_software_splat(self):
        """Every point lands within a pixel of the splat renderer's
        position (half-pixel center conventions differ), same color,
        same occlusion-free point count."""
        cam, xyz, rgb = _scene()
        sw = render_points(xyz, rgb, 320, 240, cam, point_size=3)
        gl = render_points_gl(xyz, rgb, 320, 240, cam, point_size=3)
        for color in map(tuple, rgb):
            m_sw = np.argwhere((sw == color).all(-1))
            m_gl = np.argwhere((gl == color).all(-1))
            assert len(m_sw) and len(m_gl), color
            assert np.abs(m_sw.mean(0) - m_gl.mean(0)).max() <= 1.5, color

    def test_depth_occlusion(self):
        """The GL depth test hides the farther of two colinear points."""
        cam = OrbitCamera(center=(0, 1, 0), distance=2.0)
        view = cam.view_matrix()
        eye = -np.linalg.inv(view[:3, :3]) @ view[:3, 3]
        near = np.array([0, 1, 0], np.float64)
        far = near + (near - eye) * 0.5  # behind `near` along the ray
        xyz = np.array([far, near], np.float32)  # draw near LAST? order-independent
        rgb = np.array([[255, 0, 0], [0, 255, 0]], np.uint8)
        img = render_points_gl(xyz, rgb, 320, 240, cam, point_size=5)
        assert (img == (0, 255, 0)).all(-1).any()
        assert not (img == (255, 0, 0)).all(-1).any()

    def test_background_and_empty(self):
        cam, _, _ = _scene()
        img = render_points_gl(
            np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint8),
            64, 48, cam, background=(10, 20, 30),
        )
        assert img.shape == (48, 64, 3)
        assert (img == (10, 20, 30)).all()

    def test_runtime_gl_failure_degrades_to_splat(self, monkeypatch):
        """A GL failure mid-run must not kill the viewer loop: the sink
        falls back to the numpy splat permanently."""
        import cwipc_util_jax as cwipc
        from cwipc_util_jax.io import gl_render
        from cwipc_util_jax.io.visualizer_sink import cwipc_window_sink

        def boom(*a, **kw):
            raise RuntimeError("synthetic GL loss")

        monkeypatch.setattr(gl_render, "render_points_gl", boom)
        win = cwipc_window_sink("t2")
        pc = cwipc.cwipc_from_points([(0.0, 1.0, 0.0, 255, 0, 0, 1)], 0)
        assert win.feed(pc, True)
        assert win.get_image() is not None
        assert getattr(win, "_gl_broken", False)
        assert win.feed(pc, True)  # stays on the splat path

    def test_visualizer_sink_uses_gl(self):
        """The cv2-less visualizer sink renders through the GL path and
        exposes the frame via get_image()."""
        import cwipc_util_jax as cwipc
        from cwipc_util_jax.io.visualizer_sink import cwipc_window_sink

        win = cwipc_window_sink("t")  # headless: no cv2 GUI in this env
        pc = cwipc.cwipc_from_points(
            [(0.0, 1.0, 0.0, 255, 0, 0, 1), (0.1, 1.1, 0.1, 0, 255, 0, 1)], 0
        )
        assert win.feed(pc, True)
        img = win.get_image()
        assert img is not None and img.ndim == 3
        assert (img != 0).any()
