"""DASH binding tests against the fake SIGNALS stub libraries.

The real SIGNALS SMD packager/player are external commercial components;
these tests build tiny loopback .so files exporting the same entry points
(cwipc_util_jax/native/fake_signals.c) and drive the full binding layer:
stream registration, push, discovery, frame pumping, quality switching and
the error paths (reference behavior: python/cwipc/net/sink_lldpkg.py,
python/cwipc/net/source_lldplay.py)."""

import pathlib
import subprocess
import time

import pytest

from cwipc_util_jax.core.errors import CwipcError

NATIVE_DIR = pathlib.Path(__file__).parent.parent / "cwipc_util_jax" / "native"


@pytest.fixture()
def fake_signals(monkeypatch):
    """Build the fake SIGNALS libs, point SIGNALS_SMD_PATH at them, and
    reset the module-level DLL caches around each test."""
    import cwipc_util_jax.net.sink_lldpkg as sink_mod
    import cwipc_util_jax.net.source_lldplay as src_mod

    build = NATIVE_DIR / "build"
    # always invoke make: it is incremental, and a stale .so (older than
    # fake_signals.c) must be rebuilt, not silently used
    rv = subprocess.run(
        ["make", "-C", str(NATIVE_DIR), "fakesignals"],
        capture_output=True, text=True,
    )
    if rv.returncode != 0 or not (build / "liblldash_packager.so").exists():
        pytest.skip(f"fake SIGNALS build failed: {rv.stderr[-500:]}")
    monkeypatch.setenv("SIGNALS_SMD_PATH", str(build))
    monkeypatch.setattr(sink_mod, "_lldpkg_dll_reference", None)
    monkeypatch.setattr(src_mod, "_lldplay_dll_reference", None)
    yield build
    sink_mod._lldpkg_dll_reference = None
    src_mod._lldplay_dll_reference = None


def test_lldpkg_requires_signals(monkeypatch, tmp_path):
    """Without SIGNALS installed the factory raises a clear CwipcError."""
    import cwipc_util_jax.net.sink_lldpkg as sink_mod

    monkeypatch.setenv("SIGNALS_SMD_PATH", str(tmp_path / "nonexistent"))
    monkeypatch.setattr(sink_mod, "_lldpkg_dll_reference", None)
    with pytest.raises(CwipcError, match="lldash_packager"):
        sink_mod.cwipc_sink_lldpkg("http://example.invalid/stream/")


def test_lldplay_requires_signals(monkeypatch, tmp_path):
    import cwipc_util_jax.net.source_lldplay as src_mod

    monkeypatch.setenv("SIGNALS_SMD_PATH", str(tmp_path / "nonexistent"))
    monkeypatch.setattr(src_mod, "_lldplay_dll_reference", None)
    with pytest.raises(CwipcError, match="lldash_play"):
        src_mod.cwipc_multisource_lldplay("http://example.invalid/stream/").start()


def test_lldpkg_push(fake_signals, tmp_path):
    """Packager sink: add_stream/start/feed write frames per stream."""
    from cwipc_util_jax.net.sink_lldpkg import cwipc_sink_lldpkg

    url = str(tmp_path / "ingest") + "/live.mpd"
    sink = cwipc_sink_lldpkg(url)
    sink.set_fourcc("cwi1")
    s0 = sink.add_stream(tilenum=1, tiledesc={"normal": {"x": 0.0, "y": 0.0, "z": 1.0}, "cameraMask": 1})
    s1 = sink.add_stream(tilenum=2, tiledesc={"normal": {"x": 0.0, "y": 0.0, "z": -1.0}, "cameraMask": 2})
    assert (s0, s1) == (0, 1)
    sink.start()
    assert sink.feed(b"frame-zero", s0)
    assert sink.feed(b"frame-one", s1)
    assert sink.feed(b"frame-two", s0)
    sink.stop()
    sink.statistics()
    ingest = tmp_path / "ingest"
    streams_txt = (ingest / "streams.txt").read_text().splitlines()
    assert streams_txt[0].strip() == "2"
    # descriptors carry the tile number and scaled normal (SRD fields)
    assert streams_txt[1].split()[1:5] == ["1", "0", "0", "1000"]
    assert streams_txt[2].split()[1:5] == ["2", "0", "0", str((-1000) & 0xFFFFFFFF)]
    # the packager named the MPD
    assert (ingest / "live.name").exists()
    assert (ingest / "s0_00000000.frame").read_bytes() == b"frame-zero"
    assert (ingest / "s0_00000001.frame").read_bytes() == b"frame-two"
    assert (ingest / "s1_00000000.frame").read_bytes() == b"frame-one"
    # feed after stop fails cleanly
    assert not sink.feed(b"late", s0)


def test_lldplay_bad_url(fake_signals, tmp_path):
    """Playing a URL nothing was published at raises."""
    from cwipc_util_jax.net.source_lldplay import cwipc_multisource_lldplay

    src = cwipc_multisource_lldplay(str(tmp_path / "nothing-here"))
    with pytest.raises(CwipcError, match="cannot play"):
        src.start()


def test_lldash_loopback_with_quality_switch(fake_signals, tmp_path):
    """Full loop: packager pushes tiled streams, player discovers them,
    pumps frames into per-tile views, and quality selection reaches the DLL."""
    from cwipc_util_jax.net.sink_lldpkg import cwipc_sink_lldpkg
    from cwipc_util_jax.net.source_lldplay import cwipc_multisource_lldplay

    url = str(tmp_path / "cdn") + "/"
    sink = cwipc_sink_lldpkg(url)
    sink.set_fourcc("cwi1")
    # 3 tiles; the middle tile has TWO qualities (two streams with the
    # same descriptor — the grouping contract, reference
    # source_lldplay.py:335-356)
    descs = {t: {"normal": {"x": 0.0, "y": 0.0, "z": float(t)}} for t in (1, 2, 3)}
    s0 = sink.add_stream(tilenum=1, tiledesc=descs[1])
    s1 = sink.add_stream(tilenum=2, tiledesc=descs[2])
    s2 = sink.add_stream(tilenum=2, tiledesc=descs[2])  # quality 1 of tile 2
    s3 = sink.add_stream(tilenum=3, tiledesc=descs[3])
    sink.start()
    payloads = {
        s0: [b"t0f0", b"t0f1", b"t0f2"],
        s1: [b"q0f0", b"q0f1", b"q0f2"],
        s2: [b"q1f0", b"q1f1", b"q1f2"],
        s3: [b"t2f0", b"t2f1", b"t2f2"],
    }
    for i, frames in payloads.items():
        for frame in frames:
            assert sink.feed(frame, i)
    sink.stop()

    src = cwipc_multisource_lldplay(url)
    assert src.start()
    # 4 streams group into 3 tiles; tile 1 advertises 2 qualities
    assert src.get_tile_count() == 3
    desc = src.get_description()
    assert [len(qualities) for qualities in desc] == [1, 2, 1]
    info = src.get_tileinfo_dict(1)
    assert info["cameraMask"] == 2 and info["nquality"] == 2
    assert info["normal"]["z"] == 2.0
    got = {i: [] for i in range(3)}
    want = {0: 3, 1: 6, 2: 3}  # tile 1 receives both qualities' frames
    deadline = time.time() + 10
    while time.time() < deadline and any(len(got[i]) < want[i] for i in got):
        for i in range(3):
            view = src.get_tile_source(i)
            if view.available(wait=False):
                data = view.get()
                if data:
                    got[i].append(data)
        time.sleep(0.01)
    src.select_tile_quality(1, 1)
    src.stop()
    src.statistics()
    assert got[0] == payloads[s0]
    assert got[2] == payloads[s3]
    assert sorted(got[1]) == sorted(payloads[s1] + payloads[s2])
    # quality switch side-effect recorded by the fake DLL
    assert (tmp_path / "cdn" / "quality_t1.txt").read_text().strip() == "1"


def test_lldplay_single_stream_view(fake_signals, tmp_path):
    """The non-tiled factory adapts tile 0 of the multisource."""
    from cwipc_util_jax.net.sink_lldpkg import cwipc_sink_lldpkg
    from cwipc_util_jax.net.source_lldplay import cwipc_source_lldplay

    url = str(tmp_path / "single") + "/"
    sink = cwipc_sink_lldpkg(url)
    sink.set_fourcc("cwi0")
    sink.add_stream(tilenum=0)
    sink.start()
    assert sink.feed(b"only-frame", 0)
    sink.stop()

    src = cwipc_source_lldplay(url)
    assert src.start()
    src.set_fourcc("cwi0")
    deadline = time.time() + 10
    data = None
    while time.time() < deadline and data is None:
        if src.available(wait=True):
            data = src.get()
    src.stop()
    assert data == b"only-frame"
    assert src.eof()


def test_cli_dash_loopback(fake_signals, tmp_path):
    """Full CLI loop over the fake SIGNALS libs: `cwipc forward --lldpkg`
    publishes encoded streams, `cwipc view --lldplay` plays them back
    (reference pipelines: cwipc_forward.py --lldash + view --lldplay)."""
    import os
    import sys

    url = str(tmp_path / "cdn")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(pathlib.Path(__file__).parent.parent)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env["SIGNALS_SMD_PATH"] = str(fake_signals)
    rv = subprocess.run(
        [sys.executable, "-m", "cwipc_util_jax", "forward", "--synthetic",
         "--npoints", "1000", "--count", "5", "--fps", "10",
         "--seg_dur", "2000", "--timeshift_buffer", "5000",
         "--lldpkg", url + "/live.mpd"],
        capture_output=True, text=True, timeout=240, env=env,
    )
    assert rv.returncode == 0, rv.stderr[-500:]
    assert (tmp_path / "cdn" / "streams.txt").exists()
    rv = subprocess.run(
        [sys.executable, "-m", "cwipc_util_jax", "view", "--lldplay", url,
         "--nodisplay", "--count", "5"],
        capture_output=True, text=True, timeout=240, env=env,
    )
    assert rv.returncode == 0, rv.stderr[-500:]


def test_cli_tiled_dash_loopback(fake_signals, tmp_path):
    """Tiled multi-quality DASH loop: `forward --tiled --lldpkg` publishes
    one stream per tile, `view --mt-lldplay` discovers, decodes and
    tile-synchronizes them (reference: _scriptsupport.py mt-lldplay path)."""
    import os
    import sys

    url = str(tmp_path / "cdn")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(pathlib.Path(__file__).parent.parent)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    env["SIGNALS_SMD_PATH"] = str(fake_signals)
    rv = subprocess.run(
        [sys.executable, "-m", "cwipc_util_jax", "forward", "--synthetic",
         "--npoints", "1000", "--count", "5", "--fps", "10", "--tiled",
         "--lldpkg", url + "/live.mpd"],
        capture_output=True, text=True, timeout=240, env=env,
    )
    assert rv.returncode == 0, rv.stderr[-500:]
    assert (tmp_path / "cdn" / "streams.txt").read_text().splitlines()[0].strip() == "2"
    rv = subprocess.run(
        [sys.executable, "-m", "cwipc_util_jax", "view",
         "--mt-lldplay", url, "--nodisplay", "--count", "2", "-v"],
        capture_output=True, text=True, timeout=240, env=env,
    )
    assert rv.returncode == 0, rv.stderr[-500:]
    assert "fused_tiles" in rv.stdout  # the synchronizer merged tile streams


def test_lldplay_negative_normal_roundtrip(fake_signals, tmp_path):
    """Back-facing tile normals survive the SRD round trip.  The sink stores
    int(component*1000) two's-complement-wrapped into the unsigned SRD field
    (reference sink_lldpkg.py:205-207); the player decodes SIGNED.  (The
    reference's unsigned decode at source_lldplay.py:322 turns z=-1.0 into
    4294966.296 — a bug deliberately not preserved.)"""
    from cwipc_util_jax.net.sink_lldpkg import cwipc_sink_lldpkg
    from cwipc_util_jax.net.source_lldplay import cwipc_multisource_lldplay

    url = str(tmp_path / "cdn-neg") + "/"
    sink = cwipc_sink_lldpkg(url)
    sink.set_fourcc("cwi1")
    sink.add_stream(tilenum=1, tiledesc={
        "normal": {"x": -0.5, "y": 0.25, "z": -1.0}, "cameraMask": 1})
    sink.start()
    assert sink.feed(b"f", 0)
    sink.stop()

    src = cwipc_multisource_lldplay(url)
    assert src.start()
    info = src.get_tileinfo_dict(0)
    src.stop()
    assert info["normal"] == {"x": -0.5, "y": 0.25, "z": -1.0}


def test_lldpkg_empty_frame_rejected(fake_signals, tmp_path):
    """A zero-length frame is inexpressible in the two-phase grab protocol
    (size 0 = "nothing pending") and would stall its stream forever in the
    player; the packager rejects it at the source."""
    from cwipc_util_jax.net.sink_lldpkg import cwipc_sink_lldpkg

    url = str(tmp_path / "cdn-empty") + "/"
    sink = cwipc_sink_lldpkg(url)
    sink.set_fourcc("cwi0")
    sink.add_stream(tilenum=0)
    sink.start()
    assert not sink.feed(b"", 0)
    assert sink.feed(b"real", 0)  # the stream is still usable afterwards
    sink.stop()
    assert (tmp_path / "cdn-empty" / "s0_00000000.frame").read_bytes() == b"real"


def test_lldplay_pump_error_surfaces_as_eof(fake_signals, tmp_path):
    """A failure in the pump thread must surface as EOF + error_condition so
    consumers wake up, instead of silently killing the daemon thread and
    leaving available(wait=True)/get() blocked forever."""
    from cwipc_util_jax.net.sink_lldpkg import cwipc_sink_lldpkg
    from cwipc_util_jax.net.source_lldplay import cwipc_multisource_lldplay

    url = str(tmp_path / "cdn-err") + "/"
    sink = cwipc_sink_lldpkg(url)
    sink.set_fourcc("cwi0")
    sink.add_stream(tilenum=0)
    sink.start()
    assert sink.feed(b"frame", 0)
    sink.stop()

    src = cwipc_multisource_lldplay(url)

    def boom():
        raise RuntimeError("synthetic pump failure")

    src._pump_inner = boom  # the thread target looks it up at call time
    assert src.start()
    deadline = time.time() + 5
    while time.time() < deadline and not src.stopped:
        time.sleep(0.01)
    assert src.stopped
    assert src.error_condition
    view = src.get_tile_source(0)
    assert view.eof()
    assert view.get() is None
    src.stop()
