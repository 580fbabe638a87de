"""Pipeline tests: codec, playback, capturer registry, network loopback,
synchronizer — the integration layer (reference test strategy SURVEY.md §4:
localhost TCP substitutes for real networks, synthetic substitutes for
cameras)."""

import os
import socket
import struct
import threading
import time

import numpy as np
import pytest

import cwipc_util_jax as cwipc
from cwipc_util_jax import codec
from cwipc_util_jax.models.capturer import cwipc_capturer
from cwipc_util_jax.models.playback import cwipc_playback


@pytest.fixture(scope="module")
def small_pc():
    gen = cwipc.cwipc_synthetic(0, 1500)
    gen.start()
    pc = gen.get()
    gen.stop()
    assert pc is not None
    return pc


class TestCodec:
    def test_roundtrip(self, small_pc):
        enc = codec.cwipc_new_encoder(params=codec.cwipc_encoder_params(octree_bits=10))
        enc.feed(small_pc)
        assert enc.available()
        data = enc.get_bytes()
        assert len(data) < small_pc.count() * 16  # actually compressed
        dec = codec.cwipc_new_decoder()
        dec.feed(data)
        assert dec.available()
        out = dec.get()
        assert out is not None
        assert out.timestamp() == small_pc.timestamp()
        # lossy: counts within the quantization-merge tolerance
        assert out.count() <= small_pc.count()
        assert out.count() > small_pc.count() * 0.9
        # geometric error bounded by the quantization step
        a = small_pc.get_numpy_matrix(onlyGeometry=True)
        b = out.get_numpy_matrix(onlyGeometry=True)
        bbox = a.max(axis=0) - a.min(axis=0)
        step = bbox.max() / (1 << 10)
        # every decoded point is within step of some original point
        d = np.sqrt(((b[:200, None, :] - a[None, :, :]) ** 2).sum(-1)).min(axis=1)
        assert (d <= step * 0.9).all()

    def test_empty_frame_decodes_host_backed(self):
        """An n==0 frame must decode to a HOST-backed cloud like the n>0
        path: an empty frame in an accelerator-free decode pipeline must
        not force a device upload (codec decoder n==0 branch)."""
        from cwipc_util_jax import cwipc_from_points

        empty = cwipc_from_points([], 777)
        enc = codec.cwipc_new_encoder(params=codec.cwipc_encoder_params(octree_bits=9))
        enc.feed(empty)
        data = enc.get_bytes()
        dec = codec.cwipc_new_decoder()
        dec.feed(data)
        out = dec.get()
        assert out is not None
        assert out.count() == 0
        assert out.timestamp() == 777
        assert out._lazy_host is not None  # never touched the device

    def test_quality_affects_size(self, small_pc):
        sizes = []
        for bits in (6, 8, 10):
            enc = codec.cwipc_new_encoder(params=codec.cwipc_encoder_params(octree_bits=bits))
            enc.feed(small_pc)
            sizes.append(len(enc.get_bytes()))
        assert sizes[0] < sizes[1] < sizes[2]

    def test_encodergroup_tiles(self, small_pc):
        group = codec.cwipc_new_encodergroup()
        enc_all = group.addencoder(params=codec.cwipc_encoder_params(tilenumber=0))
        enc_t1 = group.addencoder(params=codec.cwipc_encoder_params(tilenumber=1))
        group.feed(small_pc)
        dec = codec.cwipc_new_decoder()
        dec.feed(enc_t1.get_bytes())
        t1 = dec.get()
        dec.feed(enc_all.get_bytes())
        all_ = dec.get()
        assert 0 < t1.count() < all_.count()
        assert (t1.get_numpy_array()["tile"] == 1).all()

    def test_encodergroup_multiquality_shared_core(self, small_pc):
        """Qualities in one group share the deep geometry pass: the
        deepest member must stay bit-identical to an independent encode,
        and a derived coarse stream must decode inside the coarse
        quantization bound (ancestor voxel centers of the deep grid)."""
        group = codec.cwipc_new_encodergroup()
        e9 = group.addencoder(params=codec.cwipc_encoder_params(octree_bits=9))
        e7 = group.addencoder(params=codec.cwipc_encoder_params(octree_bits=7))
        group.feed(small_pc)
        b9, b7 = e9.get_bytes(), e7.get_bytes()
        solo = codec.cwipc_new_encoder(
            params=codec.cwipc_encoder_params(octree_bits=9)
        )
        solo.feed(small_pc)
        assert b9 == solo.get_bytes()
        assert len(b7) < len(b9)
        dec = codec.cwipc_new_decoder()
        dec.feed(b9)
        p9 = dec.get()
        dec.feed(b7)
        p7 = dec.get()
        assert 0 < p7.count() <= p9.count()
        assert p7.timestamp() == small_pc.timestamp()
        a = small_pc.get_numpy_matrix(onlyGeometry=True)
        b = p7.get_numpy_matrix(onlyGeometry=True)
        step7 = (a.max(axis=0) - a.min(axis=0)).max() / (1 << 7)
        d = np.sqrt(((b[:, None, :] - a[None, :, :]) ** 2).sum(-1)).min(axis=1)
        assert (d <= step7).all()

    def test_encodergroup_fuzz_random_quality_sets(self, small_pc):
        """Random quality/tile member sets: the deepest member of every
        (tile, exp) group stays bit-identical to a solo encode and every
        derived stream decodes within its own quantization bound."""
        rng = np.random.default_rng(11)
        a = small_pc.get_numpy_matrix(onlyGeometry=True)
        extent = (a.max(axis=0) - a.min(axis=0)).max()
        for trial in range(4):
            obs = sorted(
                rng.choice(np.arange(5, 11), size=rng.integers(2, 5), replace=False),
                reverse=True,
            )
            tile = int(rng.choice([0, 1, 2]))
            group = codec.cwipc_new_encodergroup()
            encs = [
                group.addencoder(
                    params=codec.cwipc_encoder_params(
                        octree_bits=int(ob), tilenumber=tile
                    )
                )
                for ob in obs
            ]
            group.feed(small_pc)
            blobs = [e.get_bytes() for e in encs]
            solo = codec.cwipc_new_encoder(
                params=codec.cwipc_encoder_params(
                    octree_bits=int(obs[0]), tilenumber=tile
                )
            )
            solo.feed(small_pc)
            assert blobs[0] == solo.get_bytes(), (trial, obs, tile)
            dec = codec.cwipc_new_decoder()
            for ob, blob in zip(obs, blobs):
                dec.feed(blob)
                out = dec.get()
                assert out.count() > 0, (trial, obs, tile)
                b = out.get_numpy_matrix(onlyGeometry=True)
                step = extent / (1 << int(ob))
                d = np.sqrt(
                    ((b[:100, None, :] - a[None, :, :]) ** 2).sum(-1)
                ).min(axis=1)
                assert (d <= step).all(), (trial, int(ob), tile)
                if tile:
                    assert (out.get_numpy_array()["tile"] == tile).all()

    def test_encodergroup_multiquality_tiled(self, small_pc):
        """Tiles x qualities: members group per tile; each derived
        stream keeps its tile filter."""
        group = codec.cwipc_new_encodergroup()
        encs = {
            (t, ob): group.addencoder(
                params=codec.cwipc_encoder_params(octree_bits=ob, tilenumber=t)
            )
            for t in (1, 2)
            for ob in (9, 7)
        }
        group.feed(small_pc)
        dec = codec.cwipc_new_decoder()
        for (t, ob), e in encs.items():
            dec.feed(e.get_bytes())
            out = dec.get()
            assert out.count() > 0, (t, ob)
            assert (out.get_numpy_array()["tile"] == t).all()

    def test_empty_cloud(self):
        pc = cwipc.cwipc_from_points([], 7)
        enc = codec.cwipc_new_encoder()
        enc.feed(pc)
        dec = codec.cwipc_new_decoder()
        dec.feed(enc.get_bytes())
        out = dec.get()
        assert out.count() == 0
        assert out.timestamp() == 7

    def test_wide_keys_roundtrip(self, small_pc):
        """octree_bits > 10 uses 45-bit Morton keys; geometry must hold the
        fine-step error bound (the v1 encoder aliased coordinates above
        1024 cells/axis, folding distant points together)."""
        enc = codec.cwipc_new_encoder(params=codec.cwipc_encoder_params(octree_bits=12))
        enc.feed(small_pc)
        data = enc.get_bytes()
        dec = codec.cwipc_new_decoder()
        dec.feed(data)
        out = dec.get()
        a = small_pc.get_numpy_matrix(onlyGeometry=True)
        b = out.get_numpy_matrix(onlyGeometry=True)
        step = (a.max(axis=0) - a.min(axis=0)).max() / (1 << 12)
        d = np.sqrt(((b[:200, None, :] - a[None, :, :]) ** 2).sum(-1)).min(axis=1)
        assert (d <= step).all()

    def test_encode_is_one_device_roundtrip(self, small_pc, monkeypatch):
        """The fused encode program must cost exactly ONE device readback
        per frame (the 30 fps budget: the v1 path paid three) — and the
        CPU-backend host path must cost ZERO."""
        import jax

        monkeypatch.setenv("CWIPC_CODEC_HOST", "0")  # force the device path
        enc = codec.cwipc_new_encoder(params=codec.cwipc_encoder_params(octree_bits=9))
        enc.feed(small_pc)  # warm the jit cache
        calls = []
        real = jax.device_get
        monkeypatch.setattr(jax, "device_get", lambda *a, **k: (calls.append(1), real(*a, **k))[1])
        enc.feed(small_pc)
        assert len(calls) == 1
        assert enc.get_bytes()

        monkeypatch.setenv("CWIPC_CODEC_HOST", "1")
        enc.feed(small_pc)
        assert len(calls) == 1  # no further device traffic
        assert enc.get_bytes()

    def test_host_and_device_geometry_agree(self, small_pc, monkeypatch):
        """The CPU-host geometry twin and the fused device program produce
        the same voxel set up to the documented centroid-rounding seam:
        identical counts/colors/tiles, positions within one quantization
        step (the device derives keys from voxel centroids, which can
        round across a cell boundary; the host quantizes raw points)."""
        import numpy as np

        decoded = {}
        step = None
        for mode in ("0", "1"):
            monkeypatch.setenv("CWIPC_CODEC_HOST", mode)
            enc = codec.cwipc_new_encoder(
                params=codec.cwipc_encoder_params(octree_bits=9, jpeg_quality=100)
            )
            enc.feed(small_pc)
            blob = enc.get_bytes()
            import struct as _struct

            step = _struct.unpack("<f", blob[20:24])[0]
            dec = codec.cwipc_new_decoder()
            dec.feed(blob)
            decoded[mode] = dec.get().get_numpy_array()
        a, b = decoded["0"], decoded["1"]
        assert a.shape[0] == b.shape[0]
        for f in ("x", "y", "z"):
            assert float(np.abs(a[f] - b[f]).max()) <= step * 1.0001
        for f in ("r", "g", "b", "tile"):
            assert np.array_equal(a[f], b[f])

    def test_decoder_rejects_legacy_and_new_widths(self, small_pc):
        """Adaptive delta widths round-trip at every octree_bits scale."""
        for bits in (4, 9, 12):
            enc = codec.cwipc_new_encoder(params=codec.cwipc_encoder_params(octree_bits=bits))
            enc.feed(small_pc)
            dec = codec.cwipc_new_decoder()
            dec.feed(enc.get_bytes())
            out = dec.get()
            assert out is not None and out.count() > 0


class TestPlayback:
    def _make_dir(self, tmp_path, small_pc, ext):
        for i in range(3):
            pc = small_pc.clone()
            pc._set_timestamp(1000 + i)
            fn = str(tmp_path / f"frame-{1000 + i}{ext}")
            if ext == ".ply":
                cwipc.cwipc_write(fn, pc, cwipc.CWIPC_FLAGS_BINARY)
            elif ext == ".cwipcdump":
                cwipc.cwipc_write_debugdump(fn, pc)
            else:
                enc = codec.cwipc_new_encoder()
                enc.feed(pc)
                with open(fn, "wb") as fp:
                    fp.write(enc.get_bytes())
        return str(tmp_path)

    @pytest.mark.parametrize("ext", [".ply", ".cwipcdump", ".cwicpc"])
    def test_dir_playback(self, tmp_path, small_pc, ext):
        d = self._make_dir(tmp_path, small_pc, ext)
        src = cwipc_playback(d, ext=ext, loop=False)
        assert src.start()
        count = 0
        while not src.eof():
            pc = src.get()
            assert pc is not None and pc.count() > 0
            count += 1
        assert count == 3
        src.stop()

    def test_single_file_loop(self, tmp_path, small_pc, monkeypatch):
        fn = str(tmp_path / "frame-1.ply")
        cwipc.cwipc_write(fn, small_pc)
        src = cwipc_playback([fn], loop=True)
        # the clone cache must serve frames 2..n without re-reading the file
        from cwipc_util_jax.models import playback as playback_mod

        reads = []
        orig = playback_mod._Filesource._read_file

        def counting(self, f):
            reads.append(f)
            return orig(self, f)

        monkeypatch.setattr(playback_mod._Filesource, "_read_file", counting)
        src.start()
        for _ in range(5):
            assert not src.eof()
            pc = src.get()
            assert pc is not None
        src.stop()
        assert len(reads) == 1, "single-file loop must serve the cached clone"

    def test_list_input_inpoint_outpoint(self, tmp_path, small_pc):
        """inpoint/outpoint must trim explicit FILE LISTS too (the script
        layer passes them for single-file --playback inputs)."""
        d = self._make_dir(tmp_path, small_pc, ".ply")
        import os

        files = sorted(os.path.join(d, f) for f in os.listdir(d) if f.endswith(".ply"))
        src = cwipc_playback(files, ext=".ply", inpoint=1001, outpoint=1001)
        got = []
        while not src.eof():
            got.append(src.get().timestamp())
        assert got == [1001]

    def test_retimestamp_wall_clock(self, tmp_path, small_pc):
        """--retimestamp replaces file timestamps with the wall clock
        (reference: playback.py retimestamp option; driven end-to-end as
        `cwipc view --playback DIR --retimestamp`)."""
        import time

        d = self._make_dir(tmp_path, small_pc, ".ply")
        src = cwipc_playback(d, ext=".ply", retimestamp=True)
        src.start()
        now_ms = time.time() * 1000.0
        ts = src.get().timestamp()
        src.stop()
        # file timestamps in the fixture are tiny (1000-1002); wall clock
        # is ~1.8e12 — any sane tolerance separates them
        assert abs(ts - now_ms) < 60_000

    def test_inpoint_outpoint(self, tmp_path, small_pc):
        d = self._make_dir(tmp_path, small_pc, ".ply")
        src = cwipc_playback(d, ext=".ply", inpoint=1001, outpoint=1001)
        got = []
        while not src.eof():
            got.append(src.get().timestamp())
        assert got == [1001]


class TestCapturerRegistry:
    def test_nonexistent_type(self):
        with pytest.raises(cwipc.CwipcError):
            cwipc_capturer('{"type":"nonexistent"}')

    def test_synthetic_type(self):
        src = cwipc_capturer('{"type":"synthetic", "npoints": 1000}')
        assert src.start()
        pc = src.get()
        assert pc is not None and pc.count() == 961
        src.stop()

    def test_auto_no_cameras(self):
        with pytest.raises(cwipc.CwipcError):
            cwipc_capturer("auto")

    def test_bad_json(self):
        with pytest.raises(cwipc.CwipcError):
            cwipc_capturer("{not json")


class TestNetworkLoopback:
    def _free_port(self):
        s = socket.socket()
        s.bind(("", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    def test_passthrough_tcp(self, small_pc):
        """clouds -> passthrough sink -> TCP -> netclient -> passthrough source."""
        from cwipc_util_jax.net.sink_netserver import cwipc_sink_netserver
        from cwipc_util_jax.net.sink_passthrough import cwipc_sink_passthrough
        from cwipc_util_jax.net.source_netclient import cwipc_source_netclient
        from cwipc_util_jax.net.source_passthrough import cwipc_source_passthrough

        port = self._free_port()
        rawsink = cwipc_sink_netserver(port, nodrop=True)
        sink = cwipc_sink_passthrough(rawsink, nodrop=True)

        producer_done = threading.Event()

        class FakeProducer:
            ident = 1

            def is_alive(self):
                return not producer_done.is_set()

        sink.set_producer(FakeProducer())
        sink.start()

        rawsource = cwipc_source_netclient(f"localhost:{port}")
        source = cwipc_source_passthrough(rawsource)
        source.start()
        time.sleep(0.3)

        sent = [small_pc.clone() for _ in range(3)]
        for pc in sent:
            sink.feed(pc)
        received = []
        deadline = time.time() + 20
        while len(received) < 3 and time.time() < deadline:
            if source.available(True):
                pc = source.get()
                if pc is not None:
                    received.append(pc)
        producer_done.set()
        assert len(received) == 3
        assert received[0].count() == small_pc.count()
        assert list(received[0].get_points()) == list(small_pc.get_points())
        source.stop()
        sink.stop()

    def test_encoder_tcp(self, small_pc):
        """clouds -> encoder sink -> TCP -> netclient -> decoder source."""
        from cwipc_util_jax.net.sink_encoder import cwipc_sink_encoder
        from cwipc_util_jax.net.sink_netserver import cwipc_sink_netserver
        from cwipc_util_jax.net.source_decoder import cwipc_activesource_decoder
        from cwipc_util_jax.net.source_netclient import cwipc_source_netclient

        port = self._free_port()
        rawsink = cwipc_sink_netserver(port, nodrop=True)
        sink = cwipc_sink_encoder(rawsink, nodrop=True)
        sink.set_encoder_params([{}], octree_bits=10)

        done = threading.Event()

        class FakeProducer:
            ident = 1

            def is_alive(self):
                return not done.is_set()

        sink.set_producer(FakeProducer())
        sink.start()

        rawsource = cwipc_source_netclient(f"localhost:{port}")
        source = cwipc_activesource_decoder(rawsource)
        source.start()
        time.sleep(0.3)

        for _ in range(2):
            sink.feed(small_pc.clone())
        received = []
        deadline = time.time() + 30
        while len(received) < 2 and time.time() < deadline:
            if source.available(True):
                pc = source.get()
                if pc is not None:
                    received.append(pc)
        done.set()
        assert len(received) == 2
        assert received[0].count() > small_pc.count() * 0.9
        source.stop()
        sink.stop()


class TestSynchronizer:
    def test_fuses_matching_timestamps(self, small_pc):
        from cwipc_util_jax.net.source_synchronizer import cwipc_source_synchronizer

        class ListSource:
            def __init__(self, pcs):
                self.pcs = list(pcs)

            def start(self):
                return True

            def stop(self):
                pass

            def eof(self):
                return not self.pcs

            def available(self, wait=False):
                return bool(self.pcs)

            def get(self):
                return self.pcs.pop(0) if self.pcs else None

            def statistics(self):
                pass

        def tile_pc(ts, tile):
            pc = cwipc.cwipc_tilefilter(small_pc, tile)
            pc._set_timestamp(ts)
            return pc

        s1 = ListSource([tile_pc(100, 1), tile_pc(200, 1)])
        s2 = ListSource([tile_pc(100, 2), tile_pc(200, 2)])
        sync = cwipc_source_synchronizer(None, [s1, s2])
        sync.start()
        fused = []
        deadline = time.time() + 15
        while len(fused) < 2 and time.time() < deadline:
            if sync.available(True):
                pc = sync.get()
                if pc is not None:
                    fused.append(pc)
        sync.stop()
        assert len(fused) == 2
        assert fused[0].count() == small_pc.count()
        assert fused[0].timestamp() == 100
        tiles = set(np.unique(fused[0].get_numpy_array()["tile"]))
        assert tiles == {1, 2}


class TestCodecRobustness:
    def test_corrupt_streams_raise_cwipc_error(self, small_pc):
        enc = codec.cwipc_new_encoder()
        enc.feed(small_pc)
        good = enc.get_bytes()
        for name, blob in [
            ("truncated header", good[:10]),
            ("bad magic", b"XXXX" + good[4:]),
            ("truncated payload", good[: len(good) // 2]),
            ("corrupted zlib", good[:44] + b"\x00" * (len(good) - 44)),
        ]:
            dec = codec.cwipc_new_decoder()
            with pytest.raises(cwipc.CwipcError):
                dec.feed(blob)

    def test_foreign_anchor_bitstream_rejected_loudly(self, tmp_path, small_pc):
        """A reference-ecosystem .cwicpc (MPEG-anchor `_cwipc_codec`
        bitstream) must fail with a message that NAMES the codec
        incompatibility, not a bare parse error (round-4 interop gap:
        this codec's CTC1 format is deliberately not anchor
        bit-compatible — codec/__init__.py module docstring).  The anchor
        codec's source is not in the reference mirror, so this feeds a
        synthetic anchor-style frame: a plausible foreign header and
        payload that is structurally unlike CTC1."""
        # anchor-style synthetic frame: foreign 4CC + version words + blob
        foreign = (
            b"CWIC" + struct.pack("<IIQ", 2, 85, 0) + os.urandom(256)
        )
        dec = codec.cwipc_new_decoder()
        with pytest.raises(cwipc.CwipcError) as ei:
            dec.feed(foreign)
        msg = str(ei.value)
        assert "CTC1" in msg
        assert "cwipc_codec" in msg  # names the anchor plugin
        assert "re-encode" in msg  # tells the user what to do

        # the same failure surfaces through .cwicpc file playback
        p = tmp_path / "frame-0001.cwicpc"
        p.write_bytes(foreign)
        src = cwipc_playback(str(tmp_path), ext=".cwicpc")
        try:
            with pytest.raises(cwipc.CwipcError, match="CTC1"):
                src.get()
        finally:
            src.stop()


class TestPlaybackTileconfigSeek:
    def test_tileconfig_json(self, tmp_path, small_pc):
        """A tileconfig.json in a playback directory supplies tileinfo
        (reference: playback.py:136-140)."""
        import json

        import cwipc_util_jax as cwipc
        from cwipc_util_jax.models.playback import cwipc_playback

        cwipc.cwipc_write(str(tmp_path / "pointcloud-1000.ply"), small_pc)
        info = {"tileInfo": [
            {"normal": {"x": 0, "y": 0, "z": 1}, "cameraName": "cam0",
             "ncamera": 1, "cameraMask": 1},
            {"normal": {"x": 0, "y": 0, "z": -1}, "cameraName": "cam1",
             "ncamera": 1, "cameraMask": 2},
        ]}
        (tmp_path / "tileconfig.json").write_text(json.dumps(info))
        src = cwipc_playback(str(tmp_path), ext=".ply")
        assert src.maxtile() == 2
        d = src.get_tileinfo_dict(1)
        assert d["cameraName"] == "cam1"
        assert d["cameraMask"] == 2
        src.stop()

    def test_seek_contract(self, tmp_path, small_pc):
        """File playback refuses seek, exactly like the reference
        (playback.py:44-45 returns False; only raw-recording capturers
        implement seek) — inpoint/outpoint are the file-level positioning
        mechanism (covered by test_inpoint_outpoint)."""
        import cwipc_util_jax as cwipc
        from cwipc_util_jax.models.playback import cwipc_playback

        cwipc.cwipc_write(str(tmp_path / "pointcloud-1000.ply"), small_pc)
        src = cwipc_playback(str(tmp_path), ext=".ply")
        src.start()
        assert not src.seek(1000)
        pc = src.get()
        assert pc is not None
        pc.free()
        src.stop()


class TestMulticamPlayback:
    def test_fused_tiled_replay(self, tmp_path, small_pc):
        """A multi-camera playback config fuses one frame per camera with
        per-camera trafos applied and tile = cameraMask."""
        import json

        import numpy as np

        import cwipc_util_jax as cwipc
        from cwipc_util_jax.models.capturer import cwipc_capturer

        for cam in range(2):
            cwipc.cwipc_write(str(tmp_path / f"camera{cam}.ply"), small_pc)
        shift = np.identity(4)
        shift[0, 3] = 5.0  # move camera 1 by +5 in x
        cfg = dict(
            version=3, type="playback",
            camera=[
                dict(filename="camera0.ply", type="playback"),
                dict(filename="camera1.ply", type="playback", trafo=shift.tolist()),
            ],
        )
        conf = tmp_path / "cameraconfig.json"
        conf.write_text(json.dumps(cfg))
        src = cwipc_capturer(str(conf))
        assert src.maxtile() == 3
        assert src.get_tileinfo_dict(2)["cameraMask"] == 2
        src.start()
        pc = src.get()
        assert pc is not None
        n = small_pc.count()
        assert pc.count() == 2 * n
        m = pc.get_numpy_matrix()
        tiles = m[:, 6].astype(int)
        assert set(tiles) == {1, 2}
        # camera 1's copy is shifted by the trafo
        x_t1 = m[tiles == 1, 0].mean()
        x_t2 = m[tiles == 2, 0].mean()
        assert abs((x_t2 - x_t1) - 5.0) < 1e-4
        pc.free()
        src.stop()
