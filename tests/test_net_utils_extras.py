"""Coverage for the proxy TCP receiver, peek queue, vectors, logging, stats.

These are the reference-parity corners not exercised by the pipeline tests:
the legacy proxy packet protocol (reference: src/cwipc_proxy.cpp:158-254),
the vectors.h quirks (vectors.h:25-47), the CWIPC_LOGGING subsystem
(src/logging.cpp:48-138) and the statistics() print protocol.
"""

import socket
import struct
import time

import numpy as np
import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _point_bytes(pts):
    """Pack [(x,y,z,r,g,b,tile)] into 16-byte external point records."""
    out = b""
    for x, y, z, r, g, b, tile in pts:
        out += struct.pack("<fffBBBB", x, y, z, r, g, b, tile)
    return out


class TestProxySource:
    def test_receive_ack_and_latest_wins(self):
        from cwipc_util_jax.net.proxy import CWIPC_POINT_PACKETHEADER_MAGIC
        from cwipc_util_jax.net.proxy import cwipc_proxy_source

        port = _free_port()
        src = cwipc_proxy_source("127.0.0.1", port)
        try:
            conn = socket.create_connection(("127.0.0.1", port), timeout=5)
            for ts in (1111, 2222):  # second cloud replaces the first
                payload = _point_bytes([(1.0, 2.0, 3.0, 10, 20, 30, ts % 5)])
                hdr = struct.pack(
                    "<IIQfI", CWIPC_POINT_PACKETHEADER_MAGIC, len(payload),
                    ts, 0.05, 0,
                )
                conn.sendall(hdr + payload)
                ack = conn.recv(8)
                assert struct.unpack("<Q", ack)[0] == ts
            deadline = time.time() + 5
            while not src.available(wait=True) and time.time() < deadline:
                pass
            pc = src.get()
            assert pc is not None
            assert pc.timestamp() == 2222  # latest wins
            assert pc.count() == 1
            arr = pc.get_numpy_array()
            assert np.isclose(arr["x"][0], 1.0)
            assert arr["tile"][0] == 2222 % 5
            pc.free()
            conn.close()
        finally:
            src.stop()

    def test_bad_magic_drops_connection(self):
        from cwipc_util_jax.net.proxy import cwipc_proxy_source

        port = _free_port()
        src = cwipc_proxy_source("127.0.0.1", port)
        try:
            conn = socket.create_connection(("127.0.0.1", port), timeout=5)
            conn.sendall(struct.pack("<IIQfI", 0xDEADBEEF, 16, 1, 0.0, 0))
            # server closes the connection; recv returns EOF
            conn.settimeout(5)
            assert conn.recv(8) == b""
            conn.close()
            assert not src.available()
        finally:
            src.stop()


class TestPeekQueue:
    def test_dont_get_leaves_item(self):
        from cwipc_util_jax.net.peek_queue import PeekQueue

        q = PeekQueue(maxsize=2)
        q.put("a")
        assert q.dont_get() == "a"
        assert q.get() == "a"  # still there

    def test_dont_get_timeout(self):
        from cwipc_util_jax.net.peek_queue import PeekQueue

        q = PeekQueue()
        assert q.dont_get(timeout=0.05) is None

    def test_peek_does_not_steal_getter_wakeup(self):
        """A blocked get() and a blocked dont_get() wait on the same
        not_empty condition; put() notifies only ONE waiter.  The peek
        must pass the wakeup on, or the real consumer sleeps forever next
        to a non-empty queue (the decoder-thread starvation bug)."""
        import threading
        import time

        from cwipc_util_jax.net.peek_queue import PeekQueue

        q = PeekQueue(maxsize=2)
        got = []

        def consumer():
            got.append(q.get())  # blocking get, no timeout

        t = threading.Thread(target=consumer, daemon=True)
        t.start()
        time.sleep(0.1)  # let the getter block first
        peeks = []

        def peeker():
            peeks.append(q.dont_get(timeout=5.0))

        p = threading.Thread(target=peeker, daemon=True)
        p.start()
        time.sleep(0.1)  # both waiters parked on not_empty
        q.put("x")
        t.join(timeout=2.0)
        assert not t.is_alive(), "getter starved: peek stole its wakeup"
        assert got == ["x"]
        p.join(timeout=2.0)


class TestVectorsQuirks:
    def test_len_vector_returns_squared_length(self):
        from cwipc_util_jax.utils.vectors import len_vector

        assert len_vector((3.0, 4.0, 0.0)) == 25.0  # quirk: squared

    def test_norm_vector_divides_by_squared_length(self):
        from cwipc_util_jax.utils.vectors import len_vector, norm_vector

        v = norm_vector((2.0, 0.0, 0.0))
        # result length is 1/|a|, not 1 (reference vectors.h:39-47)
        assert v == (0.5, 0.0, 0.0)
        assert len_vector(norm_vector((0.0, 0.0, 0.0))) == 0.0

    def test_dot_and_cross(self):
        from cwipc_util_jax.utils.vectors import cross_vectors, dot_vectors

        assert dot_vectors((1, 2, 3), (4, 5, 6)) == 32
        assert cross_vectors((1, 0, 0), (0, 1, 0)) == (0, 0, 1)


class TestLogging:
    def test_callback_receives_messages(self):
        from cwipc_util_jax.utils import logging as cl

        got = []
        cl.cwipc_log_configure(3, lambda lvl, msg: got.append((lvl, msg)))
        try:
            cl.cwipc_log(2, "test", "hello")
            assert got and got[-1][0] == 2
            assert b"hello" in got[-1][1]
        finally:
            cl.cwipc_log_configure(0, None)

    def test_level_filters(self):
        from cwipc_util_jax.utils import logging as cl

        got = []
        cl.cwipc_log_configure(1, lambda lvl, msg: got.append(lvl))
        try:
            cl.cwipc_log(4, "test", "debug message")  # above level: dropped
            assert got == []
            cl.cwipc_log(1, "test", "error message")
            assert got == [1]
        finally:
            cl.cwipc_log_configure(0, None)

    def test_capture_errors(self):
        from cwipc_util_jax.utils import logging as cl

        with cl.capture_errors() as cap:
            cl._cwipc_log_emit(1, "mod", "boom")
        assert cap.error is not None and "boom" in cap.error


class TestStats:
    def test_print1stat_formats(self, capsys):
        from cwipc_util_jax.utils.stats import print1stat

        print1stat("comp", "latency", [1.0, 2.0, 3.0])
        out = capsys.readouterr().out
        assert "count=3" in out and "average=2.000" in out
        print1stat("comp", "empty", [])
        assert "count=0" in capsys.readouterr().out

    def test_timer_and_stats(self, capsys):
        from cwipc_util_jax.utils.stats import Stats, Timer

        st = Stats("unit")
        with Timer(st, "sleep"):
            time.sleep(0.01)
        st.add("frames", 5, isInt=True)
        st.print()
        out = capsys.readouterr().out
        assert "sleep" in out and "frames" in out


class TestNodropLateSubscriber:
    def test_ring_held_for_late_subscriber(self):
        """A nodrop stream whose consumer connects AFTER another stream's
        must still deliver its early packets (held in the bounded ring, not
        drained) — and a never-subscribed stream must not block the
        producer."""
        import socket
        import threading
        import time

        from cwipc_util_jax.net.sink_netserver import _Sink_NetServer, pack_frame

        sink = _Sink_NetServer(0, nodrop=True)  # port 0: auto-assign
        # three streams on consecutive auto ports is not possible with port
        # 0; pick free ports explicitly
        s = socket.socket(); s.bind(("", 0)); base = s.getsockname()[1]; s.close()
        sink = _Sink_NetServer(base, nodrop=True)
        for _ in range(3):
            sink.add_stream()
        sink.set_fourcc("cwi0")
        sink.start()
        try:
            fed = []

            def producer():
                for i in range(12):
                    for stream in range(3):
                        ok = sink.feed(b"payload-%d-%d" % (stream, i), stream)
                        fed.append(ok)

            t = threading.Thread(target=producer)
            t.start()
            time.sleep(0.3)
            assert t.is_alive()  # held: no consumer anywhere yet

            c0 = socket.create_connection(("localhost", base), timeout=5)
            t.join(timeout=30)
            assert not t.is_alive(), "producer blocked by unsubscribed streams"
            assert all(fed)

            # late subscriber on stream 1 still receives the early backlog
            time.sleep(0.3)
            c1 = socket.create_connection(("localhost", base + 1), timeout=5)
            c1.settimeout(10)
            got = b""
            while b"payload-1-0" not in got:
                got += c1.recv(65536)
            c0.close()
            c1.close()
        finally:
            sink.stop()


class TestSwitchportRaces:
    def _serve(self, port, fourcc, stop_evt, tag):
        """Minimal netserver: accept clients, send tagged frames forever."""
        import socket
        import struct
        import threading
        import time

        from cwipc_util_jax.net.sink_netserver import pack_frame

        lsock = socket.socket()
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind(("", port))
        lsock.listen(4)
        lsock.settimeout(0.2)

        def serve():
            conns = []
            seq = 0
            while not stop_evt.is_set():
                try:
                    c, _ = lsock.accept()
                    conns.append(c)
                except OSError:
                    pass
                seq += 1
                payload = f"{tag}:{seq}".encode()
                frame = pack_frame(fourcc, payload, int(time.time() * 1000))
                dead = []
                for c in conns:
                    try:
                        c.sendall(frame)
                    except OSError:
                        dead.append(c)
                for c in dead:
                    conns.remove(c)
                time.sleep(0.02)
            for c in conns:
                try:
                    c.close()
                except OSError:
                    pass
            lsock.close()

        t = threading.Thread(target=serve, daemon=True)
        t.start()
        return t

    def test_rapid_double_switch_keeps_stream_alive(self):
        """Two switchport() calls in quick succession: the second supersedes
        the first (closing its pending socket) — the reader must neither die
        on the closed snapshot nor clobber the newer switch; the stream ends
        up on the LAST requested port."""
        import socket
        import threading
        import time

        from cwipc_util_jax.net.abstract import VRT_4CC
        from cwipc_util_jax.net.source_netclient import cwipc_source_netclient

        def free_port():
            s = socket.socket()
            s.bind(("", 0))
            p = s.getsockname()[1]
            s.close()
            return p

        ports = [free_port() for _ in range(3)]
        fourcc = VRT_4CC("cwi0")
        stop = threading.Event()
        threads = [
            self._serve(p, fourcc, stop, tag) for p, tag in zip(ports, "ABC")
        ]
        try:
            src = cwipc_source_netclient(f"localhost:{ports[0]}")
            src.set_fourcc("cwi0")
            src.start()
            deadline = time.time() + 5
            while src.queue.empty() and time.time() < deadline:
                time.sleep(0.01)
            assert not src.queue.empty(), "no frames from the first port"

            # rapid supersede: B then immediately C
            src.switchport(ports[1])
            src.switchport(ports[2])

            # the stream must stay alive and converge to C's frames
            deadline = time.time() + 10
            saw_c = False
            while time.time() < deadline and not saw_c:
                if src.available(True):
                    payload = src.get()
                    if payload and payload.startswith(b"C:"):
                        saw_c = True
            assert saw_c, "stream never delivered frames from the final port"
            assert not src.eof(), "stream died across the double switch"
            assert src.port == ports[2]
        finally:
            stop.set()
            src.stop()
            for t in threads:
                t.join(timeout=2)
