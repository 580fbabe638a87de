"""Example: publish and play a low-latency DASH pointcloud stream.

Uses the SIGNALS SMD packager/player bindings (net/sink_lldpkg.py,
net/source_lldplay.py).  Without the commercial SIGNALS libraries this
demonstrates against the repo's fake loopback implementation — build it
with `make -C cwipc_util_jax/native fakesignals` (done automatically here)
and the same code runs unchanged against the real `.so`s by pointing
SIGNALS_SMD_PATH at them.
"""

import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, REPO)

NATIVE = os.path.join(REPO, "cwipc_util_jax", "native")


def main() -> int:
    if "SIGNALS_SMD_PATH" not in os.environ:
        rv = subprocess.run(["make", "-C", NATIVE, "fakesignals"],
                            capture_output=True, text=True)
        if rv.returncode != 0:
            print("example_dash_stream: fakesignals build failed:\n" + rv.stderr[-500:])
            return 1
        os.environ["SIGNALS_SMD_PATH"] = os.path.join(NATIVE, "build")
        print("using the fake SIGNALS loopback libraries")

    import cwipc_util_jax as cwipc
    from cwipc_util_jax.codec import cwipc_new_encoder
    from cwipc_util_jax.net.sink_lldpkg import cwipc_sink_lldpkg
    from cwipc_util_jax.net.source_lldplay import cwipc_source_lldplay

    with tempfile.TemporaryDirectory() as tmp:
        url = os.path.join(tmp, "stream", "live.mpd")

        # publish: synthetic -> encoder -> DASH packager
        sink = cwipc_sink_lldpkg(url)
        sink.set_fourcc("cwi1")
        sink.add_stream(tilenum=0)
        sink.start()
        enc = cwipc_new_encoder()
        gen = cwipc.cwipc_synthetic(0, 2000)
        gen.start()
        for _ in range(3):
            pc = gen.get()
            enc.feed(pc)
            sink.feed(enc.get_bytes(), 0)
            pc.free()
        gen.stop()
        sink.stop()
        print("published 3 encoded frames")

        # play back: DASH player -> decoder
        from cwipc_util_jax.codec import cwipc_new_decoder

        src = cwipc_source_lldplay(os.path.dirname(url))
        assert src.start()
        dec = cwipc_new_decoder()
        got = 0
        deadline = time.time() + 10
        while got < 3 and time.time() < deadline:
            if not src.available(wait=True):
                continue
            data = src.get()
            if not data:
                continue
            dec.feed(data)
            pc = dec.get()
            print(f"frame {got}: {pc.count()} points")
            pc.free()
            got += 1
        src.stop()
        assert got == 3
    print("DASH stream round trip OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
